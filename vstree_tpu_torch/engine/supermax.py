"""Supermaximal repeats.

Reference algorithm (src/Vmengine/fsuper.c:61-165): one bottom-up pass
finds lcp-intervals whose children are all leaves ("alwaysontop") and
whose regular bwt characters are pairwise distinct; every suffix pair
of such an interval is a supermaximal repeat.

Copy of :mod:`vstree_tpu.engine.supermax` (host NumPy); its ``mesh``
branch reaches the port's rank-sharded scan program
(:mod:`vstree_tpu_torch.parallel.shardesa`).

Design: an alwaysontop interval of depth d spanning ranks [l..r] is
exactly a maximal run of equal values d in the lcp array
(lcp[l+1..r] == d) that is a strict local maximum (lcp[l] < d,
lcp[r+1] < d) — so the whole enumeration is a vectorized run-detection
over lcp plus per-run distinctness counts (alphabet-sized histogram of
bwt per run), no stack, no traversal.  Emission order matches the
reference's DFS completion order: alwaysontop nodes complete in order
of their right boundary.
"""

from __future__ import annotations

import numpy as np

from ..core.chardef import WILDCARD
from ..index.esa import ESA
from .match import MatchTable


def supermax_intervals(
    esa: ESA, searchlength: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(left, right, depth) arrays of supermaximal lcp-intervals with
    depth >= searchlength, ordered by right boundary (DFS completion
    order)."""
    lcp = esa.lcptab
    n1 = lcp.size  # n + 1
    d = lcp
    L = max(searchlength, 1)
    # candidate runs start at a RISE with value >= L (one boolean pass
    # over the lcp table; everything after is sized by the candidate
    # count, which the >= L filter keeps tiny)
    cand = np.flatnonzero((d[1:] > d[:-1]) & (d[1:] >= L)) + 1
    if cand.size == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    vals = d[cand].astype(np.int64)
    # run end: first index after the equal-value run, by geometric
    # window scan (runs are short)
    ends = cand.copy()
    act = np.arange(cand.size)
    w = 4
    while act.size:
        offs = np.arange(1, w + 1)
        idx = np.minimum(ends[act][:, None] + offs[None, :], n1 - 1)
        neq = (d[idx] != vals[act][:, None]) | (idx == n1 - 1)
        # also stop exactly at the array end
        stop = neq | (ends[act][:, None] + offs[None, :] >= n1 - 1)
        anystop = stop.any(axis=1)
        first = np.argmax(stop, axis=1)
        ends[act] += np.where(anystop, first, w)
        act = act[~anystop]
        if w < 1024:
            w *= 4
    # ends now = last index of the run (the step above advances to the
    # position BEFORE the first difference/end)
    nxt = np.where(ends + 1 <= n1 - 1, d[np.minimum(ends + 1, n1 - 1)],
                   -1)
    nxt = np.where(ends == n1 - 1, -1, nxt)
    keep = vals > nxt
    left = (cand[keep] - 1).astype(np.int64)
    right = ends[keep].astype(np.int64)
    depth = vals[keep]
    if left.size == 0:
        return left, right, depth.astype(np.int64)

    # distinctness of regular bwt chars per interval: for each regular
    # char c, the count of c within [l..r] must be <= 1 (specials and
    # the rank of suffix 0 are position-unique; fsuper.c:75-101).
    # Member ranks are materialized directly from the (few, narrow)
    # candidate intervals — never as a full-length mask
    bwt = esa.bwttab
    numofchars = esa.alpha.num_regular
    widths = (right - left + 1).astype(np.int64)
    total = int(widths.sum())
    cum0 = np.concatenate([[0], np.cumsum(widths)[:-1]])
    ivs = np.repeat(np.arange(left.size), widths)
    ranks = np.repeat(left, widths) + (np.arange(total) - cum0[ivs])
    chars = bwt[ranks].astype(np.int64)
    regular = chars < numofchars
    # specials and UNDEFBWTCHAR (the rank of suffix 0) are
    # position-unique -> excluded from distinctness
    cnt = np.bincount(
        (ivs[regular] * numofchars + chars[regular]),
        minlength=left.size * numofchars,
    ).reshape(left.size, numofchars)
    ok = (cnt <= 1).all(axis=1)
    return left[ok], right[ok], depth[ok].astype(np.int64)


def find_supermax(
    esa: ESA, searchlength: int, mesh=None
) -> MatchTable:
    """All supermaximal repeat pairs, reference emission order
    (fsuper.c:105-124: per interval, pairs (s, t) with s < t in rank
    order; positions swapped so position1 < position2, fself.c:23-32).

    With ``mesh`` the interval detection runs as the rank-sharded scan
    program (parallel/shardesa.py) — identical output."""
    if mesh is not None:
        from ..parallel.shardesa import supermax_intervals_sharded

        left, right, depth = supermax_intervals_sharded(
            esa, searchlength, mesh)
    else:
        left, right, depth = supermax_intervals(esa, searchlength)
    k = right - left + 1
    npairs = (k * (k - 1)) // 2
    total = int(npairs.sum())
    if total == 0:
        return MatchTable()
    suf = esa.suftab

    # expand pairs: for interval iv with ranks l..r, pairs in order
    # (s=l..r-1, t=s+1..r)
    iv_of_pair = np.repeat(np.arange(left.size), npairs)
    start = np.concatenate([[0], np.cumsum(npairs)[:-1]])
    pidx = np.arange(total) - start[iv_of_pair]  # pair index within interval
    kk = k[iv_of_pair]
    # map pidx -> (s_off, t_off) in lexicographic order
    # s_off = smallest s with pidx < cum pairs; use the triangular formula
    # pairs before s_off rows: s_off*(2k - s_off - 1)/2
    s_off = np.floor(
        (2 * kk - 1 - np.sqrt((2 * kk - 1) ** 2 - 8 * pidx)) / 2
    ).astype(np.int64)
    # fix rounding
    before = s_off * (2 * kk - s_off - 1) // 2
    over = before > pidx
    s_off[over] -= 1
    before = s_off * (2 * kk - s_off - 1) // 2
    t_off = pidx - before + s_off + 1
    s_rank = left[iv_of_pair] + s_off
    t_rank = left[iv_of_pair] + t_off
    p1 = suf[s_rank].astype(np.int64)
    p2 = suf[t_rank].astype(np.int64)
    lo = np.minimum(p1, p2)
    hi = np.maximum(p1, p2)
    d = depth[iv_of_pair]

    ms = esa.multiseq
    seq1, rel1 = ms.pos_to_pair(lo)
    seq2, rel2 = ms.pos_to_pair(hi)
    return MatchTable(
        length1=d,
        position1=lo,
        length2=d.copy(),
        position2=hi,
        distance=np.zeros(total, np.int64),
        flag=np.zeros(total, np.int64),
        seqnum1=seq1,
        relpos1=rel1,
        seqnum2=seq2,
        relpos2=rel2,
        evalue=np.zeros(total, np.float64),
        idnumber=np.zeros(total, np.int64),
        transnum=np.full(total, -1, np.int64),
    )
