"""Matching statistics of a query text against an indexed database, in
torch ops on the index's device (port of :mod:`vstree_tpu.engine.mstats`,
whose docstring gives the method).

MS(p) = length of the longest prefix of query[p..] that occurs anywhere
in the database, with the db SA rank of a suffix that realizes it:

1. sort the suffixes of db ++ SEPARATOR ++ query (the seeded compacted
   doubling of index/sort.py), keeping the rank snapshots;
2. adjacent-pair LCPs of the merged order by snapshot descent;
3. MS(p) = max over the two db-suffix neighbours of query suffix p in the
   merged order of their range-min lcp: two segmented min scans;
4. the witness is the db SA rank of the chosen neighbour: a running
   count of db-tagged ranks.

The segmented scans of the JAX module (``lax.associative_scan`` with a
flag-reset combine) are ``cummax`` over keys ``segment << 32 | (M - v)``:
the segment number never decreases along the scan, so the running
maximum of a key is the running minimum of ``v`` inside its segment.  The
``mode="drop"`` scatter to query positions is a masked index write.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.chardef import SEPARATOR
from ..device import count, phase
from ..index.esa import ESA
from ..index.sort import (
    _lce_tables,
    device_suffix_sort,
    lce_pack_params,
    lce_with_snapshots,
)

_I64 = torch.int64
_INF = 1 << 30           # the value of a db-tagged rank in the scans
_KEY = (1 << 31) - 1     # keys hold _KEY - v in their low 32 bits


def _segmented_min(v: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """Running minimum of v (0 <= v <= _INF) that restarts where the
    non-decreasing segment number seg changes."""
    key = torch.cummax((seg << 32) | (_KEY - v), 0).values
    return _KEY - (key & 0xFFFFFFFF)


def _ms_scans(sa, mlcp, n_db: int, nq: int):
    """Forward/backward segmented min scans over the merged order.

    Element r carries lcp(sa[r-1], sa[r]); db-tagged ranks restart the
    running min.  After the scans each query-tagged rank knows the lce
    to its nearest db suffix on either side and that suffix's db SA
    rank.  Returns (ms[nq], wit[nq]) at the query positions, int64."""
    sa = sa.to(_I64)
    mlcp = mlcp.to(_I64)
    is_db = sa < n_db
    db_le = torch.cumsum(is_db.to(_I64), 0)        # db ranks <= r
    # forward: the previous db neighbour p; min mlcp(p+1..r)
    vf = _segmented_min(torch.where(is_db, _INF, mlcp), db_le)
    ff = db_le > 0
    wf = torch.where(ff, db_le - 1, 0)
    # backward: the next db neighbour q; min mlcp(r+1..q), scanned on
    # the flipped order (torch has no reverse scans)
    mlcp_next = torch.cat([mlcp[1:], mlcp.new_zeros(1)])
    db_ge = torch.flip(torch.cumsum(torch.flip(is_db, [0]).to(_I64), 0),
                       [0])                          # db ranks >= r
    vb = torch.flip(_segmented_min(
        torch.flip(torch.where(is_db, _INF, mlcp_next), [0]),
        torch.flip(db_ge, [0])), [0])
    fb = db_ge > 0
    wb = torch.where(fb, db_le - is_db.to(_I64), 0)

    ms_f = torch.where(ff & ~is_db, vf, -1)
    ms_b = torch.where(fb & ~is_db, vb, -1)
    use_f = ms_f >= ms_b            # prefer the lower neighbour on ties
    ms = torch.maximum(torch.maximum(ms_f, ms_b), torch.zeros_like(ms_f))
    wit = torch.where(use_f, wf, wb)

    qtag = sa > n_db
    qpos = sa[qtag] - (n_db + 1)
    msq = torch.zeros(nq, dtype=_I64, device=sa.device)
    witq = torch.zeros(nq, dtype=_I64, device=sa.device)
    msq[qpos] = ms[qtag]
    witq[qpos] = wit[qtag]
    return msq, witq


def matching_statistics(esa: ESA, qtext: np.ndarray):
    """(ms[nq], witness_db_rank[nq]) for every query position, host
    int64, computed on ``esa.dev``.

    The witness is a db SA rank whose suffix realizes ms (ties prefer
    the lexicographically smaller neighbour).  One merged sort per call.
    """
    n_db = esa.totallength
    nq = int(qtext.size)
    if nq == 0 or n_db == 0:
        z = np.zeros(nq, np.int64)
        return z, z
    if nq == n_db and esa.stitab is not None \
            and (qtext is esa.text
                 or np.array_equal(qtext, esa.text)):
        # identical-text fast path (db vs itself): every query suffix
        # occurs at its own db position, so MS(p) is the distance to the
        # next special/end and the witness is the position's own rank
        spec = np.flatnonzero(qtext >= 254).astype(np.int64)
        nxt = np.full(nq, n_db, np.int64)
        if spec.size:
            idx = np.searchsorted(spec, np.arange(nq))
            nxt = np.where(idx < spec.size,
                           spec[np.minimum(idx, spec.size - 1)], n_db)
        ms = nxt - np.arange(nq)
        wit = esa.stitab[:n_db].astype(np.int64)
        return ms, wit
    sigma = esa.alpha.num_regular
    mtext = np.empty(n_db + 1 + nq, np.uint8)
    mtext[:n_db] = esa.text
    mtext[n_db] = SEPARATOR
    mtext[n_db + 1:] = qtext
    n_m = int(mtext.size)
    mdev = torch.from_numpy(mtext).to(esa.dev)
    # the sort's own phases ("initial sort", "doubling rounds") time it
    sa, snaps = device_suffix_sort(mdev, n_m, sigma, collect_snapshots=True)
    count("merged sorts", 1)
    count("snapshots", len(snaps))
    with phase("snapshot lce"):
        bits, D = lce_pack_params(sigma)
        P = _lce_tables(mdev, n_m, bits, D)
        mlcp_rest = lce_with_snapshots(snaps, P, sa[:-1], sa[1:], n_m,
                                       sigma)
    del snaps
    with phase("ms scans"):
        mlcp = torch.cat([mlcp_rest.new_zeros(1), mlcp_rest])
        msq, witq = _ms_scans(sa, mlcp, n_db, nq)
        return msq.cpu().numpy(), witq.cpu().numpy()
