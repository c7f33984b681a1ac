"""Sharded ESA construction and sharded match engines (port of
:mod:`vstree_tpu.parallel.shardesa`).

The reference's only distribution seams are the superbucket
partitioning of the suffix-rank range (reference
include/vdfstrav.c:419-499, ``-numproc``) and per-query independence
(fquery.c:470-477).  Here, over the shards of a
:class:`~vstree_tpu_torch.parallel.mesh.Mesh`:

- **Sharded index build**: plain prefix doubling with every O(n) array
  split over the shards by position.  The global stable sort of a round
  is a sample sort (regular samples, one all-to-all to the buckets, a
  local sort there), the shift ``rank[p + k]`` a window read from at
  most two shards, the new ranks a scatter by destination shard.  The
  LCP pass is pair-parallel and split the same way
  (``index.build.lcp_from_pairs``).
- **Sharded supermax** (reference fsuper.c:61-165): a scan/gather
  program over the lcp/bwt arrays (run detection by forward/backward
  cummax fills, left-context distinctness by per-char
  previous-occurrence scans); every global scan is a local scan plus an
  S-scalar prefix combine, every shift a one-element halo.
- **Sharded complete-match lookup**: the rank-sharded binary search of
  :func:`~vstree_tpu_torch.parallel.mesh.sharded_exact_match`; a
  pattern's occurrences are one contiguous rank interval, so a
  psum/pmin pair restores the monolithic ``[lo, hi)`` exactly.

Every result equals the monolith's (``tests/test_torch_parallel.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.chardef import WILDCARD
from .mesh import (
    Mesh,
    _lookup_shards,
    all_gather,
    all_to_all,
    collect,
    gather_dp,
    make_mesh,
    ppermute,
    psum,
    sharded_exact_match,
)

_I32 = torch.int32
_I64 = torch.int64


def _flat_mesh(mesh: Mesh) -> Mesh:
    """1-axis view ("x") over all shards of a mesh, on its transport."""
    return Mesh(mesh.devices.reshape(-1), ("x",), mesh.comm)


def flat_spec(mesh: Mesh, n: int) -> list[slice]:
    """1-D layout of an array of ``n`` elements (a multiple of the
    shard count) over every shard of the mesh: the slice of each local
    shard, in ``mesh.local`` order."""
    L = n // mesh.size
    return [slice(i * L, (i + 1) * L) for i in mesh.local]


# ---------------------------------------------------------------------------
# sharded suffix sort (index build)
# ---------------------------------------------------------------------------


def _by_key(keys, pos):
    """(keys, pos) ordered by key, then position, for positions that
    come in ascending order."""
    order = torch.sort(keys, stable=True).indices
    return keys[order], pos[order]


def _sample_sort(fm: Mesh, keys: list, pos: list) -> list:
    """Sort the (key, position) pairs of all shards by key, then
    position; each shard's positions are one ascending range below the
    next shard's.  Regular samples (S a shard) give S-1 splitters, one
    all-to-all sends each sorted run to its buckets, and each bucket
    sorts what it received.  Returns per local shard its bucket (keys,
    positions): the buckets in flat order are the sorted sequence, each
    below 2L long."""
    S = fm.size
    runs = [_by_key(k, p) for k, p in zip(keys, pos)]
    at = [(torch.arange(S, device=k.device) * k.numel()) // S
          for k, _ in runs]
    samp_k = all_gather(fm, [k[a] for (k, _), a in zip(runs, at)], "x")
    samp_p = all_gather(fm, [p[a] for (_, p), a in zip(runs, at)], "x")
    chunks_k, chunks_p = [], []
    for (k, p), sk, spos in zip(runs, samp_k, samp_p):
        sk, spos = sk.reshape(-1), spos.reshape(-1)
        o = torch.sort(spos, stable=True).indices
        o = o[torch.sort(sk[o], stable=True).indices]
        pick = o[torch.arange(1, S, device=k.device) * S + S // 2 - 1]
        hk, hp = sk[pick], spos[pick]
        above = ((k[:, None] > hk[None, :])
                 | ((k[:, None] == hk[None, :]) & (p[:, None] > hp[None, :])))
        counts = torch.bincount(above.sum(1), minlength=S).tolist()
        chunks_k.append(list(torch.split(k, counts)))
        chunks_p.append(list(torch.split(p, counts)))
    recv_k = all_to_all(fm, chunks_k)
    recv_p = all_to_all(fm, chunks_p)
    # a source's run is sorted and its positions lie below the next
    # source's: a stable sort by key of the runs in source order
    return [_by_key(torch.cat(ks), torch.cat(ps))
            for ks, ps in zip(recv_k, recv_p)]


def _dense_ranks(fm: Mesh, skeys: list) -> tuple[list, int]:
    """Dense rank of every element of the sorted buckets (the count of
    key changes before it in the global order) and the largest rank.
    Keys are >= 0; an empty bucket reports -1 as its last key."""
    S = fm.size
    lasts = [k[-1:] if k.numel() else k.new_full((1,), -1) for k in skeys]
    lastg = all_gather(fm, lasts, "x")
    newgrp = []
    for k, lg, m in zip(skeys, lastg, fm.local):
        below = torch.arange(S, device=k.device)[:, None] < m
        before = torch.where(below, lg, -1).max()
        prev = torch.cat([before.reshape(1), k[:-1]])[:k.numel()]
        newgrp.append(((prev >= 0) & (k != prev)).to(_I64))
    loc = [torch.cumsum(g, 0) for g in newgrp]
    tots = all_gather(fm, [g.sum().reshape(1) for g in newgrp], "x")
    dense = [c + torch.where(torch.arange(S, device=c.device)[:, None] < m,
                             t, 0).sum()
             for c, t, m in zip(loc, tots, fm.local)]
    return dense, int(tots[0].sum())


def _scatter(fm: Mesh, pos: list, vals: list, L: int) -> list:
    """``out[pos] = vals`` over the global layout of ``L`` positions a
    shard: each pair goes to shard ``pos // L``.  Every position is
    written once."""
    chunks_p, chunks_v = [], []
    for p, v in zip(pos, vals):
        dest = p // L
        o = torch.sort(dest, stable=True).indices
        counts = torch.bincount(dest, minlength=fm.size).tolist()
        chunks_p.append(list(torch.split(p[o], counts)))
        chunks_v.append(list(torch.split(v[o], counts)))
    recv_p = all_to_all(fm, chunks_p)
    recv_v = all_to_all(fm, chunks_v)
    out = []
    for ps, vs, i in zip(recv_p, recv_v, fm.local):
        r = torch.empty(L, dtype=_I64, device=fm.device(i))
        r[torch.cat(ps) - i * L] = torch.cat(vs)
        out.append(r)
    return out


def _shift_window(fm: Mesh, xs: list, k: int, fill: int, L: int) -> list:
    """``y[p] = x[p + k]`` over the global layout of ``L`` positions a
    shard, ``fill`` past the end: each shard's window comes from at
    most two shards (``jnp.roll(x, -k)`` with the wrapped part
    replaced)."""
    n = fm.size * L
    chunks = []
    for x, s in zip(xs, fm.local):
        row = []
        for d in range(fm.size):
            lo, hi = max(d * L + k, s * L), min(d * L + L + k, s * L + L)
            row.append(x[lo - s * L:hi - s * L] if lo < hi and lo < n
                       else x[:0])
        chunks.append(row)
    out = []
    for recv in all_to_all(fm, chunks):
        y = torch.cat(recv)
        out.append(torch.cat([y, y.new_full((L - y.numel(),), fill)]))
    return out


def _positions(fm: Mesh, L: int) -> list:
    return [torch.arange(i * L, (i + 1) * L, device=fm.device(i))
            for i in fm.local]


def _rerank(fm: Mesh, keys: list, L: int):
    """Sort the positions by their keys (then position) and give each
    the dense rank of its key.  Returns (rank shards by position, the
    sorted positions per bucket, the largest rank)."""
    buckets = _sample_sort(fm, keys, _positions(fm, L))
    dense, maxrank = _dense_ranks(fm, [b[0] for b in buckets])
    si = [b[1] for b in buckets]
    return _scatter(fm, si, dense, L), si, maxrank


def _doubling_round_shards(fm: Mesh, rank: list, k: int, n: int):
    """One prefix-doubling round over rank shards of ``n / S``
    positions: sort by (rank, rank at +k or n), then position.  The two
    keys are one int64 ``rank * (n + 1) + r2``."""
    L = n // fm.size
    r2 = _shift_window(fm, rank, k, n, L)
    return _rerank(fm, [r * (n + 1) + q for r, q in zip(rank, r2)], L)


def suffix_sort_sharded(text_np: np.ndarray,
                        mesh: Mesh) -> tuple[np.ndarray, np.ndarray]:
    """suffix_sort with all O(n) arrays split over the mesh's shards.

    Same contract and identical output as index.build.suffix_sort:
    (suftab[n+1], stitab[n+1]) int32 host arrays."""
    n = int(text_np.size)
    if n == 0:
        return np.array([0], np.int32), np.array([0], np.int32)
    fm = _flat_mesh(mesh)
    npad = ((n + fm.size - 1) // fm.size) * fm.size
    if npad != n:
        # pad with SEPARATOR chars: specials order by *position*, so
        # every pad suffix sorts after every real suffix and the first
        # n sorted entries are exactly the real suffix order
        text_np = np.concatenate([text_np,
                                  np.full(npad - n, 255, np.uint8)])
    L = npad // fm.size
    keys = []
    for s, p in zip(flat_spec(fm, npad), _positions(fm, L)):
        t = torch.from_numpy(text_np[s]).to(p.device, _I64)
        keys.append(torch.where(t >= WILDCARD, 256 + p, t))
    rank, si, maxrank = _rerank(fm, keys, L)
    k = 1
    while maxrank < npad - 1 and k < 2 * npad:
        rank, si, maxrank = _doubling_round_shards(fm, rank, k, npad)
        k *= 2
    suftab = np.empty(n + 1, np.int32)
    suftab[:n] = collect(fm, si)[:n]
    suftab[n] = n
    stitab = np.empty(n + 1, np.int32)
    stitab[suftab] = np.arange(n + 1, dtype=np.int32)
    return suftab, stitab


# ---------------------------------------------------------------------------
# sharded supermax (scan/gather formulation of fsuper.c)
# ---------------------------------------------------------------------------


def _rcummax(x):
    """Reverse cummax (``lax.cummax(x[::-1])[::-1]``)."""
    return torch.flip(torch.cummax(torch.flip(x, [0]), 0).values, [0])


# The global scans of the sharded supermax program over the flat mesh
# ``fm``: lists of equal-length shard tensors in, the same out.  A scan
# is a local scan plus an S-scalar all_gather prefix combine; a shift is
# a one-element ppermute halo.

_LOWEST = torch.iinfo(_I32).min


def _below(fm: Mesh, x, m: int):
    """Per shard index s of the mesh: s < m (the shards before ``m``)."""
    return torch.arange(fm.size, device=x.device) < m


def _cumsum_g(fm: Mesh, xs: list) -> list:
    loc = [torch.cumsum(x, 0, dtype=_I32) for x in xs]
    tots = all_gather(fm, [c[-1] for c in loc], "x")
    return [c + torch.where(_below(fm, c, m), t, 0).sum(dtype=_I32)
            for c, t, m in zip(loc, tots, fm.local)]


def _cummax_g(fm: Mesh, xs: list) -> list:
    loc = [torch.cummax(x, 0).values for x in xs]
    tots = all_gather(fm, [c[-1] for c in loc], "x")
    return [torch.maximum(c, torch.where(_below(fm, c, m), t, _LOWEST).max())
            for c, t, m in zip(loc, tots, fm.local)]


def _rcummax_g(fm: Mesh, xs: list) -> list:
    loc = [_rcummax(x) for x in xs]
    tots = all_gather(fm, [c[0] for c in loc], "x")
    return [torch.maximum(c, torch.where(~_below(fm, c, m + 1), t,
                                         _LOWEST).max())
            for c, t, m in zip(loc, tots, fm.local)]


def _shift_right(fm: Mesh, xs: list, fill) -> list:
    """y[i] = x[i-1] globally; y[0] = fill."""
    prev = ppermute(fm, [x[-1:] for x in xs],
                    [(i, i + 1) for i in range(fm.size - 1)])
    return [torch.cat([x.new_full((1,), fill) if m == 0 else p, x[:-1]])
            for x, p, m in zip(xs, prev, fm.local)]


def _shift_left(fm: Mesh, xs: list, fill) -> list:
    """y[i] = x[i+1] globally; y[n-1] = fill."""
    nxt = ppermute(fm, [x[:1] for x in xs],
                   [(i + 1, i) for i in range(fm.size - 1)])
    return [torch.cat([x[1:], x.new_full((1,), fill)
                       if m == fm.size - 1 else p])
            for x, p, m in zip(xs, nxt, fm.local)]


def _fill_bit_fwd(fm: Mesh, marks: list, bits: list, idx: list) -> list:
    """Forward fill of a boolean from marked positions (requires a mark
    at global position 0, which run-start structure gives).  The packed
    keys ``i * 2 + bit`` are read back with floor ``%`` (-1 gives 1, as
    in jnp; ``torch.fmod`` would not)."""
    keys = [torch.where(mk, i * 2 + b.to(_I32), -1)
            for mk, b, i in zip(marks, bits, idx)]
    return [(f % 2) == 1 for f in _cummax_g(fm, keys)]


def _seg_cumsum_g(fm: Mesh, xs: list, resets: list) -> list:
    """Inclusive segmented cumsum: restart the sum AT each reset position
    (that position contributes its own x).  Locally a cumsum less its
    value before the last reset, found by cummax over reset indices
    (``lax.associative_scan`` has no torch op); across shards a left
    fold of the S shard totals."""
    s_loc, r_loc = [], []
    for x, r in zip(xs, resets):
        c = torch.cumsum(x, 0, dtype=_I32)
        at = torch.arange(x.numel(), device=x.device)
        last = torch.cummax(torch.where(r, at, -1), 0).values
        j = last.clamp(min=0)
        s_loc.append(torch.where(last >= 0, c - (c[j] - x[j]), c))
        r_loc.append(last >= 0)
    tots = all_gather(fm, [s[-1] for s in s_loc], "x")
    anyr = all_gather(fm, [r[-1] for r in r_loc], "x")
    out = []
    for s, r, t, a, m in zip(s_loc, r_loc, tots, anyr, fm.local):
        carry = torch.zeros((), dtype=_I32, device=s.device)
        for j in range(m):  # left fold of the shard carries below
            carry = torch.where(a[j], t[j], carry + t[j])
        out.append(torch.where(r, s, s + carry))
    return out


def _supermax_flags_sharded(fm: Mesh, lcp: list, bwt: list, n1p: int,
                            L: int, sigma: int):
    """The shard program of :func:`_supermax_flags` over lcp/bwt shards
    of ``n1p / S`` ranks: per-shard O(n/S) work, O(S·σ) communication
    (the distributed-scan form of vdfstrav.c:419-499's superbucket
    split)."""
    if 2 * n1p >= 2 ** 31:
        raise ValueError(
            "sharded supermax: index range exceeds the int32 bit-pack "
            "(n must be < 2^30 per invocation)"
        )
    Lloc = n1p // fm.size

    def each(f, *args):
        return [f(*a) for a in zip(*args)]

    i = [m * Lloc + torch.arange(Lloc, dtype=_I32, device=x.device)
         for m, x in zip(fm.local, lcp)]
    lcp = [x.to(_I32) for x in lcp]
    prev = _shift_right(fm, lcp, 0)
    nxt = _shift_left(fm, lcp, -1)
    rs = each(lambda ii, lc, pv: (ii == 0) | (lc != pv), i, lcp, prev)
    re_ = each(lambda ii, lc, nx: (ii == n1p - 1) | (nx != lc), i, lcp, nxt)
    start_rising = each(lambda r, ii, lc, pv: r & (ii > 0) & (lc > pv),
                        rs, i, lcp, prev)
    end_falling = each(lambda r, lc, nx: r & (nx < lc), re_, lcp, nxt)
    # forward fill of start_rising from run starts
    sr_run = _fill_bit_fwd(fm, rs, start_rising, i)
    # backward fill of end_falling from run ends: pack reversed idx
    rkey = each(lambda r, ii, ef: torch.where(
        r, (n1p - 1 - ii) * 2 + ef.to(_I32), -1), re_, i, end_falling)
    ef_run = [(f % 2) == 1 for f in _rcummax_g(fm, rkey)]
    cand = each(lambda a, b, lc: a & b & (lc >= L), sr_run, ef_run, lcp)
    cand_start = each(lambda c, r: c & r, cand, rs)
    close = each(lambda c, r: c & r, cand, re_)
    # interval over ranks: [s-1 .. e] for candidate run [s .. e]
    open_ = _shift_left(fm, cand_start, False)
    copen = _cumsum_g(fm, [o.to(_I32) for o in open_])
    cclose = _cumsum_g(fm, [c.to(_I32) for c in close])
    cclose_excl = _shift_right(fm, cclose, 0)
    member = each(lambda a, b: (a - b) >= 1, copen, cclose_excl)
    istart = _cummax_g(fm, each(lambda o, ii: torch.where(o, ii, -1),
                                open_, i))
    # distinctness: repeated regular bwt char within one interval
    bad = [torch.zeros(Lloc, dtype=torch.bool, device=x.device)
           for x in lcp]
    bwt_i = [b.to(_I32) for b in bwt]
    for c in range(sigma):
        occ = each(lambda mb, b: mb & (b == c), member, bwt_i)
        inc = _cummax_g(fm, each(lambda o, ii: torch.where(o, ii, -1),
                                 occ, i))
        prev_occ = _shift_right(fm, inc, -1)
        bad = each(lambda bd, o, po, st: bd | (o & (po >= st)),
                   bad, occ, prev_occ, istart)
    # per-interval badness: segmented cumsum restarting at opens
    segbad = _seg_cumsum_g(fm, [b.to(_I32) for b in bad], open_)
    return close, istart, [s == 0 for s in segbad]


def _supermax_flags(lcp, bwt, L: int, sigma: int, n1: int):
    """Per-rank flags of supermaximal intervals, on the device of
    ``lcp`` (int32 [n1]) and ``bwt``.

    Returns (close, istart, ok): rank ``e`` carries ``close`` when a
    candidate interval [istart[e] .. e] of depth lcp[e] ends there and
    ``ok`` when its regular left-context characters are pairwise
    distinct (fsuper.c:75-124 semantics).  Elementwise ops and
    cumsum/cummax scans only."""
    i = torch.arange(n1, dtype=_I32, device=lcp.device)
    prev = torch.cat([lcp[:1], lcp[:-1]])             # lcp[i-1]
    nxt = torch.cat([lcp[1:], lcp[-1:]])              # lcp[i+1]
    rs = (i == 0) | (lcp != prev)                     # run start
    re_ = (i == n1 - 1) | (nxt != lcp)                # run end
    start_rising = rs & (i > 0) & (lcp > prev)
    end_falling = re_ & ((i == n1 - 1) | (nxt < lcp))
    run_start_idx = torch.cummax(torch.where(rs, i, -1), 0).values
    rev_key = torch.where(re_, n1 - 1 - i, -1)
    run_end_idx = n1 - 1 - _rcummax(rev_key)
    cand = (start_rising[run_start_idx.long()]
            & end_falling[run_end_idx.long()] & (lcp >= L))
    cand_start = cand & rs
    cand_end = cand & re_
    # interval over ranks: [s-1 .. e] for candidate run [s..e]
    open_ = torch.cat([cand_start[1:], cand_start.new_zeros(1)])
    close = cand_end
    copen = torch.cumsum(open_.to(_I32), 0, dtype=_I32)
    cclose = torch.cumsum(close.to(_I32), 0, dtype=_I32)
    cclose_excl = torch.cat([cclose.new_zeros(1), cclose[:-1]])
    member = (copen - cclose_excl) >= 1
    istart = torch.cummax(torch.where(open_, i, -1), 0).values
    # distinctness: a repeated regular bwt char within one interval
    bad = torch.zeros(n1, dtype=torch.bool, device=lcp.device)
    bwt_i = bwt.to(_I32)
    for c in range(sigma):
        occ = member & (bwt_i == c)
        occ_idx = torch.where(occ, i, -1)
        prev_occ = torch.cat([occ_idx.new_full((1,), -1),
                              torch.cummax(occ_idx, 0).values[:-1]])
        bad = bad | (occ & (prev_occ >= istart))
    badcum = torch.cumsum(bad.to(_I32), 0, dtype=_I32)
    base = torch.where(istart > 0, badcum[(istart - 1).clamp(min=0).long()],
                       0)
    ok = (badcum - base) == 0
    return close, istart, ok


def supermax_intervals_sharded(
    esa, searchlength: int, mesh: Mesh | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(left, right, depth) of supermaximal intervals, identical to
    engine.supermax.supermax_intervals, computed by the scan program:
    on the mesh's shards, or on ``esa.dev`` without a mesh.  Each shard
    keeps the ranks that close an interval whose left contexts are
    distinct; the host only joins them."""
    L = max(searchlength, 1)
    sigma = esa.alpha.num_regular
    n1 = int(esa.lcptab.size)
    if mesh is None:
        close, istart, ok = _supermax_flags(
            esa.device_lcp32(), esa.device("bwttab"), L, sigma, n1)
        e = torch.nonzero(close & ok).reshape(-1)
        left = istart[e].cpu().numpy().astype(np.int64)
        right = e.cpu().numpy().astype(np.int64)
    else:
        fm = _flat_mesh(mesh)
        n1p = ((n1 + fm.size - 1) // fm.size) * fm.size
        lcp_np = esa.lcptab.astype(np.int32)
        bwt_np = esa.bwttab
        if n1p != n1:
            # pad lcp with -1: matches the monolith's virtual
            # next_val = -1 after the last run (no spurious intervals,
            # last real run still ends falling)
            lcp_np = np.concatenate([lcp_np,
                                     np.full(n1p - n1, -1, np.int32)])
            bwt_np = np.concatenate([bwt_np,
                                     np.full(n1p - n1, 255, np.uint8)])
        spec = flat_spec(fm, n1p)
        devs = [fm.device(i) for i in fm.local]
        lcp = [torch.from_numpy(lcp_np[s]).to(d) for s, d in zip(spec, devs)]
        bwt = [torch.from_numpy(bwt_np[s]).to(d) for s, d in zip(spec, devs)]
        close, istart, ok = _supermax_flags_sharded(fm, lcp, bwt, n1p, L,
                                                    sigma)
        keep = [torch.nonzero(c & k).reshape(-1)
                for c, k in zip(close, ok)]
        left = collect(fm, [st[e] for st, e in zip(istart, keep)])
        right = collect(fm, [e + s.start for e, s in zip(keep, spec)])
        left, right = left.astype(np.int64), right.astype(np.int64)
    return left, right, esa.lcptab[right].astype(np.int64)


# ---------------------------------------------------------------------------
# sharded complete-match interval lookup + records
# ---------------------------------------------------------------------------


def exact_interval_lookup_sharded(
    esa, patterns: np.ndarray, plens: np.ndarray, mesh: Mesh
) -> tuple[np.ndarray, np.ndarray]:
    """Rank interval [lo, hi) of whole patterns via superbucket-sharded
    binary search.  Bit-identical to engine.complete's monolithic
    exact_interval_lookup (the occurrence set of a pattern is one
    contiguous rank interval, so psum of local counts + pmin of local
    first ranks restores it exactly).  The JAX module's
    ``_sharded_lookup_fn`` is the program of
    :func:`~vstree_tpu_torch.parallel.mesh.sharded_exact_match`, which
    this calls."""
    B, maxplen = patterns.shape
    n = int(esa.totallength)
    sp = mesh.shape["sp"]
    dp = mesh.shape["dp"]
    R = ((n + 1 + sp - 1) // sp) * sp
    suf_pad = np.full(R, n, np.int32)
    suf_pad[: n + 1] = esa.suftab
    Bp = ((B + dp - 1) // dp) * dp
    pat_pad = np.full((Bp, maxplen), -1, np.int32)
    pat_pad[:B] = patterns
    plen_pad = np.zeros(Bp, np.int32)
    plen_pad[:B] = plens

    counts, first = sharded_exact_match(
        mesh, esa.multiseq.sequence, suf_pad, pat_pad, plen_pad)
    counts = counts.cpu().numpy()[:B]
    first = first.cpu().numpy()[:B]
    lo = np.where(counts > 0, first, 0)
    hi = lo + np.where(counts > 0, counts, 0)
    # clamp to the real rank range (padded sentinel ranks never match
    # a regular pattern: their key is position-ordered special)
    return lo.astype(np.int64), np.minimum(hi, n + 1).astype(np.int64)


def sharded_exact_match_records(mesh: Mesh, text, suftab, patterns, plens,
                                cap: int):
    """Full match records on the shards: per-shard interval expansion
    into a ``cap``-bounded buffer of (global rank, text position),
    gathered over the rank shards.  Inputs as for
    :func:`~vstree_tpu_torch.parallel.mesh.sharded_exact_match`.
    Returns, int64 on the first local device,

    - counts  [B]           total occurrences per pattern
    - ranks   [S, B, cap]   global ranks, shard-major (= ascending
                            global rank order, the reference emission
                            order, exactcompl.c:156-164); -1 unused
    - pos     [S, B, cap]   text positions (suftab[rank]); -1 unused
    - shard_counts [S, B]   per-shard counts (overflow detection:
                            shard_counts > cap => re-fetch on host)
    """
    shards = _lookup_shards(mesh, text, suftab, patterns, plens)
    ranks, pos = [], []
    for lo, _, cnt, base, suf in shards:
        k = torch.arange(cap, dtype=_I64, device=lo.device)[None, :]
        valid = k < cnt[:, None]
        local_rank = (lo[:, None] + k).clamp(max=suf.numel() - 1)
        ranks.append(torch.where(valid, base + lo[:, None] + k, -1))
        pos.append(torch.where(valid, suf[local_rank], -1))
    cnts = [s[2] for s in shards]
    total = psum(mesh, cnts, "sp")
    return (gather_dp(mesh, total),
            gather_dp(mesh, all_gather(mesh, ranks, "sp"), dim=1),
            gather_dp(mesh, all_gather(mesh, pos, "sp"), dim=1),
            gather_dp(mesh, all_gather(mesh, cnts, "sp"), dim=1))


# ---------------------------------------------------------------------------
# -numproc plumbing
# ---------------------------------------------------------------------------


def numproc_mesh(numproc: int, devices) -> Mesh:
    """Mesh over the first ``numproc`` of ``devices``, the devices that
    ``-numproc`` may take (reference -numproc, parsevm.c:877 /
    vdfstrav.c:419-499: distribute the rank range to p processors)."""
    devs = list(devices)
    if numproc > len(devs):
        raise SystemExit(
            f"vmatch: -numproc {numproc} exceeds the {len(devs)} "
            "available devices"
        )
    return make_mesh(devs[:numproc])
