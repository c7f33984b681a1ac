"""Maximal-repeat enumeration as torch programs on ``esa.dev``.
Port of :mod:`vstree_tpu.engine.repeats_dev`, same names.

The host path in :mod:`vstree_tpu_torch.engine.repeats` reformulates the
reference's bottom-up traversal (src/Vmengine/vmatfind.c:240-541) into
flat array ops: lcp>=L run detection, triangular pair expansion, RMQ
depths, left-diversity on bwt, and the computed reference emission key
restored by one lexicographic sort.  This module runs those same flat
programs in torch ops on the device of the index:

- run detection: one pass over the lcp array, the run lists come to the
  host once,
- the sparse table over lcp holds only the levels that the widest
  lcp>=L run needs (queries and event-time descents never leave a run),
- per chunk of expanded pairs (bounded by ``_PAIR_CHUNK``), phase 1
  decodes the pairs, filters them by left diversity and compacts the
  survivors; phase 1 is queued for every chunk before the survivor counts
  are read in ONE transfer; phase 2 then computes depths, event times
  and the emission order at the tight surviving widths.

Departures from the JAX module, none of which changes a result: tensors
have their true sizes (no padding to compile-cache-friendly shapes, so
no ``live``/``valid`` masks), columns come back as they are (no 20-bit
pair packing, no int16 depths), index arithmetic is int64, the
triangular decode estimates in float64, the logarithm of a query width
is a ``bucketize`` over the powers of two instead of a table of n
entries, and the run id of a pair is a ``repeat_interleave`` instead of
a scatter and a running maximum.

The emission order semantics are documented in engine/repeats.py
(matching vmatfind.c cartproduct1/2 + vdfstrav.c pop cascades); this
module reproduces them key for key.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import phase
from ..index.esa import ESA
from . import repeats as _host

_PAIR_CHUNK = 1 << 22   # expanded pairs per chunk; also the widest run
_I32 = torch.int32
_I64 = torch.int64


def _lexsort(keys) -> torch.Tensor:
    """``np.lexsort``: the permutation that sorts by the LAST key first,
    ties by the one before, and so on: successive stable sorts."""
    order = torch.argsort(keys[0], stable=True)
    for key in keys[1:]:
        order = order[torch.argsort(key[order], stable=True)]
    return order


# ---------------------------------------------------------------------------
# RMQ sparse table on device
# ---------------------------------------------------------------------------


def _rmq_levels(maxw: int) -> int:
    """Levels of the sparse table that ranges and descents inside a run
    of ``maxw`` ranks need: windows of up to 2^(levels-1) >= maxw + 1."""
    return max(1, int(maxw).bit_length() + 1)


def _rmq_build(lcp: torch.Tensor, levels: int) -> torch.Tensor:
    """int32 [levels, n1]: ``table[k, i] = min lcp[i .. i + 2^k - 1]``,
    over the part of the window that lies inside the array."""
    n1 = lcp.numel()
    table = torch.empty((levels, n1), dtype=_I32, device=lcp.device)
    table[0] = lcp
    for k in range(1, levels):
        half = 1 << (k - 1)
        prev = table[k - 1]
        table[k] = prev
        if half < n1:
            torch.minimum(prev[:n1 - half], prev[half:],
                          out=table[k, :n1 - half])
    return table


def _rmq_query(table: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """min lcp[lo..hi] inclusive (lo <= hi, width < 2^levels), int64."""
    levels, n1 = table.shape
    pows = 1 << torch.arange(1, levels, dtype=_I64, device=table.device)
    k = torch.bucketize(hi - lo + 1, pows, right=True)   # floor(log2 width)
    flat = table.reshape(-1)
    a = flat[k * n1 + lo]
    b = flat[k * n1 + hi - (1 << k) + 1]
    return torch.minimum(a, b).to(_I64)


# ---------------------------------------------------------------------------
# run detection
# ---------------------------------------------------------------------------


def _runs(lcp: torch.Tensor, L: int):
    """(left, right) rank intervals of the maximal lcp>=L runs, int64 on
    the device (a run over lcp indices [s..e] covers ranks [s-1..e])."""
    ge = lcp >= L
    pad = torch.zeros(1, dtype=torch.bool, device=lcp.device)
    starts = torch.nonzero(ge & ~torch.cat([pad, ge[:-1]]))[:, 0]
    ends = torch.nonzero(ge & ~torch.cat([ge[1:], pad]))[:, 0]
    return starts - 1, ends


# ---------------------------------------------------------------------------
# pair chunk: expand + diverse + depth + event time + emission sort
# ---------------------------------------------------------------------------


def _left_keys(bwt, ranks, sigma: int):
    """Left-context key (vmatfind.c ISLEFTDIVERSE): regular bwt chars by
    value, specials and suffix 0 unique by their rank."""
    b = bwt[ranks].to(_I64)
    return torch.where(b < sigma, b, 256 + ranks)


def _triangular_decode(pidx, kk):
    """Pair number ``pidx`` of a run of ``kk`` ranks -> offsets (s, t),
    s < t, pairs in lexicographic order: a float64 estimate of the row
    and an exact integer correction."""
    twok = (2 * kk - 1).to(torch.float64)
    s = torch.floor((twok - torch.sqrt(
        (twok * twok - 8.0 * pidx.to(torch.float64)).clamp(min=0.0)))
        / 2.0).to(_I64)
    top = (kk - 2).clamp(min=0)
    s = torch.minimum(s.clamp(min=0), top)

    def before(x):
        return x * (2 * kk - x - 1) // 2

    for _ in range(3):
        s = torch.where(before(s) > pidx, s - 1, s)
        s = torch.where(before(s + 1) <= pidx, s + 1, s)
    s = torch.minimum(s.clamp(min=0), top)
    return s, pidx - before(s) + s + 1


def _pairs_phase1(bwt, left, right, T: int, sigma: int):
    """Phase 1 of a pair chunk: triangular decode + left-diversity
    filter + compaction of the surviving (ri, rj) to the front of two
    int32 [T + 1] buffers (slot T takes the writes of the others), and
    the survivor count as a 0-d tensor: nothing here waits for the
    device.

    Only the diverse minority ever reaches phase 2, so the RMQ depths,
    event times and the emission sort run at the tight surviving width
    instead of the full expansion."""
    dev = left.device
    kk_run = right - left + 1
    npairs = (kk_run * (kk_run - 1)) // 2
    cum0 = torch.cumsum(npairs, 0) - npairs
    iv = torch.repeat_interleave(
        torch.arange(left.numel(), dtype=_I64, device=dev), npairs,
        output_size=T)
    pidx = torch.arange(T, dtype=_I64, device=dev) - cum0[iv]
    s, t_off = _triangular_decode(pidx, kk_run[iv])
    ri = left[iv] + s
    rj = left[iv] + t_off
    diverse = _left_keys(bwt, ri, sigma) != _left_keys(bwt, rj, sigma)
    csum = torch.cumsum(diverse, 0)
    dst = torch.where(diverse, csum - 1, T)
    ri_c = torch.empty(T + 1, dtype=_I32, device=dev).scatter_(
        0, dst, ri.to(_I32))
    rj_c = torch.empty(T + 1, dtype=_I32, device=dev).scatter_(
        0, dst, rj.to(_I32))
    return ri_c, rj_c, csum[-1]


def _event_times(rmq, rj, d, steps: int):
    """First r >= rj with lcp[r+1] <= d: aligned-window sparse-table
    descent, ONE gather per level.  ``steps`` is bounded by the widest
    run (events never leave the pair's own lcp>=L run, since
    lcp[run_end+1] < L <= d), so ``t + 2^e`` stays far below the int
    range whatever the table's length."""
    n1 = rmq.shape[1]
    t_ev = rj
    for e in range(steps - 1, -1, -1):
        probe = rmq[e][(t_ev + 1).clamp(max=n1 - 1)]
        t_ev = torch.where((probe > d) & (t_ev + (1 << e) < n1),
                           t_ev + (1 << e), t_ev)
    return t_ev


def _emission_order(rmq, bwt, ri, rj, d, steps: int, sigma: int):
    """Reference emission-order permutation of (ri, rj, d) pairs, int64
    tensors (engine/repeats.py, "Reference emission order"): event time,
    depth descending, then the class order of cartproduct1/2.  Distinct
    pairs have distinct keys, and event times are globally comparable,
    so sorting any subset of the pairs reproduces the enumeration
    order."""
    t_ev = _event_times(rmq, rj, d, steps)
    # class = bwt char for regular left context, sigma for the unique
    # list; son-unique pairs swap (vmatfind.c:282-290)
    F = _left_keys(bwt, ri, sigma).clamp(max=sigma)
    Sc = _left_keys(bwt, rj, sigma).clamp(max=sigma)
    swap = (F < sigma) & (Sc == sigma)
    X = torch.where(swap, rj, ri)
    Y = torch.where(swap, ri, rj)
    A = torch.where(F == sigma, X, Sc)
    Bk = torch.where(F == sigma, Sc, X)
    return _lexsort((Y, Bk, A, F, -d, t_ev))


def _pairs_phase2(rmq, bwt, ri, rj, steps: int, sigma: int,
                  want_order: bool):
    """Phase 2 over the compacted diverse pairs (int64): RMQ depth and,
    with ``want_order``, the emission order.  Returns (ri, rj, d)."""
    d = _rmq_query(rmq, ri + 1, rj)
    if not want_order:
        return ri, rj, d
    order = _emission_order(rmq, bwt, ri, rj, d, steps, sigma)
    return ri[order], rj[order], d[order]


# ---------------------------------------------------------------------------
# the whole enumeration
# ---------------------------------------------------------------------------


def _chunk_bounds(npairs: np.ndarray) -> list[int]:
    """Chunk borders on run boundaries, bounded expanded pair count: the
    borders of engine/repeats.py ``_iter_pair_chunks``, found by one
    search per chunk instead of a walk over the runs."""
    cum = np.cumsum(npairs)
    bounds = [0]
    last = 0
    while True:
        # the first run past the last border that overflows the chunk
        i = max(int(np.searchsorted(cum, last + _PAIR_CHUNK, side="right")),
                bounds[-1] + 1)
        if i >= npairs.size:
            break
        bounds.append(i)
        last = int(cum[i - 1])
    bounds.append(npairs.size)
    return bounds


def _pair_positions(esa: ESA, got):
    """(pos_min, pos_max, depth, ri, rj) device tensors of the per-chunk
    column lists of :func:`maximal_pairs_device`, and the pair count."""
    d_parts, i_parts, j_parts = got
    if not i_parts:
        z = torch.zeros(0, dtype=_I64, device=esa.dev)
        return (z,) * 5, 0
    ri = torch.cat(i_parts)
    rj = torch.cat(j_parts)
    suftab = esa.device_suf32()
    p1 = suftab[ri].to(_I64)
    p2 = suftab[rj].to(_I64)
    return ((torch.minimum(p1, p2), torch.maximum(p1, p2),
             torch.cat(d_parts), ri, rj), int(ri.numel()))


def maximal_pairs_device_seeds(esa: ESA, searchlength: int,
                               table_out: dict | None = None):
    """Unordered seed variant: (pos_min, pos_max, depth, ri, rj) DEVICE
    tensors without the full-width emission sort; the caller restores
    reference order on its (small) survivor subset via
    :func:`_emission_order`, with the sparse table and its level count
    that ``table_out`` receives as ``rmq`` and ``steps``.  Returns None
    on the pathological-run guard."""
    got = maximal_pairs_device(esa, searchlength, ref_order=False,
                               device_out=True, table_out=table_out)
    return None if got is None else _pair_positions(esa, got)


def maximal_pairs_device_positions(esa: ESA, searchlength: int):
    """Seed variant: all maximal pairs in reference emission order as
    DEVICE tensors (pos_min, pos_max, depth) plus the count, for a
    consumer on the device.  Returns None when the pathological-run
    guard fires (the host path applies)."""
    got = maximal_pairs_device(esa, searchlength, ref_order=True,
                               device_out=True)
    if got is None:
        return None
    cols, count = _pair_positions(esa, got)
    return cols[:3], count


def maximal_pairs_device(esa: ESA, searchlength: int,
                         ref_order: bool = True,
                         device_out: bool = False,
                         table_out: dict | None = None):
    """(d, rank_i, rank_j) of all maximal pairs, reference emission
    order (or unordered when ref_order=False), computed on ``esa.dev``.
    Returns host int64 arrays; with ``device_out`` returns the per-chunk
    DEVICE column lists (or None on the pathological-run guard).  A
    ``table_out`` dict receives the sparse table (``rmq``) and its level
    count (``steps``) when pairs were enumerated.

    The compacted survivors of phase 1 wait on the device, 8 bytes per
    expanded pair, until the one transfer of the counts."""
    L = max(searchlength, 1)
    with phase("lcp/bwt to card"):
        lcp = esa.device_lcp32()
        bwt = esa.device("bwttab")
    z = np.zeros(0, np.int64)
    empty = ([], [], []) if device_out else (z, z, z)
    with phase("runs"):
        left_d, right_d = _runs(lcp, L)
        left, right = torch.stack([left_d, right_d]).cpu().numpy()
    if left.size == 0:
        return empty
    m = right - left + 1
    npairs = (m * (m - 1)) // 2

    if int(npairs.max()) > _PAIR_CHUNK:
        # a single run expanding past the chunk budget (more than ~2900
        # equal suffixes at depth >= L) takes the exact host path, as in
        # the reference package
        if device_out:
            return None
        return _host.maximal_pairs_ref_order_vec(esa, searchlength)

    sigma = esa.alpha.num_regular
    steps = _rmq_levels(int(m.max()))
    with phase("sparse table"):
        rmq = _rmq_build(lcp, steps)
    if table_out is not None:
        table_out.update(rmq=rmq, steps=steps)

    # phase 1 for every chunk up front, then ONE transfer of the
    # surviving counts, then phase 2 at tight widths
    with phase("pairs phase 1"):
        bounds = _chunk_bounds(npairs)
        p1 = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            T = int(npairs[a:b].sum())
            if T:
                p1.append(_pairs_phase1(bwt, left_d[a:b], right_d[a:b], T,
                                        sigma))
        cnts = torch.stack([c for _, _, c in p1]).tolist()

    with phase("pairs phase 2"):
        parts = [_pairs_phase2(rmq, bwt, ri_c[:cnt].to(_I64),
                               rj_c[:cnt].to(_I64), steps, sigma, ref_order)
                 for (ri_c, rj_c, _), cnt in zip(p1, cnts) if cnt]
        if device_out:
            return ([d for _, _, d in parts], [ri for ri, _, _ in parts],
                    [rj for _, rj, _ in parts])
        if not parts:
            return z, z, z
        ri, rj, d = (torch.cat(col).cpu().numpy() for col in zip(*parts))
        return d, ri, rj
