"""The greedy edit-extension fronts as torch programs on the device of a
:class:`~vstree_tpu_torch.engine.gextend.Seqs`.  Port of
:mod:`vstree_tpu.engine.gextend_dev`, same names.

The fronts are the batched form of the reference's per-seed greedy
Ukkonen fronts (src/kurtz/front.gen + frontSEP.c + extendED.c:78-200):

- the [S, maxdist+1, 2*maxdist+1] front tensor advances one level at a
  time for all seeds of a chunk,
- the diagonal slides run through the compacted packed-word LCE ladder
  of index/sort.py (two-text form; backward slides use the reversed
  texts' tables), so deep exact runs cost their own tail,
- the extendED.c:141-200 viability prefilter (max left + max right
  extension >= remaining length) is evaluated on the device, so only
  the surviving seeds' fronts are ever downloaded.

The (dist, l, r, diag, diag) combination stays on the host
(``gextend._extend_combine``).  Semantics are those of the JAX
package's host ``edit_fronts`` (r-masking, separator bounds, the
same-pointer self-overlap shortcut, foundseed early stop); the tests
hold the results equal.

Departures from the JAX module, none of which changes a result: the
level loop is the host-looped one (the fused one-dispatch form and its
overflow re-run exist for XLA), lane arithmetic is int64 on [S, D]
tensors, and :func:`edit_fronts_viable` takes the seeds in chunks sized
from the free device memory, keeping only each chunk's survivors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.chardef import SEPARATOR, WILDCARD
from ..device import count, phase
from ..index.sort import _lce_tables, device_lce_pairs, lce_pack_params

NEG32 = -(1 << 30)           # undefined front entry on the device
_NEG_HOST = -(1 << 40)       # engine/gextend.NEG, the host's sentinel
_I32 = torch.int32
_I64 = torch.int64

# seeds per chunk of edit_fronts_viable; None: from the device's free
# memory (the tests force a small value)
_CHUNK_SEEDS: int | None = None
_LANE_BYTES = 256            # peak bytes per (seed, diagonal) lane


def _prevsep_table(seq: torch.Tensor, n: int) -> torch.Tensor:
    """Position of the last SEPARATOR at or before each position, -1
    where there is none."""
    pos = torch.arange(n, dtype=_I32, device=seq.device)
    return torch.cummax(torch.where(seq == SEPARATOR, pos, -1), 0).values


def _nextsep_table(seq: torch.Tensor, n: int) -> torch.Tensor:
    """Position of the first SEPARATOR at or after each position, 2n
    where there is none."""
    pos = torch.arange(n, dtype=_I32, device=seq.device)
    v = torch.where(seq == SEPARATOR, pos, 2 * n)
    return torch.flip(torch.cummin(torch.flip(v, [0]), 0).values, [0])


def _dev_tables(sq):
    """Separator-distance and packed-word tables for both texts and
    their reversals, made once per Seqs object."""
    cache = getattr(sq, "_dev_tabs", None)
    if cache is None:
        n1, n2 = sq.n1, sq.n2
        regmax = int(sq.s1[sq.s1 < WILDCARD].max(initial=1))
        if sq.s2 is not sq.s1:
            regmax = max(regmax,
                         int(sq.s2[sq.s2 < WILDCARD].max(initial=1)))
        sigma = regmax + 1
        bits, D = lce_pack_params(sigma)
        p1 = _prevsep_table(sq.d_s1, n1)
        x1 = _nextsep_table(sq.d_s1, n1)
        Pf1 = _lce_tables(sq.d_s1, n1, bits, D)
        Pb1 = _lce_tables(sq.d_r1, n1, bits, D)
        if sq.s2 is sq.s1:
            p2, x2, Pf2, Pb2 = p1, x1, Pf1, Pb1
        else:
            p2 = _prevsep_table(sq.d_s2, n2)
            x2 = _nextsep_table(sq.d_s2, n2)
            Pf2 = _lce_tables(sq.d_s2, n2, bits, D)
            Pb2 = _lce_tables(sq.d_r2, n2, bits, D)
        cache = dict(sigma=sigma, p1=p1, x1=x1, p2=p2, x2=x2,
                     Pf1=Pf1, Pb1=Pb1, Pf2=Pf2, Pb2=Pb2)
        sq._dev_tabs = cache
    return cache


def _sep_left(prevsep, start, n: int):
    """#chars strictly left of ``start`` before the first SEPARATOR."""
    p = (start - 1).clamp(-1, n - 1)
    ps = torch.where(p >= 0, prevsep[p.clamp(min=0)].to(_I64), -1)
    return torch.where(p < 0, 0, p - ps)


def _sep_right(nextsep, start, n: int):
    """#chars from ``start`` rightward before the first SEPARATOR."""
    s = start.clamp(0, n - 1)
    ns = torch.where(start < n, nextsep[s].to(_I64), start)
    return (ns.clamp(max=n) - start).clamp(min=0)


def _level_pre(prev, base1, base2, ulen, vlen, maxdist: int,
               forward: bool, selfsame: bool, n1: int, n2: int, p: int):
    """Phase A of front level p: candidate values and slide probes, all
    [S, D] (int64 or bool)."""
    S = prev.shape[0]
    ks = torch.arange(-maxdist, maxdist + 1, dtype=_I64,
                      device=prev.device)[None, :]
    undef = prev.new_full((S, 1), NEG32)
    same = prev + 1
    below = torch.cat([undef, prev[:, :-1]], dim=1)
    above = torch.cat([prev[:, 1:] + 1, undef], dim=1)
    t = torch.maximum(same, torch.maximum(below, above))
    # r-masking (frontspecparms): r = p - min(ulen, vlen)
    r = (p - torch.minimum(ulen, vlen))[:, None]
    valid_k = ks.abs() <= p
    valid_k = valid_k & ((r <= 0) | (ks <= -r) | (ks >= r))
    valid_k = valid_k & (ks >= -ulen[:, None]) & (ks <= vlen[:, None])
    t = torch.where(valid_k, t, NEG32)
    # an undefined predecessor gives NEG32 + 1 here: only this mask
    # turns it back into NEG32
    bad = (t < 0) | (t + ks < 0)
    tv = torch.where(bad, NEG32, t)

    act = tv > NEG32
    tvc = torch.where(act, tv, 0)
    if forward:
        a = base1[:, None] + tvc
        b = base2[:, None] + tvc + ks
        ar, br = a, b
    else:
        a = base1[:, None] - tvc
        b = base2[:, None] - (tvc + ks)
        # backward lce == forward lce on the reversed texts
        ar = (n1 - 1) - a
        br = (n2 - 1) - b
    same_ptr = act & (a == b) if selfsame else torch.zeros_like(act)
    # out-of-range probes (base beyond either text) never match; a probe
    # at exactly n goes through, and the ladder gives it 0
    inb = (ar >= 0) & (ar <= n1) & (br >= 0) & (br <= n2)
    probe = act & ~same_ptr & inb
    return tv, ks, act, same_ptr, ar.clamp(0, n1), br.clamp(0, n2), probe


def _level_post(tv, ks, act, same_ptr, run, fronts, h, finished,
                foundseed, ulen, vlen, bound_u, bound_v, reach: int,
                maxdist: int, forward: bool, p: int):
    """Phase B: apply slide results, bounds, foundseed and the
    finished/h bookkeeping for level p (``fronts`` is written in
    place)."""
    ulen_l = ulen[:, None]
    vlen_l = vlen[:, None]
    tvc = torch.where(act, tv, 0)
    tv2 = torch.where(same_ptr, ulen_l - 1, tvc + run)
    if (not forward) and reach > 0:
        fs = act & (~same_ptr) & (run >= reach)
    else:
        fs = torch.zeros_like(act)
    bu_l = bound_u[:, None]
    bv_l = bound_v[:, None]
    # same-pointer entries skip the slide, so only the INITIAL separator
    # bound applies to them (frontSEP.c scans at most maxdist+1 chars
    # up front)
    init_u = torch.where(bu_l <= maxdist, bu_l, ulen_l)
    init_v = torch.where(bv_l <= maxdist, bv_l, vlen_l)
    bu = torch.where(same_ptr, init_u, bu_l)
    bv = torch.where(same_ptr, init_v, bv_l)
    over = (tv2 > bu) | (tv2 + ks > bv)
    newval = torch.where(fs | over, NEG32, tv2)
    t = torch.where(act, newval, tv)
    foundseed = foundseed | fs.any(dim=1)

    t = torch.where(finished[:, None], NEG32, t)
    fronts[:, p, :] = t
    defined = (t > NEG32).any(dim=1)
    # extendedleftSEP: foundseed with a defined front -> h = p
    stop_seed = (~finished) & defined & foundseed
    h = torch.where(stop_seed, p, h)
    finished = finished | stop_seed
    stop_undef = (~finished) & ~defined
    h = torch.where(stop_undef, p - 1, h)
    finished = finished | stop_undef
    return h, finished, foundseed


def _fronts_direction(sq, tabs, base1, base2, ulen, vlen,
                      maxdist: int, forward: bool, reach: int):
    """One direction's fronts for the seeds given (int64 [S] tensors):
    the level loop, with the two-text LCE ladder doing the slides.
    Returns (fronts int32 [S, maxdist+1, 2*maxdist+1], h int64 [S])."""
    S = int(base1.shape[0])
    D = 2 * maxdist + 1
    n1, n2 = sq.n1, sq.n2
    dev = base1.device
    Pa = tabs["Pf1"] if forward else tabs["Pb1"]
    Pb = tabs["Pf2"] if forward else tabs["Pb2"]
    bound_u = torch.minimum(
        ulen,
        _sep_right(tabs["x1"], base1, n1) if forward
        else _sep_left(tabs["p1"], base1 + 1, n1))
    bound_v = torch.minimum(
        vlen,
        _sep_right(tabs["x2"], base2, n2) if forward
        else _sep_left(tabs["p2"], base2 + 1, n2))
    selfsame = sq.s2 is sq.s1
    fronts = torch.full((S, maxdist + 1, D), NEG32, dtype=_I32, device=dev)
    fronts[:, 0, maxdist] = 0
    finished = (ulen == 0) & (vlen == 0)
    h = torch.where(finished, 0, maxdist)
    foundseed = torch.zeros(S, dtype=torch.bool, device=dev)
    for p in range(1, maxdist + 1):
        tv, ks, act, same_ptr, ar, br, probe = _level_pre(
            fronts[:, p - 1, :].to(_I64), base1, base2, ulen, vlen,
            maxdist, forward, selfsame, n1, n2, p)
        # lanes that do not probe keep a slide of 0
        run = device_lce_pairs(
            None, n1, tabs["sigma"], ar.reshape(-1), br.reshape(-1),
            S * D, tables=Pa, tables_b=Pb, nb=n2,
            active0=probe.reshape(-1)).reshape(S, D)
        h, finished, foundseed = _level_post(
            tv, ks, act, same_ptr, run, fronts, h, finished, foundseed,
            ulen, vlen, bound_u, bound_v, reach, maxdist, forward, p)
    return fronts, h


def _maxext_device(fr, h, maxdist: int):
    """extendED.c:141-200 prefilter value: max seq2-side extension
    over all usable front entries, int64 [S]."""
    ks = torch.arange(-maxdist, maxdist + 1, dtype=_I64, device=fr.device)
    m = torch.zeros(fr.shape[0], dtype=_I64, device=fr.device)
    for p in range(maxdist + 1):
        vals = fr[:, p, :].to(_I64)
        ok = (vals > NEG32) & (p <= h[:, None])
        v = torch.where(ok, vals + ks[None, :], 0)
        m = torch.maximum(m, v.max(dim=1).values)
    return m


def _chunk_seeds(device: torch.device, maxdist: int) -> int:
    """Seeds per chunk: a quarter of the card's free memory over the
    bytes a seed takes at its peak (its lanes in the ladder and both
    directions' fronts)."""
    if _CHUNK_SEEDS is not None:
        return _CHUNK_SEEDS
    if device.type != "cuda":
        return 1 << 20
    D = 2 * maxdist + 1
    per_seed = D * _LANE_BYTES + 2 * (maxdist + 1) * D * 4
    free = torch.cuda.mem_get_info(device)[0]
    return int(min(max(free // 4 // per_seed, 1 << 16), 1 << 23))


def edit_fronts_viable(sq, pos1, pos2, slen, maxdist: int,
                       leastlength: int, seedlength: int):
    """Both directions' fronts + the viability prefilter on the device
    of ``sq``, for seeds given as host arrays or as tensors there.

    Returns (vidx, lf, hl, rf, hr) with the front tensors already
    compacted to the viable seeds (host int64 arrays, undefined entries
    the host's sentinel).  The seeds go through in chunks; of each chunk
    only the viability mask's survivors and their fronts are kept."""
    S = int(pos1.shape[0])
    n1, n2 = sq.n1, sq.n2
    dev = sq.device
    tabs = _dev_tables(sq)

    def part(col, lo, hi):
        if isinstance(col, np.ndarray):
            return torch.from_numpy(col[lo:hi].astype(np.int64)).to(dev)
        return col[lo:hi].to(_I64)        # already on the device

    chunk = _chunk_seeds(dev, maxdist)
    kept = []
    for lo in range(0, S, chunk):
        hi = min(lo + chunk, S)
        p1 = part(pos1, lo, hi)
        p2 = part(pos2, lo, hi)
        sl = part(slen, lo, hi)
        with phase("fronts left"):
            lf, hl = _fronts_direction(
                sq, tabs, p1 - 1, p2 - 1, p1, p2, maxdist,
                forward=False, reach=seedlength)
        with phase("fronts right"):
            rf, hr = _fronts_direction(
                sq, tabs, p1 + sl, p2 + sl,
                n1 - (p1 + sl), n2 - (p2 + sl), maxdist,
                forward=True, reach=0)
        with phase("viability"):
            remain = (leastlength - sl).clamp(min=0)
            viable = (_maxext_device(lf, hl, maxdist)
                      + _maxext_device(rf, hr, maxdist)) >= remain
            sel = torch.nonzero(viable)[:, 0]
            if sel.numel():
                kept.append((sel + lo, lf[sel], hl[sel], rf[sel], hr[sel]))
    count("seeds", S)
    count("viable seeds", sum(int(k[0].numel()) for k in kept))
    z = np.zeros(0, np.int64)
    if not kept:
        return z, None, z, None, z
    with phase("fronts to host"):
        vidx, lf_h, hl_h, rf_h, hr_h = (
            torch.cat(col).cpu().numpy().astype(np.int64)
            for col in zip(*kept))
    lf_h[lf_h <= NEG32] = _NEG_HOST
    rf_h[rf_h <= NEG32] = _NEG_HOST
    return vidx, lf_h, hl_h, rf_h, hr_h
