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
  extension >= remaining length) is evaluated on the device, and the
  surviving seeds' fronts stay there,
- the (dist, l, r, diag, diag) combination (extendED.c:200-355) runs
  over the survivors' fronts as torch ops (:func:`combine_fronts`), and
  only the winners (or the ``-allmax`` emission stream) are downloaded.

Semantics are those of the JAX package's host ``edit_fronts`` (r-masking,
separator bounds, the same-pointer self-overlap shortcut, foundseed
early stop) and ``_extend_combine`` (loop order, SEPARATOR trimming,
acceptmatch, E-values, the replacement rule); the tests hold the results
equal.

Departures from the JAX module, none of which changes a result: the
level loop is the host-looped one (the fused one-dispatch form and its
overflow re-run exist for XLA), lane arithmetic is int64 on [S, D]
tensors, :func:`edit_fronts_viable_device` takes the seeds in chunks
sized from the free device memory, keeping only each chunk's survivors,
and :func:`edit_fronts_viable` is that function plus one download.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.chardef import SEPARATOR, WILDCARD
from ..device import count, phase
from ..index.sort import _lce_tables, device_lce_pairs, lce_pack_params
from ..stats.evalues import AVERAGEQUOT, MAXEXPONENTOF2

NEG32 = -(1 << 30)           # undefined front entry on the device
_NEG_HOST = -(1 << 40)       # engine/gextend.NEG, the host's sentinel
_I32 = torch.int32
_I64 = torch.int64

# seeds per chunk of the fronts and of the combination; None: from the
# device's free memory (the tests force a small value)
_CHUNK_SEEDS: int | None = None
_LANE_BYTES = 256            # peak bytes per (seed, diagonal) lane
# the combination's working set per chunk on a card, and its bytes per
# survivor besides its fronts widened to int64
_COMBINE_BYTES = 1 << 29
_COMBINE_SEED_BYTES = 384


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


def edit_fronts_viable_device(sq, pos1, pos2, slen, maxdist: int,
                              leastlength: int, seedlength: int):
    """Both directions' fronts + the viability prefilter on the device
    of ``sq``, for seeds given as host arrays or as tensors there.

    Returns (vidx, lf, hl, rf, hr) as tensors on that device, compacted
    to the viable seeds: vidx int64 [V], the fronts int32 [V, maxdist+1,
    2*maxdist+1] with undefined entries NEG32, hl/hr int64 [V].  The
    seeds go through in chunks; of each chunk only the viability mask's
    survivors and their fronts are kept."""
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
    if not kept:
        z = torch.zeros(0, dtype=_I64, device=dev)
        zf = torch.zeros((0, maxdist + 1, 2 * maxdist + 1), dtype=_I32,
                         device=dev)
        return z, zf, z, zf, z
    return tuple(torch.cat(col) for col in zip(*kept))


def edit_fronts_viable(sq, pos1, pos2, slen, maxdist: int,
                       leastlength: int, seedlength: int):
    """:func:`edit_fronts_viable_device`, downloaded: (vidx, lf, hl, rf,
    hr) as host int64 arrays, undefined front entries the host's
    sentinel; (empty, None, empty, None, empty) without a survivor."""
    got = edit_fronts_viable_device(sq, pos1, pos2, slen, maxdist,
                                    leastlength, seedlength)
    z = np.zeros(0, np.int64)
    if got[0].numel() == 0:
        return z, None, z, None, z
    with phase("fronts to host"):
        vidx, lf_h, hl_h, rf_h, hr_h = (
            col.cpu().numpy().astype(np.int64) for col in got)
    lf_h[lf_h <= NEG32] = _NEG_HOST
    rf_h[rf_h <= NEG32] = _NEG_HOST
    return vidx, lf_h, hl_h, rf_h, hr_h


# ---------------------------------------------------------------------------
# the (dist, l, r, diag, diag) combination (extendED.c:200-355)
# ---------------------------------------------------------------------------


def _combinations(maxdist: int) -> list[tuple[int, int, int, int, int]]:
    """(dist, li, ri, lki, rki) in the reference's loop order; the list
    index is the combination's key in the ``-allmax`` stream."""
    D = 2 * maxdist + 1
    return [(dist, li, dist - li, lki, rki)
            for dist in range(maxdist + 1)
            for li in range(max(0, dist - maxdist), dist + 1)
            for lki in range(D) for rki in range(D)]


def _combine_chunk(device: torch.device, maxdist: int, ncombos: int,
                   allmax: bool) -> int:
    """Survivors per chunk of :func:`combine_fronts`: its working set
    (the chunk's fronts as int64, the best-so-far state and one step's
    temporaries; with ``-allmax`` every combination's mask and four
    columns) within a quarter of the free memory and _COMBINE_BYTES."""
    if _CHUNK_SEEDS is not None:
        return _CHUNK_SEEDS
    if device.type != "cuda":
        return 1 << 20
    per_seed = (2 * (maxdist + 1) * (2 * maxdist + 1) * 8
                + _COMBINE_SEED_BYTES + (33 * ncombos if allmax else 0))
    free = torch.cuda.mem_get_info(device)[0]
    return int(max(min(free // 4, _COMBINE_BYTES) // per_seed, 1 << 10))


def _evalue_rows(ev, maxdist: int):
    """Per distance d <= maxdist, what ``Evalues.get_batch`` reads for
    multiplier 1 and edit distance d: (linestart of the row, first and
    end index of the row, scale), after growing the table as far as
    get_batch would."""
    kmax = min(maxdist, 20 + MAXEXPONENTOF2)
    if kmax + 1 > len(ev.linestart):
        ev._grow(kmax)
    ls = ev.linestart
    rows = []
    for d in range(maxdist + 1):
        kc = min(d, len(ls) - 1)
        row_end = (ls[kc + 1] + kc + 2 if kc + 1 < len(ls)
                   else len(ev.table))
        if d == 0:
            hequot = 1.0
        elif d <= 20:
            hequot = float(AVERAGEQUOT[d])
        elif d - 20 <= MAXEXPONENTOF2:
            hequot = float(1.31e+07 * np.exp2(np.float64(d - 20)))
        else:
            hequot = 0.0
        rows.append((ls[kc], ls[kc] + kc + 1, row_end, hequot))
    return rows


def combine_fronts(sq, ev, lf, hl, rf, hr, pos1, pos2, slen,
                   maxdist: int, leastlength: int, querycompare: bool,
                   selfmode: bool, allmax: bool, keys):
    """The (dist, l, r, diag, diag) combination of
    ``gextend._extend_combine`` over the survivors' fronts on the device
    of ``sq``: the fronts int32 with NEG32 (as
    :func:`edit_fronts_viable_device` gives them), ``hl``, ``hr``,
    ``pos1``, ``pos2``, ``slen`` and the key columns ``keys`` (int64
    [K, S]) tensors there.

    Each combination is one step over all survivor lanes of a chunk, in
    the reference's order, without a host read.  Best mode keeps the
    winner per survivor by ``gextend._better``'s rule (E-value, identity,
    length; a full tie goes to the later combination); ``-allmax`` keeps
    every accepted combination.  Returns None when nothing was accepted,
    else a host int64 array of rows p1, p2, l1, l2, dist, survivor
    index, combination key (``-allmax``; -1 in best mode), then the K
    key columns of the row's survivor: one download, in best mode in
    survivor order."""
    dev = sq.device
    S = int(pos1.shape[0])
    combos = _combinations(maxdist)
    ks = list(range(-maxdist, maxdist + 1))
    evrows = _evalue_rows(ev, maxdist)
    table = torch.from_numpy(np.asarray(ev.table, np.float64)).to(dev)
    last = max(int(table.numel()) - 1, 0)
    # SEPARATOR flags with a SEPARATOR on either side: an index clamped
    # to [-1, n] and shifted by one reads gextend._char's rule
    edge = torch.ones(1, dtype=torch.bool, device=dev)
    pad1 = torch.cat([edge, sq.d_s1 == SEPARATOR, edge])
    pad2 = (pad1 if sq.d_s2 is sq.d_s1
            else torch.cat([edge, sq.d_s2 == SEPARATOR, edge]))
    n1, n2 = sq.n1, sq.n2

    def sep(i, pad, n):
        return pad[(i + 1).clamp(0, n + 1)]

    swapping = selfmode and not querycompare
    level = torch.arange(maxdist + 1, device=dev)[None, :, None]
    combo_dist = torch.tensor([cb[0] for cb in combos], dtype=_I64,
                              device=dev)
    parts = []
    chunk = _combine_chunk(dev, maxdist, len(combos), allmax)
    for lo in range(0, S, chunk):
        hi = min(lo + chunk, S)
        L = lf[lo:hi].to(_I64)
        R = rf[lo:hi].to(_I64)
        # the front entries a combination may take: defined, at a level
        # within the side's usable depth
        Lok = (L > NEG32) & (level <= hl[lo:hi, None, None])
        Rok = (R > NEG32) & (level <= hr[lo:hi, None, None])
        q1, q2, sl = pos1[lo:hi], pos2[lo:hi], slen[lo:hi]
        remain = (leastlength - sl).clamp(min=0)
        m = hi - lo
        if allmax:
            oks = torch.empty((len(combos), m), dtype=torch.bool,
                              device=dev)
            cols = torch.empty((len(combos), 4, m), dtype=_I64, device=dev)
        else:
            best_e = torch.full((m,), float("inf"), dtype=torch.float64,
                                device=dev)
            best_id = torch.zeros(m, dtype=torch.float64, device=dev)
            best = torch.zeros((6, m), dtype=_I64, device=dev)
            found = torch.zeros(m, dtype=torch.bool, device=dev)
        for ci, (dist, li, ri, lki, rki) in enumerate(combos):
            lval = L[:, li, lki]
            rval = R[:, ri, rki]
            ok = Lok[:, li, lki] & Rok[:, ri, rki]
            exti = lval + rval
            extj = exti + (ks[lki] + ks[rki])
            ok = ok & (exti >= remain) & (extj >= remain)
            p1 = q1 - lval
            p2 = q2 - lval - ks[lki]
            l1 = sl + exti
            l2 = sl + extj
            if swapping:
                swap = p1 > p2
                p1, p2 = torch.where(swap, p2, p1), torch.where(swap, p1, p2)
                l1, l2 = torch.where(swap, l2, l1), torch.where(swap, l1, l2)
            # SEPARATOR edge trimming (extendED.c:268-285)
            l1 = l1 - sep(p1 + l1 - 1, pad1, n1).to(_I64)
            s1sep = sep(p1, pad1, n1).to(_I64)
            p1 = p1 + s1sep
            l1 = l1 - s1sep
            l2 = l2 - sep(p2 + l2 - 1, pad2, n2).to(_I64)
            s2sep = sep(p2, pad2, n2).to(_I64)
            p2 = p2 + s2sep
            l2 = l2 - s2sep
            if swapping:
                # acceptmatch (extendED.c:24-48)
                nolap = p1 + l1 - 1 < p2
                embedded = p1 + l1 >= p2 + l2
                nonover = (p2 - p1) + (p2 + l2) - (p1 + l1)
                ok = ok & (p1 < p2) & (nolap | (~embedded & (nonover > dist)))
            if allmax:
                oks[ci] = ok
                cols[ci] = torch.stack([p1, p2, l1, l2])
                continue
            length = torch.maximum(l1, l2)
            ls_k, row_start, row_end, hequot = evrows[dist]
            i = ls_k + length
            inrow = (i >= row_start) & (i < row_end)
            e = torch.where(inrow, table[i.clamp(0, last)], 0.0) * hequot
            ident = 100.0 * (1.0 - torch.div(
                torch.full_like(e, float(dist)),
                length.clamp(min=1).to(torch.float64)))
            # gextend._better: replace unless the old one is strictly
            # better (E-value asc, identity desc, length desc)
            keep = ((best_e < e)
                    | ((best_e == e) & (best_id > ident))
                    | ((best_e == e) & (best_id == ident)
                       & (best[4] > length)))
            repl = ok & (~found | ~keep)
            best_e = torch.where(repl, e, best_e)
            best_id = torch.where(repl, ident, best_id)
            new = torch.stack([p1, p2, l1, l2, length,
                               torch.full_like(p1, dist)])
            best = torch.where(repl, new, best)
            found = found | repl
        if allmax:
            c, s = torch.nonzero(oks, as_tuple=True)
            picked = cols[c, :, s].T               # [4, W]
            sid = s + lo
            parts.append(torch.cat([picked, combo_dist[c][None], sid[None],
                                    c[None], keys[:, sid]]))
            continue
        w = torch.nonzero(found)[:, 0]
        sid = w + lo
        parts.append(torch.cat([best[:4, w], best[5:, w], sid[None],
                                torch.full_like(sid, -1)[None],
                                keys[:, sid]]))
    with phase("extension to host"):
        rows = torch.cat(parts, dim=1).cpu().numpy()
    return rows if rows.shape[1] else None
