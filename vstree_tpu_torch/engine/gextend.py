"""Greedy seed extension for approximate repeats and MEMs
(vmatch -l L -h k / -e k; reference src/kurtz/extendHD.c,
src/kurtz/extendED.c, src/kurtz/frontSEP.c, dispatch
src/Vmengine/extendgen.c).

Every exact seed (maximal pair or MEM of length >= seedlength) is
extended left and right allowing up to k errors; the best extension
per seed survives (cmpmatches: E-value, then identity, then length,
ties replaced; include/extcmp.c).

Copy of the host parts of :mod:`vstree_tpu.engine.gextend` (NumPy), with
four departures:

- :class:`Seqs` holds the two texts and their reversals as tensors on an
  explicit device, and its LCE sweeps run the two-text packed-word
  ladder of ``index/sort.py`` there;
- there is no ``_use_device_engines`` switch: :func:`edit_extend_seeds`
  and :func:`edit_extend_self_device` always take
  ``gextend_dev.edit_fronts_viable_device`` on the device of ``sq``;
- the survivors' fronts stay there: :func:`_extend_combine_device`
  combines them as torch ops (``gextend_dev.combine_fronts``) and
  downloads only the winners.  :func:`_extend_combine`, the NumPy copy,
  is reached by nothing on the main path and stays as the plain
  reference that the tests and ``chip_smoke.py`` hold the card to;
- the host ``edit_fronts`` is reached by nothing and is not copied (the
  JAX package's is the oracle of the tests).

The per-seed char loops of the reference are LEVEL-SYNCHRONOUS batched
rounds over ALL seeds: each Hamming level h (or edit front p) runs one
batched LCE sweep for every seed simultaneously; the O(k^2) combination
of left/right budgets is a dense [S, k+1, k+1] array reduction.

Semantics preserved exactly:
- Hamming look tables (extendHD.c:57-165): the char left/right of the
  seed is an implicit first error; level h extends through the h-th
  explicit mismatch (exclusive); the LEFT scan stops early when a gap
  of >= seedlength exact matches is crossed (canonical leftmost-seed
  rule) and drops the last level when its gap exceeds seedlength;
  SEPARATOR and sequence boundaries stop a scan.
- Edit fronts (frontSEP.c/front.gen): greedy Ukkonen fronts with
  separator bounds; left scan aborts diagonals that cross an exact
  run of >= seedlength (foundseed); combination over front pairs with
  per-entry diagonals (extendED.c:120-345) incl. the
  SEPARATOR-trimming of match edges and the self-overlap acceptmatch
  rule (extendED.c:24-48).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.chardef import SEPARATOR
from ..device import phase
from ..index.sort import device_lce_pairs
from ..stats.evalues import Evalues
from .gextend_dev import (
    _dev_tables,
    combine_fronts,
    edit_fronts_viable_device,
)
from .match import MatchTable
from .repeats import _pairs_to_matchtable
from .repeats_dev import _emission_order, maximal_pairs_device_seeds

NEG = np.int64(-(1 << 40))   # MINUSINFINITYFRONT analog


class Seqs:
    """Pair of sequences being extended (seq1 = db text, seq2 = db
    text for self matches or the (possibly RC'd) query text), plus
    their reversals for leftward LCE: NumPy arrays for the host scans
    and uint8 tensors on ``device`` for the LCE ladder.  Passing the
    same array twice (``seq2 is seq1``) is what marks a self
    comparison."""

    def __init__(self, seq1: np.ndarray, seq2: np.ndarray,
                 device: torch.device | str):
        self.device = torch.device(device)
        self.s1 = seq1
        self.s2 = seq2
        self.r1 = seq1[::-1].copy()
        self.r2 = seq2[::-1].copy() if seq2 is not seq1 else self.r1
        self.n1 = seq1.size
        self.n2 = seq2.size

        def up(arr):
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                self.device)

        self.d_s1 = up(self.s1)
        self.d_s2 = up(self.s2) if seq2 is not seq1 else self.d_s1
        # torch has no negative strides: the reversal is a flipped copy
        self.d_r1 = torch.flip(self.d_s1, [0])
        self.d_r2 = (torch.flip(self.d_s2, [0]) if seq2 is not seq1
                     else self.d_r1)

    def lce(self, a, b, forward: bool) -> np.ndarray:
        """#matching chars of s1[a..] vs s2[b..] (``forward``) or of
        r1[a..] vs r2[b..], for host index arrays a, b >= 0 (a position
        at or past the end matches nothing): one run of the packed-word
        ladder on the device."""
        a = np.minimum(np.asarray(a, np.int64), self.n1)
        b = np.minimum(np.asarray(b, np.int64), self.n2)
        if a.size == 0:
            return np.zeros(0, np.int64)
        tabs = _dev_tables(self)
        ab = torch.from_numpy(np.stack([a, b])).to(self.device)
        run = device_lce_pairs(
            None, self.n1, tabs["sigma"], ab[0], ab[1], a.size,
            tables=tabs["Pf1" if forward else "Pb1"],
            tables_b=tabs["Pf2" if forward else "Pb2"], nb=self.n2)
        return run.cpu().numpy().astype(np.int64)

    def lce_fwd(self, a, b):
        """#matching chars of s1[a..] vs s2[b..]; a/b may be == n
        (returns 0)."""
        return self.lce(a, b, True)

    def lce_bwd(self, a, b):
        """#matching chars of s1[..a] vs s2[..b] going left (a, b
        inclusive start points; -1 allowed -> 0)."""
        ra = self.n1 - 1 - np.minimum(a, self.n1 - 1)
        rb = self.n2 - 1 - np.minimum(b, self.n2 - 1)
        res = self.lce(ra, rb, False)
        return np.where((a < 0) | (b < 0), 0, res)


def _char(seq: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """seq[idx] with out-of-range -> SEPARATOR (boundary acts like a
    hard stop in the scans)."""
    n = seq.size
    c = seq[np.clip(idx, 0, max(n - 1, 0))].astype(np.int64)
    return np.where((idx < 0) | (idx >= n), np.int64(SEPARATOR), c)


# ---------------------------------------------------------------------------
# Hamming look tables (extendHD.c:57-165)
# ---------------------------------------------------------------------------


def hamming_look_left(
    sq: Seqs, pos1: np.ndarray, pos2: np.ndarray, maxdist: int,
    seedlength: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(look [S, maxdist+1], h [S]) for leftward mismatch extension."""
    S = pos1.size
    look = np.zeros((S, maxdist + 1), np.int64)
    h = np.zeros(S, np.int64)

    a0 = _char(sq.s1, pos1 - 1)
    b0 = _char(sq.s2, pos2 - 1)
    blocked = (pos1 == 0) | (pos2 == 0) | (a0 == SEPARATOR) | (
        b0 == SEPARATOR)
    # tiny-boundary branch (extendHD.c:196-231): pos <= 1
    tiny = (~blocked) & ((pos1 <= 1) | (pos2 <= 1))
    look[tiny, 1 if maxdist >= 1 else 0] = 1
    h[tiny] = 1 if maxdist >= 1 else 0

    active = (~blocked) & (~tiny) & (maxdist >= 1)
    if maxdist >= 1 and active.any():
        idx = np.flatnonzero(active)
        i1 = pos1[idx] - 2
        i2 = pos2[idx] - 2
        ext = np.zeros(idx.size, np.int64)      # look[h-1]
        hh = np.ones(idx.size, np.int64)
        alive = np.ones(idx.size, bool)
        for _ in range(maxdist):
            if not alive.any():
                break
            run = np.zeros(idx.size, np.int64)
            run[alive] = sq.lce_bwd(i1[alive], i2[alive])
            s1 = i1 - run
            s2 = i2 - run
            newlook = ext + 1 + run
            a = _char(sq.s1, s1)
            b = _char(sq.s2, s2)
            off = (s1 < 0) | (s2 < 0)
            sep = (~off) & ((a == SEPARATOR) | (b == SEPARATOR))
            # record at level hh
            for lvl in range(1, maxdist + 1):
                sel = alive & (hh == lvl)
                look[idx[sel], lvl] = newlook[sel]
            gap = newlook - ext
            stop = off | sep | (hh == maxdist) | (gap > seedlength)
            # mismatch at the very sequence start: record full ext at
            # the NEXT level too (extendHD.c case 3 after mismatch)
            # mismatch at the sequence start: record the full
            # extension at the next level (extendHD.c case 3 after a
            # non-breaking mismatch: lookleft[h+1] = r1 - i1 + 2)
            mm_at0 = alive & ~stop & ((s1 == 0) | (s2 == 0))
            for lvl in range(1, maxdist):
                sel = mm_at0 & (hh == lvl)
                if sel.any():
                    look[idx[sel], lvl + 1] = pos1[idx[sel]] - s1[sel]
                    h[idx[sel]] = lvl + 1
            alive_next = alive & ~stop & ~mm_at0
            h[idx[alive & stop]] = hh[alive & stop]
            h[idx[mm_at0]] = hh[mm_at0] + 1
            ext = np.where(alive_next, newlook, ext)
            i1 = np.where(alive_next, s1 - 1, i1)
            i2 = np.where(alive_next, s2 - 1, i2)
            hh = np.where(alive_next, hh + 1, hh)
            alive = alive_next
        # loop exhausted while alive (hh reached maxdist naturally)
        h[idx[alive]] = hh[alive]
        # final truncation: drop last level if its gap > seedlength
        hi = h[idx]
        lk = look[idx, :]
        gap_last = (lk[np.arange(idx.size), np.maximum(hi, 0)]
                    - lk[np.arange(idx.size),
                         np.maximum(hi - 1, 0)])
        drop = (hi >= 1) & (gap_last > seedlength)
        h[idx[drop]] -= 1
    return look, h


def hamming_look_right(
    sq: Seqs, r1: np.ndarray, r2: np.ndarray, maxdist: int,
) -> tuple[np.ndarray, np.ndarray]:
    """(look, h) for rightward mismatch extension; r1/r2 = first
    position right of the seed (the implicit mismatch)."""
    S = r1.size
    look = np.zeros((S, maxdist + 1), np.int64)
    h = np.zeros(S, np.int64)
    n1 = sq.n1
    n2 = sq.n2

    a0 = _char(sq.s1, r1)
    b0 = _char(sq.s2, r2)
    blocked = (r1 >= n1) | (r2 >= n2) | (a0 == SEPARATOR) | (
        b0 == SEPARATOR)
    tiny = (~blocked) & ((r1 >= n1 - 1) | (r2 >= n2 - 1))
    look[tiny, 1 if maxdist >= 1 else 0] = 1
    h[tiny] = 1 if maxdist >= 1 else 0

    active = (~blocked) & (~tiny) & (maxdist >= 1)
    if maxdist >= 1 and active.any():
        idx = np.flatnonzero(active)
        i1 = r1[idx] + 1
        i2 = r2[idx] + 1
        ext = np.zeros(idx.size, np.int64)
        hh = np.ones(idx.size, np.int64)
        alive = np.ones(idx.size, bool)
        for _ in range(maxdist):
            if not alive.any():
                break
            run = np.zeros(idx.size, np.int64)
            run[alive] = sq.lce_fwd(i1[alive], i2[alive])
            s1 = i1 + run
            s2 = i2 + run
            newlook = ext + 1 + run
            a = _char(sq.s1, s1)
            b = _char(sq.s2, s2)
            off = (s1 >= n1) | (s2 >= n2)
            sep = (~off) & ((a == SEPARATOR) | (b == SEPARATOR))
            for lvl in range(1, maxdist + 1):
                sel = alive & (hh == lvl)
                look[idx[sel], lvl] = newlook[sel]
            stop = off | sep | (hh == maxdist)
            mm_atend = alive & ~stop & (
                (s1 == n1 - 1) | (s2 == n2 - 1))
            for lvl in range(1, maxdist):
                sel = mm_atend & (hh == lvl)
                if sel.any():
                    look[idx[sel], lvl + 1] = (
                        s1[sel] - r1[idx[sel]] + 1)
                    h[idx[sel]] = lvl + 1
            alive_next = alive & ~stop & ~mm_atend
            h[idx[alive & stop]] = hh[alive & stop]
            ext = np.where(alive_next, newlook, ext)
            i1 = np.where(alive_next, s1 + 1, i1)
            i2 = np.where(alive_next, s2 + 1, i2)
            hh = np.where(alive_next, hh + 1, hh)
            alive = alive_next
        h[idx[alive]] = hh[alive]
    return look, h


# ---------------------------------------------------------------------------
# best-combination selection (extendHD.c:298-358 + extcmp.c)
# ---------------------------------------------------------------------------


def _better(ev: Evalues, e_new, id_new, len_new, e_old, id_old, len_old):
    """cmpmatches(old, new) == 1, i.e. replace old with new
    (include/extcmp.c: E-value asc, identity desc, length desc; full
    tie -> replace)."""
    return ~(
        (e_old < e_new)
        | ((e_old == e_new) & (id_old > id_new))
        | ((e_old == e_new) & (id_old == id_new)
           & (len_old > len_new))
    )


def hamming_extend_seeds(
    sq: Seqs,
    ev: Evalues,
    seeds: MatchTable,
    maxdist: int,
    leastlength: int,
    seedlength: int,
    querycompare: bool,
    allmax: bool = False,
) -> MatchTable:
    """Best Hamming extension per seed (hammingextend,
    extendHD.c:167-375)."""
    S = len(seeds)
    if S == 0:
        return MatchTable()
    pos1 = seeds.position1.astype(np.int64)
    pos2 = seeds.position2.astype(np.int64)
    slen = seeds.length1.astype(np.int64)

    ll_tab, hl = hamming_look_left(sq, pos1, pos2, maxdist, seedlength)
    lr_tab, hr = hamming_look_right(
        sq, pos1 + slen, pos2 + slen, maxdist)
    remain = np.maximum(leastlength - slen, 0)

    # precheck (extendHD.c:283-289)
    viable = (ll_tab[np.arange(S), hl] + lr_tab[np.arange(S), hr]
              >= remain)
    vidx = np.flatnonzero(viable)
    if vidx.size == 0:
        return MatchTable()
    ll_tab = ll_tab[vidx]
    lr_tab = lr_tab[vidx]
    hl = hl[vidx]
    hr = hr[vidx]
    pos1 = pos1[vidx]
    pos2 = pos2[vidx]
    slen = slen[vidx]
    remain = remain[vidx] if remain.ndim else remain
    S = vidx.size
    viable = np.ones(S, bool)

    best_e = np.full(S, np.inf)
    best_id = np.zeros(S)
    best_len = np.zeros(S, np.int64)
    best_ll = np.zeros(S, np.int64)
    best_dist = np.zeros(S, np.int64)
    found = np.zeros(S, bool)
    cand: list = []
    combo_counter = 0

    for dist in range(0, maxdist + 1):
        for li in range(0, dist + 1):
            ri = dist - li
            ok = viable & (li <= hl) & (ri <= hr)
            if not ok.any():
                continue
            ll = ll_tab[:, li]
            ext = ll + lr_tab[:, ri]
            length = slen + ext
            ok = ok & (ext >= remain)
            if not ok.any():
                continue
            if allmax:
                idx = np.flatnonzero(ok)
                cand.append((idx, (pos1 - ll)[idx], (pos2 - ll)[idx],
                             length[idx], length[idx],
                             np.full(idx.size, -dist, np.int64),
                             np.full(idx.size, combo_counter,
                                     np.int64)))
                combo_counter += 1
                continue
            e = ev.get_batch(np.ones(S), np.full(S, -dist), length)
            ident = 100.0 * (1.0 - dist / np.maximum(length, 1))
            repl = ok & (~found | _better(
                ev, e, ident, length, best_e, best_id, best_len))
            best_e = np.where(repl, e, best_e)
            best_id = np.where(repl, ident, best_id)
            best_len = np.where(repl, length, best_len)
            best_ll = np.where(repl, ll, best_ll)
            best_dist = np.where(repl, -dist, best_dist)
            found |= repl

    if allmax:
        if not cand:
            return MatchTable()
        sidx = vidx[np.concatenate([c[0] for c in cand])]
        return apply_allmax_containers(
            seeds, sidx,
            np.concatenate([c[6] for c in cand]),
            np.concatenate([c[1] for c in cand]),
            np.concatenate([c[2] for c in cand]),
            np.concatenate([c[3] for c in cand]),
            np.concatenate([c[4] for c in cand]),
            np.concatenate([c[5] for c in cand]),
            querycompare, seeds.position2.astype(np.int64),
        )
    if not found.any():
        return MatchTable()
    out = seeds.select(vidx[found])
    ll = best_ll[found]
    out.position1 = out.position1 - ll
    out.position2 = out.position2 - ll
    out.length1 = best_len[found]
    out.length2 = best_len[found].copy()
    out.distance = best_dist[found]
    if querycompare:
        out.relpos2 = out.relpos2 - ll
    return out


# ---------------------------------------------------------------------------
# edit fronts (frontSEP.c / front.gen)
# ---------------------------------------------------------------------------


def _sep_dist_left(seq: np.ndarray, start: np.ndarray) -> np.ndarray:
    """#chars strictly left of ``start`` before the first SEPARATOR
    (scanning leftward from start-1); large if none."""
    sep = seq == SEPARATOR
    # prev separator position at or before p: running max of positions
    pos = np.where(sep, np.arange(seq.size), -1)
    prevsep = np.maximum.accumulate(pos)
    p = np.clip(start - 1, -1, seq.size - 1)
    ps = np.where(p >= 0, prevsep[np.maximum(p, 0)], -1)
    return np.where(p < 0, 0, p - ps)


def _sep_dist_right(seq: np.ndarray, start: np.ndarray) -> np.ndarray:
    """#chars from ``start`` rightward before the first SEPARATOR."""
    n = seq.size
    sep = seq == SEPARATOR
    pos = np.where(sep, np.arange(n), 2 * n)
    nextsep = np.minimum.accumulate(pos[::-1])[::-1]
    s = np.clip(start, 0, n - 1)
    ns = np.where(start < n, nextsep[s], start)
    return np.maximum(np.minimum(ns, n) - start, 0)


def edit_extend_seeds(
    sq: Seqs,
    ev: Evalues,
    seeds: MatchTable,
    maxdist: int,
    leastlength: int,
    seedlength: int,
    querycompare: bool,
    selfmode: bool,
    allmax: bool = False,
) -> MatchTable:
    """Best edit-distance extension per seed (editextend,
    extendED.c:78-355)."""
    S = len(seeds)
    if S == 0:
        return MatchTable()
    pos1 = seeds.position1.astype(np.int64)
    pos2 = seeds.position2.astype(np.int64)
    slen = seeds.length1.astype(np.int64)

    # fronts + viability prefilter (extendED.c:141-200) and the
    # combination on the device; only the winners come back
    cols = torch.from_numpy(np.stack([pos1, pos2, slen])).to(sq.device)
    vidx, lf, hl, rf, hr = edit_fronts_viable_device(
        sq, cols[0], cols[1], cols[2], maxdist, leastlength, seedlength)
    if vidx.numel() == 0:
        return MatchTable()
    with phase("combination"):
        cols = cols[:, vidx]
        return _extend_combine_device(
            sq, ev, lambda k: seeds.select(k[0]), lf, hl, rf, hr,
            cols[0], cols[1], cols[2], maxdist, leastlength,
            querycompare, selfmode, allmax, keys=vidx[None])


def edit_extend_self_device(esa, sq: Seqs, ev: Evalues,
                            maxdist: int, leastlength: int,
                            seedlength: int, allmax: bool = False):
    """Fused seeds -> extension for plain self comparison: maximal
    pairs are enumerated on the device (engine/repeats_dev.py), fed to
    the viability prefilter and the combination WITHOUT ever being
    downloaded, and only the winners come to the host, their seed
    table built for them alone.  ``sq`` lies on ``esa.dev``.  Returns
    None when the pathological-run guard of the enumeration fires (the
    caller runs the two-step path)."""
    table: dict = {}
    got = maximal_pairs_device_seeds(esa, seedlength, table_out=table)
    if got is None:
        return None
    (p1_d, p2_d, d_d, ri_d, rj_d), total = got
    if total == 0:
        return MatchTable()
    vidx, lf, hl, rf, hr = edit_fronts_viable_device(
        sq, p1_d, p2_d, d_d, maxdist, leastlength, seedlength)
    if vidx.numel() == 0:
        return MatchTable()
    with phase("survivor order"):
        # reference emission order, restored on the survivors only (the
        # full enumeration is never sorted), with the sparse table of
        # the run that made the seeds
        order = _emission_order(
            table["rmq"], esa.device("bwttab"), ri_d[vidx], rj_d[vidx],
            d_d[vidx], table["steps"], esa.alpha.num_regular)
        sel = vidx[order]
        cols = torch.stack([p1_d[sel], p2_d[sel], d_d[sel]])
        lf, hl, rf, hr = lf[order], hl[order], rf[order], hr[order]
    with phase("combination"):
        return _extend_combine_device(
            sq, ev, lambda k: _pairs_to_matchtable(esa, k[0], k[1], k[2]),
            lf, hl, rf, hr, cols[0], cols[1], cols[2], maxdist,
            leastlength, False, True, allmax, keys=cols)


def _extend_combine_device(sq, ev, seeds, lf, hl, rf, hr, pos1, pos2,
                           slen, maxdist, leastlength, querycompare,
                           selfmode, allmax, *, keys):
    """:func:`_extend_combine` with the survivors' fronts and seed
    columns as tensors on the device of ``sq`` (the fronts int32 with
    ``gextend_dev.NEG32``): the combination runs there
    (``gextend_dev.combine_fronts``) and one download brings the
    winners, or ``-allmax``'s emission stream, with their key columns
    (``keys``, int64 [K, S] on that device).  ``seeds`` makes the seeds'
    ``MatchTable`` from the downloaded key columns [K, W] of the rows it
    needs."""
    rows = combine_fronts(sq, ev, lf, hl, rf, hr, pos1, pos2, slen,
                          maxdist, leastlength, querycompare, selfmode,
                          allmax, keys)
    if rows is None:
        return MatchTable()
    p1, p2, l1, l2, dist, sid, combo = rows[:7]
    if allmax:
        # the seeds in the stream, in survivor order (the containers'
        # order needs only the order of the seed indices)
        _, first, inv = np.unique(sid, return_index=True,
                                  return_inverse=True)
        table = seeds(rows[7:, first])
        return apply_allmax_containers(
            table, inv.reshape(-1), combo, p1, p2, l1, l2, dist,
            querycompare, table.position2.astype(np.int64))
    out = seeds(rows[7:])
    out.length1 = l1
    out.length2 = l2
    out.distance = dist
    old_p2 = out.position2.copy()
    out.position1 = p1
    out.position2 = p2
    if querycompare:
        out.relpos2 = out.relpos2 - (old_p2 - out.position2)
    return out


def _extend_combine(sq, ev, seeds, lf, hl, rf, hr, pos1, pos2, slen,
                    maxdist, leastlength, querycompare, selfmode,
                    allmax):
    """(dist, l, r, diag, diag) combination over the viable seeds
    (extendED.c:200-355) — all arrays already restricted to the
    prefilter survivors."""
    remain = np.maximum(leastlength - slen, 0)
    S = pos1.size
    vidx = np.arange(S)
    viable = np.ones(S, bool)

    best = {
        "e": np.full(S, np.inf), "id": np.zeros(S),
        "len": np.zeros(S, np.int64), "found": np.zeros(S, bool),
        "p1": np.zeros(S, np.int64), "p2": np.zeros(S, np.int64),
        "l1": np.zeros(S, np.int64), "l2": np.zeros(S, np.int64),
        "dist": np.zeros(S, np.int64),
    }
    ks = np.arange(-maxdist, maxdist + 1, dtype=np.int64)
    cand: list = []          # -allmax emission stream
    combo_counter = 0

    for dist in range(0, maxdist + 1):
        for li in range(max(0, dist - maxdist), dist + 1):
            ri = dist - li
            base_ok = viable & (li <= hl) & (ri <= hr)
            if not base_ok.any():
                continue
            for lki in range(2 * maxdist + 1):
                lk = ks[lki]
                lval = lf[:, li, lki]
                okl = base_ok & (lval > NEG)
                if not okl.any():
                    continue
                for rki in range(2 * maxdist + 1):
                    rk = ks[rki]
                    rval = rf[:, ri, rki]
                    ok = okl & (rval > NEG)
                    if not ok.any():
                        continue
                    exti = lval + rval
                    extj = exti + lk + rk
                    ok = ok & (exti >= remain) & (extj >= remain)
                    if not ok.any():
                        continue
                    p1 = pos1 - lval
                    p2 = pos2 - lval - lk
                    l1 = slen + exti
                    l2 = slen + extj
                    if selfmode and not querycompare:
                        swap = p1 > p2
                        p1s = np.where(swap, p2, p1)
                        p2s = np.where(swap, p1, p2)
                        l1s = np.where(swap, l2, l1)
                        l2s = np.where(swap, l1, l2)
                        p1, p2, l1, l2 = p1s, p2s, l1s, l2s
                    # SEPARATOR edge trimming (extendED.c:268-285)
                    e1 = _char(sq.s1, p1 + l1 - 1) == SEPARATOR
                    l1 = l1 - e1
                    s1sep = _char(sq.s1, p1) == SEPARATOR
                    p1 = p1 + s1sep
                    l1 = l1 - s1sep
                    e2 = _char(sq.s2, p2 + l2 - 1) == SEPARATOR
                    l2 = l2 - e2
                    s2sep = _char(sq.s2, p2) == SEPARATOR
                    p2 = p2 + s2sep
                    l2 = l2 - s2sep
                    if selfmode and not querycompare:
                        # acceptmatch (extendED.c:24-48)
                        nolap = p1 + l1 - 1 < p2
                        embedded = p1 + l1 >= p2 + l2
                        nonover = (p2 - p1) + (p2 + l2) - (p1 + l1)
                        acc = (p1 < p2) & (
                            nolap
                            | (~embedded & (nonover > dist))
                        )
                        ok = ok & acc
                    if not ok.any():
                        continue
                    if allmax:
                        # collect the full emission stream in the
                        # reference iteration order (extendED.c:289ff)
                        idx = np.flatnonzero(ok)
                        cand.append((idx, p1[idx], p2[idx], l1[idx],
                                     l2[idx],
                                     np.full(idx.size, dist, np.int64),
                                     np.full(idx.size, combo_counter,
                                             np.int64)))
                        combo_counter += 1
                        continue
                    length = np.maximum(l1, l2)
                    e = ev.get_batch(
                        np.ones(S), np.full(S, dist), length)
                    ident = 100.0 * (
                        1.0 - dist / np.maximum(length, 1))
                    repl = ok & (~best["found"] | _better(
                        ev, e, ident, length,
                        best["e"], best["id"], best["len"]))
                    for name, val in (
                        ("e", e), ("id", ident), ("len", length),
                        ("p1", p1), ("p2", p2), ("l1", l1),
                        ("l2", l2),
                        ("dist", np.full(S, dist, np.int64)),
                    ):
                        best[name] = np.where(repl, val, best[name])
                    best["found"] |= repl

    if allmax:
        if not cand:
            return MatchTable()
        sidx = vidx[np.concatenate([c[0] for c in cand])]
        return apply_allmax_containers(
            seeds, sidx,
            np.concatenate([c[6] for c in cand]),
            np.concatenate([c[1] for c in cand]),
            np.concatenate([c[2] for c in cand]),
            np.concatenate([c[3] for c in cand]),
            np.concatenate([c[4] for c in cand]),
            np.concatenate([c[5] for c in cand]),
            querycompare, seeds.position2.astype(np.int64),
        )
    found = best["found"]
    if not found.any():
        return MatchTable()
    out = seeds.select(vidx[found])
    out.length1 = best["l1"][found]
    out.length2 = best["l2"][found]
    out.distance = best["dist"][found]
    old_p2 = out.position2.copy()
    out.position1 = best["p1"][found]
    out.position2 = best["p2"][found]
    if querycompare:
        out.relpos2 = out.relpos2 - (old_p2 - out.position2)
    return out


# ---------------------------------------------------------------------------
# -allmax containment container (kurtz/mcontain.c)
# ---------------------------------------------------------------------------


def _contains(a, b):
    """CONTAINSMATCH (mcontain.c:23-27): a contains b."""
    return (a[0] <= b[0] and b[0] + b[1] <= a[0] + a[1]
            and a[2] <= b[2] and b[2] + b[3] <= a[2] + a[3])


def container_insert(store: list, new: tuple) -> None:
    """matchcontainer (mcontain.c:39-93), including its exact slot-
    reuse order: a removed old match is overwritten by the LAST array
    element, and a new match contained by an old after having replaced
    a removed old stays in the array."""
    store.append(new)
    if len(store) == 1:
        return
    orig = len(store) - 1
    end = orig
    moved = False
    i = 0
    while i <= end:
        if i == orig and not moved:
            break
        a = store[i]
        if _contains(a, new):
            if not moved:
                end -= 1
            break
        if _contains(new, a):
            if i != end:
                store[i] = store[end]
                if not moved:
                    moved = True
                    i += 1
            end -= 1
        else:
            i += 1
    del store[end + 1:]


def apply_allmax_containers(
    seeds: "MatchTable",
    seed_idx: np.ndarray,
    combo: np.ndarray,
    p1: np.ndarray,
    p2: np.ndarray,
    l1: np.ndarray,
    l2: np.ndarray,
    dist: np.ndarray,
    querycompare: bool,
    seed_pos2: np.ndarray,
) -> "MatchTable":
    """Two-level -allmax containment (fself.c:131-142 /
    extendgen.c:37-45): a per-seed container over each seed's emission
    stream, whose survivors are inserted into the global container;
    the global container's final array order is the output order."""
    order = np.lexsort((combo, seed_idx))
    global_store: list = []
    cur = -1
    seed_store: list = []

    def flush():
        for m in seed_store:
            container_insert(global_store, m)

    for t in order:
        sidx = int(seed_idx[t])
        if sidx != cur:
            flush()
            seed_store = []
            cur = sidx
        container_insert(
            seed_store,
            (int(p1[t]), int(l1[t]), int(p2[t]), int(l2[t]),
             int(dist[t]), sidx),
        )
    flush()
    if not global_store:
        return MatchTable()
    arr = np.asarray([m[:5] for m in global_store], np.int64)
    sidxs = np.asarray([m[5] for m in global_store], np.int64)
    out = seeds.select(sidxs)
    out.position1 = arr[:, 0]
    out.length1 = arr[:, 1]
    out.position2 = arr[:, 2]
    out.length2 = arr[:, 3]
    out.distance = arr[:, 4]
    if querycompare:
        out.relpos2 = out.relpos2 - (seed_pos2[sidxs] - arr[:, 2])
    return out
