"""X-drop seed extension (vmatch -exdrop / -hxdrop).

Reference: the greedy edit-distance x-drop extension of
src/kurtz/xdrop.gen:1-201 (Miller et al. 2000 generations with score
pruning against the best score ``xdropbelowscore`` generations back),
its Hamming (mismatch-only) variants src/kurtz/xdrop.c:37-140, and the
seed-combination routine src/Vmengine/xdropext.c:39-221
(``xdropseedextend``: left+right extension, position normalization,
SEPARATOR trimming, self-overlap ``acceptmatch``, and the
score -> distance conversion EVALSCORE2DISTANCE of
src/include/match.h:76-77).

Copy of :mod:`vstree_tpu.engine.xdrop` (NumPy) with two departures,
neither of which changes a result.  The batched LCE sweeps go to the
device of the :class:`Seqs` object (``Seqs.lce``, the two-text
packed-word ladder) instead of ``ops/lce.py::lce_two_texts``, so the
batch functions take ``sq`` and a direction where the original takes two
texts and their device copies.  And :func:`edit_xdrop_batch` keeps its
state to the seeds still alive and to the diagonals their bands span,
where the original holds every seed at the widest window so far.

The reference extends one seed at a time with char-by-char loops.  Here
ALL seeds advance level-synchronously: one generation of the greedy
algorithm is a batched [S, K]-diagonal array update whose "slide along
matching characters" step is a single batched LCE sweep over every live
(seed, diagonal) entry simultaneously.  The Hamming scans likewise
advance all seeds one mismatch-run per round via batched LCE.

Scoring scheme (src/include/xdropdef.h:17-22): match +2, mismatch -1,
indel -2, SPRIME(i+j) = i+j - 3*d.
"""

from __future__ import annotations

import numpy as np

from ..core.chardef import SEPARATOR
from .gextend import Seqs
from .match import FLAGXDROP, MatchTable

NEG = -(1 << 40)           # MINUSINFINITYSCORE analog
MATCHSCORE = 2
MISMATCHSCORE = -1
HALFMATCHSCORE = 1
_XDROP_CAP = 64            # first length of the edit x-drop's score table


def _ctrunc_div(a: int, b: int) -> int:
    """C integer division (truncation toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _char_at(t: np.ndarray, idx: np.ndarray) -> np.ndarray:
    n = t.size
    c = t[np.clip(idx, 0, max(n - 1, 0))].astype(np.int64)
    return np.where((idx < 0) | (idx >= n), np.int64(SEPARATOR), c)


def _texts(sq: Seqs, forward: bool):
    """The two host texts of a direction: the reversals for leftward
    extension."""
    return (sq.s1, sq.s2) if forward else (sq.r1, sq.r2)


def _slide(sq: Seqs, forward: bool, u0, v0, i, j, ulen, vlen):
    """Batched COMPARESYMBOLSSEP while-loop (xdrop.gen:122-135).

    Returns (run, new_ulen, new_vlen): the number of matching chars
    consumed from (i, j), and per-entry ulen/vlen truncated when the
    stopping character is a SEPARATOR (the C macro mutates the local
    ulen/vlen).  All inputs are per-ENTRY arrays; ulen/vlen are the
    current per-entry bounds.
    """
    tu, tv = _texts(sq, forward)
    run = sq.lce(u0 + i, v0 + j, forward)
    run = np.minimum(run, np.minimum(ulen - i, vlen - j))
    run = np.maximum(run, 0)
    i2 = i + run
    j2 = j + run
    inb = (i2 < ulen) & (j2 < vlen)
    a = _char_at(tu, u0 + i2)
    b = _char_at(tv, v0 + j2)
    new_ulen = np.where(inb & (a == SEPARATOR), i2, ulen)
    new_vlen = np.where(inb & (a != SEPARATOR) & (b == SEPARATOR),
                        j2, vlen)
    return run, new_ulen, new_vlen


def edit_xdrop_batch(sq: Seqs, forward: bool, u0, v0, ulen0, vlen0, X):
    """Batched EVALXDROPEDIT (xdrop.gen:2-201) over S seeds.

    ``forward`` scans the texts of ``sq``, else their reversals
    (leftward extension, in the reversals' coordinates);
    u0/v0: per-seed start offsets; ulen0/vlen0: per-seed available
    lengths.  Returns (besti, bestj, bestscore) int64 arrays.

    The state follows the seeds still alive: once half of its rows have
    finished they leave it, and its diagonals are, generation by
    generation, the window that the live seeds' bands span (one diagonal
    wider on either side).  A few seeds inside long diverged repeats run
    for hundreds of generations; at a window sized by the generation
    count, all seeds would pay for them.
    """
    S = u0.size
    besti = np.zeros(S, np.int64)
    bestj = np.zeros(S, np.int64)
    bestscore = np.zeros(S, np.int64)
    if S == 0:
        return besti, bestj, bestscore
    out = (np.zeros(S, np.int64), np.zeros(S, np.int64),
           np.zeros(S, np.int64))
    ids = np.arange(S)              # the state's rows as seed numbers
    u0 = u0.astype(np.int64)
    v0 = v0.astype(np.int64)
    ulen = ulen0.astype(np.int64).copy()
    vlen = vlen0.astype(np.int64).copy()

    # initial identity run (CHECKIDENTITY, xdrop.gen:28-36)
    run, ulen, vlen = _slide(
        sq, forward, u0, v0, np.zeros(S, np.int64), np.zeros(S, np.int64),
        ulen, vlen)
    besti[:] = run
    bestj[:] = run
    bestscore[:] = 2 * run

    dback0 = _ctrunc_div(-(X + HALFMATCHSCORE),
                         MATCHSCORE - MISMATCHSCORE)
    # Ttab[s, d] = bestscore after generation d, minus X
    cap = _XDROP_CAP
    ttab = np.full((S, cap + 1), NEG, np.int64)
    ttab[:, 0] = bestscore - X

    klo = 0                         # R holds diagonals klo, klo + 1, ...
    R = run[:, None].copy()
    lo = np.zeros(S, np.int64)      # per-seed band (prev generation)
    up = np.zeros(S, np.int64)
    alive = np.ones(S, bool)

    d = 0
    while alive.any():
        d += 1
        if d >= cap:
            cap *= 2
            ttab = np.pad(ttab, ((0, 0), (0, cap + 1 - ttab.shape[1])),
                          constant_values=NEG)
        dmulti = d * (MATCHSCORE - MISMATCHSCORE)
        dback = dback0 + (d - 1)
        dbackval = (np.full(S, -X, np.int64) if dback < 0
                    else ttab[:, dback].copy())
        dbackval = np.where(dbackval == NEG, -X, dbackval)

        # this generation's diagonals [wlo, whi]; ``prev`` holds the last
        # generation on [wlo - 1, whi + 1], undefined where R had none
        wlo = int(lo[alive].min()) - 1
        whi = int(up[alive].max()) + 1
        W = whi - wlo + 1
        prev = np.full((S, W + 2), NEG, np.int64)
        a = max(klo, wlo - 1)
        b = min(klo + R.shape[1], whi + 2)
        if a < b:
            prev[:, a - (wlo - 1):b - (wlo - 1)] = R[:, a - klo:b - klo]
        R = prev[:, 1:-1]
        klo = wlo

        # DP step over diagonals (xdrop.gen:81-110): for k in
        # [lo-1, up+1]: max of prev[k+1] (k<up), prev[k]+1
        # (lo<=k<=up), prev[k-1]+1 (k>lo)
        ks = np.arange(wlo, whi + 1, dtype=np.int64)[None, :]
        ins = np.where(ks < up[:, None], prev[:, 2:], NEG)
        mis = np.where((ks >= lo[:, None]) & (ks <= up[:, None]),
                       np.where(R > NEG, R + 1, NEG), NEG)
        dele = np.where(prev[:, :-2] > NEG, prev[:, :-2] + 1, NEG)
        dele = np.where(ks > lo[:, None], dele, NEG)
        t = np.maximum(ins, np.maximum(mis, dele))
        inband = (ks >= (lo - 1)[:, None]) & (ks <= (up + 1)[:, None])
        t = np.where(inband & alive[:, None], t, NEG)

        # score pruning: SPRIME(i+j) < Ttab[dback] -> undefined
        jj = t - ks
        sprime_pre = t + jj - dmulti
        t = np.where((t > NEG) & (sprime_pre >= dbackval[:, None]),
                     t, NEG)

        # batched slide for every defined (seed, diagonal) entry
        si, ki = np.nonzero(t > NEG)
        if si.size:
            kk = ks[0][ki]
            iv = t[si, ki]
            jv = iv - kk
            run, nu, nv = _slide(sq, forward, u0[si], v0[si], iv, jv,
                                 ulen[si], vlen[si])
            # SEPARATOR truncation is per-seed state (see module doc)
            np.minimum.at(ulen, si, nu)
            np.minimum.at(vlen, si, nv)
            iv = iv + run
            jv = jv + run
            t[si, ki] = iv

            reach_n = jv == vlen[si]          # j == vlen -> maxisN
            reach_m = iv == ulen[si]          # i == ulen -> minisM
            maxisN = np.full(S, NEG, np.int64)
            np.maximum.at(maxisN, si[reach_n], kk[reach_n])
            minisM = np.full(S, -NEG, np.int64)
            np.minimum.at(minisM, si[reach_m], kk[reach_m])
            minisfin = np.full(S, -NEG, np.int64)
            np.minimum.at(minisfin, si, kk)
            maxisfin = np.full(S, NEG, np.int64)
            np.maximum.at(maxisfin, si, kk)

            # best update: strictly greater score, smallest k wins
            # (ascending-k scan with strict '<' in the reference)
            sp = np.where(t > NEG, 2 * t - ks - dmulti, NEG)
            best_k_idx = np.argmax(sp, axis=1)
            best_sp = sp[np.arange(S), best_k_idx]
            # argmax picks the first (smallest-k) maximum
            improved = alive & (best_sp > bestscore) & (best_sp > NEG)
            bi = t[np.arange(S), best_k_idx]
            bj = bi - ks[0][best_k_idx]
            besti = np.where(improved, bi, besti)
            bestj = np.where(improved, bj, bestj)
            bestscore = np.where(improved, best_sp, bestscore)
        else:
            maxisN = np.full(S, NEG, np.int64)
            minisM = np.full(S, -NEG, np.int64)
            minisfin = np.full(S, -NEG, np.int64)
            maxisfin = np.full(S, NEG, np.int64)

        R = np.where(alive[:, None], t, R)
        newlo = np.maximum(minisfin, maxisN + 2)
        newup = np.minimum(maxisfin, minisM - 2)
        done = newlo > newup + 2
        still = alive & ~done
        ttab[still, d] = bestscore[still] - X
        lo = np.where(still, newlo, lo)
        up = np.where(still, newup, up)
        alive = still
        if 2 * int(alive.sum()) <= S:
            # a finished seed's best values are final
            for col, best in zip(out, (besti, bestj, bestscore)):
                col[ids] = best
            (ids, u0, v0, ulen, vlen, ttab, R, lo, up, besti, bestj,
             bestscore) = (a[alive] for a in (
                 ids, u0, v0, ulen, vlen, ttab, R, lo, up, besti, bestj,
                 bestscore))
            S = ids.size
            alive = np.ones(S, bool)
    for col, best in zip(out, (besti, bestj, bestscore)):
        col[ids] = best
    return out


def hamming_xdrop_batch(sq: Seqs, forward: bool, u0, v0, ulen0, vlen0, X,
                        reachlength=None):
    """Batched evalhammingxdrop{right,left} (xdrop.c:37-140).

    Scans tu[u0..u0+ulen) vs tv[v0..v0+vlen), tu/tv the texts of ``sq``
    (``forward``) or their reversals (the leftward variant, in the
    reversals' coordinates).  ``reachlength``: abort a seed
    (mask in the returned ``aborted``) when a run of >= reachlength
    consecutive matches occurs (left-extension leftmost-seed rule).
    Returns (ext, score, aborted): ext = chars up to and including the
    best-scoring position.
    """
    S = u0.size
    ext = np.zeros(S, np.int64)
    score = np.zeros(S, np.int64)
    aborted = np.zeros(S, bool)
    if S == 0:
        return ext, score, aborted
    u0 = u0.astype(np.int64)
    v0 = v0.astype(np.int64)
    ulen = ulen0.astype(np.int64)
    vlen = vlen0.astype(np.int64)

    tu, tv = _texts(sq, forward)
    i = np.zeros(S, np.int64)      # chars consumed so far
    total = np.zeros(S, np.int64)
    alive = np.ones(S, bool)
    while alive.any():
        idx = np.flatnonzero(alive)
        run = sq.lce(u0[idx] + i[idx], v0[idx] + i[idx], forward)
        run = np.minimum(run, np.minimum(ulen[idx], vlen[idx]) - i[idx])
        run = np.maximum(run, 0)
        if reachlength is not None:
            ab = run >= reachlength
            aborted[idx[ab]] = True
            alive[idx[ab]] = False
            keep = ~ab
            idx = idx[keep]
            run = run[keep]
            if idx.size == 0:
                break
        tot = total[idx] + MATCHSCORE * run
        imp = tot > score[idx]
        score[idx[imp]] = tot[imp]
        ext[idx[imp]] = i[idx[imp]] + run[imp]
        i2 = i[idx] + run
        # stopping char: off-end / SEPARATOR -> done; else mismatch
        # (incl. WILDCARD) scores MISMATCHSCORE and may trip the drop
        off = (i2 >= ulen[idx]) | (i2 >= vlen[idx])
        a = _char_at(tu, u0[idx] + i2)
        b = _char_at(tv, v0[idx] + i2)
        sep = (~off) & ((a == SEPARATOR) | (b == SEPARATOR))
        tot = tot + MISMATCHSCORE
        drop = tot < score[idx] - X
        stop = off | sep | drop
        total[idx] = tot
        i[idx] = i2 + 1
        alive[idx[stop]] = False
    return ext, score, aborted


def _accept_match(l1, p1, l2, p2):
    """Self-overlap filter (xdropext.c:21-37)."""
    no_overlap = p1 + l1 - 1 < p2
    embedded = p1 + l1 >= p2 + l2
    return (p1 < p2) & (no_overlap | ~embedded)


def xdrop_extend_seeds(
    sq: Seqs,
    seeds: MatchTable,
    xdropbelowscore: int,
    seedlength: int,
    querycompare: bool,
    rcmode: bool = False,
) -> MatchTable:
    """Batched xdropseedextend (Vmengine/xdropext.c:39-221).

    ``xdropbelowscore`` < 0 selects the Hamming (mismatch-only)
    kernels with drop value -xdropbelowscore, mirroring the reference
    encoding of -hxdrop.  Seeds are maximal pairs / MEMs of length >=
    seedlength; each surviving seed yields one match whose distance is
    EVALSCORE2DISTANCE(score, l1, l2) (negated score for Hamming).
    """
    S = len(seeds)
    if S == 0:
        return MatchTable()
    pos1 = seeds.position1.astype(np.int64)
    pos2 = seeds.position2.astype(np.int64)
    slen = seeds.length1.astype(np.int64)
    n1, n2 = sq.n1, sq.n2
    hamming = xdropbelowscore < 0
    X = -xdropbelowscore if hamming else xdropbelowscore

    keep = np.ones(S, bool)
    if hamming:
        # left: evalhammingxdropleft with reachlength=seedlength
        # (xdrop.c:89-140); reversed-text coordinates: u index I maps
        # to absolute pos1-1-I, i.e. offset n1-pos1 in sq.r1
        lext, lscore, ab = hamming_xdrop_batch(
            sq, False, n1 - pos1, n2 - pos2, pos1, pos2, X,
            reachlength=seedlength)
        keep &= ~ab
        rext, rscore, _ = hamming_xdrop_batch(
            sq, True, pos1 + slen, pos2 + slen,
            n1 - (pos1 + slen), n2 - (pos2 + slen), X)
        li = lj = lext
        ri = rj = rext
    else:
        # blocked-at-boundary checks (xdropext.c:94-156)
        lblock = ((pos1 == 0) | (pos2 == 0)
                  | (_char_at(sq.s1, pos1 - 1) == SEPARATOR)
                  | (_char_at(sq.s2, pos2 - 1) == SEPARATOR))
        li, lj, lscore = edit_xdrop_batch(
            sq, False, n1 - pos1, n2 - pos2, pos1, pos2, X)
        li = np.where(lblock, 0, li)
        lj = np.where(lblock, 0, lj)
        lscore = np.where(lblock, 0, lscore)
        e1 = pos1 + slen
        e2 = pos2 + slen
        rblock = ((e1 >= n1) | (e2 >= n2)
                  | (_char_at(sq.s1, e1) == SEPARATOR)
                  | (_char_at(sq.s2, e2) == SEPARATOR))
        ri, rj, rscore = edit_xdrop_batch(
            sq, True, e1, e2, n1 - e1, n2 - e2, X)
        ri = np.where(rblock, 0, ri)
        rj = np.where(rblock, 0, rj)
        rscore = np.where(rblock, 0, rscore)

    p1 = pos1 - li
    p2 = pos2 - lj
    exti = li + ri
    extj = lj + rj
    # position normalization (xdropext.c:168-179)
    if rcmode or querycompare:
        l1 = slen + exti
        l2 = slen + extj
    else:
        swap = p1 > p2
        l1 = np.where(swap, slen + extj, slen + exti)
        l2 = np.where(swap, slen + exti, slen + extj)
        p1s = np.where(swap, p2, p1)
        p2s = np.where(swap, p1, p2)
        p1, p2 = p1s, p2s
    # SEPARATOR trimming (xdropext.c:180-197)
    t = _char_at(sq.s1, p1 + l1 - 1) == SEPARATOR
    l1 = l1 - t
    t = _char_at(sq.s1, p1) == SEPARATOR
    p1 = p1 + t
    l1 = l1 - t
    t = _char_at(sq.s2, p2 + l2 - 1) == SEPARATOR
    l2 = l2 - t
    t = _char_at(sq.s2, p2) == SEPARATOR
    p2 = p2 + t
    l2 = l2 - t

    if not (rcmode or querycompare):
        keep &= _accept_match(l1, p1, l2, p2)

    score = lscore + rscore + slen * MATCHSCORE
    if hamming:
        score = -score
    # EVALSCORE2DISTANCE (match.h:76-77), C truncation; both
    # numerators are nonnegative so // is exact
    dist = np.where(score >= 0,
                    (l1 + l2 - score) // 3,
                    -((l1 + l2 + score) // 3))

    out = seeds.select(keep)
    out.position1 = p1[keep]
    out.position2 = p2[keep]
    out.length1 = l1[keep]
    out.length2 = l2[keep]
    out.distance = dist[keep]
    # mark as x-drop matches (SETFLAGXDROP, mparms.h:67): the -s
    # display path re-derives the alignment with onexdropalignment2
    # semantics (output/xdropalign.py) instead of the greedy aligner
    out.flag = out.flag | FLAGXDROP
    if querycompare:
        # relpos2 shifts with the left extension (xdropext.c:213-217)
        out.relpos2 = out.relpos2 - (pos2[keep] - p2[keep])
    return out
