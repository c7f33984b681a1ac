"""Alignment-producing x-drop extension (display path for -exdrop/-hxdrop).

Host re-derivation of the reference's alignment-generating greedy
x-drop DP: reference kurtz/xdrop.gen EVALXDROPTABLE (generation table
with per-generation k-bands, x-drop pruning against the best score
``dback`` generations ago) + kurtz/xdropal2.c onexdropalignment2
(retry loop raising the threshold up to 5 times, tail completion,
xdropgbacktrace with its exact mismatch>insertion>deletion tie-break).
Edit operations use the same encoding as output/align.py (right-to-left
emission, MAXIDENTICALLENGTH-chunked match runs).

Scoring (include/xdropdef.h): match +2, mismatch -1, indel -1.5 —
realised integrally as S'(i+j) = (i+j) - 3d at generation d.
"""

from __future__ import annotations

import numpy as np

from ..core.chardef import SEPARATOR, WILDCARD
from .align import (
    DELETIONEOP,
    INSERTIONEOP,
    MAXIDENTICALLENGTH,
    MISMATCHEOP,
)


def _store_editop(eops: list[int], matchlen: int) -> None:
    """STOREEDITOP (xdropal2.c:44-59): max-chunks first, nothing for
    a zero-length run (unlike galign's ADDIDENTICAL)."""
    if matchlen > 0:
        while matchlen > MAXIDENTICALLENGTH:
            eops.append(MAXIDENTICALLENGTH)
            matchlen -= MAXIDENTICALLENGTH
        eops.append(matchlen)

_MINUS_INF = None  # sentinel: scores list entries are int or None


class _Gen:
    __slots__ = ("smallestk", "largestk", "scores", "ttab")

    def __init__(self, smallestk, largestk):
        self.smallestk = smallestk
        self.largestk = largestk
        self.scores: list[int | None] = []
        self.ttab = 0

    def score(self, k):
        if self.smallestk <= k <= self.largestk:
            return self.scores[k - self.smallestk]
        return _MINUS_INF


def _snake(u, v, i, j, ulen, vlen):
    """Extend a run of identities (COMPARESYMBOLSSEP semantics:
    separators truncate the strings, wildcards never match)."""
    while i < ulen and j < vlen:
        a = u[i]
        if a == SEPARATOR:
            ulen = i
            break
        b = v[j]
        if b == SEPARATOR:
            vlen = j
            break
        if a != b or a == WILDCARD:
            break
        i += 1
        j += 1
    return i, j, ulen, vlen


def _eval_table(u, v, xdropbelowscore):
    """EVALXDROPTABLE (xdrop.gen:205-373): returns (generations, best)
    where best = (score, kbest, dbest, ivalue, jvalue)."""
    ulen, vlen = len(u), len(v)
    intmax = max(ulen, vlen)
    intmin = -intmax
    gens: list[_Gen] = []
    g0 = _Gen(0, 0)
    # gen-0 snake along the main diagonal, bounded by MIN(ulen, vlen)
    # (xdrop.gen:228-232); separator truncation updates ulen/vlen
    i = 0
    while i < min(ulen, vlen):
        a = u[i]
        if a == SEPARATOR:
            ulen = i
            break
        b = v[i]
        if b == SEPARATOR:
            vlen = i
            break
        if a != b or a == WILDCARD:
            break
        i += 1
    g0.scores.append(i)
    best = [2 * i, 0, 0, i, i]  # score, kbest, dbest, ivalue, jvalue
    g0.ttab = best[0] - xdropbelowscore
    gens.append(g0)
    lower = upper = 0
    dmulti = 0
    dback = -((xdropbelowscore + 1) // 3)
    while True:
        dmulti += 3
        gen = _Gen(lower - 1, upper + 1)
        prev = gens[-1]
        minisfinite = minisM = intmax
        maxisfinite = maxisN = intmin
        dbackvalue = (-xdropbelowscore if dback < 0 else gens[dback].ttab)
        for k in range(lower - 1, upper + 2):
            i = _MINUS_INF
            if lower < k:  # DELETIONEOP
                t = prev.score(k - 1)
                if t is not _MINUS_INF:
                    i = t + 1
            if lower <= k <= upper:  # MISMATCHEOP
                t = prev.score(k)
                if t is not _MINUS_INF and (i is _MINUS_INF or i <= t):
                    i = t + 1
            if k < upper:  # INSERTIONEOP
                t = prev.score(k + 1)
                if t is not _MINUS_INF and (i is _MINUS_INF or i < t):
                    i = t
            if i is _MINUS_INF:
                gen.scores.append(_MINUS_INF)
                continue
            j = i - k
            if (i + j) - dmulti < dbackvalue:
                gen.scores.append(_MINUS_INF)
                continue
            i, j, ulen, vlen = _snake(u, v, i, j, ulen, vlen)
            if j == vlen:
                maxisN = k
            if i == ulen and minisM > k:
                minisM = k
            if minisfinite > k:
                minisfinite = k
            maxisfinite = k
            gen.scores.append(i)
            tmp = (i + j) - dmulti
            if best[0] < tmp:
                best = [tmp, k, len(gens), i, j]
        gens.append(gen)
        lower = max(minisfinite, maxisN + 2)
        upper = min(maxisfinite, minisM - 2)
        if lower > upper + 2:
            break
        gen.ttab = best[0] - xdropbelowscore
        dback += 1
    return gens, best


def _backtrace(eops, gens, best):
    """xdropgbacktrace (xdropal2.c:59-160): exact eop preference
    mismatch > insertion > deletion on table-value maxima."""
    score, k, dbest, ilast, jlast = best
    indel = 0
    for d in range(dbest, 0, -1):
        gen = gens[d - 1]
        i = _MINUS_INF
        eop = 0
        t = gen.score(k)
        if gen.smallestk <= k <= gen.largestk:
            i = t
            if i is not _MINUS_INF:
                i += 1
            eop = MISMATCHEOP
        t = gen.score(k + 1)
        if gen.smallestk <= k + 1 <= gen.largestk:
            if t is not _MINUS_INF and (i is _MINUS_INF or i < t):
                eop = INSERTIONEOP
                i = t
        t = gen.score(k - 1)
        if gen.smallestk <= k - 1 <= gen.largestk:
            if t is not _MINUS_INF:
                t += 1
                if i is _MINUS_INF or i < t:
                    eop = DELETIONEOP
                    i = t
        if eop == MISMATCHEOP:
            matchlen = ilast - i
            _store_editop(eops, matchlen)
            ilast -= matchlen + 1
            jlast -= matchlen + 1
            eops.append(MISMATCHEOP)
        elif eop == INSERTIONEOP:
            matchlen = jlast - (i - k)
            _store_editop(eops, matchlen)
            ilast -= matchlen
            jlast -= matchlen + 1
            eops.append(INSERTIONEOP)
            indel += 1
            k += 1
        else:  # DELETIONEOP
            matchlen = ilast - i
            _store_editop(eops, matchlen)
            ilast -= matchlen + 1
            jlast -= matchlen
            eops.append(DELETIONEOP)
            indel += 1
            k -= 1
    _store_editop(eops, ilast)
    return indel


def _xdropal1(eops: list[int], u, v) -> int:
    """onexdropalignment1 forward (xdropal1.c:41-239): full DP over
    the xdrop scores (match +2, mismatch -1, indel -2) with edge-bit
    backtrace from the best-scoring PREFIX cell (not the corner) and
    bit preference match > mismatch > insertion > deletion.  Plain
    ``==`` symbol comparison — no wildcard/separator special-casing,
    exactly like the reference.  Appends eops (right-to-left), returns
    the indel count."""
    ulen, vlen = len(u), len(v)
    INDEL, MATCH, MIS = -2, 2, -1
    MB, MMB, IB, DB = 1, 2, 4, 8
    scol = [0] * (ulen + 1)
    edges = bytearray((ulen + 1) * (vlen + 1))
    best = 0
    bi = bj = 0
    edges[0] = 0
    for i in range(1, ulen + 1):
        scol[i] = scol[i - 1] + INDEL
        edges[i] = DB
    idx = ulen + 1
    for j in range(vlen):
        nw = scol[0]
        scol[0] = nw + INDEL
        edges[idx] = IB
        idx += 1
        for i in range(ulen):
            we = scol[i + 1]
            val = scol[i] + INDEL
            bits = DB
            if u[i] == v[j]:
                sc, rb = MATCH, MB
            else:
                sc, rb = MIS, MMB
            t = nw + sc
            if val == t:
                bits |= rb
            elif val < t:
                bits = rb
                val = t
            t = we + INDEL
            if val == t:
                bits |= IB
            elif val < t:
                bits = IB
                val = t
            scol[i + 1] = val
            edges[idx] = bits
            idx += 1
            if best < val:
                best = val
                bi = i + 1
                bj = j
            nw = we
    # backtrace (xdropal1.c:172-230), eptr = edges + (ulen+1)*jvalue
    # + ivalue — the reference's own indexing, reproduced verbatim
    pos = (ulen + 1) * bj + bi
    indel = 0
    while True:
        b = edges[pos]
        if b & MB:
            if eops and 0 < (eops[-1] & MAXIDENTICALLENGTH) \
                    < MAXIDENTICALLENGTH:
                eops[-1] += 1
            else:
                eops.append(1)
            pos -= ulen + 2
        elif b & MMB:
            eops.append(MISMATCHEOP)
            pos -= ulen + 2
        elif b & IB:
            eops.append(INSERTIONEOP)
            indel += 1
            pos -= ulen + 1
        elif b & DB:
            eops.append(DELETIONEOP)
            indel += 1
            pos -= 1
        else:
            break
    return indel


def xdrop_alignment(useq, vseq, xdropbelowscore) -> tuple[int, list[int]]:
    """onexdropalignment2 forward (xdropal2.c:166-247): greedy x-drop
    alignment of the full strings, with up-to-5 threshold retries and
    unpruned tail completion.  Returns (indelcount, eops right-to-left).
    """
    u = np.asarray(useq).astype(np.int64).tolist()
    v = np.asarray(vseq).astype(np.int64).tolist()
    x = abs(int(xdropbelowscore))  # SETFLAGXDROP stores ABS(score)
    ulen, vlen = len(u), len(v)
    gens = None
    best = None
    for score in range(x, x + 5):
        gens, best = _eval_table(u, v, score)
        if best[3] == ulen and best[4] == vlen:
            break
    eops: list[int] = []
    indel = 0
    if best[3] != ulen or best[4] != vlen:
        # tail not reached within 5 retries: align the remainder with
        # the full-DP pass (onexdropalignment1, xdropal2.c:218-236)
        indel += _xdropal1(eops, u[best[3]:], v[best[4]:])
    indel += _backtrace(eops, gens, best)
    return indel, eops
