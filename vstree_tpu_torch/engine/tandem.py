"""Branching tandem repeats in the exact reference emission order.

Reference (src/Vmengine/ftandem.c): the bottom-up traversal fires
``processcompletenode`` for every completed lcp-interval of depth >=
searchlength (ftandem.c:14-21); width-2 intervals check their single
pair directly (processsmallinterval), wider intervals search the
interval for the doubled word ww with ``findmaxprefixlen`` (the
interval-descent binary search, query aligned so query[d..2d) = w) and
scan the witness's lcp>=2d neighbours left-then-right
(tandemleftright, ftandem.c:98-183), emitting a tandem at every
branching start (PROCESSSUFFIX, ftandem.c:68-84).

Copy of :mod:`vstree_tpu.engine.tandem` (host NumPy).

Vectorized node enumeration (NSV/PSV over the lcp array, completion
order = right boundary ascending then depth descending); the per-node
witness binary search replays findmaxpref.gen probe-for-probe, so the
emitted order is bit-identical to the traversal's.
"""

from __future__ import annotations

import numpy as np

from ..core.chardef import WILDCARD
from ..index.esa import ESA
from .match import MatchTable
from .repeats import LcpRmq, _pairs_to_matchtable


def _nodes(lcp: np.ndarray, L: int):
    """All lcp-intervals with depth >= max(L, 1): (left, right, depth)
    rank triples in completion order (right asc, depth desc)."""
    n1 = lcp.size
    d = lcp.astype(np.int64)
    idx = np.flatnonzero(d >= max(L, 1))
    if idx.size == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    rmq = LcpRmq(lcp)

    def nsv(i_arr, vals):
        """first j > i with lcp[j] < v; n1 if none."""
        lo = i_arr + 1
        hi = np.full(i_arr.size, n1, np.int64)
        has = np.zeros(i_arr.size, bool)
        sel = lo <= n1 - 1
        has[sel] = rmq.query(lo[sel], np.full(int(sel.sum()), n1 - 1)
                             ) < vals[sel]
        lo = np.where(has, lo, n1)
        hi = np.where(has, n1 - 1, hi)
        while True:
            open_ = lo < hi
            if not open_.any():
                break
            mid = (lo + hi) // 2
            c = np.zeros(lo.size, bool)
            c[open_] = rmq.query(i_arr[open_] + 1, mid[open_]) \
                < vals[open_]
            hi = np.where(open_ & c, mid, hi)
            lo = np.where(open_ & ~c, mid + 1, lo)
        return np.where(has, lo, n1)

    def psv(i_arr, vals):
        """last j < i with lcp[j] < v; 0 if none (lcp[0] = 0 < v)."""
        lo = np.zeros(i_arr.size, np.int64)
        hi = i_arr - 1
        while True:
            open_ = lo < hi
            if not open_.any():
                break
            mid = (lo + hi + 1) // 2
            c = np.zeros(lo.size, bool)
            c[open_] = rmq.query(mid[open_], i_arr[open_] - 1) \
                < vals[open_]
            lo = np.where(open_ & c, mid, lo)
            hi = np.where(open_ & ~c, mid - 1, hi)
        return lo

    vals = d[idx]
    r = nsv(idx, vals) - 1          # right boundary rank
    a = psv(idx, vals)              # left boundary rank
    trip = np.stack([a, r, vals], axis=1)
    trip = np.unique(trip, axis=0)
    order = np.lexsort((-trip[:, 2], trip[:, 1]))
    trip = trip[order]
    return trip[:, 0], trip[:, 1], trip[:, 2]


def _compare(text, n, sstart, qbase, querylen, lcplen):
    """COMPARE (maxpref.c:30-66): returns (retcode, lcplen'); equal
    specials compare as -1, running past the sentinel as -1."""
    while True:
        if lcplen >= querylen:
            return 0, lcplen
        si = sstart + lcplen
        if si >= n:
            return -1, lcplen
        qc = int(text[qbase + lcplen])
        sc = int(text[si])
        ret = qc - sc
        if ret == 0:
            if sc >= WILDCARD and qc >= WILDCARD:
                return -1, lcplen
            lcplen += 1
            continue
        return ret, lcplen


def _findmaxprefixlen(text, n, suftab, left, right, offset, qbase,
                      querylen):
    """findmaxpref.gen replayed probe-for-probe; returns
    (maxprefix, witness rank)."""
    lcplen = offset
    ret, lcplen = _compare(text, n, int(suftab[left]), qbase, querylen,
                           lcplen)
    wit0, wit1 = lcplen, left
    if ret <= 0:
        return wit0, wit1
    lpref = lcplen
    lcplen = offset
    ret, lcplen = _compare(text, n, int(suftab[right]), qbase,
                           querylen, lcplen)
    rpref = lcplen
    if lpref < rpref:
        wit0, wit1 = rpref, right
        lcplen = lpref
    else:
        wit0, wit1 = lpref, left
    if ret >= 0 or wit0 >= querylen:
        return wit0, wit1
    lo, hi = left, right
    while hi > lo + 1:
        mid = (lo + hi) // 2
        ret, lcplen = _compare(text, n, int(suftab[mid]), qbase,
                               querylen, lcplen)
        if wit0 < lcplen:
            wit0, wit1 = lcplen, mid
        if ret < 0:
            rpref = lcplen
            if lpref < rpref:
                lcplen = lpref
            hi = mid
        elif ret > 0:
            lpref = lcplen
            if rpref < lpref:
                lcplen = rpref
            lo = mid
        else:
            break
    return wit0, wit1


def find_tandems_ref(esa: ESA, searchlength: int) -> MatchTable:
    """Branching tandem repeats, reference emission order."""
    L = max(searchlength, 1)
    lcp = esa.lcptab
    suf = esa.suftab
    text = esa.multiseq.sequence
    n = int(esa.totallength)
    a, r, d = _nodes(lcp, L)
    out: list[tuple[int, int]] = []   # (depth, start)

    def branching(start: int, depth2: int) -> bool:
        if start + depth2 == n:
            return True
        c1 = int(text[start])
        c2 = int(text[start + depth2])
        return c1 != c2 or c1 >= WILDCARD or c2 >= WILDCARD

    for k in range(a.size):
        left, right, depth = int(a[k]), int(r[k]), int(d[k])
        d2 = 2 * depth
        if right - left + 1 <= 2:
            s0, s1 = int(suf[left]), int(suf[left + 1])
            # CHECKPAIR (ftandem.c:55-66)
            if s0 + depth == s1:
                if branching(s0, d2):
                    out.append((depth, s0))
            elif s1 + depth == s0:
                if branching(s1, d2):
                    out.append((depth, s1))
            continue
        qbase = int(suf[left]) - depth
        wit0, wit1 = _findmaxprefixlen(
            text, n, suf, left, right, depth, qbase, d2)
        if wit0 != d2:
            continue
        # tandemleftright (ftandem.c:98-183)
        ind = wit1
        while True:
            s = int(suf[ind])
            if branching(s, d2):
                out.append((depth, s))
            if ind == 0 or lcp[ind] < d2:
                break
            ind -= 1
        ind = wit1 + 1
        while ind <= n and lcp[ind] >= d2:
            s = int(suf[ind])
            if branching(s, d2):
                out.append((depth, s))
            ind += 1

    if not out:
        return MatchTable()
    arr = np.asarray(out, np.int64)
    depth_a = arr[:, 0]
    lo = arr[:, 1]
    return _pairs_to_matchtable(esa, lo, lo + depth_a, depth_a)
