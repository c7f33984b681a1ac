"""Maximal repeated pairs (vmatch -l, self matches).

Reference algorithm (src/Vmengine/vmatfind.c:240-541): Abouelhoda-
Kurtz-Ohlebusch bottom-up traversal with per-node position lists
partitioned by left context character; cartesian products of
left-diverse pairs.

Copy of :mod:`vstree_tpu.engine.repeats` (host NumPy) with two
departures: there is no ``_use_device_engines`` switch, and
:func:`find_maximal_pairs_ref` always runs the torch program of
:mod:`vstree_tpu_torch.engine.repeats_dev` on ``esa.dev``.

Reformulation (SURVEY.md §7): a maximal pair is fully
characterized WITHOUT a traversal —

    (p, q) with p < q is a maximal repeat of length d  iff
      d = lce(p, q) >= searchlength   (right-maximality is automatic:
                                       d is the exact mismatch point)
      and the left contexts diverge: text[p-1] != text[q-1], where a
      special char / sequence start counts as always-diverse
      (vmatfind.c:44-45 ISLEFTDIVERSE, uniquechar list semantics).

Since lce(suffix at rank i, suffix at rank j) = min lcp[i+1..j], the
candidate pairs are exactly the rank pairs inside maximal runs of
lcp >= searchlength, their lengths are range-minima (sparse-table RMQ,
vectorized gathers), and left-divergence is an elementwise key
comparison on the bwt.  No stack, no pointer chasing — pair expansion,
RMQ and filtering are flat array ops.

Emission order is canonical (interval-major, then (i, j) rank pairs);
the reference's own differential tests compare sorted outputs
(bin/Cmponl.sh), and `-sort` modes reorder deterministically.
"""

from __future__ import annotations

import numpy as np

from ..core.chardef import WILDCARD
from ..device import phase
from ..index.esa import ESA
from .match import MatchTable

# cap on per-chunk expanded candidate pairs (memory control)
_PAIR_CHUNK = 1 << 22


class LcpRmq:
    """Sparse-table range-minimum over the lcp array (host NumPy).
    O(n log n) build, O(1) batched queries via two gathers."""

    def __init__(self, lcp: np.ndarray):
        n = lcp.size
        levels = max(1, int(np.floor(np.log2(max(n, 1)))) + 1)
        self.table = [lcp.astype(np.int32)]
        for k in range(1, levels):
            prev = self.table[-1]
            half = 1 << (k - 1)
            if prev.size <= half:
                break
            self.table.append(
                np.minimum(prev[:-half], prev[half:])
            )
        self.n = n

    def query(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        """min lcp[lo..hi] inclusive, lo <= hi (vectorized)."""
        width = hi - lo + 1
        k = np.maximum(np.int64(np.log2(1)), 0)
        k = np.floor(np.log2(width)).astype(np.int64)
        out = np.empty(lo.size, np.int32)
        for kk in np.unique(k):
            t = self.table[int(kk)]
            sel = k == kk
            a = lo[sel]
            b = hi[sel] - (1 << int(kk)) + 1
            out[sel] = np.minimum(t[a], t[b])
        return out


def _diverse_keys(esa: ESA) -> np.ndarray:
    """Left-context key per rank: regular bwt char, or a unique value
    for specials / suffix 0 (always left-diverse)."""
    bwt = esa.bwttab
    n1 = bwt.size
    ranks = np.arange(n1, dtype=np.int64)
    keys = np.where(bwt < WILDCARD, bwt.astype(np.int64), 256 + ranks)
    return keys


def _l_runs(lcp: np.ndarray, L: int) -> tuple[np.ndarray, np.ndarray]:
    """Maximal runs of lcp >= L: returns (left, right) rank intervals
    (run over lcp indices [s..e] covers suffix ranks [s-1..e])."""
    ge = lcp >= L
    starts = np.flatnonzero(ge & ~np.concatenate([[False], ge[:-1]]))
    ends_idx = np.flatnonzero(ge & ~np.concatenate([ge[1:], [False]]))
    return starts - 1, ends_idx


def _iter_pair_chunks(left: np.ndarray, m: np.ndarray):
    """Yield (left_slice, m_slice) with bounded expanded pair count."""
    npairs = (m * (m - 1)) // 2
    cum = np.cumsum(npairs)
    bounds = [0]
    last = 0
    for i in range(left.size):
        if cum[i] - last > _PAIR_CHUNK and i > bounds[-1]:
            bounds.append(i)
            last = cum[i - 1]
    bounds.append(left.size)
    for ci in range(len(bounds) - 1):
        lo, hi = bounds[ci], bounds[ci + 1]
        if lo < hi:
            yield left[lo:hi], m[lo:hi]


def _expand_pairs(left: np.ndarray, m: np.ndarray):
    """All rank pairs (i < j) within each interval, interval-major,
    (i, j) lexicographic — flat triangular index decode."""
    npairs = (m * (m - 1)) // 2
    total = int(npairs.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z
    iv = np.repeat(np.arange(left.size), npairs)
    start = np.concatenate([[0], np.cumsum(npairs)[:-1]])
    pidx = np.arange(total) - start[iv]
    kk = m[iv]
    s_off = np.floor(
        (2 * kk - 1 - np.sqrt((2 * kk - 1) ** 2 - 8 * pidx)) / 2
    ).astype(np.int64)
    before = s_off * (2 * kk - s_off - 1) // 2
    s_off[before > pidx] -= 1
    before = s_off * (2 * kk - s_off - 1) // 2
    t_off = pidx - before + s_off + 1
    return left[iv] + s_off, left[iv] + t_off


def _pairs_to_matchtable(esa: ESA, lo, hi, d) -> MatchTable:
    ms = esa.multiseq
    seq1, rel1 = ms.pos_to_pair(lo)
    seq2, rel2 = ms.pos_to_pair(hi)
    tot = lo.size
    return MatchTable(
        length1=d,
        position1=lo,
        length2=d.copy(),
        position2=hi,
        distance=np.zeros(tot, np.int64),
        flag=np.zeros(tot, np.int64),
        seqnum1=seq1,
        relpos1=rel1,
        seqnum2=seq2,
        relpos2=rel2,
        evalue=np.zeros(tot, np.float64),
        idnumber=np.zeros(tot, np.int64),
        transnum=np.full(tot, -1, np.int64),
    )


def find_maximal_pairs(esa: ESA, searchlength: int) -> MatchTable:
    """Enumerate all maximal repeated pairs of length >= searchlength."""
    L = max(searchlength, 1)
    left, right = _l_runs(esa.lcptab, L)
    if left.size == 0:
        return MatchTable()
    m = right - left + 1
    rmq = LcpRmq(esa.lcptab)
    keys = _diverse_keys(esa)
    suf = esa.suftab

    out: list[MatchTable] = []
    for lchunk, mchunk in _iter_pair_chunks(left, m):
        i_rank, j_rank = _expand_pairs(lchunk, mchunk)
        diverse = keys[i_rank] != keys[j_rank]
        i_rank, j_rank = i_rank[diverse], j_rank[diverse]
        if i_rank.size == 0:
            continue
        d = rmq.query(i_rank + 1, j_rank).astype(np.int64)
        p1 = suf[i_rank].astype(np.int64)
        p2 = suf[j_rank].astype(np.int64)
        out.append(_pairs_to_matchtable(
            esa, np.minimum(p1, p2), np.maximum(p1, p2), d
        ))
    return MatchTable.concat(out)


def find_tandems(esa: ESA, searchlength: int) -> MatchTable:
    """Branching tandem repeats (reference src/Vmengine/ftandem.c).

    Characterization (equivalent to the reference's per-interval
    doubled-string search, ftandem.c:98-252): position p starts a
    branching tandem ww with |w| = d  iff  lce(p, p+d) == d exactly
    and d >= searchlength — the exact-lce condition simultaneously
    gives text[p..p+d-1] == text[p+d..p+2d-1] and the branching
    requirement text[p] != text[p+2d] (or text end / special).
    Emitted as (pos1=p, pos2=p+d, length=d) per OUTTANDEM
    (ftandem.c:30-39)."""
    L = max(searchlength, 1)
    left, right = _l_runs(esa.lcptab, L)
    if left.size == 0:
        return MatchTable()
    m = right - left + 1
    rmq = LcpRmq(esa.lcptab)
    suf = esa.suftab

    out: list[MatchTable] = []
    for lchunk, mchunk in _iter_pair_chunks(left, m):
        i_rank, j_rank = _expand_pairs(lchunk, mchunk)
        if i_rank.size == 0:
            continue
        p1 = suf[i_rank].astype(np.int64)
        p2 = suf[j_rank].astype(np.int64)
        lo = np.minimum(p1, p2)
        hi = np.maximum(p1, p2)
        # cheap prefilter: gap == some d in [L, run-local max] requires
        # gap >= L; exact check needs lce
        gap = hi - lo
        cand = gap >= L
        if not cand.any():
            continue
        i_rank, j_rank = i_rank[cand], j_rank[cand]
        lo, hi, gap = lo[cand], hi[cand], gap[cand]
        d = rmq.query(i_rank + 1, j_rank).astype(np.int64)
        tandem = d == gap
        if not tandem.any():
            continue
        lo, hi, d = lo[tandem], hi[tandem], d[tandem]
        out.append(_pairs_to_matchtable(esa, lo, lo + d, d))
    return MatchTable.concat(out)


# ---------------------------------------------------------------------
# Reference emission order as a computed sort key (vectorized)
# ---------------------------------------------------------------------
#
# The reference streams pairs through the bottom-up traversal
# (vdfstrav.c:248-420 + vmatfind.c processleafedge/processbranch).  Its
# emission order decomposes into a per-pair sort key, so the TPU-native
# path can enumerate pairs with flat array ops and restore the exact
# order with one lexsort:
#
# For a pair of ranks (i < j) with LCA depth d = min lcp(i+1..j):
#
# 1. event time t = first rank r >= j with lcp[r+1] <= d — the scan
#    step at which the subtree containing j merges into the LCA (the
#    lcp-interval pop; t == j iff j attaches as a direct leaf edge).
# 2. within one scan step, pops cascade deepest-first: d DESCENDING.
# 3. within one merge event, emission iterates the father's per-char
#    position windows in class order then the unique list
#    (vmatfind.c:241-290 cartproduct1/2; windows accumulate in rank
#    order): order by (class(i), class(j), rank_i, rank_j), where
#    class = bwt char for regular left context, sigma for the unique
#    list (specials + suffix 0), EXCEPT son-unique pairs which loop
#    u-outer/p-inner (vmatfind.c:282-285): (rank_j, rank_i) there.


def _pair_event_times(lcp_rmq: "LcpRmq", j_rank, d, run_right):
    """first r >= j with lcp[r+1] <= d, vectorized binary search on
    the range-minimum table (monotone in r; bounded by the enclosing
    lcp>=L run, whose right boundary satisfies the predicate)."""
    lo = j_rank.copy()
    hi = run_right.copy()
    while True:
        open_ = lo < hi
        if not open_.any():
            break
        mid = (lo + hi) // 2
        sel = open_
        cond = np.zeros(lo.size, bool)
        cond[sel] = lcp_rmq.query(
            (j_rank[sel] + 1).astype(np.int64),
            (mid[sel] + 1).astype(np.int64),
        ) <= d[sel]
        hi = np.where(open_ & cond, mid, hi)
        lo = np.where(open_ & ~cond, mid + 1, lo)
    return lo


def maximal_pairs_ref_order_vec(
    esa: ESA, searchlength: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(d, rank_i, rank_j) of all maximal pairs in the exact reference
    emission order, computed by flat array ops + one lexsort (no
    traversal, no Python stack)."""
    L = max(searchlength, 1)
    lcp = esa.lcptab
    left, right = _l_runs(lcp, L)
    if left.size == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    m = right - left + 1
    rmq = LcpRmq(lcp)
    keys = _diverse_keys(esa)
    sigma = esa.alpha.num_regular
    # class: regular bwt char < sigma; anything else (wildcards,
    # UNDEFBWTCHAR at rank `longest`) joins the unique list (class
    # sigma), matching _addpos base >= sigma (vmatfind.c:334-340)
    cls = np.where(keys < sigma, keys, sigma).astype(np.int64)

    out_d, out_i, out_j, out_key = [], [], [], []
    npairs_runs = (m * (m - 1)) // 2
    # iterate chunks but keep a global sort at the end (events never
    # cross runs, so per-chunk sorting would also be valid as long as
    # chunks split on run boundaries — which _iter_pair_chunks does)
    offset = 0
    order_chunks = []
    for lchunk, mchunk in _iter_pair_chunks(left, m):
        i_rank, j_rank = _expand_pairs(lchunk, mchunk)
        diverse = keys[i_rank] != keys[j_rank]
        i_rank, j_rank = i_rank[diverse], j_rank[diverse]
        if i_rank.size == 0:
            continue
        d = rmq.query(i_rank + 1, j_rank).astype(np.int64)
        # run right boundary per pair: runs are disjoint and chunks
        # split on run boundaries; recover via searchsorted
        ridx = np.searchsorted(lchunk, i_rank, side="right") - 1
        rr_all = lchunk + mchunk - 1
        run_right = rr_all[ridx]
        t = _pair_event_times(rmq, j_rank, d, run_right)
        F = cls[i_rank]
        S = cls[j_rank]
        swap = (F < sigma) & (S == sigma)
        X = np.where(swap, j_rank, i_rank)
        Y = np.where(swap, i_rank, j_rank)
        # father-regular: class-of-son outer, father list inner
        # (vmatfind.c:270-281) -> (F, S, X, Y); father-unique: fu
        # outer, then class of son (vmatfind.c:286-290) -> (F, X, S, Y)
        A = np.where(F == sigma, X, S)
        Bk = np.where(F == sigma, S, X)
        order = np.lexsort((Y, Bk, A, F, -d, t))
        out_d.append(d[order])
        out_i.append(i_rank[order])
        out_j.append(j_rank[order])
        # chunk-major is correct: chunks split on run boundaries and
        # runs emit in rank order (event times are within-run)
    if not out_d:
        z = np.zeros(0, np.int64)
        return z, z, z
    return (np.concatenate(out_d), np.concatenate(out_i),
            np.concatenate(out_j))


# ---------------------------------------------------------------------
# Reference-emission-order enumeration (stack simulator — retained as
# the differential test oracle for the computed-key path above)
# ---------------------------------------------------------------------

# GETLEFTCHAR at rank `longest` yields INITIALCHAR = alphabetsize+1
# (vmatfind.c:46) — >= ISLEFTDIVERSE, lands in the unique list


class _Slot:
    """One stack slot of the reference traversal (vmatfind.c Nodeinfo).
    PUSHDFS reuses slots without clearing the list windows — a node
    whose first successor is a completed branch INHERITS the popped
    child's windows by that slot reuse (vdfstrav.c:168-171 sets only
    depth/lastisleafedge; processbranch firstsucc==True is a no-op)."""

    __slots__ = ("depth", "leaf_pending", "commonchar", "start",
                 "length", "ustart", "ulen")

    def __init__(self, sigma: int):
        self.depth = 0
        self.leaf_pending = True
        self.commonchar = 0
        self.start = [0] * sigma
        self.length = [0] * sigma
        self.ustart = 0
        self.ulen = 0


def maximal_pairs_ref_order(esa: ESA, searchlength: int):
    """Maximal repeated pairs in the EXACT emission order of the
    reference bottom-up traversal (vdfstrav.c:248-420 driving
    vmatfind.c processleafedge/processbranch/cartproduct1/2) — the
    order the reference streams matches through processexactselfmatch
    (fself.c:95), which -pp chaining/matchcluster ids and bit-identical
    output depend on.

    Only ranks inside maximal runs of lcp >= searchlength can emit or
    carry state (processleafedge/processbranch reset and return at
    father.depth < searchlength), so the stack simulation runs per
    run; runs in rank order = global emission order.

    Yields (depth, pos_i, pos_j) triples (unnormalized orientation, as
    handed to the output callback)."""
    L = max(searchlength, 1)
    lcp = esa.lcptab
    suf = esa.suftab
    bwt = esa.bwttab
    longest = esa.longest
    sigma = esa.alpha.num_regular
    ILD = sigma                       # ISLEFTDIVERSE (vmatfind.c:45)
    initialchar = sigma + 1           # INITIALCHAR (vmatfind.c:46)
    left_runs, right_runs = _l_runs(lcp, L)
    out: list[tuple[int, int, int]] = []
    emit = out.append

    for run in range(left_runs.size):
        a = int(left_runs[run])
        b = int(right_runs[run])
        pos: list[list[int]] = [[] for _ in range(sigma)]
        uniq: list[int] = []
        slots = [_Slot(sigma)]
        nf = 1

        def leafedge(firstsucc, father, leftchar, leafpos):
            if father.depth < L:
                return
            depth = father.depth
            if firstsucc:
                father.commonchar = leftchar
                father.ustart = len(uniq)
                father.ulen = 0
                for c in range(sigma):
                    father.start[c] = len(pos[c])
                    father.length[c] = 0
                _addpos(father, leftchar, leafpos)
                return
            if father.commonchar != ILD and (
                    father.commonchar != leftchar or leftchar >= ILD):
                father.commonchar = ILD
            if father.commonchar == ILD:
                for c in range(sigma):
                    if c != leftchar:
                        s = father.start[c]
                        for p in pos[c][s: s + father.length[c]]:
                            emit((depth, leafpos, p))
                s = father.ustart
                for u in uniq[s: s + father.ulen]:
                    emit((depth, leafpos, u))
            _addpos(father, leftchar, leafpos)

        def _addpos(ninfo, base, leafpos):
            if base >= sigma:
                uniq.append(leafpos)
                ninfo.ulen += 1
            else:
                pos[base].append(leafpos)
                ninfo.length[base] += 1

        def branchedge(firstsucc, father, son):
            if father.depth < L:
                return
            if firstsucc:
                # adoption via slot reuse (no-op)
                return
            depth = father.depth
            if father.commonchar != ILD:
                if son.commonchar != ILD:
                    if father.commonchar != son.commonchar \
                            or son.commonchar >= ILD:
                        father.commonchar = ILD
                else:
                    father.commonchar = ILD
            if father.commonchar == ILD:
                su = uniq[son.ustart: son.ustart + son.ulen]
                for cf in range(sigma):
                    fs = father.start[cf]
                    flist = pos[cf][fs: fs + father.length[cf]]
                    for cs in range(sigma):
                        if cs != cf:
                            ss = son.start[cs]
                            slist = pos[cs][ss: ss + son.length[cs]]
                            for p1 in flist:
                                for p2 in slist:
                                    emit((depth, p1, p2))
                    for u in su:
                        for p in flist:
                            emit((depth, u, p))
                fs = father.ustart
                for fu in uniq[fs: fs + father.ulen]:
                    for cs in range(sigma):
                        ss = son.start[cs]
                        for p in pos[cs][ss: ss + son.length[cs]]:
                            emit((depth, fu, p))
                    for u in su:
                        emit((depth, fu, u))
            for c in range(sigma):
                father.length[c] += son.length[c]
            father.ulen += son.ulen

        for i in range(a, b + 1):
            currentlcp = int(lcp[i + 1])
            prevsuf = int(suf[i])
            lc = initialchar if i == longest else int(bwt[i])
            while currentlcp < slots[nf - 1].depth:
                top = slots[nf - 1]
                if top.leaf_pending:
                    leafedge(False, top, lc, prevsuf)
                else:
                    branchedge(False, top, slots[nf])
                nf -= 1
            top = slots[nf - 1]
            if i == b:
                break          # end of run: only shallow events remain
            if currentlcp == top.depth:
                if top.leaf_pending:
                    leafedge(False, top, lc, prevsuf)
                else:
                    branchedge(False, top, slots[nf])
                    top.leaf_pending = True
            else:
                if nf == len(slots):
                    slots.append(_Slot(sigma))
                newtop = slots[nf]
                newtop.depth = currentlcp
                newtop.leaf_pending = True
                nf += 1
                below = slots[nf - 2]
                if below.leaf_pending:
                    leafedge(True, newtop, lc, prevsuf)
                    below.leaf_pending = False
                # else: PROCESSBRANCHEDGE(True) — a no-op: the new node
                # adopts the just-popped child's windows by slot reuse
    return out


def find_maximal_pairs_ref(esa: ESA, searchlength: int) -> MatchTable:
    """find_maximal_pairs with the reference's exact emission order
    (processexactselfmatch normalizes each pair to (min, max) —
    ACCEPTMATCH, fself.c:23-32).  The whole pipeline (expansion, RMQ,
    event times, emission sort) runs as torch programs on ``esa.dev``
    (engine/repeats_dev.py); the positions are gathered on the host."""
    from .repeats_dev import maximal_pairs_device

    d, ri, rj = maximal_pairs_device(esa, searchlength, ref_order=True)
    if d.size == 0:
        return MatchTable()
    with phase("positions"):
        p1 = esa.suftab[ri].astype(np.int64)
        p2 = esa.suftab[rj].astype(np.int64)
        lo = np.minimum(p1, p2)
        hi = np.maximum(p1, p2)
        return _pairs_to_matchtable(esa, lo, hi, d)


def find_maximal_pairs_ref_sim(esa: ESA, searchlength: int) -> MatchTable:
    """Stack-simulator variant (test oracle for the computed key)."""
    trip = maximal_pairs_ref_order(esa, searchlength)
    tot = len(trip)
    if tot == 0:
        return MatchTable()
    arr = np.asarray(trip, np.int64).reshape(tot, 3)
    d = arr[:, 0]
    lo = np.minimum(arr[:, 1], arr[:, 2])
    hi = np.maximum(arr[:, 1], arr[:, 2])
    return _pairs_to_matchtable(esa, lo, hi, d)
