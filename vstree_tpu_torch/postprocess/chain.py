"""2-D fragment chaining (chain2dim).

Reference: src/kurtz-basic/chain2dim.c.  The scores computed here
follow ``bruteforcechainingscores`` (chain2dim.c:776-890) — the
reference's own specification oracle for its sweep implementation —
with the inner predecessor maximisation vectorized over fragments.
Chain retrieval mirrors findmaximalscores / retrievechainthreshold
(chain2dim.c:1169-1363): right-maximal chains, local equivalence
classes by chain start, thresholds for the local modes.

Modes (include/chaindef.h:25-31): global [gc|ov], local
[minscore | k best | percent away].
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..engine.match import MatchTable

GLOBAL = "global"
GLOBALGC = "globalgc"
GLOBALOV = "globalov"
LOCALMAX = "localmax"
LOCALTHRESH = "localthreshold"
LOCALBEST = "localbest"
LOCALPERCENT = "localpercent"

UNDEF = -1


@dataclass
class ChainMode:
    kind: str = GLOBAL
    minscore: int = 0
    howmanybest: int = 0
    percentaway: int = 0
    maxgapwidth: int = 0
    weightfactor: float = 1.0
    # chainvm.c / chncallparse.c extras (used by vmatch -pp chain and
    # the standalone chain2dim tool)
    silent: bool = False
    outprefix: str | None = None
    withinborders: bool = False
    dothreading: bool = False
    # -thread keyword arguments (chncallparse.c:177-222)
    minthreadlen1: int = 0
    maxerror1: int = 0
    minthreadlen2: int = 0
    maxerror2: int = 0


@dataclass
class Chains:
    """Result: per chain the fragment indices (into the presorted
    match table) and its score."""
    fragments: list[np.ndarray]
    scores: list[int]
    table: MatchTable          # the presorted matches


def _fragments_from_matches(mt: MatchTable, mode: ChainMode):
    """vmatchinitfragmentinfo (Vmatch/chainvm.c:29-80): weight =
    weightfactor * |score|; terminal gaps for every mode but plain
    global."""
    s0 = mt.position1.astype(np.int64)
    e0 = s0 + mt.length1 - 1
    s1 = mt.position2.astype(np.int64)
    e1 = s1 + mt.length2 - 1
    weight = (mode.weightfactor * np.abs(mt.score)).astype(np.int64)
    init_gap = s0 + s1
    if len(mt):
        term_gap = (e0.max() - e0) + (e1.max() - e1)
    else:
        term_gap = np.zeros(0, np.int64)
    return s0, e0, s1, e1, weight, init_gap, term_gap




class _MaxFenwick:
    """Fenwick tree over compressed keys carrying (value, -index)
    pairs under max — the sweep dictionary of fastchaining
    (chain2dim.c:1818; red-black tree there, prefix-max here)."""

    __slots__ = ("n", "t")

    def __init__(self, n: int):
        self.n = n
        self.t = [(-(1 << 62), 0)] * (n + 1)

    def update(self, i: int, val):
        i += 1
        t = self.t
        while i <= self.n:
            if t[i] < val:
                t[i] = val
            i += i & (-i)

    def query_prefix(self, i: int):
        """max over keys [0, i)."""
        best = (-(1 << 62), 0)
        t = self.t
        while i > 0:
            if t[i] > best:
                best = t[i]
            i -= i & (-i)
        return best


def _chain_scores_sweep(n, s0, e0, s1, e1, w, ig, tg, mode, gc, local):
    """O(n log n) sweep replacement for the brute-force predecessor
    maximisation: fragments (sorted by s1) are activated when the
    sweep line passes their e1, a Fenwick dictionary keyed by e0
    answers max-priority over e0 < s0[j], with priority encoding the
    j-independent part of the candidate score and ties broken to the
    smallest fragment index (matching np.argmax first-maximum order of
    the brute force)."""
    score = np.zeros(n, np.int64)
    prev = np.full(n, UNDEF, np.int64)
    first = np.arange(n, dtype=np.int64)
    if n == 0:
        return score, prev, first
    keys = np.unique(e0)
    fen = _MaxFenwick(keys.size)
    e0c = np.searchsorted(keys, e0)
    act = np.argsort(e1, kind="stable")     # activation order by e1
    ai = 0
    NEG = -(1 << 62)
    for j in range(n):
        while ai < n and e1[act[ai]] < s1[j]:
            i = int(act[ai])
            if i < j:                        # processed fragments only
                if gc:
                    pri = score[i] + e0[i] + e1[i] + tg[i]
                elif local:
                    pri = score[i] + e0[i] + e1[i]
                else:
                    pri = score[i]
                fen.update(int(e0c[i]), (int(pri), -i))
                ai += 1
            else:
                break
        hi = int(np.searchsorted(keys, s0[j]))   # keys < s0[j]
        val, negi = fen.query_prefix(hi)
        if val <= NEG:
            score[j] = w[j] - ((ig[j] + tg[j]) if gc else 0)
            continue
        i = -negi
        if gc:
            score[j] = val - (s0[j] + s1[j]) + w[j] - tg[j]
            prev[j] = i
            first[j] = first[i]
        elif local:
            base = val - (s0[j] + s1[j])
            if base > 0:
                score[j] = base + w[j]
                prev[j] = i
                first[j] = first[i]
            else:
                score[j] = w[j]
        else:
            score[j] = val + w[j]
            prev[j] = i
            first[j] = first[i]
    return score, prev, first


def chain_fragments(mt: MatchTable, mode: ChainMode,
                    _force_brute: bool = False) -> Chains:
    """Compute chains over a match table presorted by position2
    (vmatch presortdim == 1, chainvm.c:256)."""
    order = np.argsort(mt.position2, kind="stable")
    mt = mt.select(order)
    n = len(mt)
    s0, e0, s1, e1, w, ig, tg = _fragments_from_matches(mt, mode)
    gc = mode.kind in (GLOBALGC,)
    ov = mode.kind == GLOBALOV
    local = mode.kind in (LOCALMAX, LOCALTHRESH, LOCALBEST,
                          LOCALPERCENT)

    if not ov and not mode.maxgapwidth and not _force_brute:
        # fastchaining sweep (chain2dim.c:1818): O(n log n)
        score, prev, first = _chain_scores_sweep(
            n, s0, e0, s1, e1, w, ig, tg, mode, gc, local)
        return _retrieve_chains(mt, mode, n, w, ig, tg, gc, local,
                                score, prev, first)

    score = np.zeros(n, np.int64)
    prev = np.full(n, UNDEF, np.int64)
    first = np.arange(n, dtype=np.int64)

    if n >= 1:
        score[0] = w[0] - ((ig[0] + tg[0]) if gc else 0)
    for j in range(1, n):
        # predecessor candidates i < j
        i = np.arange(j)
        if ov:
            comb = ((s0[i] < s0[j]) & (e0[i] < e0[j])
                    & (s1[i] < s1[j]) & (e1[i] < e1[j]))
        else:
            comb = (e0[i] < s0[j]) & (e1[i] < s1[j])
        if mode.maxgapwidth:
            g0 = np.maximum(s0[j] - e0[i] - 1, 0)
            g1 = np.maximum(s1[j] - e1[i] - 1, 0)
            comb &= (g0 <= mode.maxgapwidth) & (g1 <= mode.maxgapwidth)
        if not comb.any():
            score[j] = w[j] - ((ig[j] + tg[j]) if gc else 0)
            continue
        ii = i[comb]
        if mode.kind == GLOBAL:
            cand = score[ii] + w[j]
            pr = ii
        else:
            if ov:
                gcost = (np.maximum(e0[ii] - s0[j] + 1, 0)
                         + np.maximum(e1[ii] - s1[j] + 1, 0))
            else:
                gcost = (s0[j] - e0[ii]) + (s1[j] - e1[ii])
            base = score[ii] - gcost
            if gc:
                cand = base + w[j] + tg[ii] - tg[j]
                pr = ii
            else:
                # local / overlaps: restart when non-positive
                cand = np.where(base > 0, base + w[j], w[j])
                pr = np.where(base > 0, ii, UNDEF)
        best = int(np.argmax(cand))   # first maximum (reference order)
        score[j] = cand[best]
        prev[j] = pr[best]
        if prev[j] == UNDEF:
            first[j] = j
        else:
            first[j] = first[prev[j]]

    return _retrieve_chains(mt, mode, n, w, ig, tg, gc, local,
                            score, prev, first)


def _retrieve_chains(mt, mode, n, w, ig, tg, gc, local, score, prev,
                     first) -> Chains:
    """Chain retrieval (findmaximalscores / retrievechainthreshold,
    chain2dim.c:1169-1363) from the computed score/prev arrays."""
    # right-maximal chains (isrightmaximallocalchain)
    rightmax = np.ones(n, bool)
    rightmax[:-1] = prev[1:] != np.arange(n - 1)

    def tgap(j):
        return int(tg[j]) if gc else 0

    def retrace(j):
        out = []
        while j != UNDEF:
            out.append(j)
            j = int(prev[j])
        return np.array(out[::-1], np.int64)

    chains: list[np.ndarray] = []
    scores: list[int] = []
    if n == 0:
        return Chains(chains, scores, mt)
    if n == 1:
        sc = int(w[0]) - ((int(ig[0]) + int(tg[0])) if gc else 0)
        return Chains([np.array([0])], [sc], mt)

    # threshold per mode
    rm = np.flatnonzero(rightmax)
    eff = score[rm] - np.array([tgap(j) for j in rm])
    if mode.kind == GLOBAL:
        # findmaximalscores GLOBALCHAINING: minscore = the score of
        # the sweep dictionary's maximum (== global max score), then
        # ALL right-maximal chains reaching it are emitted
        minscore = int(score.max())
    elif mode.kind in (GLOBALGC, GLOBALOV, LOCALMAX):
        if rm.size == 0:
            return Chains(chains, scores, mt)
        minscore = int(eff.max())
    elif mode.kind == LOCALTHRESH:
        minscore = mode.minscore
    elif mode.kind == LOCALBEST:
        if rm.size == 0:
            return Chains(chains, scores, mt)
        k = min(mode.howmanybest, rm.size)
        minscore = int(np.sort(eff)[::-1][k - 1])
    else:  # LOCALPERCENT
        if rm.size == 0:
            return Chains(chains, scores, mt)
        minscore = int(eff.max() * (1.0 - mode.percentaway / 100.0))

    # local equivalence classes: best right-maximal score per
    # chain-start class (determineequivreps)
    classbest: dict[int, int] = {}
    if local:
        for j in rm:
            f = int(first[j])
            sc = int(score[j]) - tgap(j)
            if f not in classbest or classbest[f] < sc:
                classbest[f] = sc

    taken: set[int] = set()
    for j in rm:
        sc = int(score[j]) - tgap(j)
        if sc < minscore:
            continue
        if local:
            f = int(first[j])
            if f in taken or classbest.get(f) != sc:
                continue
            taken.add(f)
        chains.append(retrace(int(j)))
        scores.append(sc)
    return Chains(chains, scores, mt)


def _diagonal_dump(sub: MatchTable, emit_rows, out) -> None:
    """The SHIPPED behavior of ``-pp chain ... thread``
    (filterinterestingbins, Vmatch/chainvm.c:365-399): matches sorted
    by diagonal descending / position2 ascending
    (comparediagonals, kurtz/matsort.c:375-407), each prefixed with a
    ``diag N`` line, followed by the bin statistics
    (bucketintobins, chainvm.c:337-363).  The gap-threading code
    behind it (threadchain.c) is dead in the reference binaries —
    filterinterestingbins intercepts every dothreading call — so the
    observable contract reproduced here is the diagonal dump."""
    diag = (sub.position2 - sub.position1).astype(np.int64)
    order = np.lexsort((sub.position2, -diag))
    s = sub.select(order)
    sdiag = diag[order]
    for i in range(len(s)):
        out.write(f"diag {int(sdiag[i])}\n")
        emit_rows(s.select(np.array([i])), out)
    out.write(f"numofmatches={len(s)}\n")
    ndiags = 1 + int(np.sum(np.diff(sdiag) != 0)) if len(s) else 0
    out.write(f"numofdiags={ndiags}\n")


def vmatch_chaining(
    mt: MatchTable,
    mode: ChainMode,
    argumentline: str,
    emit_rows,
    out,
) -> None:
    """vmatchchaining (Vmatch/chainvm.c:463-500): chain the final
    match table and emit each chain as ``# chain N: length L score S``
    followed by its member match rows (to stdout, or to
    ``<outprefix>-N.chain`` files carrying the argument-line header).

    With ``-withinborders`` and matches spanning several sequence
    pairs, matches are first grouped by (seqnum1, seqnum2)
    (groupmatchesbyseqnum, kurtz/matsort.c:316) and each group chained
    independently with its own chain counter
    (groupandcomputevmatchchains, chainvm.c:406-461).

    ``emit_rows(table, fh)`` renders match rows to the handle.
    """
    if len(mt) == 0:
        return

    def do_group(sub: MatchTable) -> None:
        if mode.dothreading:
            _diagonal_dump(sub, emit_rows, out)
            return
        res = chain_fragments(sub, mode)
        if not res.fragments:
            raise SystemExit(
                "vmatch: no chains of length > 1 with positive scores "
                "available")
        for cc, (frags, sc) in enumerate(
                zip(res.fragments, res.scores)):
            if mode.outprefix is not None:
                fname = f"{mode.outprefix}-{cc}.chain"
                fh = open(fname, "w")
                fh.write(argumentline + "\n")
            else:
                fh = out
            fh.write(f"# chain {cc}: length {frags.size} score {sc}\n")
            if not mode.silent:
                emit_rows(res.table.select(frags), fh)
            if mode.outprefix is not None:
                fh.close()

    same_pair = bool(
        (mt.seqnum1 == mt.seqnum1[0]).all()
        and (mt.seqnum2 == mt.seqnum2[0]).all()
    )
    if mode.withinborders and not same_pair:
        order = np.lexsort((mt.seqnum2, mt.seqnum1))
        grouped = mt.select(order)
        key = grouped.seqnum1 * (grouped.seqnum2.max() + 1) \
            + grouped.seqnum2
        bounds = np.flatnonzero(np.diff(key)) + 1
        for lo, hi in zip(
                np.concatenate([[0], bounds]),
                np.concatenate([bounds, [len(grouped)]])):
            do_group(grouped.select(slice(int(lo), int(hi))))
    else:
        do_group(mt)
