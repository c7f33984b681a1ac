"""q-gram hit production and on-the-fly chaining (reference
kurtz/produceqhits.c:133-267 and kurtz/onflychain.c:569-703,
driver kurtz/libtest/chainqhits.c, test bin/Checkflychain.sh).

Hit production vectorizes over all query positions (batched binary
searches over the packed index); the chaining recurrence streams a
live window of fragments — candidate scoring inside the window is
vectorized, the window advance is the reference's retire-queue."""

from __future__ import annotations

import numpy as np

from ..core.chardef import WILDCARD
from ..engine.query import _compare_batch
from ..index.build import bucket_codes
from ..index.esa import ESA


def produce_qhits(esa: ESA, qseq: np.ndarray, fixedmatchlength: int,
                  onlyqhits: bool):
    """(length, ipos, jpos) streams in reference emission order:
    query positions ascending, ranks ascending (produceqhits).

    onlyqhits: all db positions matching the query q-gram of exactly
    ``fixedmatchlength`` (bucket refined by mmsearch).  Otherwise
    ("least" mode): all left-maximal prefixlength seeds extended
    right-maximally, kept when total length >= fixedmatchlength."""
    text = esa.text
    n = esa.totallength
    suftab = esa.suftab.astype(np.int64)
    pl = esa.prefixlength
    L = fixedmatchlength
    numofchars = esa.alpha.num_regular
    qlen = int(qseq.size)
    if qlen < L:
        return (np.zeros(0, np.int64),) * 3

    jpos = np.arange(qlen - L + 1, dtype=np.int64)
    qcodes, qvalid = bucket_codes(qseq, numofchars, pl)
    valid = qvalid[jpos] == pl
    codes = np.where(valid, qcodes[jpos], 0)
    bl = esa.bcktab[2 * codes].astype(np.int64)
    br = esa.bcktab[2 * codes + 1].astype(np.int64)
    keep = valid & (br > bl)
    ji = np.flatnonzero(keep)
    if ji.size == 0:
        return (np.zeros(0, np.int64),) * 3

    if onlyqhits:
        # refine [bl, br) to the subinterval matching the q-gram to
        # depth L: two batched binary searches with the exact
        # suffix-vs-window compare
        qw = np.full(ji.size, L, np.int64)

        def bound(side):
            lo = bl[ji].copy()
            hi = br[ji].copy()
            while True:
                open_ = lo < hi
                if not open_.any():
                    break
                ia = np.flatnonzero(open_)
                mid = (lo[ia] + hi[ia]) // 2
                rel, _ = _compare_batch(
                    text, n, suftab[mid], qseq, jpos[ji[ia]],
                    qw[ia], np.full(ia.size, pl, np.int64))
                # rel = sign(query - suffix) limited to L chars:
                # suffix < window  <=>  rel > 0
                if side == "lo":
                    lt = rel > 0
                else:
                    lt = rel >= 0
                lo[ia[lt]] = mid[lt] + 1
                hi[ia[~lt]] = mid[~lt]
            return lo

        lo = bound("lo")
        hi = bound("hi")
        w = np.maximum(hi - lo, 0)
        g = np.repeat(np.arange(ji.size), w)
        starts = np.concatenate([[0], np.cumsum(w)[:-1]])
        ranks = lo[g] + (np.arange(int(w.sum())) - starts[g])
        ipos = suftab[ranks]
        out_j = jpos[ji][g]
        return (np.full(ipos.size, L, np.int64), ipos, out_j)

    # least mode: every rank of the prefixlength bucket, left-maximal
    # filter, right-maximal extension
    w = br[ji] - bl[ji]
    g = np.repeat(np.arange(ji.size), w)
    starts = np.concatenate([[0], np.cumsum(w)[:-1]])
    ranks = bl[ji][g] + (np.arange(int(w.sum())) - starts[g])
    ipos = suftab[ranks]
    jp = jpos[ji][g]
    leftc_db = text[np.maximum(ipos - 1, 0)].astype(np.int64)
    leftc_q = qseq[np.maximum(jp - 1, 0)].astype(np.int64)
    leftmax = (
        (ipos == 0) | (jp == 0)
        | (leftc_db >= WILDCARD) | (leftc_q >= WILDCARD)
        | (leftc_db != leftc_q))
    ipos = ipos[leftmax]
    jp = jp[leftmax]
    # extendtorightmaximalmatch: plain match scan from depth pl;
    # reference bounds at dblen-1 / querylen-1 (the final char is
    # never compared — faithfully reproduced via the -1 ends)
    ext = _extend_right(text, n - 1, ipos + pl, qseq, qlen - 1,
                        jp + pl)
    total = ext + pl
    ok = total >= L
    return (total[ok], ipos[ok], jp[ok])


def _extend_right(text, tend, a, qseq, qend, b):
    """Match-run length while chars equal, regular, and both indexes
    < their (exclusive-end - is the reference's endseq pointer)."""
    m = a.size
    out = np.zeros(m, np.int64)
    act = np.arange(m)
    off = 0
    cap = 64
    offs = np.arange(cap)
    while act.size:
        ia = a[act][:, None] + off + offs[None, :]
        ib = b[act][:, None] + off + offs[None, :]
        va = ia < tend
        vb = ib < qend
        ca = text[np.minimum(ia, text.size - 1)]
        cb = qseq[np.minimum(ib, qseq.size - 1)]
        match = va & vb & (ca == cb) & (ca < WILDCARD)
        run = np.cumprod(match, axis=1).sum(axis=1)
        out[act] += run
        act = act[run == cap]
        off += cap
    return out


class OnflyChainer:
    """processnewquhit / wrapmaintainedfragments
    (onflychain.c:569-703): streaming chain construction over a live
    window of fragments.  Gap cost is the clipped Chebyshev distance
    (onflychain.c:50-71); fragments whose J-distance exceeds
    maxdistance retire, and whenever the window drains completely the
    retired block's best chains are reported (newest-retired first,
    one line per chain whose first fragment records this end as its
    best, outputallstackedelements onflychain.c:539-567)."""

    def __init__(self, maxdistance: int, chainqhits: bool, out):
        self.maxd = int(maxdistance)
        self.chainqhits = chainqhits
        self.out = out
        # per-fragment columns (indexed by creation identity)
        self.I: list[int] = []
        self.J: list[int] = []
        self.Ln: list[int] = []
        self.score: list[int] = []
        self.prev: list[int] = []        # -1 = none
        self.first: list[int] = []
        self.bestend: list[int] = []     # chain-first's best end, -1
        self.chainlen: list[int] = []
        self.live: list[int] = []        # identities, FIFO by J
        self.ready: list[int] = []

    def _gapcost(self, li, lj, ll, ri, rj):
        a = np.maximum(ri - (li + ll), 0)
        b = np.maximum(rj - (lj + ll), 0)
        return np.maximum(a, b)

    def add(self, length: int, ipos: int, jpos: int) -> None:
        k = len(self.I)
        self.I.append(ipos)
        self.J.append(jpos)
        self.Ln.append(length)
        self.score.append(length)
        self.prev.append(-1)
        self.first.append(k)
        self.bestend.append(-1)
        self.chainlen.append(1)
        # retire queue heads out of J-range
        while self.live:
            h = self.live[0]
            if self.J[h] + self.Ln[h] + self.maxd + 1 >= jpos:
                break
            self.ready.append(self.live.pop(0))
            if not self.live:
                self._flush()
        if self.live:
            lv = np.array(self.live)
            li = np.array([self.I[x] for x in lv])
            lj = np.array([self.J[x] for x in lv])
            ll = np.array([self.Ln[x] for x in lv])
            ls = np.array([self.score[x] for x in lv])
            gap = self._gapcost(li, lj, ll, ipos, jpos)
            comp = (gap <= self.maxd) & (li + ll <= ipos) \
                & (lj + ll <= jpos)
            if self.chainqhits:
                comp |= (gap <= self.maxd) \
                    & ((lj - li) == (jpos - ipos)) & (li < ipos)
            cand_score = ls - gap
            valid = comp & (cand_score > 0)
            if valid.any():
                total = np.where(valid, cand_score + length,
                                 np.iinfo(np.int64).min)
                # tree-walk tie order: diagonal asc, then J asc;
                # maintainbestleft keeps the first strict maximum
                order = np.lexsort((lj, lj - li))
                pick = order[int(np.argmax(total[order]))]
                best = int(lv[pick])
                bscore = int(total[pick])
                self.chainlen[k] = self.chainlen[best] + 1
                self.first[k] = self.first[best]
                f = self.first[k]
                be = self.bestend[f]
                if be < 0 or self.score[be] < bscore or (
                        self.score[be] == bscore
                        and self.chainlen[be] < self.chainlen[best]):
                    self.bestend[f] = k
                self.prev[k] = best
                self.score[k] = bscore
        self.live.append(k)

    def _flush(self) -> None:
        for k in reversed(self.ready):
            if self.bestend[self.first[k]] == k:
                self._emit(k)
        self.ready.clear()

    def _emit(self, k: int) -> None:
        chain = []
        p = k
        while p >= 0:
            chain.append(p)
            p = self.prev[p]
        chain.reverse()
        body = "".join(
            f"[{self.I[p]},{self.J[p]}]" if self.chainqhits else
            f"[[{self.I[p]}..{self.I[p] + self.Ln[p] - 1}],"
            f"[{self.J[p]}..{self.J[p] + self.Ln[p] - 1}]]"
            for p in chain)
        self.out.write(
            f"chain {self.first[k]}->{k}: score={self.score[k]},"
            f"length={self.chainlen[k]}: {body}\n")

    def wrap(self) -> None:
        while self.live:
            self.ready.append(self.live.pop(0))
        self._flush()
