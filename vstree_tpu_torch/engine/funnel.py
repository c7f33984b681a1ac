"""The match funnel: every engine emission passes through here before
output or postprocessing.

Vectorized analog of the reference ``processfinal``
(reference src/Vmatch/procfinal.c:515-636) with the exact pipeline
order from SURVEY Appendix A.4: fetch positions -> convert -> E-value
-> idnumber -> selection function -> matchokay filters -> best-k /
buffer / output.  ``matchokay`` filter semantics mirror
Vmatch/mokay.c:7-113 (least length applies to BOTH instances;
identity; leastscore with sign-dependent semantics; max E-value;
repeat gap window).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core.multiseq import Multiseq
from ..stats.evalues import Evalues, match_multiplier
from .match import (
    FLAGCOMPLETEMATCH,
    FLAGPALINDROMIC,
    FLAGQUERY,
    FLAGSELFPALINDROMIC,
    MatchTable,
)

UNDEF = None


@dataclass
class MatchParams:
    """User filter parameters (reference include/mparms.h Matchparam)."""

    leastlength: int = 0
    identity: float = 0.0            # minimal percent identity
    leastscore: int | None = None    # -leastscore (xdropleastscore)
    maxevalue: float | None = None   # -evalue
    lowergaplength: int | None = None
    uppergaplength: int | None = None


@dataclass
class SelectionHooks:
    """Selection-function plugin protocol (reference include/select.h:
    41-50) — Python callables instead of dlopen'd C symbols."""

    header: "callable | None" = None
    init: "callable | None" = None
    match: "callable | None" = None   # (mt: MatchTable) -> bool mask
    wrap: "callable | None" = None
    final_table: "callable | None" = None


def assign_evalues(
    mt: MatchTable,
    ev: Evalues,
    ms: Multiseq,
    query: Multiseq | None = None,
) -> None:
    """assignEvalue (procfinal.c:196-260), vectorized per match class."""
    m = len(mt)
    if m == 0:
        return
    mult = np.empty(m, np.float64)
    is_query = (mt.flag & FLAGQUERY) != 0
    is_complete = (mt.flag & FLAGCOMPLETEMATCH) != 0
    is_selfpal = (mt.flag & FLAGSELFPALINDROMIC) != 0
    has_iq = ms.numofquerysequences > 0
    for cls in np.unique(
        is_query.astype(int) * 4 + is_complete.astype(int) * 2
        + is_selfpal.astype(int)
    ):
        sel = (
            is_query.astype(int) * 4 + is_complete.astype(int) * 2
            + is_selfpal.astype(int)
        ) == cls
        q, c, sp = bool(cls & 4), bool(cls & 2), bool(cls & 1)
        if q and not c and not sp:
            # per-query-sequence length needed
            qms = query if query is not None else ms
            for i in np.flatnonzero(sel):
                qlen = qms.seq_length(int(mt.seqnum2[i]))
                mult[i] = match_multiplier(
                    is_query=True, is_complete=False,
                    is_selfpalindromic=False,
                    db_totallength=ms.totallength,
                    query_seq_length=qlen,
                )
        else:
            mult[sel] = match_multiplier(
                is_query=q, is_complete=c, is_selfpalindromic=sp,
                db_totallength=ms.totallength,
                query_totallength=(
                    query.totallength if query is not None
                    else ms.totalquerylength
                ),
                has_indexed_queries=has_iq,
                database_length=ms.database_length,
            )
    # lenmatch: length2 for complete or exact, else max(l1, l2)
    lenmatch = np.where(
        is_complete | (mt.distance == 0),
        mt.length2,
        np.maximum(mt.length1, mt.length2),
    )
    mt.evalue = ev.get_batch(mult, mt.distance, lenmatch)


def match_okay_mask(mt: MatchTable, mp: MatchParams) -> np.ndarray:
    """Vectorized matchokay (mokay.c:7-113)."""
    ok = np.ones(len(mt), bool)
    if mp.leastlength > 0:
        ok &= (mt.length1 >= mp.leastlength) & (mt.length2 >= mp.leastlength)
    if mp.identity > 0:
        ok &= mt.identity >= mp.identity
    if mp.leastscore is not None:
        score = mt.score
        if mp.leastscore >= 0:
            ok &= score >= mp.leastscore
        else:
            exact = mt.distance == 0
            ok &= np.where(
                exact, score >= abs(mp.leastscore), score <= mp.leastscore
            )
    if mp.maxevalue is not None:
        ok &= mt.evalue <= mp.maxevalue
    if mp.lowergaplength is not None:
        gap = mt.position2 - (mt.position1 + mt.length1)
        overlap = mt.position1 + mt.length1 > mt.position2
        gap = np.where(
            overlap, -(mt.position1 + mt.length1 - mt.position2), gap
        )
        ok &= gap >= mp.lowergaplength
        if mp.uppergaplength is not None:
            ok &= gap <= mp.uppergaplength
    return ok


def process_final(
    mt: MatchTable,
    ms: Multiseq,
    ev: Evalues,
    mp: MatchParams,
    query: Multiseq | None = None,
    selection: SelectionHooks | None = None,
    id_start: int = 0,
) -> MatchTable:
    """Run the funnel over a match batch; returns the surviving
    matches with E-values and id numbers assigned."""
    if len(mt) == 0:
        return mt
    # fetchpositions (procfinal.c:101-151): seqnum/relpos re-derived
    # from the (possibly extension-shifted) absolute positions; the
    # query side is engine-authoritative (relpos2 tracks the query)
    mt.seqnum1, mt.relpos1 = ms.pos_to_pair(mt.position1)
    notq = (mt.flag & FLAGQUERY) == 0
    if notq.any():
        s2, r2 = ms.pos_to_pair(mt.position2[notq])
        mt.seqnum2 = mt.seqnum2.copy()
        mt.relpos2 = mt.relpos2.copy()
        mt.seqnum2[notq] = s2
        mt.relpos2[notq] = r2
        if ms.numofquerysequences > 0:
            # convertthematch (procfinal.c:462-476): self matches on
            # an index with indexed queries report instance 2 in
            # query-local numbering
            mt.position2 = mt.position2.copy()
            mt.seqnum2[notq] -= ms.num_db_sequences
            mt.position2[notq] -= ms.database_length + 1
    # fetchpositions: palindromic query matches report coordinates in
    # the original (non-RC) orientation (procfinal.c:152-158)
    pal = ((mt.flag & FLAGPALINDROMIC) != 0) & ((mt.flag & FLAGQUERY) != 0)
    if pal.any() and query is not None:
        idx = np.flatnonzero(pal)
        for i in idx:
            a, b = query.seq_bounds(int(mt.seqnum2[i]))
            seqlen = b - a
            mt.relpos2[i] = seqlen - (mt.relpos2[i] + mt.length2[i])
            mt.position2[i] = a + mt.relpos2[i]
    assign_evalues(mt, ev, ms, query)
    if selection is not None and selection.match is not None:
        keep = np.asarray(selection.match(mt), bool)
        mt = mt.select(keep)
    ok = match_okay_mask(mt, mp)
    mt = mt.select(ok)
    mt.idnumber = id_start + np.arange(len(mt), dtype=np.int64)
    return mt
