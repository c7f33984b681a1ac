"""Online (-online) query substring matching.

Reference flow (procmatch.c:34-133 constructvirtualforthisquery +
applytoeachquery -> runquerymatches): for EACH query sequence a
throwaway index is built (completevirtualtree) and the roles swap —
the DATABASE text is scanned as the "query" against the per-sequence
query index (matchsubagainstvirtspeedup*, revmposorder).  The output
rows therefore appear in database-position-major order per query
sequence (direct pass first, then the palindromic pass, which scans
the reverse-complemented database so db positions emit descending),
with the usual (db side, query side) column roles restored.

Here the same structure runs on our fast builder: per query sequence,
build its ESA (index/build.py, one device program) and run the batched
matcher (engine/query.py) with the database as the scanned side, then
swap the record roles back.

Port of :mod:`vstree_tpu.engine.onlinequery`; its one departure: the
throwaway index and the extensions' sequences live on the database
index's device (``build_esa(..., device=esa.dev)``, ``Seqs(..., esa.dev)``).
"""

from __future__ import annotations

import numpy as np

from ..core.multiseq import Multiseq, reverse_complement_inplace
from ..index.build import build_esa, recommended_prefixlength
from .gextend import Seqs, edit_extend_seeds, hamming_extend_seeds
from .match import FLAGPALINDROMIC, FLAGQUERY, MatchTable
from .query import find_query_matches
from .xdrop import xdrop_extend_seeds


def _single_seq_ms(seq: np.ndarray) -> Multiseq:
    qms = Multiseq(sequence=seq.copy(),
                   markpos=np.zeros(0, np.int64))
    qms.numofsequences = 1
    qms.totallength = int(seq.size)
    return qms


def _swap_roles(mt: MatchTable, qseqnum: int, qstart: int, qlen: int,
                flags: int, db_scan: Multiseq,
                rcmode: bool) -> MatchTable:
    """Swap the (index=query-sequence, scanned=database) record roles
    back to the reference's (db side 1, query side 2) columns.  In
    rcmode the scanned db was per-sequence reverse-complemented: db
    positions map back to the forward strand; the query side is
    pre-flipped so the funnel's palindromic query-side flip
    (procfinal) restores the true coordinates."""
    m = len(mt)
    db_abs = mt.position2.astype(np.int64)
    L1 = mt.length2.astype(np.int64)
    if rcmode:
        seqn, relp = db_scan.pos_to_pair(db_abs)
        starts = db_abs - relp
        lens = np.array([db_scan.seq_length(int(x)) for x in seqn],
                        np.int64)
        relp = lens - (relp + L1)
        db_abs = starts + relp
    q_rel = mt.position1.astype(np.int64)
    L2 = mt.length1.astype(np.int64)
    if rcmode:
        # pre-flip: process_final flips palindromic query-side coords
        q_rel = qlen - (q_rel + L2)
    out = MatchTable(
        length1=L1,
        position1=db_abs,
        length2=L2,
        position2=qstart + q_rel,
        distance=mt.distance.astype(np.int64),
        flag=np.full(m, flags, np.int64),
        seqnum1=np.zeros(m, np.int64),
        relpos1=np.zeros(m, np.int64),
        seqnum2=np.full(m, qseqnum, np.int64),
        relpos2=q_rel,
        evalue=np.zeros(m, np.float64),
        idnumber=np.zeros(m, np.int64),
        transnum=np.full(m, -1, np.int64),
    )
    return out


def online_query_matches(
    esa,
    query: Multiseq,
    searchlength: int,
    mode: str,
    ev=None,
    leastlength: int = 0,
    k_e: int | None = None,
    k_h: int | None = None,
    xdrop: int | None = None,
    seedlength: int | None = None,
    direct: bool = True,
    palindromic: bool = False,
) -> MatchTable:
    """-online substring matching (per query sequence: direct pass,
    then palindromic pass)."""
    ms = esa.multiseq
    rc_scan = None
    if palindromic:
        rc_scan = Multiseq(sequence=ms.sequence.copy(),
                           markpos=ms.markpos.copy())
        rc_scan.numofsequences = ms.numofsequences
        rc_scan.totallength = ms.totallength
        rc_scan = reverse_complement_inplace(rc_scan)
    numofchars = esa.alpha.num_regular
    tables: list[MatchTable] = []
    k = k_e if k_e is not None else k_h

    def match_one(q_esa, qms, db_scan):
        if xdrop is not None or k is not None:
            sl = seedlength if k is None else max(
                seedlength or 0, leastlength // (k + 1))
            if xdrop is not None and not sl:
                sl = 30
            seeds = find_query_matches(q_esa, db_scan, sl, "mem")
            sq = Seqs(qms.sequence, db_scan.sequence, esa.dev)
            if xdrop is not None:
                return xdrop_extend_seeds(sq, seeds, xdrop, sl,
                                          querycompare=True)
            if k_e is not None:
                return edit_extend_seeds(
                    sq, ev, seeds, k, leastlength, sl,
                    querycompare=True, selfmode=False)
            return hamming_extend_seeds(
                sq, ev, seeds, k, leastlength, sl, querycompare=True)
        return find_query_matches(
            q_esa, db_scan, searchlength,
            "mumcand" if mode == "mumcand" else "mem")

    for s in range(query.numofsequences):
        a, b = query.seq_bounds(s)
        qms = _single_seq_ms(query.sequence[a:b])
        pl = recommended_prefixlength(numofchars,
                                      max(qms.totallength, 1))
        q_esa = build_esa(qms, esa.alpha, prefixlength=pl,
                          demand=("suf", "lcp", "bwt", "bck", "sti"),
                          device=esa.dev)
        if direct:
            sub = match_one(q_esa, qms, ms)
            tables.append(_swap_roles(sub, s, a, b - a, FLAGQUERY,
                                      ms, False))
        if palindromic:
            sub = match_one(q_esa, qms, rc_scan)
            tables.append(_swap_roles(
                sub, s, a, b - a, FLAGQUERY | FLAGPALINDROMIC,
                rc_scan, True))
    return MatchTable.concat(tables)
