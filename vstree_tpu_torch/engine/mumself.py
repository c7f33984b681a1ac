"""Maximal unique matches, self variant (index built over db + query
files, ``vmatch -mum -l N idx`` with no ``-q``).

Reference algorithm (src/Vmengine/fmumself.c:10-66
``findmaximaluniquematches``): one linear scan of the lcp table —
ranks j with an lcp *peak* (lcp[j] >= searchlength, lcp[j-1] < lcp[j],
lcp[j+1] < lcp[j]) name a unique pair of adjacent suffixes
(suftab[j-1], suftab[j]); the pair is emitted iff one side lies in the
database region and the other in the indexed-query region
(fmumself.c:48) and it is left-maximal: one start is 0, a bwt char is
special, or the two bwt chars differ (fmumself.c:50-53).

Copy of :mod:`vstree_tpu.engine.mumself` (host NumPy).

Design: the peak predicate, the db/query straddle test, and
left-maximality are all elementwise over rank arrays — the whole
enumeration is a handful of vectorized comparisons, no traversal.
"""

from __future__ import annotations

import numpy as np

from ..core.chardef import is_special
from ..index.esa import ESA
from .match import MatchTable


def find_mum_self(esa: ESA, searchlength: int) -> MatchTable:
    """All maximal unique matches between the database region and the
    indexed-query region of ``esa``, in suffix-rank order (the
    reference's emission order)."""
    ms = esa.multiseq
    if ms.numofquerysequences == 0:
        raise ValueError(
            "maximal unique matches search requires at least one "
            "query file"
        )
    n = ms.totallength
    if n < 2:
        raise ValueError(
            "search for maximal unique matches requires at least a "
            "table of length 2"
        )
    qsep = ms.database_length  # getqueryseppos: separator position
    lcp = esa.lcptab.astype(np.int64)
    suf = esa.suftab.astype(np.int64)
    bwt = esa.bwttab

    # peak ranks j in [1, n-1): reference loop i in [2, n) with
    # secondlcp = lcp[i-1]  (fmumself.c:33-38)
    j = np.arange(1, n - 1, dtype=np.int64)
    sec = lcp[j]
    peak = (
        (sec >= max(searchlength, 1))
        & (lcp[j - 1] < sec)
        & (lcp[j + 1] < sec)
    )
    j = j[peak]
    if j.size == 0:
        return MatchTable()
    s_prev = suf[j - 1]
    s_here = suf[j]
    start1 = np.minimum(s_prev, s_here)
    start2 = np.maximum(s_prev, s_here)
    # one instance in the database, the other in the query region
    # (fmumself.c:48)
    straddle = (start1 < qsep) & (start2 > qsep)
    # left-maximality (fmumself.c:50-53)
    a = bwt[j]
    b = bwt[j - 1]
    leftmax = (
        (start1 == 0) | is_special(a) | is_special(b) | (a != b)
    )
    keep = straddle & leftmax
    j, start1, start2 = j[keep], start1[keep], start2[keep]
    if j.size == 0:
        return MatchTable()
    d = lcp[j]
    tot = j.size
    seq1, rel1 = ms.pos_to_pair(start1)
    seq2, rel2 = ms.pos_to_pair(start2)
    return MatchTable(
        length1=d,
        position1=start1,
        length2=d.copy(),
        position2=start2,
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
