"""Match sorting, best-k selection and containment removal.

Reference: src/kurtz/matsort.c (12 sort modes), src/kurtz/bestmatch.c
(best list ordering), src/kurtz/smcontain.c (removecontained).
"""

from __future__ import annotations

import numpy as np

from ..engine.match import MatchTable

SORTMODES = (
    "la", "ld", "ia", "id", "ja", "jd", "ea", "ed", "sa", "sd",
    "ida", "idd",
)


def sort_matches(mt: MatchTable, mode: str) -> MatchTable:
    """sortallmatches (matsort.c:246-263).  Score and identity sorts
    compare absolute values (matsort.c:86-158)."""
    if mode in ("la", "ld"):
        key = mt.length1
    elif mode in ("ia", "id"):
        key = mt.position1
    elif mode in ("ja", "jd"):
        key = mt.position2
    elif mode in ("ea", "ed"):
        key = mt.evalue
    elif mode in ("sa", "sd"):
        key = np.abs(mt.score)
    elif mode in ("ida", "idd"):
        key = np.abs(mt.identity)
    else:
        raise ValueError(f"illegal sort mode {mode!r}")
    order = np.argsort(key, kind="stable")
    if mode.endswith("d"):
        # stable descending: reverse of the stable ascending order of
        # the negated... simplest faithful: argsort of -key
        order = np.argsort(-key.astype(np.float64), kind="stable")
    return mt.select(order)


def remove_contained(mt: MatchTable) -> tuple[MatchTable, int]:
    """removecontained (smcontain.c:41-96): sort by (pos1, len1,
    pos2); drop matches contained in another (both coordinate ranges
    nested); survivors stay in the sorted order."""
    n = len(mt)
    if n == 0:
        return mt, 0
    order = np.lexsort((mt.position2, mt.length1, mt.position1))
    s = mt.select(order)
    p1 = s.position1
    l1 = s.length1
    p2 = s.position2
    l2 = s.length2
    reject = np.zeros(n, bool)
    for i in range(n):
        if True:
            # backward over equal pos1
            j = i - 1
            while j >= 0 and p1[j] == p1[i]:
                if not reject[i] and _contains(p1, l1, p2, l2, i, j):
                    reject[j] = True
                j -= 1
            # forward while pos1 within [p1[i], p1[i]+l1[i]]
            j = i + 1
            while j < n and p1[j] <= p1[i] + l1[i]:
                if not reject[i] and _contains(p1, l1, p2, l2, i, j):
                    reject[j] = True
                j += 1
    kept = s.select(~reject)
    return kept, int(reject.sum())


def _contains(p1, l1, p2, l2, a, b) -> bool:
    """CONTAINSSTOREMATCH(a contains b)."""
    return (p1[a] <= p1[b] and p1[b] + l1[b] <= p1[a] + l1[a]
            and p2[a] <= p2[b] and p2[b] + l2[b] <= p2[a] + l2[a])
