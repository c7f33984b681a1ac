"""E-value statistics for match significance.

Reimplements the reference's Hamming-model E-values
(reference src/kurtz/evalues.c; Kurtz et al., ISMB 2000):

- ``prob(l, k)``: expected-count term for a length-``l`` match with
  ``k`` mismatches; built row-by-row with the identical recurrence
  (``evalues.c:181-256``) so floating-point results agree bit-for-bit,
- edit-distance E-values are the Hamming value scaled by
  ``averagequot[d]`` for d <= 20 and ``1.31e7 * 2^(d-20)`` above
  (``evalues.c:270-305``),
- ``probmatch = 1/(mapsize-1)`` (reference Vmatch/procmatch.c:545),
- multipliers per match class mirror ``assignEvalue``
  (Vmatch/procfinal.c:196-260).

The table is tiny (a few thousand doubles); kept on host.  Batched
lookups are vectorized with NumPy for the match funnel.
"""

from __future__ import annotations

import numpy as np

SMALLESTEVALUE = 1.0e-300
MAXEXPONENTOF2 = 100

# averagequot[k] for k = 0..20 (evalues.c:62-85)
AVERAGEQUOT = np.array([
    0.0,
    3.97e+00, 1.28e+01, 3.26e+01, 7.60e+01, 1.71e+02,
    3.77e+02, 8.22e+02, 1.78e+03, 3.91e+03, 8.50e+03,
    1.76e+04, 3.78e+04, 7.98e+04, 1.66e+05, 3.58e+05,
    7.44e+05, 1.52e+06, 3.20e+06, 6.40e+06, 1.31e+07,
])


class Evalues:
    """Incrementally grown Hamming E-value table
    (inithammingEvalues / incprecomputehammingEvalues)."""

    def __init__(self, probmatch: float):
        self.probmatch = probmatch
        # `first` = starting prob of the next row k
        self.first = probmatch * (1.0 - probmatch) * (1.0 - probmatch)
        self.linestart: list[int] = []   # linestart[k] + l indexes table
        self.table: list[float] = []

    def _grow(self, kmax: int) -> None:
        """incprecomputehammingEvalues (evalues.c:313-365): extend rows
        up to ``kmax`` with the reference's exact recurrence."""
        p = self.probmatch
        for k in range(len(self.linestart), kmax + 1):
            self.linestart.append(len(self.table) - (k + 1))
            prob = self.first
            self.first *= ((k + 2) / (k + 1)) * (1.0 - p)
            l = k + 1
            while prob > SMALLESTEVALUE:
                self.table.append(prob)
                prob *= ((l + 1) * p / (l + 1 - k))
                l += 1
        # sentinel for the row-end bound used by lookup
        self._end_sentinel = len(self.table)

    def _lookup(self, k: int, length: int) -> float:
        """inclookupEvalue: table[(k, length)] or 0.0 past the row."""
        if k + 1 > len(self.linestart):
            self._grow(k)
        i = self.linestart[k] + length
        if k + 1 < len(self.linestart):
            row_end = self.linestart[k + 1] + k + 2
        else:
            row_end = len(self.table)
        if self.linestart[k] + k + 1 <= i < row_end:
            return self.table[i]
        return 0.0

    def get(self, multiplier: float, distance: int, length: int) -> float:
        """incgetEvalue (evalues.c:372-421).  ``distance`` < 0 means
        Hamming (stored negative), >= 0 edit distance."""
        if distance <= 0:
            return multiplier * self._lookup(-distance, length)
        if distance > 20:
            if distance - 20 > MAXEXPONENTOF2:
                return 0.0
            hequot = 1.31e+07 * (2.0 ** (distance - 20))
        else:
            hequot = AVERAGEQUOT[distance]
        return multiplier * hequot * self._lookup(distance, length)

    def get_batch(
        self, multiplier: np.ndarray, distance: np.ndarray, length: np.ndarray
    ) -> np.ndarray:
        """Vectorized E-values for match arrays (same math as get())."""
        distance = np.asarray(distance, np.int64)
        length = np.asarray(length, np.int64)
        if distance.size == 0:
            return np.zeros(0, np.float64)
        k = np.abs(distance)
        kmax = int(np.minimum(k, 20 + MAXEXPONENTOF2).max())
        if kmax + 1 > len(self.linestart):
            self._grow(kmax)
        ls = np.asarray(self.linestart, np.int64)
        tab = np.asarray(self.table, np.float64)
        kc = np.minimum(k, len(ls) - 1)
        i = ls[kc] + length
        row_start = ls[kc] + kc + 1
        has_next = kc + 1 < len(ls)
        row_end = np.where(
            has_next, ls[np.minimum(kc + 1, len(ls) - 1)] + kc + 2,
            len(tab),
        )
        inrow = (i >= row_start) & (i < row_end)
        val = np.where(
            inrow, tab[np.clip(i, 0, max(len(tab) - 1, 0))], 0.0
        )
        # edit-distance scaling (evalues.c:270-305)
        d = distance
        hequot = np.ones(d.size, np.float64)
        small = (d > 0) & (d <= 20)
        hequot[small] = AVERAGEQUOT[d[small]]
        big = (d > 20) & (d - 20 <= MAXEXPONENTOF2)
        hequot[big] = 1.31e+07 * np.exp2((d[big] - 20).astype(np.float64))
        toobig = d - 20 > MAXEXPONENTOF2
        out = np.asarray(multiplier, np.float64) * hequot * val
        out[toobig] = 0.0
        return out


def match_multiplier(
    *,
    is_query: bool,
    is_complete: bool,
    is_selfpalindromic: bool,
    db_totallength: int,
    query_seq_length: int = 0,
    query_totallength: int = 0,
    has_indexed_queries: bool = False,
    database_length: int = 0,
) -> float:
    """assignEvalue multiplier selection (procfinal.c:196-246)."""
    if is_query:
        if is_complete:
            return float(db_totallength)
        if is_selfpalindromic:
            return 0.5 * float(db_totallength) * float(query_totallength)
        return float(db_totallength) * float(query_seq_length)
    if has_indexed_queries:
        return float(database_length) * float(query_totallength)
    return 0.5 * float(db_totallength) * float(db_totallength)
