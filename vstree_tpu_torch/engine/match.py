"""Match records and flags.

Struct-of-arrays analog of the reference ``StoreMatch``
(reference src/include/match.h:141-189) — batches of matches flow
through the funnel as NumPy arrays instead of per-record callbacks.

Flag bits mirror match.h:20-50; the mode char shown in output rows is
derived exactly as in echomatch.c:912-942.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Storeflag bits (reference include/match.h:20-50)
FLAGQUERY = 1 << 0            # match against separate query
FLAGPALINDROMIC = 1 << 1      # query match on reverse complement
FLAGSELFPALINDROMIC = 1 << 2  # self match vs own reverse complement
FLAGCOMPLETEMATCH = 1 << 3
FLAGXDROP = 1 << 4
FLAGSCOREMATCH = 1 << 5       # distance field holds a score (xdrop)
FLAGPPLEFTREVERSE = 1 << 6
FLAGPPRIGHTREVERSE = 1 << 7

# mode chars (reference include/match.h:51-58)
DIRECTCHAR = "D"
PALINDROMICCHAR = "P"
PPFWDFWDCHAR = "F"   # protein match: left forward, right forward
PPFWDREVCHAR = "G"   # left forward, right reverse
PPREVFWDCHAR = "H"   # left reverse, right forward
PPREVREVCHAR = "I"   # left reverse, right reverse


@dataclass
class MatchTable:
    """A batch of matches (struct-of-arrays StoreMatch)."""

    length1: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    position1: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    length2: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    position2: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # distance: >0 edit, <0 hamming (negated), 0 exact; score if FLAGSCOREMATCH
    distance: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    flag: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    seqnum1: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    relpos1: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    seqnum2: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    relpos2: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    evalue: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float64))
    idnumber: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # translation scheme number for 6-frame matches; -1 = none
    # (reference packs this into Storeflag high bits, FLAG2TRANSNUM)
    transnum: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    ARRAYS = (
        "length1", "position1", "length2", "position2", "distance",
        "flag", "seqnum1", "relpos1", "seqnum2", "relpos2", "evalue",
        "idnumber", "transnum",
    )

    def __len__(self) -> int:
        return int(self.length1.size)

    def select(self, mask_or_idx) -> "MatchTable":
        return MatchTable(
            **{a: getattr(self, a)[mask_or_idx] for a in self.ARRAYS}
        )

    @staticmethod
    def concat(tables: list["MatchTable"]) -> "MatchTable":
        tables = [t for t in tables if len(t) > 0]
        if not tables:
            return MatchTable()
        return MatchTable(**{
            a: np.concatenate([getattr(t, a) for t in tables])
            for a in MatchTable.ARRAYS
        })

    # -- derived quantities (match.h:78-140) --

    @property
    def score(self) -> np.ndarray:
        """score = L1+L2-3D for D>=0, -(L1+L2+3D) for D<0
        (EVALDISTANCE2SCORE, match.h:114-116)."""
        s = self.length1 + self.length2
        return np.where(
            self.distance >= 0,
            s - 3 * self.distance,
            -(s + 3 * self.distance),
        )

    @property
    def identity(self) -> np.ndarray:
        """identity = 100*(1-|D|/max(L1,L2)) (EVALIDENTITY,
        match.h:122-135; note the reference macro falls through so the
        D==0 case also uses the general formula — same value 100.0)."""
        longer = np.maximum(self.length1, self.length2)
        longer = np.maximum(longer, 1)
        return 100.0 * (1.0 - np.abs(self.distance) / longer)

    def mode_chars(self) -> np.ndarray:
        """Output mode char per match (echomatch.c:912-942).

        Codon (6-frame) matches use F/G/H/I; otherwise P for
        palindromic, D for direct.
        """
        out = np.full(len(self), DIRECTCHAR, dtype="U1")
        out[(self.flag & FLAGPALINDROMIC) != 0] = PALINDROMICCHAR
        # 6-frame translation matches refine to F/G/H/I
        tn = getattr(self, "transnum")
        if tn.size == 0:
            tn = np.full(len(self), -1, np.int64)
        codon = tn >= 0
        lrev = (self.flag & FLAGPPLEFTREVERSE) != 0
        rrev = (self.flag & FLAGPPRIGHTREVERSE) != 0
        out[codon & ~lrev & ~rrev] = PPFWDFWDCHAR
        out[codon & ~lrev & rrev] = PPFWDREVCHAR
        out[codon & lrev & ~rrev] = PPREVFWDCHAR
        out[codon & lrev & rrev] = PPREVREVCHAR
        return out
