"""Shared option-constraint combinators (reference
kurtz-basic/procopt.c:505-583 ``checkexclude`` + the OPTIONIMPLY
pattern from include/optdesc.h).

The reference declares pairwise option constraints ONCE per program in
a flat table and validates them after parsing; the per-CLI hand-rolled
checks here repeatedly regrew the same silent-option bug class (the
``-cpl`` mishandling fixed in round 4, the ``remred`` gaps fixed in
round 5).  This module is the declarative replacement: each CLI builds
a :class:`Constraints` table next to its option list and calls
:meth:`check` once after parsing.

Messages byte-match the reference:
  ``option -a and option -b exclude each other``   (procopt.c:546)
  ``option -a requires option -b``                 (the OPTIONIMPLY
                                                    convention used
                                                    across parsevm.c)
"""

from __future__ import annotations


class Constraints:
    """Declarative EXCLUDE / IMPLY table for one CLI."""

    def __init__(self, prog: str):
        self.prog = prog
        self._excludes: list[tuple[str, str]] = []
        self._implies: list[tuple[str, str, str | None]] = []

    def exclude(self, a: str, b: str) -> "Constraints":
        """Options ``a`` and ``b`` must not both be set
        (checkexclude, procopt.c:531-554: symmetric)."""
        self._excludes.append((a, b))
        return self

    def exclude_group(self, *names: str) -> "Constraints":
        """Every pair in ``names`` excludes each other (one exclude
        sub-table row, procopt.c:515-522)."""
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                self._excludes.append((a, b))
        return self

    def imply(self, a: str, b: str,
              argument: str | None = None) -> "Constraints":
        """Option ``a`` requires option ``b``; with ``argument`` the
        message names an option ARGUMENT instead (parsevm.c:1435)."""
        self._implies.append((a, b, argument))
        return self

    def check(self, isset) -> None:
        """Validate after parsing.  ``isset`` maps an option name
        (without dash) to truthiness — pass the parsed-options dict
        or a callable."""
        get = isset if callable(isset) else \
            (lambda k: bool(isset.get(k)))
        for a, b in self._excludes:
            if get(a) and get(b):
                raise SystemExit(
                    f"{self.prog}: option -{a} and option -{b} "
                    "exclude each other")
        for a, b, argument in self._implies:
            if get(a) and not get(b):
                if argument is not None:
                    raise SystemExit(
                        f'{self.prog}: argument "{argument}" of '
                        f"option -{a} requires option -{b}")
                raise SystemExit(
                    f"{self.prog}: option -{a} requires option -{b}")
