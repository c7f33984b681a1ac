"""mkiso: build the isomorphic-depth table (.iso).

Reference Mkvtree/mkiso.c: for every lcp-interval [l..r] of depth d>0,
let psi map each rank to the rank of the suffix one text position to
the right (RANKOFNEXTLEAF, virtualdef.h:144-145).  If [psi(l), psi(r)]
spans no more ranks than [l, r] and is an EXACT interval at depth d-1
(findminprefixlength, mkiso.c:79-109: both boundary lcps < d-1), every
rank in [l..r] gets the minimal prefix length of that target interval
(capped at 255); writes happen in bottom-up completion order, so
shallower ancestors overwrite.  Unset ranks then get the leaf-unique
length of their psi successor (1 + max of the two neighbor lcps,
vnodes.c:85-115).
"""

from __future__ import annotations

import sys

import numpy as np

from ..index.io import read_index

ISOMAX = 255


def _enum_intervals(lcp: np.ndarray):
    """All lcp-intervals (depth, left, right) in bottom-up completion
    order (the vdfstrav enumeration mkiso consumes)."""
    n = int(lcp.size) - 1
    out = []
    stack = [(0, 0)]
    for i in range(1, n + 1):
        lb = i - 1
        v = int(lcp[i])
        while v < stack[-1][0]:
            d, l = stack.pop()
            out.append((d, l, i - 1))
            lb = l
        if v > stack[-1][0]:
            stack.append((v, lb))
    while stack:
        d, l = stack.pop()
        out.append((d, l, n))
    return out


def build_iso(suftab: np.ndarray, stitab: np.ndarray,
              lcp: np.ndarray) -> np.ndarray:
    n = int(suftab.size) - 1
    iso = np.zeros(n, np.uint8)
    if n == 0:
        return iso

    def psi(rank: int) -> int:
        return int(stitab[int(suftab[rank]) + 1])

    for d, l, r in _enum_intervals(lcp):
        if d <= 0:
            continue
        r1 = psi(l)
        r2 = psi(r)
        if r2 - r1 > r - l:
            continue
        off = d - 1
        if r1 == 0:
            minpref = off
        else:
            if lcp[r1] >= off:
                continue
            minpref = int(lcp[r1]) + 1
        if r2 < n:
            if lcp[r2 + 1] >= off:
                continue
            minpref = max(minpref, int(lcp[r2 + 1]) + 1)
        iso[l:r + 1] = min(minpref, ISOMAX)

    # leaf-unique lengths per rank (vnodes.c enumvleaves)
    lu = np.empty(n + 1, np.int64)
    lu[0] = 1 + lcp[1] if n >= 1 else 1
    if n >= 2:
        lu[1:n] = 1 + np.maximum(lcp[1:n], lcp[2:n + 1])
    lu[n] = 1 + lcp[n]
    lu = np.minimum(lu, ISOMAX)
    unset = np.flatnonzero(iso == 0)
    if unset.size:
        nxt = stitab[suftab[unset] + 1]
        iso[unset] = lu[nxt].astype(np.uint8)
    return iso


def run(argv: list[str]) -> int:
    if len(argv) != 1:
        raise SystemExit("Usage: mkiso <indexname>")
    indexname = argv[0]
    esa = read_index(indexname, demand=("suf", "lcp", "sti"))
    iso = build_iso(esa.suftab.astype(np.int64),
                    esa.stitab.astype(np.int64),
                    esa.lcptab.astype(np.int64))
    iso.tofile(indexname + ".iso")
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:]))
    except BrokenPipeError:
        sys.exit(0)


if __name__ == "__main__":
    main()
