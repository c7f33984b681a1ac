"""mklsf: build the suffix-link-frame table (.lsf).

Reference Mkvtree/mklsf.c: a BFS over the lcp-interval tree assigns
every interval's HOME rank (DELIVERHOME, virtualdef.h:309-326: the
boundary with the deeper neighboring lcp) a starting bracket for the
suffix-link walk (drop the first character), stored as two bytes
relative to the target's bucket left border.

Release-parity note: the interval refinement (mmsearch) in
setdrop1tab is compiled ONLY under -DDEBUG (mklsf.c:126-149), so the
shipped binary propagates the untouched root bracket (0, n) to every
interval; the table's bytes therefore reduce to (uint0 - bucketleft,
uint1 - uint0) of that bracket — (0, 255-saturated n) for every home
outside the bucket depth, 255/255 elsewhere.  This module reproduces
those bytes exactly (and inherits the reference's semantics of lsf as
a STARTING bracket, refined at query time by qspeedup 4).
"""

from __future__ import annotations

import sys

import numpy as np

from ..index.io import read_index
from .mkiso import _enum_intervals

LARGE = 255


def build_lsf(esa) -> np.ndarray:
    n = int(esa.suftab.size) - 1
    lcp = esa.lcptab.astype(np.int64)
    pl = esa.prefixlength
    out = np.full(2 * (n + 1), LARGE, np.uint8)
    if n == 0:
        return out
    defined = np.zeros(n + 1, bool)
    inside = np.zeros(n + 1, bool)
    for d, l, r in _enum_intervals(lcp):
        if d <= 0:
            continue
        if l > 0:
            home = l if lcp[l] >= lcp[r + 1] else r
        else:
            home = r
        defined[home] = True
        if d <= pl:
            inside[home] = True

    # the propagated bracket is (0, n) for every defined home
    # (transformdrop1tab, mklsf.c:165-235): bucket code of the rank-0
    # suffix, whose bucket left border must be 0
    first = esa.suftab[0]
    sigma = esa.alpha.num_regular
    window = esa.text[first:first + pl]
    if window.size < pl or (window >= sigma).any():
        raise SystemExit(
            "mklsf: qgram2code undefined for the rank-0 suffix")
    code = 0
    for c in window:
        code = code * sigma + int(c)
    bck = esa.bcktab if esa.bcktab is not None else esa.aux_bck(pl)
    leftbound = int(bck[2 * code])
    if leftbound != 0:
        raise SystemExit(f"mklsf: leftbound={leftbound} > 0 "
                         "not expected")
    sel = defined & ~inside
    out[0::2][sel] = 0
    out[1::2][sel] = min(n, LARGE)
    return out


def run(argv: list[str]) -> int:
    if len(argv) != 1:
        raise SystemExit("Usage: mklsf <indexname>")
    indexname = argv[0]
    esa = read_index(indexname, demand=("suf", "lcp", "bck", "tis"))
    build_lsf(esa).tofile(indexname + ".lsf")
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:]))
    except BrokenPipeError:
        sys.exit(0)


if __name__ == "__main__":
    main()
