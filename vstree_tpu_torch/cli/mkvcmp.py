"""mkvcmp: compare two indexes (reference Mkvtree/mkvcmp.c ->
readvirt.c:1641 ``compareVirtualtree``): per-table equality check of
the text, alphabet, suftab, lcp (+ large values), bwt, bck, sti1 and
skip tables; prints ``# comparevirtualtrees: okay`` on success, exits
nonzero naming the first differing table otherwise.
"""

from __future__ import annotations

import os
import sys

import numpy as np


_TABLES = ("tis", "ois", "suf", "lcp", "llv", "bwt", "bck", "sti1",
           "skp", "al1", "ssp")


def run(argv: list[str], out=None) -> int:
    out = out or sys.stdout
    names = [a for a in argv if not a.startswith("-")]
    if len(names) != 2:
        raise SystemExit("Usage: mkvcmp indexname1 indexname2")
    a, b = names
    compared = 0
    for suffix in _TABLES:
        fa, fb = f"{a}.{suffix}", f"{b}.{suffix}"
        ea, eb = os.path.exists(fa), os.path.exists(fb)
        if not ea and not eb:
            continue
        if ea != eb:
            raise SystemExit(
                f"mkvcmp: table .{suffix} present in only one index")
        da = np.fromfile(fa, np.uint8)
        db = np.fromfile(fb, np.uint8)
        if da.size != db.size or not np.array_equal(da, db):
            raise SystemExit(
                f"mkvcmp: comparevirtual.{suffix}tab: tables differ")
        compared += 1
    if compared == 0:
        raise SystemExit("mkvcmp: no tables found to compare")
    print("# comparevirtualtrees: okay", file=out)
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:]))
    except BrokenPipeError:
        sys.exit(0)


if __name__ == "__main__":
    main()
