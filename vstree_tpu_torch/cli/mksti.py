"""mksti: build the full inverse suffix array table (.sti).

Reference Mkvtree/mksti.c:15-34: stitab[suftab[i]] = i over all n+1
ranks, written as Uint words — the experimental full-width companion
of the 1-byte sti1 table, feeding the query speedup experiments.
"""

from __future__ import annotations

import sys

import numpy as np

from ..index.io import read_index

_U64 = np.dtype("<u8")


def run(argv: list[str]) -> int:
    if len(argv) != 1:
        raise SystemExit("Usage: mksti <indexname>")
    indexname = argv[0]
    esa = read_index(indexname, demand=("suf",))
    sti = np.zeros(esa.suftab.size, np.int64)
    sti[esa.suftab] = np.arange(esa.suftab.size, dtype=np.int64)
    sti.astype(_U64).tofile(indexname + ".sti")
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:]))
    except BrokenPipeError:
        sys.exit(0)


if __name__ == "__main__":
    main()
