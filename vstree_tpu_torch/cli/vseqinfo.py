"""vseqinfo-compatible CLI: per-sequence info dump
(reference src/Mkvtree/vseqinfo.c; manual virtman.tex:1039).

Usage: python -m vstree_tpu_torch.cli.vseqinfo indexname
"""

from __future__ import annotations

import sys

from ..index.io import read_index


def run(argv: list[str], out=None) -> int:
    out = out or sys.stdout
    if len(argv) != 1:
        raise SystemExit(f"Usage: vseqinfo indexname")
    esa = read_index(argv[0], demand=("tis", "des"))
    ms = esa.multiseq
    for i in range(ms.numofsequences):
        a, b = ms.seq_bounds(i)
        desc = ms.description(i).decode("latin-1")
        print(f"{i} {b - a} {desc}", file=out)
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:]))
    except BrokenPipeError:  # e.g. piped into head
        sys.exit(0)


if __name__ == "__main__":
    main()
