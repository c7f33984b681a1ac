"""vendian: byte-swap a binary table file (reference
Mkvtree/endian.c, driven by bin/vmigrate.sh for index migration).

Usage: vendian bytes filename — streams the file to stdout with each
``bytes``-sized item (2 or 4; 8 added for the 64-bit index tables)
byte-swapped; a trailing partial item is dropped, exactly like the
reference's fread loop.
"""

from __future__ import annotations

import sys


def run(argv: list[str], out=None) -> int:
    out = out if out is not None else sys.stdout.buffer
    if len(argv) != 2:
        raise SystemExit("Usage: vendian bytes filename")
    try:
        nbytes = int(argv[0])
    except ValueError:
        raise SystemExit(f'invalid argument "{argv[0]}"')
    if nbytes < 0:
        raise SystemExit(f'invalid argument "{argv[0]}"')
    if nbytes not in (2, 4, 8):
        raise SystemExit(
            f'vendian: first argument "{argv[0]}" must be 2 or 4')
    try:
        with open(argv[1], "rb") as fh:
            data = fh.read()
    except OSError:
        raise SystemExit(f'Cannot open file "{argv[1]}"')
    usable = len(data) - (len(data) % nbytes)
    chunk = data[:usable]
    swapped = bytearray(usable)
    for k in range(nbytes):
        swapped[k::nbytes] = chunk[nbytes - 1 - k::nbytes]
    out.write(bytes(swapped))
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:]))
    except BrokenPipeError:
        sys.exit(0)


if __name__ == "__main__":
    main()
