"""vsubseqselect-compatible CLI: select substrings of an index
(reference src/Mkvtree/vsubseqselect.c).

Options: -range i j (absolute position range), -seq len snum relpos
(substring of a given sequence), -snum n with -minlength/-maxlength
(n random substrings; the reference uses the C library PRNG).

Usage: python -m vstree_tpu_torch.cli.vsubseqselect [options] indexname
"""

from __future__ import annotations

import sys

import numpy as np

from ..index.io import read_index

WIDTH = 60


def run(argv: list[str], out=None) -> int:
    out = out or sys.stdout
    rng_range = None
    seqspec = None
    snum = minlength = maxlength = None
    index = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-range":
            rng_range = (int(argv[i + 1]), int(argv[i + 2]))
            i += 2
        elif a == "-seq":
            seqspec = (int(argv[i + 1]), int(argv[i + 2]),
                       int(argv[i + 3]))
            i += 3
        elif a == "-snum":
            i += 1
            snum = int(argv[i])
        elif a == "-minlength":
            i += 1
            minlength = int(argv[i])
        elif a == "-maxlength":
            i += 1
            maxlength = int(argv[i])
        elif not a.startswith("-"):
            index = a
        else:
            raise SystemExit(f'vsubseqselect: illegal option "{a}"')
        i += 1
    if index is None:
        raise SystemExit("vsubseqselect: the last argument must be "
                         "the index name")
    if rng_range is not None and (seqspec is not None
                                  or snum is not None):
        raise SystemExit(
            "vsubseqselect: option -range and option "
            f"-{'seq' if seqspec else 'snum'} exclude each other")
    esa = read_index(index, demand=("tis", "ois", "des"))
    ms = esa.multiseq
    if ms.originalsequence is None:
        raise SystemExit("vsubseqselect: index lacks the ois table")

    def emit(absstart: int, absend: int) -> None:
        s, _ = ms.pos_to_pair(np.array([absstart]))
        seqnum = int(s[0])
        desc = ms.description(seqnum).decode("latin-1")
        print(f">{desc} {index} [{absstart},{absend}]", file=out)
        seq = ms.originalsequence[absstart : absend + 1]
        txt = seq.tobytes().decode("latin-1")
        for k in range(0, len(txt), WIDTH):
            print(txt[k : k + WIDTH], file=out)

    if rng_range is not None:
        lo, hi = rng_range
        if not (0 <= lo <= hi < ms.totallength):
            raise SystemExit("vsubseqselect: illegal range")
        emit(lo, hi)
        return 0
    if seqspec is not None:
        length, unit, relpos = seqspec
        if unit >= ms.numofsequences:
            raise SystemExit(
                f"vsubseqselect: unit {unit} does not exist: maximal "
                f"number of units is {ms.numofsequences - 1}")
        a, b = ms.seq_bounds(unit)
        if relpos + length > b - a:
            raise SystemExit(
                "vsubseqselect: substring exceeds the sequence")
        emit(a + relpos, a + relpos + length - 1)
        return 0
    if snum is not None:
        rng = np.random.default_rng()
        lo = minlength or 1
        hi = maxlength or lo
        for _ in range(snum):
            s = int(rng.integers(0, ms.numofsequences))
            a, b = ms.seq_bounds(s)
            ln = int(rng.integers(lo, hi + 1))
            ln = min(ln, b - a)
            rp = int(rng.integers(0, max(b - a - ln, 0) + 1))
            emit(a + rp, a + rp + ln - 1)
        return 0
    raise SystemExit("vsubseqselect: one of -range/-seq/-snum "
                     "is required")


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:]))
    except BrokenPipeError:  # e.g. piped into head
        sys.exit(0)


if __name__ == "__main__":
    main()
