"""vseqselect-compatible CLI: select indexed sequences and print them
as FASTA (reference src/Mkvtree/vseqselect.c).

Options: -minlength n / -maxlength n (length window),
-seqnum file (sequence numbers listed in a file, output in file
order), -randomnum n / -randomlength n (random selection; the
reference uses the C library PRNG, so random picks are reproducible
only within one implementation).

Usage: python -m vstree_tpu_torch.cli.vseqselect [options] indexname
"""

from __future__ import annotations

import sys

import numpy as np

from ..index.io import read_index

WIDTH = 60


def fasta_out(ms, seqnum: int, out) -> None:
    a, b = ms.seq_bounds(seqnum)
    desc = ms.description(seqnum).decode("latin-1")
    print(f">{desc}", file=out)
    if ms.originalsequence is None:
        raise SystemExit("vseqselect: index lacks the ois table")
    seq = ms.originalsequence[a:b].tobytes().decode("latin-1")
    for i in range(0, len(seq), WIDTH):
        print(seq[i : i + WIDTH], file=out)


def run(argv: list[str], out=None) -> int:
    out = out or sys.stdout
    minlength = maxlength = randomnum = randomlength = None
    seqnumfile = None
    index = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-minlength":
            i += 1
            minlength = int(argv[i])
        elif a == "-maxlength":
            i += 1
            maxlength = int(argv[i])
        elif a == "-randomnum":
            i += 1
            randomnum = int(argv[i])
        elif a == "-randomlength":
            i += 1
            randomlength = int(argv[i])
        elif a == "-seqnum":
            i += 1
            seqnumfile = argv[i]
        elif not a.startswith("-"):
            index = a
        else:
            raise SystemExit(f'vseqselect: illegal option "{a}"')
        i += 1
    if index is None:
        raise SystemExit("vseqselect: the last argument must be the "
                         "index name")
    esa = read_index(index, demand=("tis", "ois", "des"))
    ms = esa.multiseq
    m = ms.numofsequences

    def seqlen(s):
        a, b = ms.seq_bounds(s)
        return b - a

    if seqnumfile is not None:
        nums = [int(tok) for tok in open(seqnumfile).read().split()]
        for s in nums:
            if s >= m:
                raise SystemExit(
                    f"vseqselect: unit {s} does not exist: maximal "
                    f"number of units is {m - 1}")
            fasta_out(ms, s, out)
        return 0

    candidates = [
        s for s in range(m)
        if (minlength is None or seqlen(s) >= minlength)
        and (maxlength is None or seqlen(s) <= maxlength)
    ]
    if randomnum is not None or randomlength is not None:
        rng = np.random.default_rng()
        rng.shuffle(candidates)
        if randomnum is not None:
            candidates = candidates[:randomnum]
        else:
            total = 0
            picked = []
            for s in candidates:
                picked.append(s)
                total += seqlen(s)
                if total >= randomlength:
                    break
            candidates = picked
    for s in candidates:
        fasta_out(ms, s, out)
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:]))
    except BrokenPipeError:  # e.g. piped into head
        sys.exit(0)


if __name__ == "__main__":
    main()
