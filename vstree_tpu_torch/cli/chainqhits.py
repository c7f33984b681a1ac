"""chainqhits on the port: q-gram hit production + on-the-fly chaining
driver (reference kurtz/libtest/chainqhits.c, tested by
kurtz/libtest/Checkflychain.sh).

Usage: chainqhits <fixedmatchlength> <edistvalue> <indexname>
       <queryfile> [checkqhit|nocheckqhit|checkleast|nocheckleast]

The nocheck* modes stream maximal chains to stdout ("chain a->b: ..."
lines, byte-compatible with the reference DEBUG build); the check*
modes verify the on-the-fly result against a brute-force chaining.

A copy of :mod:`vstree_tpu.cli.chainqhits` but for the device: ``run``
takes the device the index is read onto (the hits and the chaining are
host work), and the entry point asks for the CUDA card."""

from __future__ import annotations

import sys

import numpy as np

from ..core.multiseq import read_multiseq
from ..device import cuda_device
from ..index.esa import ESA
from ..postprocess.onflychain import OnflyChainer, produce_qhits

ARGLIST = "[checkqhit|nocheckqhit|checkleast|nocheckleast]"


def _brute_scores(lens, ipos, jpos, maxd, chainqhits):
    """bruteforcechainingofmatches (onflychain.c:339-377): O(n^2)
    reference recurrence, scores only."""
    n = lens.size
    score = lens.astype(np.int64).copy()
    for k in range(1, n):
        li = ipos[:k]
        lj = jpos[:k]
        ll = lens[:k]
        gap = np.maximum(
            np.maximum(ipos[k] - (li + ll), 0),
            np.maximum(jpos[k] - (lj + ll), 0))
        comp = (gap <= maxd) & (li + ll <= ipos[k]) \
            & (lj + ll <= jpos[k])
        if chainqhits:
            comp |= (gap <= maxd) & ((lj - li) == (jpos[k] - ipos[k])) \
                & (li < ipos[k])
        cand = score[:k] - gap
        valid = comp & (cand > 0)
        if valid.any():
            score[k] = int((cand[valid]).max()) + int(lens[k])
    return score


def run(argv: list[str], device) -> int:
    if len(argv) != 5:
        print(f"Usage: chainqhits fixedmatchlength edistvalue "
              f"indexname queryfile {ARGLIST}", file=sys.stderr)
        return 1
    try:
        fixedmatchlength = int(argv[0])
        edist = int(argv[1])
        if fixedmatchlength <= 0 or edist <= 0:
            raise ValueError
    except ValueError:
        print(f"chainqhits: illegal numeric argument", file=sys.stderr)
        return 1
    indexname, queryfile, flag = argv[2], argv[3], argv[4]
    if flag not in ("checkqhit", "nocheckqhit", "checkleast",
                    "nocheckleast"):
        print(f"chainqhits: last argument must be: {ARGLIST}",
              file=sys.stderr)
        return 1
    withcheck = flag.startswith("check")
    onlyqhits = flag.endswith("qhit")

    esa = ESA.read(indexname, device)
    if fixedmatchlength < esa.prefixlength:
        print(f"chainqhits: fixedmatchlength = {fixedmatchlength} "
              f"must be >= prefixlength = {esa.prefixlength}",
              file=sys.stderr)
        return 1
    qms = read_multiseq([queryfile], esa.alpha)
    lens, ipos, jpos = produce_qhits(esa, qms.sequence,
                                     fixedmatchlength, onlyqhits)
    if withcheck:
        chainer = OnflyChainer(edist, onlyqhits, _NullOut())
        for k in range(lens.size):
            chainer.add(int(lens[k]), int(ipos[k]), int(jpos[k]))
        chainer.wrap()
        brute = _brute_scores(lens, ipos, jpos, edist, onlyqhits)
        onfly = np.array(chainer.score, np.int64)
        if not np.array_equal(brute, onfly):
            bad = int(np.flatnonzero(brute != onfly)[0])
            print(f"chainqhits: check failed at fragment {bad}: "
                  f"brute={brute[bad]} onfly={onfly[bad]}",
                  file=sys.stderr)
            return 1
        print(f"# check okay: {lens.size} fragments")
        return 0
    chainer = OnflyChainer(edist, onlyqhits, sys.stdout)
    for k in range(lens.size):
        chainer.add(int(lens[k]), int(ipos[k]), int(jpos[k]))
    chainer.wrap()
    return 0


class _NullOut:
    def write(self, s):
        pass


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:], cuda_device()))
    except BrokenPipeError:
        sys.exit(0)


if __name__ == "__main__":
    main()
