"""mkrcidx: build the reverse-complement index pair (reference
Mkvtree/mkrcidx.c via callmkvtreegeneric with its exclusion list):
every input DNA sequence is followed by its reverse complement and the
result is indexed as ``<indexname>.rcm`` (tables tis/suf/lcp/llv/bwt/
ssp/des/sds/al1/prj, prj line ``specialindex=0``, with the reference's
zeroed special-statistics quirk).

A copy of :mod:`vstree_tpu.cli.mkrcidx` but for the device: ``run``
builds the index on the device it is given, ``main`` asks for the CUDA
card.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..core.alphabet import dna_alphabet
from ..core.chardef import SEPARATOR
from ..core.multiseq import Multiseq, read_multiseq
from ..device import cuda_device
from ..index.build import build_esa
from ..index.io import write_index

RCM_TABLES = {"tis", "suf", "lcp", "bwt", "ssp"}


def rcplus_multiseq(ms: Multiseq) -> Multiseq:
    """seq1, rc(seq1), seq2, rc(seq2), ... SEPARATOR-delimited, each
    description duplicated (mkrcsequences2index)."""
    comp = np.arange(256, dtype=np.uint8)
    comp[0:4] = [3, 2, 1, 0]
    pieces: list[np.ndarray] = []
    markpos: list[int] = []
    descs: list[bytes] = []
    total = 0
    sep = np.full(1, SEPARATOR, np.uint8)
    for s in range(ms.numofsequences):
        a, b = ms.seq_bounds(s)
        seq = ms.sequence[a:b]
        rc = comp[seq[::-1]]
        for part in (seq, rc):
            if total > 0:
                markpos.append(total)
                pieces.append(sep)
                total += 1
            pieces.append(part)
            total += part.size
        d = ms.descriptions[s] if s < len(ms.descriptions) else b""
        descs.extend([d, d])
    out = Multiseq(sequence=np.concatenate(pieces),
                   markpos=np.asarray(markpos, np.int64))
    out.numofsequences = ms.numofsequences * 2
    out.totallength = int(out.sequence.size)
    out.descriptions = descs
    out.filenames = list(ms.filenames)
    out.filelengths = list(ms.filelengths)
    out.filesep = [0xFFFFFFFF]
    return out


def run(argv: list[str], device) -> int:
    db: list[str] = []
    indexname = None
    verbose = False
    cpl = False
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-db":
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                db.append(argv[i]); i += 1
            continue
        if a == "-indexname":
            i += 1; indexname = argv[i]; i += 1; continue
        if a == "-v":
            verbose = True; i += 1; continue
        if a == "-cpl":
            cpl = True; i += 1; continue
        if a == "-maxdepth":
            # sort performance hint (the doubling sort always
            # completes); reference forwards it to mkvtree
            if i + 1 < len(argv) and argv[i + 1].isdigit():
                i += 1
            i += 1; continue
        raise SystemExit(f"mkrcidx: illegal option {a}")
    if not db:
        raise SystemExit("mkrcidx: option -db is mandatory")
    if indexname is None:
        if len(db) > 1:
            raise SystemExit(
                "mkrcidx: option -indexname is mandatory if more "
                "than one input file is given")
        indexname = os.path.basename(db[0])

    alpha = dna_alphabet()
    ms = read_multiseq(db, alpha)
    if cpl:
        # -cpl complements the input in place before the rc-pair
        # construction (reference: mkvtreeinput applies OPTCPL before
        # mkrcsequences2index; mkvinput.c:173-309)
        comp = np.arange(256, dtype=np.uint8)
        comp[0:4] = [3, 2, 1, 0]
        ms.sequence = comp[ms.sequence]
    rcms = rcplus_multiseq(ms)
    esa = build_esa(rcms, alpha, demand=("suf", "lcp", "bwt"),
                    device=device)
    if verbose:
        print(f"# rcm index: {rcms.totallength} symbols, "
              f"{rcms.numofsequences} sequences")
    # the reference writes BOTH lines: specialindex=0 for the rcm
    # flag plus specialindex=1 from its default transnum
    # (mkvprocess.c:489-496) — reproduced verbatim
    write_index(esa, indexname + ".rcm", tables=RCM_TABLES,
                prj_extra=("specialindex=0", "specialindex=1"),
                prj_special_zero=True)
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:], cuda_device()))
    except BrokenPipeError:
        sys.exit(0)


if __name__ == "__main__":
    main()
