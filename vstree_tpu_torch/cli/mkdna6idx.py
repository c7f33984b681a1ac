"""mkdna6idx: build the six-frame-translated index of a DNA database
(reference Mkvtree/mkdna6idx.c via callmkvtreegeneric).

Writes two file families:
- ``<indexname>``: the plain DNA input tables (tis/ois/des/sds/ssp/
  al1/prj, no suffix sort — prefixlength=0),
- ``<indexname>.6fr``: the protein index over the six-frame
  translation (multisixframetranslateDNA), prj line
  ``specialindex=<transnum>``.

A copy of :mod:`vstree_tpu.cli.mkdna6idx` but for the device: ``run``
builds the six-frame index on the device it is given, ``main`` asks for
the CUDA card.
"""

from __future__ import annotations

import os
import sys

from ..core.alphabet import (
    dna_alphabet,
    protein_alphabet,
    read_symbolmap,
)
from ..core.codon import check_transnum, six_frame_translate
from ..core.multiseq import read_multiseq
from ..device import cuda_device
from ..index.build import build_esa
from ..index.esa import ESA
from ..index.io import write_index

BASE_TABLES = {"tis", "ois", "ssp"}
SIX_TABLES = {"tis", "ois", "suf", "lcp", "bwt", "ssp"}


def run(argv: list[str], device) -> int:
    db: list[str] = []
    indexname = None
    smap = None
    transnum = 1
    verbose = False
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
        if a == "-smap":
            i += 1; smap = argv[i]; i += 1; continue
        if a == "-transnum":
            i += 1
            transnum = int(argv[i]); i += 1
            try:
                check_transnum(transnum)
            except ValueError as e:
                raise SystemExit(f"mkdna6idx: {e}")
            continue
        if a == "-v":
            verbose = True; i += 1; continue
        raise SystemExit(f"mkdna6idx: illegal option {a}")
    if not db:
        raise SystemExit("mkdna6idx: option -db is mandatory")
    if indexname is None:
        if len(db) > 1:
            raise SystemExit(
                "mkdna6idx: option -indexname is mandatory if more "
                "than one input file is given")
        indexname = os.path.basename(db[0])

    dna_alpha = read_symbolmap(smap) if smap else dna_alphabet()
    ms = read_multiseq(db, dna_alpha, store_original=True)
    # base family: input tables only, no sort
    base = ESA(multiseq=ms, alpha=dna_alpha, suftab=None,
               prefixlength=0, longest=0, indexname=indexname)
    write_index(base, indexname, tables=BASE_TABLES)

    prot_alpha = protein_alphabet()
    sixms = six_frame_translate(ms, prot_alpha, transnum,
                                withdescription=True)
    sixms.filenames = list(ms.filenames)
    sixms.filelengths = list(ms.filelengths)
    sixms.filesep = [0xFFFFFFFF]
    esa6 = build_esa(sixms, prot_alpha, demand=("suf", "lcp", "bwt"),
                     device=device)
    if verbose:
        print(f"# 6fr index: {sixms.totallength} symbols, "
              f"{sixms.numofsequences} sequences "
              f"(translation scheme {transnum})")
    write_index(esa6, indexname + ".6fr", tables=SIX_TABLES,
                prj_extra=(f"specialindex={transnum}",),
                prj_dbfile=False,
                prj_special_zero=True)
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:], cuda_device()))
    except BrokenPipeError:
        sys.exit(0)


if __name__ == "__main__":
    main()
