"""mkvtree-compatible CLI on the port: build a persistent index.

Same options, output names and table files as
:mod:`vstree_tpu.cli.mkvtree` (reference src/Mkvtree/mkvtree.c:169-744),
minus the XLA compile cache.  ``-numproc N`` splits the suffix sort and
the lcp pass over N of the devices that :func:`run` is given (every
CUDA card, from :func:`main`; parallel/shardesa.py).  Index files are
written by the port's copy of ``index.io.write_index``, so they are
byte-identical to the JAX CLI's, with or without ``-numproc``.

Usage: python -m vstree_tpu_torch.cli.mkvtree -db f.fna -dna -pl -allout
(needs a CUDA device; :func:`run` takes the device explicitly).
"""

from __future__ import annotations

import os
import sys

import torch

from ..core.alphabet import (
    dna_alphabet,
    guess_if_protein,
    protein_alphabet,
    read_symbolmap,
)
from ..core.multiseq import (
    complement_inplace,
    read_multiseq,
    reverse_complement_inplace,
    reverse_inplace,
)
from ..index.io import write_index

from ..device import cuda_device, cuda_devices, phase
from ..index.build import (
    build_esa,
    maximal_prefixlength,
    recommended_prefixlength,
)

TABLE_OPTS = ("tis", "ois", "suf", "sti1", "bwt", "bck", "lcp", "skp")


def parse_args(argv: list[str]) -> dict:
    """Table-driven option parse mirroring mkvparseoptions
    (mkvtree.c:169-344)."""
    opts: dict = {
        "db": [], "q": [], "smap": None, "dna": False, "protein": False,
        "pl": None, "pl_auto": False, "indexname": None, "rev": False,
        "cpl": False, "maxdepth": None, "v": False, "numproc": None,
        "demand": set(),
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-db", "-q"):
            key = a[1:]
            i += 1
            while i < len(argv) and not argv[i].startswith("-"):
                opts[key].append(argv[i])
                i += 1
            continue
        if a in ("-smap", "-indexname"):
            opts[a[1:]] = argv[i + 1]
            i += 2
            continue
        if a == "-pl":
            opts["pl_auto"] = True
            if i + 1 < len(argv) and argv[i + 1].isdigit():
                opts["pl"] = int(argv[i + 1])
                i += 1
            i += 1
            continue
        if a == "-numproc":
            opts["numproc"] = int(argv[i + 1])
            i += 2
            continue
        if a == "-maxdepth":
            if i + 1 < len(argv) and argv[i + 1].isdigit():
                opts["maxdepth"] = int(argv[i + 1])
                i += 1
            else:
                opts["maxdepth"] = 0
            i += 1
            continue
        if a in ("-dna", "-protein", "-rev", "-cpl", "-v"):
            opts[a[1:]] = True
            i += 1
            continue
        if a == "-allout":
            opts["demand"].update(TABLE_OPTS)
            i += 1
            continue
        if a.startswith("-") and a[1:] in TABLE_OPTS:
            opts["demand"].add(a[1:])
            i += 1
            continue
        raise SystemExit(f"mkvtree: illegal option {a}")
    if not opts["db"]:
        raise SystemExit("mkvtree: option -db is mandatory")
    if opts["indexname"] is None:
        if len(opts["db"]) > 1:
            raise SystemExit(
                "mkvtree: option -indexname is mandatory if more than "
                "one input file is given")
        opts["indexname"] = os.path.basename(opts["db"][0])
    return opts


def run(argv: list[str], device: torch.device | str,
        devices: list | None = None) -> int:
    """Build and write the index that ``argv`` asks for, on ``device``;
    ``-numproc N`` takes the first N of ``devices`` (default: ``device``
    alone), which may name one device several times."""
    opts = parse_args(argv)
    files = opts["db"] + opts["q"]

    if opts["smap"]:
        from ..core.envconf import scan_paths_for_file

        alpha = read_symbolmap(
            scan_paths_for_file("MKVTREESMAPDIR", opts["smap"]))
    elif opts["protein"]:
        alpha = protein_alphabet()
    elif opts["dna"]:
        alpha = dna_alphabet()
    else:
        with open(files[0], "rb") as fh:
            head = fh.read(4096)
        alpha = (protein_alphabet() if guess_if_protein(head)
                 else dna_alphabet())

    with phase("read input"):
        ms = read_multiseq(files, alpha, num_query_files=len(opts["q"]),
                           store_original="ois" in opts["demand"])
    # -rev reverses, -cpl complements, both reverse-complement; the
    # index name gains .rev/.cpl/.rcp (mkvtree.c:143-161)
    if opts["rev"] and opts["cpl"]:
        ms = reverse_complement_inplace(ms)
        opts["indexname"] += ".rcp"
    elif opts["rev"]:
        ms = reverse_inplace(ms)
        opts["indexname"] += ".rev"
    elif opts["cpl"]:
        ms = complement_inplace(ms)
        opts["indexname"] += ".cpl"

    numofchars = alpha.num_regular
    pl = opts["pl"]
    if pl is None:
        pl = recommended_prefixlength(numofchars, max(ms.totallength, 1))
    maxpl = maximal_prefixlength(numofchars, max(ms.totallength, 1))
    if pl > maxpl:
        raise SystemExit(
            f"mkvtree: prefix length {pl} is too large, maximal "
            f"prefix length for this input size and alphabet size "
            f"is {maxpl}")
    demand = {{"sti1": "sti"}.get(t, t) for t in opts["demand"]}
    build_demand = tuple(
        d for d in ("suf", "lcp", "bwt", "bck", "sti", "skp") if d in demand
    ) or ("suf",)
    if opts["v"]:
        print(f"# dbfile={files[0]} {ms.totallength} symbols")
        print(f"# prefixlength={pl}")
        if opts["maxdepth"] is not None:
            # the prefix-doubling sort always completes the order
            print("# maxdepth accepted (sort always completes; "
                  "index content unaffected)")
    mesh = None
    if opts["numproc"] and opts["numproc"] > 1:
        from ..parallel.shardesa import numproc_mesh

        mesh = numproc_mesh(opts["numproc"],
                            [device] if devices is None else devices)
    esa = build_esa(ms, alpha, prefixlength=pl, demand=build_demand,
                    mesh=mesh, device=device)
    with phase("write index"):
        write_index(esa, opts["indexname"])
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:], cuda_device(), cuda_devices()))
    except BrokenPipeError:  # e.g. piped into head
        sys.exit(0)


if __name__ == "__main__":
    main()
