"""matchcluster-compatible CLI: cluster matches from a match file.

Reference: src/Vmatch/matchcl.mn.c (main), src/Vmatch/parsemcl.c
(``parsematchcluster``: exactly one of -erate/-gapsize/-overlap, plus
mandatory -outprefix, then the match file).

Usage: python -m vstree_tpu_torch.cli.matchcluster
           (-erate p | -gapsize n | -overlap p)
           -outprefix prefix matchfile
"""

from __future__ import annotations

import sys

from ..postprocess.matchcluster import (
    GAP_MCL,
    OVERLAP_MCL,
    SIMILARITY_MCL,
    UNDEF_MCL,
    Matchclustercallinfo,
    run_matchcluster,
)
from ..postprocess.matchfile import read_match_file

PROG = "matchcluster"


def parse_matchcluster_args(
    argv: list[str], fromvmatch: bool = False
) -> tuple[Matchclustercallinfo, str | None]:
    """parsematchcluster (parsemcl.c:29-184).  Returns (info,
    matchfile); matchfile is None when called from vmatch -pp (the
    buffered matches are used instead)."""
    prog = "vmatch" if fromvmatch else PROG
    dash = "" if fromvmatch else "-"
    info = Matchclustercallinfo()
    seen: set[str] = set()
    mfile = None
    i = 0

    def need_arg(name):
        if i + 1 >= len(argv) or argv[i + 1].startswith("-"):
            raise SystemExit(
                f"{prog}: missing argument for option {dash}{name}")

    while i < len(argv):
        a = argv[i]
        if not a.startswith("-"):
            break
        name = a[1:]
        if name == "erate":
            need_arg(name)
            i += 1
            v = int(argv[i])
            if v < 0 or v > 100:
                raise SystemExit(
                    f"{prog}: argument to option {dash}erate must be "
                    f"integer in range [0,100]")
            info.errorrate = v
            info.matchclustertype = SIMILARITY_MCL
            seen.add("erate")
        elif name == "gapsize":
            need_arg(name)
            i += 1
            v = int(argv[i])
            if v < 0:
                raise SystemExit(
                    f"{prog}: argument to option {dash}gapsize must be "
                    f"non-negative")
            info.maxgapsize = v
            info.matchclustertype = GAP_MCL
            seen.add("gapsize")
        elif name == "overlap":
            need_arg(name)
            i += 1
            v = int(argv[i])
            if v < 0 or v > 100:
                raise SystemExit(
                    f"{prog}: argument to option {dash}overlap must be "
                    f"integer in range [0,100]")
            info.minpercentoverlap = v
            info.matchclustertype = OVERLAP_MCL
            seen.add("overlap")
        elif name == "outprefix":
            need_arg(name)
            i += 1
            info.outprefix = argv[i]
        else:
            raise SystemExit(f"{prog}: illegal option -{name}")
        i += 1

    if i < len(argv) - 1:
        raise SystemExit(
            f'{prog}: superfluous file argument "{argv[-1]}"')
    if i < len(argv):
        mfile = argv[i]

    if len(seen) > 1:
        a, b = sorted(seen)[:2]
        raise SystemExit(
            f"{prog}: options {dash}{a} and {dash}{b} exclude each "
            f"other")
    if info.matchclustertype == UNDEF_MCL:
        raise SystemExit(
            f"{prog}: one of the options {dash}erate, {dash}gapsize, "
            f"or {dash}overlap must be used")
    if info.outprefix is None:
        raise SystemExit(
            f"{prog}: option {dash}outprefix is mandatory")
    if not fromvmatch and mfile is None:
        raise SystemExit(f"{prog}: missing matchfile")
    return info, mfile


def run(argv: list[str], out=None) -> int:
    out = out or sys.stdout
    info, mfile = parse_matchcluster_args(argv)
    mf = read_match_file(mfile)
    mfargs = mf.argline[len("# args="):]
    run_matchcluster(info, mf.table, mf.esa.multiseq, mf.query,
                     mfargs, out=out)
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:]))
    except BrokenPipeError:  # e.g. piped into head
        sys.exit(0)


if __name__ == "__main__":
    main()
