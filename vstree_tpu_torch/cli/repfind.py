"""repfind emulation: map REPuter's repfind CLI onto mkvtree + vmatch
(reference Emulate/repfind.pl — option table repfind.pl:152-296,
index reuse check repfind.pl:85-122, pipeline repfind.pl:10-42).

A copy of :mod:`vstree_tpu.cli.repfind` but for the device: ``run``
calls the port's ``mkvtree`` and ``vmatch`` on the device it is given,
``main`` asks for the CUDA card."""

from __future__ import annotations

import os
import sys

from ..device import cuda_device

NOT_SUPPORTED = {"-r", "-c", "-hrate", "-erate", "-o", "-b", "-warn",
                 "-iw", "-mem"}

HELP = """-f           compute maximal forward repeats
-p           compute maximal palindromes
-l           specify that repeats must have the given length
-h           search for repeats up to the given hamming distance
-e           search for repeats up to the given edit distance
-seedsize    set the seed size
-allmax      show all maximal repeats in the order of their computation
-best        show the repeats with smallest E-value (default best 50)
-s           show the string content of the maximal repeats
-lw          format string output to given linewidth
-iub         print pair of different residues in IUB format
-nodistance  do not show distance values
-noevalue    do not compute evalues
-i           give info about number of different repeats
-v           show program version
-help        this option
"""


def _analyze(program: str, argv: list[str]) -> list[str]:
    """analyzerepfindargs (repfind.pl:149-296): translate repfind
    options to vmatch options; the last argument is the filename."""
    out: list[str] = []
    stringoption = False
    linewidth = 0
    doiub = False
    bestoption = False
    allmaxoption = False
    argcount = len(argv)
    argnum = 0
    while argnum < argcount - 1:
        a = argv[argnum]
        if a == "-f":
            out.append("-d")
        elif a == "-p":
            out.append("-p")
        elif a in ("-l", "-seedsize", "-best"):
            out.append("-seedlength" if a == "-seedsize" else a)
            argnum += 1
            if argnum >= argcount - 1 or argv[argnum].startswith("-"):
                print(f'{program}: missing argument for option "{a}"',
                      file=sys.stderr)
                sys.exit(1)
            if a == "-best":
                bestoption = True
            out.append(argv[argnum])
        elif a == "-lw":
            argnum += 1
            if argnum >= argcount - 1 or argv[argnum].startswith("-"):
                print(f'{program}: missing argument for option "{a}"',
                      file=sys.stderr)
                sys.exit(1)
            linewidth = int(argv[argnum])
            if linewidth <= 0:
                print(f'{program}: illegal argument "{linewidth}" '
                      f'to option "-lw"', file=sys.stderr)
                sys.exit(1)
        elif a in ("-h", "-e"):
            out.append(a)
            # optional numeric argument, default 4; the Perl ALWAYS
            # consumes the next token, so "-h -l 30" swallows the -l
            # and then fails on the orphaned "30" (repfind.pl:219-229
            # increments $argnum before the dash test, faithfully
            # reproduced)
            argnum += 1
            if argnum >= argcount - 1 or argv[argnum].startswith("-"):
                out.append("4")
            else:
                out.append(argv[argnum])
        elif a == "-allmax":
            allmaxoption = True
            out.append("-allmax")
        elif a == "-s":
            stringoption = True
        elif a == "-iub":
            doiub = True
        elif a == "-nodistance":
            out.append("-nodist")
        elif a in ("-noevalue", "-i"):
            out.append(a)
        else:
            if a in NOT_SUPPORTED:
                print(f'{program}: repfind option "{a}" is not '
                      "supported", file=sys.stderr)
            else:
                print(f'{program}: illegal option "{a}"',
                      file=sys.stderr)
            sys.exit(1)
        argnum += 1
    if argnum == argcount - 1 and argv[argnum].startswith("-"):
        print(f'{program}: last argument must be filename, not '
              'beginning with "-"', file=sys.stderr)
        sys.exit(1)
    if argnum > argcount - 1:
        print(f"{program}: missing last argument", file=sys.stderr)
        sys.exit(1)
    if not out:
        print(f"{program}: at least one option is required",
              file=sys.stderr)
        sys.exit(1)
    if not bestoption and not allmaxoption:
        out += ["-best", "50"]
    if stringoption:
        out.append("-s")
        if linewidth > 0:
            out.append(str(linewidth))
        if doiub:
            out.append("abbreviub")
    out += ["-noscore", "-noidentity", "-absolute"]
    return out


def _check_dbfile(inputfile: str, prjfile: str) -> bool:
    """Skip the index build when the prj already records this dbfile
    with its current size (repfind.pl:85-122)."""
    if not os.path.exists(prjfile):
        return False
    try:
        with open(prjfile) as fp:
            for line in fp:
                if line.startswith("dbfile="):
                    fields = line.split()
                    if len(fields) >= 2 and fields[0] == \
                            f"dbfile={inputfile}":
                        try:
                            if os.stat(inputfile).st_size == \
                                    int(fields[1]):
                                return True
                        except OSError:
                            pass
                    return False
    except OSError:
        return False
    return False


def _call(module, args: list[str], name: str) -> None:
    try:
        rc = module(args)
        rc = 0 if rc is None else rc
    except SystemExit as e:
        if isinstance(e.code, str):
            print(e.code, file=sys.stderr)
            rc = 1
        else:
            rc = e.code or 0
    if rc != 0:
        # the Perl prints the raw wait status $? (rc << 8)
        print(f'failure: "{name} {" ".join(args)}", errorcode '
              f'{rc * 256}', file=sys.stderr)
        sys.exit(1)
    print(f"# {name} {' '.join(args)}", file=sys.stderr)


def run(argv: list[str], device) -> int:
    program = "repfind.pl"
    if not argv:
        print(f"{program}: Missing Arguments", file=sys.stderr)
        print(f"Usage: {program} [options] filename", file=sys.stderr)
        print(f"try {program} -help", file=sys.stderr)
        return 1
    if argv == ["-help"]:
        print(HELP, end="")
        return 0
    if argv == ["-v"]:
        print(f"this is {program},")
        print("a perl script emulating the options of the "
              "C-program repfind")
        print("by calling mkvtree and vmatch")
        return 0
    vmatchoptions = _analyze(program, argv)
    inputfile = argv[-1]
    indexname = os.path.basename(inputfile)

    from . import mkvtree as mkvtree_cli
    from . import vmatch as vmatch_cli

    if not _check_dbfile(inputfile, indexname + ".prj"):
        _call(lambda args: mkvtree_cli.run(args, device),
              ["-db", inputfile, "-dna", "-pl", "-lcp", "-suf",
               "-tis", "-ois", "-bwt", "-bck", "-sti1"], "mkvtree")
    vmatchoptions.append(indexname)
    _call(lambda args: vmatch_cli.run(args, device), vmatchoptions,
          "vmatch")
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:], cuda_device()))
    except BrokenPipeError:
        sys.exit(0)


if __name__ == "__main__":
    main()
