"""chain2dim-compatible CLI: global/local chaining of match files
(reference src/Vmatch/chain2dim.mn.c + kurtz-basic/chain2dim.c).

Usage: python -m vstree_tpu_torch.cli.chain2dim -global [gc|ov] file
       python -m vstree_tpu_torch.cli.chain2dim -local [k|kb|kp] file
"""

from __future__ import annotations

import sys

from ..output.render import (
    assign_query_digits,
    assign_virtual_digits,
    render_matches,
)
from ..postprocess.chain import (
    GLOBAL,
    GLOBALGC,
    GLOBALOV,
    LOCALBEST,
    LOCALMAX,
    LOCALPERCENT,
    LOCALTHRESH,
    ChainMode,
    chain_fragments,
)
from ..postprocess.matchfile import read_match_file


def parse_chain_args(argv):
    mode = ChainMode()
    silent = False
    mfile = None
    chosen = False
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-global":
            mode.kind = GLOBAL
            chosen = True
            while i + 1 < len(argv) and argv[i + 1] in ("gc", "ov"):
                i += 1
                mode.kind = GLOBALGC if argv[i] == "gc" else GLOBALOV
        elif a == "-local":
            mode.kind = LOCALMAX
            chosen = True
            if i + 1 < len(argv) and not argv[i + 1].startswith("-") \
                    and i + 1 < len(argv) - 1:
                i += 1
                spec = argv[i]
                if spec.endswith("b"):
                    mode.kind = LOCALBEST
                    mode.howmanybest = int(spec[:-1])
                elif spec.endswith("p"):
                    mode.kind = LOCALPERCENT
                    mode.percentaway = int(spec[:-1])
                else:
                    mode.kind = LOCALTHRESH
                    mode.minscore = int(spec)
        elif a == "-wf":
            i += 1
            mode.weightfactor = float(argv[i])
        elif a == "-maxgap":
            i += 1
            mode.maxgapwidth = int(argv[i])
        elif a == "-silent":
            silent = True
            mode.silent = True
        elif a == "-outprefix":
            i += 1
            mode.outprefix = argv[i]
        elif a == "-withinborders":
            mode.withinborders = True
        elif a == "-thread":
            # chncallparse.c:177-222: keyword-value pairs minlen1/
            # maxerror1/minlen2/maxerror2 (all optional)
            mode.dothreading = True
            keys = {"minlen1": "minthreadlen1", "maxerror1": "maxerror1",
                    "minlen2": "minthreadlen2", "maxerror2": "maxerror2"}
            while i + 2 < len(argv) and argv[i + 1] in keys:
                val = int(argv[i + 2])
                if val <= 0:
                    raise SystemExit(
                        f"chain2dim: argument of {argv[i + 1]} must be "
                        "positive")
                setattr(mode, keys[argv[i + 1]], val)
                i += 2
        elif a == "-v":
            pass
        elif not a.startswith("-"):
            mfile = a
        else:
            raise SystemExit(f"chain2dim: illegal option {a}")
        i += 1
    if not chosen:
        raise SystemExit(
            "chain2dim: missing options: -help displays the possible "
            "options")
    if mfile is None:
        raise SystemExit(
            "chain2dim: the last argument must be the match file")
    return mode, silent, mfile


def run(argv: list[str], out=None) -> int:
    out = out or sys.stdout
    mode, silent, mfile = parse_chain_args(argv)
    mf = read_match_file(mfile)
    res = chain_fragments(mf.table, mode)
    digits = assign_virtual_digits(mf.esa.multiseq)
    if mf.query is not None:
        assign_query_digits(digits, mf.query)
    if mode.dothreading:
        # chain2dim.mn.c routes -thread through vmatchchaining too, so
        # the standalone tool shows the same diagonal dump
        from ..postprocess.chain import _diagonal_dump

        def emit_rows(sub, fh):
            for line in render_matches(sub, mf.esa.multiseq, digits,
                                       mf.showmode, mf.query):
                fh.write(line + "\n")

        _diagonal_dump(mf.table, emit_rows, out)
        return 0
    for ci, (frags, sc) in enumerate(zip(res.fragments, res.scores)):
        print(f"# chain {ci}: length {frags.size} score {sc}",
              file=out)
        if silent:
            continue
        sub = res.table.select(frags)
        for line in render_matches(sub, mf.esa.multiseq, digits,
                                   mf.showmode, mf.query):
            print(line, file=out)
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:]))
    except BrokenPipeError:  # e.g. piped into head
        sys.exit(0)


if __name__ == "__main__":
    main()
