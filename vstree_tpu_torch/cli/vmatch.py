"""vmatch-compatible CLI on the port: the ``-complete -q`` task.

The slice of :mod:`vstree_tpu.cli.vmatch` that the port runs: exact
whole-query matching (``-complete -q``), direct and palindromic
(``-d``/``-p``), with the show-mode flags ``-absolute -nodist -noevalue
-noscore -noidentity`` and ``-s``.  The index is read with the shared
``index.io.read_index``, and matches go through the shared funnel and
renderer in the order of the JAX CLI, so stdout is byte-identical.
Every other option exits with a "not yet ported" message naming it.

Usage: python -m vstree_tpu_torch.cli.vmatch -complete -q q.fna idx
(needs a CUDA device; :func:`run` takes the device explicitly).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vstree_tpu.core.multiseq import read_multiseq, reverse_complement_inplace
from vstree_tpu.engine.funnel import MatchParams, process_final
from vstree_tpu.engine.match import FLAGPALINDROMIC, MatchTable
from vstree_tpu.output import align as _al
from vstree_tpu.output.render import (
    SHOWABSOLUTE,
    SHOWNODIST,
    SHOWNOEVALUE,
    SHOWNOIDENTITY,
    SHOWNOSCORE,
    argument_header,
    assign_query_digits,
    assign_virtual_digits,
    render_matches,
)
from vstree_tpu.stats.evalues import Evalues

from ..device import cuda_device, phase
from ..engine.complete import exact_complete_matches
from ..index.esa import ESA

_FLAGS = ("complete", "p", "d", "absolute", "nodist", "noevalue",
          "noscore", "noidentity")

_S_KEYWORDS = {
    "leftseq": _al.SHOWPURELEFTSEQ,
    "rightseq": _al.SHOWPURERIGHTSEQ,
    "abbrev": _al.SHOWALIGNABBREV,
    "abbreviub": _al.SHOWALIGNABBREVIUB,
}


def _not_ported(what: str) -> SystemExit:
    return SystemExit(f"vmatch: {what} is not yet ported to "
                      "vstree_tpu_torch")


def _parse_s_arg(arg: str) -> int:
    """parseoptstringargs (Vmatch/optstring.c:15-56)."""
    if arg[:1].isdigit():
        try:
            v = int(arg)
        except ValueError:
            v = 0
        if not 0 < v <= _al.MAXLINEWIDTH:
            raise SystemExit(
                f'vmatch: argument "{arg}" of option -s must be number '
                f"in the range [1...{_al.MAXLINEWIDTH}]")
        return v
    if arg == "xml":
        raise _not_ported("option -s xml")
    if arg in _S_KEYWORDS:
        return _S_KEYWORDS[arg]
    raise SystemExit(
        f'vmatch: incorrect argument "{arg}" to option -s '
        "must be one of the following keywords: "
        "leftseq, rightseq, abbrev, abbreviub")


def parse_args(argv: list[str]) -> dict:
    """The slice's options, parsed as :func:`vstree_tpu.cli.vmatch.
    parse_args` parses them; the last argument is the index."""
    opts: dict = {"index": None, "q": [], "s": None}
    opts.update((k, False) for k in _FLAGS)
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-"):
            opts["index"] = a
            i += 1
            continue
        key = a[1:]
        if key == "q":
            i += 1
            while (i < len(argv) - 1 and not argv[i].startswith("-")):
                opts["q"].append(argv[i])
                i += 1
            continue
        if key == "complete":
            opts["complete"] = True
            i += 1
            if i < len(argv) - 1 and not argv[i].startswith("-"):
                raise _not_ported(f'argument "{argv[i]}" of option '
                                  "-complete")
            continue
        if key in _FLAGS:
            opts[key] = True
            i += 1
            continue
        if key == "s":
            # parsesequenceoutparms (Vmatch/optstring.c:62-108): up to
            # two optional arguments, a line width and/or a keyword
            showstring = _al.DEFAULTLINEWIDTH
            nopt = 0
            while (nopt < 2 and i + 1 < len(argv) - 1
                   and not argv[i + 1].startswith("-")):
                ret = _parse_s_arg(argv[i + 1])
                if ret & _al.MAXLINEWIDTH:
                    if nopt == 0:
                        showstring = ret
                    else:
                        showstring = (showstring & (_al.SHOWPURELEFTSEQ
                                                    | _al.SHOWPURERIGHTSEQ)
                                      ) | ret
                else:
                    showstring |= ret
                i += 1
                nopt += 1
            opts["s"] = showstring
            i += 1
            continue
        raise _not_ported(f"option {a}")
    if opts["index"] is None:
        raise SystemExit("vmatch: the last argument must be the index name")
    if not opts["complete"]:
        raise _not_ported("a task other than -complete")
    if not opts["q"]:
        raise _not_ported("option -complete without -q")
    return opts


def run(argv: list[str], device: torch.device | str, out=None) -> int:
    """Run the ``-complete -q`` task of ``argv`` on ``device``, writing
    the match rows to ``out`` (default stdout)."""
    out = out or sys.stdout
    opts = parse_args(argv)
    with phase("read index"):
        esa = ESA.read(opts["index"], device)
    ms = esa.multiseq
    ev = Evalues(1.0 / esa.alpha.num_regular)
    mp = MatchParams(leastlength=0, identity=0.0, leastscore=None,
                     maxevalue=None, lowergaplength=None,
                     uppergaplength=None)
    showmode = 0
    for flag, bit in (("absolute", SHOWABSOLUTE), ("nodist", SHOWNODIST),
                      ("noevalue", SHOWNOEVALUE), ("noscore", SHOWNOSCORE),
                      ("noidentity", SHOWNOIDENTITY)):
        if opts[flag]:
            showmode |= bit
    print(argument_header(argv[:-1], opts["index"]), file=out)
    digits = assign_virtual_digits(ms)
    with phase("read queries"):
        query = read_multiseq(opts["q"], esa.alpha, store_original=True)
    assign_query_digits(digits, query)
    starts = np.array(
        [query.seq_bounds(i)[0] for i in range(query.numofsequences)],
        np.int64)

    def run_pats(q, flags):
        ps = [q.sequence[slice(*q.seq_bounds(i))]
              for i in range(q.numofsequences)]
        return exact_complete_matches(esa, ps, flags_extra=flags,
                                      query_starts=starts)

    # reference order (runquery.c:283-321): all direct matches first
    # (queries in input order), then all palindromic ones; -p alone
    # turns the direct ones off unless -d is given too
    tables: list[MatchTable] = []
    if opts["d"] or not opts["p"]:
        tables.append(run_pats(query, 0))
    if opts["p"]:
        tables.append(run_pats(reverse_complement_inplace(query),
                               FLAGPALINDROMIC))
    with phase("funnel"):
        mt = process_final(MatchTable.concat(tables), ms, ev, mp,
                           query=query)
    with phase("render"):
        lines = render_matches(mt, ms, digits, showmode, query)
        if opts["s"] is None:
            for line in lines:
                print(line, file=out)
            return 0
        # echomatch2file with showstring > 0 (echomatch.c:1036-1086):
        # row, newline, alignment text, newline
        for k, line in enumerate(lines):
            out.write(line + "\n")
            row = {
                "position1": int(mt.position1[k]),
                "length1": int(mt.length1[k]),
                "position2": int(mt.position2[k]),
                "length2": int(mt.length2[k]),
                "distance": int(mt.distance[k]),
                "flag": int(mt.flag[k]),
                "relpos1": int(mt.relpos1[k]),
                "relpos2": int(mt.relpos2[k]),
                "xdropscore": None,
            }
            out.write(_al.echo_string_output(row, ms, query, opts["s"]))
            out.write("\n")
    return 0


def main() -> None:
    try:
        sys.exit(run(sys.argv[1:], cuda_device()))
    except BrokenPipeError:  # e.g. piped into head
        sys.exit(0)


if __name__ == "__main__":
    main()
