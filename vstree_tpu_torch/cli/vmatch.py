"""vmatch-compatible CLI on the port.

The slices of :mod:`vstree_tpu.cli.vmatch` that the port runs:

- whole-query matching (``-complete -q``), exact or approximate with at
  most k mismatches (``-h k``) or k differences (``-e k``), over the
  index or, with ``-online``, by scans of the text; direct and
  palindromic (``-d``/``-p``),
- the self-match tasks on an index without ``-q``: maximal repeats
  (``-l L``), supermaximal repeats (``-supermax -l L``), branching tandem
  repeats (``-tandem -l L``) and maximal unique matches between the
  database and the indexed queries (``-mum -l L``),
- seed extension of the maximal repeats: degenerate repeats with at most
  k differences or mismatches (``-l L -e k``, ``-l L -h k``, all maximal
  extensions with ``-allmax``) and the x-drop extensions (``-exdrop x``,
  ``-hxdrop x``), each with ``-seedlength``,
- query matching on the index (``-q`` without ``-complete``): maximal
  exact matches (``-l L -q``), MUM candidates and MUMs (``-mum [cand]``),
  direct and palindromic (``-d``/``-p``), the seed extension of such
  matches (``-e``, ``-h``, ``-exdrop``, ``-hxdrop`` with ``-q``), each
  also ``-online`` (a throwaway index per query sequence), and the
  reference's query speedups 0, 2 and 5 (``-qspeedup N`` or the
  ``QUERYSPEEDUP`` environment variable),
- self-palindromic matches (``-l L -p`` without ``-q``, also with the
  seed extension),

with the show-mode flags ``-absolute -nodist -noevalue -noscore
-noidentity``, ``-s`` and the length histogram ``-i``.  Matches go
through the funnel and renderer in the order of the JAX CLI, so stdout
is byte-identical.  Every other option exits with a "not yet ported"
message naming it.

Usage: python -m vstree_tpu_torch.cli.vmatch -complete [-e 1] -q q.fna idx
       python -m vstree_tpu_torch.cli.vmatch [-mum [cand]] -l 20 -q q.fna idx
       python -m vstree_tpu_torch.cli.vmatch [-supermax] -l 20 idx
       python -m vstree_tpu_torch.cli.vmatch -l 30 -e 2 [-allmax] idx
       python -m vstree_tpu_torch.cli.vmatch -l 40 -exdrop 3 idx
(needs a CUDA device; :func:`run` takes the device explicitly).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..core.multiseq import read_multiseq, reverse_complement_inplace
from ..engine.funnel import MatchParams, process_final
from ..engine.match import FLAGPALINDROMIC, FLAGSELFPALINDROMIC, MatchTable
from ..output import align as _al
from ..output.render import (
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
from ..stats.evalues import Evalues

from ..device import count, cuda_device, phase
from ..engine.approx import approx_complete_matches
from ..engine.complete import exact_complete_matches
from ..engine.gextend import (
    Seqs,
    edit_extend_seeds,
    edit_extend_self_device,
    hamming_extend_seeds,
)
from ..engine.mumself import find_mum_self
from ..engine.online import online_complete_matches
from ..engine.onlinequery import online_query_matches
from ..engine.query import _unique_in_query, find_query_matches
from ..engine.repeats import find_maximal_pairs_ref
from ..engine.supermax import find_supermax
from ..engine.tandem import find_tandems_ref
from ..engine.xdrop import xdrop_extend_seeds
from ..index.esa import ESA

_FLAGS = ("complete", "online", "p", "d", "absolute", "nodist", "noevalue",
          "noscore", "noidentity", "supermax", "tandem", "mum", "i",
          "allmax")
_NUMBERS = ("e", "h", "exdrop", "hxdrop", "seedlength")

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
    opts: dict = {"index": None, "q": [], "s": None, "l": None,
                  "mumcand": False, "qspeedup": None}
    opts.update((k, False) for k in _FLAGS)
    opts.update((k, None) for k in _NUMBERS)
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
            if key == "mum" and i < len(argv) and argv[i] == "cand":
                opts["mumcand"] = True
                i += 1
            continue
        if key == "qspeedup":
            i += 1
            if i >= len(argv) - 1 or not _is_number(argv[i]):
                raise SystemExit(
                    "vmatch: argument of option -qspeedup must be "
                    "non-negative integer")
            opts["qspeedup"] = int(argv[i])
            i += 1
            continue
        if key == "l":
            # optional numeric argument; the gap bounds that may follow
            # it (parselowerupperbounds, parsevm.c:536-585) are filters
            opts["l"] = 0
            if i + 1 < len(argv) and _is_number(argv[i + 1]):
                opts["l"] = int(argv[i + 1])
                i += 1
                if i + 1 < len(argv) - 1 and _is_number(argv[i + 1]):
                    raise _not_ported("a gap bound of option -l")
            i += 1
            continue
        if key in _NUMBERS:
            arg = argv[i + 1] if i + 1 < len(argv) else ""
            if not (arg.isascii() and arg.isdigit()):
                raise SystemExit(
                    f'vmatch: argument "{arg}" of option {a} must be a '
                    "non-negative integer")
            opts[key] = int(arg)
            i += 2
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
    _refuse_unported(opts)
    return opts


def _refuse_unported(opts: dict) -> None:
    """Exit for the combinations of the parsed options that reach code
    the port does not have yet."""
    if opts["complete"]:
        if not opts["q"]:
            raise _not_ported("option -complete without -q")
        return
    xdrop = opts["exdrop"] is not None or opts["hxdrop"] is not None
    task = (opts["l"] is not None or opts["supermax"] or opts["tandem"]
            or opts["mum"] or xdrop)
    for key in ("e", "h"):
        if opts[key] is not None and not task:
            raise _not_ported(f"option -{key} without -complete")
    if not task:
        raise _not_ported("a task other than -complete, -l, -supermax, "
                          "-tandem and -mum")


def _query_speedup(opts: dict) -> int:
    """The query speedup: option -qspeedup, overridden by the variable
    QUERYSPEEDUP (parsevm.c:1126-1137,1642), with the JAX CLI's refusals
    of the algorithms it does not run (1, 3, 4, above 5)."""
    qsp = opts["qspeedup"] if opts["qspeedup"] is not None else 2
    env = os.environ.get("QUERYSPEEDUP")
    if env is not None:
        try:
            qsp = int(env)
            if qsp < 0:
                raise ValueError
        except ValueError:
            raise SystemExit(
                f'vmatch: incorrect value "{env}" of environment '
                "variable QUERYSPEEDUP; must be non-negative integer")
    if qsp == 1:
        raise SystemExit(
            "vmatch: Algorithm 1 is no longer available, please use "
            "Algorithm 0, or 2; we recommend Algorithm 2")
    if qsp > 5:
        raise SystemExit(f"vmatch: illegal speedup value {qsp}")
    if qsp == 3:
        # the reference binary crashes on -qspeedup 3 (matchsub.c:539)
        raise SystemExit(
            "vmatch: Algorithm 3 is not supported (it crashes the "
            "reference implementation); please use Algorithm 0, 2 "
            "or 5")
    if qsp == 4:
        # the reference's own reader rejects the lsf table that
        # Algorithm 4 demands (readvirt.c:895)
        raise SystemExit(
            "vmatch: Algorithm 4 is not supported: the reference's "
            "own reader rejects its mklsf output (size mismatch, "
            "readvirt.c:895), making it unusable there; please use "
            "Algorithm 0, 2 or 5")
    return qsp


def _is_number(s: str) -> bool:
    try:
        int(s)
        return True
    except ValueError:
        return False


def _self_matches(esa: ESA, opts: dict,
                  qsp: int) -> tuple[MatchTable, bool]:
    """The self-match task that ``opts`` names, on an index without
    ``-q``, with the reference's messages for what a task requires, and
    whether self-palindromic rows were asked for: ``-p`` adds them to
    ``-l`` and the seed extension (runself.c:128-180), the database
    against its own per-sequence reverse complement through the query
    machinery; ``-p`` alone drops the direct ones.  ``-p`` means nothing
    to the other tasks."""
    ms = esa.multiseq
    has_iq = ms.numofquerysequences > 0
    length = opts["l"]
    for task, what in (("supermax", "supermaximal repeat search does not "
                        "allow query files in index"),
                       ("tandem", "tandem repeat search does not allow "
                        "query files in index")):
        if opts[task]:
            if length is None:
                raise SystemExit(
                    f"vmatch: option -{task} requires option -l")
            if has_iq:
                raise SystemExit(f"vmatch: {what}")
            with phase(task):
                return (find_supermax if task == "supermax"
                        else find_tandems_ref)(esa, length), False
    if opts["mum"]:
        # self variant: maximal unique matches between the database and
        # indexed-query regions (fmumself.c)
        if opts["mumcand"]:
            raise SystemExit(
                "vmatch: option -mum cand also requires option -q")
        if length is None:
            raise SystemExit("vmatch: option -mum requires option -l")
        with phase("mum"):
            try:
                return find_mum_self(esa, length), False
            except ValueError as e:     # no indexed queries, tiny table
                raise SystemExit(f"vmatch: {e}")
    tables = [_self_direct(esa, opts) if opts["d"] or not opts["p"]
              else MatchTable()]
    if opts["p"]:
        if has_iq:
            raise SystemExit("vmatch: option -p for self comparison does "
                             "not allow queryfiles in the index")
        tables.append(_query_run(
            esa, opts, reverse_complement_inplace(ms),
            FLAGPALINDROMIC | FLAGSELFPALINDROMIC, qsp, "mem"))
    return MatchTable.concat(tables), opts["p"]


def _self_direct(esa: ESA, opts: dict) -> MatchTable:
    """The direct part of ``-l L`` and of its seed extension."""
    ms = esa.multiseq
    has_iq = ms.numofquerysequences > 0
    length = opts["l"]

    def cross_filter(mt: MatchTable) -> MatchTable:
        """CHECKEXCLUSION (fself.c:33-36): on an index with indexed
        queries, keep only self pairs straddling the db/query separator."""
        if not has_iq or len(mt) == 0:
            return mt
        qsep = ms.database_length
        return mt.select((mt.position1 < qsep) & (mt.position2 > qsep))

    xdrop = _xdropscore(opts)
    k_e, k_h = opts["e"], opts["h"]
    if xdrop is not None:
        # x-drop seed extension (fself.c:157-173 -> xdropseedextend); the
        # seeds are maximal pairs of length >= seedlength, 30 by default
        # (matchlenparm.c:4,40-44)
        seedlength = opts["seedlength"] or 30
        seeds = cross_filter(find_maximal_pairs_ref(esa, seedlength))
        count("seeds", len(seeds))
        sq = Seqs(ms.sequence, ms.sequence, esa.dev)
        with phase("x-drop extension"):
            return xdrop_extend_seeds(sq, seeds, xdrop, seedlength,
                                      querycompare=False)
    if k_e is None and k_h is None:
        return cross_filter(find_maximal_pairs_ref(esa, length))
    # approximate repeats: exact seeds + greedy extension (fself.c:95 ->
    # extendgen.c callgenericextend)
    k = k_e if k_e is not None else k_h
    seedlength = max(opts["seedlength"] or 0, length // (k + 1))
    sq = Seqs(ms.sequence, ms.sequence, esa.dev)
    ev = Evalues(1.0 / esa.alpha.num_regular)
    if k_e is not None and not has_iq:
        # fused path: the seeds never leave the device
        mt = edit_extend_self_device(esa, sq, ev, k, length, seedlength,
                                     allmax=opts["allmax"])
        if mt is not None:
            return mt
    seeds = cross_filter(find_maximal_pairs_ref(esa, seedlength))
    if k_e is not None:
        return edit_extend_seeds(sq, ev, seeds, k, length, seedlength,
                                 querycompare=False, selfmode=True,
                                 allmax=opts["allmax"])
    count("seeds", len(seeds))
    with phase("hamming extension"):
        return hamming_extend_seeds(sq, ev, seeds, k, length, seedlength,
                                    querycompare=False,
                                    allmax=opts["allmax"])


def _query_run(esa: ESA, opts: dict, q, flags: int, qsp: int,
               mode: str) -> MatchTable:
    """Matches of the query ``q`` on the index (runquery.c:71-353 ->
    fquery.c findquerymatches): MEMs, MUM candidates or MUMs of length
    ``-l``, or with ``-e``/``-h``/``-exdrop``/``-hxdrop`` the extension
    of the MEM seeds, flagged ``flags``."""
    ms = esa.multiseq
    xdrop = _xdropscore(opts)
    k_e, k_h = opts["e"], opts["h"]
    k = k_e if k_e is not None else k_h
    if xdrop is not None:
        seedlength = opts["seedlength"] or 30
        seeds = find_query_matches(esa, q, seedlength, "mem",
                                   flags_extra=flags, qspeedup=qsp)
        count("seeds", len(seeds))
        sq = Seqs(ms.sequence, q.sequence, esa.dev)
        with phase("x-drop extension"):
            return xdrop_extend_seeds(sq, seeds, xdrop, seedlength,
                                      querycompare=True)
    if k is None:
        return find_query_matches(esa, q, opts["l"], mode,
                                  flags_extra=flags, qspeedup=qsp)
    seedlength = max(opts["seedlength"] or 0, opts["l"] // (k + 1))
    seeds = find_query_matches(esa, q, seedlength, "mem", flags_extra=flags,
                               qspeedup=qsp)
    count("seeds", len(seeds))
    sq = Seqs(ms.sequence, q.sequence, esa.dev)
    ev = Evalues(1.0 / esa.alpha.num_regular)
    if k_e is not None:
        return edit_extend_seeds(sq, ev, seeds, k, opts["l"], seedlength,
                                 querycompare=True, selfmode=False,
                                 allmax=opts["allmax"])
    with phase("hamming extension"):
        return hamming_extend_seeds(sq, ev, seeds, k, opts["l"], seedlength,
                                    querycompare=True, allmax=opts["allmax"])


def _query_matches(esa: ESA, opts: dict, query, qsp: int) -> MatchTable:
    """``-q`` without ``-complete``: all direct matches first, then all
    palindromic ones (``-p`` alone drops the direct ones), or with
    ``-online`` per query sequence against a throwaway index of it."""
    if opts["l"] is None and _xdropscore(opts) is None:
        raise SystemExit("vmatch: task not implemented yet")
    mode = ("mumcand" if opts["mumcand"] else "mum") if opts["mum"] \
        else "mem"
    direct = opts["d"] or not opts["p"]
    if opts["online"]:
        if mode == "mum" and query.numofsequences > 1:
            raise SystemExit(
                "vmatch: options -mum, -q, and -online can only be "
                "combined if there is exactly one sequence in the query "
                "file")
        mt = online_query_matches(
            esa, query, opts["l"] if opts["l"] is not None else 0, mode,
            ev=Evalues(1.0 / esa.alpha.num_regular),
            leastlength=opts["l"] or 0, k_e=opts["e"], k_h=opts["h"],
            xdrop=_xdropscore(opts), seedlength=opts["seedlength"],
            direct=direct, palindromic=opts["p"])
        return _unique_in_query(mt, query) if mode == "mum" else mt
    tables = []
    if direct:
        tables.append(_query_run(esa, opts, query, 0, qsp, mode))
    if opts["p"]:
        tables.append(_query_run(esa, opts, reverse_complement_inplace(query),
                                 FLAGPALINDROMIC, qsp, mode))
    return MatchTable.concat(tables)


def _xdropscore(opts: dict) -> int | None:
    """The x-drop score of ``-exdrop``/``-hxdrop``; the reference stores
    ``-hxdrop`` negated (parsevm.c:974-992)."""
    if opts["exdrop"] is not None:
        return opts["exdrop"]
    if opts["hxdrop"] is not None:
        return -opts["hxdrop"]
    return None


def _complete_matches(esa: ESA, opts: dict, query) -> MatchTable:
    """``-complete [-online] [-e k | -h k]`` of all queries."""
    starts = np.array(
        [query.seq_bounds(i)[0] for i in range(query.numofsequences)],
        np.int64)
    k_e, k_h = opts["e"], opts["h"]

    def run_pats(q, flags):
        ps = [q.sequence[slice(*q.seq_bounds(i))]
              for i in range(q.numofsequences)]
        if opts["online"]:
            kind = ("edit" if k_e is not None
                    else "hamming" if k_h is not None else "exact")
            return online_complete_matches(
                esa, ps, k_e if k_e is not None else (k_h or 0), kind,
                flags_extra=flags, query_starts=starts)
        for k, edit in ((k_e, True), (k_h, False)):
            if k is not None:
                try:
                    return approx_complete_matches(
                        esa, ps, k, edit=edit, flags_extra=flags,
                        query_starts=starts)
                except ValueError as e:  # threshold >= a pattern's length
                    raise SystemExit(f"vmatch: {e}")
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
    return MatchTable.concat(tables)


def matches(esa: ESA, opts: dict, qsp: int):
    """The matches of the task that ``opts`` names, before the funnel:
    (MatchTable, the query Multiseq or None for a self task, whether
    the table holds self-palindromic rows)."""
    if not opts["q"]:
        raw, selfpal = _self_matches(esa, opts, qsp)
        return raw, None, selfpal
    with phase("read queries"):
        query = read_multiseq(opts["q"], esa.alpha, store_original=True)
    if opts["complete"]:
        if opts["l"]:
            raise SystemExit("vmatch: option -l and option -complete "
                             "exclude each other")
        return _complete_matches(esa, opts, query), query, False
    return _query_matches(esa, opts, query, qsp), query, False


def run(argv: list[str], device: torch.device | str, out=None) -> int:
    """Run the task of ``argv`` on ``device``, writing the match rows to
    ``out`` (default stdout)."""
    out = out or sys.stdout
    opts = parse_args(argv)
    qsp = _query_speedup(opts)
    with phase("read index"):
        esa = ESA.read(opts["index"], device)
    ms = esa.multiseq
    ev = Evalues(1.0 / esa.alpha.num_regular)
    mp = MatchParams(leastlength=opts["l"] or 0, identity=0.0,
                     leastscore=None, maxevalue=None, lowergaplength=None,
                     uppergaplength=None)
    if opts["i"] and opts["absolute"]:
        raise SystemExit(
            "vmatch: option -i and option -absolute exclude each other")
    if opts["allmax"] and opts["h"] is None and opts["e"] is None:
        # OPTIONIMPLYEITHER2(OPTALLMAX,OPTHDIST,OPTEDIST)
        raise SystemExit(
            "vmatch: option -allmax requires either option -h or -e")
    showmode = 0
    for flag, bit in (("absolute", SHOWABSOLUTE), ("nodist", SHOWNODIST),
                      ("noevalue", SHOWNOEVALUE), ("noscore", SHOWNOSCORE),
                      ("noidentity", SHOWNOIDENTITY)):
        if opts[flag]:
            showmode |= bit
    print(argument_header(argv[:-1], opts["index"]), file=out)
    digits = assign_virtual_digits(ms)
    raw, query, selfpal = matches(esa, opts, qsp)
    if query is not None:
        assign_query_digits(digits, query)
    count("matches", len(raw))
    if opts["i"]:
        # match-count distribution (vmatcount.c via distri.c): histogram
        # of match lengths, engine output pre-filter, so no funnel runs
        lens = raw.length1
        print(f"# all {lens.size}", file=out)
        for ln in np.unique(lens):
            print(f"# {ln} {int((lens == ln).sum())}", file=out)
        return 0
    with phase("funnel"):
        # the funnel flips palindromic coordinates with the bounds of
        # the query's sequences: the database's own for self-palindromic
        # rows, which are rendered as self matches
        mt = process_final(raw, ms, ev, mp, query=ms if selfpal else query)
        if selfpal:
            # self-palindromic dedup (procfinal.c:159-171): keep only
            # (seq1,rel1) <= (seq2,rel2) after the coordinate flip
            sp = (mt.flag & FLAGSELFPALINDROMIC) != 0
            if sp.any():
                drop = sp & ((mt.seqnum1 > mt.seqnum2)
                             | ((mt.seqnum1 == mt.seqnum2)
                                & (mt.relpos1 > mt.relpos2)))
                mt = mt.select(~drop)
                mt.idnumber = np.arange(len(mt), dtype=np.int64)
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
                "xdropscore": _xdropscore(opts),
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
