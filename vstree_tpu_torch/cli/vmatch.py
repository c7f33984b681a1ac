"""vmatch-compatible CLI on the port.

Every task and option of :mod:`vstree_tpu.cli.vmatch`:

- whole-query matching (``-complete -q``), exact or approximate with at
  most k mismatches (``-h k``) or k differences (``-e k``), over the
  index or, with ``-online``, by scans of the text (``-complete remred
  -online -e k`` drops the redundant matches); direct and palindromic
  (``-d``/``-p``); a ``vmotif*`` plugin given to ``-complete`` takes the
  search over,
- the self-match tasks on an index without ``-q``: maximal repeats
  (``-l L``), supermaximal repeats (``-supermax -l L``), branching tandem
  repeats (``-tandem -l L``), maximal unique matches between the
  database and the indexed queries (``-mum -l L``), self-palindromic
  matches (``-l L -p``),
- seed extension of the maximal repeats and of the query matches: at
  most k differences or mismatches (``-l L -e k``, ``-l L -h k``,
  ``-allmax``) and the x-drop extensions (``-exdrop x``, ``-hxdrop x``),
  each with ``-seedlength``,
- query matching on the index (``-q`` without ``-complete``): maximal
  exact matches (``-l L -q``), MUM candidates and MUMs (``-mum [cand]``),
  each also ``-online``, with the query speedups 0, 2 and 5
  (``-qspeedup N`` or ``QUERYSPEEDUP``),
- DNA queries on a protein index (``-dnavsprot transnum [symbolmap]``):
  the queries are translated in their six frames, matched, and the rows
  mapped back onto the DNA,
- the filters ``-evalue``, ``-identity``, ``-leastscore`` and the gap
  bounds of ``-l``, ``-best`` with ``-sort``, a selection module
  (``-selfun``), the show-mode flags ``-absolute -nodist -noevalue
  -noscore -noidentity -f -showdesc``, alignments and XML (``-s``), the
  length histogram ``-i``, and the outputs that replace the rows: the
  regions without a match and the masked sequences (``-dbnomatch``,
  ``-qnomatch``, ``-dbmaskmatch``, ``-qmaskmatch``), database clusters
  (``-dbcluster``, ``-nonredundant``), chains and match clusters
  (``-pp chain``, ``-pp matchcluster``).

Stdout is byte-identical to the JAX CLI's.  ``-numproc N`` splits the
rank range over N of the devices that :func:`run` is given (every CUDA
card, from :func:`main`): ``-supermax`` and exact ``-complete`` run their
rank-sharded programs (parallel/shardesa.py), every other task runs as
without it.  Malformed numbers exit with one ``vmatch:`` line where the
JAX CLI shows a traceback.

Usage: python -m vstree_tpu_torch.cli.vmatch -complete [-e 1] -q q.fna idx
       python -m vstree_tpu_torch.cli.vmatch [-mum [cand]] -l 20 -q q.fna idx
       python -m vstree_tpu_torch.cli.vmatch -complete -dnavsprot 1 -q q.fna pidx
       python -m vstree_tpu_torch.cli.vmatch [-supermax] -l 20 idx
       python -m vstree_tpu_torch.cli.vmatch -l 30 -e 2 [-allmax] idx
       python -m vstree_tpu_torch.cli.vmatch -l 20 -best 50 -sort ia idx
(needs a CUDA device; :func:`run` and :func:`entry` take the device
explicitly).  The environment: QUERYSPEEDUP (0, 2 or 5), VMATCHSHOWTIMESPACE
(on: print ``# TIME`` and ``# SPACE`` in place of the rows), VSTREE_PROFILE
(a directory: a torch.profiler trace of the run), VSTREE_DEBUG_NANS (on/off).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import re
import resource
import sys
import time

import numpy as np
import torch

from ..core.alphabet import dna_alphabet, read_symbolmap
from ..core.codon import (
    check_transnum,
    six_frame_translate,
    sixframe_convert_match,
)
from ..core.envconf import check_env_on_off
from ..core.multiseq import read_multiseq, reverse_complement_inplace
from ..core.optdesc import Constraints
from ..engine.funnel import MatchParams, SelectionHooks, process_final
from ..engine.match import (
    FLAGPALINDROMIC,
    FLAGPPRIGHTREVERSE,
    FLAGSELFPALINDROMIC,
    MatchTable,
)
from ..engine.vplugin import VpluginData, is_vplugin_arg, run_vplugin
from ..output import align as _al
from ..output.render import (
    SHOWABSOLUTE,
    SHOWFILE,
    SHOWNODIST,
    SHOWNOEVALUE,
    SHOWNOIDENTITY,
    SHOWNOSCORE,
    argument_header,
    assign_query_digits,
    assign_virtual_digits,
    basic_args,
    format_description,
    render_matches,
)
from ..output.xml import xml_header, xml_init, xml_match, xml_wrap
from ..postprocess.chain import vmatch_chaining
from ..postprocess.dbcluster import Clusterparms, run_dbcluster
from ..postprocess.mask import (
    Markfields,
    init_marktable,
    mark_matches,
    show_masked_seq,
    show_nomatch,
)
from ..postprocess.matchcluster import run_matchcluster
from ..postprocess.select import SORTMODES, remove_contained, sort_matches
from ..stats.evalues import Evalues
from .chain2dim import parse_chain_args
from .matchcluster import parse_matchcluster_args

from ..device import count, cuda_device, cuda_devices, phase
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

_FLAGS = ("online", "p", "d", "absolute", "nodist", "noevalue", "noscore",
          "noidentity", "supermax", "tandem", "i", "v", "allmax", "f")
_NUMBERS = ("e", "h", "exdrop", "hxdrop", "seedlength", "numproc", "best")

_S_KEYWORDS = {
    "leftseq": _al.SHOWPURELEFTSEQ,
    "rightseq": _al.SHOWPURERIGHTSEQ,
    "abbrev": _al.SHOWALIGNABBREV,
    "abbreviub": _al.SHOWALIGNABBREVIUB,
    "xml": _al.SHOWVMATCHXML,
}

_KEEPFLAGS = (
    "keepleft", "keepright", "keepleftifsamesequence",
    "keeprightifsamesequence",
)


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
    if arg in _S_KEYWORDS:
        return _S_KEYWORDS[arg]
    raise SystemExit(
        f'vmatch: incorrect argument "{arg}" to option -s '
        "must be one of the following keywords: "
        "leftseq, rightseq, abbrev, abbreviub")


def _number(argv: list[str], i: int, kind=int, nonnegative: bool = False,
            option: str | None = None):
    """The number ``argv[i + 1]`` that follows the option ``argv[i]``
    (or names ``option``), or one ``vmatch:`` line when it is missing or
    malformed (the JAX CLI exits with a traceback there, fault F4).  The
    last argument is the index, never a number."""
    arg = argv[i + 1] if i + 1 < len(argv) - 1 else ""
    try:
        if kind is int and not (arg.isascii()
                                and arg.lstrip("-").isdigit()):
            raise ValueError
        value = kind(arg)
        if nonnegative and value < 0:
            raise ValueError
        return value
    except ValueError:
        what = ("a number" if kind is float else
                "a non-negative integer" if nonnegative else "an integer")
        raise SystemExit(f'vmatch: argument "{arg}" of option '
                         f"{option or argv[i]} must be {what}")


def parse_args(argv: list[str]) -> dict:
    """Parse the options as :func:`vstree_tpu.cli.vmatch.parse_args`
    parses them; the last argument is the index.  Malformed numbers exit
    with one ``vmatch:`` line, and ``-best`` needs its number."""
    opts: dict = {"index": None, "q": [], "s": None, "l": None,
                  "mumcand": False, "qspeedup": None, "complete": False,
                  "mum": False, "removeredundant": False, "vplugin": None,
                  "evalue": None, "identity": None,
                  "leastscore": None, "lowergap": None, "uppergap": None,
                  "sort": None, "showdesc": None, "selfun": None,
                  "dnavsprot": None, "dnavsprot_smap": None}
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
        if key == "dnavsprot":
            # -dnavsprot transnum [symbolmap] (parsevm.c:1284-1298)
            if i + 1 >= len(argv):
                raise SystemExit(
                    "vmatch: missing argument for option -dnavsprot")
            opts["dnavsprot"] = _number(argv, i)
            i += 2
            try:
                check_transnum(opts["dnavsprot"])
            except ValueError as e:
                raise SystemExit(f"vmatch: {e}")
            if i < len(argv) - 1 and not argv[i].startswith("-"):
                opts["dnavsprot_smap"] = argv[i]
                i += 1
            continue
        if key == "q":
            i += 1
            while (i < len(argv) - 1 and not argv[i].startswith("-")):
                opts["q"].append(argv[i])
                i += 1
            continue
        if key == "complete":
            # optional argument (parsevm.c:1140-1178): the keyword
            # "remred" or a vmotif*/cpridx* plugin
            opts["complete"] = True
            i += 1
            if i < len(argv) - 1 and not argv[i].startswith("-"):
                arg = argv[i]
                if arg == "remred":
                    opts["removeredundant"] = True
                    i += 1
                elif is_vplugin_arg(arg):
                    opts["vplugin"] = arg
                    i += 1
                elif "." not in arg and arg != opts["index"]:
                    raise SystemExit(
                        'vmatch: argument to option -complete must be '
                        'either the keyword "remred" or names of '
                        'shared object files with prefix "vmotif" or '
                        '"cpridxps"')
            continue
        if key in _FLAGS:
            opts[key] = True
            i += 1
            continue
        if key == "mum":
            opts["mum"] = True
            if i + 1 < len(argv) and argv[i + 1] == "cand":
                opts["mumcand"] = True
                i += 1
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
            # optional numeric argument, then optional lower/upper gap
            # bounds (parselowerupperbounds, parsevm.c:536-585)
            opts["l"] = 0
            if i + 1 < len(argv) and _is_number(argv[i + 1]):
                opts["l"] = int(argv[i + 1])
                i += 1
            if i + 1 < len(argv) - 1 and _is_number(argv[i + 1]):
                i += 1
                lower = int(argv[i])
                if lower < 0 and -lower > opts["l"]:
                    raise SystemExit(
                        "vmatch: if second argument is negative, the "
                        "absolute value must not be larger than the "
                        "user defined leastlength")
                opts["lowergap"] = lower
                if i + 1 < len(argv) - 1 and _is_number(argv[i + 1]):
                    i += 1
                    upper = int(argv[i])
                    if upper < lower:
                        raise SystemExit(
                            f'vmatch: optional second argument "{upper}" '
                            "of option -l must be greater or equal than "
                            f'first argument "{lower}"')
                    opts["uppergap"] = upper
            i += 1
            continue
        if key in _NUMBERS:
            # -best needs its number: the JAX CLI takes a missing one as 0
            # and prints no match at all (fault F4)
            opts[key] = _number(argv, i, nonnegative=True)
            i += 2
            continue
        if key in ("leastscore", "identity"):
            opts[key] = _number(argv, i)
            i += 2
            continue
        if key == "evalue":
            opts["evalue"] = _number(argv, i, float)
            i += 2
            continue
        if key in ("dbnomatch", "qnomatch"):
            # -dbnomatch/-qnomatch N [keepflag] (parsevm.c:1023-1045)
            opts["nomatch"] = _number(argv, i)
            i += 2
            opts["nomatch_markdb"] = key == "dbnomatch"
            if (key == "dbnomatch" and i < len(argv) - 1
                    and argv[i] in _KEEPFLAGS):
                opts["nomatch_keep"] = argv[i]
                i += 1
            continue
        if key in ("dbmaskmatch", "qmaskmatch"):
            # -dbmaskmatch/-qmaskmatch <char>|tolower|toupper [keepflag]
            # (parsevm.c:1046-1074)
            if i + 1 >= len(argv):
                raise SystemExit(f"vmatch: missing argument for option {a}")
            arg = argv[i + 1]
            i += 2
            if arg not in ("tolower", "toupper") and len(arg) != 1:
                raise SystemExit(
                    f'vmatch: illegal argument "{arg}" to option '
                    f"-{key}: must be single character or the "
                    'keywords "toupper" or "tolower"')
            opts["maskchar"] = arg
            opts["mask_markdb"] = key == "dbmaskmatch"
            if (key == "dbmaskmatch" and i < len(argv) - 1
                    and argv[i] in _KEEPFLAGS):
                opts["mask_keep"] = argv[i]
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
        if key == "pp":
            i = _parse_pp(argv, i, opts)
            continue
        if key == "dbcluster":
            i = _parse_dbcluster(argv, i, opts)
            continue
        if key == "nonredundant":
            i += 1
            if i >= len(argv) - 1 or argv[i].startswith("-"):
                raise SystemExit(
                    "vmatch: missing argument for option -nonredundant")
            opts["nonredundant"] = argv[i]
            i += 1
            continue
        if key == "showdesc":
            i = _parse_showdesc(argv, i, opts)
            continue
        if key == "selfun":
            # -selfun <module.py> [args...]: a Python selection-function
            # module with the hooks of select.h:41-50
            if i + 1 >= len(argv) - 1:
                raise SystemExit(
                    "vmatch: missing argument for option -selfun")
            opts["selfun"] = argv[i + 1]
            i += 2
            sargs = []
            while i < len(argv) - 1 and not argv[i].startswith("-"):
                sargs.append(argv[i])
                i += 1
            opts["selfun_args"] = sargs
            continue
        if key == "sort":
            if (i + 1 < len(argv) - 1 and not argv[i + 1].startswith("-")):
                opts["sort"] = argv[i + 1]
                i += 1
            else:
                opts["sort"] = ""
            i += 1
            continue
        _refuse_excluded(key)
        raise SystemExit(f"vmatch: illegal option {a}")
    if opts["index"] is None:
        raise SystemExit("vmatch: the last argument must be the index name")
    _parse_constraints(opts)
    return opts


def _refuse_excluded(key: str) -> None:
    """The JAX CLI's refusals of what the reference builds without
    (its messages, vstree_tpu/cli/vmatch.py:383-405)."""
    if key in ("dbms", "mysql"):
        # compile-gated VMATCHDB SQL export (Vmatch/vmdbfunc.c, OFF in
        # the shipped Makefile, Vmatch/Makefile:3-4)
        raise SystemExit(
            "vmatch: option -dbms is not supported: the database "
            "export is compile-gated OFF in the reference "
            "(VMATCHDB, Vmatch/Makefile:3-4) and deliberately "
            "excluded here; see the capability matrix in README")
    if key in ("regexp", "agrep"):
        # WITHREGEXP / WITHAGREP need external automata libraries
        # (fcomplete.c:17-24) and are OFF in the shipped build
        raise SystemExit(
            f"vmatch: option -{key} is not supported: it needs "
            "the external libautomata build (fcomplete.c:17-24, "
            "OFF in the shipped reference); deliberately excluded "
            "here; see the capability matrix in README")
    if key in ("pssm", "vplugin", "vmotif", "cpridx"):
        # vendored lib-homann PSSM search / the vplugin ABI
        raise SystemExit(
            f"vmatch: option -{key} is not supported: the "
            "PSSM/vplugin search ships as vendored tarballs in "
            "the reference (lib-homann/) and is deliberately "
            "excluded here; see the capability matrix in README")


def _parse_pp(argv: list[str], i: int, opts: dict) -> int:
    """-pp chain|matchcluster <operands...> (parsepp.c:123-186): the
    operands run until the next option or the index; known sub-option
    keywords get a "-" prefix (filltransformedargs, parsepp.c:32-94).
    Returns the index of the next argument."""
    j = i + 1
    ops: list[str] = []
    while j < len(argv) - 1 and not argv[j].startswith("-"):
        ops.append(argv[j])
        j += 1
    if not ops:
        raise SystemExit("vmatch: missing argument for option -pp")
    ppmode, rest = ops[0], ops[1:]
    if ppmode == "chain":
        kw = ("global", "local", "maxgap", "outprefix", "silent",
              "thread", "wf", "withinborders")
        targs = [("-" + a if a in kw else a) for a in rest]
        opts["pp_chain"] = parse_chain_args(targs + ["dummyindex"])[0]
    elif ppmode == "matchcluster":
        kw = ("erate", "gapsize", "overlap", "outprefix")
        targs = [("-" + a if a in kw else a) for a in rest]
        opts["pp_mcl"] = parse_matchcluster_args(targs, fromvmatch=True)[0]
    else:
        raise SystemExit(f'vmatch: illegal postprocessing mode "{ppmode}"')
    return j


def _parse_dbcluster(argv: list[str], i: int, opts: dict) -> int:
    """-dbcluster p1 p2 [prefix [(min,max)]] (parsedbcl.c:16-75).
    Returns the index of the next argument."""
    parms = Clusterparms()
    for which in ("first", "second"):
        i += 1
        if i >= len(argv) or argv[i].startswith("-"):
            raise SystemExit(
                "vmatch: missing argument for option -dbcluster")
        v = _number(argv, i - 1, option="-dbcluster")
        if v < 0 or v > 100:
            raise SystemExit(
                f"vmatch: {which} argument to option -dbcluster must be "
                "integer in range [0,100]")
        if which == "first":
            parms.percsmall = v
        else:
            parms.perclarge = v
    if i + 1 < len(argv) - 1 and not argv[i + 1].startswith("-"):
        i += 1
        if argv[i].startswith("("):
            raise SystemExit(
                "vmatch: the specification of minimal and maximal "
                "cluster sizes requires the specification of a file "
                "prefix as third argument")
        parms.prefix = argv[i]
        if i + 1 < len(argv) - 1 and not argv[i + 1].startswith("-"):
            i += 1
            m = re.fullmatch(r"\((\d+),(\d+)\)", argv[i])
            if not m:
                raise SystemExit(
                    f'vmatch: incorrect fourth argument "{argv[i]}" to '
                    "option -dbcluster: cluster size specification must "
                    "be of the form (dbclminsize,dbclmaxsize)")
            parms.minsize = int(m.group(1))
            parms.maxsize = int(m.group(2))
            if parms.minsize < 1:
                raise SystemExit(
                    "vmatch: first number in clustersize specification "
                    "must not be < 1")
            if parms.maxsize != 0 and parms.maxsize < parms.minsize:
                raise SystemExit(
                    "vmatch: second number in clustersize specification "
                    "must not be smaller than first number")
    opts["dbcluster"] = parms
    return i + 1


def _parse_showdesc(argv: list[str], i: int, opts: dict) -> int:
    """parsedescparameters (parsevm.c:587-620): maxlength or
    (skipprefix,maxlength).  Returns the index of the next argument."""
    if i + 1 >= len(argv) - 1:
        raise SystemExit("vmatch: missing argument for option -showdesc")
    arg = argv[i + 1]
    sd = {"skipprefix": 0, "maxlength": 0, "untilfirstblank": False,
          "replaceblanks": True}
    m = re.fullmatch(r"\((\d+),(\d+)\)", arg)
    if m:
        sd["skipprefix"] = int(m.group(1))
        sd["maxlength"] = int(m.group(2))
    elif re.fullmatch(r"\d+", arg):
        sd["maxlength"] = int(arg)
    else:
        raise SystemExit(
            f'vmatch: incorrect argument "{arg}" to option -showdesc: '
            "must be either single number or pair (skipprefix,maxlength) "
            "of non-negative integers")
    if sd["maxlength"] == 0:
        sd["untilfirstblank"] = True
    opts["showdesc"] = sd
    return i + 2


def _parse_constraints(opts: dict) -> None:
    """The declarative parse-time constraints (core/optdesc.py, the
    reference's OPTIONEXCLUDE/IMPLY discipline, procopt.c:505-583)."""
    c = Constraints("vmatch")
    # -complete remred (parsevm.c:1433-1454); "complete" stands for its
    # remred argument so that the message names -complete
    c.imply("complete", "online", argument="remred")
    if (opts["removeredundant"] and opts["online"]
            and opts["e"] is None and opts["h"] is None):
        raise SystemExit('vmatch: argument "remred" of option -complete '
                         "requires options -e or -h")

    def isset(name):
        if name == "complete":
            return bool(opts["removeredundant"])
        v = opts.get(name)
        if v is None or isinstance(v, (bool, list, str)):
            return bool(v)
        return True    # numeric option present
    c.check(isset)


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


def _self_matches(esa: ESA, opts: dict, qsp: int,
                  mesh=None) -> tuple[MatchTable, bool]:
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
                if task == "supermax":
                    return find_supermax(esa, length, mesh=mesh), False
                return find_tandems_ref(esa, length), False
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
    if length is None and _xdropscore(opts) is None:
        raise SystemExit("vmatch: task not implemented yet")
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


def _rm_redundant(mt: MatchTable) -> MatchTable:
    """-complete remred (edistcompl.c:20-66 CHECKMATCHPOSITION): the
    right-to-left scan keeps a single candidate; a match one position
    left of the candidate replaces it only on a strictly better distance
    (else it is consumed); any other match emits the candidate and
    starts anew."""
    if len(mt) == 0:
        return mt
    order = np.lexsort((-mt.position1, mt.seqnum2, mt.flag))
    keep = np.zeros(len(mt), bool)
    cand = None
    cand_pos = cand_d = 0
    prev_key = None
    for oi in order:
        keyg = (int(mt.flag[oi]), int(mt.seqnum2[oi]))
        p = int(mt.position1[oi])
        d = abs(int(mt.distance[oi]))
        if cand is not None and keyg == prev_key and p + 1 == cand_pos:
            if d < cand_d:
                cand, cand_pos, cand_d = oi, p, d
        else:
            if cand is not None:
                keep[cand] = True
            cand, cand_pos, cand_d = oi, p, d
        prev_key = keyg
    if cand is not None:
        keep[cand] = True
    return mt.select(keep)


def _complete_matches(esa: ESA, opts: dict, query,
                      mesh=None) -> MatchTable:
    """``-complete [-online] [-e k | -h k]`` of all queries, with the
    redundant matches of ``-complete remred -online -e k`` removed."""
    starts = np.array(
        [query.seq_bounds(i)[0] for i in range(query.numofsequences)],
        np.int64)
    k_e, k_h = opts["e"], opts["h"]
    remred = opts["removeredundant"] and opts["online"] and k_e is not None

    def run_pats(q, flags):
        ps = [q.sequence[slice(*q.seq_bounds(i))]
              for i in range(q.numofsequences)]
        if opts["online"]:
            kind = ("edit" if k_e is not None
                    else "hamming" if k_h is not None else "exact")
            mt = online_complete_matches(
                esa, ps, k_e if k_e is not None else (k_h or 0), kind,
                flags_extra=flags, query_starts=starts)
            return _rm_redundant(mt) if remred else mt
        for k, edit in ((k_e, True), (k_h, False)):
            if k is not None:
                try:
                    return approx_complete_matches(
                        esa, ps, k, edit=edit, flags_extra=flags,
                        query_starts=starts)
                except ValueError as e:  # threshold >= a pattern's length
                    raise SystemExit(f"vmatch: {e}")
        return exact_complete_matches(esa, ps, flags_extra=flags,
                                      query_starts=starts, mesh=mesh)

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


def _read_queries(esa: ESA, opts: dict):
    """(the queries as matched, the queries as read): with ``-dnavsprot``
    the DNA queries are read with a DNA symbol map and translated in
    their six frames into the index's alphabet (procmatch.c:440-462)."""
    if opts["dnavsprot"] is None:
        query = read_multiseq(opts["q"], esa.alpha, store_original=True)
        return query, query
    if opts["supermax"] or opts["tandem"] or opts.get("dbcluster"):
        raise SystemExit(
            "vmatch: option -dnavsprot excludes self-match tasks")
    dna_alpha = (read_symbolmap(opts["dnavsprot_smap"])
                 if opts["dnavsprot_smap"] else dna_alphabet())
    dnaquery = read_multiseq(opts["q"], dna_alpha, store_original=True)
    with phase("six-frame translation"):
        return six_frame_translate(dnaquery, esa.alpha,
                                   opts["dnavsprot"]), dnaquery


def _dnavsprot_convert(mt: MatchTable, dnaquery, transnum: int):
    """dnavsprotfromsixframetooriginalquery (procfinal.c:262-289): the
    coordinates in the translated frames back onto the DNA query."""
    if len(mt) == 0:
        return mt
    dseq, rel, abspos, dlen, rev = sixframe_convert_match(
        dnaquery, mt.seqnum2, mt.relpos2, mt.length2)
    mt.seqnum2 = dseq
    mt.relpos2 = rel
    mt.position2 = abspos
    mt.length2 = dlen
    mt.transnum = np.full(len(mt), transnum, np.int64)
    mt.flag = mt.flag | np.where(rev, FLAGPPRIGHTREVERSE, 0)
    return mt


def matches(esa: ESA, opts: dict, qsp: int, mesh=None):
    """The matches of the task that ``opts`` names, before the funnel:
    (MatchTable, the query Multiseq that the funnel and the renderer
    take or None for a self task, whether the table holds
    self-palindromic rows, the query Multiseq as read).  With
    ``-dnavsprot`` the rows are mapped back onto the DNA queries, except
    those of ``-online`` (as in the JAX CLI).  ``mesh`` (``-numproc``)
    reaches ``-supermax`` and exact ``-complete``."""
    if not opts["q"]:
        raw, selfpal = _self_matches(esa, opts, qsp, mesh)
        return raw, None, selfpal, None
    with phase("read queries"):
        query, read = _read_queries(esa, opts)
    if opts["complete"]:
        if opts["l"]:
            raise SystemExit("vmatch: option -l and option -complete "
                             "exclude each other")
        raw = _complete_matches(esa, opts, query, mesh)
    elif opts["online"]:
        return _query_matches(esa, opts, query, qsp), query, False, read
    else:
        raw = _query_matches(esa, opts, query, qsp)
    if read is not query:
        with phase("back-mapping"):
            raw = _dnavsprot_convert(raw, read, opts["dnavsprot"])
    return raw, read, False, read


def _selection_hooks(opts: dict, argv: list[str], esa: ESA):
    """The hooks of the ``-selfun`` module (the Python analog of the
    dlopen selection-function plugin, Vmatch/opensel.c +
    include/select.h:41-50), after its header and init hooks ran."""
    if opts["selfun"] is None:
        return None
    spec = importlib.util.spec_from_file_location("vmatch_selfun",
                                                  opts["selfun"])
    if spec is None or spec.loader is None:
        raise SystemExit(
            f"vmatch: cannot load selection module {opts['selfun']!r}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    hooks = SelectionHooks(
        header=getattr(module, "selectmatch_header", None),
        init=getattr(module, "selectmatch_init", None),
        match=getattr(module, "selectmatch", None),
        wrap=getattr(module, "selectmatch_wrap", None),
        final_table=getattr(module, "selectmatch_finaltable", None))
    if hooks.header is not None:
        hooks.header(argv, opts.get("selfun_args", []))
    if hooks.init is not None:
        hooks.init(esa.alpha, esa.multiseq, None)
    return hooks


def _check_exclusions(opts: dict) -> None:
    """The exclusions the JAX CLI checks after reading the index."""
    if opts["i"] and opts["absolute"]:
        raise SystemExit(
            "vmatch: option -i and option -absolute exclude each other")
    if opts["allmax"] and opts["best"] is not None:
        raise SystemExit(
            "vmatch: option -allmax and option -best exclude each other")
    if opts["allmax"] and opts["sort"] is not None:
        raise SystemExit(
            "vmatch: option -sort and option -allmax exclude each other")
    if opts["allmax"] and opts["h"] is None and opts["e"] is None:
        # OPTIONIMPLYEITHER2(OPTALLMAX,OPTHDIST,OPTEDIST)
        raise SystemExit(
            "vmatch: option -allmax requires either option -h or -e")


def _mark_and_emit(opts: dict, esa: ESA, mt: MatchTable, query,
                   out) -> None:
    """The -dbnomatch/-qnomatch/-dbmaskmatch/-qmaskmatch output
    (initpost.c:25-269, markmat.c, nomatch.c, showmasked.c)."""
    ms = esa.multiseq
    nomatch = opts.get("nomatch")
    mf = Markfields(markdb=opts.get(
        "nomatch_markdb" if nomatch is not None else "mask_markdb", True))
    keep = opts.get("nomatch_keep" if nomatch is not None else "mask_keep")
    if keep:
        mf.parse_keepflag(
            keep, "-dbnomatch" if nomatch is not None else "-dbmaskmatch")
    selfmatch = not opts["q"]
    has_iq2 = ms.numofquerysequences > 0
    # the DATABASELENGTH macro subtracts the separator slot
    # unconditionally (multidef.h:91-92)
    dblen_ref = ms.totallength - ms.totalquerylength - 1
    if selfmatch:
        if not mf.markdb and not has_iq2:
            which = "-qnomatch" if nomatch is not None else "-qmaskmatch"
            raise SystemExit(
                f"vmatch: option {which} requires index containing "
                "query sequences or option -q")
        msmark = ms
    else:
        msmark = ms if (opts["complete"] or mf.markdb) else query
    bits = init_marktable(msmark)
    mark_matches(bits, mt, mf, has_no_query_files=selfmatch,
                 vms_has_indexed_queries=has_iq2,
                 database_length=dblen_ref)
    if nomatch is not None:
        if selfmatch:
            if mf.markdb:
                posoffset, length = 0, dblen_ref
            else:
                posoffset = dblen_ref + 1
                length = ms.totalquerylength
            msref = ms
        else:
            msref = msmark
            posoffset, length = 0, msref.totallength
        show_nomatch(bits, msref, posoffset, length, nomatch,
                     absolute=opts["absolute"], out=out)
    elif mf.markdb:
        show_masked_seq(ms, bits, opts["maskchar"], out=out)
    else:
        if selfmatch:
            raise SystemExit("vmatch: maskmatch for query sequence in "
                             "index not implemented")
        chars = (bytes(esa.alpha.characters)
                 if msmark.originalsequence is None else None)
        show_masked_seq(msmark, bits, opts["maskchar"], characters=chars,
                        out=out)


def _postprocess(opts: dict, argv: list[str], esa: ESA, digits,
                 showmode: int, mt: MatchTable, query, out) -> bool:
    """The outputs that replace the match rows: masking and no-match
    regions, database clusters, chains and match clusters.  Returns
    whether one of them ran."""
    ms = esa.multiseq
    header = argument_header(basic_args(argv[:-1]), opts["index"])
    if opts.get("nomatch") is not None or opts.get("maskchar") is not None:
        _mark_and_emit(opts, esa, mt, query, out)
    elif opts.get("dbcluster") is not None:
        parms = opts["dbcluster"]
        parms.nonredundantfile = opts.get("nonredundant")
        run_dbcluster(ms, mt, parms, basic_header=header, digits=digits,
                      showmode=showmode,
                      showdesc_defined=opts["showdesc"] is not None,
                      showstring=opts["s"] or 0, out=out)
    elif opts.get("pp_chain") is not None:
        def emit_rows(sub, fh):
            for line in render_matches(sub, ms, digits, showmode, query):
                fh.write(line + "\n")

        vmatch_chaining(mt, opts["pp_chain"], header, emit_rows, out)
    elif opts.get("pp_mcl") is not None:
        run_matchcluster(opts["pp_mcl"], mt, ms, query,
                         header[len("# args="):], out=out)
    else:
        return False
    return True


def _select_best(opts: dict, mt: MatchTable) -> MatchTable:
    """-best k (bestmatch.c cmpBestMatch order: E-value ascending,
    length1 descending, position1 ascending, length2 descending,
    position2 ascending, direct before palindromic), then with -sort the
    contained matches removed and the rows sorted (procfinal.c:720-735;
    mode "ia" keeps the order of the removal)."""
    pal = ((mt.flag & FLAGPALINDROMIC) != 0).astype(np.int64)
    order = np.lexsort((pal, mt.position2, -mt.length2, mt.position1,
                        -mt.length1, mt.evalue))
    mt = mt.select(order[:opts["best"]])
    if opts["sort"] is not None:
        if opts["sort"] not in SORTMODES:
            raise SystemExit(f"vmatch: illegal sort mode {opts['sort']!r}")
        mt, _ = remove_contained(mt)
        if opts["sort"] != "ia":
            mt = sort_matches(mt, opts["sort"])
    return mt


def _row(mt: MatchTable, k: int, xdrop) -> dict:
    """Row ``k`` of ``mt`` as the alignment renderers take it."""
    return {"position1": int(mt.position1[k]), "length1": int(mt.length1[k]),
            "position2": int(mt.position2[k]), "length2": int(mt.length2[k]),
            "distance": int(mt.distance[k]), "flag": int(mt.flag[k]),
            "relpos1": int(mt.relpos1[k]), "relpos2": int(mt.relpos2[k]),
            "xdropscore": xdrop}


def _render_xml(opts: dict, esa: ESA, mt: MatchTable, query, out) -> None:
    """-s xml (xmlfunc.c + echomatch.c:1036-1045)."""
    ms = esa.multiseq
    xml_init(esa.alpha, ms, query, out)
    modes = mt.mode_chars()
    scores = mt.score
    idents = mt.identity
    sd = opts["showdesc"]
    if sd is not None:
        sd = dict(sd, replaceblanks=False)
    for k in range(len(mt)):
        row = _row(mt, k, _xdropscore(opts))
        row.update(seqnum1=int(mt.seqnum1[k]), seqnum2=int(mt.seqnum2[k]),
                   evalue=float(mt.evalue[k]), score=int(scores[k]),
                   identity=float(idents[k]),
                   idnumber=int(mt.idnumber[k]))
        eops = _al.alignment_eops(row, ms, query)
        d1 = d2 = None
        if sd is not None:
            d1 = format_description(ms, row["seqnum1"], sd)
            d2 = format_description(query if query is not None else ms,
                                    row["seqnum2"], sd)
        xml_match(row, modes[k], eops, out, d1, d2)
    xml_wrap(out)


def _finish(opts: dict, argv: list[str], esa: ESA, digits, showmode: int,
            hooks, mt: MatchTable, query, raw: MatchTable, out) -> int:
    """Everything after the funnel, in the order of the JAX CLI's
    ``finish``: the postprocessing outputs, the length histogram (-i),
    -best/-sort, the selection module's final table, then the rows as
    XML, with alignments (-s) or plain."""
    ms = esa.multiseq
    if _postprocess(opts, argv, esa, digits, showmode, mt, query, out):
        return 0
    if opts["i"]:
        # match-count distribution (vmatcount.c via distri.c): histogram
        # of the lengths of the engine's output, before the funnel
        lens = raw.length1
        print(f"# all {lens.size}", file=out)
        for ln in np.unique(lens):
            print(f"# {ln} {int((lens == ln).sum())}", file=out)
        return 0
    if opts["best"] is not None:
        mt = _select_best(opts, mt)
    if hooks is not None and hooks.final_table is not None:
        mt = hooks.final_table(mt) or mt
    if opts["s"] is not None and opts["s"] & _al.SHOWVMATCHXML:
        _render_xml(opts, esa, mt, query, out)
        return 0
    with phase("render"):
        lines = render_matches(mt, ms, digits, showmode, query,
                               showdesc=opts["showdesc"])
        if hooks is not None and hooks.wrap is not None:
            hooks.wrap(esa.alpha, ms, query)
        if opts["s"] is None:
            for line in lines:
                print(line, file=out)
            return 0
        # echomatch2file with showstring > 0 (echomatch.c:1036-1086):
        # row, newline, alignment text, newline
        for k, line in enumerate(lines):
            out.write(line + "\n")
            out.write(_al.echo_string_output(_row(mt, k, _xdropscore(opts)),
                                             ms, query, opts["s"]))
            out.write("\n")
    return 0


def _vplugin(opts: dict, esa: ESA, process) -> int:
    """The vplugin takeover (vplugin-interface.h:37-52 analog): the
    plugin owns the whole search, with or without -q, and hands its
    tables to ``process(table, query)``."""
    vquery = (read_multiseq(opts["q"], esa.alpha, store_original=True)
              if opts["q"] else None)
    data = VpluginData(
        progname="vmatch", indexname=opts["index"], esa=esa,
        queryfiles=list(opts["q"]), query=vquery,
        forceonline=bool(opts["online"]),
        plugin_args=list(opts.get("selfun_args") or []),
        process=lambda mt: process(mt, vquery))
    run_vplugin(opts["vplugin"], data)
    return 0


def run(argv: list[str], device: torch.device | str, out=None,
        devices: list | None = None) -> int:
    """Run the task of ``argv`` on ``device``, writing the match rows to
    ``out`` (default stdout); ``-numproc N`` takes the first N of
    ``devices`` (default: ``device`` alone), which may name one device
    several times."""
    out = out or sys.stdout
    opts = parse_args(argv)
    qsp = _query_speedup(opts)
    with phase("read index"):
        esa = ESA.read(opts["index"], device)
    # -numproc N (parsevm.c:877, vdfstrav.c:419-499 DISTRIBUTEDDFS):
    # distribute the rank range over N devices of a mesh
    mesh = None
    if opts["numproc"] and opts["numproc"] > 1:
        from ..parallel.shardesa import numproc_mesh

        mesh = numproc_mesh(opts["numproc"],
                            [device] if devices is None else devices)
    ms = esa.multiseq
    ev = Evalues(1.0 / esa.alpha.num_regular)
    mp = MatchParams(leastlength=opts["l"] or 0,
                     identity=opts["identity"] or 0.0,
                     leastscore=opts["leastscore"],
                     maxevalue=opts["evalue"],
                     lowergaplength=opts["lowergap"],
                     uppergaplength=opts["uppergap"])
    _check_exclusions(opts)
    showmode = 0
    for flag, bit in (("absolute", SHOWABSOLUTE), ("f", SHOWFILE),
                      ("nodist", SHOWNODIST), ("noevalue", SHOWNOEVALUE),
                      ("noscore", SHOWNOSCORE),
                      ("noidentity", SHOWNOIDENTITY)):
        if opts[flag]:
            showmode |= bit
    hooks = _selection_hooks(opts, argv, esa)
    if opts.get("maskchar") is None:
        # masking replaces the whole output, the argument header
        # included (initpost.c markermaskmatchout)
        if opts["s"] is not None and opts["s"] & _al.SHOWVMATCHXML:
            xml_header(argv, out)
        else:
            print(argument_header(argv[:-1], opts["index"]), file=out)
    digits = assign_virtual_digits(ms)
    if opts["sort"] is not None and opts["best"] is None:
        raise SystemExit("vmatch: option -sort requires option -best")
    if (opts.get("nonredundant") is not None
            and opts.get("dbcluster") is None):
        raise SystemExit(
            "vmatch: option -nonredundant requires option -dbcluster")

    def funnel_and_finish(raw, query, selfpal=False):
        count("matches", len(raw))
        with phase("funnel"):
            # the funnel flips palindromic coordinates with the bounds
            # of the query's sequences: the database's own for
            # self-palindromic rows, which are rendered as self matches
            mt = process_final(raw, ms, ev, mp,
                               query=ms if selfpal else query,
                               selection=hooks)
            if selfpal:
                # self-palindromic dedup (procfinal.c:159-171): keep
                # only (seq1,rel1) <= (seq2,rel2) after the flip
                sp = (mt.flag & FLAGSELFPALINDROMIC) != 0
                if sp.any():
                    drop = sp & ((mt.seqnum1 > mt.seqnum2)
                                 | ((mt.seqnum1 == mt.seqnum2)
                                    & (mt.relpos1 > mt.relpos2)))
                    mt = mt.select(~drop)
                    mt.idnumber = np.arange(len(mt), dtype=np.int64)
        return _finish(opts, argv, esa, digits, showmode, hooks, mt, query,
                       raw, out)

    if opts["complete"] and opts["vplugin"] is not None:
        return _vplugin(opts, esa, funnel_and_finish)
    raw, query, selfpal, read = matches(esa, opts, qsp, mesh)
    if read is not None:
        assign_query_digits(digits, read)
    return funnel_and_finish(raw, query, selfpal)


def _check_queryspeedup() -> None:
    """The JAX CLI's front check of QUERYSPEEDUP, before :func:`run` and
    its own check (:func:`_query_speedup`): its accepted set and its
    messages."""
    env = os.environ.get("QUERYSPEEDUP")
    if env is None:
        return
    try:
        qs = int(env)
    except ValueError:
        raise SystemExit(
            "vmatch: incorrect value of environment variable "
            "QUERYSPEEDUP; must be non-negative integer")
    if qs == 1:
        raise SystemExit(
            "vmatch: Algorithm 1 is no longer available, please use "
            "Algorithm 0, or 2; we recommend Algorithm 2")
    if qs not in (0, 2, 3, 4, 5):
        raise SystemExit(f"vmatch: illegal speedup value {qs}")


def entry(argv: list[str], device, devices) -> None:
    """What ``python -m vstree_tpu_torch.cli.vmatch`` does, in the order
    of the JAX CLI's ``main``: the QUERYSPEEDUP check, the on/off checks
    of VMATCHSHOWTIMESPACE and VSTREE_DEBUG_NANS, then :func:`run` on
    ``device()`` with ``devices()`` for ``-numproc``.  The two are
    called only after the checks, so a malformed variable is reported
    before the card is requested.  Exits with run's code.

    VMATCHSHOWTIMESPACE=on is the reference's timing mode
    (vmatch.mn.c:44-52,91-96): the rows are swallowed, and the process
    time and peak resident size are printed at the end.
    VSTREE_PROFILE=<dir> traces the run with torch.profiler (the card's
    kernels and copies too) into ``<dir>/vmatch.<ns>.pt.trace.json``,
    which TensorBoard and Perfetto read.  VSTREE_DEBUG_NANS=on checks
    nothing more: no floating-point tensor leaves the device (the one
    the port makes, ``repeats_dev._triangular_decode``'s estimate, is
    clamped before its square root and turned into integers there)."""
    _check_queryspeedup()
    showtimespace = check_env_on_off("VMATCHSHOWTIMESPACE")
    profile_dir = os.environ.get("VSTREE_PROFILE")
    check_env_on_off("VSTREE_DEBUG_NANS")
    dev, devs = device(), devices()
    tracer = contextlib.nullcontext()
    if profile_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(dev).type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        tracer = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                profile_dir, worker_name="vmatch"))
    try:
        t0 = time.process_time()
        with tracer:
            rc = run(argv, dev, out=io.StringIO() if showtimespace else None,
                     devices=devs)
        if showtimespace:
            peak = resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1024.0
            print(f"# TIME vmatch {time.process_time() - t0:.2f}")
            print(f"# SPACE vmatch {peak:.2f}")
        sys.exit(rc)
    except BrokenPipeError:  # e.g. piped into head
        sys.exit(0)


def main() -> None:
    entry(sys.argv[1:], cuda_device, cuda_devices)


if __name__ == "__main__":
    main()
