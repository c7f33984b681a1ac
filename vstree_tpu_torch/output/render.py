"""Match output rendering — byte-compatible with vmatch.

Reproduces the reference's row format exactly (stdout is compared
byte by byte with the reference vmatch's):

- row layout:    echomatch.c:878-979 (vmatchnormaloutmatch,
  echomatchpart1/2, echopospair)
- column widths: Vmatch/assigndig.c (length digits by DATABASELENGTH
  thresholds; position/seqnum digits = 1+floor(log10(...)))
- score/identity algebra: include/match.h:78-140
- header line:   Vmatch/procargs.c:32-83 (`# args=...` with
  absolutized index path unless VMATCHRELATIVEINDEXPATH)
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np

from ..core.multiseq import Multiseq
from ..engine.match import FLAGQUERY, MatchTable

# showmode bits (reference include/outinfo.h / select.h)
SHOWABSOLUTE = 1 << 0
SHOWNODIST = 1 << 1
SHOWNOEVALUE = 1 << 2
SHOWNOSCORE = 1 << 3
SHOWNOIDENTITY = 1 << 4
SHOWFILE = 1 << 5


@dataclass
class Digits:
    """Column widths (reference outinfo.h Digits / assigndig.c)."""

    length: int = 2
    position1: int = 1
    seqnum1: int = 1
    position2: int = 1
    seqnum2: int = 1


def assign_virtual_digits(ms: Multiseq) -> Digits:
    """assignvirtualdigits (assigndig.c:5-37)."""
    dblen = max(ms.database_length, 1)
    d = Digits()
    if dblen < 1000:
        d.length = 2
    elif dblen < 10000:
        d.length = 3
    elif dblen < 100000:
        d.length = 4
    else:
        d.length = 5
    d.position1 = 1 + int(math.log10(dblen))
    d.seqnum1 = 1 + int(math.log10(max(ms.num_db_sequences, 1)))
    d.position2 = d.position1
    d.seqnum2 = d.seqnum1
    return d


def assign_query_digits(d: Digits, query: Multiseq) -> None:
    """assignquerydigits (assigndig.c:39-45)."""
    d.position2 = 1 + int(math.log10(max(query.totallength, 1)))
    d.seqnum2 = 1 + int(math.log10(max(query.numofsequences, 1)))


def argument_header(
    args: list[str], index_path: str, out=None
) -> str:
    """`# args=` line (procargs.c savethearguments + showargumentline).
    ``args`` excludes the trailing index name."""
    pieces = "".join(a + " " for a in args)
    if not os.environ.get("VMATCHRELATIVEINDEXPATH"):
        if not index_path.startswith("/"):
            index_path = os.path.join(os.getcwd(), index_path)
    return "# args=" + pieces + index_path


_BASIC_SKIP = (
    "-s", "-sort", "-selfun", "-best", "-dbcluster", "-qspeedup",
    "-pp", "-nonredundant",
)


def basic_args(args: list[str]) -> list[str]:
    """Strip display/postprocessing options and their operands from an
    argument vector (SKIPSOMEARGS, procargs.c:14-29) — used for the
    `# args=` header of derived match files."""
    out: list[str] = []
    i = 0
    while i < len(args):
        if args[i] in _BASIC_SKIP:
            i += 1
            while i < len(args) and not args[i].startswith("-"):
                i += 1
            continue
        out.append(args[i])
        i += 1
    return out


def format_evalue(v: float) -> str:
    """`%.2e` with the extra-space quirk (echomatch.c:955-960):
    values >= 1e-99 or == 0 get a leading space (their exponent
    prints with 2 digits instead of 3)."""
    s = f"{v:.2e}"
    if v >= 1.0e-99 or v == 0.0:
        return " " + "   " + s
    return "   " + s


def format_description(ms: Multiseq, seqnum: int, sd: dict) -> str:
    """echothedescription (multiseq-adv.c:1462-1501): skipprefix /
    maxlength window, blanks replaced by underscores or truncating."""
    desc = ms.description(seqnum)
    if desc is None or not ms.descriptions:
        return f"sequence{seqnum}"
    ln = len(desc)
    if sd["maxlength"] > 0 and sd["maxlength"] + sd["skipprefix"] < ln:
        ln = sd["maxlength"] + sd["skipprefix"]
    out = []
    for ch in desc[sd["skipprefix"]:ln]:
        c = chr(ch)
        if c.isspace():
            if sd["untilfirstblank"]:
                break
            out.append("_" if sd["replaceblanks"] else c)
        else:
            out.append(c)
    return "".join(out)


def render_matches(
    mt: MatchTable,
    ms: Multiseq,
    digits: Digits,
    showmode: int = 0,
    query: Multiseq | None = None,
    showdesc: dict | None = None,
) -> list[str]:
    """Render match rows (vmatchnormaloutmatch)."""
    lines = []
    modes = mt.mode_chars()
    scores = mt.score
    idents = mt.identity
    for i in range(len(mt)):
        parts = []
        # part 1: length1 + (seqnum1, relpos1) or absolute position1
        parts.append(f"{mt.length1[i]:>{digits.length}}")
        if showmode & SHOWFILE:
            fnum = _filenum(ms, int(mt.position1[i]))
            parts.append(f" {ms.filenames[fnum]}")
        if showmode & SHOWABSOLUTE:
            parts.append(f" {mt.position1[i]:>{digits.position1}}")
        elif showdesc is not None:
            # echopospair (echomatch.c:86-111): "   " + description
            # (unpadded) + " %*lu" relpos
            parts.append(
                "   " + format_description(ms, int(mt.seqnum1[i]),
                                           showdesc)
                + f" {mt.relpos1[i]:>{digits.position1}}"
            )
        else:
            parts.append(
                f"    {mt.seqnum1[i]:>{digits.seqnum1}}"
                f" {mt.relpos1[i]:>{digits.position1}}"
            )
        parts.append(f"   {modes[i]} ")
        # part 2
        parts.append(f"{mt.length2[i]:>{digits.length}}")
        is_query = bool(mt.flag[i] & FLAGQUERY)
        ms2 = query if (is_query and query is not None) else ms
        if showmode & SHOWFILE:
            offset = 0
            if not is_query and ms.numofquerysequences > 0:
                offset = ms.database_length + 1
            fnum = _filenum(ms2, offset + int(mt.position2[i]))
            parts.append(f" {ms2.filenames[fnum]}")
        if showmode & SHOWABSOLUTE:
            parts.append(f" {mt.position2[i]:>{digits.position2}}")
        elif showdesc is not None:
            # descindex rebase for self matches on indexed queries
            # (echomatch.c:206-216)
            if is_query and query is not None:
                dms, didx = query, int(mt.seqnum2[i])
            elif ms.numofquerysequences > 0:
                dms = ms
                didx = int(mt.seqnum2[i]) + ms.num_db_sequences
            else:
                dms, didx = ms, int(mt.seqnum2[i])
            parts.append(
                "   " + format_description(dms, didx, showdesc)
                + f" {mt.relpos2[i]:>{digits.position2}}"
            )
        else:
            parts.append(
                f"    {mt.seqnum2[i]:>{digits.seqnum2}}"
                f" {mt.relpos2[i]:>{digits.position2}}"
            )
        if not (showmode & SHOWNODIST):
            parts.append(f" {mt.distance[i]:>3}")
        if not (showmode & SHOWNOEVALUE):
            parts.append(format_evalue(float(mt.evalue[i])))
        if not (showmode & SHOWNOSCORE):
            parts.append(f" {scores[i]:>{digits.length + 1}}")
        if not (showmode & SHOWNOIDENTITY):
            ident = idents[i]
            prefix = " " if ident < 100.0 else ""
            parts.append(f"{prefix}   {ident:.2f}")
        lines.append("".join(parts))
    return lines


def _filenum(ms: Multiseq, position: int) -> int:
    """getfilenum: which input file covers the absolute position."""
    total = 0
    for i in range(len(ms.filenames)):
        sep = ms.filesep[i]
        if sep == 0xFFFFFFFF or position <= sep:
            return i
    return len(ms.filenames) - 1
