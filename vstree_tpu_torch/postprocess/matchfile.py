"""Match-file parsing: read vmatch output back into a MatchTable.

Reference: src/Vmatch/detmatch.c (``analyzeargline`` re-parses the
``# args=`` header through the vmatch option parser to recover the
index, query files and show mode; ``analyzematchline`` scans the data
rows according to that show mode).  Used by vmatchselect, chain2dim,
matchcluster and ``vmatch -f``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..core.multiseq import Multiseq, read_multiseq
from ..engine.match import (
    FLAGPALINDROMIC,
    FLAGPPLEFTREVERSE,
    FLAGPPRIGHTREVERSE,
    FLAGQUERY,
    FLAGSCOREMATCH,
    FLAGSELFPALINDROMIC,
    MatchTable,
)
from ..index.esa import ESA
from ..index.io import read_index
from ..output.render import (
    SHOWABSOLUTE,
    SHOWNODIST,
    SHOWNOEVALUE,
    SHOWNOIDENTITY,
    SHOWNOSCORE,
)

ARGLINE_PREFIX = "# args="


@dataclass
class MatchFile:
    args: list[str]          # original vmatch arguments (incl. index)
    argline: str             # the verbatim "# args=..." line
    esa: ESA
    query: Multiseq | None
    showmode: int
    table: MatchTable
    has_query: bool


def _showmode_from_args(opts: dict) -> int:
    m = 0
    if opts.get("absolute"):
        m |= SHOWABSOLUTE
    if opts.get("nodist"):
        m |= SHOWNODIST
    if opts.get("noevalue"):
        m |= SHOWNOEVALUE
    if opts.get("noscore"):
        m |= SHOWNOSCORE
    if opts.get("noidentity"):
        m |= SHOWNOIDENTITY
    return m


_SELF_FLAGS = {
    "D": 0,
    "P": FLAGPALINDROMIC | FLAGSELFPALINDROMIC,
    "F": 0,
    "H": FLAGPPRIGHTREVERSE,
    "I": FLAGPPLEFTREVERSE,
    "G": FLAGPPLEFTREVERSE | FLAGPPRIGHTREVERSE,
}
_QUERY_FLAGS = {
    "D": FLAGQUERY,
    "P": FLAGQUERY | FLAGPALINDROMIC,
    "F": FLAGQUERY,
    "H": FLAGQUERY | FLAGPPRIGHTREVERSE,
    "I": FLAGQUERY | FLAGPPLEFTREVERSE,
    "G": FLAGQUERY | FLAGPPLEFTREVERSE | FLAGPPRIGHTREVERSE,
}


def read_match_file(path: str) -> MatchFile:
    """Parse a vmatch match file (header + rows)."""
    from ..cli.vmatch import parse_args

    argline = None
    rows: list[list[str]] = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith("#"):
                if line.startswith(ARGLINE_PREFIX) and argline is None:
                    argline = line
                continue
            if line.strip():
                rows.append(line.split())

    if argline is None:
        raise ValueError(f"{path}: no '{ARGLINE_PREFIX}' header line")
    args = argline[len(ARGLINE_PREFIX):].split()
    opts = parse_args(args)
    showmode = _showmode_from_args(opts)

    esa = read_index(opts["index"])
    query = None
    if opts["q"]:
        query = read_multiseq(opts["q"], esa.alpha, store_original=True)
    has_query = bool(opts["q"])
    flagmap = _QUERY_FLAGS if has_query else _SELF_FLAGS
    ms2 = query if has_query else esa.multiseq

    n = len(rows)
    mt = MatchTable(**{
        a: (np.zeros(n, np.float64) if a == "evalue"
            else np.zeros(n, np.int64))
        for a in MatchTable.ARRAYS
    })
    mt.transnum = np.full(n, -1, np.int64)

    for i, tok in enumerate(rows):
        it = iter(tok)
        mt.length1[i] = int(next(it))
        if showmode & SHOWABSOLUTE:
            mt.position1[i] = int(next(it))
            s, r = esa.multiseq.pos_to_pair(
                np.array([mt.position1[i]]))
            mt.seqnum1[i], mt.relpos1[i] = int(s[0]), int(r[0])
        else:
            mt.seqnum1[i] = int(next(it))
            mt.relpos1[i] = int(next(it))
            a, _ = esa.multiseq.seq_bounds(int(mt.seqnum1[i]))
            mt.position1[i] = a + mt.relpos1[i]
        mode = next(it)
        mt.flag[i] = flagmap[mode]
        mt.length2[i] = int(next(it))
        if showmode & SHOWABSOLUTE:
            mt.position2[i] = int(next(it))
            s, r = ms2.pos_to_pair(np.array([mt.position2[i]]))
            mt.seqnum2[i], mt.relpos2[i] = int(s[0]), int(r[0])
        else:
            mt.seqnum2[i] = int(next(it))
            mt.relpos2[i] = int(next(it))
            a, _ = ms2.seq_bounds(int(mt.seqnum2[i]))
            mt.position2[i] = a + mt.relpos2[i]
        if not (showmode & SHOWNODIST):
            mt.distance[i] = int(next(it))
        if not (showmode & SHOWNOEVALUE):
            mt.evalue[i] = float(next(it))
        if not (showmode & SHOWNOSCORE):
            next(it)   # score is derived
        if not (showmode & SHOWNOIDENTITY):
            ident = float(next(it))
            if ident == 0.0:
                mt.flag[i] |= FLAGSCOREMATCH
        mt.idnumber[i] = i

    return MatchFile(
        args=args, argline=argline, esa=esa, query=query,
        showmode=showmode, table=mt, has_query=has_query,
    )
