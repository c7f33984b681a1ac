"""Sequence clustering (``vmatch -dbcluster p1 p2 [prefix (min,max)]
[-nonredundant file]``).

Reference: src/Vmatch/vmcluster.c (``addvmcluster`` :360,
``processvmcluster`` :417, ``sufficientoverlap`` :289) over the
single-linkage ClusterSet of src/kurtz/cluster.c.  Every self match
whose shorter instance covers >= p1% of the shorter sequence and
>= p2% of the larger sequence becomes an edge between the two
database sequences; connected components are reported, optionally
written to per-cluster ``prefix.size.num.match``/``.fna`` files, and
``-nonredundant`` emits one representative (the longest member) per
cluster plus all singlets.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..core.multiseq import Multiseq
from ..engine.match import MatchTable
from ..output.render import render_matches
from .cluster import ClusterSet

DEFAULTLINEWIDTH = 60


@dataclass
class Clusterparms:
    """reference Vmatch/vmcldef.h Clusterparms."""

    percsmall: int = 0
    perclarge: int = 0
    minsize: int = 1
    maxsize: int = 0          # 0 = unbounded (DBCLMAXSIZE)
    prefix: str | None = None
    nonredundantfile: str | None = None


def _seqlen(ms: Multiseq, seqnum: int) -> int:
    s, e = ms.seq_bounds(seqnum)
    return e - s


def _sufficient(matchlength: int, seqlen: int, percentage: int) -> bool:
    """sufficientoverlap (vmcluster.c:289-295) — integer floor."""
    return matchlength >= seqlen * percentage // 100


def _desc(ms: Multiseq, seqnum: int) -> str:
    if ms.descriptions:
        return ms.description(seqnum).decode("latin-1")
    return f"sequence{seqnum}"


def _format_fasta(fh, ms: Multiseq, seqnum: int,
                  linewidth: int = DEFAULTLINEWIDTH) -> None:
    s, e = ms.seq_bounds(seqnum)
    seq = ms.originalsequence if ms.originalsequence is not None \
        else ms.sequence
    body = seq[s:e].tobytes()
    fh.write(">" + _desc(ms, seqnum) + "\n")
    for off in range(0, len(body), linewidth):
        fh.write(body[off: off + linewidth].decode("latin-1") + "\n")


def run_dbcluster(
    ms: Multiseq,
    mt: MatchTable,
    parms: Clusterparms,
    basic_header: str,
    digits,
    showmode: int = 0,
    showdesc_defined: bool = False,
    showstring: int = 0,
    out=None,
) -> None:
    """Cluster the database sequences from the final match batch and
    emit all dbcluster outputs (processvmcluster, vmcluster.c:417)."""
    out = out or sys.stdout
    if ms.numofsequences == 1:
        raise SystemExit(
            "vmatch: option -dbcluster only possible for index with "
            "at least two sequences"
        )
    if ms.numofquerysequences > 0:
        raise SystemExit(
            "vmatch: option -dbcluster requires index without query "
            "sequences"
        )
    cs = ClusterSet(ms.numofsequences)
    edge_elems: list[tuple[int, int]] = []
    edge_match: list[int] = []
    lens = np.array([_seqlen(ms, i) for i in range(ms.numofsequences)],
                    np.int64)
    for i in range(len(mt)):
        s1 = int(mt.seqnum1[i])
        s2 = int(mt.seqnum2[i])
        if s1 == s2:
            continue
        lsmall = int(min(lens[s1], lens[s2]))
        llarge = int(max(lens[s1], lens[s2]))
        mmin = int(min(mt.length1[i], mt.length2[i]))
        if _sufficient(mmin, lsmall, parms.percsmall) and \
                _sufficient(mmin, llarge, parms.perclarge):
            if parms.prefix is not None:
                edge_elems.append((s1, s2))
                edge_match.append(i)
            cs.link(s1, s2)

    for line in cs.size_distribution_lines():
        print(line, file=out)

    maxsize = cs.max_cluster_size()
    with_desc = parms.nonredundantfile is not None or showdesc_defined
    for shown, cnum in cs.nonempty_clusters():
        csize = cs.cinfo[cnum][0]
        if not (0 <= csize <= maxsize):
            continue
        members = cs.members(cnum)
        if with_desc:
            print(f"{shown}:", file=out)
            for m in members:
                pre = f"{m}: " if parms.nonredundantfile is not None \
                    else ""
                print(f"  {pre}{_desc(ms, m)}", file=out)
        else:
            print(f"{shown}: " + "".join(f" {m}" for m in members),
                  file=out)

    if parms.prefix is not None:
        clmax = parms.maxsize if parms.maxsize != 0 else ms.numofsequences
        per_edges = cs.cluster_edges(edge_elems)
        for shown, cnum in cs.nonempty_clusters():
            csize = cs.cinfo[cnum][0]
            if not (parms.minsize <= csize <= clmax):
                continue
            mname = f"{parms.prefix}.{csize}.{shown}.match"
            with open(mname, "w") as fh:
                fh.write(basic_header + "\n")
                idx = [edge_match[e] for e in per_edges.get(cnum, [])]
                for line in render_matches(
                        mt.select(np.array(idx, np.int64)), ms, digits,
                        showmode):
                    fh.write(line + "\n")
            if showstring > 0:
                fname = f"{parms.prefix}.{csize}.{shown}.fna"
                with open(fname, "w") as fh:
                    for m in cs.members(cnum):
                        _format_fasta(fh, ms, m)
        if showstring > 0 and parms.minsize == 1 \
                and parms.nonredundantfile is None:
            with open(f"{parms.prefix}.single.fna", "w") as fh:
                for m in cs.singletons():
                    _format_fasta(fh, ms, m)

    if parms.nonredundantfile is not None:
        with open(parms.nonredundantfile, "w") as fh:
            for shown, cnum in cs.nonempty_clusters():
                members = cs.members(cnum)
                # representative: longest member, earliest on ties
                # (clcmpsequencelength + showClusterSetwithmaxelem)
                rep = members[0]
                for m in members[1:]:
                    if lens[rep] < lens[m]:
                        rep = m
                _format_fasta(fh, ms, rep)
            for m in cs.singletons():
                _format_fasta(fh, ms, m)
