"""Match clustering (``matchcluster`` / ``vmatch -pp matchcluster``).

Reference: src/Vmatch/allmclust.c:10 (``genericmatchclustering``),
src/Vmatch/clpos.c (gap/overlap edge enumeration over the
position-sorted mirror array), src/Vmatch/cluedist.c (similarity
edges via threshold unit edit distance), src/Vmatch/matchclust.c
(``domatchclustering``: union-find link + per-cluster ``.match``
files), src/Vmatch/mcldef.h (Matchclustercallinfo / Matchedge).

Matches become graph nodes; an edge links two matches when

- GapMCL: some instance of one starts within ``maxgapsize`` after
  (start + Storelength1) of an instance of the other (clpos.c:72-127;
  the reference always uses length1 for the extent — reproduced),
- OverlapMCL: the instances overlap by >= ``minpercentoverlap``% of
  the longer match's length1 (clpos.c:129-201),
- SimilarityMCL: the matched substrings align within
  ``errorrate``% unit edit distance (cluedist.c:120-198).

Connected components are emitted as ``<outprefix>.<size>.<num>.match``
files with the cluster's members and intra-cluster edges.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ..core.multiseq import Multiseq
from ..engine.match import MatchTable
from ..output.render import Digits, render_matches
from .cluster import ClusterSet

SIMILARITY_MCL = 0
GAP_MCL = 1
OVERLAP_MCL = 2
UNDEF_MCL = 3


@dataclass
class Matchclustercallinfo:
    """reference mcldef.h Matchclustercallinfo."""

    matchclustertype: int = UNDEF_MCL
    errorrate: int = 0
    maxgapsize: int = 0
    minpercentoverlap: int = 0
    outprefix: str | None = None


def default_digits() -> Digits:
    """ASSIGNDEFAULTDIGITS (Vmatch/outinfo.h:93-98)."""
    return Digits(length=5, position1=6, seqnum1=3, position2=6,
                  seqnum2=3)


def _mirror_and_sort(mt: MatchTable) -> tuple[np.ndarray, np.ndarray]:
    """Interleave (Storeposition1, Storeposition2) of every match and
    stable-sort by position (clpos.c:34-51 mirrorandsortmatches; glibc
    qsort is stable mergesort for these sizes, and entry j=2i is
    position1 of match i, j=2i+1 its position2)."""
    m = len(mt)
    start = np.empty(2 * m, np.int64)
    start[0::2] = mt.position1
    start[1::2] = mt.position2
    matchnum = np.repeat(np.arange(m, dtype=np.int64), 2)
    order = np.argsort(start, kind="stable")
    return start[order], matchnum[order]


def gap_edges(mt: MatchTable, maxgapsize: int):
    """GapMCL edges (clpos.c:72-107): for position-sorted instance
    entries i<j, gap = start[j] - (start[i] + length1[matchnum[i]]);
    an unsigned underflow (overlapping instances) exceeds any
    maxgapsize and BREAKS the inner scan — reproduced via the signed
    test."""
    start, matchnum = _mirror_and_sort(mt)
    len1 = np.asarray(mt.length1, np.int64)
    edges: list[tuple[int, int]] = []
    data: list[int] = []
    m2 = start.size
    for i in range(m2 - 1):
        endi = start[i] + len1[matchnum[i]]
        for j in range(i + 1, m2):
            gap = int(start[j] - endi)
            if gap > maxgapsize or gap < 0:
                break
            if matchnum[i] != matchnum[j]:
                edges.append((int(matchnum[i]), int(matchnum[j])))
                data.append(gap)
    return edges, data


def overlap_edges(mt: MatchTable, minpercentoverlap: int):
    """OverlapMCL edges (clpos.c:129-201)."""
    start, matchnum = _mirror_and_sort(mt)
    len1 = np.asarray(mt.length1, np.int64)
    edges: list[tuple[int, int]] = []
    data: list[float] = []
    m2 = start.size
    for i in range(m2 - 1):
        endi = start[i] + len1[matchnum[i]]
        for j in range(i + 1, m2):
            if endi < start[j]:
                break
            if matchnum[i] == matchnum[j]:
                continue
            if len1[matchnum[i]] >= len1[matchnum[j]]:
                longer = len1[matchnum[i]]
            else:
                longer = len1[matchnum[j]]
            overlap = float((endi - start[j]) * 100.0) / float(longer)
            if overlap >= float(minpercentoverlap):
                edges.append((int(matchnum[i]), int(matchnum[j])))
                data.append(overlap)
    return edges, data


def _unit_edist_threshold(u: np.ndarray, v: np.ndarray, maxdist: int,
                          wildmin: int) -> int:
    """Threshold unit edit distance; symbols match only when equal AND
    regular (frontSEP.c:27-38 COMPARESYMBOLS).  Returns the distance
    if <= maxdist, else -1 (unitedistfrontSEPgeneric semantics)."""
    ul, vl = len(u), len(v)
    if maxdist == 0:
        if ul != vl:
            return -1
        if ul and (np.any(u != v) or np.any(u >= wildmin)
                   or np.any(v >= wildmin)):
            return -1
        return 0
    if abs(ul - vl) > maxdist:
        return -1
    # banded DP, band radius maxdist
    INF = maxdist + 1
    prev = np.arange(vl + 1, dtype=np.int64)
    prev[maxdist + 1:] = INF
    for i in range(1, ul + 1):
        cur = np.full(vl + 1, INF, np.int64)
        jlo = max(1, i - maxdist)
        jhi = min(vl, i + maxdist)
        if i - maxdist <= 0:
            cur[0] = i
        a = u[i - 1]
        js = np.arange(jlo, jhi + 1)
        eq = (v[jlo - 1: jhi] == a) & (a < wildmin) \
            & (v[jlo - 1: jhi] < wildmin)
        sub = prev[jlo - 1: jhi] + np.where(eq, 0, 1)
        dele = prev[jlo: jhi + 1] + 1
        cur[jlo: jhi + 1] = np.minimum(sub, dele)
        run = cur[jlo - 1]
        # insertion needs a left-to-right scan
        for j in range(jlo, jhi + 1):
            run = min(cur[j], run + 1)
            cur[j] = run
        prev = cur
        if prev.min() > maxdist:
            return -1
    d = int(prev[vl])
    return d if d <= maxdist else -1


def similarity_edges(mt: MatchTable, ms: Multiseq, errorrate: int,
                     wildmin: int):
    """SimilarityMCL edges (cluedist.c:120-180): all match pairs whose
    substrings (any of the 4 instance pairings, tried in order
    (1,1),(1,2),(2,1),(2,2)) are within maxdist =
    floor(minlen * errorrate / 100) unit edit operations."""
    seq = ms.sequence
    m = len(mt)
    p1 = np.asarray(mt.position1, np.int64)
    p2 = np.asarray(mt.position2, np.int64)
    l1 = np.asarray(mt.length1, np.int64)
    l2 = np.asarray(mt.length2, np.int64)
    minl = np.minimum(l1, l2)
    edges: list[tuple[int, int]] = []
    data: list[tuple[int, int]] = []

    def verify(pa, la, pb, lb, maxdist):
        """verifysmalldistance (cluedist.c:72-106)."""
        if la == lb and pa == pb:
            return 0
        if abs(int(la) - int(lb)) > maxdist:
            return -1
        return _unit_edist_threshold(
            seq[pa: pa + la], seq[pb: pb + lb], maxdist, wildmin)

    for i in range(m):
        leni = int(minl[i])
        for j in range(i + 1, m):
            minlen = min(int(minl[j]), leni)
            maxdist = int(minlen * float(errorrate) / 100.0)
            for pa, la, pb, lb in (
                (p1[i], l1[i], p1[j], l1[j]),
                (p1[i], l1[i], p2[j], l2[j]),
                (p2[i], l2[i], p1[j], l1[j]),
                (p2[i], l2[i], p2[j], l2[j]),
            ):
                ed = verify(int(pa), int(la), int(pb), int(lb), maxdist)
                if ed >= 0:
                    edges.append((i, j))
                    data.append((minlen, ed))
                    break
    return edges, data


def run_matchcluster(
    info: Matchclustercallinfo,
    mt: MatchTable,
    ms: Multiseq,
    query: Multiseq | None,
    mfargs: str,
    showmode_direct: int = 0,
    out=None,
) -> None:
    """genericmatchclustering + domatchclustering (allmclust.c:10,
    matchclust.c:87-128): build edges, single-linkage cluster, write
    one ``.match`` file per cluster (elements then edges) and announce
    each cluster on stdout."""
    out = out or sys.stdout
    wildmin = ms.alpha.num_regular if hasattr(ms, "alpha") else 250
    if info.matchclustertype == SIMILARITY_MCL:
        edges, data = similarity_edges(mt, ms, info.errorrate, wildmin)

        def linkline(d):
            minlen, ed = d
            return (f"edit distance {ed} "
                    f"(error rate {100.0 * ed / minlen:.2f}%)")
    elif info.matchclustertype == GAP_MCL:
        edges, data = gap_edges(mt, info.maxgapsize)

        def linkline(d):
            return f"gapsize {d}"
    elif info.matchclustertype == OVERLAP_MCL:
        edges, data = overlap_edges(mt, info.minpercentoverlap)

        def linkline(d):
            return f"overlap percentage {d:.2f}"
    else:
        raise SystemExit("matchcluster: unknown matchclustertype")

    cs = ClusterSet(len(mt))
    for e1, e2 in edges:
        cs.link(e1, e2)
    print(f"# cluster {len(mt)} matches", file=out)

    digits = default_digits()
    per_edges = cs.cluster_edges(edges)
    for shown, cnum in cs.nonempty_clusters():
        csize = cs.cinfo[cnum][0]
        print(f"# create cluster {shown} of size {csize}", file=out)
        fname = f"{info.outprefix}.{csize}.{shown}.match"
        with open(fname, "w") as fh:
            fh.write(f"# args={mfargs}\n")
            for elem in cs.members(cnum):
                fh.write(f"# id {int(mt.idnumber[elem])}\n")
                for line in render_matches(
                        mt.select(np.array([elem], np.int64)), ms,
                        digits, showmode_direct, query):
                    fh.write(line + "\n")
            for e in per_edges.get(cnum, []):
                i0 = int(mt.idnumber[edges[e][0]])
                i1 = int(mt.idnumber[edges[e][1]])
                fh.write(f"# linked {i0} and {i1} with "
                         f"{linkline(data[e])}\n")
