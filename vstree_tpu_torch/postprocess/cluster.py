"""Single-linkage cluster set with reference-faithful ordering.

Reference: src/kurtz/cluster.c (``linkcluster`` cluster.c:518,
``addClusterEdge`` cluster.c:586, ``showClusterSet`` cluster.c:125,
``clusterSizedistribution`` cluster.c:638).  The display order of
clusters and of elements within a cluster is load-bearing for output
parity: clusters are numbered in creation order, members are kept in
an append-ordered linked list, and merging splices the smaller
cluster's list after the larger one's.
"""

from __future__ import annotations

NIL = -1


class ClusterSet:
    """Union of element clusters over ``n`` elements with
    linkcluster's exact linked-list semantics."""

    def __init__(self, n: int):
        self.n = n
        self.clusternumber = [NIL] * n
        self.nextelem = [NIL] * n
        self.incluster = [False] * n
        # per cluster slot: [csize, firstelem, lastelem, startedges]
        self.cinfo: list[list[int]] = []
        self.numofedges = 0
        # edge bookkeeping for addClusterEdge semantics
        self._edges: list[tuple[int, int, int]] = []

    # -- linkcluster (cluster.c:518-580) --

    def link(self, e1: int, e2: int) -> None:
        self.numofedges += 1
        if not self.incluster[e1]:
            if not self.incluster[e2]:
                cnum = len(self.cinfo)
                self.cinfo.append([2, e1, e2, 1])
                self.clusternumber[e1] = cnum
                self.clusternumber[e2] = cnum
                self.nextelem[e1] = e2
                self.nextelem[e2] = NIL
                self.incluster[e2] = True
            else:
                self._append(self.clusternumber[e2], e1)
            self.incluster[e1] = True
        else:
            c1 = self.clusternumber[e1]
            if not self.incluster[e2]:
                self._append(c1, e2)
                self.incluster[e2] = True
            else:
                c2 = self.clusternumber[e2]
                if c1 == c2:
                    self.cinfo[c1][3] += 1
                else:
                    if self.cinfo[c1][0] > self.cinfo[c2][0]:
                        target, source = c1, c2
                    else:
                        target, source = c2, c1
                    self._merge(target, source)

    def _append(self, cnum: int, elem: int) -> None:
        self.clusternumber[elem] = cnum
        self.nextelem[elem] = NIL
        self.nextelem[self.cinfo[cnum][2]] = elem
        self.cinfo[cnum][2] = elem
        self.cinfo[cnum][3] += 1
        self.cinfo[cnum][0] += 1

    def _merge(self, target: int, source: int) -> None:
        # relabel source members, splice its list after target's
        j = self.cinfo[source][1]
        while j != NIL:
            self.clusternumber[j] = target
            j = self.nextelem[j]
        self.nextelem[self.cinfo[target][2]] = self.cinfo[source][1]
        self.cinfo[source][1] = NIL
        self.cinfo[target][2] = self.cinfo[source][2]
        self.cinfo[target][0] += self.cinfo[source][0]
        self.cinfo[target][3] += self.cinfo[source][3] + 1
        self.cinfo[source][0] = 0
        self.cinfo[source][3] = 0

    # -- traversal --

    def members(self, cnum: int) -> list[int]:
        out = []
        j = self.cinfo[cnum][1]
        while j != NIL:
            out.append(j)
            j = self.nextelem[j]
        return out

    def nonempty_clusters(self):
        """(display_number, slot) pairs in creation order — display
        numbers count only nonempty slots (showClusterSet
        cluster.c:137-196)."""
        shown = 0
        for cnum, info in enumerate(self.cinfo):
            if info[0] > 0:
                yield shown, cnum
                shown += 1

    def singletons(self) -> list[int]:
        return [i for i in range(self.n) if not self.incluster[i]]

    def max_cluster_size(self) -> int:
        return max((info[0] for info in self.cinfo), default=0)

    # -- edge grouping (addClusterEdge cluster.c:586-620: edges are
    # written back-to-front per cluster, so each cluster's edge list
    # comes out in reverse insertion order) --

    def cluster_edges(self, edge_elems: list[tuple[int, int]]):
        """Map cluster slot -> edge indexes in the order showClusterSet
        would emit them."""
        per: dict[int, list[int]] = {}
        for idx, (e1, e2) in enumerate(edge_elems):
            per.setdefault(self.clusternumber[e1], []).append(idx)
        return {c: list(reversed(v)) for c, v in per.items()}

    # -- clusterSizedistribution (cluster.c:638-688) --

    def size_distribution_lines(self) -> list[str]:
        csum = 0
        dist: dict[int, int] = {}
        nonempty = 0
        for info in self.cinfo:
            csum += info[0]
            if info[0] >= 2:
                nonempty += 1
                dist[info[0]] = dist.get(info[0], 0) + 1
        total = self.n
        singlets = total - csum
        lines = [
            f"# {nonempty} cluster{'' if nonempty == 1 else 's'}",
            f"# {csum} elements out of {total} "
            f"({100.0 * csum / total:.2f}%) are in clusters",
            f"# {singlets} elements out of {total} "
            f"({100.0 * singlets / total:.2f}%) are singlets",
        ]
        for size in sorted(dist):
            cnt = dist[size]
            lines.append(
                f"# {cnt} cluster{'s' if cnt > 1 else ''} "
                f"of size {size}"
            )
        return lines
