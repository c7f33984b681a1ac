"""Shards of the ESA over several devices, and the collectives between
them (port of :mod:`vstree_tpu.parallel.mesh`).

Reference seams (SURVEY.md §2.7): the C code's only parallel hooks are
(1) ``DISTRIBUTEDDFS`` superbucket partitioning of the suffix-rank
range (reference include/vdfstrav.c:419-499, ``-numproc``) and (2) the
per-query independence of the matching loops (fquery.c:470-477).

A :class:`Mesh` is a 2-D grid of shards with the JAX package's axes

- ``sp`` (sequence/rank parallel): ``suftab`` is split into contiguous
  rank ranges, the superbucket split by equal rank counts.  Every shard
  answers "which of my ranks match?" on its own; the answers merge with
  :func:`psum` / :func:`pmin`.
- ``dp`` (data parallel): the query batch is split; nothing moves along
  this axis but the results.

The text is replicated (one byte a symbol; shards read arbitrary
windows of it).  Each shard lives on a ``torch.device`` of its own, and
a device may repeat: four shards on one card run the same shard programs
and collectives as four cards would.

A shard program is written once, over the shards of this process
(``mesh.local``), as a list of tensors, one per local shard; it sees only
its shard and the replicated text, and the only traffic between shards
is the collective functions below.  Where every shard lives in this
process (:class:`LocalComm`), a collective copies tensors between the
shards' devices; where each rank of a ``torch.distributed`` group holds
one shard (:mod:`vstree_tpu_torch.parallel.distributed`), it is the
group's ``all_gather`` / ``all_reduce`` / ``all_to_all_single``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.chardef import WILDCARD
from ..device import cuda_devices

_SPECIAL = 1 << 20
_I64 = torch.int64


class LocalComm:
    """Transport of a mesh whose shards all live in this process: a
    collective copies each shard's tensor to the devices of the shards
    that receive it.  ``moved`` counts the elements that shards received
    from other shards."""

    def __init__(self):
        self.moved = 0

    def local_shards(self, size: int) -> list[int]:
        return list(range(size))

    def gather(self, mesh: "Mesh", xs: list, members: list) -> list:
        return [torch.stack([xs[j].to(mesh.device(i)) for j in members[p]])
                for p, i in enumerate(mesh.local)]

    def reduce(self, mesh: "Mesh", xs: list, members: list,
               op: str) -> list:
        stacked = self.gather(mesh, xs, members)
        return [s.sum(0) if op == "sum" else s.amin(0) for s in stacked]

    def exchange(self, mesh: "Mesh", chunks: list) -> list:
        return [[chunks[s][d].to(mesh.device(d)) for s in range(mesh.size)]
                for d in mesh.local]

    def collect(self, mesh: "Mesh", xs: list) -> np.ndarray:
        return np.concatenate([x.cpu().numpy() for x in xs])


class Mesh:
    """A grid of shards with named axes, the counterpart of a
    ``jax.sharding.Mesh``: ``devices`` is an object array of
    ``torch.device`` in the grid's shape (a device may repeat),
    ``shape`` maps each axis name to its size, ``local`` lists the flat
    indices (row-major) of the shards this process runs, and ``comm``
    moves tensors between shards."""

    def __init__(self, devices: np.ndarray, axis_names: tuple,
                 comm=None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))
        self.comm = comm if comm is not None else LocalComm()
        self.local = self.comm.local_shards(int(devices.size))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, i: int) -> torch.device:
        return self.devices.flat[i]

    def coords(self, i: int) -> dict:
        """Axis name -> index of flat shard ``i``."""
        return dict(zip(self.axis_names,
                        np.unravel_index(i, self.devices.shape)))

    def groups(self, axis: str) -> list[list[int]]:
        """The shards that a collective over ``axis`` joins, as lists of
        flat indices in axis order."""
        ax = self.axis_names.index(axis)
        idx = np.moveaxis(np.arange(self.size).reshape(self.devices.shape),
                          ax, -1)
        return idx.reshape(-1, self.shape[axis]).tolist()

    def members(self, axis: str) -> list[list[int]]:
        """Per local shard, its group along ``axis``."""
        of = {i: g for g in self.groups(axis) for i in g}
        return [of[i] for i in self.local]

    def replicate(self, arr) -> list:
        """A host array (or tensor) on every local shard's device, one
        copy per distinct device."""
        copies: dict = {}
        out = []
        for i in self.local:
            dev = self.device(i)
            if dev not in copies:
                copies[dev] = torch.as_tensor(arr).to(dev)
            out.append(copies[dev])
        return out


def make_mesh(devices=None, dp: int | None = None) -> Mesh:
    """(dp, sp) mesh over the given devices, in this process.  Without a
    list it takes every CUDA card, and raises without one; a list may
    name one device several times."""
    if devices is None:
        devices = cuda_devices()
    devs = np.empty(len(devices), dtype=object)
    devs[:] = [torch.device(d) for d in devices]
    n = devs.size
    if dp is None:
        dp = 2 if n % 2 == 0 and n >= 4 else 1
    sp = n // dp
    return Mesh(devs[: dp * sp].reshape(dp, sp), ("dp", "sp"))


# ---------------------------------------------------------------------------
# collectives: lists with one tensor per local shard in, the same out
# ---------------------------------------------------------------------------


def all_gather(mesh: Mesh, xs: list, axis: str) -> list:
    """Per local shard, ``xs`` of every shard of its group along
    ``axis`` stacked in axis order, on its own device
    (``lax.all_gather``)."""
    members = mesh.members(axis)
    mesh.comm.moved += sum(x.numel() * (len(g) - 1)
                           for x, g in zip(xs, members))
    return mesh.comm.gather(mesh, xs, members)


def psum(mesh: Mesh, xs: list, axis: str) -> list:
    """Elementwise sum over the group along ``axis`` (``lax.psum``)."""
    members = mesh.members(axis)
    mesh.comm.moved += sum(x.numel() * (len(g) - 1)
                           for x, g in zip(xs, members))
    return mesh.comm.reduce(mesh, xs, members, "sum")


def pmin(mesh: Mesh, xs: list, axis: str) -> list:
    """Elementwise minimum over the group along ``axis``
    (``lax.pmin``)."""
    members = mesh.members(axis)
    mesh.comm.moved += sum(x.numel() * (len(g) - 1)
                           for x, g in zip(xs, members))
    return mesh.comm.reduce(mesh, xs, members, "min")


def all_to_all(mesh: Mesh, chunks: list) -> list:
    """``chunks[p][d]`` (1-D, any length) goes from local shard ``p`` to
    flat shard ``d``; returns, per local shard, what every flat shard
    sent it, in flat order."""
    recv = mesh.comm.exchange(mesh, chunks)
    mesh.comm.moved += sum(r.numel() for p, i in enumerate(mesh.local)
                           for s, r in enumerate(recv[p]) if s != i)
    return recv


def ppermute(mesh: Mesh, xs: list, perm: list) -> list:
    """``xs`` of shard ``a`` goes to shard ``b`` for each pair ``(a, b)``
    of ``perm``; a shard that receives nothing gets zeros
    (``lax.ppermute``)."""
    dest = dict(perm)
    empty = [x[:0] for x in xs]
    chunks = [[x if dest.get(i) == d else e for d in range(mesh.size)]
              for x, e, i in zip(xs, empty, mesh.local)]
    src = {b: a for a, b in perm}
    recv = all_to_all(mesh, chunks)
    return [r[src[i]] if i in src else torch.zeros_like(x)
            for r, x, i in zip(recv, xs, mesh.local)]


def collect(mesh: Mesh, xs: list) -> np.ndarray:
    """The per-shard 1-D tensors of every shard (any lengths),
    concatenated in flat order, as a host array in every process."""
    return mesh.comm.collect(mesh, xs)


# ---------------------------------------------------------------------------
# the rank-sharded binary search
# ---------------------------------------------------------------------------


def _suffix_cmp(text, n, spos, pat, plen, maxplen):
    """Vectorized lexicographic relation sign(suffix_prefix - pattern)
    over the first ``plen`` pattern chars (same key scheme as
    engine/complete.py: past-end < regular < special-by-position).
    ``text`` holds at least one byte past ``n``."""
    offs = torch.arange(maxplen, dtype=_I64, device=text.device)
    idx = spos[:, None] + offs[None, :]
    inb = idx < n
    ch = text[idx.clamp(max=n)].to(_I64)
    # past-end == the sentinel: greater than every regular symbol and
    # ordered by position, exactly like other specials
    skey = torch.where(inb & (ch < WILDCARD), ch, _SPECIAL + idx)
    active = offs[None, :] < plen[:, None]
    diff = torch.where(active, skey - pat, 0)
    nz = diff != 0
    first = nz.to(torch.uint8).argmax(1)
    d = diff.gather(1, first[:, None])[:, 0]
    return torch.where(nz.any(1), torch.sign(d), 0)


def _local_interval(text, suf_shard, patterns, plens, n, maxplen, nloc):
    """[lo, hi) bracket of pattern occurrences within one rank shard:
    two binary searches of a fixed number of steps.  A closed bracket
    still probes (at a clamped rank) and keeps its bounds."""
    nsteps = max(1, int(np.ceil(np.log2(max(nloc, 2)))) + 1)

    def search(upper: bool):
        lo = torch.zeros_like(plens)
        hi = torch.full_like(plens, nloc)
        for _ in range(nsteps):
            open_ = lo < hi
            mid = (lo + hi) // 2
            rel = _suffix_cmp(text, n, suf_shard[mid.clamp(max=nloc - 1)],
                              patterns, plens, maxplen)
            right = (rel <= 0) if upper else (rel < 0)
            lo = torch.where(open_ & right, mid + 1, lo)
            hi = torch.where(open_ & ~right, mid, hi)
        return lo

    return search(False), search(True)


def _host_or_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def _lookup_shards(mesh: Mesh, text, suftab, patterns, plens):
    """The shard program of the rank-sharded lookup: per local shard,
    the bracket of its ``dp`` block of patterns in its ``sp`` block of
    ranks.  Returns (lo, hi, cnt, base, suf) per local shard."""
    n = int(text.shape[0])
    R = int(suftab.shape[0])
    maxplen = int(patterns.shape[1])
    sp, dp = mesh.shape["sp"], mesh.shape["dp"]
    nloc = R // sp
    bl = int(patterns.shape[0]) // dp
    # one byte past the end: the probes read text[min(idx, n)]
    texts = mesh.replicate(torch.cat([_host_or_tensor(text).cpu(),
                                      torch.tensor([WILDCARD],
                                                   dtype=torch.uint8)]))
    suftab, patterns, plens = (_host_or_tensor(x)
                               for x in (suftab, patterns, plens))
    out = []
    for t, i in zip(texts, mesh.local):
        c = mesh.coords(i)
        dev = mesh.device(i)
        j, rows = c["sp"], slice(c["dp"] * bl, (c["dp"] + 1) * bl)
        suf = suftab[j * nloc:(j + 1) * nloc].to(dev, _I64)
        lo, hi = _local_interval(t, suf, patterns[rows].to(dev, _I64),
                                 plens[rows].to(dev, _I64), n, maxplen,
                                 nloc)
        out.append((lo, hi, (hi - lo).clamp(min=0), j * nloc, suf))
    return out


def gather_dp(mesh: Mesh, xs: list, dim: int = 0) -> torch.Tensor:
    """The blocks of a result split over ``dp`` (one per local shard),
    joined along ``dim`` in ``dp`` order, on the first local shard's
    device (``out_specs=P("dp")``)."""
    return torch.cat(all_gather(mesh, xs, "dp")[0].unbind(0), dim=dim)


def sharded_exact_match(mesh: Mesh, text, suftab, patterns, plens):
    """Occurrence count and first global rank of each whole pattern.

    ``text`` uint8 [n] (replicated), ``suftab`` [R] split over ``sp``
    (R a multiple of it), ``patterns`` [B, maxplen] (-1 padded) and
    ``plens`` [B] split over ``dp`` (B a multiple of it); host arrays or
    tensors.  Per-shard binary search, then one psum/pmin pair over
    ``sp``.  Returns (counts [B], first_rank [B]; first_rank = R where
    the pattern does not occur), int64 on the first local device."""
    R = int(suftab.shape[0])
    shards = _lookup_shards(mesh, text, suftab, patterns, plens)
    first = [torch.where(cnt > 0, base + lo, R)
             for lo, _, cnt, base, _ in shards]
    total = psum(mesh, [s[2] for s in shards], "sp")
    first = pmin(mesh, first, "sp")
    return gather_dp(mesh, total), gather_dp(mesh, first)


def doubling_round_sharded(mesh: Mesh, rank, k: int):
    """One prefix-doubling round of the suffix sort with the rank array
    (length a multiple of the mesh's size) laid out over every shard:
    the global sort is a sample sort with all-to-all exchanges, the
    shift by ``k`` a window read from at most two shards, the new ranks
    a scatter by destination shard.  Semantics identical to
    ``index.build._doubling_round``; returns (new_rank [n], si [n])
    tensors on the first local device."""
    from .shardesa import _doubling_round_shards, _flat_mesh, flat_spec

    fm = _flat_mesh(mesh)
    rank = _host_or_tensor(rank)
    n = int(rank.shape[0])
    if n % fm.size:
        raise ValueError(f"rank array of {n} does not split over "
                         f"{fm.size} shards")
    shards = [rank[s].to(fm.device(i), _I64)
              for s, i in zip(flat_spec(fm, n), fm.local)]
    new_rank, si, _ = _doubling_round_shards(fm, shards, k, n)
    dev = fm.device(fm.local[0])
    return (torch.from_numpy(collect(fm, new_rank)).to(dev),
            torch.from_numpy(collect(fm, si)).to(dev))


def full_step(mesh: Mesh, text, suftab, rank, patterns, plens, k: int):
    """One sharded index-build round plus one sharded query-match round
    (the JAX package's "training step" analog)."""
    new_rank, _ = doubling_round_sharded(mesh, rank, k)
    counts, first = sharded_exact_match(mesh, text, suftab, patterns,
                                        plens)
    return new_rank, counts, first
