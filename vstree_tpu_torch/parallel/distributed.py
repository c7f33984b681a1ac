"""Multi-process entry points (port of
:mod:`vstree_tpu.parallel.distributed`).

The single-process meshes (``parallel/mesh.py``) hold every shard in
one process; a run over several processes holds one shard a rank and
moves data through a ``torch.distributed`` process group, which must be
set up before the first collective.  This module is that entry point
plus the global mesh, mirroring how the reference's distribution seams
(superbuckets vdfstrav.c:419-499, mergeesa.c text sharding) map onto
the interconnect:

- rank-range (superbucket) sharding of one index: the collectives of
  the shard programs in ``shardesa.py``, here the group's
  ``all_gather``, ``all_reduce`` and ``all_to_all_single``;
- text sharding across hosts (one sub-database per host, merged by
  ``index/merge.py`` rank arithmetic): each host builds its part, the
  cross counts of ``merge_indexes`` are the only traffic.

Usage (one process per rank, e.g. under ``torchrun``)::

    from vstree_tpu_torch.parallel.distributed import (
        init_multihost, global_mesh)
    init_multihost(device=dev)          # env-driven, or pass arguments
    mesh = global_mesh(dev)             # one shard per rank
    esa = build_esa(ms, alpha, mesh=mesh, device=dev)

Driven by ``torchrun``'s variables (MASTER_ADDR / MASTER_PORT /
WORLD_SIZE / RANK) or by explicit arguments.  The backend is NCCL for
ranks on CUDA devices and gloo on the CPU, unless the caller names one:
a gloo group whose shards are CUDA tensors stages every collective
through host memory, which lets several ranks share one card (NCCL
refuses two ranks on one device).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh


def init_multihost(address: str | None = None,
                   world_size: int | None = None,
                   rank: int | None = None, *, device,
                   backend: str | None = None) -> bool:
    """Initialize the default process group for a multi-process run.

    ``address`` (``tcp://host:port``), ``world_size`` and ``rank``
    default to torchrun's environment variables; returns False (no-op)
    when neither arguments nor environment describe a multi-process
    run.  ``device`` is this rank's device and picks the backend
    (``nccl`` on CUDA, ``gloo`` on the CPU) unless ``backend`` names
    one."""
    if address is None and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        address = (f"tcp://{os.environ['MASTER_ADDR']}:"
                   f"{os.environ['MASTER_PORT']}")
    if world_size is None:
        v = os.environ.get("WORLD_SIZE")
        world_size = int(v) if v else None
    if rank is None:
        v = os.environ.get("RANK")
        rank = int(v) if v else None
    if not address or not world_size or world_size <= 1 or rank is None:
        return False
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=address,
                            world_size=world_size, rank=rank)
    return True


class GroupComm:
    """Transport of a mesh with one shard per rank of the default
    process group: a shard's collective is the group's (or the
    sub-group's of its axis).  ``stage`` (a gloo group with CUDA
    shards) copies every tensor to the host and back around the
    collective.  Every rank builds the sub-groups of every axis, in one
    order, when the mesh is made."""

    def __init__(self, axes: list, device: torch.device):
        self.moved = 0
        self.rank = dist.get_rank()
        self.device = device
        self.stage = (dist.get_backend() == "gloo"
                      and device.type == "cuda")
        self.groups = {}
        world = list(range(dist.get_world_size()))
        for members in axes:
            key = tuple(members)
            if key not in self.groups and len(members) > 1:
                self.groups[key] = (None if list(members) == world
                                    else dist.new_group(list(members)))

    def local_shards(self, size: int) -> list[int]:
        return [self.rank]

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor a collective sends: on the host when staged;
        booleans as bytes."""
        x = x.contiguous()
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        return x.cpu() if self.stage else x

    def _back(self, x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return x.to(like.device, like.dtype)

    def gather(self, mesh: Mesh, xs: list, members: list) -> list:
        (x,), (g,) = xs, members
        if len(g) == 1:
            return [x[None]]
        t = self._out(x)
        parts = [torch.empty_like(t) for _ in g]
        dist.all_gather(parts, t, group=self.groups[tuple(g)])
        return [self._back(torch.stack(parts), x)]

    def reduce(self, mesh: Mesh, xs: list, members: list,
               op: str) -> list:
        (x,), (g,) = xs, members
        if len(g) == 1:
            return [x.clone()]
        t = self._out(x).clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MIN, group=self.groups[tuple(g)])
        return [self._back(t, x)]

    def exchange(self, mesh: Mesh, chunks: list) -> list:
        (row,) = chunks
        send = [c.numel() for c in row]
        # what every rank sends this one
        counts = self._out(torch.tensor(send, dtype=torch.int64,
                                        device=self.device))
        sizes = torch.empty_like(counts)
        dist.all_to_all_single(sizes, counts)
        sizes = sizes.tolist()
        flat = self._out(torch.cat(row))
        out = flat.new_empty(sum(sizes))
        dist.all_to_all_single(out, flat, output_split_sizes=sizes,
                               input_split_sizes=send)
        return [[self._back(p, row[0]) for p in torch.split(out, sizes)]]

    def collect(self, mesh: Mesh, xs: list) -> np.ndarray:
        (x,) = xs
        n = torch.tensor([x.numel()], dtype=torch.int64, device=x.device)
        (sizes,) = self.gather(mesh, [n], [list(range(mesh.size))])
        sizes = sizes.reshape(-1).tolist()
        if max(sizes) == 0:
            return x.cpu().numpy()
        pad = torch.cat([x, x.new_zeros(max(sizes) - x.numel())])
        (parts,) = self.gather(mesh, [pad], [list(range(mesh.size))])
        return np.concatenate([p[:s].cpu().numpy()
                               for p, s in zip(parts, sizes)])


def global_mesh(device) -> Mesh:
    """(dp, sp) mesh with one shard per rank of the initialized process
    group, this rank's on ``device``; the split rule of
    :func:`~vstree_tpu_torch.parallel.mesh.make_mesh`."""
    device = torch.device(device)
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, str(device))
    n = len(names)
    dp = 2 if n % 2 == 0 and n >= 4 else 1
    devs = np.empty(n, dtype=object)
    devs[:] = [torch.device(d) for d in names]
    devs = devs[: dp * (n // dp)].reshape(dp, n // dp)
    grid = Mesh(devs, ("dp", "sp"))      # the axes' groups, in one order
    axes = [g for a in ("dp", "sp") for g in grid.groups(a)]
    axes.append(list(range(n)))
    return Mesh(devs, ("dp", "sp"), GroupComm(axes, device))
