"""Device meshes of the port: ``repro.launch.mesh`` over ``torch.distributed``
ranks.

A ``Mesh`` lays the ranks of the process group out in a (pod, data, model)
or (data, model) grid, row-major, with one process group per axis for
each rank (the ranks that differ from it in that axis alone). Its ``shape``
maps each axis name to its size, as a JAX mesh's ``shape`` does, so the
sharding rules (``distributed.sharding``) read either. ``Mesh.abstract``
makes one with no groups: only its shape, for the rules.

Axes, as in the JAX package:
  pod    -- across pods: data parallel by default, pipeline stages with
            ``distributed.pipeline.pipeline_apply``
  data   -- within a pod: batch rows, experts, optimizer-state shards
  model  -- tensor parallel (Megatron layout)

``init_distributed`` starts the process group from the launcher's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``, as ``torch.distributed.run`` sets them). Its backend is a
rule of the placement, decided before the group starts: NCCL where every
rank of the host has a card of its own (``cuda:LOCAL_RANK``); gloo where
ranks share a card (NCCL refuses two ranks on one device) or run on the
CPU.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


class Mesh:
    """Ranks in a grid of named axes, with this rank's group along each."""

    def __init__(self, ranks: np.ndarray, axis_names: tuple, groups: Optional[dict] = None):
        if ranks.ndim != len(axis_names):
            raise ValueError(f"a mesh of {ranks.ndim} dims takes {ranks.ndim} axis names, "
                             f"got {axis_names}")
        self.devices = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in ranks.shape)))
        self.groups = groups or {}
        self.rank = dist.get_rank() if groups is not None else int(ranks.flat[0])
        where = np.argwhere(ranks == self.rank)
        self.coords = ({a: int(i) for a, i in zip(self.axis_names, where[0])} if len(where)
                       else None)

    @classmethod
    def abstract(cls, shape: tuple, axis_names: tuple, rank: int = 0,
                 recorder=None) -> "Mesh":
        """A mesh of `shape` over ranks 0..n-1 with no process groups, seen
        from `rank`: for the sharding rules and ``shard``, which read only
        its shape and this rank's place in it. With a `recorder`
        (``distributed.collectives.Recorder``) each axis holds a
        ``RecordedGroup``, and `rank`'s program runs on it alone, its
        collectives recorded (a dry run)."""
        from ..distributed.collectives import RecordedGroup
        m = cls(np.arange(int(np.prod(shape))).reshape(shape), axis_names)
        m.rank = rank
        m.coords = {a: int(i) for a, i in zip(m.axis_names, np.unravel_index(rank, shape))}
        if recorder is not None:
            m.groups = {a: RecordedGroup(recorder, a, m.shape[a], m.coords[a])
                        for a in m.axis_names}
        return m

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axis) -> int:
        """The size of an axis, or of a tuple of axes; 1 for an absent one."""
        axes = axis if isinstance(axis, tuple) else (axis,)
        return int(np.prod([self.shape.get(a, 1) for a in axes]))

    def index(self, axis) -> int:
        """This rank's index along an axis, or along a tuple of axes (the
        first the major one); 0 along an absent one."""
        axes = axis if isinstance(axis, tuple) else (axis,)
        i = 0
        for a in axes:
            i = i * self.shape.get(a, 1) + (self.coords or {}).get(a, 0)
        return i

    def group(self, axis):
        """This rank's process group along `axis`, or None where the axis
        has one rank (nothing to communicate)."""
        if self.shape.get(axis, 1) == 1:
            return None
        if axis not in self.groups:
            raise ValueError(f"this mesh has no process group for {axis!r}: "
                             "an abstract mesh holds shapes only")
        return self.groups[axis]

    def group_ranks(self, axis) -> list:
        """The global ranks of this rank's group along `axis`, in order."""
        idx = [slice(None) if a == axis else self.coords[a] for a in self.axis_names]
        return [int(r) for r in np.atleast_1d(self.devices[tuple(idx)])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def _build(shape: tuple, axis_names: tuple, ranks=None) -> Mesh:
    """A mesh of `shape` over `ranks` (the world's, in order, by default)
    with a group along every axis. Every rank of the world must call it, in
    the same order as every other (``new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: call "
                           "launch.mesh.init_distributed() first")
    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    grid = np.array(ranks).reshape(shape)
    groups = {}
    me = dist.get_rank()
    for ax, name in enumerate(axis_names):
        moved = np.moveaxis(grid, ax, -1).reshape(-1, grid.shape[ax])
        for row in moved:
            g = dist.new_group([int(r) for r in row])
            if me in row:
                groups[name] = g
    return Mesh(grid, axis_names, groups)


def _require_world(n: int, what: str):
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"{what} needs {n} ranks, but the world size is {world}")


def production_mesh_shape(multi_pod: bool = False):
    """(shape, axis names) of the JAX package's production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def host_mesh_shape(data: int = 1, model: int = 1, pod: int = 1):
    """(shape, axis names) of ``make_host_mesh(data, model, pod)``."""
    if pod > 1:
        return (pod, data, model), ("pod", "data", "model")
    return (data, model), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production mesh: (16, 16) over (data, model), or
    (2, 16, 16) over (pod, data, model); the world must have that many
    ranks."""
    shape, axes = production_mesh_shape(multi_pod)
    _require_world(int(np.prod(shape)), f"the production mesh {shape}")
    return _build(shape, axes)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1) -> Mesh:
    """A (data, model) mesh, or (pod, data, model) with pod > 1, over the
    world's ranks; raises ValueError unless data x model x pod is the world
    size."""
    _require_world(pod * data * model, f"a mesh of pod {pod} x data {data} x model {model}")
    return _build(*host_mesh_shape(data, model, pod))


def placement(device=None, local_rank: int = 0, local_world: int = 1):
    """(backend, device) of a rank, decided before the group starts: NCCL
    and ``cuda:local_rank`` where the host has a card for each of its
    `local_world` ranks; gloo where ranks share a card (NCCL refuses two
    ranks on one device), on ``cuda:local_rank % cards``; gloo on the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "gloo", dev
    cards = torch.cuda.device_count()
    if cards >= local_world:
        return "nccl", torch.device("cuda", local_rank)
    return "gloo", torch.device("cuda", local_rank % cards)


def init_distributed(device=None):
    """Start the default process group from the environment that
    ``torch.distributed.run`` sets, with the backend ``placement`` picks.
    Returns (rank, world size, device); a process started without that
    environment is rank 0 of a world of 1 and starts no group."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    backend, dev = placement(device, local_rank, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world > 1 and not dist.is_initialized():
        dist.init_process_group(backend, rank=rank, world_size=world,
                                **({"device_id": dev} if backend == "nccl" else {}))
        if rank == 0:
            print(f"[dist] {world} ranks, backend {backend}, rank 0 on {dev}"
                  + (" (ranks share the card)" if dev.type == "cuda" and backend == "gloo"
                     else ""), flush=True)
    return rank, world, dev


__all__ = ["Mesh", "production_mesh_shape", "host_mesh_shape", "make_production_mesh",
           "make_host_mesh", "placement", "init_distributed"]
