"""Collectives of the port: what XLA inserts for the JAX package's sharded
programs, written out, with the autograd Functions the model calls.

Tensor parallelism (Megatron's layout, ``sharding._PARAM_RULES``):
  * ``copy_to_model`` -- Megatron's *f*: identity forward, all-reduce over
    ``model`` backward; at the input of a column-parallel product;
  * ``reduce_from_model`` -- Megatron's *g*: all-reduce over ``model``
    forward, identity backward; after a row-parallel product.
Experts over ``data`` (MoE routed over the whole batch, ROADMAP C10):
  * ``gather_rows`` -- all-gather of token rows forward, reduce-scatter
    backward;
  * ``reduce_scatter_rows`` -- reduce-scatter forward (the sum over the
    ranks, this rank's rows kept), all-gather backward.

Every collective goes through ``run``, which routes it by a fixed table:
the backend takes the tensor where it lies (``NATIVE``), or the tensor is
copied to the host, the collective runs there and the result is copied
back. gloo takes ``all_reduce``, ``broadcast`` and ``all_gather`` on CUDA
tensors (PyTorch's documentation lists the first two; a probe of torch
2.11 on an H100 found ``all_gather`` right too), and given a CUDA tensor
to ``send`` it writes from the device address over TCP and the process
aborts (``gloo::IoException``, "Bad address"); NCCL takes CUDA tensors
only. The table is a rule of (backend, device, op), never an error
caught. ``STATS`` counts the calls, the bytes each rank sent into
collectives, the bytes staged through the host, and the host seconds
spent inside them, timed from the point where the device work this rank
queued before the call has drained (a ``torch.cuda.synchronize``), so
that none of it is counted; the seconds still hold the wait for the
slowest rank to arrive, and where ranks share one card, that rank's
device work too.

A dry run (``launch.dryrun``) traces one rank's program on a mesh with no
process groups (``launch.mesh.Mesh.abstract(..., recorder=)``): its axes
hold ``RecordedGroup``s, and ``run`` hands each collective to the
``Recorder`` instead of a backend. The recorder keeps the kind under the
JAX package's names (the op the port executes: a reduce-scatter done as an
all-reduce is an all-reduce), the axis and the bytes as the JAX
``analysis._instr_collective_bytes`` counts them (the result's), and
returns a tensor of the result's shape, made as the real collective makes
its result: a copy of the input for an all-reduce or a broadcast, zeros
for a gather (each rank's part, then their concatenation), and the
receive buffer zeroed for a recv. The same recorder runs the rank program
on real tensors, on one card, with the same collectives. A mesh with
process groups never reaches it; ``observe`` keeps a record of the
collectives such a mesh runs, beside running them.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

#: (backend, device type) -> the collectives the backend runs on tensors there
NATIVE = {
    ("gloo", "cpu"): {"all_reduce", "broadcast", "all_gather", "send", "recv"},
    ("gloo", "cuda"): {"all_reduce", "broadcast", "all_gather"},
    ("nccl", "cuda"): {"all_reduce", "broadcast", "all_gather", "send", "recv"},
}

STATS = {"calls": 0, "bytes": 0, "staged_bytes": 0, "seconds": 0.0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


#: the JAX package's names of the collectives the port executes
KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
         "broadcast": "collective-broadcast", "send": "collective-permute",
         "recv": "collective-permute"}


class Recorder:
    """The collectives of one rank program, in call order: (kind, axis,
    bytes) each."""

    def __init__(self):
        self.calls = []

    def stats(self) -> dict:
        """{"bytes", "count", "by_kind"}: the dry-run record's collectives,
        as the JAX ``CollectiveStats`` holds them."""
        by_kind = {}
        for kind, _, n in self.calls:
            by_kind[kind] = by_kind.get(kind, 0) + n
        return {"bytes": sum(by_kind.values()), "count": len(self.calls),
                "by_kind": dict(sorted(by_kind.items()))}

    def by_axis(self) -> dict:
        """{axis: bytes} of the recorded collectives."""
        out = {}
        for _, axis, n in self.calls:
            out[axis] = out.get(axis, 0) + n
        return out


class RecordedGroup:
    """The stand-in for a process group along `axis` of an abstract mesh:
    `size` ranks, this one at `index`, its collectives kept by `recorder`."""

    def __init__(self, recorder: Recorder, axis: str, size: int, index: int):
        self.recorder, self.axis, self.size, self.index = recorder, axis, size, index

    def run(self, op: str, t: torch.Tensor, **kw) -> torch.Tensor:
        nbytes = t.numel() * t.element_size()
        if op in ("all_reduce", "broadcast"):
            out = t.clone()
        elif op == "all_gather":
            out = torch.cat([torch.zeros_like(t, memory_format=torch.contiguous_format)
                             for _ in range(self.size)], dim=kw.get("dim", 0))
            nbytes *= self.size
        elif op == "recv":
            out = t.zero_()
        elif op == "send":
            out = None
        else:
            raise ValueError(f"no collective {op!r}")
        self.recorder.calls.append((KINDS[op], self.axis, nbytes))
        return out


_OBSERVERS: list = []


class observe:
    """Within the block every collective that runs on a process group is
    also recorded in `recorder` (its axis None): a real world's record, to
    hold a traced one to."""

    def __init__(self, recorder: Recorder):
        self.recorder = recorder

    def __enter__(self):
        _OBSERVERS.append(self.recorder)
        return self.recorder

    def __exit__(self, *exc):
        _OBSERVERS.remove(self.recorder)


def group_size(group) -> int:
    """The ranks of a process group or a recorded one."""
    return group.size if isinstance(group, RecordedGroup) else dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in a process group or a recorded one."""
    return group.index if isinstance(group, RecordedGroup) else dist.get_rank(group)


def reset_stats():
    STATS.update(calls=0, bytes=0, staged_bytes=0, seconds=0.0)


def staged(op: str, device: torch.device, group=None) -> bool:
    """Whether `op` on a tensor on `device` goes through a host copy."""
    backend = dist.get_backend(group)
    native = NATIVE.get((backend, device.type))
    if native is None:
        raise ValueError(f"backend {backend} takes no tensor on {device.type}")
    return op not in native


def run(op: str, t: torch.Tensor, group, **kw) -> torch.Tensor:
    """Run one collective on `t` over `group` and return its result on
    `t`'s device: "all_reduce" (kw ``reduce``: "sum" or "max"), "broadcast"
    (kw ``src``, a global rank), "all_gather" (the ranks' tensors
    concatenated along kw ``dim``), "send" (kw ``dst``), "recv" (into `t`,
    kw ``src``). A recorded group records it instead (``Recorder``)."""
    if isinstance(group, RecordedGroup):
        return group.run(op, t, **kw)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    via_host = staged(op, t.device, group)
    if via_host:
        x = t.to("cpu", copy=True)
    else:   # all_reduce and broadcast work in place: on a copy
        x = t.clone() if op in ("all_reduce", "broadcast") else t
    if op == "all_reduce":
        dist.all_reduce(x, op=_OPS[kw.get("reduce", "sum")], group=group)
    elif op == "broadcast":
        dist.broadcast(x, src=kw["src"], group=group)
    elif op == "all_gather":
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        x = torch.cat(parts, dim=kw.get("dim", 0))
    elif op == "send":
        dist.send(x.contiguous(), dst=kw["dst"], group=group)
    elif op == "recv":
        dist.recv(x, src=kw["src"], group=group)
    else:
        raise ValueError(f"no collective {op!r}")
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    for rec in _OBSERVERS:
        rec.calls.append((KINDS[op], None, t.numel() * t.element_size()
                          * (dist.get_world_size(group) if op == "all_gather" else 1)))
    if via_host:
        STATS["staged_bytes"] += t.numel() * t.element_size()
        if op != "send":
            STATS["staged_bytes"] += x.numel() * x.element_size()
            x = t.copy_(x) if op == "recv" else x.to(t.device)
    STATS["seconds"] += time.perf_counter() - t0
    return x


def all_reduce(t: torch.Tensor, group, reduce: str = "sum") -> torch.Tensor:
    """A new tensor: `t` reduced over `group` (`t` itself where the group
    is None, a one-rank axis)."""
    return t if group is None else run("all_reduce", t, group, reduce=reduce)


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return t if group is None else run("all_gather", t, group, dim=dim)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    return t if group is None else run("broadcast", t, group, src=src)


def send(t: torch.Tensor, dst: int, group):
    run("send", t, group, dst=dst)


def recv(t: torch.Tensor, src: int, group) -> torch.Tensor:
    return run("recv", t, group, src=src)


def _rows(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's rows of `t`: the group's index-th of its equal parts."""
    return t.chunk(group_size(group), dim=0)[group_rank(group)]


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather(x, group)

    @staticmethod
    def backward(ctx, dy):
        return _rows(all_reduce(dy, ctx.group), ctx.group).contiguous(), None


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _rows(all_reduce(x, group), group).contiguous()

    @staticmethod
    def backward(ctx, dy):
        return all_gather(dy.contiguous(), ctx.group), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f over the model group (identity where it is None)."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g over the model group (identity where it is None)."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's rows of x, in rank order, along dim 0."""
    return x if group is None else _GatherRows.apply(x, group)


def reduce_scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the group, this rank's equal part of dim 0 kept."""
    return x if group is None else _ReduceScatterRows.apply(x, group)


__all__ = ["NATIVE", "STATS", "KINDS", "Recorder", "RecordedGroup", "observe", "group_size",
           "group_rank", "reset_stats", "staged", "run", "all_reduce", "all_gather",
           "broadcast", "send", "recv", "copy_to_model", "reduce_from_model", "gather_rows",
           "reduce_scatter_rows"]
