"""What a dry run measures of one rank's program: ``repro.launch.analysis``
without XLA.

The JAX dry run reads a compiled SPMD program: ``cost_analysis`` for FLOPs,
``memory_analysis`` for bytes, and the optimized HLO for the collectives
(``collective_bytes``, ``hlo_costs``). The port has no compiler: a rank
runs its local shards and calls its collectives itself, so a trace of that
program on fake tensors (``launch.dryrun``) is measured directly:

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the aten ops
    (matmuls, bmm, attention) plus the operations the kernel wrappers tally
    where they launch (``kernels.ops``, ``kernels._trace``);
  * memory: ``LiveBytes``, a dispatch mode that counts the storages live
    at entry (parameters, optimizer state, cache, inputs) and every storage
    an op makes until it dies; its peak is the rank's;
  * collectives: the ``distributed.collectives.Recorder`` the traced mesh
    carries.

``CollectiveStats``, ``collectives_to_graph`` and
``predicted_collective_time`` are the JAX module's, held equal to it.
``collective_bytes`` and ``hlo_costs`` are not ported: they parse XLA's
optimized HLO, which the port never produces; the recorder and the tally
take their place.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@dataclass
class CollectiveStats:
    total_bytes: float = 0.0
    by_kind: Dict[str, float] = field(default_factory=dict)
    count: int = 0


_KIND_TO_SPEC = {"all-reduce": "all_reduce", "all-gather": "all_gather",
                 "reduce-scatter": "reduce_scatter",
                 "all-to-all": "all_to_all", "collective-permute": "p2p"}


def collectives_to_graph(stats: CollectiveStats, n_devices: int):
    """Lower per-kind collective bytes into a CollectiveSpec graph: one node
    per kind, its bytes summed, priced by the analytic link model
    (``core.interconnect``) as a planner sweep's are."""
    from ..core.ir import CollectiveSpec, Graph, Node
    nodes = []
    for kind, bytes_ in sorted(stats.by_kind.items()):
        spec_kind = _KIND_TO_SPEC.get(kind)
        if spec_kind is None or bytes_ <= 0:
            continue
        nodes.append(Node(CollectiveSpec(spec_kind, bytes_, n_devices),
                          f"hlo_{kind.replace('-', '_')}"))
    return Graph(tuple(nodes))


def predicted_collective_time(system, stats: CollectiveStats,
                              n_devices: int = 0, device: str = "cuda") -> float:
    """Seconds the analytic interconnect model predicts for the collective
    traffic of one execution of the program (the evaluator's mapper tables
    on `device`)."""
    from ..core.evaluator import Evaluator
    n = n_devices or system.device_count
    graph = collectives_to_graph(stats, n)
    if not len(graph):
        return 0.0
    return Evaluator(system, device=device).evaluate(graph).latency


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages a program holds: those of the tensors of
    `entry` from the start, then each storage an op's output lives in, from
    that op until the storage dies. ``peak`` is the most held at once."""

    def __init__(self, entry=()):
        super().__init__()
        self.live: Dict[int, int] = {}
        self.now = self.peak = 0
        for t in entry:
            self._add(t)
        self.entry_keys = set(self.live)
        self.argument = self.now

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.now -= self.live.pop(key, 0)

    def held(self, tensors) -> int:
        """Bytes of the storages of `tensors` that the program made (not
        those it was given)."""
        seen = {}
        for t in tensors:
            st = t.untyped_storage()
            if st._cdata not in self.entry_keys:
                seen[st._cdata] = st.nbytes()
        return sum(seen.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t)
        return out


def cost_summary(aten_flops: int, kernel_ops: dict) -> dict:
    """The record's cost of one rank program: the aten ops' FLOPs, the
    kernels' operations by kernel name, and their sum as ``flops``."""
    kernel = {k: int(v) for k, v in sorted(kernel_ops.items()) if v}
    return {"flops": float(aten_flops + sum(kernel.values())), "aten_flops": int(aten_flops),
            "kernel_ops": kernel}


def memory_summary(live: LiveBytes, outputs=()) -> dict:
    """The record's memory of one rank program, under the JAX
    ``memory_summary``'s names: ``argument`` (the storages at entry),
    ``output`` (those the outputs hold that the program made), ``temp``
    (the rest of the peak) and ``total`` (the peak)."""
    out = live.held(outputs)
    return {"argument_size_in_bytes": live.argument, "output_size_in_bytes": out,
            "temp_size_in_bytes": live.peak - live.argument - out,
            "generated_code_size_in_bytes": 0, "alias_size_in_bytes": 0,
            "total_bytes": live.peak}


__all__ = ["CollectiveStats", "collectives_to_graph", "predicted_collective_time",
           "LiveBytes", "cost_summary", "memory_summary"]
