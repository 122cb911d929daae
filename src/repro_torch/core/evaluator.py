"""Evaluator: turn symbolic Graphs (ir.py) into latencies on a System.

One Evaluator owns one System and one result cache keyed by OpSpec. Because
specs are hashable values, any spec — a matmul shape, a softmax extent, a
collective volume — is evaluated at most once per Evaluator lifetime, no
matter how many plans, KV depths, or repeated layers reference it. Share one
Evaluator across a whole planner sweep and plan #2 onward pays only for
shapes it has not seen.

The PyTorch port's copy of the JAX package's Evaluator as it runs with
static verification off: without the verifier and its metrics registry,
the seed-replica (dense reference) mode, the unbatched mode, the bare-Device
form, the batched GEMM prefetch, the overlap scheduler and the search
counters. Every spec, a GEMM included, is priced through one memoized
lookup that dispatches to the same operators.py / mapper.py /
interconnect.py model, so the numbers are the JAX evaluator's
(tests/test_torch_analytic.py).
"""
from __future__ import annotations

from typing import Dict

from .hardware import System
from . import operators as ops
from . import interconnect as net
from .ir import (CollectiveSpec, ElementwiseSpec, FusedMatmulSpec, Graph,
                 MatmulSpec, NormSpec, OpSpec, ScanSpec, SoftmaxSpec,
                 TrafficSpec)
from .mapper import matmul_perf


class Evaluator:
    """Evaluate IR graphs on one System, each distinct spec once."""

    def __init__(self, system: System) -> None:
        self.system = system
        self.device = system.device
        self._cache: Dict[OpSpec, ops.OpResult] = {}

    # ------------------------------------------------------------------

    def _eval_spec(self, spec: OpSpec) -> ops.OpResult:
        """Evaluate one spec eagerly through the operator models."""
        dev = self.device
        if isinstance(spec, MatmulSpec):
            r = matmul_perf(dev, *spec.shape)
            return ops.OpResult("matmul",
                                r.latency + dev.kernel_launch_overhead_s,
                                r.flops, r.main_memory_bytes,
                                r.mapping.bound, r.mapping)
        if isinstance(spec, FusedMatmulSpec):
            # one kernel: the GEMM (mapper-priced at its rescaled output
            # traffic) plus tile-local vector epilogues — no per-epilogue
            # launch overhead, no intermediate HBM round trip
            r_mm = self._lookup(spec.gemm)
            lat, flops = r_mm.latency, r_mm.flops
            for e in spec.epilogue:
                t, f = ops.fused_epilogue(dev, e)
                lat += t
                flops += f
            return ops.OpResult("fused_matmul", lat, flops,
                                r_mm.main_memory_bytes, r_mm.bound,
                                r_mm.mapping)
        if isinstance(spec, SoftmaxSpec):
            return ops.softmax(dev, spec.rows, spec.cols, spec.bytes_in,
                               spec.bytes_out)
        if isinstance(spec, NormSpec):
            fn = ops.layernorm if spec.kind == "layernorm" else ops.rmsnorm
            return fn(dev, spec.rows, spec.cols, spec.bytes_in, spec.bytes_out)
        if isinstance(spec, ElementwiseSpec):
            if spec.kind == "gelu":
                return ops.gelu(dev, spec.n_elements, spec.bytes_elt,
                                spec.bytes_elt)
            if spec.kind == "silu_mul":
                return ops.silu_mul(dev, spec.n_elements, spec.bytes_elt,
                                    spec.bytes_elt)
            return ops.elementwise(dev, spec.n_elements, spec.flops_per_elt,
                                   spec.n_in, spec.bytes_elt)
        if isinstance(spec, ScanSpec):
            return ops.recurrent_scan(dev, spec.seq, spec.batch, spec.d_state,
                                      spec.flops_per_step, spec.bytes_io,
                                      spec.chunk)
        if isinstance(spec, CollectiveSpec):
            n = spec.n_devices or self.system.device_count
            if spec.kind == "all_reduce":
                # reduction vector work priced at the payload's element width
                return net.all_reduce(self.system, spec.n_bytes, n,
                                      bytes_elt=spec.bytes_elt)
            if spec.kind == "reduce_scatter":
                return net.reduce_scatter(self.system, spec.n_bytes, n,
                                          bytes_elt=spec.bytes_elt)
            fn = {"all_gather": net.all_gather,
                  "all_to_all": net.all_to_all}.get(spec.kind)
            if fn is not None:
                return fn(self.system, spec.n_bytes, n)
            if spec.kind == "p2p":
                return net.p2p(self.system, spec.n_bytes)
            raise ValueError(f"unknown collective kind {spec.kind!r}")
        if isinstance(spec, TrafficSpec):
            return ops.memory_traffic(dev, spec.n_bytes)
        raise TypeError(f"cannot evaluate spec of type {type(spec).__name__}")

    def _lookup(self, spec: OpSpec) -> ops.OpResult:
        r = self._cache.get(spec)
        if r is None:
            r = self._cache[spec] = self._eval_spec(spec)
        return r

    # ------------------------------------------------------------------
    def evaluate(self, graph: Graph) -> "LayerCost":
        """The graph's serial cost: each node's spec priced once, times its
        repeat, in node order."""
        from .graph import LayerCost      # late import: graph builds on ir
        cost = LayerCost()
        for node in graph:
            r = self._lookup(node.spec)
            cost.add(ops.OpResult(
                node.name, r.latency * node.repeat, r.flops * node.repeat,
                r.main_memory_bytes * node.repeat, r.bound, r.mapping))
        return cost
