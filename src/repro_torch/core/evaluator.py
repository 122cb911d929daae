"""Evaluator: turn symbolic Graphs (ir.py) into latencies on a System.

One Evaluator owns one System and one result cache keyed by OpSpec. Because
specs are hashable values, any spec — a matmul shape, a softmax extent, a
collective volume — is evaluated at most once per Evaluator lifetime, no
matter how many plans, KV depths, or repeated layers reference it. Share one
Evaluator across a whole planner sweep and plan #2 onward pays only for
shapes it has not seen.

Matmuls additionally batch: `evaluate_many` first collects every unique
un-cached MatmulSpec across all requested graphs and solves them in one
stacked mapper search (mapper.matmul_perf_batch) before assembling per-graph
results. The decode-KV trapezoid sweep and a multi-plan ranking both become
a single batched search this way.

Numbers are bit-for-bit identical to the seed eager path: each spec kind
dispatches to the same operators.py / interconnect.py model the eager code
called, and node repeat counts multiply results exactly the way the seed
model_ops multiplied per-op costs by the layer count.

The PyTorch port's copy of the JAX package's Evaluator, whole. Its batched
mapper searches price their candidate tables on `device`: ``"cuda"`` (the
default, the kernel of ``kernels/mapper_tables``; raises without a card) or
``"cpu"`` (numpy). The numbers are the same on both.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, List, Mapping, Sequence

from .hardware import Device, Link, System
from . import operators as ops
from . import interconnect as net
from .ir import (CollectiveSpec, ElementwiseSpec, FusedMatmulSpec, Graph,
                 MatmulSpec, NormSpec, OpSpec, ScanSpec, SoftmaxSpec,
                 TrafficSpec, resource_of)
from .mapper import check_device, matmul_cache_stats, matmul_perf_batch
from .obs import metrics
from .schedule import schedule_graph
from . import verify as verify_mod


@dataclass
class EvalStats:
    """Cache / search statistics for one Evaluator."""
    graphs: int = 0
    nodes: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    matmul_searches: int = 0         # unique GEMM shapes actually searched
    batched_searches: int = 0        # matmul_perf_batch invocations
    candidates_searched: int = 0     # dense-equivalent candidate count
    serial_seconds: float = 0.0      # serial sum of overlap-scheduled graphs
    scheduled_seconds: float = 0.0   # their resource-timeline makespans
    # mapper memo deltas attributable to this evaluator: shapes
    # served by the in-memory LRU / the persistent disk layer instead of a
    # search, and LRU entries evicted while it ran
    mapper_memo_hits: int = 0
    mapper_disk_hits: int = 0
    mapper_evictions: int = 0
    # Study result-cache outcomes attributed to this evaluator: cases whose
    # CaseResult was served from the persistent case cache vs re-evaluated
    # (study.Study.run fills these in)
    case_hits: int = 0
    case_misses: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    @property
    def schedule_ratio(self) -> float:
        """Scheduled-vs-serial latency ratio across all overlap-mode graphs
        (< 1 means overlap hid work; 1.0 when nothing was scheduled). A
        regression in overlap modeling shows up here in bench logs."""
        return self.scheduled_seconds / self.serial_seconds \
            if self.serial_seconds > 0 else 1.0

    def to_doc(self) -> Dict[str, float]:
        """Plain-dict snapshot of every field — the pickle-friendly form a
        Study worker ships its shard's stats home in."""
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def merge(self, doc: Mapping[str, float]) -> None:
        """Accumulate a worker shard's `to_doc()` snapshot into this
        instance (field-wise addition; unknown keys are ignored so docs
        from newer/older workers degrade gracefully)."""
        for f in fields(self):
            v = doc.get(f.name)
            if v:
                setattr(self, f.name, getattr(self, f.name) + v)

    def summary(self) -> str:
        return (f"graphs={self.graphs} nodes={self.nodes} "
                f"hits={self.cache_hits} misses={self.cache_misses} "
                f"hit_rate={self.hit_rate:.1%} "
                f"matmul_searches={self.matmul_searches} "
                f"batched_calls={self.batched_searches} "
                f"candidates={self.candidates_searched} "
                f"mapper_memo_hits={self.mapper_memo_hits} "
                f"mapper_disk_hits={self.mapper_disk_hits} "
                f"mapper_evictions={self.mapper_evictions} "
                f"case_hits={self.case_hits} "
                f"case_misses={self.case_misses} "
                f"sched_vs_serial={self.schedule_ratio:.3f}")


def _single_device_system(device: Device) -> System:
    return System(device=device, device_count=1, link=Link(1e9))


class Evaluator:
    """Evaluate IR graphs on one System, deduplicating and batching work."""

    def __init__(self, system: System, batch_matmuls: bool = True,
                 use_reference_mapper: bool = False,
                 verify: str | None = None, device: str = "cuda") -> None:
        self._device_only = isinstance(system, Device)
        if self._device_only:   # device-only use: no real link parameters
            system = _single_device_system(system)
        self.system = system
        self.device = system.device          # the hardware being priced
        # where the batched mapper searches run their candidate tables
        self.tables_device = check_device(device)
        self.batch_matmuls = batch_matmuls
        # seed-replica mode for before/after benchmarking: per-shape dense
        # search (mapper.matmul_perf_reference), no batching, no global memo
        self.use_reference_mapper = use_reference_mapper
        if use_reference_mapper:
            self.batch_matmuls = False
        # static verification mode: "error" | "warn" | "off",
        # defaulting to $REPRO_VERIFY else "warn". Graphs are linted once
        # each (they are frozen/hashable) before any mapper work; overlap
        # schedules are certificate-checked after scheduling.
        self.verify_mode = verify_mod.resolve_mode(verify)
        self._verified: set[Graph] = set()
        self._cache: Dict[OpSpec, ops.OpResult] = {}
        self.stats = EvalStats()

    # ------------------------------------------------------------------
    def _mapper_call(self, shapes):
        """matmul_perf_batch with the global memo's hit/eviction deltas
        attributed to this evaluator's stats."""
        ms = matmul_cache_stats()
        memo0, disk0, evict0 = ms.memo_hits, ms.disk_hits, ms.evictions
        results = matmul_perf_batch(self.device, shapes,
                                    device=self.tables_device)
        self.stats.mapper_memo_hits += ms.memo_hits - memo0
        self.stats.mapper_disk_hits += ms.disk_hits - disk0
        self.stats.mapper_evictions += ms.evictions - evict0
        return results

    def _eval_spec(self, spec: OpSpec) -> ops.OpResult:
        """Evaluate one spec eagerly through the operator models."""
        dev = self.device
        if isinstance(spec, MatmulSpec):
            self.stats.matmul_searches += 1
            if self.use_reference_mapper:
                from .mapper import matmul_perf_reference
                r = matmul_perf_reference(dev, spec.m, spec.k, spec.n,
                                          spec.batch, spec.bytes_a,
                                          spec.bytes_b, spec.bytes_out,
                                          spec.bytes_acc, spec.b_shared,
                                          spec.mac_scale)
            else:
                self.stats.batched_searches += 1
                r = self._mapper_call([spec.shape])[0]
            self.stats.candidates_searched += r.candidates_searched
            return ops.OpResult("matmul", r.latency
                                + dev.kernel_launch_overhead_s, r.flops,
                                r.main_memory_bytes, r.mapping.bound,
                                r.mapping)
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
            if self._device_only:
                raise ValueError(
                    "this Evaluator was built from a bare Device and has no "
                    "link model; construct it with a System to price "
                    f"collectives (got {spec.kind})")
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
            self.stats.cache_misses += 1
            r = self._eval_spec(spec)
            self._cache[spec] = r
        else:
            self.stats.cache_hits += 1
        return r

    def _prefetch_matmuls(self, graphs: Sequence[Graph]) -> set:
        """Solve every un-cached unique MatmulSpec in one stacked search.
        Returns the set of specs filled in (already counted as misses)."""
        pending: List[MatmulSpec] = []
        seen = set()
        for g in graphs:
            for node in g:
                s = node.spec
                if isinstance(s, FusedMatmulSpec):
                    s = s.gemm            # the stacked search solves the base
                if isinstance(s, MatmulSpec) and s not in self._cache \
                        and s not in seen:
                    seen.add(s)
                    pending.append(s)
        if not pending:
            return seen
        dev = self.device
        results = self._mapper_call([s.shape for s in pending])
        self.stats.batched_searches += 1
        for s, r in zip(pending, results):
            self.stats.matmul_searches += 1
            self.stats.candidates_searched += r.candidates_searched
            self.stats.cache_misses += 1
            self._cache[s] = ops.OpResult(
                "matmul", r.latency + dev.kernel_launch_overhead_s, r.flops,
                r.main_memory_bytes, r.mapping.bound, r.mapping)
        return seen

    # ------------------------------------------------------------------
    def evaluate(self, graph: Graph, overlap: bool = False) -> "LayerCost":
        return self.evaluate_many([graph], overlap=overlap)[0]

    def evaluate_many(self, graphs: Sequence[Graph],
                      overlap: bool = False) -> List["LayerCost"]:
        """Evaluate several graphs; unique matmuls across ALL of them are
        solved in one batched mapper search first.

        With `overlap=True` each graph is additionally list-scheduled over
        per-resource timelines (core/schedule.py): the returned LayerCost's
        `latency` is the dataflow makespan (collectives pipelined with their
        producers) instead of the serial sum, and carries the per-op
        start/end schedule."""
        from .graph import LayerCost      # late import: graph builds on ir
        reg = metrics()
        if self.verify_mode != "off":
            with reg.phase("verify"):
                for g in graphs:
                    if g not in self._verified:
                        verify_mod.verify_graph(g, self.device,
                                                mode=self.verify_mode)
                        self._verified.add(g)
        with reg.phase("search"):
            prefetched = self._prefetch_matmuls(graphs) \
                if self.batch_matmuls else set()
        out = []
        for g in graphs:
            self.stats.graphs += 1
            cost = LayerCost()
            for node in g:
                self.stats.nodes += 1
                if node.spec in prefetched:
                    prefetched.discard(node.spec)   # first use = the miss
                    r = self._cache[node.spec]
                else:
                    r = self._lookup(node.spec)
                cost.add(ops.OpResult(
                    node.name, r.latency * node.repeat,
                    r.flops * node.repeat,
                    r.main_memory_bytes * node.repeat, r.bound, r.mapping))
            cost._resources = tuple(resource_of(n.spec) for n in g)
            if overlap:
                lats = [o.latency for o in cost.ops]
                with reg.phase("schedule"):
                    sch = schedule_graph(g, lats)
                if self.verify_mode != "off":
                    # certificate check: the schedule really is a feasible
                    # witness of its claimed makespan
                    with reg.phase("verify"):
                        verify_mod.verify_schedule(g, lats, sch,
                                                   mode=self.verify_mode)
                cost.schedule = sch
                self.stats.serial_seconds += sch.serial
                self.stats.scheduled_seconds += sch.makespan
            out.append(cost)
        reg.inc("evaluator.graphs", len(graphs))
        return out
