"""Deterministic list scheduler over per-resource timelines.

Replaces the serial latency sum with a resource-constrained schedule of the
dataflow DAG: every node occupies one device resource ("compute" — the
systolic datapath, "vector" — vector units + HBM streaming, "link" — the
interconnect) for `latency x repeat` seconds, starting once all of its
producers have finished AND its resource is free. Nodes are visited in graph
order (a topological order by construction), which makes the schedule
deterministic and — for a pure chain — reproduces the serial float-summation
order bit-for-bit: start_i = end_{i-1}, so the makespan is the exact
left-to-right sum the seed model computed.

Comm/compute overlap (`pipeline_collectives=True`) models the chunked
execution deployed TP inference actually uses (Megatron's tensor-parallel
communication overlap, ring-exchange RS/AG): a collective's ring steps
interleave with its producer's output tiles, so on the link timeline it may
start when its producer *starts* (not ends), while still never completing
before the producer has finished its last chunk:

    start  = max(link free, max over deps of START)
    finish = max(start + duration, max over deps of END)

Consumers wait for `finish`; the link stays busy for `duration`. This is the
ideal pipelined limit — per-chunk framing overheads are already inside the
LogGP link model, and the schedule's makespan is still bounded below by
every per-resource busy time (tested).

A node with repeat=n stands for n sequential instances (the folded identical
layers of build_model). Scheduling it once with duration n x latency equals
scheduling n copies whose intra-layer edges repeat per instance, because
list-schedule start times are positively homogeneous in the durations; the
one structure this folding cannot express is overlap *across* the layer
boundary, which keeps the model conservative.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .ir import CollectiveSpec, Graph
from .units import Ratio, Seconds

RESOURCES = ("compute", "vector", "link")


@dataclass(frozen=True)
class OpSlot:
    """One scheduled node: where and when it ran."""
    name: str
    resource: str
    start: Seconds
    end: Seconds                    # completion seen by consumers
    duration: Seconds               # resource occupancy (latency x repeat)
    critical_pred: int = -1         # node index that set our start (-1: none)

    @property
    def slack_free(self) -> bool:
        return self.start == 0.0


@dataclass
class Schedule:
    """Per-op timeline + aggregate accounting for one scheduled Graph."""
    slots: List[OpSlot]
    makespan: Seconds
    serial: Seconds                 # left-to-right serial sum (seed metric)
    busy: Dict[str, Seconds]        # per-resource occupied time

    @property
    def overlap_speedup(self) -> Ratio:
        """Serial latency / scheduled latency (>= 1)."""
        return self.serial / self.makespan if self.makespan > 0 else 1.0

    def critical_path(self) -> List[int]:
        """Node indices on the critical path, source to sink. Follows the
        recorded `critical_pred` chain from the last-finishing node, so the
        attribution is exact for the schedule that was actually built."""
        if not self.slots:
            return []
        cur = max(range(len(self.slots)), key=lambda i: self.slots[i].end)
        path = [cur]
        while self.slots[cur].critical_pred >= 0:
            cur = self.slots[cur].critical_pred
            path.append(cur)
        path.reverse()
        return path

    def critical_breakdown(self) -> Dict[str, Seconds]:
        """Critical-path (not additive) attribution: seconds each named op
        contributes along the critical path, plus any scheduling stall."""
        out: Dict[str, Seconds] = {}
        prev_end: Seconds = 0.0
        for i in self.critical_path():
            s = self.slots[i]
            stall = s.start - prev_end
            if stall > 0:
                out["(stall)"] = out.get("(stall)", 0.0) + stall
            # clamp: a pipelined collective predecessor can extend past its
            # successor's own end in pathological hand-built graphs; its
            # contribution is then already attributed upstream
            out[s.name] = out.get(s.name, 0.0) \
                + max(0.0, s.end - max(s.start, prev_end))
            prev_end = max(prev_end, s.end)
        return out

    def summary(self) -> str:
        busy = " ".join(f"{r}={self.busy.get(r, 0.0) * 1e3:.2f}ms"
                        for r in RESOURCES)
        return (f"makespan={self.makespan * 1e3:.2f}ms "
                f"serial={self.serial * 1e3:.2f}ms "
                f"overlap_speedup={self.overlap_speedup:.3f}x {busy}")


def schedule_graph(graph: Graph, latencies: Sequence[float],
                   pipeline_collectives: bool = True,
                   resources: Optional[Sequence[str]] = None) -> Schedule:
    """List-schedule `graph` given per-node latencies (already x repeat).

    `latencies[i]` is node i's resource occupancy in seconds. `resources`
    optionally overrides `ir.resource_of` per node (tests use this to build
    synthetic contention). Returns the per-op timeline; the caller decides
    whether makespan (overlap) or the serial sum prices the graph.
    """
    n = len(graph.nodes)
    if len(latencies) != n:
        raise ValueError(f"got {len(latencies)} latencies for {n} nodes")
    edges = graph.edges()
    res = list(resources) if resources is not None else \
        [node.resource for node in graph.nodes]

    slots: List[OpSlot] = []
    ends: List[Seconds] = []
    starts: List[Seconds] = []
    free: Dict[str, Seconds] = {}
    free_by: Dict[str, int] = {}    # node currently holding each resource
    serial: Seconds = 0.0
    makespan: Seconds = 0.0
    busy: Dict[str, Seconds] = {}

    for i, node in enumerate(graph.nodes):
        dur: Seconds = latencies[i]
        r = res[i]
        deps = edges[i]
        pipelined = (pipeline_collectives and r == "link"
                     and isinstance(node.spec, CollectiveSpec) and deps)

        # -- when can we start? track WHO set the start for attribution ----
        start: Seconds = 0.0
        pred = -1
        for d in deps:
            ready = starts[d] if pipelined else ends[d]
            if ready > start:
                start, pred = ready, d
        if free.get(r, 0.0) > start:
            start, pred = free[r], free_by.get(r, -1)

        end: Seconds = start + dur
        if pipelined:
            # ring chunks interleave with the producer's tiles, but the last
            # chunk cannot complete before the producer does
            for d in deps:
                if ends[d] > end:
                    end, pred = ends[d], d
        free[r] = start + dur
        free_by[r] = i
        busy[r] = busy.get(r, 0.0) + dur
        serial = serial + dur               # left-to-right, seed order
        if end > makespan:
            makespan = end
        starts.append(start)
        ends.append(end)
        slots.append(OpSlot(node.name, r, start, end, dur, pred))

    return Schedule(slots=slots, makespan=makespan, serial=serial, busy=busy)
