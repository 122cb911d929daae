"""Chrome/Perfetto ``trace_event`` export for Schedules and simulator
replays (DESIGN.md §13).

The timestamps here are **virtual**: they come from the analytical model
(`schedule.Schedule` slot times, `simulator.SimResult` event times), never
from a wall clock, so exporting the same object twice — or the same
workload with the mapper's candidate tables on numpy or on the card —
yields byte-identical JSON that can be diffed in CI. `_ts` quantizes
modeled seconds to microseconds at picosecond resolution, which is the
Chrome trace unit and also collapses any 1-ulp float differences between
table devices.

Schedule traces use one process with one thread lane per resource
(compute / vector / link). Every op becomes a matched B/E pair on its
lane; because `schedule_graph` hands each resource's slots out from a
single `free[r]` cursor, same-lane slots are disjoint and emitted in
start order — the validator below checks exactly that. Pipelined
collectives whose consumer-visible `end` exceeds `start + duration` keep
their occupancy-sized B/E pair and get an extra instant marker at the
visible end, so `total_span_us(events) == _ts(makespan)` holds bit-for-bit
even when the last-finishing op is an overlapped collective.

Simulator traces use two processes: an engine process (wave / refill /
decode / idle spans plus a ``live_slots`` counter track) and a requests
process with one lane per request (queued span, generate span, TTFT
instant carrying the TPOT in its args).

All functions on the export path are covered by the purity lint
(tests/test_torch_purity_lint.py): no clocks, no entropy, no env reads, no
bare dict-order iteration.

The PyTorch port's copy of the JAX package's module, whole: the same
objects give the same bytes (tests/test_torch_trace.py).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from .ir import FusedMatmulSpec, Graph
from .schedule import RESOURCES, Schedule
from .simulator import SimResult

__all__ = [
    "schedule_trace_events", "simulation_trace_events", "to_perfetto_json",
    "write_trace", "validate_trace_events", "total_span_us",
]

Event = Dict[str, Any]


def _ts(seconds: float) -> float:
    """Modeled seconds -> trace microseconds, quantized to picoseconds.

    round() is monotone, so max(_ts(end_i)) == _ts(makespan) exactly, and
    the ps quantum erases sub-ulp latency differences between table
    devices without losing any physically meaningful resolution."""
    return round(seconds * 1e6, 6)


# ---------------------------------------------------------------------------
# Schedule -> trace events
# ---------------------------------------------------------------------------

def schedule_trace_events(sch: Schedule, graph: Optional[Graph] = None,
                          pid: int = 0,
                          process_name: str = "schedule") -> List[Event]:
    """Per-resource timeline of one overlap Schedule.

    When the originating `graph` is passed, each span's args carry the op
    kind plus fusion facts (stream_out, elided bytes) so fused seams are
    inspectable in the Perfetto UI."""
    used = []
    for s in sch.slots:
        if s.resource not in used:
            used.append(s.resource)
    lanes = [r for r in RESOURCES if r in used] \
        + sorted(r for r in used if r not in RESOURCES)
    tid_of = {r: i for i, r in enumerate(lanes)}
    crit = frozenset(sch.critical_path())

    events: List[Event] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0, "ts": 0,
         "args": {"name": process_name,
                  "makespan_us": _ts(sch.makespan),
                  "serial_us": _ts(sch.serial)}},
    ]
    for r in lanes:
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid_of[r], "ts": 0, "args": {"name": r}})

    for i, s in enumerate(sch.slots):
        tid = tid_of[s.resource]
        args: Dict[str, Any] = {"critical": i in crit,
                                "duration_us": _ts(s.duration),
                                "resource": s.resource}
        if graph is not None:
            spec = graph.nodes[i].spec
            args["kind"] = type(spec).__name__
            args["repeat"] = graph.nodes[i].repeat
            if isinstance(spec, FusedMatmulSpec):
                args["fused"] = len(spec.epilogue)
                args["stream_out"] = spec.stream_out
                args["elided_bytes"] = spec.elided
        pipelined = s.end > s.start + s.duration
        if pipelined:
            args["pipelined"] = True
            args["end_us"] = _ts(s.end)
        events.append({"name": s.name, "ph": "B", "pid": pid, "tid": tid,
                       "ts": _ts(s.start), "args": args})
        events.append({"name": s.name, "ph": "E", "pid": pid, "tid": tid,
                       "ts": _ts(s.start + s.duration)})
        if pipelined:
            # consumer-visible completion of an overlapped collective: the
            # link lane is already free, so mark it rather than extend B/E
            events.append({"name": f"{s.name}:done", "ph": "i", "pid": pid,
                           "tid": tid, "ts": _ts(s.end), "s": "t"})
    return events


# ---------------------------------------------------------------------------
# SimResult -> trace events
# ---------------------------------------------------------------------------

def simulation_trace_events(sim: SimResult, pid: int = 0) -> List[Event]:
    """Serving-replay timeline: engine phase spans + live-slot counter in
    one process, per-request lifecycle lanes in a second process."""
    events: List[Event] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0, "ts": 0,
         "args": {"name": f"engine[{sim.policy}]",
                  "makespan_us": _ts(sim.makespan)}},
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": 0, "ts": 0,
         "args": {"name": "engine"}},
        {"name": "process_name", "ph": "M", "pid": pid + 1, "tid": 0,
         "ts": 0, "args": {"name": "requests"}},
    ]
    for kind, t0, t1 in sim.events:
        events.append({"name": kind, "ph": "B", "pid": pid, "tid": 0,
                       "ts": _ts(t0)})
        events.append({"name": kind, "ph": "E", "pid": pid, "tid": 0,
                       "ts": _ts(t1)})
    for t, occ in sim.occupancy:
        events.append({"name": "live_slots", "ph": "C", "pid": pid,
                       "tid": 0, "ts": _ts(t), "args": {"slots": occ}})

    for i, r in enumerate(sim.requests):
        tid = i + 1
        events.append({"name": "thread_name", "ph": "M", "pid": pid + 1,
                       "tid": tid, "ts": 0,
                       "args": {"name": f"req{r.index}"}})
        events.append({"name": "queued", "ph": "B", "pid": pid + 1,
                       "tid": tid, "ts": _ts(r.arrival),
                       "args": {"in_len": r.in_len, "out_len": r.out_len}})
        events.append({"name": "queued", "ph": "E", "pid": pid + 1,
                       "tid": tid, "ts": _ts(r.admitted)})
        events.append({"name": "generate", "ph": "B", "pid": pid + 1,
                       "tid": tid, "ts": _ts(r.admitted),
                       "args": {"emitted": r.emitted}})
        events.append({"name": "first_token", "ph": "i", "pid": pid + 1,
                       "tid": tid, "ts": _ts(r.arrival + r.ttft), "s": "t",
                       "args": {"ttft_us": _ts(r.ttft),
                                "tpot_us": _ts(r.tpot)}})
        events.append({"name": "generate", "ph": "E", "pid": pid + 1,
                       "tid": tid, "ts": _ts(r.arrival + r.e2e)})
    return events


# ---------------------------------------------------------------------------
# serialization + validation
# ---------------------------------------------------------------------------

def to_perfetto_json(events: List[Event]) -> str:
    """Canonical (sorted-keys, no-whitespace) trace JSON — identical event
    lists serialize to identical bytes."""
    return json.dumps({"traceEvents": events, "displayTimeUnit": "ms"},
                      sort_keys=True, separators=(",", ":"))


def write_trace(path: str, events: List[Event]) -> str:
    text = to_perfetto_json(events)
    with open(path, "w") as f:
        f.write(text)
        f.write("\n")
    return text


def validate_trace_events(events: List[Event]) -> List[str]:
    """Chrome trace_event schema checks: required keys, known phases,
    non-negative timestamps, and per-(pid, tid) lane discipline — matched
    same-name B/E pairs with non-decreasing timestamps."""
    errors: List[str] = []
    stacks: Dict[Tuple[int, int], List[Tuple[str, float]]] = {}
    last_ts: Dict[Tuple[int, int], float] = {}
    for i, e in enumerate(events):
        missing = [k for k in ("name", "ph", "pid", "tid", "ts")
                   if k not in e]
        if missing:
            errors.append(f"event {i}: missing keys {missing}")
            continue
        ph = e["ph"]
        if ph not in ("B", "E", "M", "i", "C"):
            errors.append(f"event {i}: unknown phase {ph!r}")
            continue
        ts = e["ts"]
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i}: bad ts {ts!r}")
            continue
        if ph == "M":
            continue
        lane = (e["pid"], e["tid"])
        if ph in ("B", "E"):
            if ts < last_ts.get(lane, 0.0):
                errors.append(f"event {i}: ts {ts} goes backwards on lane "
                              f"{lane}")
            last_ts[lane] = ts
            stack = stacks.setdefault(lane, [])
            if ph == "B":
                stack.append((e["name"], ts))
            else:
                if not stack:
                    errors.append(f"event {i}: E without B on lane {lane}")
                else:
                    bname, bts = stack.pop()
                    if bname != e["name"]:
                        errors.append(f"event {i}: E {e['name']!r} closes "
                                      f"B {bname!r} on lane {lane}")
                    if ts < bts:
                        errors.append(f"event {i}: E before its B on lane "
                                      f"{lane}")
    for lane, stack in sorted(stacks.items()):
        if stack:
            errors.append(f"lane {lane}: {len(stack)} unclosed B events")
    return errors


def total_span_us(events: List[Event]) -> float:
    """Last virtual timestamp in the trace (metadata excluded). For a
    Schedule export this equals `_ts(makespan)` bit-for-bit."""
    out = 0.0
    for e in events:
        if e.get("ph") != "M" and e.get("ts", 0) > out:
            out = e["ts"]
    return out
