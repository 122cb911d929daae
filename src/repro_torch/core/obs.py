"""Observability core: process-wide metrics registry, wall-clock phase
spans, and per-op attribution records.

Three concerns live here, all deliberately decoupled from the pricing
models they observe:

  * `MetricsRegistry` — process-wide counters/gauges/histograms. The
    scattered cache statistics (mapper memo/disk hits, result-cache
    hits/puts, verifier diagnostics, chunk-backend selections) all feed
    this one registry; the per-module stats objects
    (`mapper.MapperCacheStats`, `result_cache.DiskCacheStats`,
    `evaluator.EvalStats`) remain as compatibility views/mirrors over it.
    Counters are plain dict increments — always on, same cost as the
    attribute adds they replaced.

  * phase spans — `with metrics().phase("presolve"): ...` records
    wall-clock seconds per named framework phase (presolve / search /
    schedule / verify), so a caller (`chip_smoke.py`'s study phase) can
    report where the framework's OWN time goes. Spans are the only wall-clock reads in the
    subsystem and are **zero-overhead when off**: with spans disabled
    (the default) `phase()` returns a shared no-op context manager and
    never touches the clock.

  * `Attribution` — the structured per-op report for one evaluated graph:
    latency/flops/bytes per op and per layer group, bound classification,
    fusion savings (elided HBM bytes, from `FusedMatmulSpec.elided` — the
    single source of truth shared with `fusion.elided_bytes`), and
    collective exposure (critical-path seconds) vs hidden (overlapped)
    time. Wired into `study.CaseResult` so a finished Study can answer
    "why did case A beat case B" without re-running anything.

Everything here uses *modeled* quantities (virtual time, analytic bytes);
only phase spans read the wall clock. The trace exporters live in
core/trace_export.py and consume Schedules/SimResults directly.

The PyTorch port's copy of the JAX package's module, whole.
"""
from __future__ import annotations

import csv
import io
import json
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from .ir import FusedMatmulSpec, resource_of

__all__ = [
    "MetricsRegistry", "metrics", "AttrRow", "Attribution", "attribute",
    "combine", "layer_group",
]


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

class _NullSpan:
    """Shared no-op context manager returned by phase() when spans are off
    (no allocation, no clock read)."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One live wall-clock phase measurement."""
    __slots__ = ("_reg", "_name", "_t0")

    def __init__(self, reg: "MetricsRegistry", name: str) -> None:
        self._reg = reg
        self._name = name
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> bool:
        dt = time.perf_counter() - self._t0
        ph = self._reg._phases.get(self._name)
        if ph is None:
            self._reg._phases[self._name] = [1, dt]
        else:
            ph[0] += 1
            ph[1] += dt
        return False


@dataclass
class _Hist:
    """Streaming summary of an observed distribution (no sample storage)."""
    count: int = 0
    total: float = 0.0
    min: float = 0.0
    max: float = 0.0

    def observe(self, v: float) -> None:
        if self.count == 0:
            self.min = self.max = v
        else:
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
        self.count += 1
        self.total += v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricsRegistry:
    """Process-wide named counters, gauges, histograms and phase spans.

    Counters are monotone and always on (`inc`); consumers that want a
    window (e.g. `mapper.MapperCacheStats`) snapshot a baseline and report
    deltas, so the registry itself is never reset mid-process. Phase spans
    (`phase`) are wall-clock and gated by `enabled` — off by default.
    """

    def __init__(self) -> None:
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Hist] = {}
        self._phases: Dict[str, List[float]] = {}   # name -> [count, secs]
        self.enabled = False        # gates phase spans (wall-clock) only

    # -- counters ----------------------------------------------------------
    def inc(self, name: str, value: float = 1.0) -> None:
        self._counters[name] = self._counters.get(name, 0.0) + value

    def counter(self, name: str) -> float:
        return self._counters.get(name, 0.0)

    def counters(self, prefix: str = "") -> Dict[str, float]:
        return {k: v for k, v in sorted(self._counters.items())
                if k.startswith(prefix)}

    # -- gauges ------------------------------------------------------------
    def set_gauge(self, name: str, value: float) -> None:
        self._gauges[name] = value

    def gauge(self, name: str) -> float:
        return self._gauges.get(name, 0.0)

    # -- histograms --------------------------------------------------------
    def observe(self, name: str, value: float) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = _Hist()
        h.observe(value)

    def histogram(self, name: str) -> _Hist:
        return self._hists.get(name, _Hist())

    # -- phase spans (wall-clock; the only clock reads in the subsystem) ---
    def set_enabled(self, flag: bool) -> bool:
        """Turn phase spans on/off; returns the previous setting."""
        prev = self.enabled
        self.enabled = bool(flag)
        return prev

    def phase(self, name: str):
        """Context manager timing one framework phase. A shared no-op when
        spans are disabled — zero clock reads, zero allocation."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name)

    def phase_seconds(self) -> Dict[str, float]:
        return {k: v[1] for k, v in sorted(self._phases.items())}

    def phase_counts(self) -> Dict[str, int]:
        return {k: int(v[0]) for k, v in sorted(self._phases.items())}

    # -- reporting ---------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """Flat {name: value} view of every counter, gauge and phase total
        (phases as `phase.<name>.seconds` / `.count`), for delta-taking."""
        out: Dict[str, float] = {}
        for k, v in sorted(self._counters.items()):
            out[k] = v
        for k, v in sorted(self._gauges.items()):
            out[f"gauge.{k}"] = v
        for k, cv in sorted(self._phases.items()):
            out[f"phase.{k}.count"] = cv[0]
            out[f"phase.{k}.seconds"] = cv[1]
        return out

    def merge_delta(self, delta: Dict[str, float]) -> None:
        """Fold a worker process's snapshot delta (`snapshot()` minus a
        baseline taken at worker start) into this registry: counters and
        phase spans ADD, gauges overwrite (last writer wins — gauges are
        point-in-time readings, not totals).

        This is what makes baseline-window views (`mapper.MapperCacheStats`)
        merge-safe across `Study.run(workers=N)` joins: worker activity is
        invisible to the parent's counters while the shard runs, then lands
        exactly once at join — a window constructed before the run reports
        the summed cross-process activity, never a torn intermediate state.
        """
        for k in sorted(delta):
            v = delta[k]
            if k.startswith("gauge."):
                self._gauges[k[len("gauge."):]] = v
            elif k.startswith("phase.") and k.endswith(".count"):
                ph = self._phases.setdefault(
                    k[len("phase."):-len(".count")], [0, 0.0])
                ph[0] += v
            elif k.startswith("phase.") and k.endswith(".seconds"):
                ph = self._phases.setdefault(
                    k[len("phase."):-len(".seconds")], [0, 0.0])
                ph[1] += v
            else:
                self.inc(k, v)

    def summary(self) -> str:
        parts = [f"{k}={v:g}" for k, v in sorted(self._counters.items())]
        parts += [f"phase.{k}={v[1]:.4f}s/{int(v[0])}"
                  for k, v in sorted(self._phases.items())]
        return " ".join(parts) if parts else "(empty)"


_REGISTRY = MetricsRegistry()


def metrics() -> MetricsRegistry:
    """The process-wide registry every subsystem reports into."""
    return _REGISTRY


# ---------------------------------------------------------------------------
# layer-group classification (attribution reports)
# ---------------------------------------------------------------------------

def layer_group(name: str) -> str:
    """Coarse layer-group bucket for an op name from graph.py's builder
    vocabulary: "attn" (token mixers: attention, recurrence, conv),
    "mlp" (channel mixers: FFN, MoE experts), "comm" (collectives and
    expert dispatch), "head" (embedding / final norm / lm head), "other".
    Attribution prefixes ("prefill/") and fused names ("qk_t+softmax")
    classify by their leading op."""
    base = name.rsplit("/", 1)[-1].split("+", 1)[0]
    for p in ("x_", "enc_"):
        if base.startswith(p):
            base = base[len(p):]
    if ("allreduce" in base or base.endswith(("_rs", "_ag"))
            or base in ("moe_dispatch", "moe_combine", "p2p")):
        return "comm"
    if base in ("embed", "ln_final") or base.startswith("lm_"):
        return "head"
    if base.startswith(("ln_mlp", "router", "expert", "moe", "w1", "w2",
                        "act", "gelu", "cmix")):
        return "mlp"
    if base.startswith(("ln_attn", "qkv", "qk", "rope", "kv", "softmax",
                        "a_mul_v", "o_proj", "tmix", "wkv", "rec", "rg_lru",
                        "conv1d", "gate", "attn")):
        return "attn"
    return "other"


# ---------------------------------------------------------------------------
# attribution records
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AttrRow:
    """One op of an attributed graph (all times modeled/virtual seconds)."""
    name: str
    group: str              # layer_group bucket
    resource: str           # compute | vector | link
    bound: str              # compute | memory | overhead | link
    latency: float          # resource occupancy, x repeat
    flops: float
    bytes: float            # main-memory traffic, x repeat
    elided: float           # HBM bytes fusion removed (x repeat)
    repeat: int
    critical: bool          # on the schedule's critical path
    start: float            # schedule start (serial: running prefix sum)
    end: float              # consumer-visible end
    exposed: float          # critical-path seconds (serial: == latency)


@dataclass(frozen=True)
class Attribution:
    """Per-op/per-group attribution of one evaluated graph (or a labeled
    bundle of graphs, e.g. a generate case's prefill + decode sections)."""
    label: str
    total: float            # priced latency (makespan when scheduled)
    serial: float           # serial (no-overlap) sum
    rows: Tuple[AttrRow, ...]

    # -- aggregates --------------------------------------------------------
    @property
    def elided(self) -> float:
        """Total HBM bytes the fusion rewrites removed (fusion savings)."""
        return sum(r.elided for r in self.rows)

    @property
    def link_exposed(self) -> float:
        """Collective seconds the makespan actually waits on."""
        return sum(r.exposed for r in self.rows if r.resource == "link")

    @property
    def link_hidden(self) -> float:
        """Collective seconds overlapped behind compute/vector work."""
        return sum(max(0.0, r.latency - r.exposed) for r in self.rows
                   if r.resource == "link")

    def by_group(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for r in self.rows:
            g = out.setdefault(r.group, {"latency": 0.0, "flops": 0.0,
                                         "bytes": 0.0, "elided": 0.0})
            g["latency"] += r.latency
            g["flops"] += r.flops
            g["bytes"] += r.bytes
            g["elided"] += r.elided
        return out

    def by_bound(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.rows:
            out[r.bound] = out.get(r.bound, 0.0) + r.latency
        return out

    # -- structured output -------------------------------------------------
    def to_rows(self) -> List[dict]:
        return [{"name": r.name, "group": r.group, "resource": r.resource,
                 "bound": r.bound, "latency_s": r.latency, "flops": r.flops,
                 "bytes": r.bytes, "elided_bytes": r.elided,
                 "repeat": r.repeat, "critical": r.critical,
                 "start_s": r.start, "end_s": r.end, "exposed_s": r.exposed}
                for r in self.rows]

    def to_csv(self, path: Optional[str] = None) -> str:
        rows = self.to_rows()
        buf = io.StringIO()
        if rows:
            w = csv.DictWriter(buf, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        text = buf.getvalue()
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def to_json(self) -> str:
        return json.dumps(self.to_doc(), sort_keys=True,
                          separators=(",", ":"))

    # -- cache-doc round trip (study.py CaseResult layer) ------------------
    def to_doc(self) -> dict:
        return {"label": self.label, "total": self.total,
                "serial": self.serial,
                "rows": [[r.name, r.group, r.resource, r.bound, r.latency,
                          r.flops, r.bytes, r.elided, r.repeat,
                          int(r.critical), r.start, r.end, r.exposed]
                         for r in self.rows]}

    @classmethod
    def from_doc(cls, doc: dict) -> Optional["Attribution"]:
        try:
            rows = tuple(
                AttrRow(str(n), str(g), str(res), str(b), float(lat),
                        float(fl), float(by), float(el), int(rep),
                        bool(cr), float(st), float(en), float(ex))
                for n, g, res, b, lat, fl, by, el, rep, cr, st, en, ex
                in doc["rows"])
            return cls(str(doc["label"]), float(doc["total"]),
                       float(doc["serial"]), rows)
        except (KeyError, TypeError, ValueError):
            return None                 # malformed/older entry


def attribute(graph, cost, label: str = "", prefix: str = "") -> Attribution:
    """Build the Attribution for one evaluated graph.

    `cost` is the graph's `graph.LayerCost` (ops aligned 1:1 with
    graph.nodes, latencies already x repeat). When the cost carries an
    overlap schedule, start/end come from the per-resource timeline and
    `exposed` is each op's critical-path contribution; for a serially
    priced graph every op is "critical" and fully exposed, with start/end
    the left-to-right prefix sums. Elided bytes come from
    `FusedMatmulSpec.elided` — the same per-spec accounting
    `fusion.elided_bytes` sums, so the two surfaces cannot diverge."""
    sch = cost.schedule
    crit_idx = frozenset(sch.critical_path()) if sch is not None \
        else frozenset()
    crit_secs = sch.critical_breakdown() if sch is not None else {}
    rows = []
    t = 0.0
    for i, (node, op) in enumerate(zip(graph.nodes, cost.ops)):
        if sch is not None:
            slot = sch.slots[i]
            start, end = slot.start, slot.end
        else:
            start = t
            t = t + op.latency
            end = t
        spec = node.spec
        elided = node.repeat * spec.elided \
            if isinstance(spec, FusedMatmulSpec) else 0.0
        if sch is None:
            critical, exposed = True, op.latency
        else:
            critical = i in crit_idx
            exposed = min(op.latency, crit_secs.get(node.name, 0.0)) \
                if critical else 0.0
        rows.append(AttrRow(
            prefix + node.name, layer_group(node.name), resource_of(spec),
            op.bound, op.latency, op.flops, op.main_memory_bytes, elided,
            node.repeat, critical, start, end, exposed))
    return Attribution(label, cost.latency, cost.serial_latency, tuple(rows))


def combine(label: str, atts: Iterable[Attribution]) -> Attribution:
    """Concatenate several section Attributions (e.g. prefill + decode)
    into one labeled record; totals add across sections."""
    atts = list(atts)
    rows: Tuple[AttrRow, ...] = ()
    for a in atts:
        rows = rows + a.rows
    return Attribution(label, sum(a.total for a in atts),
                       sum(a.serial for a in atts), rows)
