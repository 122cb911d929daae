"""Trace-driven continuous-batching serving simulator.

Answers request-level serving questions — p99 TTFT under Poisson arrivals,
goodput of continuous vs static batching, slot occupancy — analytically, per
hardware design, in seconds: the event loop replays the REAL engine's
scheduling policy (`core.scheduler.SlotScheduler`, the same object
`serving/engine.py` drives) but prices every prefill wave and decode round
with `inference_model`-built graphs evaluated through one shared Evaluator
instead of timing real kernels.

Cost model (mirrors the engine's static-shape execution):

  * a whole-batch admission wave (scheduler idle) prefills all `slots` rows
    right-padded to the wave's longest prompt: priced as one
    `build_model(batch=slots, seq=S)` graph;
  * a refill admission (scheduler busy) prefills each request alone and
    stalls decode while doing so: priced as batch-1 prefills at each
    request's prompt length;
  * a decode round advances ALL slots (dead ones masked): priced as
    `build_model(batch=slots, seq=1, kv_len=max live context)`.

To keep the mapper out of the event loop, the kv and prompt-length axes are
sampled (`kv_samples` / `seq_samples` points, the trick
`inference_model.generate` uses for its decode trapezoid) and every sampled
graph is evaluated in ONE `evaluate_many` call — all unique GEMM shapes of
the whole trace go through a single stacked mapper search; per-round costs
are linear interpolations between sample points. Following generate()'s
accounting, the first output token is priced as a decode round at
kv = in_len right after the prefill wave, so a constant-arrival uniform
trace reproduces `generate()`/`throughput()` within a fraction of a percent.

The PyTorch port's copy of the JAX package's simulator, on the port's
`SlotScheduler`, whose `serving/engine.py` it mirrors.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..configs.base import ModelConfig
from . import inference_model as im
from .evaluator import Evaluator
from .fusion import SERIAL, FusionPolicy, fuse
from .graph import Graph, LayerCost, Plan, build_model
from .hardware import System
from .precision import DEFAULT, PrecisionPolicy
from .scheduler import SlotScheduler
from .units import Bytes, Flops, PerSecond, Ratio, Seconds
from . import verify as verify_mod
from .workload import Trace, TrafficWorkload

__all__ = ["Trace", "TrafficWorkload", "SimResult", "RequestStats",
           "simulate", "trace_graphs"]


# ---------------------------------------------------------------------------
# sampled cost tables
# ---------------------------------------------------------------------------

@dataclass
class _RoundCost:
    """Price of one engine round: latency + accounting to aggregate."""
    latency: Seconds
    flops: Flops
    bytes: Bytes
    bound: Dict[str, float]

    @classmethod
    def of(cls, c: LayerCost) -> "_RoundCost":
        return cls(c.latency, c.flops, c.bytes, c.by_bound())


def _lerp(a: _RoundCost, b: _RoundCost, w: float) -> _RoundCost:
    if w <= 0.0:
        return a
    keys = set(a.bound) | set(b.bound)
    return _RoundCost(
        a.latency + (b.latency - a.latency) * w,
        a.flops + (b.flops - a.flops) * w,
        a.bytes + (b.bytes - a.bytes) * w,
        {k: a.bound.get(k, 0.0)
         + (b.bound.get(k, 0.0) - a.bound.get(k, 0.0)) * w for k in keys})


class _Interp:
    """Piecewise-linear interpolation of _RoundCost over an integer axis."""

    def __init__(self, xs: Sequence[int], costs: Sequence[LayerCost]):
        self.xs = list(xs)
        self.cs = [_RoundCost.of(c) for c in costs]

    def at(self, x: int) -> _RoundCost:
        xs = self.xs
        if x <= xs[0] or len(xs) == 1:
            return self.cs[0]
        if x >= xs[-1]:
            return self.cs[-1]
        j = int(np.searchsorted(xs, x, side="right"))
        lo, hi = xs[j - 1], xs[j]
        return _lerp(self.cs[j - 1], self.cs[j], (x - lo) / (hi - lo))


def _subsample(values, k: int) -> List[int]:
    """Up to k representative points from a set of values (endpoints kept,
    every point is a real member so exact shapes stay exact)."""
    values = sorted(set(values))
    if len(values) <= k or k < 2:
        return values[:max(k, 1)]
    idx = {round(i * (len(values) - 1) / (k - 1)) for i in range(k)}
    return [values[i] for i in sorted(idx)]


def _axis_points(lo: int, hi: int, k: int) -> List[int]:
    """generate()-style integer grid spanning [lo, hi]."""
    if hi <= lo or k < 2:
        return [lo]
    return sorted({lo + round(i * (hi - lo) / (k - 1)) for i in range(k)})


def _axes(traffic: TrafficWorkload) -> Tuple[List[int], List[int]]:
    trace = traffic.trace
    in_pts = _subsample([r.in_len for r in trace], traffic.seq_samples)
    kv_lo = min(r.in_len for r in trace)
    kv_hi = trace.max_total_len - 1
    kv_pts = _axis_points(kv_lo, kv_hi, traffic.kv_samples)
    return in_pts, kv_pts


def _graphs_and_axes(cfg: ModelConfig, plan: Plan, traffic: TrafficWorkload,
                     policy: PrecisionPolicy = DEFAULT,
                     fusion: FusionPolicy = SERIAL
                     ) -> Tuple[List[Graph], List[int], List[int]]:
    """(graphs, in_pts, kv_pts) — the graph list is laid out as
    [wave prefills at in_pts | refill prefills at in_pts | decodes at
    kv_pts], and returning the axes alongside keeps simulate()'s slicing
    structurally aligned with the build. Graphs are rewritten under
    `fusion`'s kernel-fusion rules before pricing."""
    if not len(traffic.trace):
        raise ValueError("traffic has an empty trace")
    in_pts, kv_pts = _axes(traffic)
    B = traffic.batch
    graphs = ([build_model(cfg, plan, B, S, kv_len=S, policy=policy)
               for S in in_pts]
              + [build_model(cfg, plan, 1, S, kv_len=S, policy=policy)
                 for S in in_pts]
              + [build_model(cfg, plan, B, seq=1, kv_len=kv, policy=policy)
                 for kv in kv_pts])
    return [fuse(g, fusion) for g in graphs], in_pts, kv_pts


def trace_graphs(cfg: ModelConfig, plan: Plan, traffic: TrafficWorkload,
                 policy: PrecisionPolicy = DEFAULT,
                 fusion: FusionPolicy = SERIAL) -> List[Graph]:
    """Every symbolic graph simulate() will price for this traffic — wave
    prefills (batch=slots) and refill prefills (batch=1) at the sampled
    prompt lengths, plus decode rounds at the sampled kv points. Exposed so
    study.Study can pre-collect the GEMM shapes of a whole serve-stage grid
    into one device-axis stacked mapper search."""
    return _graphs_and_axes(cfg, plan, traffic, policy, fusion)[0]


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

@dataclass
class RequestStats:
    """Per-request serving record (all times in seconds)."""
    index: int
    arrival: Seconds
    in_len: int
    out_len: int
    admitted: Seconds = 0.0     # end of the prefill wave that admitted it
    ttft: Seconds = 0.0         # arrival -> first output token
    e2e: Seconds = 0.0          # arrival -> last output token
    emitted: int = 0

    @property
    def tpot(self) -> Seconds:
        """Mean time per output token after the first."""
        return (self.e2e - self.ttft) / (self.out_len - 1) \
            if self.out_len > 1 else 0.0


@dataclass
class SimResult:
    """Request-level metrics of one simulated trace replay."""
    requests: List[RequestStats]
    slots: int
    policy: str
    makespan: Seconds           # clock at last completion (arrivals from t=0)
    tokens_out: int
    waves: int                  # admission waves priced
    rounds: int                 # decode rounds priced
    prefill_busy: Seconds
    decode_busy: Seconds
    idle: Seconds               # engine idle, waiting for arrivals
    occupancy: List[Tuple[float, int]]   # (time, live slots) after events
    slot_seconds: Seconds       # integral of live slots over time
    flops: Flops
    bytes: Bytes
    bound: Dict[str, float] = field(default_factory=dict)
    #: engine phase spans for the trace exporter (core/trace_export.py):
    #: ("wave" | "refill" | "decode" | "idle", start, end) in virtual seconds
    events: List[Tuple[str, Seconds, Seconds]] = field(default_factory=list)

    # -- percentiles -------------------------------------------------------
    def ttft(self, p: float = 50.0) -> Seconds:
        return float(np.percentile([r.ttft for r in self.requests], p))

    def tpot(self, p: float = 50.0) -> Seconds:
        vals = [r.tpot for r in self.requests if r.out_len > 1]
        return float(np.percentile(vals, p)) if vals else 0.0

    def e2e(self, p: float = 50.0) -> Seconds:
        return float(np.percentile([r.e2e for r in self.requests], p))

    # -- aggregates --------------------------------------------------------
    @property
    def goodput(self) -> PerSecond:
        """Output tokens per second over the whole replay."""
        return self.tokens_out / self.makespan if self.makespan > 0 else 0.0

    @property
    def request_rate(self) -> PerSecond:
        return len(self.requests) / self.makespan if self.makespan > 0 \
            else 0.0

    @property
    def mean_occupancy(self) -> Ratio:
        """Time-averaged fraction of slots holding a live request."""
        busy: Seconds = self.makespan - self.idle
        return self.slot_seconds / (busy * self.slots) if busy > 0 else 0.0

    @property
    def dominant(self) -> str:
        return max(self.bound, key=self.bound.get) if self.bound else "n/a"

    def goodput_slo(self, ttft_slo: Optional[Seconds] = None,
                    tpot_slo: Optional[Seconds] = None) -> PerSecond:
        """Goodput counting only requests meeting the given SLOs."""
        toks = sum(r.out_len for r in self.requests
                   if (ttft_slo is None or r.ttft <= ttft_slo)
                   and (tpot_slo is None or r.tpot <= tpot_slo))
        return toks / self.makespan if self.makespan > 0 else 0.0

    def summary(self) -> str:
        return (f"{self.policy}: {len(self.requests)} reqs "
                f"{self.tokens_out} toks in {self.makespan:.3f}s "
                f"goodput={self.goodput:.1f} tok/s "
                f"ttft p50/p99={self.ttft(50):.4f}/{self.ttft(99):.4f}s "
                f"tpot p50/p99={self.tpot(50):.5f}/{self.tpot(99):.5f}s "
                f"occ={self.mean_occupancy:.0%} waves={self.waves} "
                f"rounds={self.rounds}")


# ---------------------------------------------------------------------------
# the event loop
# ---------------------------------------------------------------------------

def simulate(system: System, cfg: ModelConfig, plan: Plan,
             traffic: TrafficWorkload,
             evaluator: Optional[Evaluator] = None,
             policy: PrecisionPolicy = DEFAULT,
             fusion: FusionPolicy = SERIAL,
             verify: Optional[str] = None,
             device: str = "cuda") -> SimResult:
    """Replay `traffic.trace` through the engine's slot scheduler, pricing
    every wave/round analytically. See the module docstring for the model.
    Without an `evaluator`, one is made whose mapper tables run on
    `device` (``"cuda"``, or ``"cpu"`` for numpy).

    `policy` prices every wave/round at a quantization point; `fusion`
    prices it at an execution-model point (fused kernels and/or
    overlap-scheduled rounds). The slot count stays `traffic.batch` — to let a quantized KV cache raise it,
    size the TrafficWorkload with
    `slots=inference_model.max_batch(..., policy=...)` (an int8-KV policy
    budgets roughly twice the fp16 slots at equal memory; the serve-stage
    Study memory gate checks that budget under the case's policy)."""
    if not isinstance(policy, PrecisionPolicy):
        raise TypeError(
            f"simulate()'s `policy` is a precision.PrecisionPolicy, got "
            f"{policy!r} — the scheduler policy string "
            f"('continuous'/'static') belongs on the TrafficWorkload")
    trace = traffic.trace
    n = len(trace)
    if n == 0:
        raise ValueError("traffic has an empty trace")
    if any(r.out_len < 1 for r in trace):
        raise ValueError("every trace request must generate >= 1 token")
    B = traffic.batch
    # static verification: plan + policy rules up front; the
    # sampled wave/round graphs are linted by the Evaluator below. Memory
    # capacity is the serve-stage Study gate's call, not re-proved here.
    mode = verify_mod.resolve_mode(verify)
    if mode != "off":
        diags = verify_mod.plan_diagnostics(
            system, cfg, plan, policy=policy, batch=B,
            max_len=traffic.total_len, check_memory=False)
        diags += verify_mod.policy_diagnostics(policy, system.device)
        verify_mod.apply_mode(diags, mode)
    ev = im._evaluator(system, evaluator, verify=mode, device=device)

    # ---- price all sampled graphs in ONE batched evaluation --------------
    graphs, in_pts, kv_pts = _graphs_and_axes(cfg, plan, traffic, policy,
                                              fusion)
    costs = ev.evaluate_many(graphs, overlap=fusion.overlap)
    k = len(in_pts)
    wave_tbl = _Interp(in_pts, costs[:k])            # batch=slots prefill
    one_tbl = _Interp(in_pts, costs[k:2 * k])        # batch=1 refill prefill
    dec_tbl = _Interp(kv_pts, costs[2 * k:])         # batch=slots decode
    dec_fill: Seconds = im.pp_fill(system, plan, B, cfg.d_model, policy)

    sched = SlotScheduler(B, policy=traffic.policy)
    recs = [RequestStats(i, r.arrival, r.in_len, r.out_len)
            for i, r in enumerate(trace)]

    t = 0.0
    i_next = 0                  # next not-yet-arrived trace index
    waiting: List[int] = []     # arrived, not yet admitted (record indices)
    done = 0
    tokens_out = waves = rounds = 0
    prefill_busy = decode_busy = idle = slot_seconds = 0.0
    flops = bytes_ = 0.0
    bound: Dict[str, float] = {}
    occupancy: List[Tuple[float, int]] = []
    events: List[Tuple[str, float, float]] = []

    def account(c: _RoundCost, fill: Seconds) -> Seconds:
        nonlocal flops, bytes_
        flops += c.flops
        bytes_ += c.bytes
        for key, v in c.bound.items():
            bound[key] = bound.get(key, 0.0) + v
        if fill > 0:
            bound["link"] = bound.get("link", 0.0) + fill
        return c.latency + fill

    while done < n:
        while i_next < n and trace.requests[i_next].arrival <= t:
            waiting.append(i_next)
            i_next += 1
        live = sched.live_slots()
        pairs = sched.plan_wave([recs[j] for j in waiting],
                                more_coming=i_next < n)
        if pairs:
            # ---- admission wave: price the prefill(s), then occupy -------
            wave = [r for _, r in pairs]
            if sched.idle:
                kind = "wave"
                S = max(r.in_len for r in wave)
                dt = account(wave_tbl.at(S),
                             im.pp_fill(system, plan, B * S, cfg.d_model,
                                        policy))
            else:
                kind = "refill"
                dt = 0.0
                for r in wave:
                    dt += account(one_tbl.at(r.in_len),
                                  im.pp_fill(system, plan, r.in_len,
                                             cfg.d_model, policy))
            slot_seconds += len(live) * dt
            events.append((kind, t, t + dt))
            t += dt
            prefill_busy += dt
            waves += 1
            admitted = set()
            for slot, rec in pairs:
                sched.admit(slot, rec, rec.out_len)
                rec.admitted = t
                admitted.add(rec.index)
            waiting = [j for j in waiting if j not in admitted]
            occupancy.append((t, len(sched.live_slots())))
        elif live:
            # ---- decode round: all slots advance, kv = max live context --
            kv = max(sched.slot_req[s].in_len + sched.slot_req[s].emitted
                     for s in live)
            dt = account(dec_tbl.at(kv), dec_fill)
            slot_seconds += len(live) * dt
            events.append(("decode", t, t + dt))
            t += dt
            decode_busy += dt
            rounds += 1
            for slot in live:
                rec = sched.slot_req[slot]
                rec.emitted += 1
                tokens_out += 1
                if rec.emitted == 1:
                    rec.ttft = t - rec.arrival
                if sched.step(slot):
                    rec.e2e = t - rec.arrival
                    done += 1
            occupancy.append((t, len(sched.live_slots())))
        else:
            # ---- nothing runnable: fast-forward to the next arrival ------
            if i_next >= n:
                raise RuntimeError(
                    "simulator deadlock: no live slots, no waiting "
                    "requests, no future arrivals")
            idle += trace.requests[i_next].arrival - t
            events.append(("idle", t, trace.requests[i_next].arrival))
            t = trace.requests[i_next].arrival

    return SimResult(requests=recs, slots=B, policy=traffic.policy,
                     makespan=t, tokens_out=tokens_out, waves=waves,
                     rounds=rounds, prefill_busy=prefill_busy,
                     decode_busy=decode_busy, idle=idle,
                     occupancy=occupancy, slot_seconds=slot_seconds,
                     flops=flops, bytes=bytes_, bound=bound, events=events)
