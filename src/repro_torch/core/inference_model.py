"""End-to-end LLM inference performance model (paper Sec. III-B / IV / V).

prefill latency, per-token decode latency, end-to-end generation latency,
max batch under memory capacity, and throughput — for a System + ModelConfig
+ Plan. Pipeline parallelism follows the paper's description (sequential
stage partitions; throughput multiplies by stages once the pipeline is full,
latency gains nothing).

All entry points build symbolic IR (graph.build_model) and evaluate it with
an Evaluator; pass a shared `evaluator` to amortize the cost model across
calls (the planner does this across its whole plan sweep). `generate`
evaluates the prefill graph and every decode-KV trapezoid sample in ONE
batched evaluation — the unique GEMM shapes of all sample points go through
a single stacked mapper search. Without a shared `evaluator` each call makes
one whose mapper tables run on the card (`Evaluator`'s default device).

The PyTorch port's copy of the JAX package's module, whole.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from ..configs.base import ModelConfig
from .evaluator import Evaluator
from .fusion import SERIAL, FusionPolicy, fuse
from .hardware import System
from .graph import LayerCost, Plan, build_model
from .precision import DEFAULT, PrecisionPolicy
from .units import Bytes, Flops, PerSecond, Seconds
from . import interconnect as net


@dataclass
class PerfReport:
    latency: Seconds
    flops: Flops
    bytes: Bytes
    breakdown: Dict[str, float] = field(default_factory=dict)
    bound: Dict[str, float] = field(default_factory=dict)
    serial_latency: Seconds = 0.0   # no-overlap sum (== latency when serial)
    schedule: object = None         # per-op timeline (overlap mode, 1 graph)

    @property
    def dominant(self) -> str:
        return max(self.bound, key=self.bound.get) if self.bound else "n/a"


def _report(cost: LayerCost) -> PerfReport:
    return PerfReport(latency=cost.latency, flops=cost.flops,
                      bytes=cost.bytes, breakdown=cost.breakdown(),
                      bound=cost.by_bound(),
                      serial_latency=cost.serial_latency,
                      schedule=cost.schedule)


def _evaluator(system: System, evaluator: Optional[Evaluator],
               verify: Optional[str] = None,
               device: str = "cuda") -> Evaluator:
    """The caller's Evaluator, checked against `system`, or a new one whose
    mapper tables run on `device`."""
    if evaluator is None:
        return Evaluator(system, verify=verify, device=device)
    if evaluator.system != system:
        raise ValueError(
            f"evaluator was built for {evaluator.system.device.name} x"
            f"{evaluator.system.device_count} but this call targets "
            f"{system.device.name} x{system.device_count}; memoized results "
            f"would price the wrong hardware")
    return evaluator


def pp_fill(system: System, plan: Plan, tokens: int, d_model: int,
            policy: PrecisionPolicy = DEFAULT) -> Seconds:
    """Pipeline fill: (pp-1) p2p activation hand-offs for the first batch.

    Public: the serving simulator prices its prefill waves and
    decode rounds with the same fill term generate() uses. Hand-offs move
    activations, so the policy's activation width prices them.
    """
    if plan.pp <= 1:
        return 0.0
    return net.p2p(system, tokens * d_model
                   * policy.activations.bytes).latency * (plan.pp - 1)


def prefill(system: System, cfg: ModelConfig, plan: Plan, batch: int,
            seq: int, evaluator: Optional[Evaluator] = None,
            policy: PrecisionPolicy = DEFAULT,
            fusion: FusionPolicy = SERIAL) -> PerfReport:
    ev = _evaluator(system, evaluator)
    cost = ev.evaluate(fuse(build_model(cfg, plan, batch, seq, kv_len=seq,
                                        policy=policy), fusion),
                       overlap=fusion.overlap)
    rep = _report(cost)
    fill: Seconds = pp_fill(system, plan, batch * seq, cfg.d_model, policy)
    rep.latency += fill
    rep.serial_latency += fill
    return rep


def decode_step(system: System, cfg: ModelConfig, plan: Plan, batch: int,
                kv_len: int, evaluator: Optional[Evaluator] = None,
                policy: PrecisionPolicy = DEFAULT,
                fusion: FusionPolicy = SERIAL) -> PerfReport:
    ev = _evaluator(system, evaluator)
    cost = ev.evaluate(fuse(build_model(cfg, plan, batch, seq=1,
                                        kv_len=kv_len, policy=policy),
                            fusion),
                       overlap=fusion.overlap)
    rep = _report(cost)
    fill: Seconds = pp_fill(system, plan, batch, cfg.d_model, policy)
    rep.latency += fill
    rep.serial_latency += fill
    return rep


def generate_graphs(cfg: ModelConfig, plan: Plan, batch: int, in_len: int,
                    out_len: int, samples: int = 8,
                    policy: PrecisionPolicy = DEFAULT,
                    fusion: FusionPolicy = SERIAL):
    """The exact symbolic graphs `generate` evaluates: the prefill graph plus
    one decode graph per KV trapezoid sample point. Exposed so study.Study
    can pre-collect every GEMM shape of a whole grid into one device-axis
    stacked mapper search before any case is priced. Returns (graphs, pts)
    where pts are the sampled KV lengths (graphs[1:] align with pts).
    Graphs come back already rewritten under `fusion`'s kernel-fusion
    rules."""
    pts = [in_len + round(i * (out_len - 1) / max(samples - 1, 1))
           for i in range(samples)]
    graphs = [build_model(cfg, plan, batch, in_len, kv_len=in_len,
                          policy=policy)] + \
        [build_model(cfg, plan, batch, seq=1, kv_len=kv, policy=policy)
         for kv in pts]
    return [fuse(g, fusion) for g in graphs], pts


def generate(system: System, cfg: ModelConfig, plan: Plan, batch: int,
             in_len: int, out_len: int, samples: int = 8,
             evaluator: Optional[Evaluator] = None,
             policy: PrecisionPolicy = DEFAULT,
             fusion: FusionPolicy = SERIAL) -> PerfReport:
    """prefill + out_len decode steps; decode latency integrated over the
    growing KV with `samples` trapezoid points (exact enough, hugely faster).

    The prefill graph and all `samples` decode graphs are evaluated in one
    batched call: their unique GEMM shapes share a single mapper search.
    `fusion` selects the execution model: kernel-fusion rewrites and/or
    overlap-scheduled (critical-path) latencies per graph.
    """
    ev = _evaluator(system, evaluator)
    graphs, pts = generate_graphs(cfg, plan, batch, in_len, out_len, samples,
                                  policy, fusion)
    costs = ev.evaluate_many(graphs, overlap=fusion.overlap)

    pf = _report(costs[0])
    pf_fill: Seconds = pp_fill(system, plan, batch * in_len, cfg.d_model,
                               policy)
    pf.latency += pf_fill
    pf.serial_latency += pf_fill
    dec_fill: Seconds = pp_fill(system, plan, batch, cfg.d_model, policy)
    lats = [c.latency + dec_fill for c in costs[1:]]
    # the no-overlap pricing of the same graphs, integrated identically so
    # PerfReport.serial_latency stays meaningful for the whole generation
    # (and bit-for-bit equal to `latency` in serial mode)
    ser_lats = [c.serial_latency + dec_fill for c in costs[1:]]

    total = pf.latency
    serial_total = pf.serial_latency
    dec = ser_dec = 0.0
    # per-sample trapezoid weights: sample i carries wts[i] of the out_len-1
    # integrated decode steps, +1 at pts[0] for the first token
    wts = [0.0] * samples
    for i in range(samples - 1):
        w = pts[i + 1] - pts[i] if i < samples - 2 \
            else out_len - 1 - (pts[i] - in_len)
        dec += (lats[i] + lats[i + 1]) / 2 * max(w, 0)
        ser_dec += (ser_lats[i] + ser_lats[i + 1]) / 2 * max(w, 0)
        wts[i] += max(w, 0) / 2
        wts[i + 1] += max(w, 0) / 2
    if out_len == 1:
        dec = ser_dec = 0.0
        wts = [0.0] * samples
    wts[0] += 1.0               # +1 first token
    total += dec + lats[0]
    serial_total += ser_dec + ser_lats[0]
    # aggregate flops/bytes/bound over prefill + the integrated decode steps
    # (the decode graphs carry the same weights their latencies were
    # integrated with), so PerfReport.dominant reflects the whole generation
    # instead of just the prefill pass
    flops, bytes_ = pf.flops, pf.bytes
    bound = dict(pf.bound)
    if pf_fill > 0:
        bound["link"] = bound.get("link", 0.0) + pf_fill
    for w, c in zip(wts, costs[1:]):
        if w <= 0:
            continue
        flops += c.flops * w
        bytes_ += c.bytes * w
        for k, v in c.by_bound().items():
            bound[k] = bound.get(k, 0.0) + v * w
        if dec_fill > 0:
            bound["link"] = bound.get("link", 0.0) + dec_fill * w
    rep = PerfReport(latency=total, flops=flops, bytes=bytes_,
                     breakdown={"prefill": pf.latency,
                                "decode": dec + lats[0]},
                     bound=bound, serial_latency=serial_total)
    return rep


# ------------------------- memory accounting ------------------------------

def memory_per_device(cfg: ModelConfig, plan: Plan, batch: int,
                      max_len: int,
                      policy: PrecisionPolicy = DEFAULT) -> Bytes:
    """Resident bytes per device under the planner memory model.

    The precision policy is the single source of truth for byte widths
   : weights at `policy.weights`, the KV cache at
    `policy.kv_cache` (this is the quantized-KV capacity lever: int8 KV
    doubles the slot budget), activations at `policy.activations`.
    Recurrent state stays fp32, matching the kernels.
    """
    wb = policy.weights.bytes
    kvb = policy.kv_cache.bytes
    param_n = cfg.param_count()
    if cfg.n_experts and plan.ep > 1:
        # expert FFN weights are sharded ep-ways: each device in the expert
        # group holds n_experts/ep experts (graph.build_mlp's e_local), so
        # only 1/ep of the expert weight bytes are resident per device
        expert_n = cfg.n_layers * cfg.n_experts * cfg.mlp_params()
        param_n = param_n - expert_n * (plan.ep - 1) / plan.ep
    params = param_n * wb / (plan.tp * plan.pp)
    # KV shards at most n_kv_heads ways: past that, tp ranks hold replicas
    # (each rank computes a distinct query-head group against a KV head that
    # also lives elsewhere — graph.build_attention's hkv = max(1, kv//tp)).
    # Dividing by tp would under-count the replicated copies; the verifier
    # notes such plans as plan.tp-kv-heads.
    kv_ways = min(plan.tp, cfg.n_kv_heads) if cfg.n_kv_heads else plan.tp
    kv = batch * max_len * cfg.kv_bytes_per_token(kvb) / (kv_ways * plan.pp)
    if cfg.attn_window:   # local attention caps the resident KV window
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if cfg.block_kind(i) == "attn")
        if n_attn:
            per_layer = cfg.kv_bytes_per_token(kvb) / n_attn
            kv = batch * min(max_len, cfg.attn_window) * per_layer * n_attn \
                / (kv_ways * plan.pp)
    # recurrent state (rwkv/rglru)
    state = 0.0
    for i in range(cfg.n_layers):
        k = cfg.block_kind(i)
        if k == "rwkv":
            state += batch * cfg.d_model * cfg.rwkv_head_dim * 4
        elif k == "rglru":
            state += batch * cfg.d_model * 4
    state /= (plan.tp * plan.pp)
    act = batch * max(1, max_len if max_len < 8192 else 8192) \
        * cfg.d_model * policy.activations.bytes * 4 / plan.tp
    return params + kv + state + act


def max_batch(system: System, cfg: ModelConfig, plan: Plan,
              max_len: int, policy: PrecisionPolicy = DEFAULT) -> int:
    """Largest batch (or serving slot count) that fits device memory —
    quantized-KV policies raise this budget."""
    cap = system.device.memory_capacity
    lo, hi = 0, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if memory_per_device(cfg, plan, mid, max_len, policy) <= cap:
            lo = mid
        else:
            hi = mid - 1
    return lo


def throughput(system: System, cfg: ModelConfig, plan: Plan, batch: int,
               in_len: int, out_len: int,
               evaluator: Optional[Evaluator] = None,
               policy: PrecisionPolicy = DEFAULT,
               fusion: FusionPolicy = SERIAL) -> PerSecond:
    """Output tokens / second for the whole system (pipeline-full steady
    state: pp stages each process different microbatches concurrently)."""
    g = generate(system, cfg, plan, batch, in_len, out_len,
                 evaluator=evaluator, policy=policy, fusion=fusion)
    return throughput_from_generate(g, plan, batch, out_len)


def throughput_from_generate(g: PerfReport, plan: Plan, batch: int,
                             out_len: int) -> PerSecond:
    """Derive steady-state throughput from an existing generate() report
    (saves the planner a second full-model walk per plan)."""
    toks = batch * out_len * plan.dp
    return toks * plan.pp / g.latency if g.latency > 0 else 0.0
