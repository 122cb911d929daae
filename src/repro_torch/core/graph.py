"""LLM computational graph -> symbolic op-IR (paper Fig. 2 + Sec. III-B).

Builds the per-layer operator graph for any ModelConfig at a given stage
(prefill: seq=S; decode: seq=1 with KV length), already divided by the
parallelism plan (tp / ep), including the Megatron-style collectives the
paper models (two all-reduce per transformer layer under TP) plus the
all-to-all that MoE expert parallelism adds (an extension of the paper).

The builders (`build_layer`, `build_model`) are *symbolic*: they emit
ir.Graph values of hashable OpSpec nodes and never touch a Device, so one
build can be evaluated on any hardware description — and the evaluator can
deduplicate identical specs across a whole design-space sweep. Identical
transformer layers become one node x `repeat` instead of n_layers nodes.
`layer_ops` / `model_ops` remain as eager conveniences: build + evaluate.

The PyTorch port's copy of the JAX package's module, whole, on the port's
own ``ModelConfig``; the eager conveniences price on the port's
`Evaluator`, whose mapper tables run on `device` (``"cuda"``, or ``"cpu"``
for numpy).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import List

from ..configs.base import ModelConfig
from .hardware import System
from . import operators as ops
from .ir import (CollectiveSpec, ElementwiseSpec, Graph, GraphBuilder,
                 MatmulSpec, NormSpec, ScanSpec, SoftmaxSpec, TrafficSpec)
from .precision import DEFAULT, PrecisionPolicy


@dataclass(frozen=True)
class Plan:
    """Parallelism plan for the analytical model."""
    tp: int = 1
    pp: int = 1
    dp: int = 1
    ep: int = 1          # expert parallel degree (within tp group or dp)
    sequence_parallel: bool = False   # RS+AG instead of AR (beyond-paper opt)

    @property
    def devices(self) -> int:
        return self.tp * self.pp * self.dp


@dataclass
class LayerCost:
    """Evaluated graph cost. With `schedule` set (overlap-mode evaluation,
    core/schedule.py) `latency` is the resource-timeline makespan and the
    per-op start/end times are exposed; otherwise it is the seed's serial
    sum in node order, bit-for-bit."""
    ops: List[ops.OpResult] = field(default_factory=list)
    schedule: object = None         # Optional[schedule.Schedule]

    def add(self, r: ops.OpResult):
        self.ops.append(r)

    @property
    def latency(self) -> float:
        if self.schedule is not None:
            return self.schedule.makespan
        return self.serial_latency

    @property
    def serial_latency(self) -> float:
        """Serial (no-overlap) latency: the left-to-right sum."""
        return sum(o.latency for o in self.ops)

    @property
    def flops(self) -> float:
        return sum(o.flops for o in self.ops)

    @property
    def bytes(self) -> float:
        return sum(o.main_memory_bytes for o in self.ops)

    def by_bound(self) -> dict:
        out: dict = {}
        for o in self.ops:
            out[o.bound] = out.get(o.bound, 0.0) + o.latency
        return out

    def breakdown(self) -> dict:
        """Additive per-name busy time (resource occupancy, not wall-clock
        when scheduled — see critical_breakdown for path attribution)."""
        out: dict = {}
        for o in self.ops:
            out[o.name] = out.get(o.name, 0.0) + o.latency
        return out

    def by_resource(self) -> dict:
        """Per-resource busy seconds (compute / vector / link)."""
        if self.schedule is not None:
            return dict(self.schedule.busy)
        out: dict = {}
        for o, node_res in zip(self.ops, self._resources or ()):
            out[node_res] = out.get(node_res, 0.0) + o.latency
        return out

    _resources: tuple = ()          # set by the evaluator (spec resources)

    def critical_breakdown(self) -> dict:
        """Critical-path (not additive) attribution: which ops the scheduled
        makespan is actually waiting on. Falls back to the additive
        breakdown when the graph was priced serially."""
        if self.schedule is not None:
            return self.schedule.critical_breakdown()
        return self.breakdown()


# ---------------------------------------------------------------------------
# symbolic builders
# ---------------------------------------------------------------------------

def _norm_spec(cfg: ModelConfig, rows: int,
               policy: PrecisionPolicy = DEFAULT,
               plan: Plan = None) -> NormSpec:
    kind = "layernorm" if cfg.norm == "layernorm" else "rmsnorm"
    ab = policy.activations.bytes
    if plan is not None and plan.sequence_parallel and plan.tp > 1:
        # Megatron-style sequence parallelism: the norm (and the rest of the
        # RS..AG region) runs on the token shard, 1/tp of the rows
        rows = math.ceil(rows / plan.tp)
    return NormSpec(kind, rows, cfg.d_model, bytes_in=ab, bytes_out=ab)


def _add_tp_collective(g: GraphBuilder, cfg: ModelConfig, plan: Plan,
                       tokens: int, name: str,
                       policy: PrecisionPolicy = DEFAULT) -> None:
    """Per-layer activation synchronization under tensor parallelism.

    Chain deps are the true edges here: the collective consumes the output
    of the node added just before it (the row-parallel GEMM), and the next
    node consumes the synchronized activations."""
    if plan.tp <= 1:
        return
    ab = policy.activations.bytes
    bytes_ = tokens * cfg.d_model * ab
    if plan.sequence_parallel:
        g.add(CollectiveSpec("reduce_scatter", bytes_, plan.tp, ab),
              name + "_rs")
        g.add(CollectiveSpec("all_gather", bytes_, plan.tp, ab), name + "_ag")
        return
    g.add(CollectiveSpec("all_reduce", bytes_, plan.tp, ab), name)


def build_attention(cfg: ModelConfig, plan: Plan, batch: int, seq: int,
                    kv_len: int, cross_len: int = 0, prefix: str = "",
                    policy: PrecisionPolicy = DEFAULT) -> Graph:
    """Self- (or cross-) attention block. seq = query length (1 for decode).

    Precision: the projections are activation x weight GEMMs; the score and
    value GEMMs stream their B operand from the (possibly quantized) KV
    cache, as does the one-token KV append at decode."""
    d, dh = cfg.d_model, cfg.d_head
    hq = max(1, cfg.n_heads // plan.tp)
    hkv = max(1, cfg.n_kv_heads // plan.tp)
    g_ = hq // hkv
    toks = batch * seq
    ctx = cross_len if cross_len else kv_len
    win = cfg.attn_window
    kv_eff = min(ctx, win) if (win and not cross_len) else ctx
    ab = policy.activations.bytes
    w_mm, kv_mm = policy.weight_gemm(), policy.attn_gemm()

    g = GraphBuilder()
    g.add(_norm_spec(cfg, toks, policy, plan), prefix + "ln_attn")
    i_qkv = g.add(MatmulSpec(toks, d, (hq + 2 * hkv) * dh, **w_mm),
                  prefix + "qkv_proj")
    i_qk = i_qkv                   # most recent producer of the q/k tensors
    if cfg.qk_norm:
        i_qk = g.add(NormSpec("rmsnorm", toks * (hq + hkv), dh, bytes_in=ab,
                              bytes_out=ab), prefix + "qk_norm")
    if cfg.rope_fraction > 0:
        i_qk = g.add(ElementwiseSpec("generic", toks * (hq + hkv) * dh, 6.0,
                                     bytes_elt=ab), prefix + "rope")
    i_app = None
    if seq == 1:   # decode: append one token of KV at cache precision
        i_app = g.add(TrafficSpec(batch * 2 * hkv * dh
                                  * policy.kv_cache.bytes),
                      prefix + "kv_append", deps=(i_qk,))
    qk_deps = (i_qk,) if i_app is None else (i_qk, i_app)
    i_sc = g.add(MatmulSpec(g_ * seq, dh, kv_eff, batch=batch * hkv, **kv_mm),
                 prefix + "qk_t", deps=qk_deps)
    i_sm = g.add(SoftmaxSpec(batch * hq * seq, kv_eff, bytes_in=ab,
                             bytes_out=ab), prefix + "softmax", deps=(i_sc,))
    # a_mul_v reads the probabilities AND the V projection (via i_qk /
    # kv_append) — a real two-producer join in the dataflow DAG
    i_av = g.add(MatmulSpec(g_ * seq, kv_eff, dh, batch=batch * hkv, **kv_mm),
                 prefix + "a_mul_v", deps=tuple(sorted({i_sm} | set(qk_deps))))
    g.add(MatmulSpec(toks, hq * dh, d, **w_mm), prefix + "o_proj",
          deps=(i_av,))
    _add_tp_collective(g, cfg, plan, toks, prefix + "allreduce_attn", policy)
    return g.build()


def build_mlp(cfg: ModelConfig, plan: Plan, batch: int, seq: int,
              policy: PrecisionPolicy = DEFAULT) -> Graph:
    d = cfg.d_model
    toks = batch * seq
    ab = policy.activations.bytes
    w_mm = policy.weight_gemm()
    g = GraphBuilder()
    g.add(_norm_spec(cfg, toks, policy, plan), "ln_mlp")

    if cfg.n_experts:
        e_local = max(1, cfg.n_experts // plan.ep)
        g.add(MatmulSpec(toks, d, cfg.n_experts, **w_mm), "router")
        if plan.ep > 1:
            a2a = toks * cfg.top_k * d * ab
            g.add(CollectiveSpec("all_to_all", a2a, plan.ep, ab),
                  "moe_dispatch")
        toks_e = math.ceil(toks * cfg.top_k / cfg.n_experts)
        ff = max(1, cfg.d_ff // plan.tp)
        n_up = 2 * ff if cfg.mlp_gated else ff
        g.add(MatmulSpec(toks_e, d, n_up, batch=e_local, **w_mm), "expert_up")
        act = "silu_mul" if cfg.mlp_gated else "gelu"
        g.add(ElementwiseSpec(act, toks_e * e_local * ff, bytes_elt=ab),
              "expert_act")
        g.add(MatmulSpec(toks_e, ff, d, batch=e_local, **w_mm), "expert_down")
        if plan.ep > 1:
            g.add(CollectiveSpec("all_to_all", toks * cfg.top_k * d * ab,
                                 plan.ep, ab), "moe_combine")
        g.add(ElementwiseSpec("generic", toks * d, 2 * cfg.top_k,
                              bytes_elt=ab), "moe_mix")
    else:
        ff = max(1, cfg.d_ff // plan.tp)
        if cfg.mlp_gated:
            g.add(MatmulSpec(toks, d, 2 * ff, **w_mm), "w1_gate_proj")
            g.add(ElementwiseSpec("silu_mul", toks * ff, bytes_elt=ab),
                  "act_mul")
        else:
            g.add(MatmulSpec(toks, d, ff, **w_mm), "w1_proj")
            g.add(ElementwiseSpec("gelu", toks * ff, bytes_elt=ab), "gelu")
        g.add(MatmulSpec(toks, ff, d, **w_mm), "w2_proj")
    _add_tp_collective(g, cfg, plan, toks, "allreduce_mlp", policy)
    return g.build()


def build_rwkv(cfg: ModelConfig, plan: Plan, batch: int, seq: int,
               policy: PrecisionPolicy = DEFAULT) -> Graph:
    """RWKV6 time-mix + channel-mix (extension op: ScanSpec)."""
    d = cfg.d_model
    d_tp = max(1, d // plan.tp)
    dh = cfg.rwkv_head_dim
    toks = batch * seq
    ab = policy.activations.bytes
    w_mm = policy.weight_gemm()
    g = GraphBuilder()
    g.add(NormSpec("layernorm", toks, d, bytes_in=ab, bytes_out=ab),
          "ln_tmix")
    for nm in ("r", "k", "v", "g", "w_lora"):
        n = d_tp if nm != "w_lora" else 64
        g.add(MatmulSpec(toks, d, n, **w_mm), f"tmix_{nm}")
    g.add(ScanSpec(seq, batch, d_state=d_tp * dh,
                   flops_per_step=6.0 * d_tp * dh,
                   bytes_io=6 * toks * d_tp * ab), "wkv_scan")
    g.add(MatmulSpec(toks, d_tp, d, **w_mm), "tmix_out")
    if plan.tp > 1:
        g.add(CollectiveSpec("all_reduce", toks * d * ab, plan.tp, ab),
              "allreduce_tmix")
    # channel mix
    ff = int(3.5 * d) // plan.tp
    g.add(NormSpec("layernorm", toks, d, bytes_in=ab, bytes_out=ab),
          "ln_cmix")
    g.add(MatmulSpec(toks, d, ff, **w_mm), "cmix_up")
    g.add(ElementwiseSpec("generic", toks * ff, 3.0, bytes_elt=ab), "relu_sq")
    g.add(MatmulSpec(toks, ff, d, **w_mm), "cmix_down")
    if plan.tp > 1:
        g.add(CollectiveSpec("all_reduce", toks * d * ab, plan.tp, ab),
              "allreduce_cmix")
    return g.build()


def build_rglru(cfg: ModelConfig, plan: Plan, batch: int, seq: int,
                policy: PrecisionPolicy = DEFAULT) -> Graph:
    """Griffin recurrent block: dual in-proj, short conv, RG-LRU scan."""
    d = cfg.d_model
    d_tp = max(1, d // plan.tp)
    toks = batch * seq
    ab = policy.activations.bytes
    w_mm = policy.weight_gemm()
    g = GraphBuilder()
    g.add(_norm_spec(cfg, toks, policy, plan), "ln_rec")
    g.add(MatmulSpec(toks, d, 2 * d_tp, **w_mm), "rec_in_proj")
    g.add(ElementwiseSpec("generic", toks * d_tp,
                          2.0 * cfg.rglru_conv_width, bytes_elt=ab), "conv1d")
    g.add(ScanSpec(seq, batch, d_state=d_tp, flops_per_step=12.0 * d_tp,
                   bytes_io=4 * toks * d_tp * ab), "rg_lru")
    g.add(ElementwiseSpec("generic", toks * d_tp, 4.0, bytes_elt=ab),
          "gate_mul")
    g.add(MatmulSpec(toks, d_tp, d, **w_mm), "rec_out_proj")
    _add_tp_collective(g, cfg, plan, toks, "allreduce_rec", policy)
    return g.build()


def build_layer(cfg: ModelConfig, plan: Plan, layer: int, batch: int,
                seq: int, kv_len: int,
                policy: PrecisionPolicy = DEFAULT) -> Graph:
    kind = cfg.block_kind(layer)
    if kind == "rwkv":
        return build_rwkv(cfg, plan, batch, seq, policy)
    if kind == "rglru":
        return build_rglru(cfg, plan, batch, seq, policy) \
            + build_mlp(cfg, plan, batch, seq, policy)
    g = build_attention(cfg, plan, batch, seq, kv_len, policy=policy)
    if cfg.cross_attention or layer in cfg.cross_attn_layers:
        g = g + build_attention(cfg, plan, batch, seq, kv_len,
                                cross_len=max(cfg.n_frontend_tokens, 1),
                                prefix="x_", policy=policy)
    return g + build_mlp(cfg, plan, batch, seq, policy)


@functools.lru_cache(maxsize=4096)
def build_model(cfg: ModelConfig, plan: Plan, batch: int, seq: int,
                kv_len: int, include_head: bool = True,
                policy: PrecisionPolicy = DEFAULT) -> Graph:
    """Whole-model graph: distinct layer kinds built once with repeat counts.

    Layers of the same kind have identical cost — each kind becomes one set
    of nodes x `repeat` (this is what makes simulating GPT-3's 96 layers as
    cheap as one layer). The build is symbolic and cached: no operator model
    runs until an Evaluator sees the graph. `policy` stamps per-operand byte
    widths + compute rates on every spec; the default
    reproduces the implicit-fp16 seed graph exactly.
    """
    kinds: dict = {}
    for i in range(cfg.n_layers):
        key = (cfg.block_kind(i),
               cfg.cross_attention or i in cfg.cross_attn_layers)
        kinds[key] = kinds.get(key, 0) + 1
    layers_per_stage = {k: math.ceil(v / plan.pp) for k, v in kinds.items()}
    rep_layer = {}
    for i in range(cfg.n_layers):
        key = (cfg.block_kind(i),
               cfg.cross_attention or i in cfg.cross_attn_layers)
        if key not in rep_layer:
            rep_layer[key] = build_layer(cfg, plan, i, batch, seq, kv_len,
                                         policy)
    g = GraphBuilder()
    for key, cnt in layers_per_stage.items():
        g.extend(rep_layer[key].scaled(cnt))
    # encoder stack (whisper): runs once per request at prefill
    if cfg.n_encoder_layers and seq > 1:
        enc_len = max(cfg.n_frontend_tokens, 1)
        enc = build_attention(cfg, plan, batch, enc_len, enc_len,
                              policy=policy) \
            + build_mlp(cfg, plan, batch, enc_len, policy)
        g.extend(enc.scaled(cfg.n_encoder_layers, prefix="enc_"))
    if include_head:
        toks = batch * (seq if seq > 1 else 1)
        i_last = len(g) - 1
        # embedding gather reads weight-precision rows. Physically it runs
        # BEFORE layer 0 consumes its output; since the head block is
        # appended after the folded stack (seed ordering), keep it chained
        # rather than a free source so the scheduler never hides traffic
        # that sits on the serial prefix of the critical path.
        i_emb = g.add(TrafficSpec(toks * cfg.d_model * policy.weights.bytes),
                      "embed")
        head_deps = (i_emb,) if i_last < 0 else (i_last, i_emb)
        i_ln = g.add(_norm_spec(cfg, toks, policy), "ln_final",
                     deps=head_deps)
        g.add(MatmulSpec(toks, cfg.d_model,
                         max(1, cfg.vocab_size // plan.tp),
                         **policy.weight_gemm()), "lm_head", deps=(i_ln,))
    return g.build()


# ---------------------------------------------------------------------------
# eager conveniences: build + evaluate
# ---------------------------------------------------------------------------

def layer_ops(cfg: ModelConfig, system: System, plan: Plan, layer: int,
              batch: int, seq: int, kv_len: int, evaluator=None,
              policy: PrecisionPolicy = DEFAULT,
              device: str = "cuda") -> LayerCost:
    from .evaluator import Evaluator
    ev = evaluator if evaluator is not None \
        else Evaluator(system, device=device)
    return ev.evaluate(build_layer(cfg, plan, layer, batch, seq, kv_len,
                                   policy))


def model_ops(cfg: ModelConfig, system: System, plan: Plan, batch: int,
              seq: int, kv_len: int, include_head: bool = True,
              evaluator=None, policy: PrecisionPolicy = DEFAULT,
              device: str = "cuda") -> LayerCost:
    """Whole-model cost: build the symbolic graph and evaluate it."""
    from .evaluator import Evaluator
    ev = evaluator if evaluator is not None \
        else Evaluator(system, device=device)
    return ev.evaluate(build_model(cfg, plan, batch, seq, kv_len,
                                   include_head, policy))
