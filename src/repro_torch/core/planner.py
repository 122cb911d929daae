"""Parallelism planner — the paper's model used the way Sec. IV/V uses it:
enumerate plans, keep the ones that fit memory, rank by predicted latency or
throughput. launch/serve.py calls this to report a plan before it serves.

`rank_plans` is a thin Study over the plan enumeration: one
declarative case per candidate plan, sharing ONE Evaluator across the whole
sweep, with every unique GEMM shape pre-solved in a single stacked mapper
search (its tables on `device`: ``"cuda"``, the default, or ``"cpu"``).
Plans that differ only in dp re-use the entire cost model of their
tp/pp siblings. Pass your own Evaluator to inspect cache statistics.

The PyTorch port's copy of the JAX package's planner, whole
(tests/test_torch_analytic.py).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional

from ..configs.base import ModelConfig
from .evaluator import Evaluator
from .fusion import SERIAL, FusionPolicy
from .hardware import System
from .graph import Plan
from .precision import DEFAULT, PrecisionPolicy
from .study import Case, Study
from .workload import Workload


@dataclass(frozen=True)
class RankedPlan:
    plan: Plan
    latency: float          # generate latency for the probe workload
    throughput: float       # tokens/s
    memory_per_device: float
    fits: bool


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_plans(system: System, cfg: ModelConfig,
                    max_tp: Optional[int] = None) -> List[Plan]:
    """Every tp/pp/dp/ep factorization of the system, plus a
    sequence-parallel sibling for each tp>1 plan (RS+AG instead of AR, norms
    on the token shard) — SP gives the overlap scheduler a pair of
    collectives to hide behind the adjacent row-parallel GEMMs, and the
    ranking prices it like any other candidate."""
    n = system.device_count
    plans = []
    for tp in _divisors(n):
        if max_tp and tp > max_tp:
            continue
        if cfg.n_heads and cfg.n_kv_heads and tp > cfg.n_kv_heads * cfg.group_size:
            continue
        if cfg.n_heads and tp > 1 and cfg.n_heads % tp:
            # the builder shards heads as floor(n_heads/tp) per device, so a
            # non-dividing tp silently drops attention work — the verifier
            # flags such plans as plan.tp-heads errors
            continue
        for pp in _divisors(n // tp):
            if pp > 1 and pp > cfg.n_layers:
                # more stages than layers: ceil-sized stages would price
                # phantom layers (verifier rule plan.pp-layers)
                continue
            dp = n // (tp * pp)
            ep = 1
            if cfg.n_experts:
                ep = math.gcd(cfg.n_experts, dp) or 1
            plan = Plan(tp=tp, pp=pp, dp=dp, ep=ep)
            plans.append(plan)
            if tp > 1 and _supports_sp(cfg):
                plans.append(replace(plan, sequence_parallel=True))
    return plans


def _supports_sp(cfg: ModelConfig) -> bool:
    """Sequence parallelism is modeled for blocks that route their TP sync
    through _add_tp_collective (attention / mlp / rglru); rwkv blocks
    hardcode an all-reduce, so an SP sibling would be a mislabeled
    duplicate of its AR twin."""
    return any(cfg.block_kind(i) != "rwkv" for i in range(cfg.n_layers))


def rank_plans(system: System, cfg: ModelConfig, batch: int, in_len: int,
               out_len: int, objective: str = "latency",
               max_tp: Optional[int] = None,
               evaluator: Optional[Evaluator] = None,
               policy: PrecisionPolicy = DEFAULT,
               fusion: FusionPolicy = SERIAL,
               device: str = "cuda") -> List[RankedPlan]:
    """Rank every candidate plan: a Study with one case per plan, splitting
    the global batch over each plan's dp replicas. `policy` prices the whole
    sweep at a quantization point — the memory-fit gate sees the quantized
    weight/KV footprint, so int8-weights plans that would not fit at fp16
    stay in the ranking. `fusion` prices it at an execution-model point:
    under FULL, sequence-parallel siblings are ranked with their RS+AG
    hidden behind the adjacent GEMMs."""
    cases = [Case(system, cfg, plan,
                  Workload(max(1, batch // plan.dp), in_len, out_len),
                  policy=policy, fusion=fusion)
             for plan in enumerate_plans(system, cfg, max_tp=max_tp)]
    res = Study(cases=cases,
                evaluators={system: evaluator} if evaluator else None,
                device=device).run()
    out = [RankedPlan(r.case.plan, r.latency, r.throughput,
                      r.memory_per_device, r.fits) for r in res]
    key = (lambda r: r.latency) if objective == "latency" \
        else (lambda r: -r.throughput)
    return sorted(out, key=key)


def best_plan(system: System, cfg: ModelConfig, batch: int, in_len: int,
              out_len: int, objective: str = "latency",
              evaluator: Optional[Evaluator] = None,
              policy: PrecisionPolicy = DEFAULT,
              fusion: FusionPolicy = SERIAL,
              device: str = "cuda") -> RankedPlan:
    ranked = rank_plans(system, cfg, batch, in_len, out_len, objective,
                        evaluator=evaluator, policy=policy, fusion=fusion,
                        device=device)
    fitting = [r for r in ranked if r.fits]
    if not fitting:
        raise ValueError(
            f"{cfg.name} does not fit on {system.device_count}x"
            f"{system.device.name} under any plan")
    return fitting[0]
