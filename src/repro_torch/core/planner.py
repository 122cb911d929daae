"""Parallelism planner — the paper's model used the way Sec. IV/V uses it:
enumerate plans, keep the ones that fit memory, rank by predicted latency or
throughput. launch/serve.py calls this to report a plan before it serves.

The PyTorch port's copy of the JAX package's planner. The JAX `rank_plans`
runs each plan as a case of a `Study`; the port has no Study and prices each
plan the way a Study prices a generate case: the global batch split over the
plan's dp replicas, the memory-fit gate first (a plan that does not fit is
not evaluated and ranks last, at infinite latency), then `generate` on one
Evaluator shared by the whole sweep and the throughput derived from it.
Plans, order and numbers are the JAX ranking's (tests/test_torch_analytic.py).
It leaves out the JAX planner's `max_tp` cap and its precision, fusion and
shared-evaluator arguments, which no caller of the port sets: every plan is
priced at `precision.DEFAULT` under the serial execution model.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List

from ..configs.base import ModelConfig
from . import inference_model as im
from .evaluator import Evaluator
from .hardware import System
from .graph import Plan


@dataclass(frozen=True)
class RankedPlan:
    plan: Plan
    latency: float          # generate latency for the probe workload
    throughput: float       # tokens/s
    memory_per_device: float
    fits: bool


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_plans(system: System, cfg: ModelConfig) -> List[Plan]:
    """Every tp/pp/dp/ep factorization of the system, plus a
    sequence-parallel sibling for each tp>1 plan (RS+AG instead of AR, norms
    on the token shard)."""
    n = system.device_count
    plans = []
    for tp in _divisors(n):
        if cfg.n_heads and cfg.n_kv_heads and tp > cfg.n_kv_heads * cfg.group_size:
            continue
        if cfg.n_heads and tp > 1 and cfg.n_heads % tp:
            # the builder shards heads as floor(n_heads/tp) per device, so a
            # non-dividing tp would silently drop attention work
            continue
        for pp in _divisors(n // tp):
            if pp > 1 and pp > cfg.n_layers:
                # more stages than layers: ceil-sized stages would price
                # phantom layers
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
               out_len: int, objective: str = "latency") -> List[RankedPlan]:
    """Rank every candidate plan, splitting the global batch over each
    plan's dp replicas."""
    ev = Evaluator(system)
    out = []
    for plan in enumerate_plans(system, cfg):
        b = max(1, batch // plan.dp)
        mem = im.memory_per_device(cfg, plan, b, in_len + out_len)
        if mem > system.device.memory_capacity:
            out.append(RankedPlan(plan, math.inf, 0.0, mem, False))
            continue
        rep = im.generate(system, cfg, plan, b, in_len, out_len,
                          evaluator=ev)
        out.append(RankedPlan(plan, rep.latency,
                              im.throughput_from_generate(rep, plan, b,
                                                          out_len),
                              mem, True))
    key = (lambda r: r.latency) if objective == "latency" \
        else (lambda r: -r.throughput)
    return sorted(out, key=key)


def best_plan(system: System, cfg: ModelConfig, batch: int, in_len: int,
              out_len: int, objective: str = "latency") -> RankedPlan:
    ranked = rank_plans(system, cfg, batch, in_len, out_len, objective)
    fitting = [r for r in ranked if r.fits]
    if not fitting:
        raise ValueError(
            f"{cfg.name} does not fit on {system.device_count}x"
            f"{system.device.name} under any plan")
    return fitting[0]
