"""Lint every shipped config/plan/policy combination.

    python -m repro_torch.verify                 # default matrix, summary
    python -m repro_torch.verify --all-configs   # include EXTRA_ARCHS (gpt3-175b)
    python -m repro_torch.verify --json out.json # machine-readable report

Exit status is 1 if any error-severity diagnostic is found, else 0 — CI
runs `--all-configs` as the error-mode gate the Evaluator/Study default
(warn) deliberately does not enforce at runtime.

The matrix mirrors what the benchmarks actually evaluate: every registered
arch on a 4x A100 node and a 16x TPU v5e slice, every plan the planner
would enumerate, every precision preset against each device's datapath,
graphs built per fusion preset at a prefill and a decode point, and a
schedule certificate for each overlap-scheduled graph (unit latencies —
certificate rules are latency-scale-free).

The PyTorch port's copy of the JAX package's CLI, over the port's configs
and verifier: the same matrix gives the same rows. It lints graphs and
plans and prices nothing, so it runs on the host alone.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

from .configs import ARCHS, EXTRA_ARCHS
from .core import hardware as hw
from .core import planner
from .core.fusion import FULL, FUSED, SERIAL, FusionPolicy, fuse
from .core.graph import Plan, build_model
from .core.ir import Graph
from .core.precision import POLICIES
from .core.schedule import schedule_graph
from .core.verify import (Diagnostic, graph_diagnostics, plan_diagnostics,
                          policy_diagnostics, registry_diagnostics,
                          schedule_diagnostics)

#: fusion presets to build graphs under (overlap presets also get their
#: schedule certificate validated)
_FUSIONS: Tuple[Tuple[str, FusionPolicy], ...] = (
    ("serial", SERIAL), ("fused", FUSED), ("full", FULL))

#: (stage, seq, kv_len) graph points — one prefill, one deep decode step
_STAGES: Tuple[Tuple[str, int, int], ...] = (
    ("prefill", 512, 512), ("decode", 1, 2048))


def _systems() -> Dict[str, hw.System]:
    return {"dgx-a100-4": hw.dgx_a100(4), "tpu-v5e-16": hw.tpu_v5e_pod(16)}


def _record(report: List[dict], where: str, diags: List[Diagnostic]) -> None:
    for d in diags:
        report.append({"where": where, "rule": d.rule,
                       "severity": d.severity, "location": d.location,
                       "message": d.message, "hint": d.hint})


def lint_all(all_configs: bool = False,
             progress: bool = False) -> List[dict]:
    """Run every rule family over the shipped matrix; return diagnostic
    rows (dicts) for reporting. Pure collection — no mode enforcement."""
    report: List[dict] = []
    archs = dict(ARCHS)
    if all_configs:
        archs.update(EXTRA_ARCHS)

    _record(report, "registry", registry_diagnostics())

    for sname, system in _systems().items():
        dev = system.device
        for pname, pol in POLICIES.items():
            _record(report, f"{sname}/policy:{pname}",
                    policy_diagnostics(pol, dev))
        for arch, cfg in archs.items():
            plans = planner.enumerate_plans(system, cfg)
            for plan in plans:
                _record(report, f"{sname}/{arch}/{_ptag(plan)}",
                        plan_diagnostics(system, cfg, plan,
                                         check_memory=False))
            # graphs: lint the densest-TP plan plus the single-device plan
            # under each fusion preset — builder seams do not depend on the
            # policy sweep, so DEFAULT precision keeps the matrix tractable
            lint_plans = {plans[0], max(plans, key=lambda p: p.tp)}
            for plan in lint_plans:
                for fname, fus in _FUSIONS:
                    for stage, seq, kv in _STAGES:
                        g = fuse(build_model(cfg, plan, 1, seq, kv_len=kv),
                                 fus)
                        where = (f"{sname}/{arch}/{_ptag(plan)}/"
                                 f"{fname}/{stage}")
                        _record(report, where, graph_diagnostics(g, dev))
                        if fus.overlap:
                            _record(report, where + "/schedule",
                                    _certificate(g))
            if progress:
                print(f"  {sname}/{arch}: "
                      f"{len(plans)} plans linted", file=sys.stderr)
    return report


def _ptag(plan: Plan) -> str:
    sp = "+sp" if plan.sequence_parallel else ""
    return f"tp{plan.tp}pp{plan.pp}dp{plan.dp}ep{plan.ep}{sp}"


def _certificate(g: Graph) -> List[Diagnostic]:
    """Schedule the graph at unit latencies and validate the certificate
    (the rules check structure, not absolute time, so 1.0s per node is as
    strong a witness as priced latencies)."""
    lats = [1.0] * len(g)
    return schedule_diagnostics(g, lats, schedule_graph(g, lats))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.verify",
        description="lint every shipped config/plan/policy combination")
    ap.add_argument("--all-configs", action="store_true",
                    help="include EXTRA_ARCHS (gpt3-175b) in the matrix")
    ap.add_argument("--json", metavar="PATH",
                    help="write the full diagnostic report as JSON")
    ap.add_argument("--progress", action="store_true",
                    help="per-arch progress on stderr")
    args = ap.parse_args(argv)

    report = lint_all(all_configs=args.all_configs, progress=args.progress)
    counts = {"error": 0, "warn": 0, "info": 0}
    for row in report:
        counts[row["severity"]] += 1

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"counts": counts, "diagnostics": report}, f, indent=2)

    for row in report:
        if row["severity"] != "info":
            print(f"{row['severity']}[{row['rule']}] {row['where']} "
                  f"{row['location']}: {row['message']}")
    print(f"verify: {counts['error']} errors, {counts['warn']} warns, "
          f"{counts['info']} infos across the shipped matrix")
    return 1 if counts["error"] else 0


if __name__ == "__main__":
    sys.exit(main())
