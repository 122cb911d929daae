"""Export a Perfetto timeline + per-op attribution for one grid point.

    python -m repro_torch.trace --config gpt3_175b --stage prefill
    python -m repro_torch.trace --config qwen3-1.7b --stage serve --requests 24
    python -m repro_torch.trace --config gpt3_175b --fusion full --csv ops.csv
    python -m repro_torch.trace --config gpt3_175b --tables-device cpu

Builds the requested config x plan x policy x fusion x stage point, prices
it through the analytical models, and writes a Chrome trace_event JSON
(`--out`, default <config>_<stage>.perfetto.json) that opens directly in
https://ui.perfetto.dev or chrome://tracing. Timestamps are the model's
*virtual* times (core/trace_export.py), so the file is deterministic and
diffable; the tool validates the trace schema and asserts the exported
span equals the Schedule makespan bit-for-bit before reporting success.

Non-serve stages export per-resource Schedule lanes (compute/vector/link,
critical ops flagged, fused kernels carrying their elided bytes) and print
the per-op attribution table (core/obs.py) — `--csv` dumps the full table.
The serve stage replays the Poisson trace through the continuous-batching
simulator and exports engine phases, slot occupancy and per-request lanes.

`--device` names the *hardware preset* being priced (default a100), as in
the JAX package's CLI, so its command lines run unchanged. Where the
mapper's candidate tables run is `--tables-device`: ``cuda`` (the default,
the kernel ``kernels/csrc/mapper_tables.cu``) or ``cpu`` (numpy); the two
write the same bytes. ``cuda`` without a card raises.
"""
from __future__ import annotations

import argparse
import sys

from .configs import get_config
from .core import fusion as fu
from .core import hardware as hw
from .core import obs
from .core.evaluator import Evaluator
from .core.graph import Plan
from .core.mapper import TABLE_DEVICES
from .core.precision import POLICIES, get_policy
from .core.schedule import schedule_graph
from .core.simulator import simulate
from .core.study import Case, Study
from .core.trace_export import (schedule_trace_events,
                                simulation_trace_events, total_span_us,
                                validate_trace_events, write_trace, _ts)
from .core.workload import Trace, TrafficWorkload, Workload

_FUSIONS = {"serial": fu.SERIAL, "fused": fu.FUSED, "overlap": fu.OVERLAP,
            "full": fu.FULL}


def _attribution_table(att: obs.Attribution, top: int = 20) -> str:
    rows = sorted(att.rows, key=lambda r: -r.latency)[:top]
    lines = [f"{'op':<28} {'group':<6} {'bound':<9} {'latency_s':>12} "
             f"{'bytes':>12} {'elided':>12} {'crit':>5}"]
    for r in rows:
        lines.append(f"{r.name:<28} {r.group:<6} {r.bound:<9} "
                     f"{r.latency:>12.6f} {r.bytes:>12.4g} "
                     f"{r.elided:>12.4g} {str(r.critical):>5}")
    lines.append(f"total={att.total:.6f}s serial={att.serial:.6f}s "
                 f"elided={att.elided:.4g}B "
                 f"link_exposed={att.link_exposed:.6f}s "
                 f"link_hidden={att.link_hidden:.6f}s")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True,
                    help="model config name (gpt3_175b, qwen3-1.7b, ...)")
    ap.add_argument("--stage", default="prefill",
                    choices=("generate", "prefill", "decode", "layer",
                             "serve"))
    ap.add_argument("--device", default="a100",
                    help=f"device preset ({', '.join(sorted(hw.PRESETS))})")
    ap.add_argument("--tables-device", default="cuda", choices=TABLE_DEVICES,
                    help="where the mapper's candidate tables run: cuda "
                         "(the kernel) or cpu (numpy)")
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--link-gbps", type=float, default=600.0)
    ap.add_argument("--topology", default="fc")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor parallel (default: all devices)")
    ap.add_argument("--pp", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--ep", type=int, default=1)
    ap.add_argument("--sp", action="store_true", help="sequence parallelism")
    ap.add_argument("--policy", default="fp16",
                    help=f"precision preset ({', '.join(sorted(POLICIES))})")
    ap.add_argument("--fusion", default="full",
                    choices=tuple(sorted(_FUSIONS)))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--in-len", type=int, default=512)
    ap.add_argument("--out-len", type=int, default=64)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16,
                    help="serve stage: trace length")
    ap.add_argument("--rate", type=float, default=8.0,
                    help="serve stage: Poisson arrivals per second")
    ap.add_argument("--out", default=None,
                    help="trace path (default <config>_<stage>"
                         ".perfetto.json)")
    ap.add_argument("--csv", default=None,
                    help="also dump the full attribution table as CSV")
    args = ap.parse_args(argv)

    cfg = get_config(args.config.strip().lower().replace("_", "-"))
    system = hw.make_system(hw.get_device(args.device), args.devices,
                            args.link_gbps, args.topology)
    plan = Plan(tp=args.tp or args.devices, pp=args.pp, dp=args.dp,
                ep=args.ep, sequence_parallel=args.sp)
    policy = get_policy(args.policy)
    fus = _FUSIONS[args.fusion]
    out = args.out or f"{cfg.name}_{args.stage}.perfetto.json"

    ev = Evaluator(system, device=args.tables_device)
    att = None
    if args.stage == "serve":
        trace = Trace.poisson(args.requests, args.rate, args.in_len,
                              args.out_len, seed=0)
        traffic = TrafficWorkload.from_trace(trace, slots=args.batch)
        sim = simulate(system, cfg, plan, traffic, evaluator=ev,
                       policy=policy, fusion=fus)
        events = simulation_trace_events(sim)
        expect = _ts(sim.makespan)
        print(sim.summary())
    else:
        w = Workload(args.batch, args.in_len, args.out_len,
                     samples=args.samples)
        case = Case(system, cfg, plan, w, stage=args.stage, policy=policy,
                    fusion=fus)
        graphs = Study._graphs(case)
        if args.stage in ("generate", "layer") and len(graphs) > 1:
            sections = [("prefill/", graphs[0]), ("decode/", graphs[1])]
        else:
            sections = [("", graphs[0])]
        costs = ev.evaluate_many([g for _, g in sections],
                                 overlap=fus.overlap)
        events, expect, atts = [], 0.0, []
        for i, ((pre, g), cost) in enumerate(zip(sections, costs)):
            sch = cost.schedule
            if sch is None:
                # serial pricing: a dependency-ordered timeline for display
                sch = schedule_graph(g, [o.latency for o in cost.ops],
                                     pipeline_collectives=False)
            name = pre.rstrip("/") or args.stage
            events += schedule_trace_events(sch, g, pid=i,
                                            process_name=name)
            expect = max(expect, _ts(sch.makespan))
            atts.append(obs.attribute(g, cost, label=args.stage,
                                      prefix=pre))
        att = atts[0] if len(atts) == 1 else obs.combine(args.stage, atts)
        print(_attribution_table(att))

    errors = validate_trace_events(events)
    span = total_span_us(events)
    write_trace(out, events)
    if errors:
        for e in errors:
            print(f"SCHEMA ERROR: {e}", file=sys.stderr)
        return 1
    if span != expect:
        print(f"SPAN MISMATCH: trace span {span} us != makespan {expect} us",
              file=sys.stderr)
        return 1
    if args.csv and att is not None:
        att.to_csv(args.csv)
        print(f"wrote {args.csv}")
    print(f"wrote {out} ({len(events)} events, span {span:.3f} us == "
          f"modeled makespan; open in https://ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
