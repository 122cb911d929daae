"""Serving launcher of the port: plan with the analytical model, then build
a model and serve requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --preset full --requests 16 --batch 8

The planner (the paper's performance model, ``core/planner.py``) is
consulted first, as the JAX launcher consults it: it prints the
predicted-latency-optimal (tp, pp, dp) plan of the arch's full config on
``--plan-chips`` NVIDIA H100 cards (``nvidia_h100()``, the card the port
runs on, whose predictions ``chip_smoke.py`` holds against its times), its
predicted latency, throughput and memory a card, or the planner's error
where no plan fits (full gpt3-175b and grok-1-314b on one card). The
cards are joined by NVLink 4 at 900 GB/s a GPU (NVIDIA H100 Tensor Core GPU
datasheet, SXM), as ``dgx_a100`` gives the A100's NVLink 3 600 GB/s.

Runs on ``cuda`` unless ``--device cpu`` is given; the planner prices its
mapper tables on the same device (``plan_report``). Weights are random, from
a seeded ``torch.Generator``. ``--arch`` takes the ids of ``ARCHS`` (with
rwkv6-7b, whose 7.0 G parameters, 14.0 GB in their bf16 and fp32 dtypes, fit
one 80 GB card at full depth, recurrentgemma-2b, 2.89 G parameters, 6.5 GB
with its fp32 RG-LRU gate weights, and granite-moe-3b-a800m, 3.30 G, 6.6 GB)
and of ``EXTRA_ARCHS`` (gpt3-175b), resolved through ``get_config`` as the
JAX launcher resolves them; ``--layers`` cuts the depth (gpt3-175b's 96
layers, 350 GB of bf16 weights, do not fit one 80 GB card; 8 layers do;
grok-1-314b's 64 layers, 633 GB, neither; 4 layers, 42.6 GB, do:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b \
        --preset full --layers 4

). whisper-tiny and llama-3.2-vision-11b (9.78 G parameters, 19.6 GB,
full size on one card) cross-attend to a frontend, whose encoder or vision
tower the reference stubs out: each request gets a stub frontend of
(n_frontend_tokens, d) normal embeddings in bf16, drawn from a
``torch.Generator`` seeded with 0.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

import torch

from ..configs import ARCHS, EXTRA_ARCHS, ModelConfig, get_config, smoke_config
from ..core import planner
from ..core.hardware import make_system, nvidia_h100
from ..device import resolve_device
from ..models import init_params
from ..serving import Engine, Request, SamplingParams


def preset_config(cfg: ModelConfig, preset: str) -> ModelConfig:
    """The size presets of ``repro.launch.train.preset_config``."""
    if preset == "full":
        return cfg
    if preset == "m100":      # ~100M-param config of the same family
        return replace(cfg, name=cfg.name + "-m100", n_layers=12,
                       d_model=768, n_heads=12 if cfg.n_heads else 0,
                       n_kv_heads=4 if cfg.n_kv_heads else 0,
                       d_head=64 if cfg.n_heads else 0, d_ff=2048,
                       vocab_size=32000,
                       n_experts=min(cfg.n_experts, 8),
                       top_k=min(cfg.top_k, 2))
    return smoke_config(cfg)


def plan_report(full_cfg: ModelConfig, plan_chips: int, batch: int, max_new: int,
                device: str) -> str:
    """The launcher's ``[planner]`` line: the latency-optimal plan of
    `full_cfg` on `plan_chips` H100 cards, its mapper tables priced on
    `device` (``"cuda"``: the kernel; ``"cpu"``: numpy; the same plan and
    numbers either way), or the planner's error where no plan fits."""
    try:
        best = planner.best_plan(make_system(nvidia_h100(), plan_chips, link_gbps=900.0),
                                 full_cfg, batch=batch, in_len=512, out_len=max_new,
                                 device=device)
    except ValueError as e:
        return f"[planner] {e}"
    p = best.plan
    return (f"[planner] {full_cfg.name} on {plan_chips}x h100: "
            f"tp={p.tp} pp={p.pp} dp={p.dp} ep={p.ep}  "
            f"pred latency={best.latency * 1e3:.1f}ms  "
            f"pred throughput={best.throughput:.0f} tok/s  "
            f"mem/chip={best.memory_per_device / 2 ** 30:.2f}GiB")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=sorted(ARCHS) + sorted(EXTRA_ARCHS))
    ap.add_argument("--preset", choices=["tiny", "m100", "full"],
                    default="tiny")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the preset's depth to this many layers")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--plan-chips", type=int, default=1,
                    help="H100 cards for the planning report")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    full_cfg = get_config(args.arch)
    # 1) plan on the real config with the paper's model
    print(plan_report(full_cfg, args.plan_chips, args.batch, args.max_new, device.type))

    # 2) serve the (preset) model
    cfg = preset_config(full_cfg, args.preset)
    if args.layers is not None:
        cfg = replace(cfg, name=f"{cfg.name}-{args.layers}l", n_layers=args.layers)
    params = init_params(cfg, seed=0, device=device)
    eng = Engine(cfg, params, batch_size=args.batch, max_len=args.max_len,
                 device=device)
    sampling = SamplingParams(temperature=args.temperature, top_k=40)
    gen = torch.Generator().manual_seed(0)
    shape = (cfg.n_frontend_tokens, cfg.d_model)
    reqs = [Request(uid=i, prompt=[(7 * i + j) % cfg.vocab_size
                                   for j in range(5 + i % 7)],
                    max_new_tokens=args.max_new, sampling=sampling,
                    frontend=torch.randn(shape, generator=gen).to(torch.bfloat16)
                    if cfg.n_frontend_tokens else None)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = eng.run(reqs)
    dt = time.perf_counter() - t0
    for r in done[: min(4, len(done))]:
        print(f"req {r.uid}: prompt={r.prompt} -> {r.output}")
    print(f"served {len(done)} requests, {eng.stats['tokens_out']} tokens "
          f"in {dt:.2f}s ({eng.throughput():.1f} tok/s) on {device}")
    return done


if __name__ == "__main__":
    main()
