"""Serving launcher of the port: build a model and serve requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --preset full --requests 16 --batch 8

Runs on ``cuda`` unless ``--device cpu`` is given. Weights are random, from
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
``torch.Generator`` seeded with 0. (The JAX launcher's planner report
needs the analytical stack, which the port has no copy of yet.)
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

import torch

from ..configs import ARCHS, EXTRA_ARCHS, ModelConfig, get_config, smoke_config
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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = preset_config(get_config(args.arch), args.preset)
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
