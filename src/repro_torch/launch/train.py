"""Training launcher of the port: ``repro.launch.train`` on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --preset full --steps 20 --batch 8 --seq 512

Runs on ``cuda`` unless ``--device cpu`` is given. Weights are random, from
a seeded ``torch.Generator``; batches come from ``TokenPipeline``
(synthetic, or ``--token-file``), a pure function of (seed, step).
Checkpoints are written asynchronously every ``--ckpt-every`` steps and at
the last, each with a restart manifest, so ``--resume`` restores the
newest checkpoint and continues from the step after it with the same data.
``StepMonitor`` flags stragglers. ``--data`` and ``--model`` other than 1
(a device mesh) wait for the distributed slice of the port (ROADMAP A12).
Every config of ``--arch`` trains (``check_trainable``). An audio or vision model gets the zero bf16 frontend
of (batch, n_frontend_tokens, d_model) that the JAX launcher builds.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..checkpoint import Checkpointer
from ..configs import ARCHS, EXTRA_ARCHS, get_config
from ..data import DataConfig, TokenPipeline
from ..device import resolve_device
from ..distributed.fault_tolerance import RestartManifest, StepMonitor
from ..models import check_trainable, needs_frontend
from ..training import (AdamW, cosine_schedule, init_state, load_state_tree, make_train_step,
                        state_tree)
from .serve import preset_config


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=sorted(ARCHS) + sorted(EXTRA_ARCHS))
    ap.add_argument("--preset", choices=["tiny", "m100", "full"], default="tiny")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--token-file", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    if args.data != 1 or args.model != 1:
        raise NotImplementedError(
            f"--data {args.data} --model {args.model}: a device mesh waits for the "
            "distributed slice of the port (ROADMAP A12); run with --data 1 --model 1")
    device = resolve_device(args.device)
    cfg = preset_config(get_config(args.arch), args.preset)
    check_trainable(cfg)
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=max(args.steps // 20, 1),
                                   total=args.steps))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed,
                                    token_file=args.token_file))
    ck = Checkpointer(args.ckpt_dir)
    man_path = os.path.join(args.ckpt_dir, "manifest.json")
    mon = StepMonitor(on_straggler=lambda s, dt: print(
        f"[straggler] step {s} took {dt:.2f}s"))

    state = init_state(cfg, opt, args.seed, device)
    start = 0
    if args.resume and ck.latest_step() is not None:
        man = RestartManifest.load(man_path)
        tree, _ = ck.restore(state_tree(state))
        load_state_tree(state, tree)
        start = man.step + 1
        print(f"resumed from step {man.step}")
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches,
                              has_frontend=needs_frontend(cfg))

    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"training {cfg.name}: {n_params / 1e6:.1f}M params, device={device}, "
          f"batch={args.batch}x{args.seq}")
    for s in range(start, args.steps):
        mon.start()
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(s).items()}
        if needs_frontend(cfg):
            batch["frontend"] = torch.zeros((args.batch, max(cfg.n_frontend_tokens, 1),
                                             cfg.d_model), dtype=torch.bfloat16, device=device)
        state, metrics = step_fn(state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # the step's time is the device's
        dt = mon.stop(s)
        if s % max(args.steps // 20, 1) == 0 or s == args.steps - 1:
            print(f"step {s:5d}  loss={float(metrics['loss']):.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.3f}  "
                  f"{args.batch * args.seq / dt:.0f} tok/s")
        if s % args.ckpt_every == 0 or s == args.steps - 1:
            ck.save(s, state_tree(state), extra={"data_step": s}, async_=True)
            RestartManifest(step=s, data_step=s, mesh_shape={"data": 1, "model": 1},
                            rng_seed=args.seed).save(man_path)
    ck.wait()
    print("done")
    return state


if __name__ == "__main__":
    main()
