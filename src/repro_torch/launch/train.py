"""Training launcher of the port: ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --preset full --steps 20 --batch 8 --seq 512

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --arch qwen3-1.7b --preset full \
        --data 1 --model 2

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --arch rwkv6-7b --preset tiny \
        --data 1 --model 2 --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given. Weights are random, from
a seeded ``torch.Generator``; batches come from ``TokenPipeline``
(synthetic, or ``--token-file``), a pure function of (seed, step).
Checkpoints are written asynchronously every ``--ckpt-every`` steps (0:
never) and at the last, each with a restart manifest, so ``--resume``
restores the newest checkpoint and continues from the step after it with
the same data. ``StepMonitor`` flags stragglers. Every config of ``--arch``
trains (``check_trainable``). An audio or vision model gets the zero bf16
frontend of (batch, n_frontend_tokens, d_model) that the JAX launcher
builds.

``--data`` and ``--model`` lay the ranks that ``torch.distributed.run``
starts out in a (data, model) mesh (``launch.mesh.make_host_mesh``): every
rank builds the same global batch and trains its shards of the state on its
rows (``training.train_step``); the backend is NCCL where each rank has a
card of its own, else gloo (``launch.mesh.placement``). Rank 0 prints the
mesh, the step lines and the checkpoints' manifest, which records the
mesh; a checkpoint holds whole leaves, so ``--resume`` may restore it onto
another mesh. In a world of one rank, ``--data`` or ``--model`` other than
1 raises ValueError naming the world size.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..checkpoint import Checkpointer
from ..configs import ARCHS, EXTRA_ARCHS, get_config
from ..data import DataConfig, TokenPipeline
from ..distributed import collectives as C
from ..distributed.fault_tolerance import RestartManifest, StepMonitor
from ..models import check_trainable, needs_frontend
from ..training import (AdamW, cosine_schedule, init_state, load_state_tree, make_train_step,
                        state_tree)
from .mesh import init_distributed, make_host_mesh
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
    ap.add_argument("--ckpt-every", type=int, default=50, help="0: write no checkpoint")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--token-file", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    rank, world, device = init_distributed(args.device)
    if world == 1 and (args.data != 1 or args.model != 1):
        raise ValueError(f"--data {args.data} --model {args.model} needs "
                         f"{args.data * args.model} ranks, but the world size is 1: start the "
                         "ranks with python -m torch.distributed.run --nproc-per-node "
                         f"{args.data * args.model}")
    mesh = make_host_mesh(args.data, args.model) if world > 1 else None
    lead = rank == 0
    cfg = preset_config(get_config(args.arch), args.preset)
    check_trainable(cfg)
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=max(args.steps // 20, 1),
                                   total=args.steps))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed,
                                    token_file=args.token_file))
    ck = Checkpointer(args.ckpt_dir)
    man_path = os.path.join(args.ckpt_dir, "manifest.json")
    mon = StepMonitor(on_straggler=lambda s, dt: print(
        f"[straggler] rank {rank} step {s} took {dt:.2f}s"))

    state = init_state(cfg, opt, args.seed, device, mesh)
    start = 0
    if args.resume and ck.latest_step() is not None:
        man = RestartManifest.load(man_path)
        tree, _ = ck.restore(state_tree(state, gather=False), mesh=mesh, cfg=cfg)
        load_state_tree(state, tree)
        start = man.step + 1
        if lead:
            print(f"resumed from step {man.step} (saved on the mesh {man.mesh_shape})")
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches,
                              has_frontend=needs_frontend(cfg))

    n_params = sum(p.numel() for p in state.model.parameters())
    shape = dict(mesh.shape) if mesh is not None else {"data": 1, "model": 1}
    if lead:
        print(f"training {cfg.name}: {n_params / 1e6:.1f}M params a rank, device={device}, "
              f"mesh={shape}, batch={args.batch}x{args.seq}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    C.reset_stats()
    busy = 0.0
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
        busy += dt
        if lead and (s % max(args.steps // 20, 1) == 0 or s == args.steps - 1):
            print(f"step {s:5d}  loss={float(metrics['loss']):.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.3f}  "
                  f"{args.batch * args.seq / dt:.0f} tok/s")
        if args.ckpt_every and (s % args.ckpt_every == 0 or s == args.steps - 1):
            tree = state_tree(state)
            if lead:
                ck.save(s, tree, extra={"data_step": s}, async_=True)
                RestartManifest(step=s, data_step=s, mesh_shape=shape,
                                rng_seed=args.seed).save(man_path)
    ck.wait()
    if mesh is not None:
        st = C.STATS
        peak = torch.tensor([torch.cuda.max_memory_allocated(device) / 2 ** 30
                             if device.type == "cuda" else 0.0], device=device)
        peaks = C.all_gather(peak, torch.distributed.group.WORLD)
        if lead:
            print(f"[dist] rank 0: {st['calls']} collectives, {st['bytes'] / 2 ** 20:.1f} MiB "
                  f"in, {st['staged_bytes'] / 2 ** 20:.1f} MiB staged through the host, "
                  f"{st['seconds']:.3f} s in collective calls of {busy:.3f} s of steps "
                  f"({100 * st['seconds'] / max(busy, 1e-9):.1f}%)")
            if device.type == "cuda":
                print("[dist] peak device memory by rank: "
                      + ", ".join(f"{float(p):.2f} GiB" for p in peaks))
        torch.distributed.destroy_process_group()
    elif lead and device.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f} GiB")
    if lead:
        print("done")
    return state


if __name__ == "__main__":
    main()
