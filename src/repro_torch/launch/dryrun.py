"""Dry run of the production meshes: every (architecture x input shape)
cell, one rank's program traced on fake tensors, its memory, FLOPs,
kernel launches and collectives recorded.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \
        --shape decode_32k --mesh single            # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]

The JAX package's dry run (``repro.launch.dryrun``) compiles each cell's
SPMD program for 256 or 512 placeholder devices. The port has no SPMD
compiler: each rank runs its local shards (``distributed.sharding.plan``)
and calls its collectives itself, so one rank's program is fixed by its
local config and the collectives it calls, and tracing that program is
the dry run. Rank 0 is traced: no rank holds more (``rank0_largest``, for
the experts that ``_moe_pad_experts`` pads). The program runs on an
abstract mesh of the production shape whose axes record their collectives
(``Mesh.abstract(..., recorder=)``), on fake tensors
(``torch._subclasses.fake_tensor``), so no memory is taken and no kernel
is launched: every kernel wrapper, given a fake tensor, takes the route a
real tensor would, allocates what the launch would, counts it and returns
(``kernels._trace``). ``--device cuda`` (the default) traces the card's
program: fake CUDA tensors, or, where torch has no CUDA build, fake CPU
tensors standing for the card (``device.card_standin``); ``--device cpu``
traces the CPU path. No card and no nvcc are needed.

The programs are the JAX dry run's: train, one step of `microbatches`
microbatches (forward, backward, the ZeRO update); prefill, one prefill into
a cache of seq_len + 128; decode, one step against a cache seq_len deep.
Records go to <out>/<arch>__<shape>__<mesh>.json (cells on disk are kept
unless --force); ``launch.roofline_report`` prices them on the H100.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, get_config, shape_applicable
from ..configs.base import ModelConfig, ShapeConfig
from ..device import card_standin
from ..distributed.collectives import Recorder
from ..distributed.sharding import attach, init_sharded, plan
from .. import kernels as K
from ..models import input_specs, needs_frontend
from ..models.bridge import decayed_leaves
from ..models.lm import LM
from ..training import AdamW, constant_schedule, step_grads
from . import analysis
from .mesh import Mesh, production_mesh_shape

OUT_DIR = "experiments/dryrun_torch"
MESHES = {"single": production_mesh_shape(False), "multi": production_mesh_shape(True)}
#: the cache a prefill writes into holds this many slots past the prompt
PREFILL_SLACK = 128


def cache_len(shape: ShapeConfig) -> int:
    """Slots of a cell's cache: seq_len for a decode step, seq_len + 128
    for a prefill."""
    return shape.seq_len if shape.kind == "decode" else shape.seq_len + PREFILL_SLACK


def rank0_largest(cfg: ModelConfig, mesh) -> bool:
    """Whether rank 0's shards are as large as any rank's: every leaf
    splits evenly over its axes (``plan`` refuses the rest), so only the
    experts a data rank runs differ, the JAX ``_moe_pad_experts`` padding
    leaving the last ranks fewer."""
    E, D = cfg.n_experts, mesh.shape.get("data", 1)
    if not E:
        return True
    e_pad = -(-E // D) * D
    counts = [min((i + 1) * e_pad // D, E) - min(i * e_pad // D, E) for i in range(D)]
    return counts[0] == max(counts)


class RankProgram:
    """One rank's program of a cell: its shards of the model (``plan`` on
    `mesh`), the optimizer state's ZeRO slices or the cache at its local
    config, and its rows of the inputs (``ModelShard.split_rows``: a
    serving batch that the DP axes do not divide is replicated over them,
    long_500k's one row on every rank), on `device`. ``run`` executes the
    program once. Without a `seed` the weights are left as allocated (a
    trace reads none); with one they are drawn as ``init_sharded`` draws
    them, the tokens from the same seed, and a decode cache's positions set
    to its last slot."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, mesh, device,
                 microbatches: int = 8, kv_mode: str = "channel", seed=None):
        if kv_mode != "channel":
            raise NotImplementedError(f"kv mode {kv_mode!r}: the cache's time axis over model "
                                      "needs the decode kernels' log-sum-exp for a cross-rank "
                                      "combine (ROADMAP A12b); the port runs \"channel\"")
        self.cfg, self.shape, self.microbatches = cfg, shape, microbatches
        par = self.par = plan(cfg, mesh)
        B = shape.global_batch
        par.split_rows(B, train=shape.kind == "train")
        rows = B // par.data_size
        self.model = (attach(LM(cfg, None, device), par) if seed is None
                      else init_sharded(cfg, mesh, seed, device))
        gen = None if seed is None else torch.Generator(device).manual_seed(seed + 1)
        self.inputs = {}
        for name, (dims, dtype) in input_specs(cfg, shape).items():
            dims = (rows,) + tuple(dims[1:])
            if dtype == torch.int32 and gen is not None:
                t = torch.randint(0, cfg.vocab_size, dims, generator=gen, device=device,
                                  dtype=dtype)
            elif name == "mask":
                t = torch.ones(dims, dtype=dtype, device=device)
            elif gen is not None:
                t = torch.randn(dims, generator=gen, device=device).to(dtype)
            else:
                t = torch.zeros(dims, dtype=dtype, device=device)
            self.inputs[name] = t
        self.state = {}
        if shape.kind == "train":
            self.model.requires_grad_(True)
            self.opt = AdamW(lr=constant_schedule(1e-4))
            self.opt_state = self.opt.init(dict(self.model.named_parameters()), par)
            st = self.opt_state
            self.state = {"step": st.step, **{f"{k}.{n}": t for k, d in
                                              (("master", st.master), ("m", st.m), ("v", st.v))
                                              for n, t in d.items()}}
        else:
            self.cache = par.init_cache(rows, cache_len(shape), device)
            if shape.kind == "decode" and seed is not None:
                self.cache["pos"].fill_(shape.seq_len - 1)
            self.state = dict(self.cache)

    def entry(self) -> list:
        """The tensors the program is handed: parameters, optimizer state or
        cache, inputs."""
        return [*self.model.parameters(), *self.state.values(), *self.inputs.values()]

    def run(self):
        """The program once; returns its outputs (the loss, or the logits of
        this rank's vocab columns)."""
        cfg, par, model = self.cfg, self.par, self.model
        fe = self.inputs.get("frontend") if needs_frontend(cfg) else None
        if self.shape.kind == "train":
            lv, grads, _ = step_grads(model, self.inputs, self.microbatches, needs_frontend(cfg),
                                      local=True)
            params = dict(model.named_parameters())
            self.opt_state, _ = self.opt.update(grads, self.opt_state, params,
                                                decayed_leaves(cfg, params), par.global_sq, par)
            return [lv]
        with torch.no_grad():
            if self.shape.kind == "prefill":
                return [model.prefill(self.inputs["tokens"], self.cache, frontend=fe)]
            return [model.decode_step(self.inputs["token"], self.cache)]


def trace_device(device: str):
    """(device of the fake tensors, its label, whether they stand for the
    card) of a trace of `device`'s program."""
    if device == "cpu":
        return "cpu", "fake cpu", False
    if torch.backends.cuda.is_built():
        return "cuda", "fake cuda", False
    return "cpu", "fake cpu standing for cuda (torch has no CUDA build)", True


def measure(prog_fn, recorder: Recorder, live=None) -> dict:
    """Build a ``RankProgram`` (`prog_fn`), run it once with every launch
    count set to 0 and a FLOP counter, and return what it did: kernel
    launches by name, the cost, the collectives, and with a `live` tracker
    (``analysis.LiveBytes``, given the entry tensors) the memory."""
    from torch.utils.flop_counter import FlopCounterMode
    from torch.utils._pytree import tree_leaves
    prog = prog_fn()
    K.reset_launches()
    recorder.calls.clear()
    tracker = analysis.LiveBytes(prog.entry()) if live else contextlib.nullcontext()
    with FlopCounterMode(display=False) as fc, tracker:
        out = prog.run()
    res = {"kernels": {n: c for n, c in K.launches().items() if c},
           "cost": analysis.cost_summary(fc.get_total_flops(), K.ops()),
           "collectives": recorder.stats(), "collectives_by_axis": recorder.by_axis(),
           "program": prog}
    if live:
        res["memory"] = analysis.memory_summary(tracker, tree_leaves(out))
    return res


def trace(cfg: ModelConfig, shape: ShapeConfig, mesh, device: str = "cuda",
          microbatches: int = 8, kv_mode: str = "channel", rank: int = 0) -> dict:
    """`rank`'s program of a cell traced on fake tensors (``measure``), on
    the production `mesh` of that name ("single", "multi") or on a mesh of
    (shape, axis names)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    recorder = Recorder()
    dims, axes = MESHES[mesh] if isinstance(mesh, str) else mesh
    mesh = Mesh.abstract(dims, axes, rank=rank, recorder=recorder)
    tdev, label, standin = trace_device(device)
    with FakeTensorMode(), (card_standin() if standin else contextlib.nullcontext()):
        res = measure(lambda: RankProgram(cfg, shape, mesh, tdev, microbatches, kv_mode),
                      recorder, live=True)
    res.pop("program")
    res["traced_on"] = label
    return res


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str = OUT_DIR,
             force: bool = False, verbose: bool = True, microbatches: int = 8,
             kv_mode: str = "channel", device: str = "cuda") -> dict:
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if kv_mode == "channel" else f"__kv-{kv_mode}"
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "skipped": True,
               "reason": "long_500k needs sub-quadratic attention (DESIGN.md Sec. 5)"}
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        return rec
    dims, axes = MESHES[mesh_kind]
    n_dev = 1
    for d in dims:
        n_dev *= d
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "devices": n_dev,
           "kind": shape.kind, "microbatches": microbatches if shape.kind == "train" else 1,
           "kv_mode": kv_mode, "rank": 0, "device": device}
    t0 = time.time()
    try:
        res = trace(cfg, shape, mesh_kind, device, microbatches, kv_mode)
        mem = res["memory"]
        rec.update({
            "ok": True, "trace_s": round(time.time() - t0, 2), "traced_on": res["traced_on"],
            "memory": mem, "cost": res["cost"], "collectives": res["collectives"],
            "collectives_by_axis": res["collectives_by_axis"],
            "bytes_per_device": mem["total_bytes"], "kernels": res["kernels"],
            "rank0_largest": rank0_largest(cfg, Mesh.abstract(dims, axes)),
            "params": cfg.param_count(), "active_params": cfg.active_param_count(),
            "tokens": shape.tokens if shape.kind != "decode" else shape.global_batch,
        })
        if verbose:
            print(f"[{arch} | {shape_name} | {mesh_kind}] OK  trace={rec['trace_s']}s  "
                  f"mem/dev={mem['total_bytes'] / 2**30:.2f}GiB  "
                  f"flops={rec['cost']['flops']:.3e}  "
                  f"coll={rec['collectives']['bytes'] / 2**20:.1f}MiB", flush=True)
    except Exception as e:  # noqa: BLE001 -- record the failure, keep going
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
        if verbose:
            print(f"[{arch} | {shape_name} | {mesh_kind}] FAIL {e}", flush=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--kv-shard", choices=["channel", "sequence", "auto"], default="channel")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="whose program to trace: the card's (default) or the CPU path's")
    args = ap.parse_args(argv)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(arch, shape, m) for arch in ARCHS for shape in SHAPES for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, m) for m in meshes]
    n_ok = n_fail = n_skip = 0
    for arch, shape, m in cells:
        rec = run_cell(arch, shape, m, out_dir=args.out, force=args.force,
                       microbatches=args.microbatches, kv_mode=args.kv_shard,
                       device=args.device)
        if rec.get("skipped"):
            n_skip += 1
        elif rec.get("ok"):
            n_ok += 1
        else:
            n_fail += 1
    print(f"dry-run: {n_ok} ok, {n_fail} failed, {n_skip} skipped (inapplicable cells)")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
