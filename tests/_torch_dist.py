"""Worlds of gloo ranks for the port's distributed tests, and their workers.

``start_world`` spawns `world` processes (``torch.multiprocessing``'s
spawn, never a fork of the test process) that join one gloo group over a
``FileStore`` in a temporary directory and call a worker of this module by
name; ``join_world`` waits for them and raises what a rank raised. The
workers read their inputs from, and write their results to, files that the
test writes and reads with ``torch.save`` / ``torch.load``.

Imports no JAX (a worker imports this module), so that
``test_torch_cuda.py`` can use it where only the port is installed.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, store, device, worker, args):
    sys.path[:0] = [p for p in (os.path.join(os.path.dirname(__file__), "..", "src"),
                                os.path.dirname(__file__)) if p not in sys.path]
    # one thread a rank: the worlds of a test file run side by side at
    # smoke sizes, where more threads only contend for the host's cores
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        globals()[worker](rank, world, *args)
    finally:
        dist.destroy_process_group()


def start_world(tmp, world: int, worker: str, *args, device: str = "cpu"):
    """Spawn `world` ranks running ``worker(rank, world, *args)`` (a
    function of this module) in one gloo group; returns the context that
    ``join_world`` takes."""
    store = os.path.join(str(tmp), f"store_{worker}_{world}_{os.getpid()}_{id(args)}")
    return mp.start_processes(_entry, args=(world, store, device, worker, args), nprocs=world,
                              join=False, start_method="spawn")


def join_world(ctx, timeout: float = 240.0):
    while not ctx.join(timeout):
        pass


def run_world(tmp, world: int, worker: str, *args, device: str = "cpu"):
    join_world(start_world(tmp, world, worker, *args, device=device))


def _replay(records, route):
    """The port's ``moe_route`` returning the recorded experts, call by
    call, gated by `route`'s (the unreplayed function's) probabilities at
    them, as ``_torch_routing.replay_routing`` does without pytest's
    monkeypatch (a worker is a process of its own)."""
    from repro_torch.models import layers
    calls = iter(records)

    def replayed(cfg, p, xt):
        probs, _, idx = route(cfg, p, xt)
        idx = torch.as_tensor(np.array(next(calls)[0]), dtype=torch.long, device=xt.device)
        gate = probs.gather(-1, idx)
        return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), idx

    layers.moe_route = replayed


def sharded_model(case, mesh, device="cpu"):
    """The case's model (its whole state dict, ``params_from_jax`` of the
    JAX weights; every leaf fp32 where the case says "fp32") on this rank's
    shards of `mesh`, trainable."""
    from repro_torch.distributed.sharding import attach, plan
    from repro_torch.models.lm import LM
    model = LM(case["cfg"], None, device)
    if case.get("fp32"):
        model = model.float()
    model.load_state_dict(case["state"])
    return attach(model, plan(case["cfg"], mesh)).requires_grad_(True)


def train_worker(rank, world, cases_path, meshes, out_dir, device="cpu"):
    """Every case of `cases_path` on every mesh of `meshes` ((data, model)
    shapes over this world): one step's loss, metrics and kernel launches,
    the gradients gathered whole, and the master copy after one AdamW
    update, gathered;
    rank 0 writes them to ``<out_dir>/<case>_<data>x<model>.pt``."""
    from repro_torch import kernels as K
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers
    from repro_torch.models.bridge import decayed_leaves
    from repro_torch.training import AdamW, constant_schedule, step_grads
    cases = torch.load(cases_path, weights_only=False)
    route = layers.moe_route
    for shape in meshes:
        mesh = make_host_mesh(*shape)
        for name, case in cases.items():
            if tuple(shape) not in case["meshes"]:
                continue
            model = sharded_model(case, mesh, device)
            if case["records"] is not None:
                _replay(case["records"], route)
            batch = {k: v.to(device) for k, v in case["batch"].items() if v is not None}
            K.reset_launches()
            try:
                loss, grads, met = step_grads(model, batch, case["microbatches"],
                                              case["frontend"])
            finally:
                layers.moe_route = route
            launches = K.launches()
            par = model.par
            opt = AdamW(lr=constant_schedule(1e-2), weight_decay=0.1)
            params = dict(model.named_parameters())
            st = opt.init(params)
            st, stats = opt.update(grads, st, params, decayed_leaves(case["cfg"], params),
                                   par.global_sq)
            whole = {"grads": par.gather_state(grads), "master": par.gather_state(st.master)}
            if rank == 0:
                torch.save({"loss": float(loss), "launches": launches,
                            "met": {k: float(v) for k, v in met.items()},
                            "grad_norm": float(stats["grad_norm"]), **whole},
                           os.path.join(out_dir, f"{name}_{shape[0]}x{shape[1]}.pt"))
            del model, grads, st


def pipeline_worker(rank, world, inputs_path, out_path, device="cpu"):
    """``pipeline_apply`` over a pod axis of `world`: the stacked tanh stack
    of `inputs_path` and, where it holds a model, its blocks split across
    the stages; every rank's outputs, rank 0's written to `out_path`."""
    from repro_torch.distributed.pipeline import pipeline_apply, stage_params
    from repro_torch.launch.mesh import make_host_mesh
    inp = torch.load(inputs_path, weights_only=False)
    mesh = make_host_mesh(pod=world)
    w = stage_params(inp["w"].to(device), mesh)

    def tanh_stack(ws, x):
        for wi in ws:
            x = torch.tanh(x @ wi)
        return x

    outs = {"tanh": pipeline_apply(mesh, tanh_stack, w, inp["x"].to(device),
                                   inp["n_microbatches"]).cpu()}
    if "state" in inp:
        from repro_torch.models.lm import LM
        cfg = inp["cfg"]
        model = LM(cfg, None, device)
        model.load_state_dict(inp["state"])
        per = cfg.n_layers // world
        mine = range(mesh.index("pod") * per, (mesh.index("pod") + 1) * per)
        for i, blk in enumerate(model.blocks):     # each stage keeps its own blocks
            if i not in mine:
                model.blocks[i] = torch.nn.Module()
        outs["blocks"] = pipeline_apply(mesh, lambda m, x: m.apply_layers(x, mine), model,
                                        inp["h"].to(device), inp["n_microbatches"]).cpu()
    gathered = [None] * world
    dist.all_gather_object(gathered, outs)
    if rank == 0:
        torch.save(gathered, out_path)


def ckpt_worker(rank, world, out_dir):
    """Checkpoints across meshes, qwen3-smoke. A world of 4: a step at
    (data, model) = (2, 2), the state gathered and saved by rank 0, each
    rank's own shards written beside it; then a fresh state at (1, 4)
    restored from it, its shards written. A world of 2: three steps
    straight at (1, 2); again two steps, saved, the ranks regrouped by
    ``remesh`` into (pod, data, model) = (1, 2, 1), restored, the third
    step run; rank 0 writes both runs' losses."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed.fault_tolerance import remesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import (AdamW, constant_schedule, init_state, load_state_tree,
                                      make_train_step, state_tree)
    cfg = smoke_config(get_config("qwen3-1.7b"))
    opt = AdamW(lr=constant_schedule(1e-3))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 16, 4, seed=1))
    step = make_train_step(cfg, opt)
    ck = Checkpointer(os.path.join(out_dir, f"ckpt_{world}"))

    def run(state, steps):
        losses = []
        for s in steps:
            state, met = step(state, {k: torch.from_numpy(v) for k, v in
                                      pipe.batch_at(s).items()})
            losses.append(float(met["loss"]))
        return state, losses

    def save(state, s):
        tree = state_tree(state)
        if rank == 0:
            ck.save(s, tree)
        dist.barrier()

    if world == 4:
        state, _ = run(init_state(cfg, opt, 0, "cpu", make_host_mesh(2, 2)), range(1))
        save(state, 0)
        torch.save(state_tree(state, gather=False), os.path.join(out_dir, f"local_2x2_{rank}.pt"))
        mesh = make_host_mesh(1, 4)
        fresh = init_state(cfg, opt, 5, "cpu", mesh)
        tree, _ = ck.restore(state_tree(fresh, gather=False), mesh=mesh, cfg=cfg)
        load_state_tree(fresh, tree)
        torch.save(state_tree(fresh, gather=False), os.path.join(out_dir, f"local_1x4_{rank}.pt"))
        return
    mesh = make_host_mesh(1, 2)
    _, straight = run(init_state(cfg, opt, 0, "cpu", mesh), range(3))
    state, before = run(init_state(cfg, opt, 0, "cpu", mesh), range(2))
    save(state, 1)
    regrouped = remesh(model_parallel=1)
    fresh = init_state(cfg, opt, 7, "cpu", regrouped)
    tree, _ = ck.restore(state_tree(fresh, gather=False), mesh=regrouped, cfg=cfg)
    _, after = run(load_state_tree(fresh, tree), range(2, 3))
    if rank == 0:
        torch.save({"straight": straight, "resumed": before + after,
                    "mesh": dict(regrouped.shape)}, os.path.join(out_dir, "remesh.pt"))


def rank_program_worker(rank, world, cases_path, out_dir):
    """The dry run's rank programs (``launch.dryrun.RankProgram``) of the
    cases of `cases_path` on a real (2, 2) mesh of this world, each run once
    with the collectives observed, the aten FLOPs counted and the live
    storages tracked (``dryrun.measure``); rank 0 writes what each did to
    ``<out_dir>/program_<case>.pt``."""
    from repro_torch.distributed.collectives import Recorder, observe
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    cases = torch.load(cases_path, weights_only=False)
    mesh = make_host_mesh(2, 2)
    for name, (cfg, shape, microbatches) in cases.items():
        rec = Recorder()
        with observe(rec):
            res = dryrun.measure(lambda: dryrun.RankProgram(cfg, shape, mesh, "cpu", microbatches,
                                                            seed=0), rec, live=True)
        res.pop("program")
        res.pop("collectives_by_axis")
        if rank == 0:
            torch.save(res, os.path.join(out_dir, f"program_{name}.pt"))


def serve_worker(rank, world, cases_path, out_dir):
    """Tensor-parallel prefill and decode of every case of `cases_path` on
    its (pod, data, model) mesh of this world: the case's prompts (with its
    prompt lengths, where it has them), its rows over the axes
    ``ModelShard.split_rows`` gives the batch (replicated over the others),
    prefilled into a cache of the rank's heads, then teacher-forced decode
    steps; the logits of every step gathered whole (the vocab over model,
    the rows over the axes they split over), the greedy tokens
    ``greedy_token`` picks from the rank's columns, the axes the rows split
    over and the axes of every collective that prefill and decode ran.
    Rank 0 writes them to ``<out_dir>/serve_<case>.pt``."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import gather
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers
    from repro_torch.models.lm import greedy_token
    cases = torch.load(cases_path, weights_only=False)
    route = layers.moe_route
    for name, case in cases.items():
        pod, data, model_ = case["mesh"]
        if pod * data * model_ != world:
            continue
        mesh = make_host_mesh(data, model_, pod)
        m = sharded_model(case, mesh).requires_grad_(False)
        par = m.par
        if case["records"] is not None:
            _replay(case["records"], route)
        toks, steps, lens = case["tokens"], case["steps"], case.get("lens")
        rows = par.local_rows(torch.arange(toks.shape[0]))
        cache = par.init_cache(len(rows), case["max_len"], "cpu")
        axis_of = {id(g): a for a, g in mesh.groups.items()}
        run, axes = C.run, set()

        def recorded(op, t, group, **kw):
            axes.add(axis_of[id(group)])
            return run(op, t, group, **kw)

        def all_rows(t):
            for axis in reversed(par.batch_axes):
                t = C.all_gather(t, mesh.group(axis), dim=0)
            return t

        def whole(logits):
            return all_rows(gather(logits, (None, "model"), mesh))

        C.run = recorded
        try:
            logits = [m.prefill(toks[rows], cache, None if lens is None else lens[rows])]
            for s in range(steps.shape[1]):
                logits.append(m.decode_step(steps[rows, s], cache))
        finally:
            layers.moe_route = route
            C.run = run
        greedy = [all_rows(greedy_token(lg, par)) for lg in logits]
        logits = [whole(lg) for lg in logits]
        if rank == 0:
            torch.save({"logits": logits, "greedy": greedy, "batch_axes": par.batch_axes,
                        "collective_axes": sorted(axes)},
                       os.path.join(out_dir, f"serve_{name}.pt"))


def zero_worker(rank, world, cases_path, out_dir):
    """The train step with ZeRO's optimizer state (``AdamW.init(params,
    par)``) for every case of `cases_path` on its (pod, data, model) mesh of
    this world: the loss, the gradients gathered whole, the master copy after
    one update gathered whole, and each rank's optimizer-state bytes; rank 0
    writes them to ``<out_dir>/zero_<case>.pt``."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.bridge import decayed_leaves
    from repro_torch.training import AdamW, constant_schedule, step_grads
    from repro_torch.models import layers
    cases = torch.load(cases_path, weights_only=False)
    route = layers.moe_route
    for name, case in cases.items():
        pod, data, model_ = case["mesh"]
        if pod * data * model_ != world:
            continue
        mesh = make_host_mesh(data, model_, pod)
        model = sharded_model(case, mesh)
        par = model.par
        if case["records"] is not None:
            _replay(case["records"], route)
        try:
            loss, grads, met = step_grads(model, case["batch"], case["microbatches"], False)
        finally:
            layers.moe_route = route
        opt = AdamW(lr=constant_schedule(1e-2), weight_decay=0.1)
        params = dict(model.named_parameters())
        st = opt.init(params, par)
        state_bytes = sum(t.numel() * t.element_size() for t in st.master.values())
        st, stats = opt.update(grads, st, params, decayed_leaves(case["cfg"], params),
                               par.global_sq, par)
        every = [None] * world
        dist.all_gather_object(every, state_bytes)
        whole = {"grads": par.gather_state(grads), "master": par.gather_state(st.master, True),
                 "params": par.gather_state(params)}
        if rank == 0:
            torch.save({"loss": float(loss), "grad_norm": float(stats["grad_norm"]),
                        "met": {k: float(v) for k, v in met.items()}, "state_bytes": every,
                        **whole}, os.path.join(out_dir, f"zero_{name}.pt"))
