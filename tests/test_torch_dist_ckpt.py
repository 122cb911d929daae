"""Checkpoints across meshes and the sharded launcher, on gloo worlds of
CPU ranks (qwen3-smoke).

A sharded run gathers its state whole and rank 0 writes the single-rank
format (``training.state_tree``), so a checkpoint saved at (data, model) =
(2, 2) restores into a single-rank run leaf for leaf, and onto (1, 4) as
each rank's slices (``Checkpointer.restore(..., mesh=, cfg=)``); a run
saved at (1, 2) and regrouped by ``remesh`` into data 2 resumes within
2e-2 of the straight run. The launcher started by ``torch.distributed.run``
with ``--data 2`` on the CPU trains three steps within 2e-2 of the
single-rank launcher's losses and records the mesh in its manifest.
"""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import flatten
from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed.sharding import shard, train_tree_spec
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import Mesh
from repro_torch.models.bridge import to_tensor
from repro_torch.training import AdamW, constant_schedule, init_state, load_state_tree, state_tree

import _torch_dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = smoke_config(get_config("qwen3-1.7b"))


def same(a, b) -> bool:
    """Equal bits (bf16 leaves are raw 2-byte values)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def raw(t):
    t = t if isinstance(t, np.ndarray) else to_tensor(t)
    return t if isinstance(t, np.ndarray) else (
        t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy())


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_ckpt")
    ctxs = [_torch_dist.start_world(tmp, n, "ckpt_worker", str(tmp)) for n in (4, 2)]
    for ctx in ctxs:
        _torch_dist.join_world(ctx)
    return tmp


def saved(tmp):
    """The (2, 2) run's checkpoint restored on one rank: {key: whole leaf}."""
    single = init_state(CFG, AdamW(lr=constant_schedule(1e-3)), 9, "cpu")
    tree, _ = Checkpointer(str(tmp / "ckpt_4")).restore(state_tree(single))
    return single, tree


@pytest.mark.parametrize("rank", range(4))
def test_checkpoint_saved_at_2x2_holds_every_ranks_shards(worlds, rank):
    _, tree = saved(worlds)
    local = dict(flatten(torch.load(worlds / f"local_2x2_{rank}.pt", weights_only=False)))
    mesh = Mesh.abstract((2, 2), ("data", "model"), rank=rank)
    for key, whole in flatten(tree):
        want = shard(raw(whole), train_tree_spec(mesh, CFG, key, whole.shape), mesh)
        assert same(raw(local[key]), want), key


def test_checkpoint_saved_at_2x2_restores_on_one_rank(worlds):
    single, tree = saved(worlds)
    load_state_tree(single, tree)
    back = dict(flatten(state_tree(single)))
    for key, whole in flatten(tree):
        assert same(raw(back[key]), raw(whole)), key
    assert int(single.opt.step) == 1


@pytest.mark.parametrize("rank", range(4))
def test_checkpoint_restores_onto_1x4_as_each_ranks_slices(worlds, rank):
    _, tree = saved(worlds)
    local = dict(flatten(torch.load(worlds / f"local_1x4_{rank}.pt", weights_only=False)))
    mesh = Mesh.abstract((1, 4), ("data", "model"), rank=rank)
    for key, whole in flatten(tree):
        spec = train_tree_spec(mesh, CFG, key, whole.shape)
        assert same(raw(local[key]), shard(raw(whole), spec, mesh)), key
        if key == ".params/units/u0/attn/wq":
            assert spec == (None, None, "model")


def test_remeshed_resume_equals_the_straight_run(worlds):
    r = torch.load(worlds / "remesh.pt", weights_only=False)
    assert r["mesh"] == {"pod": 1, "data": 2, "model": 1}
    assert len(r["resumed"]) == len(r["straight"]) == 3
    for a, b in zip(r["resumed"], r["straight"]):
        assert abs(a - b) < 2e-2 * max(1.0, abs(b)), (r["resumed"], r["straight"])


def losses(out: str) -> list:
    return [float(m) for m in re.findall(r"^step\s+\d+\s+loss=([\d.]+)", out, re.M)]


def test_launcher_under_torch_distributed_run_trains_data_parallel(tmp_path, capsys):
    args = ["--arch", "qwen3-1.7b", "--device", "cpu", "--preset", "tiny", "--steps", "3",
            "--batch", "4", "--seq", "16", "--seed", "2"]
    train_launcher.main(args + ["--ckpt-dir", str(tmp_path / "one")])
    want = losses(capsys.readouterr().out)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *args,
                        "--data", "2", "--ckpt-dir", str(tmp_path / "two")],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = losses(r.stdout)
    assert len(got) == len(want) == 3, r.stdout
    assert all(abs(a - b) < 2e-2 * max(1.0, abs(b)) for a, b in zip(got, want)), (got, want)
    assert "mesh={'data': 2, 'model': 1}" in r.stdout and "backend gloo" in r.stdout
    man = json.load(open(tmp_path / "two" / "manifest.json"))
    assert man["mesh_shape"] == {"data": 2, "model": 1} and man["step"] == 2
    assert (tmp_path / "two" / "step_2" / "manifest.json").exists()
