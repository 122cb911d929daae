"""Tensor parallelism of RWKV6 and batch rows replicated over the DP axes
that do not divide them, on gloo worlds of CPU ranks, against the JAX
package's single-device step, ``prefill`` and ``decode_step``.

Train (``step_grads`` on local shards): rwkv6 at smoke size, 4 rows of 96
tokens (past a wkv chunk of 64 steps), at (data, model) = (1, 2) and
(2, 2), with one and two microbatches on (2, 2), and once more at (1, 2)
with a head dim of 32, so that a rank holds 2 of the 4 heads (the smoke
config's 2 heads of 64 give one a rank, which hides a head-order slip).
Each case runs twice, with the bf16 weights and with every leaf fp32, and
both are held to JAX's single-device step on the same weights in fp32, as
``test_torch_dist_train.check`` holds a case: the loss and its parts, and
every gathered gradient (relative Frobenius norm), within 2e-2 for the
bf16 run and 2e-5 for the fp32 one; the master after one AdamW update
within 2e-5 of JAX's on the same gradients. (Two bf16 runs of this model
lie about 2e-2 apart: the single-rank port's bf16 step measured 2.1e-2
from JAX's bf16 step on ``u``, and at most 1.7e-2 from JAX's fp32 step;
the port's fp32 step lies 1.3e-6 from JAX's.) The inputs show a wrong
slice: ``w0`` and ``u`` are unhidden as
``test_torch_train_rwkv.unhidden`` does, ``ln_x`` (all ones at init) is
seeded per channel and both mixes' ``mu`` (all 0.5) per row and channel.
The launcher under ``torch.distributed.run`` trains rwkv6 at model 2.

Serve (``prefill`` and ``decode_step``, teacher forced for three steps),
as (pod, data, model): rwkv6 at (1, 1, 2), four prompts of 12, 9, 5 and 3
tokens (the lengths path), each held to JAX prefilling it alone (ROADMAP
C4); a batch of 1 at (1, 2, 2), replicated over data, for qwen3 and rwkv6;
and qwen3's batch of 2 at (2, 2, 1), its rows over data, replicated over
pod. The logits, gathered whole, within 2e-2 of JAX's (relative to their
largest), ``greedy_token`` the whole argmax, and no collective of prefill
or decode over an axis the rows replicate over. A train batch that does
not split raises ValueError naming the rule, and an MoE layer over
replicated rows NotImplementedError naming A12b.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jax_models
from repro.configs import get_config as jax_get_config, smoke_config as jax_smoke
from repro_torch.configs import get_config, smoke_config
from repro_torch.distributed.sharding import plan
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers
from repro_torch.models.bridge import params_from_jax
from repro_torch.models.lm import init_params

import _torch_dist
from test_torch_dist_serve import rel_err
from test_torch_dist_train import MB_ROWS, check, jax_reference, jax_weights, make_batch
from test_torch_train_rwkv import unhidden

ARCH = "rwkv6-7b"
TOL = 2e-2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: config changes of each train variant: the smoke config's, and a head dim
#: of 32 (4 heads, 2 a rank at model 2)
VARIANTS = {"rwkv6-7b": {}, "rwkv6-7b-n32": {"rwkv_head_dim": 32}}
#: the port's weights in each run, and its tolerance against JAX's fp32 step
DTYPES = {"bf16": TOL, "fp32": 2e-5}
TRAIN_CASES = [(f"{v}-{dt}", m, n) for v, m, n in (
    ("rwkv6-7b", (1, 2), 1), ("rwkv6-7b", (2, 2), 1), ("rwkv6-7b", (2, 2), 2),
    ("rwkv6-7b-n32", (1, 2), 1)) for dt in DTYPES]


def unhide(tree, seed=5):
    """``unhidden``'s ``w0`` and ``u``, ``ln_x`` seeded in [0.5, 1.5] per
    channel and every ``mu`` in [0, 1] per row and channel (in its
    bf16)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        key, a = path[-1].key, np.asarray(a)
        if key == "ln_x":
            return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        if key == "mu":
            return rng.uniform(0.0, 1.0, a.shape).astype(a.dtype)
        return a

    return unhidden(jax.tree_util.tree_map_with_path(leaf, tree))


def rwkv_weights(change=None):
    """(JAX config, JAX params unhidden, port config) of rwkv6's smoke
    config with `change`."""
    change = change or {}
    jcfg = dataclasses.replace(jax_smoke(jax_get_config(ARCH)), **change)
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)), **change)
    jparams = jax.tree.map(jnp.asarray, unhide(jax_models.init_params(
        jcfg, jax.random.PRNGKey(1))))
    return jcfg, jparams, cfg


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Every train case's JAX reference (the fp32 step) and port result, by
    "<variant>-<dtype>": two ranks for (1, 2), four for (2, 2); the
    references computed while they run."""
    tmp = tmp_path_factory.mktemp("dist_rwkv_train")
    refs, cases = {}, {}
    for variant, change in VARIANTS.items():
        jcfg, jparams, cfg = rwkv_weights(change)
        j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
        tok, tgt, mask, _ = make_batch(cfg, ARCH)
        for dt in DTYPES:
            key = f"{variant}-{dt}"
            state = params_from_jax(cfg, jax.tree.map(np.asarray,
                                                      j32 if dt == "fp32" else jparams))
            refs[key] = [jcfg, j32, cfg, None, state]
            for mb, rows in ((1, slice(0, 2)), (2, slice(0, 4))):
                meshes = [m for k, m, n in TRAIN_CASES if k == key and n == mb]
                if meshes:
                    cases[f"{key}_mb{mb}"] = {
                        "cfg": cfg, "state": state, "fp32": dt == "fp32", "microbatches": mb,
                        "frontend": False, "records": None, "meshes": meshes,
                        "batch": {"tokens": torch.from_numpy(tok[rows]),
                                  "targets": torch.from_numpy(tgt[rows]),
                                  "mask": torch.from_numpy(mask[rows]), "frontend": None}}
    path = tmp / "cases.pt"
    torch.save(cases, path)
    ctxs = [_torch_dist.start_world(tmp, n, "train_worker", str(path), [shape], str(tmp))
            for n, shape in ((2, (1, 2)), (4, (2, 2)))]
    for variant in VARIANTS:
        out = jax_reference(*refs[f"{variant}-fp32"][:3], ARCH, MB_ROWS)
        for dt in DTYPES:
            refs[f"{variant}-{dt}"][3] = out
    for ctx in ctxs:
        _torch_dist.join_world(ctx)
    return refs, tmp


@pytest.mark.parametrize("key,mesh,microbatches", TRAIN_CASES,
                         ids=[f"{k}-{m[0]}x{m[1]}-mb{n}" for k, m, n in TRAIN_CASES])
def test_tensor_parallel_rwkv6_step_matches_jax_single_device(trained, key, mesh,
                                                              microbatches):
    check(trained, key, mesh, microbatches, DTYPES[key.rsplit("-", 1)[1]])


def test_rank_heads_follow_the_head_dim():
    """At model 2 with a head dim of 32 rank 1 runs heads 2 and 3 of 4:
    channels [64, 128)."""
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)), rwkv_head_dim=32)
    par = plan(cfg, Mesh.abstract((1, 2), ("data", "model"), rank=1))
    assert par.rwkv_heads == (2, 2) and par.rwkv_channels == (64, 128)
    assert tuple(par.init_cache(1, 8, "meta")["state"].shape) == (cfg.n_layers, 1, 2, 32, 32)


def losses(out: str) -> list:
    return [float(m) for m in re.findall(r"^step\s+\d+\s+loss=([\d.]+)", out, re.M)]


def test_launcher_trains_rwkv6_at_model_2(tmp_path, capsys):
    """``torch.distributed.run`` of the train launcher at (data, model) =
    (1, 2) on rwkv6's tiny preset: three steps within 2e-2 of the
    single-rank launcher's losses."""
    from repro_torch.launch import train as train_launcher
    args = ["--arch", ARCH, "--device", "cpu", "--preset", "tiny", "--steps", "3",
            "--batch", "2", "--seq", "16", "--seed", "2", "--ckpt-every", "0"]
    train_launcher.main(args + ["--ckpt-dir", str(tmp_path / "one")])
    want = losses(capsys.readouterr().out)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *args,
                        "--data", "1", "--model", "2", "--ckpt-dir", str(tmp_path / "two")],
                       capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = losses(r.stdout)
    assert len(got) == len(want) == 3, r.stdout
    assert all(abs(a - b) < TOL * max(1.0, abs(b)) for a, b in zip(got, want)), (got, want)
    assert "mesh={'data': 1, 'model': 2}" in r.stdout


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

S, STEPS, MAX_LEN = 12, 3, 32
#: case: (arch, (pod, data, model), batch, prompt lengths or None)
SERVE = {"rwkv6_tp2_lens": (ARCH, (1, 1, 2), 4, [12, 9, 5, 3]),
         "rwkv6_b1_dp2_tp2": (ARCH, (1, 2, 2), 1, None),
         "qwen3_b1_dp2_tp2": ("qwen3-1.7b", (1, 2, 2), 1, None),
         "qwen3_b2_pod2_dp2": ("qwen3-1.7b", (2, 2, 1), 2, None)}
#: the axes each case's rows split over (``ModelShard.split_rows``)
SPLIT = {"rwkv6_tp2_lens": ("data",), "rwkv6_b1_dp2_tp2": (), "qwen3_b1_dp2_tp2": (),
         "qwen3_b2_pod2_dp2": ("data",)}


def jax_logits(jcfg, jparams, toks, steps, lens):
    """JAX's logits after prefill and after each teacher-forced step, (B,
    V) each: the wave at once, or with `lens` each prompt alone at batch 1
    (the port's lengths path is the JAX model's result for each prompt
    alone, ROADMAP C4)."""
    prefill = jax.jit(lambda p, t, c: jax_models.prefill(jcfg, p, t, c))
    decode = jax.jit(lambda p, t, c: jax_models.decode_step(jcfg, p, t, c))

    def run(t, st):
        lg, cache = prefill(jparams, t, jax_models.init_cache(jcfg, t.shape[0], MAX_LEN))
        out = [np.asarray(lg, np.float32)]
        for s in range(st.shape[1]):
            lg, cache = decode(jparams, st[:, s], cache)
            out.append(np.asarray(lg, np.float32))
        return out

    if lens is None:
        return run(toks, steps)
    alone = [run(toks[b:b + 1, :n], steps[b:b + 1]) for b, n in enumerate(lens)]
    return [np.concatenate([a[s] for a in alone]) for s in range(STEPS + 1)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_rwkv_serve")
    refs, cases = {}, {}
    for name, (arch, mesh, B, lens) in SERVE.items():
        jcfg, jparams, cfg = rwkv_weights() if arch == ARCH else jax_weights(arch)
        rng = np.random.default_rng(11)
        toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
        steps = rng.integers(0, cfg.vocab_size, (B, STEPS), dtype=np.int32)
        refs[name] = (cfg, jax_logits(jcfg, jparams, toks, steps, lens))
        cases[name] = {"cfg": cfg, "state": params_from_jax(cfg, jax.tree.map(np.asarray,
                                                                              jparams)),
                       "mesh": mesh, "records": None, "max_len": MAX_LEN,
                       "tokens": torch.from_numpy(toks), "steps": torch.from_numpy(steps),
                       "lens": None if lens is None else torch.tensor(lens, dtype=torch.int32)}
    path = tmp / "cases.pt"
    torch.save(cases, path)
    ctxs = [_torch_dist.start_world(tmp, n, "serve_worker", str(path), str(tmp)) for n in (2, 4)]
    for ctx in ctxs:
        _torch_dist.join_world(ctx)
    return refs, tmp


@pytest.mark.parametrize("case", list(SERVE))
def test_serving_matches_jax_and_replicated_rows_run_no_collective(served, case):
    refs, tmp = served
    cfg, want = refs[case]
    got = torch.load(tmp / f"serve_{case}.pt", weights_only=False)
    V, B = cfg.vocab_size, SERVE[case][2]
    assert len(got["logits"]) == len(want) == STEPS + 1
    for step, (g, w) in enumerate(zip(got["logits"], want)):
        g = g.float().numpy()
        assert g.shape == (B, w.shape[-1]), (step, g.shape)
        assert rel_err(g[:, :V], w[:, :V]) < TOL, (step, rel_err(g[:, :V], w[:, :V]))
        assert (g[:, V:] < -1e29).all()
    for g, tok in zip(got["logits"], got["greedy"]):
        assert torch.equal(tok, g.float().argmax(-1))
    pod, data, model = SERVE[case][1]
    assert tuple(got["batch_axes"]) == SPLIT[case]
    sizes = {"pod": pod, "data": data, "model": model}
    replicated = {a for a in ("pod", "data") if sizes[a] > 1 and a not in SPLIT[case]}
    assert not replicated & set(got["collective_axes"]), got["collective_axes"]
    assert ("model" in got["collective_axes"]) == (model > 1)


def test_train_batch_that_does_not_split_raises_naming_the_rule():
    par = plan(smoke_config(get_config("qwen3-1.7b")), Mesh.abstract((2, 2), ("data", "model")))
    with pytest.raises(ValueError, match="_batch_axes rule"):
        par.split_rows(1, train=True)
    assert par.split_rows(1) == () and par.batch_axes == () and par.data_size == 1
    assert par.split_rows(4, train=True) == ("data",) and par.rows is None
    pod = plan(smoke_config(get_config("qwen3-1.7b")),
               Mesh.abstract((2, 2, 1), ("pod", "data", "model")))
    assert pod.split_rows(2) == ("data",) and pod.batch_axes == ("data",)
    assert pod.split_rows(4) == ("pod", "data") and pod.rows is None


def test_moe_over_replicated_rows_names_a12b():
    cfg = smoke_config(get_config("granite-moe-3b-a800m"))
    par = plan(cfg, Mesh.abstract((2, 1), ("data", "model")))
    par.split_rows(1)
    moe = init_params(cfg, seed=0, device="cpu").blocks[0].moe
    x = torch.zeros((1, 4, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="A12b"):
        layers.moe_apply(cfg, moe, x, par=par)
