"""The port's checkpointer (``repro_torch.checkpoint``), its JAX-layout
state tree (``training.state_tree``, ``models.bridge.params_to_jax``) and
the copied fault-tolerance pieces, on the CPU.

Checkpoints cross between the packages in both directions bit for bit
(bf16 included, written as raw 2-byte values), with manifests that list
the same keys, shapes and dtypes in the same order; a save, restore and
continue equals the straight run bit for bit.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jax_models
from repro import training as jt
from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.checkpoint.checkpointer import _flatten as jax_flatten, _path_key
from repro.configs import get_config as jax_get_config, \
    smoke_config as jax_smoke
from repro_torch import training as tt
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import flatten
from repro_torch.configs import ARCHS, EXTRA_ARCHS, get_config, smoke_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.distributed import FailureInjector, RestartManifest, StepMonitor
from repro_torch.models import init_params, params_from_jax, params_to_jax
from repro_torch.models.bridge import to_numpy, to_tensor

ARCH = "qwen2-0.5b"     # qkv biases (bf16 leaves of 2 dims when stacked)
# the MoE leaves (an fp32 router, bf16 experts of 3 dims, 4 when stacked),
# the LayerNorm biases, the encoder's stacked layers and the decoder's
# cross-attention, trained with a frontend
CROSSING = ["granite-moe-3b-a800m", "whisper-tiny"]


def frontend_of(cfg, B, step):
    """A seeded normal bf16 frontend (numpy) of an audio or vision config,
    else None."""
    if cfg.family not in ("audio", "vlm"):
        return None
    rng = np.random.default_rng(100 + step)
    return np.asarray(jnp.asarray(rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)),
                                  jnp.bfloat16))


def bits(a) -> np.ndarray:
    """The raw bits of an array or tensor, as unsigned integers."""
    a = to_numpy(a) if isinstance(a, torch.Tensor) else np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def jax_state(steps=1, arch=ARCH):
    """A JAX TrainState after `steps` steps (moments nonzero)."""
    jcfg = jax_smoke(jax_get_config(arch))
    opt = jt.AdamW(lr=jt.constant_schedule(1e-3))
    state = jt.init_state(jcfg, opt, jax.random.PRNGKey(0))
    fe = frontend_of(jcfg, 2, 0)
    step = jax.jit(jt.make_train_step(jcfg, opt, has_frontend=fe is not None))
    rng = np.random.default_rng(0)
    for _ in range(steps):
        tok = jnp.asarray(rng.integers(0, jcfg.vocab_size, (2, 17)), jnp.int32)
        b = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
        if fe is not None:
            b["frontend"] = jnp.asarray(fe)
        state, _ = step(state, b)
    return state


def port_state(seed=0, arch=ARCH):
    cfg = smoke_config(get_config(arch))
    opt = tt.AdamW(lr=tt.constant_schedule(1e-3))
    return cfg, opt, tt.init_state(cfg, opt, seed, "cpu")


def port_steps(cfg, opt, state, steps, start=0):
    step = tt.make_train_step(cfg, opt, has_frontend=frontend_of(cfg, 2, 0) is not None)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 16, 2, seed=5))
    losses = []
    for s in range(start, start + steps):
        b = {k: torch.from_numpy(v) for k, v in pipe.batch_at(s).items()}
        fe = frontend_of(cfg, 2, s)
        if fe is not None:
            b["frontend"] = to_tensor(fe)
        state, met = step(state, b)
        losses.append(float(met["loss"]))
    return state, losses


def jax_leaves(tree):
    return [(_path_key(p), np.asarray(leaf)) for p, leaf in jax_flatten(tree)[0]]


@pytest.mark.parametrize("arch", [ARCH] + CROSSING)
def test_jax_checkpoint_restores_into_the_port_bit_for_bit(tmp_path, arch):
    jstate = jax_state(arch=arch)
    JaxCheckpointer(str(tmp_path)).save(1, jstate, extra={"data_step": 1})
    cfg, opt, state = port_state(seed=3, arch=arch)
    tree, manifest = Checkpointer(str(tmp_path)).restore(tt.state_tree(state))
    tt.load_state_tree(state, tree)
    assert manifest["step"] == 1 and manifest["extra"] == {"data_step": 1}
    got = flatten(tt.state_tree(state))
    want = jax_leaves(jstate)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and np.array_equal(bits(a), bits(b)), key
    assert state.model.embed.dtype == torch.bfloat16 and int(state.opt.step) == 1


@pytest.mark.parametrize("arch", [ARCH] + CROSSING)
def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path, arch):
    cfg, opt, state = port_state(arch=arch)
    state, _ = port_steps(cfg, opt, state, 1)
    Checkpointer(str(tmp_path / "port")).save(1, tt.state_tree(state), extra={"data_step": 1})
    jstate = jax_state(arch=arch)
    JaxCheckpointer(str(tmp_path / "jax")).save(1, jstate, extra={"data_step": 1})
    restored, manifest = JaxCheckpointer(str(tmp_path / "port")).restore(jax_state(0, arch))
    want = flatten(tt.state_tree(state))
    got = jax_leaves(restored)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, a), (_, b) in zip(got, want):
        assert np.array_equal(bits(a), bits(b)), key
    assert str(np.asarray(restored.params["embed"]).dtype) == "bfloat16"
    with open(tmp_path / "jax" / "step_1" / "manifest.json") as f:
        jax_manifest = json.load(f)
    assert manifest["leaves"] == jax_manifest["leaves"]
    assert manifest["step"] == jax_manifest["step"] and manifest["extra"] == jax_manifest["extra"]


def test_atomic_commit_leaves_no_tmp(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(2)})
    assert os.listdir(tmp_path) == ["step_1"]
    assert sorted(os.listdir(tmp_path / "step_1")) == ["manifest.json", "shard_0.npz"]


def test_async_save_wait_and_keep_n(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    w = torch.zeros(4, dtype=torch.bfloat16)
    for s in (1, 2, 3, 4):
        ck.save(s, {"w": w}, async_=True)
        w += 1          # the host copy was taken before save returned
    ck.wait()
    assert ck.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]
    out, manifest = ck.restore({"w": w})
    assert out["w"].dtype == torch.bfloat16 and out["w"].tolist() == [3.0] * 4
    assert manifest["leaves"] == [{"key": "w", "shape": [4], "dtype": "bfloat16"}]
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"w": w})


def test_async_write_error_is_raised_by_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(2)}, async_=True)
    ck.wait()
    (tmp_path / "step_2.tmp").write_text("a file where the write wants a directory")
    ck.save(2, {"w": torch.ones(2)}, async_=True)
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()           # the error is raised once
    assert ck.latest_step() == 1


def test_save_restore_continue_equals_the_straight_run(tmp_path):
    """3 steps, checkpoint at step 2, a fresh model and optimizer restored
    from it, 2 more steps: every leaf and loss equals 5 straight steps."""
    cfg, opt, straight = port_state()
    straight, straight_losses = port_steps(cfg, opt, straight, 5)
    _, _, state = port_state()
    state, losses = port_steps(cfg, opt, state, 3)
    ck = Checkpointer(str(tmp_path))
    ck.save(2, tt.state_tree(state), async_=True)
    ck.wait()
    _, _, fresh = port_state(seed=9)
    tree, _ = ck.restore(tt.state_tree(fresh))
    fresh = tt.load_state_tree(fresh, tree)
    fresh, more = port_steps(cfg, opt, fresh, 2, start=3)
    assert losses + more == straight_losses
    for (key, a), (_, b) in zip(flatten(tt.state_tree(fresh)), flatten(tt.state_tree(straight))):
        assert np.array_equal(bits(a), bits(b)), key


@pytest.mark.parametrize("arch", sorted(ARCHS) + sorted(EXTRA_ARCHS))
def test_params_to_jax_round_trips_and_has_the_jax_layout(arch):
    """params_from_jax(params_to_jax(sd)) == sd bit for bit, and the tree
    has the keys, shapes and dtypes of the JAX init_params tree."""
    cfg = smoke_config(get_config(arch))
    sd = init_params(cfg, seed=2, device="cpu").state_dict()
    tree = params_to_jax(cfg, sd)
    back = params_from_jax(cfg, tree)
    assert set(back) == set(sd)
    for n, t in sd.items():
        assert back[n].dtype == t.dtype and np.array_equal(bits(back[n]), bits(t)), n
    jcfg = jax_smoke(jax_get_config(arch))
    shapes = jax.eval_shape(lambda: jax_models.init_params(jcfg, jax.random.PRNGKey(0)))
    want = [(_path_key(p), tuple(s.shape), str(s.dtype)) for p, s in jax_flatten(shapes)[0]]
    got = [(k, a.shape, "bfloat16" if a.dtype.kind == "V" else str(a.dtype))
           for k, a in flatten(tree)]
    assert got == want


# ---------------- fault tolerance (as tests/test_fault_tolerance.py) ----------------

def test_restart_manifest_roundtrip(tmp_path):
    m = RestartManifest(step=42, data_step=42, mesh_shape={"data": 4}, rng_seed=7)
    p = str(tmp_path / "manifest.json")
    m.save(p)
    m2 = RestartManifest.load(p)
    assert m2.step == 42 and m2.mesh_shape == {"data": 4}
    assert not os.path.exists(p + ".tmp")


def test_step_monitor_flags_straggler():
    hits = []
    mon = StepMonitor(window=20, threshold_sigma=3.0,
                      on_straggler=lambda s, dt: hits.append(s))
    for i in range(15):
        mon.start()
        mon.stop(i)
    mon.times = [0.01] * 15          # deterministic history
    mon.start()
    time.sleep(0.2)                  # a straggler step
    mon.stop(99)
    assert 99 in mon.straggler_steps and hits == [99]


def test_failure_injection_and_recovery(tmp_path):
    """Train, fail at step 3, restart from the checkpoint and manifest,
    continue: the final state equals an uninterrupted run bit for bit."""
    cfg, opt, ref = port_state()
    ref, _ = port_steps(cfg, opt, ref, 5)
    ck = Checkpointer(str(tmp_path / "run"))
    man_path = str(tmp_path / "manifest.json")
    step = tt.make_train_step(cfg, opt)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 16, 2, seed=5))

    def run(state, start, injector=None):
        for s in range(start, 5):
            if injector:
                injector.check(s)
            state, _ = step(state, {k: torch.from_numpy(v) for k, v in pipe.batch_at(s).items()})
            ck.save(s, tt.state_tree(state), extra={"data_step": s})
            RestartManifest(step=s, data_step=s, mesh_shape={}, rng_seed=0).save(man_path)
        return state

    inj = FailureInjector(fail_at_step=3)
    with pytest.raises(RuntimeError, match="injected node failure"):
        run(port_state()[2], 0, inj)
    inj.check(3)                     # fires once only
    man = RestartManifest.load(man_path)
    _, _, state = port_state(seed=4)
    tree, _ = ck.restore(tt.state_tree(state))
    state = run(tt.load_state_tree(state, tree), man.step + 1)
    for (key, a), (_, b) in zip(flatten(tt.state_tree(state)), flatten(tt.state_tree(ref))):
        assert np.array_equal(bits(a), bits(b)), key
