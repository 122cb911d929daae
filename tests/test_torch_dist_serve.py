"""Tensor-parallel prefill and decode of the port (``LM.prefill`` and
``LM.decode_step`` on a model axis, a cache of the rank's heads in kv mode
"channel"), on gloo worlds of CPU ranks, against the JAX package's
single-device ``prefill`` and ``decode_step``.

Cases, at smoke size, as (pod, data, model): qwen3 at (1, 1, 2) and at
(1, 1, 4), where its 2 kv heads replicate over the 4 model ranks and each
rank caches the one its q head reads; stablelm (layernorm, partial RoPE,
untied head) at (1, 1, 2); granite (MoE) at (1, 2, 2), its rows gathered
over data so that routing is the whole batch's (ROADMAP C10: the JAX
routing is recorded and replayed, ``_torch_routing``'s way, and a rank
that routed its own rows alone would not take the record's shape); and
qwen3 at (2, 1, 2), the rows over the pod axis. Four prompts of 12 tokens
are prefilled into a cache of 32, then three decode steps are teacher
forced. The logits of every step, gathered whole, lie within 2e-2 of the
JAX logits (relative to their largest; the smoke models are bf16, so the
fp32 bound of 2e-5 has no case here), and ``greedy_token`` over the ranks'
vocab columns picks the whole logits' argmax, the least index on a tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import models as jax_models
from repro.models import layers as jax_layers
from repro_torch.models.bridge import params_from_jax

import _torch_dist
from test_torch_dist_train import jax_weights

TOL = 2e-2
B, S, STEPS, MAX_LEN = 4, 12, 3, 32
CASES = {"qwen3_tp2": ("qwen3-1.7b", (1, 1, 2)), "qwen3_tp4": ("qwen3-1.7b", (1, 1, 4)),
         "stablelm_tp2": ("stablelm-1.6b", (1, 1, 2)),
         "granite_dp2_tp2": ("granite-moe-3b-a800m", (1, 2, 2)),
         "qwen3_pod2_tp2": ("qwen3-1.7b", (2, 1, 2))}


def rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def jax_serve(arch):
    """(port config, whole state dict, prompts, decode tokens, the JAX
    logits of the prefill and of each step, the JAX routing records)."""
    jcfg, jparams, cfg = jax_weights(arch)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    steps = rng.integers(0, cfg.vocab_size, (B, STEPS), dtype=np.int32)
    records, moe_apply = [], jax_layers.moe_apply

    def recorded(c, p, x, capacity_factor=1.25):
        logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p["router"]
        _, idx = lax.top_k(jax.nn.softmax(logits, axis=-1), c.top_k)
        jax.debug.callback(lambda i, lg: records.append((np.asarray(i), np.asarray(lg))),
                           idx, logits, ordered=True)
        return moe_apply(c, p, x, capacity_factor)

    jax_layers.moe_apply = recorded
    try:
        cache = jax_models.init_cache(jcfg, B, MAX_LEN)
        jl, cache = jax.jit(lambda p, t, c: jax_models.prefill(jcfg, p, t, c))(
            jparams, toks, cache)
        out = [np.asarray(jl, np.float32)]
        decode = jax.jit(lambda p, t, c: jax_models.decode_step(jcfg, p, t, c))
        for s in range(STEPS):
            jl, cache = decode(jparams, steps[:, s], cache)
            out.append(np.asarray(jl, np.float32))
        jax.effects_barrier()
    finally:
        jax_layers.moe_apply = moe_apply
    state = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    return cfg, state, toks, steps, out, (list(records) if cfg.n_experts else None)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_serve")
    refs, cases = {}, {}
    for name, (arch, mesh) in CASES.items():
        cfg, state, toks, steps, want, records = jax_serve(arch)
        refs[name] = (cfg, want)
        cases[name] = {"cfg": cfg, "state": state, "mesh": mesh, "records": records,
                       "tokens": torch.from_numpy(toks), "steps": torch.from_numpy(steps),
                       "max_len": MAX_LEN}
    path = tmp / "cases.pt"
    torch.save(cases, path)
    ctxs = [_torch_dist.start_world(tmp, n, "serve_worker", str(path), str(tmp)) for n in (2, 4)]
    for ctx in ctxs:
        _torch_dist.join_world(ctx)
    return refs, tmp


@pytest.mark.parametrize("case", list(CASES))
def test_tp_prefill_and_decode_match_jax_single_device(served, case):
    refs, tmp = served
    cfg, want = refs[case]
    got = torch.load(tmp / f"serve_{case}.pt", weights_only=False)
    V = cfg.vocab_size
    assert len(got["logits"]) == len(want) == STEPS + 1
    for step, (g, w) in enumerate(zip(got["logits"], want)):
        g = g.float().numpy()
        assert g.shape == (B, w.shape[-1]), (step, g.shape)
        assert rel_err(g[:, :V], w[:, :V]) < TOL, (step, rel_err(g[:, :V], w[:, :V]))
        assert (g[:, V:] < -1e29).all()


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_token_over_vocab_shards_is_the_whole_argmax(served, case):
    refs, tmp = served
    got = torch.load(tmp / f"serve_{case}.pt", weights_only=False)
    for g, tok in zip(got["logits"], got["greedy"]):
        assert torch.equal(tok, g.float().argmax(-1))
