"""The port's recurrentgemma-2b (Griffin) against the JAX model on the same
weights, at smoke size: d = 128, 4 query heads of 32 on one kv-head, a
local window of 64, RG-LRU layers with a width-4 conv, a gated-GELU MLP.

Weights come from the JAX package's ``init_params`` through
``params_from_jax`` (bf16 bit-exact; the RG-LRU gate weights fp32). Tokens
come from numpy. Logits are compared as relative error to the largest logit
below 2e-2, as in ``test_torch_model.py``: both run in bf16, which rounds
at other places in the two frameworks (the gated GELU rounds once here,
twice in JAX).

The smoke config has 6 layers, two units of (rglru, rglru, attn); the tests
also run 8, which adds the JAX tree's remainder of two rglru layers, as the
full model's 26 layers have. Prompts past the window exercise the ring
cache: the prefill of a prompt longer than the ring, then decode steps past
its wrap. Where a wave's prompts differ in length, the port keeps each
prompt's pads out of its RG-LRU state and conv carry and keeps each prompt's
own last keys in the ring, which the JAX wave does not (``ROADMAP.md``, C4):
the port's wave is held against JAX prefilling each prompt alone, and
against the JAX wave where the prompts are of one length.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jax_models
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke
from repro_torch import models
from repro_torch.configs import ModelConfig, get_config, smoke_config
from repro_torch.models.lm import LM, layer_kinds, padded_vocab, unit_structure

TOL = 2e-2
ARCH = "recurrentgemma-2b"


def rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def t2np(t):
    return t.float().numpy()


def _pair(n_layers):
    jcfg = dataclasses.replace(jax_smoke(jax_get_config(ARCH)), n_layers=n_layers)
    jparams = jax_models.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = LM(cfg, device="cpu")
    model.load_state_dict(models.params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, model


@pytest.fixture(scope="module", params=[6, 8], ids=["6-layers", "8-layers"])
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def pair8():
    return _pair(8)


def tokens(V, B, S, seed):
    return np.random.default_rng(seed).integers(0, V, (B, S), dtype=np.int32)


def _cache_by_kind(cfg, jcache, b=None):
    """The JAX cache in the port's layout (each leaf's layers of one kind
    stacked in layer order), fp32 numpy; sequence `b` only if given."""
    unit, n_units, rem = unit_structure(cfg)
    per_layer = [jax.tree.map(lambda a, r=r: a[r], jcache["units"][f"u{j}"])
                 for r in range(n_units) for j in range(len(unit))]
    per_layer += [jcache["rem"][f"r{j}"] for j in range(len(rem))]
    out = {}
    for name in ("k", "v", "h", "conv"):
        leaves = [np.asarray(p[name], np.float32) for p in per_layer if name in p]
        out[name] = np.stack(leaves) if b is None else np.stack(leaves)[:, b]
    return out


def test_config_and_layer_structure():
    """The port's config is the JAX one; its layers are JAX's unit of
    (rglru, rglru, attn) eight times and a remainder of two rglru layers."""
    cfg = get_config(ARCH)
    assert ModelConfig(**dataclasses.asdict(jax_get_config(ARCH))) == cfg
    assert unit_structure(cfg) == (("rglru", "rglru", "attn"), 8, ("rglru", "rglru"))
    assert layer_kinds(cfg).count("attn") == 8 and layer_kinds(cfg).count("rglru") == 18
    s = smoke_config(cfg)
    assert (s.n_layers, s.d_model, s.n_heads, s.n_kv_heads, s.d_head, s.attn_window) == \
        (6, 128, 4, 1, 32, 64)


def test_param_count_at_full_size():
    """recurrentgemma-2b at full size, shapes only (meta device), has
    exactly the JAX init's parameters (``jax.eval_shape``, no memory):
    2,894,481,920, of which the fp32 w_a and w_x of its 18 RG-LRU layers.
    The config's accounting says 92,160 fewer: it leaves out each RG-LRU
    layer's conv bias and lam, 2 d each (ROADMAP.md, C6)."""
    cfg = get_config(ARCH)
    shapes = jax.eval_shape(lambda: jax_models.init_params(jax_get_config(ARCH),
                                                           jax.random.PRNGKey(0)))
    n_jax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    model = models.init_params(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == n_jax == 2_894_481_920
    assert cfg.param_count() == n - 2 * cfg.d_model * 18
    assert padded_vocab(cfg) == cfg.vocab_size
    assert model.blocks[0].rec["w_a"].dtype == torch.float32
    assert model.blocks[2].attn["wq"].shape == (2560, 10 * 256)


def test_forward_matches_jax(pair):
    jcfg, jparams, model = pair
    toks = tokens(jcfg.vocab_size, 2, 80, 0)        # past the window of 64
    want, _ = jax.jit(lambda p, t: jax_models.forward(jcfg, p, t))(jparams, toks)
    got = model(torch.from_numpy(toks))
    V = jcfg.vocab_size
    assert got.shape == (2, 80, padded_vocab(model.cfg))
    assert rel_err(t2np(got)[..., :V], np.asarray(want, np.float32)[..., :V]) < TOL


def test_prefill_past_the_window_and_decode_past_the_wrap_match_jax(pair):
    """Two prompts of 100 tokens (past the ring of 64 slots that max_len 128
    and the window of 64 give), then six decode steps, teacher-forced, against
    the JAX serving path: logits at each step, and the ring K/V, RG-LRU state
    and conv carry after the last."""
    jcfg, jparams, model = pair
    V = jcfg.vocab_size
    toks = tokens(V, 2, 100, 1)
    jl, jcache = jax.jit(lambda p, t, c: jax_models.prefill(jcfg, p, t, c))(
        jparams, toks, jax_models.init_cache(jcfg, 2, 128))
    cache = models.init_cache(model.cfg, 2, 128, device="cpu")
    assert cache["k"].shape[2] == 64
    tl = model.prefill(torch.from_numpy(toks), cache)
    assert rel_err(t2np(tl)[:, :V], np.asarray(jl, np.float32)[:, :V]) < TOL
    jdecode = jax.jit(lambda p, t, c: jax_models.decode_step(jcfg, p, t, c))
    for s in range(6):
        tok = tokens(V, 2, 1, 10 + s)[:, 0]
        jl, jcache = jdecode(jparams, tok, jcache)
        tl = model.decode_step(torch.from_numpy(tok), cache)
        assert rel_err(t2np(tl)[:, :V], np.asarray(jl, np.float32)[:, :V]) < TOL, s
    assert cache["pos"].tolist() == [106, 106]
    for name, want in _cache_by_kind(model.cfg, jcache).items():
        assert rel_err(t2np(cache[name]), want) < TOL, name


def _jax_alone(jcfg, jparams, prompt, steps, max_len):
    prefill = jax.jit(lambda p, t, c: jax_models.prefill(jcfg, p, t, c))
    decode = jax.jit(lambda p, t, c: jax_models.decode_step(jcfg, p, t, c))
    lg, cache = prefill(jparams, jnp.asarray([prompt]), jax_models.init_cache(jcfg, 1, max_len))
    out = [(lg, cache)]
    for tok in steps:
        lg, cache = decode(jparams, jnp.asarray([tok], jnp.int32), cache)
        out.append((lg, cache))
    return out


def test_padded_wave_matches_jax_per_request(pair8):
    """A right-padded wave of prompts of 100, 70 and 30 tokens (the first two
    past the window), then four teacher-forced decode steps: each sequence's
    logits, RG-LRU state, conv carry and live ring slots against JAX run on
    its prompt alone (C4). The JAX wave itself runs the short prompt's pads
    through its state and fills its ring with the wave's last positions
    (pads for it), so its logits there are far from the prompt's own."""
    jcfg, jparams, model = pair8
    V, T = jcfg.vocab_size, 128
    toks = tokens(V, 3, 100, 2)
    lens = [100, 70, 30]
    steps = tokens(V, 3, 4, 3)
    cache = models.init_cache(model.cfg, 3, T, device="cpu")
    got = [model.prefill(torch.from_numpy(toks), cache, torch.tensor(lens, dtype=torch.int32))]
    caches = [{name: t.clone() for name, t in cache.items()}]
    for s in range(4):
        got.append(model.decode_step(torch.from_numpy(steps[:, s]), cache))
        caches.append({name: t.clone() for name, t in cache.items()})
    assert cache["pos"].tolist() == [104, 74, 34]
    W = cache["k"].shape[2]
    for b, n in enumerate(lens):
        for s, (jl, jc) in enumerate(_jax_alone(jcfg, jparams, toks[b, :n].tolist(),
                                                steps[b].tolist(), T)):
            assert rel_err(t2np(got[s][b])[:V], np.asarray(jl, np.float32)[0, :V]) < TOL, (b, s)
            want = _cache_by_kind(model.cfg, jc, 0)
            live = min(n + s, W)                     # ring slots holding this prompt's keys
            for name in ("h", "conv"):
                assert rel_err(t2np(caches[s][name][:, b]), want[name]) < TOL, (b, s, name)
            for name in ("k", "v"):
                assert rel_err(t2np(caches[s][name][:, b, :live]),
                               want[name][:, :live]) < TOL, (b, s, name)
    _, jwave = jax_models.prefill(jcfg, jparams, toks, jax_models.init_cache(jcfg, 3, T),
                                  prompt_lens=np.asarray(lens, np.int32))
    jwave_dec, _ = jax_models.decode_step(jcfg, jparams, steps[:, 0], jwave)
    assert rel_err(t2np(got[1][2])[:V], np.asarray(jwave_dec, np.float32)[2, :V]) > 2 * TOL
