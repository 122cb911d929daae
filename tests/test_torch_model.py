"""The port's dense and RWKV6 models against the JAX model on the same
weights.

Weights come from the JAX package's ``init_params`` and cross into the port
through ``params_from_jax`` (bf16 bit-exact). Tokens come from numpy. The
logits of ``forward``, ``prefill`` and ``decode_step`` are compared teacher-
forced, on the same tokens, as relative error to the largest logit below
2e-2: both run in bf16, which rounds at other places in the two frameworks;
the port's SwiGLU gate rounds ``silu(g) * u`` to bf16 once where the JAX
model rounds ``silu(g)`` and the product separately, and its tanh-GELU
computes in fp32 and rounds once where the JAX model computes
``jax.nn.gelu(approximate=True)`` on a bf16 tensor.

RWKV6's prefill of a right-padded wave keeps each prompt's pads out of its
state, where the JAX prefill runs them through it (``ROADMAP.md``, C4); so
the port's wave is held against JAX prefilling each prompt alone, and
against the JAX wave only where the wave's prompts are of one length.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jax_models
from repro.configs import ModelConfig as JaxModelConfig
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke
from repro.models import layers as jax_layers
from repro_torch import models
from repro_torch.configs import (ARCHS, EXTRA_ARCHS, ModelConfig, get_config,
                                  smoke_config)
from repro_torch.models import layers as t_layers
from repro_torch.models.lm import LM, padded_vocab

PORTED = sorted(ARCHS) + sorted(EXTRA_ARCHS)
DENSE = [a for a in PORTED if get_config(a).family == "dense"]
TOL = 2e-2


def rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def t2np(t):
    return t.float().numpy()


def port_cfg(jax_cfg):
    return ModelConfig(**dataclasses.asdict(jax_cfg))


def _pair(arch):
    """(jax cfg, jax params, port model) of `arch`'s smoke config on the
    same weights."""
    jcfg = jax_smoke(jax_get_config(arch))
    jparams = jax_models.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = port_cfg(jcfg)
    model = LM(cfg, device="cpu")
    model.load_state_dict(models.params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, model


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def rwkv_pair():
    return _pair("rwkv6-7b")


def tokens(cfg, B=2, S=16, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S),
                                                dtype=np.int32)


def test_port_config_matches_jax_config():
    for arch in PORTED:
        assert port_cfg(jax_get_config(arch)) == get_config(arch)
        assert port_cfg(jax_smoke(jax_get_config(arch))) == smoke_config(get_config(arch))


@pytest.mark.parametrize("fraction", [1.0, 0.25])
def test_apply_rope_matches_jax(fraction):
    """RoPE with full and partial rotary fractions, bit for bit: the same
    fp32 products and sums, one rounding to bf16."""
    cfg = dataclasses.replace(smoke_config(get_config("qwen3-1.7b")),
                              rope_fraction=fraction)
    x = np.random.default_rng(4).standard_normal((2, 9, 4, 32)).astype(np.float32)
    pos = np.tile(np.arange(3, 12, dtype=np.int32), (2, 1))
    want = jax_layers.apply_rope(JaxModelConfig(**dataclasses.asdict(cfg)),
                                 jax.numpy.asarray(x, jax.numpy.bfloat16), pos)
    got = t_layers.apply_rope(cfg, torch.from_numpy(x).to(torch.bfloat16),
                              torch.from_numpy(pos))
    assert np.array_equal(t2np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("offset", [0, 37])
def test_sinusoidal_positions_match_jax(offset):
    """The table the port adds to gpt3's embeddings, against the JAX one,
    to fp32 rounding of sin and cos (two libraries' sin and cos)."""
    want = np.asarray(jax_layers.sinusoidal_positions(20, 128, offset), np.float32)
    got = t_layers.sinusoidal_positions(torch.arange(offset, offset + 20), 128)
    assert got.dtype == torch.float32 and got.shape == (20, 128)
    assert np.abs(t2np(got) - want).max() < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax_layers(dtype):
    """The model's LayerNorm (any leading shape) against the JAX model's."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 9, 128)) * 3 + 1).astype(np.float32)
    g = rng.standard_normal(128).astype(np.float32)
    b = rng.standard_normal(128).astype(np.float32)
    jdt, tdt = {"float32": (jax.numpy.float32, torch.float32),
                "bfloat16": (jax.numpy.bfloat16, torch.bfloat16)}[dtype]
    want = jax_layers.layer_norm(jax.numpy.asarray(x, jdt), g, b)
    got = t_layers.layer_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(g),
                              torch.from_numpy(b))
    assert got.shape == (2, 9, 128) and got.dtype == tdt
    assert rel_err(t2np(got), want) < (2e-2 if dtype == "bfloat16" else 2e-5)


def test_forward_matches_jax(pair):
    jcfg, jparams, model = pair
    toks = tokens(jcfg)
    want, _ = jax.jit(lambda p, t: jax_models.forward(jcfg, p, t))(jparams, toks)
    got = model(torch.from_numpy(toks))
    assert got.shape == (2, 16, padded_vocab(model.cfg))
    V = jcfg.vocab_size
    assert rel_err(t2np(got)[..., :V], np.asarray(want, np.float32)[..., :V]) < TOL
    # padded vocab entries never win, in either framework
    assert (t2np(got)[..., V:] < -1e29).all()


def test_prefill_and_decode_match_jax(pair):
    """Right-padded prompts of different lengths, then three teacher-forced
    decode steps, against the JAX serving path."""
    jcfg, jparams, model = pair
    V = jcfg.vocab_size
    toks = tokens(jcfg, B=3, S=12, seed=1)
    lens = np.array([12, 7, 3], np.int32)
    jcache = jax_models.init_cache(jcfg, 3, 32)
    jl, jcache = jax.jit(lambda p, t, c, n: jax_models.prefill(
        jcfg, p, t, c, prompt_lens=n))(jparams, toks, jcache, lens)
    cache = models.init_cache(model.cfg, 3, 32, device="cpu")
    tl = model.prefill(torch.from_numpy(toks), cache, torch.from_numpy(lens))
    assert rel_err(t2np(tl)[:, :V], np.asarray(jl, np.float32)[:, :V]) < TOL
    assert cache["pos"].tolist() == lens.tolist()
    jdecode = jax.jit(lambda p, t, c: jax_models.decode_step(jcfg, p, t, c))
    step_toks = tokens(jcfg, B=3, S=3, seed=2)
    for s in range(3):
        jl, jcache = jdecode(jparams, step_toks[:, s], jcache)
        tl = model.decode_step(torch.from_numpy(step_toks[:, s]), cache)
        assert rel_err(t2np(tl)[:, :V], np.asarray(jl, np.float32)[:, :V]) < TOL
    assert cache["pos"].tolist() == (lens + 3).tolist()
    # the port's K/V cache holds what the JAX cache holds
    jk = np.asarray(jcache["units"]["u0"]["k"], np.float32)   # (L, B, T, Hkv*dh)
    assert rel_err(t2np(cache["k"]), jk) < TOL


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_decode_matches_forward(arch):
    """Mirror of test_models_smoke.py::test_prefill_decode_matches_forward
    on the port alone: the cached serving path agrees with teacher-forced
    forward logits. As there, an MoE model is held by its greedy tokens:
    its experts' capacity depends on the tokens of the call (32 in forward,
    2 at the decode step), so other assignments drop."""
    cfg = smoke_config(get_config(arch))
    model = models.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(tokens(cfg, B=2, S=16))
    fe = None    # a cross-attending model's stub frontend
    if cfg.n_frontend_tokens:
        fe = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)).to(torch.bfloat16)
    logits = model(toks, fe)
    cache = models.init_cache(cfg, 2, 32, device="cpu")
    V = cfg.vocab_size

    def check(got, want, tol):
        got, want = t2np(got)[:, :V], t2np(want)[:, :V]
        if cfg.n_experts:
            assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99
        else:
            assert rel_err(got, want) < tol

    check(model.prefill(toks[:, :-1], cache, frontend=fe), logits[:, -2], 0.05)
    check(model.decode_step(toks[:, -1], cache), logits[:, -1], 0.07)


def test_param_count_matches_config_at_full_width():
    """qwen3-1.7b at full width, shapes only (meta device): the port's
    parameters are the config's accounting plus the vocab padding."""
    cfg = get_config("qwen3-1.7b")
    model = models.init_params(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    pad = padded_vocab(cfg) - cfg.vocab_size
    assert n - pad * cfg.d_model == cfg.param_count()
    assert all(p.device.type == "meta" for p in model.parameters())


@pytest.mark.parametrize("arch,n_config", [("stablelm-1.6b", 1_644_365_824),
                                            ("gpt3-175b", 175_189_561_344)])
def test_layernorm_param_counts_at_full_size(arch, n_config):
    """stablelm-1.6b and gpt3-175b at full size, shapes only (meta device):
    the config's accounting, plus the vocab padding of the embedding (and of
    the untied head), plus the final LayerNorm's bias, which the accounting
    leaves out (it counts d_model for the final norm)."""
    cfg = get_config(arch)
    assert cfg.param_count() == n_config
    model = models.init_params(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    pad = padded_vocab(cfg) - cfg.vocab_size
    n_heads_padded = 1 if cfg.tie_embeddings else 2
    assert n == n_config + pad * cfg.d_model * n_heads_padded + cfg.d_model
    assert set(model.final_norm) == {"scale", "bias"}
    assert ("w_gate" in model.blocks[0].mlp) == cfg.mlp_gated


def test_rwkv6_smoke_config_keeps_its_head_dim():
    """Two heads of 64 at d=128, as in JAX; the channel mix is int(3.5 d)
    wide, not d_ff."""
    cfg = smoke_config(get_config("rwkv6-7b"))
    assert (cfg.d_model, cfg.rwkv_head_dim, cfg.d_ff) == (128, 64, 256)
    model = models.init_params(cfg, seed=0, device="cpu")
    assert model.blocks[0].cmix["w_up"].shape == (128, 448)
    assert model.blocks[0].tmix["u"].dtype == torch.float32


def test_rwkv6_forward_matches_jax(rwkv_pair):
    jcfg, jparams, model = rwkv_pair
    toks = tokens(jcfg)
    want, _ = jax.jit(lambda p, t: jax_models.forward(jcfg, p, t))(jparams, toks)
    got = model(torch.from_numpy(toks))
    V = jcfg.vocab_size
    assert got.shape == (2, 16, padded_vocab(model.cfg))
    assert rel_err(t2np(got)[..., :V], np.asarray(want, np.float32)[..., :V]) < TOL


def _jax_alone(jcfg, jparams, prompt, steps):
    """JAX prefill of one prompt alone at batch 1, then teacher-forced
    decode steps: (logits after prefill and each step, cache after each)."""
    prefill = jax.jit(lambda p, t, c: jax_models.prefill(jcfg, p, t, c))
    decode = jax.jit(lambda p, t, c: jax_models.decode_step(jcfg, p, t, c))
    lg, cache = prefill(jparams, jnp.asarray([prompt]), jax_models.init_cache(jcfg, 1, 32))
    out = [(lg, cache)]
    for tok in steps:
        lg, cache = decode(jparams, jnp.asarray([tok], jnp.int32), cache)
        out.append((lg, cache))
    return out


def _rwkv_cache_err(cache, b, jcache):
    """Largest relative error of sequence b's state and token shifts against
    a batch-1 JAX cache."""
    unit = jcache["units"]["u0"]
    return max(rel_err(t2np(cache[name][:, b]), np.asarray(unit[name], np.float32)[:, 0])
               for name in ("state", "sx_t", "sx_c"))


def test_rwkv6_padded_wave_matches_jax_per_request(rwkv_pair):
    """A right-padded wave of prompts of 12, 7 and 3 tokens, then three
    teacher-forced decode steps: each sequence's logits, state and token
    shifts against JAX run on its prompt alone (C4: the pads stay out of
    the state). The JAX wave itself leaves the short prompts' states far
    from that, so this comparison sees a pad in the state."""
    jcfg, jparams, model = rwkv_pair
    V = jcfg.vocab_size
    toks = tokens(jcfg, B=3, S=12, seed=1)
    lens = [12, 7, 3]
    steps = tokens(jcfg, B=3, S=3, seed=2)
    cache = models.init_cache(model.cfg, 3, 32, device="cpu")
    got = [model.prefill(torch.from_numpy(toks), cache,
                         torch.tensor(lens, dtype=torch.int32))]
    caches = [{name: t.clone() for name, t in cache.items()}]
    for s in range(3):
        got.append(model.decode_step(torch.from_numpy(steps[:, s]), cache))
        caches.append({name: t.clone() for name, t in cache.items()})
    assert cache["pos"].tolist() == [15, 10, 6]
    for b, n in enumerate(lens):
        for s, (jl, jc) in enumerate(_jax_alone(jcfg, jparams, toks[b, :n].tolist(),
                                                steps[b].tolist())):
            assert rel_err(t2np(got[s][b])[:V], np.asarray(jl, np.float32)[0, :V]) < TOL, (b, s)
            assert _rwkv_cache_err(caches[s], b, jc) < TOL, (b, s)
    jwave = jax_models.prefill(jcfg, jparams, toks, jax_models.init_cache(jcfg, 3, 32),
                               prompt_lens=np.asarray(lens, np.int32))[1]
    jstate = np.asarray(jwave["units"]["u0"]["state"])
    assert rel_err(t2np(caches[0]["state"][:, 2]), jstate[:, 2]) > 10 * TOL


def test_rwkv6_equal_length_wave_matches_jax_wave(rwkv_pair):
    """Where a wave's prompts are of one length the JAX wave is right: the
    port's wave against it, prefill and three decode steps, cache too."""
    jcfg, jparams, model = rwkv_pair
    V = jcfg.vocab_size
    toks = tokens(jcfg, B=2, S=10, seed=3)
    jl, jcache = jax.jit(lambda p, t, c: jax_models.prefill(jcfg, p, t, c))(
        jparams, toks, jax_models.init_cache(jcfg, 2, 32))
    cache = models.init_cache(model.cfg, 2, 32, device="cpu")
    tl = model.prefill(torch.from_numpy(toks), cache)
    assert rel_err(t2np(tl)[:, :V], np.asarray(jl, np.float32)[:, :V]) < TOL
    jdecode = jax.jit(lambda p, t, c: jax_models.decode_step(jcfg, p, t, c))
    for s in range(3):
        tok = tokens(jcfg, B=2, S=1, seed=4 + s)[:, 0]
        jl, jcache = jdecode(jparams, tok, jcache)
        tl = model.decode_step(torch.from_numpy(tok), cache)
        assert rel_err(t2np(tl)[:, :V], np.asarray(jl, np.float32)[:, :V]) < TOL
    for name in ("state", "sx_t", "sx_c"):
        want = np.asarray(jcache["units"]["u0"][name], np.float32)
        assert rel_err(t2np(cache[name]), want) < TOL, name
    assert cache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()


def test_rwkv6_param_count_at_full_size():
    """rwkv6-7b at full size, shapes only (meta device), has exactly the
    JAX init's parameters (``jax.eval_shape``, no memory). The config's
    accounting says 40,628,224 more: it counts 310 d a layer too many (six
    32 x d mixing vectors and a doubled decay LoRA, where the model has
    eight d-vectors and one LoRA of rank 64) and d for the final LayerNorm,
    which has a bias too (ROADMAP.md, C6)."""
    cfg = get_config("rwkv6-7b")
    shapes = jax.eval_shape(lambda: jax_models.init_params(
        jax_get_config("rwkv6-7b"), jax.random.PRNGKey(0)))
    n_jax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    model = models.init_params(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == n_jax == 6_997_942_272
    d, L = cfg.d_model, cfg.n_layers
    assert cfg.param_count() == 7_038_570_496 == n + 310 * d * L - d
    assert padded_vocab(cfg) == cfg.vocab_size
    assert {p.dtype for p in model.blocks[0].tmix.values()} == {torch.bfloat16,
                                                                torch.float32}


@pytest.mark.parametrize("arch,change,field", [
    ("whisper-tiny", {"n_frontend_tokens": 0}, "cross_attention"),
    ("whisper-tiny", {"n_encoder_layers": 0}, "cross_attention"),
    ("whisper-tiny", {"qk_norm": True}, "cross_attention"),
    ("llama-3.2-vision-11b", {"n_frontend_tokens": 0}, "cross_attn_layers"),
    ("llama-3.2-vision-11b", {"n_experts": 4, "top_k": 2}, "cross_attn_layers"),
    ("llama-3.2-vision-11b", {"qkv_bias": True}, "cross_attn_layers"),
    ("llama-3.2-vision-11b", {"cross_attention": True}, "cross_attention"),
    ("llama-3.2-vision-11b", {"family": "video"}, "family"),
])
def test_configs_outside_the_slice_raise(arch, change, field):
    """Cross-attending configs the port does not run: an encoder-decoder
    without frontend tokens, without an encoder, or with qk-norm (the JAX
    cached encdec arm leaves the cross q un-normed where its forward norms
    it); vision cross layers without frontend tokens, in an MoE model
    (the JAX xattn layer is built with a dense MLP and applied with the MoE
    one) or with qkv biases (a request without a frontend gets zero cross
    K/V from zero frontend rows, which biases would move); both kinds of cross-attention at once; another family."""
    cfg = dataclasses.replace(smoke_config(port_cfg(jax_get_config(arch))), **change)
    with pytest.raises(NotImplementedError, match=field):
        models.init_params(cfg, device="cpu")


@pytest.mark.parametrize("change,field", [
    ({"n_encoder_layers": 2}, "n_encoder_layers"),
    ({"cross_attention": True}, "cross_attention"),
    ({"cross_attn_layers": (1,)}, "cross_attn_layers"),
    ({"n_frontend_tokens": 16}, "n_frontend_tokens"),
    ({"activation": "relu"}, "activation"),
    ({"mlp_gated": False, "activation": "relu"}, "activation"),
    ({"norm": "layernorm", "block_pattern": ("attn", "xattn")}, "block_pattern"),
    ({"norm": "scalenorm"}, "norm"),
])
def test_dense_fields_outside_the_slice_raise(change, field):
    cfg = dataclasses.replace(smoke_config(get_config("qwen3-1.7b")), **change)
    with pytest.raises(NotImplementedError, match=field):
        models.init_cache(cfg, 1, 8, device="cpu")
