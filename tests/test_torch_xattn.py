"""The port's cross-attention paths against the JAX model on the same
weights: whisper-tiny's encoder-decoder (an encoder over the frontend, a
decoder that cross-attends to its output in every layer) and
llama-3.2-vision-11b's gated cross-attention layers over the frontend, at
their smoke configs.

The JAX init sets ``xgate`` to 0, so ``tanh(xgate)`` wipes the vision
layers' cross-attention, and sets whisper's qkv biases to 0: a wrong
cross-attention would pass on those weights. So every comparison first sets
``xgate`` to 0.5, fills the qkv biases with seeded normal values and scales
the cross-attention's output projection by 8 in the JAX tree (numpy
leaves), which both packages then read: at the init's scale whisper's cross
branch moves its logits by about the tolerance, after it by several times
it (``test_forward_with_frontend_matches_jax`` checks). Frontends are
seeded normal bf16 embeddings of the config's full ``n_frontend_tokens``
(the port's cache holds exactly that many cross keys). Tolerance: 2e-2 of
the largest value (bf16), as in ``test_torch_model.py``.

The JAX engine passes no frontend (``ROADMAP.md``, C12), so the port's
engine, which takes one per request, is held per request to the JAX model
prefilled alone with that request's frontend; the JAX engine is the
reference only for the vision model without any frontend.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jax_models
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke
from repro.models import layers as jax_layers
from repro.serving import Engine as JaxEngine, Request as JaxRequest
from repro_torch import models
from repro_torch.configs import ModelConfig, get_config, smoke_config
from repro_torch.models import layers as t_layers
from repro_torch.models.bridge import to_tensor
from repro_torch.models.lm import LM, layer_kinds, padded_vocab, unit_structure
from repro_torch.serving import Engine, Request
from repro_torch.serving import engine as engine_mod

TOL = 2e-2
WHISPER, LLAMA = "whisper-tiny", "llama-3.2-vision-11b"
CROSS = [WHISPER, LLAMA]
BIAS_SCALE = 0.2
XGATE = 0.5
XATTN_WO_SCALE = 8.0


def rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def t2np(t):
    return t.float().numpy()


def perturbed(tree, seed=7):
    """The JAX tree as numpy leaves with every ``xgate`` at XGATE, every
    qkv bias (bq, bk, bv) drawn N(0, BIAS_SCALE^2) in its dtype and every
    cross-attention output projection (``xattn`` ``wo``) times
    XATTN_WO_SCALE."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        key = path[-1].key
        if key == "xgate":
            return np.full_like(a, XGATE)
        if key in ("bq", "bk", "bv"):
            return (rng.standard_normal(a.shape) * BIAS_SCALE).astype(a.dtype)
        if key == "wo" and any(getattr(k, "key", None) == "xattn" for k in path):
            return (a.astype(np.float32) * XATTN_WO_SCALE).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _pair(arch, **change):
    """(jax cfg, perturbed numpy params, port model) of `arch`'s smoke config
    (with `change` to its fields) on the same weights."""
    jcfg = dataclasses.replace(jax_smoke(jax_get_config(arch)), **change)
    jparams = perturbed(jax_models.init_params(jcfg, jax.random.PRNGKey(0)))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = LM(cfg, device="cpu")
    model.load_state_dict(models.params_from_jax(cfg, jparams))
    return jcfg, jparams, model


@pytest.fixture(scope="module", params=[(WHISPER, {}), (LLAMA, {}), (LLAMA, {"n_kv_heads": 1})],
                ids=["whisper-tiny", "llama-3.2-vision-11b", "llama-3.2-vision-11b-G4"])
def pair(request):
    """The smoke configs, and llama's with 4 query heads a kv-head, the
    full config's G (on the card its decode step's cross-attention runs on
    flash, the smoke config's G = 2 on the decode op)."""
    arch, change = request.param
    return _pair(arch, **change)


def frontend(cfg, B, seed=0):
    """(B, n_frontend_tokens, d) normal embeddings, bf16 numpy."""
    x = np.random.default_rng(seed).standard_normal((B, cfg.n_frontend_tokens, cfg.d_model))
    return x.astype(jnp.bfloat16)


def tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S), dtype=np.int32)


def cross_rows(cfg, jcache):
    """The JAX cache's cross K/V of every cross-attending layer, in layer
    order as the port stacks them: {"xk": (n_cross, B, nf, Hkv*dh), "xv"}."""
    unit, n_units, rem = unit_structure(cfg)
    layers = [jcache["units"][f"u{j}"] for _ in range(n_units) for j in range(len(unit))]
    rows = [r for r in range(n_units) for _ in unit]
    out = {}
    for name in ("xk", "xv"):
        out[name] = np.stack([np.asarray(layer[name][r], np.float32)
                              for layer, r, kind in zip(layers, rows, layer_kinds(cfg))
                              if kind != "attn"])
    return out


def test_smoke_structure():
    """The two smoke configs as the JAX model groups them, and the layer
    kinds of the full configs."""
    assert layer_kinds(get_config(WHISPER)) == ["encdec"] * 4
    kinds = layer_kinds(get_config(LLAMA))
    assert [i for i, k in enumerate(kinds) if k == "xattn"] == [3, 8, 13, 18, 23, 28, 33, 38]
    assert unit_structure(get_config(LLAMA)) == (("attn", "attn", "attn", "xattn", "attn"),
                                                 8, ())
    for arch in CROSS:
        jcfg = jax_smoke(jax_get_config(arch))
        assert unit_structure(ModelConfig(**dataclasses.asdict(jcfg))) == \
            jax_models.unit_structure(jcfg)
    model = models.init_params(get_config(LLAMA), device="meta")
    assert not hasattr(model.blocks[3], "attn") and model.blocks[3].xgate.shape == (1,)
    assert model.blocks[3].xgate.dtype == torch.float32


@pytest.mark.parametrize("arch", CROSS)
def test_params_from_jax_carries_cross_and_encoder_leaves(arch):
    """``xgate`` (a leaf of the layer itself, not a group), the ``lnx`` and
    ``xattn`` groups and the encoder's stacked layers and final norm cross
    bit for bit into their port names."""
    jcfg, jparams, model = _pair(arch)
    state = model.state_dict()

    def same(got, want):
        want = np.ascontiguousarray(want)
        got = got.view(torch.int16).numpy().view(np.uint16) if got.dtype == torch.bfloat16 \
            else got.numpy()
        return np.array_equal(got, want.view(np.uint16) if want.dtype.itemsize == 2 else want)

    unit = jparams["units"]
    if arch == LLAMA:     # layers (attn, xattn): layer 1's gate and cross group
        assert state["blocks.1.xgate"].shape == (1,) and same(state["blocks.1.xgate"],
                                                              unit["u1"]["xgate"][0])
        for name, leaf in unit["u1"]["xattn"].items():
            assert same(state[f"blocks.1.xattn.{name}"], leaf[0]), name
    else:                 # (encdec,) x 2 and a 2-layer encoder
        for i in range(2):
            for group in ("lnx", "xattn"):
                for name, leaf in unit["u0"][group].items():
                    assert same(state[f"blocks.{i}.{group}.{name}"], leaf[i]), (i, group, name)
            for group, leaves in jparams["enc"]["layers"].items():
                for name, leaf in leaves.items():
                    assert same(state[f"enc.layers.{i}.{group}.{name}"], leaf[i]), (i, group)
        for name, leaf in jparams["enc"]["final_norm"].items():
            assert same(state[f"enc.final_norm.{name}"], leaf)


@pytest.mark.parametrize("arch,qk_norm", [(WHISPER, False), (LLAMA, False), (LLAMA, True)])
def test_attn_qkv_with_kv_src_matches_jax(arch, qk_norm):
    """q from x, k and v from the frontend (another length), qk-norm where
    the config sets it, no RoPE: against the JAX ``attn_qkv(kv_src=...)``."""
    jcfg = dataclasses.replace(jax_smoke(jax_get_config(arch)), qk_norm=qk_norm)
    p = jax.tree.map(np.asarray, jax_layers.attn_init(jcfg, jax.random.PRNGKey(3)))
    if qk_norm:   # norm gains off 1, so that a missing norm shows
        rng = np.random.default_rng(2)
        p["q_norm"] = (1 + rng.standard_normal(p["q_norm"].shape)).astype(np.float32)
        p["k_norm"] = (1 + rng.standard_normal(p["k_norm"].shape)).astype(np.float32)
    p = perturbed({"attn": p})["attn"]
    x = frontend(jcfg, 2, seed=4)[:, :9]
    src = frontend(jcfg, 2, seed=5)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    want = jax_layers.attn_qkv(jcfg, p, jnp.asarray(x), kv_src=jnp.asarray(src),
                               positions=pos)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    tp = {name: to_tensor(a) for name, a in p.items()}
    rope = t_layers.rope_tables(cfg, torch.from_numpy(pos))
    got = t_layers.attn_qkv(cfg, tp, to_tensor(x), rope, kv_src=to_tensor(src))
    assert [tuple(t.shape) for t in got] == [(2, 9, cfg.n_heads, cfg.d_head)] + \
        [(2, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.d_head)] * 2
    for g, w in zip(got, want):
        assert rel_err(t2np(g), w) < TOL


def test_encode_matches_jax():
    """whisper's encoder: the frontend plus its sinusoidal positions,
    non-causal layers, the final LayerNorm."""
    jcfg, jparams, model = _pair(WHISPER)
    fe = frontend(jcfg, 2)
    want = jax.jit(lambda p, f: jax_models.lm._encode(jcfg, p, f))(jparams, fe)
    got = model._encode(to_tensor(fe))
    assert got.shape == (2, jcfg.n_frontend_tokens, jcfg.d_model)
    assert rel_err(t2np(got), want) < TOL


def test_forward_with_frontend_matches_jax(pair):
    jcfg, jparams, model = pair
    toks, fe = tokens(jcfg, 2, 16), frontend(jcfg, 2)
    want, _ = jax.jit(lambda p, t, f: jax_models.forward(jcfg, p, t, frontend=f))(
        jparams, toks, fe)
    got = model(torch.from_numpy(toks), to_tensor(fe))
    V = jcfg.vocab_size
    assert got.shape == (2, 16, padded_vocab(model.cfg))
    assert rel_err(t2np(got)[..., :V], np.asarray(want, np.float32)[..., :V]) < TOL
    # the cross-attention moves the logits: another frontend, other logits
    other = model(torch.from_numpy(toks), to_tensor(frontend(jcfg, 2, seed=9)))
    assert rel_err(t2np(other)[..., :V], t2np(got)[..., :V]) > 5 * TOL


def test_prefill_and_decode_with_frontend_match_jax(pair):
    """Right-padded prompts of 12, 7 and 3 tokens with their frontends, then
    three teacher-forced decode steps: logits, the cached cross K/V and the
    self-attention K/V against the JAX serving path."""
    jcfg, jparams, model = pair
    V = jcfg.vocab_size
    toks, fe = tokens(jcfg, 3, 12), frontend(jcfg, 3)
    lens = np.array([12, 7, 3], np.int32)
    jl, jcache = jax.jit(lambda p, t, c, f, n: jax_models.prefill(
        jcfg, p, t, c, frontend=f, prompt_lens=n))(
        jparams, toks, jax_models.init_cache(jcfg, 3, 32), fe, lens)
    cache = models.init_cache(model.cfg, 3, 32, device="cpu")
    tl = model.prefill(torch.from_numpy(toks), cache, torch.from_numpy(lens), to_tensor(fe))
    assert rel_err(t2np(tl)[:, :V], np.asarray(jl, np.float32)[:, :V]) < TOL
    want = cross_rows(model.cfg, jcache)
    for name in ("xk", "xv"):
        assert cache[name].shape == want[name].shape
        assert rel_err(t2np(cache[name]), want[name]) < TOL, name
    jdecode = jax.jit(lambda p, t, c: jax_models.decode_step(jcfg, p, t, c))
    steps = tokens(jcfg, 3, 3, seed=2)
    for s in range(3):
        jl, jcache = jdecode(jparams, steps[:, s], jcache)
        tl = model.decode_step(torch.from_numpy(steps[:, s]), cache)
        assert rel_err(t2np(tl)[:, :V], np.asarray(jl, np.float32)[:, :V]) < TOL, s
    assert cache["pos"].tolist() == (lens + 3).tolist()
    jk = [np.asarray(jcache["units"][f"u{j}"]["k"], np.float32)
          for j, kind in enumerate(unit_structure(model.cfg)[0]) if kind != "xattn"]
    assert rel_err(t2np(cache["k"]), np.concatenate(jk)) < TOL


@pytest.mark.parametrize("arch,n_jax,n_config", [(WHISPER, 56_457_216, 56_377_344),
                                                  (LLAMA, 9_775_157_256, 9_775_157_256)])
def test_param_counts_at_full_size(arch, n_jax, n_config):
    """Both models at full size, shapes only (meta device; the JAX side by
    ``jax.eval_shape``, no memory): the port has exactly the JAX init's
    parameters. whisper's config accounting says 79,872 fewer: 103 padded
    vocab rows x 384 in the embedding and in the untied head (79,104) and
    the biases of the two final LayerNorms (768), which it leaves out."""
    cfg = get_config(arch)
    shapes = jax.eval_shape(lambda: jax_models.init_params(jax_get_config(arch),
                                                           jax.random.PRNGKey(0)))
    assert sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes)) == n_jax
    model = models.init_params(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert cfg.param_count() == n_config
    pad = padded_vocab(cfg) - cfg.vocab_size
    assert n_jax - n_config == (2 * pad * cfg.d_model + 2 * cfg.d_model
                                if arch == WHISPER else 0)
    if arch == WHISPER:
        assert (pad, n_jax - n_config) == (103, 79_872)


@pytest.mark.parametrize("arch,call,match", [
    (WHISPER, "prefill_without", "needs a frontend"),
    (WHISPER, "prefill_short", r"takes a frontend of \(2, 16, 128\)"),
    (WHISPER, "forward_without", "needs a frontend"),
    (LLAMA, "prefill_short", r"takes a frontend of \(2, 16, 128\)"),
    (LLAMA, "forward_without", "needs a frontend"),
    (WHISPER, "engine_without", "brings no frontend"),
])
def test_frontend_errors(arch, call, match):
    """A missing whisper frontend and a frontend of the wrong length raise
    ValueError (the port's cache holds exactly n_frontend_tokens cross
    keys); so does a vision model's forward without one, and an engine
    request to whisper without one."""
    cfg = smoke_config(get_config(arch))
    model = models.init_params(cfg, seed=0, device="cpu")
    toks = torch.zeros((2, 4), dtype=torch.int32)
    short = torch.zeros((2, cfg.n_frontend_tokens - 1, cfg.d_model), dtype=torch.bfloat16)
    cache = models.init_cache(cfg, 2, 8, device="cpu")
    with pytest.raises(ValueError, match=match):
        if call == "prefill_without":
            model.prefill(toks, cache)
        elif call == "prefill_short":
            model.prefill(toks, cache, frontend=short)
        elif call == "forward_without":
            model(toks)
        else:
            Engine(cfg, model, batch_size=2, max_len=8, device="cpu").run(
                [Request(uid=0, prompt=[1, 2], max_new_tokens=2)])


def test_vision_prefill_without_frontend_matches_jax():
    """llama's prefill with no frontend attends over zero cross K/V, as the
    JAX prefill does over a fresh cache; the port zeroes them in place, so
    a cache that held another frontend's K/V gives the same logits."""
    jcfg, jparams, model = _pair(LLAMA)
    V = jcfg.vocab_size
    toks = tokens(jcfg, 2, 10)
    jl, _ = jax.jit(lambda p, t, c: jax_models.prefill(jcfg, p, t, c))(
        jparams, toks, jax_models.init_cache(jcfg, 2, 16))
    cache = models.init_cache(model.cfg, 2, 16, device="cpu")
    model.prefill(torch.from_numpy(toks), cache, frontend=to_tensor(frontend(jcfg, 2)))
    assert cache["xk"].abs().max() > 0
    tl = model.prefill(torch.from_numpy(toks), cache)
    assert not cache["xk"].any() and not cache["xv"].any()
    assert rel_err(t2np(tl)[:, :V], np.asarray(jl, np.float32)[:, :V]) < TOL


@functools.cache
def _jax_serving(jcfg):
    """The JAX prefill (with a frontend) and decode step of `jcfg`, jitted
    once."""
    return (jax.jit(lambda p, t, c, f: jax_models.prefill(jcfg, p, t, c, frontend=f)),
            jax.jit(lambda p, t, c: jax_models.decode_step(jcfg, p, t, c)))


def _jax_alone(jcfg, jparams, prompt, fe, n, forced=None):
    """JAX greedy tokens of one request prefilled alone at batch 1 with its
    frontend (or none), n of them, or teacher-forced on `forced`; and the
    row of logits each token was sampled from."""
    prefill, decode = _jax_serving(jcfg)
    lg, cache = prefill(jparams, jnp.asarray([prompt]), jax_models.init_cache(jcfg, 1, 64),
                        None if fe is None else fe[None])
    toks, rows = [], []
    for step in range(n):
        rows.append(np.asarray(lg[0, :jcfg.vocab_size], np.float32))
        toks.append(int(rows[-1].argmax()) if forced is None else forced[step])
        if step + 1 < n:
            lg, cache = decode(jparams, jnp.asarray([toks[-1]], jnp.int32), cache)
    return toks, rows


def _forced_engine(monkeypatch, model, reqs, want):
    """Serve `reqs` on two slots of the port's engine, its sampler returning
    `want`'s tokens ({uid: tokens}); returns (engine, every row of logits
    it sampled from by (uid, step), the slot each request was admitted to)."""
    by_sampling = {id(r.sampling): r for r in reqs}
    rows, slots = {}, {}

    def forced(logits, generator, sampling):
        out = []
        for row, sp in zip(logits, sampling):
            r = by_sampling[id(sp)]
            rows[r.uid, len(r.output)] = row.float().numpy()
            out.append(want[r.uid][len(r.output)])
        return torch.tensor(out, dtype=torch.int32)

    monkeypatch.setattr(engine_mod, "sample_per_request", forced)
    eng = Engine(model.cfg, model, batch_size=2, max_len=64, device="cpu")
    admit = eng._admit_slot
    eng._admit_slot = lambda slot, r, tok: (slots.__setitem__(r.uid, slot),
                                            admit(slot, r, tok))
    done = eng.run(reqs)
    assert sorted(r.uid for r in done) == [r.uid for r in reqs]
    return eng, rows, slots


N_NEW = [3, 8, 5, 6, 4]


def _requests(jcfg, with_frontend):
    """Five requests of 3-11 tokens with budgets N_NEW, each with its own
    frontend where `with_frontend[i]` (numpy bf16, (nf, d))."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, jcfg.vocab_size, size=int(rng.integers(3, 12))).tolist()
               for _ in N_NEW]
    fes = [frontend(jcfg, 1, seed=20 + i)[0] if f else None
           for i, f in enumerate(with_frontend)]
    return prompts, fes


@pytest.mark.parametrize("arch,with_frontend", [
    (WHISPER, [True] * 5), (LLAMA, [True] * 5),
    (LLAMA, [True, False, True, True, False]),
    (LLAMA, [False, True, False, True, False])])
def test_engine_matches_jax_per_request(monkeypatch, arch, with_frontend):
    """Five requests, each with its own frontend (llama: also some without,
    in the wave, where the frontend's zero rows must give zero cross K/V,
    and in refills), on two slots: one wave prefill, three refills. The port's engine is
    teacher-forced on the JAX model's greedy tokens for each request alone
    with its frontend, and every row of logits it sampled from, in its
    batched wave and refill schedule, is held to the JAX model's row for
    that request and step. A slot that kept another request's cross K/V, or
    a frontend handed to another slot, moves these rows past the
    tolerance."""
    jcfg, jparams, model = _pair(arch)
    prompts, fes = _requests(jcfg, with_frontend)
    want, jrows = {}, {}
    for uid, (p, fe, n) in enumerate(zip(prompts, fes, N_NEW)):
        want[uid], jrows[uid] = _jax_alone(jcfg, jparams, p, fe, n)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n,
                    frontend=None if fe is None else to_tensor(fe))
            for i, (p, fe, n) in enumerate(zip(prompts, fes, N_NEW))]
    eng, rows, slots = _forced_engine(monkeypatch, model, reqs, want)
    assert len(rows) == sum(N_NEW)
    for (uid, step), row in rows.items():
        assert rel_err(row[:jcfg.vocab_size], jrows[uid][step]) < TOL, (uid, step)
    assert {r.uid: r.output for r in reqs} == want


def test_refilled_slot_never_keeps_a_previous_requests_cross_kv(monkeypatch):
    """llama on two slots: a wave of a request with a frontend and one
    without, then refills with and without, so a slot is refilled after a
    request with a frontend by one without and by one with another. At the
    end each slot's cross K/V are its last request's own (a batch-1
    prefill of that request), or zero where it brought none."""
    jcfg, jparams, model = _pair(LLAMA)
    prompts, fes = _requests(jcfg, [True, False, False, True, True])
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n,
                    frontend=None if fe is None else to_tensor(fe))
            for i, (p, fe, n) in enumerate(zip(prompts, fes, N_NEW))]
    want = {i: [1] * n for i, n in enumerate(N_NEW)}
    eng, _, slots = _forced_engine(monkeypatch, model, reqs, want)
    last = {slot: uid for uid, slot in sorted(slots.items())}
    assert sorted(last) == [0, 1] and set(slots.values()) == {0, 1}
    for slot, uid in last.items():
        one = models.init_cache(model.cfg, 1, 64, device="cpu")
        fe = reqs[uid].frontend
        model.prefill(torch.tensor([prompts[uid]], dtype=torch.int32), one,
                      frontend=None if fe is None else fe[None])
        for name in ("xk", "xv"):
            assert torch.equal(eng.cache[name][:, slot], one[name][:, 0]), (slot, uid, name)
        assert bool(eng.cache["xk"][:, slot].any()) == (fe is not None)


def test_vision_engine_without_frontend_matches_jax_engine(monkeypatch):
    """llama with no frontend at all: the JAX engine is the reference (it
    passes none). The port's engine is teacher-forced on the JAX engine's
    tokens; its rows, counters, positions and final caches (K/V and the
    zero cross K/V) against the JAX engine's."""
    jcfg, jparams, model = _pair(LLAMA)
    prompts, _ = _requests(jcfg, [False] * 5)
    jeng = JaxEngine(jcfg, jparams, batch_size=2, max_len=64)
    jdone = jeng.run([JaxRequest(uid=i, prompt=p, max_new_tokens=n)
                      for i, (p, n) in enumerate(zip(prompts, N_NEW))])
    want = {r.uid: r.output for r in jdone}
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, N_NEW))]
    eng, rows, _ = _forced_engine(monkeypatch, model, reqs, want)
    for uid, p in enumerate(prompts):
        _, jrows = _jax_alone(jcfg, jparams, p, None, len(want[uid]), forced=want[uid])
        for step, jrow in enumerate(jrows):
            assert rel_err(rows[uid, step][:jcfg.vocab_size], jrow) < TOL, (uid, step)
    assert eng.stats["tokens_out"] == jeng.stats["tokens_out"] == sum(N_NEW)
    assert eng.stats["steps"] == jeng.stats["steps"]
    assert eng.cache["pos"].tolist() == np.asarray(jeng.cache["pos"]).tolist()
    jx = cross_rows(model.cfg, jeng.cache)
    assert not eng.cache["xk"].any() and not jx["xk"].any()
    jk = np.asarray(jeng.cache["units"]["u0"]["k"], np.float32)
    assert rel_err(t2np(eng.cache["k"]), jk) < TOL
