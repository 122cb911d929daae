"""Training the configs that LayerNorm, GELU, the MoE aux loss and a
frontend open: granite-moe-3b-a800m, stablelm-1.6b, gpt3-175b, whisper-tiny
and llama-3.2-vision-11b, against the JAX package on the CPU at their smoke
configs, on the same numpy inputs and weights (JAX's ``init_params``
carried over by ``params_from_jax``).

llama-3.2-vision's ``xgate`` is set to 0.5 in the JAX tree before it
crosses: at the init's 0 the gate wipes the cross-attention, and every
gradient behind it would be 0 on both sides. Frontends are seeded normal
bf16 embeddings of the config's ``n_frontend_tokens``.

granite routes each token to its top-k experts, a discrete choice that a
rounding elsewhere can flip at a near-tie (``tests/_torch_routing.py``), so
the JAX routing is recorded and replayed in the port. The JAX loss
rematerialises each unit in its backward, so its forward's records come
first and the rematerialised ones after them, in reverse layer order: the
first ``n_layers`` of each microbatch are replayed and the others must
repeat them.

Tolerances, as in ``test_torch_training.py``: the loss, each of its parts
and each gradient leaf within 2e-2 (relative Frobenius for a leaf); the
plain backward versions within 2e-2 (bf16) and 2e-5 (fp32) of ``jax.vjp``
of the JAX kernel references, relative to the largest gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import models as jax_models
from repro import training as jt
from repro.configs import get_config as jax_get_config, smoke_config as jax_smoke
from repro.kernels.gelu.ref import gelu_ref as jax_gelu_ref
from repro.kernels.rmsnorm.ref import layernorm_ref as jax_layernorm_ref
from repro.models import layers as jax_layers
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.gelu.ref import gelu_bwd_ref, gelu_mul_bwd_ref
from repro_torch.kernels.rmsnorm.ref import layernorm_bwd_ref
from repro_torch.models.bridge import decayed_leaves, params_from_jax, to_tensor
from repro_torch.models.lm import LM, check_trainable, loss_fn, needs_frontend
from repro_torch import training as tt

from _torch_routing import replay_routing, routing_flips

OPENED = ["granite-moe-3b-a800m", "stablelm-1.6b", "gpt3-175b", "whisper-tiny",
          "llama-3.2-vision-11b", "recurrentgemma-2b", "grok-1-314b", "rwkv6-7b"]
# the configs whose loss and gradients this file holds to JAX; those of
# recurrentgemma-2b and grok-1-314b are held in test_torch_train_hybrid.py,
# at a length their window cuts, and rwkv6-7b's in test_torch_train_rwkv.py,
# its decays unhidden
GRADIENTS_HERE = OPENED[:5]
XGATE = 0.5
TOL = 2e-2


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def t2np(t):
    return t.detach().float().numpy()


def jnp2np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def opened_gate(tree):
    """The JAX tree as numpy leaves, every ``xgate`` at XGATE."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.full_like(np.asarray(a), XGATE) if path[-1].key == "xgate"
        else np.asarray(a), tree)


def jax_case(arch, seed=1):
    """(JAX config, JAX params, port config, trainable port model holding
    them)."""
    jcfg = jax_smoke(jax_get_config(arch))
    jparams = jax.tree.map(jnp.asarray, opened_gate(
        jax_models.init_params(jcfg, jax.random.PRNGKey(seed))))
    cfg = smoke_config(get_config(arch))
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, cfg, model.requires_grad_(True)


def grads_by_name(cfg, jgrads):
    """JAX gradients (a parameter tree) as fp32 numpy arrays keyed by the
    port's parameter names."""
    tree = jax.tree.map(lambda g: np.asarray(g, np.float32), jgrads)
    return {n: t.numpy() for n, t in params_from_jax(cfg, tree).items()}


def batch(cfg, B, S, seed):
    """(tokens, targets, mask, frontend or None) as numpy arrays."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    fe = None
    if needs_frontend(cfg):
        fe = np.asarray(jnp.asarray(rng.standard_normal((B, cfg.n_frontend_tokens, cfg.d_model)),
                                    jnp.bfloat16))
    return tok[:, :-1], tok[:, 1:], mask, fe


def record_jax_routing(monkeypatch):
    """Wrap the JAX ``moe_apply`` so that every call, its rematerialised
    ones too, appends (idx, fp32 router logits) as numpy arrays, in call
    order, to the list returned."""
    records, moe_apply = [], jax_layers.moe_apply

    def wrapped(cfg, p, x, capacity_factor=1.25):
        logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p["router"]
        _, idx = lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
        jax.debug.callback(lambda i, lg: records.append((np.asarray(i), np.asarray(lg))),
                           idx, logits, ordered=True)
        return moe_apply(cfg, p, x, capacity_factor)

    monkeypatch.setattr(jax_layers, "moe_apply", wrapped)
    return records


def forward_records(records, n_layers, microbatches=1):
    """The records of each microbatch's forward: of its 2 n_layers calls,
    the first n_layers; the rematerialised ones must repeat them in reverse."""
    jax.effects_barrier()
    assert len(records) == 2 * n_layers * microbatches
    out = []
    for m in range(microbatches):
        calls = records[2 * n_layers * m: 2 * n_layers * (m + 1)]
        fwd, again = calls[:n_layers], calls[n_layers:][::-1]
        assert all(np.array_equal(a[0], b[0]) for a, b in zip(fwd, again))
        out += fwd
    return out


# ---------------- loss, aux and gradients ----------------

@pytest.mark.parametrize("arch", GRADIENTS_HERE)
def test_loss_aux_and_every_gradient_match_jax(monkeypatch, arch):
    """The loss, each of its parts (granite's aux among them, nonzero) and
    every leaf's gradient, the router's, the experts', the LayerNorm biases',
    the encoder's and the cross layers' (xgate too) included."""
    jcfg, jparams, cfg, model = jax_case(arch)
    tokens, targets, mask, fe = batch(cfg, 2, 16, 3)
    records = record_jax_routing(monkeypatch) if cfg.n_experts else None

    def jloss(p):
        return jax_models.loss_fn(jcfg, p, jnp.asarray(tokens), jnp.asarray(targets),
                                  mask=jnp.asarray(mask),
                                  frontend=None if fe is None else jnp.asarray(fe))

    (jtotal, jmet), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    own = []
    if records is not None:
        replay_routing(monkeypatch, forward_records(records, cfg.n_layers), own)
    total, met = loss_fn(model, torch.from_numpy(tokens), torch.from_numpy(targets),
                         mask=torch.from_numpy(mask),
                         frontend=None if fe is None else to_tensor(fe))
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
    assert abs(float(total.detach()) - float(jtotal)) < TOL
    for k in ("ce", "z_loss", "aux", "tokens"):
        got = float(met[k].detach())
        assert abs(got - float(jmet[k])) < TOL * max(1.0, abs(float(jmet[k]))), k
    assert (float(jmet["aux"]) > 0) == bool(cfg.n_experts)
    want = grads_by_name(cfg, jgrads)
    assert set(want) == set(grads)
    for n, g in grads.items():
        assert g.dtype == params[n].dtype, n
        if n.endswith(".bk"):
            # 0 in exact arithmetic: a key bias shifts all of a row's scores
            # alike, which the softmax ignores; both sides keep roundings
            scale = np.linalg.norm(want[n[:-1] + "q"])
            assert max(np.linalg.norm(t2np(g)), np.linalg.norm(want[n])) < TOL * scale, n
            continue
        assert np.linalg.norm(want[n]) > 0, n
        assert rel_fro(t2np(g), want[n]) < TOL, (n, rel_fro(t2np(g), want[n]))
    if records is not None:
        assert routing_flips(cfg.top_k, forward_records(records, cfg.n_layers), own)[1] == 0


def test_serving_computes_no_aux(monkeypatch):
    """granite's prefill and decode step call the MoE layer without its aux
    loss, and give the same logits as before."""
    from repro_torch.models import init_cache, init_params, layers
    cfg = smoke_config(get_config("granite-moe-3b-a800m"))
    model = init_params(cfg, seed=0, device="cpu")
    flags, moe_apply = [], layers.moe_apply

    def spy(cfg, p, x, capacity_factor=1.25, with_aux=True):
        flags.append(with_aux)
        return moe_apply(cfg, p, x, capacity_factor, with_aux)

    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)))
    cache = init_cache(cfg, 2, 16, device="cpu")
    want = model.prefill(tok, cache)
    monkeypatch.setattr(layers, "moe_apply", spy)
    cache = init_cache(cfg, 2, 16, device="cpu")
    got = model.prefill(tok, cache)
    model.decode_step(tok[:, 0], cache)
    assert torch.equal(got, want)
    assert flags == [False] * (2 * cfg.n_layers)
    y, aux = moe_apply(cfg, model.blocks[0].moe, torch.zeros((1, 4, cfg.d_model),
                                                             dtype=torch.bfloat16),
                       with_aux=False)
    assert aux is None and y.shape == (1, 4, cfg.d_model)


# ---------------- plain backward versions against jax.vjp ----------------

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def both(seed, shape, dtype, scale=1.0, shift=0.0):
    jdt, tdt, _ = DTYPES[dtype]
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale + shift
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("r,c", [(64, 256), (100, 384), (7, 2100)])
def test_layernorm_bwd_plain_matches_jax_vjp(r, c, dtype):
    """dx, dg and db, rows off zero mean (the centring counts)."""
    jx, x = both(4, (r, c), dtype, 3.0, 1.5)
    rng = np.random.default_rng(5)
    g, b = (rng.standard_normal(c).astype(np.float32) for _ in range(2))
    jdy, dy = both(6, (r, c), dtype)
    _, vjp = jax.vjp(jax_layernorm_ref, jx, jnp.asarray(g), jnp.asarray(b))
    want = vjp(jdy)
    got = layernorm_bwd_ref(x, torch.from_numpy(g), dy)
    assert got[0].dtype == x.dtype and got[1].dtype == got[2].dtype == torch.float32
    for a, w in zip(got, want):
        assert rel_max(t2np(a), jnp2np(w)) < DTYPES[dtype][2]


def with_tails(x):
    """x with its first elements where gelu' saturates (JAX's own gelu'
    turns NaN where x^3 overflows fp32, so no further)."""
    flat = np.asarray(x, np.float32).reshape(-1).copy()
    flat[:6] = [-1e4, -30.0, -9.5, 9.5, 30.0, 1e4]
    return flat.reshape(np.shape(x))


def test_gelu_grad_plain_saturates_where_x_cubed_overflows():
    """Past |x| = 20 gelu' is exactly 0 and 1 in fp32, also where x^3
    overflows; a NaN stays NaN."""
    x = torch.tensor([-1e30, -1e20, -20.0, 20.0, 1e20, 1e30, float("nan")])
    dy = torch.ones_like(x)
    got = gelu_bwd_ref(x, dy)
    assert got[:6].tolist() == [0.0, 0.0, 0.0, 1.0, 1.0, 1.0] and got[6].isnan()
    dg, du = gelu_mul_bwd_ref(x[:6], dy[:6] * 2, dy[:6])
    assert dg.tolist() == [0.0, 0.0, 0.0, 2.0, 2.0, 2.0]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gelu_bwd_plain_matches_jax_vjp(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x = with_tails(np.random.default_rng(7).standard_normal((100, 256)) * 3)
    jdy, dy = both(8, (100, 256), dtype)
    _, vjp = jax.vjp(jax_gelu_ref, jnp.asarray(x, jdt))
    want, = vjp(jdy)
    got = gelu_bwd_ref(torch.from_numpy(x).to(tdt), dy)
    assert got.dtype == tdt and torch.isfinite(got).all()
    assert rel_max(t2np(got), jnp2np(want)) < tol


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gelu_mul_bwd_plain_matches_jax_vjp(dtype):
    """Against jax.vjp of the JAX model's gated GELU, ``jax.nn.gelu(g,
    approximate=True) * u``, in fp32 and rounded once."""
    jdt, tdt, tol = DTYPES[dtype]
    g = with_tails(np.random.default_rng(9).standard_normal((100, 256)) * 3)
    ju, u = both(10, (100, 256), dtype)
    jdy, dy = both(11, (100, 256), dtype)

    def jax_gelu_mul(a, b):
        return (jax.nn.gelu(a.astype(jnp.float32), approximate=True)
                * b.astype(jnp.float32)).astype(a.dtype)

    _, vjp = jax.vjp(jax_gelu_mul, jnp.asarray(g, jdt), ju)
    want = vjp(jdy)
    got = gelu_mul_bwd_ref(torch.from_numpy(g).to(tdt), u, dy)
    for a, w in zip(got, want):
        assert a.dtype == tdt and torch.isfinite(a).all()
        assert rel_max(t2np(a), jnp2np(w)) < tol


# ---------------- AdamW's decayed leaves ----------------

@pytest.mark.parametrize("arch", OPENED)
def test_decayed_leaves_are_jax_ones(arch):
    """ROADMAP C14: the leaves the JAX AdamW decays (ndim >= 2 on its
    stacked tree): every leaf of a stacked layer, the LayerNorm biases, the
    experts, the router, the encoder's and the cross layers' (xgate), and
    RWKV6's 1-D w0, u and ln_x (its layers are units of one) among them;
    not the final norm's."""
    jcfg, jparams, cfg, model = jax_case(arch)
    flags = jax.tree.map(lambda p: np.full(p.shape, p.ndim >= 2), jparams)
    want = {n for n, t in params_from_jax(cfg, flags).items() if bool(t.all())}
    got = decayed_leaves(cfg, dict(model.named_parameters()))
    assert got == want
    assert not any(n.startswith("final_norm.") for n in got)
    must = {"granite-moe-3b-a800m": ("blocks.0.moe.router", "blocks.0.moe.w_up"),
            "stablelm-1.6b": ("blocks.0.ln1.bias",),
            "gpt3-175b": ("blocks.0.ln2.bias", "blocks.0.attn.bq"),
            "whisper-tiny": ("enc.layers.0.ln1.bias", "blocks.0.xattn.wk"),
            "llama-3.2-vision-11b": ("blocks.1.xgate", "blocks.1.xattn.wq"),
            "recurrentgemma-2b": ("blocks.0.rec.lam", "blocks.0.rec.conv_b", "blocks.2.attn.wq"),
            "grok-1-314b": ("blocks.0.moe.router", "blocks.0.moe.w_gate"),
            "rwkv6-7b": ("blocks.0.tmix.w0", "blocks.1.tmix.u", "blocks.0.tmix.ln_x",
                         "blocks.1.ln1.scale", "blocks.0.ln2.bias")}[arch]
    assert set(must) <= got


# ---------------- the train step ----------------

@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-11b",
                                  "granite-moe-3b-a800m"])
def test_two_microbatch_step_matches_jax(monkeypatch, arch):
    """make_train_step(..., microbatches=2, has_frontend=...) against the
    JAX step: the frontend split with the tokens, granite's capacity taken
    per microbatch (its JAX routing replayed); two steps, so the second
    runs on the updated weights: mean loss, global gradient norm, metric
    set."""
    jcfg, jparams, cfg, model = jax_case(arch)
    jopt = jt.AdamW(lr=jt.constant_schedule(1e-3))
    opt = tt.AdamW(lr=tt.constant_schedule(1e-3))
    jstate = jt.TrainState(jparams, jopt.init(jparams))
    state = tt.TrainState(model, opt.init(dict(model.named_parameters())))
    front = needs_frontend(cfg)
    jstep = jax.jit(jt.make_train_step(jcfg, jopt, microbatches=2, has_frontend=front))
    step = tt.make_train_step(cfg, opt, microbatches=2, has_frontend=front)
    records = record_jax_routing(monkeypatch) if cfg.n_experts else None
    for seed in (4, 5):
        tokens, targets, mask, fe = batch(cfg, 2, 12, seed)
        jb = {"tokens": tokens, "targets": targets, "mask": mask}
        if front:
            jb["frontend"] = fe
        if records is not None:
            records.clear()
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in jb.items()})
        with monkeypatch.context() as m:
            if records is not None:
                calls = replay_routing(m, forward_records(records, cfg.n_layers, 2))
            state, met = step(state, {k: to_tensor(v) for k, v in jb.items()})
            if records is not None:
                assert next(calls, None) is None
        assert set(met) == set(jmet) == {"loss", "grad_norm", "lr"}
        assert abs(float(met["loss"]) - float(jmet["loss"])) < TOL
        assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=TOL)


@pytest.mark.parametrize("arch", OPENED)
def test_full_configs_are_trainable(arch):
    check_trainable(get_config(arch))
    check_trainable(smoke_config(get_config(arch)))


def test_frontend_is_read_only_with_has_frontend():
    """A batch's frontend reaches the model only where the step was made
    with has_frontend, as in the JAX step; without it a vision model's
    forward refuses to run with no frontend."""
    cfg = smoke_config(get_config("llama-3.2-vision-11b"))
    opt = tt.AdamW(lr=tt.constant_schedule(1e-3))
    state = tt.init_state(cfg, opt, 0, "cpu")
    tokens, targets, _, fe = batch(cfg, 2, 8, 6)
    b = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets),
         "frontend": to_tensor(fe)}
    state, met = tt.make_train_step(cfg, opt, has_frontend=True)(state, b)
    assert torch.isfinite(met["loss"])
    with pytest.raises(ValueError, match="needs a frontend"):
        tt.make_train_step(cfg, opt)(state, b)
    assert not needs_frontend(smoke_config(get_config("gpt3-175b")))
