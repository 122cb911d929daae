"""The port's training path (``repro_torch.training``, ``models.lm.loss_fn``,
``data``, the backward ops and ``launch.train``) against the JAX package on
the CPU, at smoke size, on the same numpy inputs and weights (JAX's
``init_params`` carried over by ``params_from_jax``).

Tolerances: the loss within 2e-2 and each gradient leaf within 2e-2
relative Frobenius norm (both sides run bf16 activations and round in
different places); AdamW on identical fp32 gradients to 2e-5 per leaf
(fp32 throughout, sums in another order); the plain backward versions
within 2e-2 (bf16) and 2e-5 (fp32) of ``jax.vjp`` of the JAX kernel
references, relative to the largest gradient; int8 compression and the
data pipeline exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jax_models
from repro.configs import ARCHS as JAX_ARCHS, smoke_config as jax_smoke
from repro.data import DataConfig as JaxDataConfig, TokenPipeline as JaxPipeline
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.gelu.ref import silu_mul_ref as jax_silu_mul_ref
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro import training as jt
from repro_torch import models
from repro_torch.configs import ARCHS, EXTRA_ARCHS, get_config, smoke_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref, attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.gelu.ref import silu_mul_bwd_ref
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref
from repro_torch.launch import train as train_launcher
from repro_torch.models.bridge import decayed_leaves, params_from_jax, to_tensor
from repro_torch.models.lm import LM, check_trainable, loss_fn
from repro_torch import training as tt

TRAINABLE = ("qwen1.5-0.5b", "qwen2-0.5b", "qwen3-1.7b")


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


def jax_case(arch, seed=1):
    """(JAX config, JAX params, port config, port model holding them)."""
    jcfg = jax_smoke(JAX_ARCHS[arch])
    jparams = jax_models.init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = smoke_config(get_config(arch))
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, cfg, model.requires_grad_(True)


def grads_by_name(cfg, jgrads):
    """JAX gradients (a parameter tree) as fp32 numpy arrays keyed by the
    port's parameter names."""
    tree = jax.tree.map(lambda g: np.asarray(g, np.float32), jgrads)
    return {n: t.numpy() for n, t in params_from_jax(cfg, tree).items()}


def batch(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, size=(B, S + 1)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    return tok[:, :-1], tok[:, 1:], mask


# ---------------- loss and gradients ----------------

@pytest.mark.parametrize("arch", TRAINABLE)
def test_loss_and_every_gradient_match_jax(arch):
    """qwen1.5 (MHA, qkv bias), qwen2 (GQA 2:1 here, qkv bias), qwen3
    (qk-norm): the loss, its parts, and every leaf's gradient."""
    jcfg, jparams, cfg, model = jax_case(arch)
    tokens, targets, mask = batch(cfg.vocab_size, 2, 24, 3)

    def jloss(p):
        return jax_models.loss_fn(jcfg, p, jnp.asarray(tokens), jnp.asarray(targets),
                                  mask=jnp.asarray(mask))

    (jtotal, jmet), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    total, met = loss_fn(model, torch.from_numpy(tokens), torch.from_numpy(targets),
                         mask=torch.from_numpy(mask))
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
    assert abs(float(total.detach()) - float(jtotal)) < 2e-2
    for k in ("ce", "z_loss", "aux", "tokens"):
        got = float(met[k].detach())
        assert abs(got - float(jmet[k])) < 2e-2 * max(1.0, abs(float(jmet[k]))), k
    want = grads_by_name(cfg, jgrads)
    assert set(want) == set(grads)
    for n, g in grads.items():
        assert g.dtype == params[n].dtype, n
        assert rel_fro(t2np(g), want[n]) < 2e-2, (n, rel_fro(t2np(g), want[n]))


# ---------------- AdamW, schedules, clipping ----------------

def jax_decayed(cfg, jparams):
    """The port's names of the leaves the JAX AdamW decays (its ndim >= 2
    test on its own, stacked tree)."""
    flags = jax.tree.map(lambda p: np.full(p.shape, p.ndim >= 2), jparams)
    return {n for n, t in params_from_jax(cfg, flags).items() if bool(t.all())}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen3-1.7b"])
def test_adamw_update_matches_jax_and_decays_jax_leaves(arch):
    """Three updates on identical fp32 gradients (one clipped) with weight
    decay on: every master leaf and every cast parameter within 2e-5; the
    decayed set is JAX's (ROADMAP C14: every stacked leaf, norm scales and
    qkv biases included, not the final norm)."""
    jcfg, jparams, cfg, model = jax_case(arch)
    params = dict(model.named_parameters())
    assert decayed_leaves(cfg, params) == jax_decayed(cfg, jparams)
    assert "final_norm.scale" not in decayed_leaves(cfg, params)
    assert "blocks.0.ln1.scale" in decayed_leaves(cfg, params)
    jopt = jt.AdamW(lr=jt.constant_schedule(1e-2), weight_decay=0.1)
    opt = tt.AdamW(lr=tt.constant_schedule(1e-2), weight_decay=0.1)
    jst, st = jopt.init(jparams), opt.init(params)
    rng = np.random.default_rng(7)
    for i, gscale in enumerate((1e-3, 5.0, 1e-2)):    # the second is clipped
        jg = jax.tree.map(lambda p: jnp.asarray(
            rng.standard_normal(p.shape).astype(np.float32) * gscale), jparams)
        jparams, jst, jstats = jopt.update(jg, jst, jparams)
        st, stats = opt.update({n: torch.from_numpy(g) for n, g in
                                grads_by_name(cfg, jg).items()}, st, params,
                               decayed_leaves(cfg, params))
        assert float(stats["grad_norm"]) == pytest.approx(float(jstats["grad_norm"]), rel=2e-5)
        assert float(stats["lr"]) == float(jstats["lr"])
    assert int(st.step) == int(jst.step) == 3
    for tree, got in ((jst.master, st.master), (jst.m, st.m), (jst.v, st.v)):
        want = grads_by_name(cfg, tree)
        for n, t in got.items():
            assert t.dtype == torch.float32
            assert rel_max(t2np(t), want[n]) < 2e-5, n
    # each parameter is its master cast to its dtype; masters 2e-5 apart can
    # round to neighbouring bf16 values, so the casts are held to one bf16
    # rounding (2^-7 of the largest) of JAX's
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
    for n, p in params.items():
        assert p.dtype == want[n].dtype
        assert torch.equal(p.detach(), st.master[n].to(p.dtype)), n
        assert rel_max(t2np(p), t2np(want[n])) < (2e-5 if p.dtype == torch.float32
                                                  else 2.0 ** -7), n


def test_cosine_and_constant_schedules_match_jax():
    jlr, lr = jt.cosine_schedule(1e-3, 10, 100), tt.cosine_schedule(1e-3, 10, 100)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        assert float(lr(torch.tensor(s, dtype=torch.int32))) == pytest.approx(
            float(jlr(jnp.asarray(s, jnp.int32))), rel=1e-6, abs=1e-12)
    assert float(tt.constant_schedule(3e-4)(torch.tensor(5))) == float(
        jt.constant_schedule(3e-4)(jnp.asarray(5)))


def test_clipping_matches_jax():
    """The global norm (with its + 1e-20) and the clipped update."""
    jopt = jt.AdamW(lr=jt.constant_schedule(1e-3), clip_norm=1.0)
    opt = tt.AdamW(lr=tt.constant_schedule(1e-3), clip_norm=1.0)
    g = {"a": np.full((4,), 100.0, np.float32), "b": np.arange(6, dtype=np.float32).reshape(2, 3)}
    jp = {k: jnp.zeros(v.shape) for k, v in g.items()}
    p = {k: torch.zeros(v.shape) for k, v in g.items()}
    jp, jst, jstats = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jopt.init(jp), jp)
    st, stats = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, opt.init(p), p,
                           {"b"})       # the JAX rule: ndim >= 2
    assert float(stats["grad_norm"]) == pytest.approx(float(jstats["grad_norm"]), rel=1e-6)
    for k in g:
        np.testing.assert_allclose(t2np(st.master[k]), np.asarray(jst.master[k]), rtol=2e-5)
    zero = {"a": torch.zeros(4)}
    _, stats = opt.update(zero, opt.init(zero), zero, set())
    assert float(stats["grad_norm"]) == pytest.approx(1e-10, rel=1e-3)


# ---------------- the train step ----------------

def jax_and_port_states(arch, opt_args):
    jcfg, jparams, cfg, model = jax_case(arch)
    jopt = jt.AdamW(lr=jt.constant_schedule(1e-3), **opt_args)
    opt = tt.AdamW(lr=tt.constant_schedule(1e-3), **opt_args)
    jstate = jt.TrainState(jparams, jopt.init(jparams))
    state = tt.TrainState(model, opt.init(dict(model.named_parameters())))
    return jcfg, jopt, jstate, cfg, opt, state


def test_two_microbatch_step_matches_jax():
    """make_train_step(..., microbatches=2) on one device (no mesh, so C3
    does not apply): the mean loss, the global norm of the mean gradient,
    the metric set, and the loss of the next step after the update."""
    jcfg, jopt, jstate, cfg, opt, state = jax_and_port_states("qwen2-0.5b", {})
    jstep = jax.jit(jt.make_train_step(jcfg, jopt, microbatches=2))
    step = tt.make_train_step(cfg, opt, microbatches=2)
    for seed in (4, 5):
        tokens, targets, mask = batch(cfg.vocab_size, 4, 16, seed)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(tokens),
                                      "targets": jnp.asarray(targets),
                                      "mask": jnp.asarray(mask)})
        state, met = step(state, {"tokens": torch.from_numpy(tokens),
                                  "targets": torch.from_numpy(targets),
                                  "mask": torch.from_numpy(mask)})
        assert set(met) == set(jmet) == {"loss", "grad_norm", "lr"}
        assert abs(float(met["loss"]) - float(jmet["loss"])) < 2e-2
        assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=2e-2)


def test_one_microbatch_step_reports_jax_metrics():
    jcfg, jopt, jstate, cfg, opt, state = jax_and_port_states("qwen3-1.7b", {})
    tokens, targets, mask = batch(cfg.vocab_size, 2, 16, 6)
    jstate, jmet = jax.jit(jt.make_train_step(jcfg, jopt))(
        jstate, {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)})
    state, met = tt.make_train_step(cfg, opt)(
        state, {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)})
    assert set(met) == set(jmet) == {"loss", "grad_norm", "lr", "ce", "z_loss", "aux", "tokens"}
    for k in met:
        assert abs(float(met[k]) - float(jmet[k])) < 2e-2 * max(1.0, abs(float(jmet[k]))), k


def test_int8_compression_equals_jax():
    rng = np.random.default_rng(0)
    g = {"a": rng.standard_normal((33, 7)).astype(np.float32) * 3,
         "b": np.zeros((5,), np.float32),
         "c": (rng.standard_normal((64,)) * 0.01).astype(np.float32)}
    for k, x in g.items():
        jq, js = jt.compress_int8(jnp.asarray(x))
        q, s = tt.compress_int8(torch.from_numpy(x))
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq)), k
        assert float(s) == float(js), k
        assert np.array_equal(t2np(tt.decompress_int8(q, s)),
                              np.asarray(jt.decompress_int8(jq, js))), k
    jbf = {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}
    bf = {k: to_tensor(np.asarray(v)) for k, v in jbf.items()}
    jdeq, jres = jt.compress_grads(jbf)
    deq, res = tt.compress_grads(bf)
    jdeq2, jres2 = jt.compress_grads(jbf, jres)
    deq2, res2 = tt.compress_grads(bf, res)
    for k in g:
        for a, b in ((deq[k], jdeq[k]), (deq2[k], jdeq2[k])):
            assert a.dtype == torch.bfloat16 and np.array_equal(t2np(a), jnp2np(b)), k
        for a, b in ((res[k], jres[k]), (res2[k], jres2[k])):
            assert np.array_equal(t2np(a), np.asarray(b)), k


# ---------------- data pipeline ----------------

def assert_same_batches(cfg_args, steps=(0, 1, 7, 123)):
    ours, theirs = TokenPipeline(DataConfig(**cfg_args)), JaxPipeline(JaxDataConfig(**cfg_args))
    for s in steps:
        a, b = ours.batch_at(s), theirs.batch_at(s)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (s, k)


@pytest.mark.parametrize("host_count", [1, 2, 4])
def test_synthetic_batches_equal_jax(host_count):
    for h in range(host_count):
        assert_same_batches(dict(vocab_size=512, seq_len=16, global_batch=8, seed=3,
                                 host_index=h, host_count=host_count))


def test_memmap_batches_equal_jax(tmp_path):
    path = tmp_path / "tokens.u32"
    np.random.default_rng(0).integers(0, 1000, 5000, dtype=np.uint32).tofile(path)
    for h in range(2):
        assert_same_batches(dict(vocab_size=1000, seq_len=32, global_batch=4, seed=1,
                                 token_file=str(path), host_index=h, host_count=2))


def test_pipeline_refuses_an_uneven_host_split():
    with pytest.raises(ValueError, match="does not split"):
        TokenPipeline(DataConfig(512, 16, 6, host_count=4))


# ---------------- plain backward versions against jax.vjp ----------------

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def both(seed, shape, dtype, scale=1.0):
    jdt, tdt, _ = DTYPES[dtype]
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


ATTENTION_BWD_CASES = [
    (4, 4, 40, 32, True, 0, 0.0), (4, 2, 33, 64, True, 0, 0.0), (6, 2, 20, 64, False, 0, 0.0),
    (4, 1, 48, 32, True, 8, 0.0), (2, 2, 24, 32, True, 0, 5.0)]


def check_attention_bwd_against_jax_vjp(hq, hkv, s, d, causal, window, cap, dtype, given_lse):
    jq, q = both(0, (2, hq, s, d), dtype)
    jk, k = both(1, (2, hkv, s, d), dtype)
    jv, v = both(2, (2, hkv, s, d), dtype)
    jdo, do = both(3, (2, hq, s, d), dtype)
    kw = dict(causal=causal, window=window, softcap=cap)
    _, vjp = jax.vjp(lambda a, b, c: jax_attention_ref(a, b, c, **kw), jq, jk, jv)
    want = vjp(jdo)
    lse = attention_lse_ref(q, k, **kw) if given_lse else None
    got = attention_bwd_ref(q, k, v, attention_ref(q, k, v, **kw), do, lse, **kw)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert rel_max(t2np(g), jnp2np(w)) < DTYPES[dtype][2]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv,s,d,causal,window,cap", ATTENTION_BWD_CASES)
def test_attention_bwd_plain_matches_jax_vjp(hq, hkv, s, d, causal, window, cap, dtype):
    check_attention_bwd_against_jax_vjp(hq, hkv, s, d, causal, window, cap, dtype, False)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv,s,d,causal,window,cap", ATTENTION_BWD_CASES)
def test_attention_bwd_plain_given_lse_matches_jax_vjp(hq, hkv, s, d, causal, window, cap,
                                                        dtype):
    """The plain backward given the rows' log-sum-exp (P = exp(s - L), as
    the wgmma backward kernel takes it from the forward) at the same cases
    and tolerances as without it."""
    check_attention_bwd_against_jax_vjp(hq, hkv, s, d, causal, window, cap, dtype, True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv,sq,sk,causal,window,cap", [
    (4, 2, 40, 40, True, 0, 0.0), (4, 2, 40, 40, False, 0, 0.0), (6, 2, 33, 33, True, 0, 0.0),
    (4, 4, 20, 45, False, 0, 0.0), (4, 1, 48, 48, True, 8, 0.0), (2, 2, 24, 24, True, 0, 5.0)])
def test_attention_lse_ref_matches_jax_logsumexp(hq, hkv, sq, sk, causal, window, cap, dtype):
    """``attention_lse_ref`` (the rows' log-sum-exp the wgmma forward writes:
    natural log over the scaled, capped, masked logits) against
    ``jax.nn.logsumexp`` of the JAX reference's logits, causal, full, at a
    ragged length (33, no multiple of a tile), more keys than queries, a
    window and a softcap; to 2e-5 relative in fp32 (both from the same
    rounded inputs)."""
    jq, q = both(7, (2, hq, sq, 32), dtype)
    jk, k = both(8, (2, hkv, sk, 32), dtype)
    kw = dict(causal=causal, window=window, softcap=cap)
    qg = jnp.asarray(jq, jnp.float32).reshape(2, hkv, hq // hkv, sq, 32)
    s = jnp.einsum("bhgqd,bhkd->bhgqk", qg, jnp.asarray(jk, jnp.float32)) / np.sqrt(32)
    if cap > 0:
        s = cap * jnp.tanh(s / cap)
    qp, kp = jnp.arange(sq)[:, None], jnp.arange(sk)[None, :]
    mask = jnp.ones((sq, sk), bool)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= kp > qp - window
    want = np.asarray(jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1)).reshape(2, hq, sq)
    got = attention_lse_ref(q, k, **kw)
    assert got.dtype == torch.float32 and got.shape == (2, hq, sq)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_attention_lse_ref_is_inf_on_a_row_with_no_live_key():
    """Rows with no live key (causal, window 1, fewer keys than queries:
    rows 4 and 5 would see only keys 4 and 5, which do not exist) get +inf,
    the others their one logit; the plain backward given them adds nothing
    from those rows."""
    g = torch.Generator().manual_seed(0)
    q, do = torch.randn(1, 2, 6, 32, generator=g), torch.randn(1, 2, 6, 32, generator=g)
    k, v = torch.randn(1, 2, 4, 32, generator=g), torch.randn(1, 2, 4, 32, generator=g)
    kw = dict(causal=True, window=1)
    lse = attention_lse_ref(q, k, **kw)
    assert (lse[..., 4:] == float("inf")).all()
    torch.testing.assert_close(lse[..., :4], (q[..., :4, :] * k).sum(-1) / np.sqrt(32))
    dq, dk, dv = attention_bwd_ref(q, k, v, attention_ref(q, k, v, **kw), do, lse, **kw)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all() and torch.isfinite(dv).all()
    assert not dq[..., 4:, :].any()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("r,c", [(64, 256), (100, 128), (7, 1024)])
def test_rmsnorm_bwd_plain_matches_jax_vjp(r, c, dtype):
    jx, x = both(4, (r, c), dtype, 3.0)
    g = np.random.default_rng(5).standard_normal(c).astype(np.float32)
    jdy, dy = both(6, (r, c), dtype)
    _, vjp = jax.vjp(jax_rmsnorm_ref, jx, jnp.asarray(g))
    jdx, jdg = vjp(jdy)
    dx, dg = rmsnorm_bwd_ref(x, torch.from_numpy(g), dy)
    assert dx.dtype == x.dtype and dg.dtype == torch.float32
    tol = DTYPES[dtype][2]
    assert rel_max(t2np(dx), jnp2np(jdx)) < tol
    assert rel_max(t2np(dg), jnp2np(jdg)) < tol


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_silu_mul_bwd_plain_matches_jax_vjp(dtype):
    jg, g = both(7, (100, 256), dtype, 3.0)
    ju, u = both(8, (100, 256), dtype)
    jdy, dy = both(9, (100, 256), dtype)
    _, vjp = jax.vjp(jax_silu_mul_ref, jg, ju)
    want = vjp(jdy)
    got = silu_mul_bwd_ref(g, u, dy)
    for a, w in zip(got, want):
        assert a.dtype == g.dtype
        assert rel_max(t2np(a), jnp2np(w)) < DTYPES[dtype][2]


def test_ops_build_no_graph_without_grad():
    """Serving: parameters without requires_grad (or no_grad) take the
    direct forward; the autograd Functions only where a gradient is due."""
    cfg = smoke_config(get_config("qwen3-1.7b"))
    model = models.init_params(cfg, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 8))
    assert model(tok).grad_fn is None
    model.requires_grad_(True)
    with torch.no_grad():
        assert model(tok).grad_fn is None
    assert model(tok).grad_fn is not None


# ---------------- what trains ----------------

# the fields a LayerNorm, GELU and gated-GELU backward, the MoE aux loss, a
# frontend in the train step, the windowed and softcapped flash backward, the
# RG-LRU backward and the wkv backward opened
ADMITTED = {
    "attention_free": dict(family="ssm"),
    "attn_window": dict(attn_window=16),
    "attn_logit_softcap": dict(attn_logit_softcap=30.0),
    "block_pattern": dict(family="hybrid", block_pattern=("rglru", "rglru", "attn")),
    "norm": dict(norm="layernorm"),
    "activation": dict(activation="gelu"),
    "n_experts": dict(family="moe", n_experts=4, top_k=2),
    "cross_attention": dict(family="audio", cross_attention=True, n_encoder_layers=2,
                            n_frontend_tokens=16, qk_norm=False),
    "cross_attn_layers": dict(family="vlm", cross_attn_layers=(1,), n_frontend_tokens=16),
}


@pytest.mark.parametrize("field", sorted(ADMITTED))
def test_check_trainable_admits_each_opened_field(field):
    cfg = dataclasses.replace(smoke_config(get_config("qwen3-1.7b")), **ADMITTED[field])
    check_trainable(cfg)


def test_check_trainable_takes_exactly_the_opened_configs():
    """Every config trains, at full size and at smoke size: the wkv
    backward opened the last one, rwkv6-7b."""
    archs = {**ARCHS, **EXTRA_ARCHS}
    assert set(TRAINABLE) < set(archs) and "rwkv6-7b" in archs and len(archs) == 11
    for cfg in archs.values():
        check_trainable(cfg)
        check_trainable(smoke_config(cfg))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-tiny", "recurrentgemma-2b",
                                  "rwkv6-7b"])
def test_train_launcher_runs_on_cpu(tmp_path, capsys, arch):
    """The launcher on the CPU: three steps, a checkpoint each; whisper-tiny
    with the zero frontend the JAX launcher gives it; recurrentgemma through
    its RG-LRU and windowed attention backward; rwkv6 through the wkv
    backward."""
    state = train_launcher.main(["--arch", arch, "--device", "cpu", "--preset",
                                 "tiny", "--steps", "3", "--batch", "2", "--seq", "16",
                                 "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert [ln.split()[1] for ln in out.splitlines() if ln.startswith("step")] == ["0", "1", "2"]
    assert int(state.opt.step) == 3
    assert (tmp_path / "step_2" / "manifest.json").exists()
    with pytest.raises(ValueError, match="world size is 1"):
        train_launcher.main(["--device", "cpu", "--data", "2"])
