"""Training the configs that the windowed and softcapped flash backward and
the RG-LRU backward open: recurrentgemma-2b (Griffin: RG-LRU layers and
local attention under a window, D = 256 at full size) and grok-1-314b
(MoE, an attention logit softcap of 30), against the JAX package on the
CPU at their smoke configs, on the same numpy inputs and weights (JAX's
``init_params`` carried over by ``params_from_jax``).

recurrentgemma's ``lam`` is set to seeded values in [-6, 1] in the JAX tree
before it crosses: at the init's 3.0 every recurrence gate a is about
5e-6, so h_t is b_t and the scan's carried gradient would be too small to
see. Its 2 x 128 tokens pass the smoke window of 64, so the window cuts.
grok routes each token to its top-2 experts, so the JAX routing is
recorded and replayed in the port, as for granite
(``test_torch_train_configs.py``).

Tolerances: the loss, each of its parts and each gradient leaf within 2e-2
(relative Frobenius for a leaf), as for the other configs; the plain RG-LRU
backward within 1e-4 of ``jax.vjp`` relative to the largest gradient (the
rglru tolerance, all in fp32), the plain attention backward within 2e-2
(bf16) and 2e-5 (fp32).
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
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.models import recurrent as jax_recurrent
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref, attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.rglru.ops import rglru
from repro_torch.kernels.rglru.ref import rglru_bwd_ref, rglru_ref
from repro_torch.models.bridge import decayed_leaves, params_from_jax, to_tensor
from repro_torch.models.lm import LM, loss_fn, unit_structure
from repro_torch import training as tt

from _torch_routing import replay_routing, routing_flips
from test_torch_train_configs import (TOL, batch, forward_records, grads_by_name, jnp2np,
                                      record_jax_routing, rel_fro, rel_max, t2np)

HYBRID = ["recurrentgemma-2b", "grok-1-314b"]
RGLRU_TOL = 1e-4


def seeded_lam(tree, seed=2):
    """The JAX tree as numpy leaves, every RG-LRU ``lam`` at seeded values
    in [-6, 1] (recurrence gates a from about 5e-6 to 0.99)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: rng.uniform(-6.0, 1.0, np.shape(a)).astype(np.float32)
        if path[-1].key == "lam" else np.asarray(a), tree)


def jax_case(arch, n_layers=None, seed=1):
    """(JAX config, JAX params, port config, trainable port model holding
    them); the smoke config, cut to `n_layers` where given."""
    import dataclasses
    jcfg = jax_smoke(jax_get_config(arch))
    cfg = smoke_config(get_config(arch))
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    jparams = jax.tree.map(jnp.asarray, seeded_lam(
        jax_models.init_params(jcfg, jax.random.PRNGKey(seed))))
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, cfg, model.requires_grad_(True)


# ---------------- loss, aux and gradients ----------------

@pytest.mark.parametrize("arch", HYBRID)
def test_loss_and_every_gradient_match_jax(monkeypatch, arch):
    """The loss, each of its parts (grok's aux among them, nonzero) and
    every leaf's gradient at 2 x 128 tokens: recurrentgemma's window (64)
    cuts, and every RG-LRU leaf (lam, the gate weights, the conv) has a
    gradient through the scan's backward; grok's attention under its
    softcap, its experts and router with the JAX routing replayed."""
    jcfg, jparams, cfg, model = jax_case(arch)
    assert cfg.attn_window in (0, 64) and (cfg.attn_window or cfg.attn_logit_softcap)
    tokens, targets, mask, _ = batch(cfg, 2, 128, 3)
    records = record_jax_routing(monkeypatch) if cfg.n_experts else None

    def jloss(p):
        return jax_models.loss_fn(jcfg, p, jnp.asarray(tokens), jnp.asarray(targets),
                                  mask=jnp.asarray(mask))

    (jtotal, jmet), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    own = []
    if records is not None:
        replay_routing(monkeypatch, forward_records(records, cfg.n_layers), own)
    total, met = loss_fn(model, torch.from_numpy(tokens), torch.from_numpy(targets),
                         mask=torch.from_numpy(mask))
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
    assert abs(float(total.detach()) - float(jtotal)) < TOL
    for k in ("ce", "z_loss", "aux", "tokens"):
        got = float(met[k].detach())
        assert abs(got - float(jmet[k])) < TOL * max(1.0, abs(float(jmet[k]))), k
    assert (float(jmet["aux"]) > 0) == bool(cfg.n_experts)
    want = grads_by_name(cfg, jgrads)
    assert set(want) == set(grads)
    if cfg.block_pattern:
        assert any(n.endswith("rec.lam") for n in grads)
    for n, g in grads.items():
        assert g.dtype == params[n].dtype, n
        assert np.linalg.norm(want[n]) > 0, n
        assert rel_fro(t2np(g), want[n]) < TOL, (n, rel_fro(t2np(g), want[n]))
    if records is not None:
        assert routing_flips(cfg.top_k, forward_records(records, cfg.n_layers), own)[1] == 0


@pytest.mark.parametrize("arch", HYBRID)
def test_two_microbatch_step_matches_jax(monkeypatch, arch):
    """make_train_step(..., microbatches=2) against the JAX step, two steps
    (the second on the updated weights): mean loss, global gradient norm,
    metric set; grok's capacity per microbatch with its JAX routing
    replayed."""
    jcfg, jparams, cfg, model = jax_case(arch)
    jopt = jt.AdamW(lr=jt.constant_schedule(1e-3))
    opt = tt.AdamW(lr=tt.constant_schedule(1e-3))
    jstate = jt.TrainState(jparams, jopt.init(jparams))
    state = tt.TrainState(model, opt.init(dict(model.named_parameters())))
    jstep = jax.jit(jt.make_train_step(jcfg, jopt, microbatches=2))
    step = tt.make_train_step(cfg, opt, microbatches=2)
    records = record_jax_routing(monkeypatch) if cfg.n_experts else None
    for seed in (4, 5):
        tokens, targets, mask, _ = batch(cfg, 2, 80, seed)
        jb = {"tokens": tokens, "targets": targets, "mask": mask}
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


def test_decayed_leaves_of_a_unit_and_its_remainder_are_jax_ones():
    """ROADMAP C14 on a recurrentgemma cut of 5 layers, one stacked unit of
    (rglru, rglru, attn) and a remainder of (rglru, rglru): the 1-D ``lam``
    and ``conv_b`` are decayed inside the unit (its leaves are stacked, so
    2-D in JAX) and not in the remainder, as the JAX AdamW decides."""
    jcfg, jparams, cfg, model = jax_case("recurrentgemma-2b", n_layers=5)
    assert unit_structure(cfg) == (("rglru", "rglru", "attn"), 1, ("rglru", "rglru"))
    flags = jax.tree.map(lambda p: np.full(p.shape, p.ndim >= 2), jparams)
    want = {n for n, t in params_from_jax(cfg, flags).items() if bool(t.all())}
    got = decayed_leaves(cfg, dict(model.named_parameters()))
    assert got == want
    for i in (0, 1):
        assert {f"blocks.{i}.rec.lam", f"blocks.{i}.rec.conv_b"} <= got
    for i in (3, 4):
        assert not {f"blocks.{i}.rec.lam", f"blocks.{i}.rec.conv_b"} & got
        assert f"blocks.{i}.rec.w_a" in got


# ---------------- the RG-LRU backward ----------------

def jax_rglru(u, w_a, w_x, lam, gate, h0):
    """The JAX model's RG-LRU after its conv: ``_rglru_gates``, h0 folded
    into the first step, the associative scan, ``gate * h`` and the final
    h, as ``rglru_apply`` runs them."""
    a, b = jax_recurrent._rglru_gates({"w_a": w_a, "w_x": w_x, "lam": lam}, u)
    if h0 is not None:
        b = b.at[:, 0, :].add(a[:, 0, :] * h0)

    def combine(e1, e2):
        return e1[0] * e2[0], e1[1] * e2[0] + e2[1]

    _, hh = lax.associative_scan(combine, (a, b), axis=1)
    return gate.astype(jnp.float32) * hh, hh[:, -1]


def rglru_case(T, with_h0, B=2, d=24, seed=0):
    """u and the gate at bf16 values, fp32 gate weights with channels 0-3's
    ga near -40 (the clamp of sqrt(max(1 - a^2, 1e-12)) holds there), lam in
    [-2, 4], h0, dy and the final state's gradient normal."""
    rng = np.random.default_rng(seed)

    def bf(x):
        return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))

    u = bf(rng.standard_normal((B, T, d)))
    u[..., 0] = 1.0
    w_a = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    w_x = (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
    w_a[0, :4] = -40.0
    w_a[1:, :4] *= 0.01
    lam = rng.uniform(-2, 4, d).astype(np.float32)
    gate = bf(rng.standard_normal((B, T, d)))
    h0 = rng.standard_normal((B, d)).astype(np.float32) if with_h0 else None
    dy = rng.standard_normal((B, T, d)).astype(np.float32)
    dh_last = rng.standard_normal((B, d)).astype(np.float32)
    return u, w_a, w_x, lam, gate, h0, dy, dh_last


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("T", [1, 33, 128])
def test_rglru_bwd_plain_matches_jax_vjp(T, with_h0):
    """``rglru_bwd_ref`` on ga = u w_a and gx = u w_x, chained to u, w_a and
    w_x, against jax.vjp of the JAX gates and scan for the gradients of
    ``gate * h`` and of the final h: u, w_a, w_x, lam, the gate and h0, in
    fp32, to 1e-4 of the largest; with the clamp holding on channels 0-3
    (its gradient there is 0, as JAX's ``maximum`` passes)."""
    u, w_a, w_x, lam, gate, h0, dy, dh_last = rglru_case(T, with_h0)
    args = [jnp.asarray(x) for x in (u, w_a, w_x, lam, gate)] + \
        ([jnp.asarray(h0)] if with_h0 else [])
    f = jax_rglru if with_h0 else (lambda *a: jax_rglru(*a, None))
    want = jax.jit(lambda a, ct: jax.vjp(f, *a)[1](ct))(args, (jnp.asarray(dy),
                                                               jnp.asarray(dh_last)))
    tu, wa, wx = (torch.from_numpy(x) for x in (u, w_a, w_x))
    ga, gx = tu @ wa, tu @ wx
    lam_t, gate_t = torch.from_numpy(lam), torch.from_numpy(gate)
    h0_t = None if h0 is None else torch.from_numpy(h0)
    clamp = (1 - torch.exp(-16 * torch.sigmoid(ga) * torch.nn.functional.softplus(lam_t))) \
        <= 1e-12
    assert clamp[..., :4].all() and not clamp[..., 4:].any()
    du, dga, dgx, dlam, dgate, dh0 = rglru_bwd_ref(tu, ga, gx, lam_t, gate_t, h0_t,
                                                   torch.from_numpy(dy),
                                                   torch.from_numpy(dh_last))
    assert (dh0 is None) == (h0 is None)
    assert du.dtype == dga.dtype == dgx.dtype == dlam.dtype == dgate.dtype == torch.float32
    got = [du + dga @ wa.T + dgx @ wx.T, torch.einsum("btj,btc->jc", tu, dga),
           torch.einsum("btj,btc->jc", tu, dgx), dlam, dgate] + ([dh0] if with_h0 else [])
    for name, g, w in zip(("u", "w_a", "w_x", "lam", "gate", "h0"), got, want):
        assert rel_max(g.numpy(), np.asarray(w)) < RGLRU_TOL, name


def test_rglru_op_differentiates_through_its_backward():
    """On the CPU the op with a gradient due runs as ``RGLRUFn``: its
    output is ``rglru_ref``'s, and autograd's gradients are
    ``rglru_bwd_ref``'s (bf16 u and gate get bf16 gradients); with lengths
    the backward raises; without a gradient no graph is built."""
    u, w_a, w_x, lam, gate, h0, dy, _ = rglru_case(40, True, seed=3)
    tu = torch.from_numpy(u).bfloat16()
    uf = torch.from_numpy(u)
    ga, gx = uf @ torch.from_numpy(w_a), uf @ torch.from_numpy(w_x)
    tg, tl, th = torch.from_numpy(gate).bfloat16(), torch.from_numpy(lam), torch.from_numpy(h0)
    leaves = [t.clone().requires_grad_(True) for t in (tu, ga, gx, tl, tg, th)]
    y, h = rglru(*leaves)
    wy, wh = rglru_ref(tu, ga, gx, tl, tg, th)
    assert torch.equal(y, wy) and torch.equal(h, wh) and y.grad_fn is not None
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    want = rglru_bwd_ref(tu, ga, gx, tl, tg, th, torch.from_numpy(dy))
    for g, w in zip(grads, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    y, _ = rglru(*leaves, torch.full((2,), 20, dtype=torch.int32))
    with pytest.raises(ValueError, match="no lengths"):
        y.sum().backward()
    with torch.no_grad():
        assert rglru(*leaves)[0].grad_fn is None


# ---------------- the attention backward under a window, a softcap, D = 256 ----------------

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

# (Hq, Hkv, S, D, window, softcap, q scale): a window that cuts and one
# that does not (>= S), grok's softcap of 30 on logits of about 8 (q x 8),
# window and softcap together, and recurrentgemma's D = 256 with G = 10
# under a window that cuts
WINDOW_CAP_CASES = [(4, 2, 64, 32, 16, 0.0, 1.0), (4, 2, 40, 32, 64, 0.0, 1.0),
                    (6, 2, 40, 64, 0, 30.0, 8.0), (4, 1, 48, 64, 16, 20.0, 6.0),
                    (10, 1, 40, 256, 24, 0.0, 1.0)]


@pytest.mark.parametrize("given_lse", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv,s,d,window,cap,qs", WINDOW_CAP_CASES)
def test_attention_bwd_plain_matches_jax_vjp(hq, hkv, s, d, window, cap, qs, dtype, given_lse):
    """``attention_bwd_ref`` (given the rows' log-sum-exp, as the wgmma
    backward takes it, or not) against jax.vjp of the JAX attention
    reference, causal, at each case."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(s + d)
    xs = [rng.standard_normal(shape).astype(np.float32)
          for shape in ((2, hq, s, d), (2, hkv, s, d), (2, hkv, s, d), (2, hq, s, d))]
    xs[0] *= qs
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in xs)
    q, k, v, do = (torch.from_numpy(x).to(tdt) for x in xs)
    kw = dict(causal=True, window=window, softcap=cap)
    want = jax.jit(lambda a, b, c, ct: jax.vjp(
        lambda x, y, z: jax_attention_ref(x, y, z, **kw), a, b, c)[1](ct))(jq, jk, jv, jdo)
    lse = attention_lse_ref(q, k, **kw) if given_lse else None
    got = attention_bwd_ref(q, k, v, attention_ref(q, k, v, **kw), do, lse, **kw)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        assert rel_max(t2np(g), jnp2np(w)) < tol
