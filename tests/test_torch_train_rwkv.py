"""Training rwkv6-7b, the config the wkv backward opens, against the JAX
package on the CPU at its smoke config, on the same numpy inputs and
weights (JAX's ``init_params`` carried over by ``params_from_jax``).

The base decays ``w0`` are set to seeded values in [-6.9, 1.1] in the JAX
tree before it crosses, and the bonus ``u`` to seeded normal values at the
init's scale of 0.3: at the init's w0 = -6 every decay w = exp(-exp(w0 +
dd)) is about 0.9975, and a backward that dropped the decays from the
state's gradient would pass. With them, w spans about 0.05 to 0.999.

Tolerances: the loss, each of its parts and each gradient leaf within 2e-2
(relative Frobenius for a leaf), as for the other configs; the plain wkv
backward within 1e-10 of float64 autograd and within 1e-4 of ``jax.vjp``
of the JAX scan (the wkv tolerance, fp32, relative to the largest
gradient); the chunked form of ``csrc/wkv_bwd.cu`` within 1e-4 of the plain
backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jax_models
from repro import training as jt
from repro.configs import get_config as jax_get_config, smoke_config as jax_smoke
from repro.models import recurrent as jax_recurrent
from repro_torch import models
from repro_torch import training as tt
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.wkv.ops import WKVFn, wkv
from repro_torch.kernels.wkv.ref import wkv_bwd_chunked_ref, wkv_bwd_ref, wkv_ref
from repro_torch.models.bridge import params_from_jax, to_tensor
from repro_torch.models.lm import LM, loss_fn

from test_torch_train_configs import TOL, batch, grads_by_name, rel_fro, rel_max, t2np

ARCH = "rwkv6-7b"
WKV_TOL = 1e-4
NAMES = ("dr", "dk", "dv", "dw", "du", "dstate0")


def unhidden(tree, seed=2):
    """The JAX tree as numpy leaves, every ``w0`` at seeded values in
    [-6.9, 1.1] and every ``u`` seeded normal times 0.3."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        key = path[-1].key
        if key == "w0":
            return rng.uniform(-6.9, 1.1, np.shape(a)).astype(np.float32)
        if key == "u":
            return (0.3 * rng.standard_normal(np.shape(a))).astype(np.float32)
        return np.asarray(a)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def jax_case(seed=1):
    """(JAX config, JAX params, port config, trainable port model holding
    them), the decays and the bonus unhidden."""
    jcfg = jax_smoke(jax_get_config(ARCH))
    cfg = smoke_config(get_config(ARCH))
    jparams = jax.tree.map(jnp.asarray, unhidden(
        jax_models.init_params(jcfg, jax.random.PRNGKey(seed))))
    model = LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, cfg, model.requires_grad_(True)


def wkv_case(B, T, H, N, with_state, decays=(0.05, 0.999), dtype=np.float64, seed=0):
    """r, k, v, the output's and the final state's gradients normal; w
    uniform over `decays`, or "edge": a fifth each of exact 0, 1e-30 and
    exact 1 among values in (0.05, 0.999); u at 0.3; state0 normal if
    asked. numpy arrays of `dtype`."""
    rng = np.random.default_rng(seed)
    shape = (B, T, H, N)
    r, k, v, dout = (rng.standard_normal(shape) for _ in range(4))
    lo, hi = (0.05, 0.999) if decays == "edge" else decays
    w = rng.uniform(lo, hi, shape)
    if decays == "edge":
        pick = rng.integers(0, 5, shape)
        w = np.where(pick == 0, 0.0, np.where(pick == 1, 1e-30, np.where(pick == 2, 1.0, w)))
    u = 0.3 * rng.standard_normal((H, N))
    s0 = rng.standard_normal((B, H, N, N)) if with_state else None
    dstate = rng.standard_normal((B, H, N, N))
    return tuple(None if a is None else a.astype(dtype)
                 for a in (r, k, v, w, u, s0, dout, dstate))


def tensors(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


# ---------------- the plain backward ----------------

@pytest.mark.parametrize("B,T,H,N,with_state", [(2, 13, 2, 4, True), (1, 40, 1, 8, False),
                                                (2, 70, 2, 8, True), (3, 1, 2, 4, True)])
def test_wkv_bwd_ref_matches_float64_autograd(B, T, H, N, with_state):
    """``wkv_bwd_ref`` against torch.autograd.grad of ``wkv_ref`` in
    float64, for the output's and the final state's gradients together:
    every input's gradient, state0's too, within 1e-10 of the largest."""
    r, k, v, w, u, s0, dout, dstate = tensors(*wkv_case(B, T, H, N, with_state))
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, s0) if t is not None]
    out, state = wkv_ref(*leaves[:5], leaves[5] if with_state else None)
    assert out.dtype == torch.float64
    want = torch.autograd.grad((out * dout).sum() + (state * dstate).sum(), leaves)
    got = wkv_bwd_ref(r, k, v, w, u, s0, dout, dstate)
    assert (got[5] is None) == (not with_state)
    for name, g, x in zip(NAMES, [t for t in got if t is not None], want):
        assert g.dtype == torch.float64 and g.shape == x.shape, name
        assert rel_max(g.numpy(), x.numpy()) < 1e-10, name


def test_wkv_bwd_ref_sets_dw_to_zero_where_log_w_is_clamped():
    """Where log w <= LOG_W_MIN (w exactly 0 and 1e-30) the chunked forward
    clamps log w and its output does not depend on w: dw is 0 there and
    autograd's elsewhere; the other gradients are autograd's throughout."""
    r, k, v, w, u, s0, dout, dstate = tensors(*wkv_case(2, 30, 2, 8, True, "edge"))
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, s0)]
    out, state = wkv_ref(*leaves)
    want = torch.autograd.grad((out * dout).sum() + (state * dstate).sum(), leaves)
    got = wkv_bwd_ref(r, k, v, w, u, s0, dout, dstate)
    clamped = w <= 1e-30
    assert clamped.any() and not got[3][clamped].any()
    assert torch.allclose(got[3][~clamped], want[3][~clamped], rtol=0, atol=1e-10)
    for name, g, x in zip(NAMES, got, want):
        if name != "dw":
            assert rel_max(g.numpy(), x.numpy()) < 1e-10, name


@pytest.mark.parametrize("T,with_state", [(1, True), (33, False), (100, True)])
def test_wkv_bwd_ref_matches_jax_vjp(T, with_state):
    """``wkv_bwd_ref`` in fp32 against jax.vjp of the JAX model's
    ``wkv_scan`` (its chunks of 64 steps, T off them), for the gradients of
    the output and of the final state: r, k, v, w, u and state0, to 1e-4
    of the largest."""
    r, k, v, w, u, s0, dout, dstate = wkv_case(2, T, 2, 8, True, dtype=np.float32, seed=T)
    if not with_state:
        s0 = np.zeros_like(s0)
    want = jax.jit(lambda a, ct: jax.vjp(jax_recurrent.wkv_scan, *a)[1](ct))(
        [jnp.asarray(x) for x in (r, k, v, w, u, s0)], (jnp.asarray(dout), jnp.asarray(dstate)))
    got = wkv_bwd_ref(*tensors(r, k, v, w, u), torch.from_numpy(s0) if with_state else None,
                      *tensors(dout, dstate))
    for name, g, x in zip(NAMES, got, want):
        if g is None:
            continue
        assert g.dtype == torch.float32, name
        assert rel_max(g.numpy(), np.asarray(x)) < WKV_TOL, name


@pytest.mark.parametrize("B,T,H,N,with_state,decays,segment", [
    (2, 70, 2, 8, True, (0.05, 0.999), 32), (1, 100, 2, 16, False, (0.0, 0.2), 64),
    (2, 50, 2, 8, True, "edge", 32), (1, 130, 1, 64, True, (0.99, 0.999), 64)])
def test_wkv_bwd_chunked_form_matches_the_plain_backward(B, T, H, N, with_state, decays,
                                                        segment):
    """The arithmetic of ``csrc/wkv_bwd.cu`` (``wkv_bwd_chunked_ref``:
    segments' states, each chunk's rebuilt, the chunks from the end, dw as
    the rowsum of D S expanded over the chunk) against ``wkv_bwd_ref`` in
    fp32 at 1e-4 of the largest: T off the chunk and the segment, decays
    near 1, small ones (where dw divided from d(log w) would lose its
    precision) and exact 0, 1e-30 and 1."""
    args = tensors(*wkv_case(B, T, H, N, with_state, decays, np.float32, seed=T))
    want = wkv_bwd_ref(*args)
    got = wkv_bwd_chunked_ref(*args, segment=segment)
    for name, g, x in zip(NAMES, got, want):
        assert (g is None) == (x is None), name
        if x is not None:
            assert g.shape == x.shape and rel_max(g.numpy(), x.numpy()) < WKV_TOL, name


# ---------------- the op's autograd Function ----------------

def test_wkv_fn_passes_gradcheck():
    """``WKVFn`` on the CPU (``wkv_ref`` forward, ``wkv_bwd_ref`` backward)
    through torch.autograd.gradcheck in float64: both outputs, state0
    given; and the output alone without state0."""
    leaves = [t.requires_grad_(True) for t in tensors(*wkv_case(1, 6, 2, 3, True)[:6])]
    assert torch.autograd.gradcheck(lambda *a: WKVFn.apply(*a, None), leaves)
    assert torch.autograd.gradcheck(lambda *a: WKVFn.apply(*a, None, None)[0], leaves[:5])


def test_wkv_op_differentiates_through_its_backward():
    """On the CPU the op with a gradient due runs as ``WKVFn``: its outputs
    are ``wkv_ref``'s and autograd's gradients ``wkv_bwd_ref``'s, bit for
    bit; an unused final state passes none; with lengths the backward
    raises, with state_out the call; without a gradient no graph is
    built."""
    r, k, v, w, u, s0, dout, _ = tensors(*wkv_case(2, 40, 2, 8, True, dtype=np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, s0)]
    out, state = wkv(*leaves)
    want_out, want_state = wkv_ref(r, k, v, w, u, s0)
    assert torch.equal(out, want_out) and torch.equal(state, want_state)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, dout)
    for g, x in zip(grads, wkv_bwd_ref(r, k, v, w, u, s0, dout)):
        assert g.dtype == x.dtype and torch.equal(g, x)
    out, _ = wkv(*leaves, torch.full((2,), 20, dtype=torch.int32))
    with pytest.raises(ValueError, match="no lengths"):
        out.sum().backward()
    with pytest.raises(ValueError, match="no state_out"):
        wkv(*leaves, state_out=torch.empty_like(s0))
    with torch.no_grad():
        assert wkv(*leaves)[0].grad_fn is None
    assert wkv(r, k, v, w, u, s0)[0].grad_fn is None


# ---------------- the model against JAX ----------------

def test_loss_and_every_gradient_match_jax():
    """The loss, each of its parts and every leaf's gradient at 2 x 96
    tokens (past a JAX chunk of 64 steps, with a loss mask), the decays and
    the bonus unhidden: every time-mix leaf (w0, the decay LoRA, u, ln_x)
    has a gradient through the wkv backward."""
    jcfg, jparams, cfg, model = jax_case()
    tokens, targets, mask, _ = batch(cfg, 2, 96, 3)

    def jloss(p):
        return jax_models.loss_fn(jcfg, p, jnp.asarray(tokens), jnp.asarray(targets),
                                  mask=jnp.asarray(mask))

    (jtotal, jmet), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    total, met = loss_fn(model, torch.from_numpy(tokens), torch.from_numpy(targets),
                         mask=torch.from_numpy(mask))
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
    assert abs(float(total.detach()) - float(jtotal)) < TOL
    for key in ("ce", "z_loss", "tokens"):
        assert abs(float(met[key].detach()) - float(jmet[key])) < \
            TOL * max(1.0, abs(float(jmet[key]))), key
    want = grads_by_name(cfg, jgrads)
    assert set(want) == set(grads)
    w0 = params["blocks.0.tmix.w0"].detach()
    decays = torch.exp(-torch.exp(w0))
    assert decays.min() < 0.1 and decays.max() > 0.99
    for n in ("tmix.w0", "tmix.u", "tmix.w_lora_a", "tmix.w_lora_b", "tmix.ln_x"):
        assert f"blocks.1.{n}" in grads
    for n, g in grads.items():
        assert g.dtype == params[n].dtype, n
        assert np.linalg.norm(want[n]) > 0, n
        assert rel_fro(t2np(g), want[n]) < TOL, (n, rel_fro(t2np(g), want[n]))


def test_two_microbatch_step_matches_jax():
    """make_train_step(..., microbatches=2) against the JAX step, two steps
    (the second on the updated weights): mean loss, global gradient norm,
    metric set."""
    jcfg, jparams, cfg, model = jax_case()
    jopt = jt.AdamW(lr=jt.constant_schedule(1e-3))
    opt = tt.AdamW(lr=tt.constant_schedule(1e-3))
    jstate = jt.TrainState(jparams, jopt.init(jparams))
    state = tt.TrainState(model, opt.init(dict(model.named_parameters())))
    jstep = jax.jit(jt.make_train_step(jcfg, jopt, microbatches=2))
    step = tt.make_train_step(cfg, opt, microbatches=2)
    for seed in (4, 5):
        tokens, targets, mask, _ = batch(cfg, 2, 80, seed)
        jb = {"tokens": tokens, "targets": targets, "mask": mask}
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in jb.items()})
        state, met = step(state, {k: to_tensor(v) for k, v in jb.items()})
        assert set(met) == set(jmet) == {"loss", "grad_norm", "lr"}
        assert abs(float(met["loss"]) - float(jmet["loss"])) < TOL
        assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=TOL)


def test_serving_with_grad_enabled_builds_no_graph():
    """Serving parameters need no gradient, so the wkv op runs its forward
    directly: prefill, a decode step and the forward build no graph with
    grad mode on; a trainable model does, and not under no_grad."""
    cfg = smoke_config(get_config(ARCH))
    model = models.init_params(cfg, seed=0, device="cpu")
    cache = models.init_cache(cfg, 2, 32, device="cpu")
    toks = torch.zeros((2, 8), dtype=torch.int32)
    with torch.enable_grad():
        out = [model.prefill(toks, cache, torch.tensor([8, 5], dtype=torch.int32)),
               model.decode_step(toks[:, 0], cache), model(toks)]
        assert all(o.grad_fn is None for o in out)
        model.requires_grad_(True)
        assert model(toks).grad_fn is not None
        with torch.no_grad():
            assert model(toks).grad_fn is None
