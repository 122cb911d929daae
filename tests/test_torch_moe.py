"""The port's MoE layer and the MoE decoders against the JAX package.

``moe_apply`` routes each token to its top-k experts by an fp32 router and
gives each expert a buffer of ``capacity`` rows; an assignment past it is
dropped. Weights and inputs are the same numpy arrays on both sides (bf16
crosses bit-exactly through ``bridge.to_tensor``).

A routing is a discrete choice: where two router logits of a token nearly
tie at its k-th choice, a rounding elsewhere in the model can flip which
expert runs, and that moves the token's output by a share of its MLP term,
far past the 2e-2 logit tolerance. So the logits are compared with the JAX
routing replayed in the port: a test-side wrapper of the JAX ``moe_apply``
records each call's top-k (``jax.debug.callback``, ordered), and a wrapper
of the port's ``moe_route`` (``_torch_routing``) returns those experts,
gated by the port's own probabilities. In that run the experts the port
would have chosen itself are held to the JAX ones: a choice may differ only
where the JAX margin between the k-th and the (k+1)-th router logit is at
most twice the largest difference between the two frameworks' router
logits in that call.

The JAX layer counts every token of the batch against the capacity, a
padded wave's pads included (``ROADMAP.md``, C10); the port reproduces it
and is held to the JAX model on the same batch, not to a prompt alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import models as jax_models
from repro.configs import get_config as jax_get_config, smoke_config as jax_smoke
from repro.models import layers as jax_layers
from repro.serving import Engine as JaxEngine, Request as JaxRequest
from repro.serving import engine as jax_engine_mod
from repro_torch import models
from repro_torch.configs import ModelConfig, get_config, smoke_config
from repro_torch.models import layers as t_layers
from repro_torch.models.bridge import to_tensor
from repro_torch.models.lm import LM, padded_vocab
from repro_torch.serving import Engine, Request

from _torch_routing import replay_routing, routing_flips

MOE = ["granite-moe-3b-a800m", "grok-1-314b"]
TOL = 2e-2


def rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def t2np(t):
    return t.float().numpy()


def _jax_route(cfg, p, xt):
    """The JAX layer's router on tokens xt: (fp32 logits, top-k gate, idx)."""
    logits = xt.astype(jnp.float32) @ p["router"]
    gate, idx = lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    return logits, gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9), idx


def record_jax_routing(monkeypatch):
    """Wrap the JAX ``moe_apply`` so that every call, jitted or not,
    appends (idx, router logits) as numpy arrays, in call order, to the
    list returned."""
    records, moe_apply = [], jax_layers.moe_apply

    def wrapped(cfg, p, x, capacity_factor=1.25):
        logits, _, idx = _jax_route(cfg, p, x.reshape(-1, x.shape[-1]))
        jax.debug.callback(lambda i, lg: records.append((np.asarray(i), np.asarray(lg))),
                           idx, logits, ordered=True)
        return moe_apply(cfg, p, x, capacity_factor)

    monkeypatch.setattr(jax_layers, "moe_apply", wrapped)
    return records


def dropped(idx, E, capacity):
    """Assignments past their expert's capacity, from the expert counts."""
    counts = np.bincount(idx.reshape(-1), minlength=E)
    return int(np.maximum(counts - capacity, 0).sum())


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _layer_case(case):
    """(port cfg, JAX cfg, JAX params, x (B, S, d) bf16 numpy, capacity
    factor) of one moe_apply case."""
    arch = "grok-1-314b" if case == "gated-gelu" else "granite-moe-3b-a800m"
    jcfg = jax_smoke(jax_get_config(arch))
    B, S, factor = 2, 16, 1.25
    if case == "decode-8":   # granite's 40 experts, top-8, at an 8-slot step
        jcfg = dataclasses.replace(jcfg, n_experts=40, top_k=8)
        B, S = 8, 1
    if case == "capacity-1":
        factor = 0.01
    p = jax_layers.moe_init(jcfg, jax.random.PRNGKey(3))
    x = np.random.default_rng(4).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    if case == "skewed":
        # every token's largest logit on expert 0: most of its assignments drop
        x += 1.0
        p["router"] = p["router"].at[:, 0].add(0.05)
    x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    return ModelConfig(**dataclasses.asdict(jcfg)), jcfg, p, x, factor


@pytest.mark.parametrize("case", ["gated-silu", "gated-gelu", "skewed", "capacity-1",
                                  "decode-8"])
def test_moe_apply_matches_jax(monkeypatch, case):
    """y within 2e-2 of the JAX layer's (its routing replayed), the aux loss
    within 1e-5, the port's own experts those of JAX but where the k-th and
    (k+1)-th probabilities lie within 1e-6, its gates within 1e-5; the
    skewed, capacity-1 and decode cases drop assignments."""
    cfg, jcfg, p, x, factor = _layer_case(case)
    E, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    T = x.shape[0] * x.shape[1]
    capacity = max(1, int(factor * T * k / E))
    want_y, want_aux = jax_layers.moe_apply(jcfg, p, jnp.asarray(x), factor)
    jlogits, jgate, jidx = (np.asarray(a) for a in _jax_route(jcfg, p, x.reshape(T, d)))
    tp = {name: to_tensor(np.asarray(w)) for name, w in p.items()}
    xt = to_tensor(x)
    _, gate, idx = t_layers.moe_route(cfg, tp, xt.reshape(T, d))
    probs = np.sort(np.asarray(jax.nn.softmax(jlogits, -1)), -1)[:, ::-1]
    tied = probs[:, k - 1] - probs[:, k] < 1e-6
    same = (np.sort(idx.numpy(), -1) == np.sort(jidx, -1)).all(-1)
    assert (same | tied).all()
    assert np.abs(gate.numpy() - jgate)[same].max() < 1e-5
    if case != "gated-silu" and case != "gated-gelu":
        assert dropped(jidx, E, capacity) > 0
    replay_routing(monkeypatch, [(jidx, jlogits)])
    y, aux = t_layers.moe_apply(cfg, tp, xt, factor)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert rel_err(t2np(y), want_y) < TOL
    assert abs(float(aux) - float(want_aux)) < 1e-5


def test_moe_dispatch_drops_past_capacity():
    """The buffer's slots go in the flat (token, choice) order. Three tokens
    choose experts 0 then 1, 0 then 1, and 0 then 2; at a capacity of 2,
    expert 0 takes the first two tokens and drops the third's first choice,
    whose output is then its second expert's alone. Each expert is
    gelu(8 x) times its index plus one, so the output shows which ran."""
    cfg = dataclasses.replace(smoke_config(get_config("granite-moe-3b-a800m")),
                              d_model=4, d_ff=4, n_experts=3, top_k=2, mlp_gated=False,
                              activation="gelu")
    eye = torch.eye(4, dtype=torch.bfloat16)
    router = torch.zeros((4, 3))
    router[0], router[1] = torch.tensor([4.0, 2.0, 0.0]), torch.tensor([4.0, 0.0, 2.0])
    p = {"router": router, "w_up": torch.stack([eye * 8] * 3),
         "w_down": torch.stack([eye * (e + 1) for e in range(3)])}
    x = torch.zeros((1, 3, 4), dtype=torch.bfloat16)
    x[0, :2, 0] = x[0, 2, 1] = 1.0
    # capacity int(1.2 * 3 * 2 / 3) = 2
    y, _ = t_layers.moe_apply(cfg, p, x, capacity_factor=1.2)
    p0, p1 = torch.softmax(torch.tensor([4.0, 2.0, 0.0]), 0)[:2].tolist()
    g0, g1 = p0 / (p0 + p1), p1 / (p0 + p1)
    want = torch.zeros((3, 4))
    want[:2, 0] = 8.0 * (g0 * 1 + g1 * 2)
    want[2, 1] = 8.0 * g1 * 3
    assert torch.allclose(y[0].float(), want, rtol=2 ** -7, atol=0)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _pair(arch):
    jcfg = jax_smoke(jax_get_config(arch))
    jparams = jax_models.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = LM(cfg, device="cpu")
    model.load_state_dict(models.params_from_jax(cfg, jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module", params=MOE)
def pair(request):
    return _pair(request.param)


def tokens(V, B, S, seed):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(np.int32)


def _port_run(monkeypatch, records, run):
    """`run()` on the port with `records` replayed: (the experts the port
    would have chosen itself in each call, and router logits; its result)."""
    own = []
    with monkeypatch.context() as m:
        calls = replay_routing(m, records, own)
        out = run()
        assert next(calls, None) is None
    return own, out


def test_forward_matches_jax(monkeypatch, pair):
    jcfg, jparams, cfg, model = pair
    V = cfg.vocab_size
    toks = tokens(V, 2, 16, 0)
    records = record_jax_routing(monkeypatch)
    want, aux = jax.jit(lambda p, t: jax_models.forward(jcfg, p, t))(jparams, toks)
    jax.effects_barrier()
    assert len(records) == cfg.n_layers and float(aux) > 0
    own, got = _port_run(monkeypatch, records, lambda: model(torch.from_numpy(toks)))
    assert got.shape == (2, 16, padded_vocab(cfg))
    assert rel_err(t2np(got)[..., :V], np.asarray(want, np.float32)[..., :V]) < TOL
    assert routing_flips(cfg.top_k, records, own)[1] == 0


def test_prefill_and_decode_match_jax(monkeypatch, pair):
    """Right-padded prompts of 12, 7 and 3 tokens, then three teacher-forced
    decode steps: logits, K/V and positions against the JAX serving path,
    the JAX routing replayed (the pads route and take capacity on both
    sides), and the port's own routing within the margin rule."""
    jcfg, jparams, cfg, model = pair
    V = cfg.vocab_size
    toks = tokens(V, 3, 12, 1)
    lens = np.array([12, 7, 3], np.int32)
    steps = tokens(V, 3, 3, 2)
    records = record_jax_routing(monkeypatch)
    jcache = jax_models.init_cache(jcfg, 3, 32)
    jl, jcache = jax.jit(lambda p, t, c, n: jax_models.prefill(
        jcfg, p, t, c, prompt_lens=n))(jparams, toks, jcache, lens)
    want = [np.asarray(jl, np.float32)]
    jdecode = jax.jit(lambda p, t, c: jax_models.decode_step(jcfg, p, t, c))
    for s in range(3):
        jl, jcache = jdecode(jparams, steps[:, s], jcache)
        want.append(np.asarray(jl, np.float32))
    jax.effects_barrier()
    assert len(records) == 4 * cfg.n_layers

    def run():
        cache = models.init_cache(cfg, 3, 32, device="cpu")
        out = [t2np(model.prefill(torch.from_numpy(toks), cache, torch.from_numpy(lens)))]
        out += [t2np(model.decode_step(torch.from_numpy(steps[:, s]), cache))
                for s in range(3)]
        return out, cache

    own, (got, cache) = _port_run(monkeypatch, records, run)
    for g, w in zip(got, want):
        assert rel_err(g[:, :V], w[:, :V]) < TOL
    assert cache["pos"].tolist() == (lens + 3).tolist()
    for name in ("k", "v"):
        assert rel_err(t2np(cache[name]), np.asarray(jcache["units"]["u0"][name],
                                                     np.float32)) < TOL
    assert routing_flips(cfg.top_k, records, own)[1] == 0


def test_padded_wave_takes_capacity_as_in_jax(monkeypatch):
    """ROADMAP.md C10, on granite-moe-3b-a800m's smoke config: a wave of a
    3-token prompt and a 12-token one, padded to 12. Its 24 token rows (9 of
    them the short prompt's pads) share each expert's capacity of
    int(1.25 * 24 * 2 / 4) = 15, where the short prompt alone has a capacity
    of 1 for its 3 tokens; causal attention keeps the pads out of its last
    token, so only the capacity moves its next-token logits. The port's
    wave is held to the JAX wave and its prompt alone to JAX's alone (JAX
    routing replayed), and the effect to JAX's: its size, 0.0534 of the
    largest logit in both frameworks (2.7 times the tolerance), in each
    within the tolerance of the other's."""
    jcfg, jparams, cfg, model = _pair("granite-moe-3b-a800m")
    V = cfg.vocab_size
    toks = tokens(V, 2, 12, 5)
    toks[0, 3:] = 0
    lens = np.array([3, 12], np.int32)
    prefill = jax.jit(lambda p, t, c, n: jax_models.prefill(jcfg, p, t, c, prompt_lens=n))
    out = {}
    for name, t, n in (("wave", toks, lens), ("alone", toks[:1, :3], lens[:1])):
        with monkeypatch.context() as m:
            records = record_jax_routing(m)
            jl, _ = prefill(jparams, t, jax_models.init_cache(jcfg, len(n), 16), n)
            jax.effects_barrier()
        with monkeypatch.context() as m:
            replay_routing(m, records)
            tl = model.prefill(torch.from_numpy(t), models.init_cache(cfg, len(n), 16,
                                                                      device="cpu"),
                               torch.from_numpy(n))
        out[name] = np.asarray(jl, np.float32)[0, :V], t2np(tl)[0, :V]
        assert rel_err(out[name][1], out[name][0]) < TOL
    effect = [rel_err(out["wave"][i], out["alone"][i]) for i in (0, 1)]
    assert min(effect) > TOL
    assert abs(effect[0] - effect[1]) < TOL


def test_engine_greedy_matches_jax_engine(monkeypatch):
    """granite-moe-3b-a800m's smoke config: five requests on two slots with
    staggered budgets, a first wave of two prompts of unequal lengths, then
    three refills by per-slot prefill and insert while the other slot
    decodes; the JAX engine's routing replayed. The port's engine must emit
    the JAX engine's greedy tokens and leave its K/V and positions. Each
    JAX step's top-2 logit margin is above twice the logit tolerance, so a
    mismatch is a fault and not a rounding."""
    jcfg, jparams, cfg, model = _pair("granite-moe-3b-a800m")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(rng.integers(3, 12))).tolist()
               for _ in range(5)]
    assert len(prompts[0]) != len(prompts[1])
    n_new = [3, 8, 5, 6, 4]
    margins = []
    sample = jax_engine_mod.sample_per_request

    def sampled(logits, key, sampling):
        rows = np.sort(np.asarray(logits, np.float32)[:, :cfg.vocab_size], -1)
        margins.extend((rows[:, -1] - rows[:, -2]) / np.abs(rows).max(-1))
        return sample(logits, key, sampling)

    monkeypatch.setattr(jax_engine_mod, "sample_per_request", sampled)
    records = record_jax_routing(monkeypatch)
    jeng = JaxEngine(jcfg, jparams, batch_size=2, max_len=64)
    jdone = jeng.run([JaxRequest(uid=i, prompt=p, max_new_tokens=n)
                      for i, (p, n) in enumerate(zip(prompts, n_new))])
    jax.effects_barrier()
    assert min(margins) > 2 * TOL
    calls = replay_routing(monkeypatch, records)
    eng = Engine(cfg, model, batch_size=2, max_len=64, device="cpu")
    inserts = []
    insert = eng._insert
    eng._insert = lambda one, slot: (inserts.append(slot), insert(one, slot))
    done = eng.run([Request(uid=i, prompt=p, max_new_tokens=n)
                    for i, (p, n) in enumerate(zip(prompts, n_new))])
    assert next(calls, None) is None and inserts == [0, 0, 1]
    assert {r.uid: r.output for r in done} == {r.uid: r.output for r in jdone}
    assert eng.stats["steps"] == jeng.stats["steps"]
    assert eng.cache["pos"].tolist() == np.asarray(jeng.cache["pos"]).tolist()
    for name in ("k", "v"):
        assert rel_err(t2np(eng.cache[name]),
                       np.asarray(jeng.cache["units"]["u0"][name], np.float32)) < TOL


# ---------------------------------------------------------------------------
# full size, shapes only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,n_layers,n_config", [
    ("granite-moe-3b-a800m", None, 3_298_793_472),
    ("grok-1-314b", 4, 21_290_539_008)])
def test_param_count_at_full_size(arch, n_layers, n_config):
    """granite-moe-3b-a800m at full size and grok-1-314b at full width cut
    to 4 of 64 layers, shapes only (meta device): the config's accounting
    (router and experts included) plus the vocab padding, the router fp32
    and the experts bf16, as the JAX init makes them (``jax.eval_shape``)."""
    cfg = get_config(arch)
    jcfg = jax_get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    model = models.init_params(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n - (padded_vocab(cfg) - cfg.vocab_size) * cfg.d_model == cfg.param_count() \
        == n_config
    shapes = jax.eval_shape(lambda: jax_models.init_params(jcfg, jax.random.PRNGKey(0)))
    assert n == sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    moe = model.blocks[0].moe
    assert moe["router"].dtype == torch.float32
    assert {moe[w].dtype for w in ("w_up", "w_gate", "w_down")} == {torch.bfloat16}
    assert tuple(moe["w_down"].shape) == (cfg.n_experts, cfg.d_ff, cfg.d_model)
