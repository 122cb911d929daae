"""The port's serving engine and sampler.

The port's ``Engine`` must emit the JAX ``Engine``'s greedy tokens, token for
token, on the same weights and prompts. That comparison is sound only where
no greedy step is a near tie: the test first measures every step's top-2
margin in the JAX logits and requires it to exceed twice the cross-framework
logit tolerance (2e-2 of the largest logit, the model tests' bound), so a
mismatch means a fault and not a bf16 rounding. At the JAX init's scale a
random model stays close to an identity map and mostly repeats a token,
which keeps the margins wide; with the layer weights scaled up the streams
vary but near ties appear within the tolerance. Non-greedy draws cannot
match ``jax.random``; the sampler is tested by its properties instead.

RWKV6 (rwkv6-7b's smoke config) and Griffin (recurrentgemma-2b's, whose
local window is 64 there) are held to the JAX engine where the first wave's
prompts are of one length, and, on a wave of unequal prompts, to JAX run on
each request alone at batch 1: the JAX wave runs a short prompt's pads
through its recurrent state, and past the window keeps the wave's last
positions in the ring rather than each prompt's own (``ROADMAP.md``, C4);
the port's does neither.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jax_models
from repro.configs import get_config as jax_get_config, smoke_config as jax_smoke
from repro.serving import Engine as JaxEngine, Request as JaxRequest
from repro_torch import models
from repro_torch.configs import ModelConfig
from repro_torch.models.lm import LM, unit_structure
from repro_torch.serving import engine as engine_mod
from repro_torch.serving import (Engine, Request, SamplingParams, sample,
                                 sample_per_request)

TOL = 2e-2


def _pair(arch):
    """(jax cfg, jax params, port cfg, port model) of the smoke config of
    `arch` on the same weights."""
    jcfg = jax_smoke(jax_get_config(arch))
    jparams = jax_models.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    model = LM(cfg, device="cpu")
    model.load_state_dict(models.params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module")
def setup():
    return _pair("qwen3-1.7b")


def rel_err(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def _prompts(n, vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, size=int(rng.integers(3, 12))).tolist()
            for _ in range(n)]


def _jax_greedy_margins(jcfg, jparams, prompt, n):
    """(tokens, top-2 margins, largest |logit|) of a batch-1 JAX greedy run."""
    prefill = jax.jit(lambda p, t, c: jax_models.prefill(jcfg, p, t, c))
    decode = jax.jit(lambda p, t, c: jax_models.decode_step(jcfg, p, t, c))
    cache = jax_models.init_cache(jcfg, 1, 64)
    lg, cache = prefill(jparams, jnp.asarray([prompt]), cache)
    toks, margins, big = [], [], 0.0
    for step in range(n):
        row = np.asarray(lg[0, :jcfg.vocab_size], np.float32)
        top2 = np.sort(row)[-2:]
        margins.append(float(top2[1] - top2[0]))
        big = max(big, float(np.abs(row).max()))
        toks.append(int(row.argmax()))
        if step + 1 < n:
            lg, cache = decode(jparams, jnp.asarray([toks[-1]]), cache)
    return toks, margins, big


def test_engine_greedy_matches_jax_engine(setup):
    """Five requests on two slots with staggered budgets: one wave prefill,
    then three refills by per-slot prefill and insert while the other slot
    decodes, all against the JAX engine."""
    _engine_matches_jax_engine(*setup)


def test_gpt3_engine_matches_jax_engine(monkeypatch):
    """The same schedule on gpt3-175b's smoke config (LayerNorm, GELU MLP,
    qkv bias, no RoPE), where the refilled slots decode at their own
    positions, so the sinusoidal rows must be taken at each slot's own
    ``pos``.

    Here the sinusoidal table (amplitude 1) swamps the token embeddings
    (scale 0.02), so a greedy stream follows the positions and its steps
    come within the logit tolerance of a tie: free greedy tokens could part
    on a rounding. So the port's engine is teacher-forced on the JAX
    engine's tokens (its sampler returns them) and every row of logits it
    sampled from, in its batched wave and refill schedule, is held against
    the JAX model's own logits for that request and step (batch 1, teacher-
    forced on the same tokens). A position taken from another slot or from
    the wave moves these logits far past the tolerance."""
    jcfg, jparams, cfg, model = _pair("gpt3-175b")
    _forced_engine_matches_jax_engine(monkeypatch, jcfg, jparams, cfg, model,
                                      _prompts(5, cfg.vocab_size))


def _teacher_force(monkeypatch, reqs, want):
    """Make the port engine's sampler return `want`'s tokens ({uid: tokens})
    for `reqs`; returns the dict that keeps every row of logits it sampled
    from, by (uid, step)."""
    by_sampling = {id(r.sampling): r for r in reqs}
    rows = {}

    def forced(logits, generator, sampling):
        out = []
        for row, sp in zip(logits, sampling):
            r = by_sampling[id(sp)]
            rows[r.uid, len(r.output)] = row.float().numpy()
            out.append(want[r.uid][len(r.output)])
        return torch.tensor(out, dtype=torch.int32)

    monkeypatch.setattr(engine_mod, "sample_per_request", forced)
    return rows


def _rows_match_jax_alone(jcfg, jparams, prompts, want, rows):
    """Every row the port's engine sampled from against the JAX model's own
    logits for that request and step (batch 1, teacher-forced on `want`)."""
    prefill = jax.jit(lambda p, t, c: jax_models.prefill(jcfg, p, t, c))
    decode = jax.jit(lambda p, t, c: jax_models.decode_step(jcfg, p, t, c))
    V = jcfg.vocab_size
    for uid, prompt in enumerate(prompts):
        cache = jax_models.init_cache(jcfg, 1, 64)
        lg, cache = prefill(jparams, jnp.asarray([prompt]), cache)
        for step, tok in enumerate(want[uid]):
            jrow = np.asarray(lg[0, :V], np.float32)
            assert rel_err(rows[uid, step][:V], jrow) < TOL, (uid, step)
            lg, cache = decode(jparams, jnp.asarray([tok]), cache)
    assert len(rows) == sum(len(t) for t in want.values())


def _forced_engine_matches_jax_engine(monkeypatch, jcfg, jparams, cfg, model,
                                      prompts):
    """Five requests on two slots, the port's engine teacher-forced on the
    JAX engine's tokens: the schedule, counters and final caches against
    the JAX engine's, every sampled row against JAX run per request."""
    n_new = [3, 8, 5, 6, 4]
    jeng = JaxEngine(jcfg, jparams, batch_size=2, max_len=64)
    jdone = jeng.run([JaxRequest(uid=i, prompt=p, max_new_tokens=n)
                      for i, (p, n) in enumerate(zip(prompts, n_new))])
    want = {r.uid: r.output for r in jdone}
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n, sampling=SamplingParams())
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    rows = _teacher_force(monkeypatch, reqs, want)
    _check_engine(jeng, jdone, cfg, model, reqs, n_new)
    _rows_match_jax_alone(jcfg, jparams, prompts, want, rows)


def _engine_matches_jax_engine(jcfg, jparams, cfg, model, prompts=None):
    if prompts is None:
        prompts = _prompts(5, cfg.vocab_size)
    n_new = [3, 8, 5, 6, 4]
    for p, n in zip(prompts, n_new):
        toks, margins, big = _jax_greedy_margins(jcfg, jparams, p, n)
        assert min(margins) > 2 * TOL * big, (p, margins, big)
    jeng = JaxEngine(jcfg, jparams, batch_size=2, max_len=64)
    jdone = jeng.run([JaxRequest(uid=i, prompt=p, max_new_tokens=n)
                      for i, (p, n) in enumerate(zip(prompts, n_new))])
    _check_engine(jeng, jdone, cfg, model,
                  [Request(uid=i, prompt=p, max_new_tokens=n)
                   for i, (p, n) in enumerate(zip(prompts, n_new))], n_new)


def _check_engine(jeng, jdone, cfg, model, reqs, n_new):
    """Serve `reqs` on the port's engine (two slots, so three refills) and
    hold its tokens, counters, final K/V and positions to the JAX engine's."""
    eng = Engine(cfg, model, batch_size=2, max_len=64, device="cpu")
    inserts = []
    insert = eng._insert
    eng._insert = lambda one, slot: (inserts.append(slot), insert(one, slot))
    done = eng.run(reqs)
    assert inserts == [0, 0, 1]
    want = {r.uid: r.output for r in jdone}
    got = {r.uid: r.output for r in done}
    assert got == want
    assert [len(got[i]) for i in range(5)] == n_new
    assert len({tuple(o) for o in got.values()}) == 5
    assert eng.stats["tokens_out"] == sum(n_new) == jeng.stats["tokens_out"]
    assert eng.stats["steps"] == jeng.stats["steps"]
    # the refilled slots' caches (K/V, Griffin's RG-LRU state and conv
    # carry, or RWKV6's state and token shifts) and positions, as the JAX
    # engine left them (the tokens alone would not show a misplaced cache:
    # at this init scale the model's greedy stream hardly depends on its
    # context)
    jcache = _jax_cache_by_kind(cfg, jeng.cache)
    assert eng.cache["pos"].tolist() == np.asarray(jeng.cache["pos"]).tolist()
    assert set(eng.cache) == set(jcache) | {"pos"}
    for name, want in jcache.items():
        assert rel_err(eng.cache[name].float().numpy(), want) < TOL, name


def _jax_cache_by_kind(cfg, jcache):
    """The JAX cache's stacked units and remainder in the port's layout: each
    leaf name's per-layer entries stacked in layer order (the layers of one
    kind), fp32 numpy."""
    unit, n_units, rem = unit_structure(cfg)
    per_layer = [jax.tree.map(lambda a, r=r: a[r], jcache["units"][f"u{j}"])
                 for r in range(n_units) for j in range(len(unit))]
    per_layer += [jcache["rem"][f"r{j}"] for j in range(len(rem))]
    names = {name for leaves in per_layer for name in leaves}
    return {name: np.stack([np.asarray(leaves[name], np.float32) for leaves in per_layer
                            if name in leaves]) for name in names}


@pytest.fixture(scope="module")
def rwkv_setup():
    return _pair("rwkv6-7b")


def test_rwkv6_engine_matches_jax_engine_on_an_equal_length_wave(monkeypatch,
                                                                 rwkv_setup):
    """The first wave's two prompts of one length (where the JAX wave is
    right), then three refills of other lengths, against the JAX engine:
    the schedule, counters and the slots' final states and token shifts.
    The smoke model's greedy steps come within the logit tolerance of a tie,
    so, as for gpt3, the port's engine is teacher-forced on the JAX engine's
    tokens and every row it sampled from is held against JAX's logits for
    that request and step."""
    jcfg, jparams, cfg, model = rwkv_setup
    prompts = _prompts(5, cfg.vocab_size)
    prompts[1] = prompts[1][:len(prompts[0])] + prompts[0][len(prompts[1]):]
    assert len(prompts[0]) == len(prompts[1]) != len(prompts[2])
    _forced_engine_matches_jax_engine(monkeypatch, jcfg, jparams, cfg, model,
                                      prompts)


def test_rwkv6_engine_on_an_unequal_wave_matches_jax_per_request(monkeypatch,
                                                                 rwkv_setup):
    """Four prompts of 3-11 tokens on four slots in one right-padded wave,
    then decode, teacher-forced on the greedy tokens of JAX run on each
    request alone at batch 1: every row the engine sampled from against
    JAX's logits for that request and step. A pad run through a short
    prompt's state (C4) moves its rows far past the tolerance."""
    jcfg, jparams, cfg, model = rwkv_setup
    prompts = _prompts(4, cfg.vocab_size)
    assert len({len(p) for p in prompts}) > 1
    n_new = [6, 4, 5, 7]
    want = {i: _jax_greedy_margins(jcfg, jparams, p, n)[0]
            for i, (p, n) in enumerate(zip(prompts, n_new))}
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    rows = _teacher_force(monkeypatch, reqs, want)
    eng = Engine(cfg, model, batch_size=4, max_len=64, device="cpu")
    done = eng.run(reqs)
    assert {r.uid: r.output for r in done} == want
    assert eng.stats["tokens_out"] == sum(n_new)
    assert eng.stats["steps"] == max(n_new) - 1
    _rows_match_jax_alone(jcfg, jparams, prompts, want, rows)


@pytest.fixture(scope="module")
def griffin_setup():
    return _pair("recurrentgemma-2b")


def test_griffin_engine_matches_jax_engine_on_an_equal_length_wave(monkeypatch,
                                                                   griffin_setup):
    """recurrentgemma-2b's smoke config (RG-LRU and local-attention layers,
    gated GELU): the first wave's two prompts of one length, then three
    refills of other lengths, against the JAX engine, teacher-forced on its
    tokens: the schedule, counters, every sampled row against JAX per
    request, and the slots' final ring K/V, RG-LRU state and conv carry."""
    jcfg, jparams, cfg, model = griffin_setup
    prompts = _prompts(5, cfg.vocab_size)
    prompts[1] = prompts[1][:len(prompts[0])] + prompts[0][len(prompts[1]):]
    assert len(prompts[0]) == len(prompts[1]) != len(prompts[2])
    _forced_engine_matches_jax_engine(monkeypatch, jcfg, jparams, cfg, model,
                                      prompts)


def test_griffin_engine_on_an_unequal_wave_matches_jax_per_request(monkeypatch,
                                                                   griffin_setup):
    """Four prompts of 3-11 tokens in one right-padded wave on four slots,
    then decode, teacher-forced on JAX's greedy tokens for each request
    alone: every row the engine sampled from against JAX's logits for that
    request and step (the pads must stay out of h and the conv carry)."""
    jcfg, jparams, cfg, model = griffin_setup
    prompts = _prompts(4, cfg.vocab_size)
    assert len({len(p) for p in prompts}) > 1
    n_new = [6, 4, 5, 7]
    want = {i: _jax_greedy_margins(jcfg, jparams, p, n)[0]
            for i, (p, n) in enumerate(zip(prompts, n_new))}
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    rows = _teacher_force(monkeypatch, reqs, want)
    eng = Engine(cfg, model, batch_size=4, max_len=64, device="cpu")
    done = eng.run(reqs)
    assert {r.uid: r.output for r in done} == want
    _rows_match_jax_alone(jcfg, jparams, prompts, want, rows)


def test_griffin_engine_serves_prompts_past_the_window(monkeypatch, griffin_setup):
    """Prompts of 70-100 tokens, past the smoke window of 64, on two slots
    of a 128-token budget (a ring of 64): a wave of two unequal prompts and
    a refill, each decoding past its ring's wrap, teacher-forced on JAX's
    greedy tokens for each request alone; every sampled row against JAX's
    logits for that request and step. The ring must hold each prompt's own
    last 64 keys and each refill's ring must land in its slot."""
    jcfg, jparams, cfg, model = griffin_setup
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist() for n in (100, 70, 83)]
    n_new = [5, 9, 6]
    want = {i: _jax_greedy_margins(jcfg, jparams, p, n)[0]
            for i, (p, n) in enumerate(zip(prompts, n_new))}
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, n_new))]
    rows = _teacher_force(monkeypatch, reqs, want)
    eng = Engine(cfg, model, batch_size=2, max_len=128, device="cpu")
    inserts = []
    insert = eng._insert
    eng._insert = lambda one, slot: (inserts.append(slot), insert(one, slot))
    done = eng.run(reqs)
    assert inserts == [0] and eng.cache["k"].shape[2] == 64
    assert {r.uid: r.output for r in done} == want
    _rows_match_jax_alone(jcfg, jparams, prompts, want, rows)


def test_engine_greedy_matches_step_by_step(setup):
    """Engine generation for one request == a manual prefill+decode loop."""
    _, _, cfg, model = setup
    prompt = [3, 1, 4, 1, 5]
    eng = Engine(cfg, model, batch_size=1, max_len=64, device="cpu")
    [req] = eng.run([Request(uid=0, prompt=prompt, max_new_tokens=4)])
    cache = models.init_cache(cfg, 1, 64, device="cpu")
    lg = model.prefill(torch.tensor([prompt]), cache)
    toks = [int(lg[0].argmax())]
    for _ in range(3):
        lg = model.decode_step(torch.tensor([toks[-1]]), cache)
        toks.append(int(lg[0].argmax()))
    assert req.output == toks


def test_engine_eos_stops(setup):
    _, _, cfg, model = setup
    cache = models.init_cache(cfg, 1, 64, device="cpu")
    eos = int(model.prefill(torch.tensor([[1, 2]]), cache)[0].argmax())
    eng = Engine(cfg, model, batch_size=1, max_len=64, device="cpu")
    [req] = eng.run([Request(uid=0, prompt=[1, 2], max_new_tokens=10,
                             eos_id=eos)])
    assert req.done and req.output == [eos]


def test_engine_greedy_next_to_sampled_request(setup):
    """A greedy request keeps its solo output when batched next to a
    temperature>0 request, in either slot order."""
    _, _, cfg, model = setup
    prompt = [3, 1, 4]
    solo = Engine(cfg, model, batch_size=1, max_len=64, device="cpu").run(
        [Request(uid=0, prompt=prompt, max_new_tokens=6)])[0].output
    hot = SamplingParams(temperature=1.5, top_k=8)
    for order in (0, 1):
        reqs = [Request(uid=0, prompt=[9, 8, 7], max_new_tokens=6, sampling=hot),
                Request(uid=1, prompt=prompt, max_new_tokens=6)]
        if order:
            reqs.reverse()
        done = Engine(cfg, model, batch_size=2, max_len=64, device="cpu").run(reqs)
        assert next(r for r in done if r.uid == 1).output == solo


# ---------------- sampler properties ----------------

def _gen(seed=0):
    return torch.Generator("cpu").manual_seed(seed)


def test_top_k_support():
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 50))
                              .astype(np.float32)).repeat(2000, 1)
    out = sample(logits, _gen(), SamplingParams(temperature=1.0, top_k=3))
    top3 = set(torch.topk(logits[0], 3).indices.tolist())
    assert set(out.tolist()) == top3


def test_top_p_cutoff():
    probs = torch.tensor([0.05, 0.5, 0.15, 0.3])
    logits = probs.log().repeat(4000, 1)
    out = sample(logits, _gen(), SamplingParams(temperature=1.0, top_p=0.7))
    assert set(out.tolist()) == {1, 3}          # 0.5 + 0.3 reaches 0.7
    share = (out == 1).float().mean().item()
    assert abs(share - 0.5 / 0.8) < 0.05


def test_greedy_rows_consume_no_randomness():
    logits = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 30))
                              .astype(np.float32))
    g = _gen(7)
    before = g.get_state()
    out = sample_per_request(logits, g, [SamplingParams()] * 4)
    assert torch.equal(g.get_state(), before)
    assert out.tolist() == logits.argmax(-1).tolist()
    mixed = [SamplingParams(), SamplingParams(temperature=1.0),
             SamplingParams(), SamplingParams(temperature=1.0)]
    out = sample_per_request(logits, g, mixed)
    assert out[0] == logits[0].argmax() and out[2] == logits[2].argmax()
    assert out.dtype == torch.int32


def test_generator_reproducibility():
    logits = torch.zeros(64, 100)
    p = SamplingParams(temperature=1.0)
    a = sample(logits, _gen(5), p)
    b = sample(logits, _gen(5), p)
    c = sample(logits, _gen(6), p)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_sample_per_request_checks_rows():
    with pytest.raises(ValueError):
        sample_per_request(torch.zeros(2, 5), _gen(), [SamplingParams()])
