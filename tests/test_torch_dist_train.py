"""The port's sharded train step (tensor and data parallel on local shards,
``distributed.sharding``) on gloo worlds of CPU ranks, against the JAX
package's single-device step (ROADMAP C3: its 8-device pjit step fails, and
sharding changes no value in JAX, only the order of sums).

Configs: qwen2 (qkv bias, GQA), qwen3 (qk-norm), stablelm (layernorm,
untied head), gpt3 (GELU, sinusoidal positions), granite and grok (MoE,
grok's softcap; the JAX routing recorded and replayed, ``_torch_routing``),
at smoke size; meshes (data, model) = (2, 1), (1, 2), (2, 2) and (1, 4) (at
model 4 the 2 kv heads replicate: the GQA rule), and two microbatches on
(2, 2). The same weights (``params_from_jax``) and the same masked batch go
to both sides; each world runs every config and mesh once in a
module-scoped fixture (``_torch_dist``), and the tests read its files.

Tolerances as ``test_torch_training.py``: the loss and its parts within
2e-2, every gathered gradient within 2e-2 relative Frobenius norm (a key
bias's without RoPE, 0 in exact arithmetic, below 2e-2 of its query
bias's; RoPE rotates the bias by position, so there it is held by the
ratio; a vision cross layer's scalar ``xgate``, whose microbatches'
gradients can cancel in their mean, within 2e-2 of the mean of the
microbatches' own norms), and the
master copy after one AdamW update within 2e-5 of the JAX update on the
same (gathered) gradients: the sharded step's gradient norm and clipping
are the whole model's.
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
from repro.models import layers as jax_layers
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import needs_frontend
from repro_torch.models.bridge import params_from_jax, params_to_jax, to_tensor

import _torch_dist

TOL = 2e-2
TP_ARCHS = ("qwen2-0.5b", "qwen3-1.7b", "stablelm-1.6b", "gpt3-175b", "granite-moe-3b-a800m",
            "grok-1-314b")
MESHES = ((2, 1), (1, 2), (2, 2), (1, 4))
CASES = [(a, m, 1) for a in TP_ARCHS for m in MESHES] + [(a, (2, 2), 2) for a in TP_ARCHS]
B, S = 4, 16     # microbatches of 2 rows: the one-microbatch cases take rows 0-1
# the single-rank tests' lengths, where they are longer: past a wkv chunk
# of 64 steps (test_torch_train_rwkv), past recurrentgemma's window of 64
# (test_torch_train_hybrid)
SEQ = {"rwkv6-7b": 96, "recurrentgemma-2b": 128}


def rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def make_batch(cfg, arch, seed=3):
    rng = np.random.default_rng(seed)
    S_ = SEQ.get(arch, S)
    tok = rng.integers(0, cfg.vocab_size, size=(B, S_ + 1)).astype(np.int32)
    mask = (rng.random((B, S_)) > 0.2).astype(np.float32)
    fe = None
    if needs_frontend(cfg):
        fe = np.asarray(jnp.asarray(rng.standard_normal((B, cfg.n_frontend_tokens,
                                                         cfg.d_model)), jnp.bfloat16))
    return tok[:, :-1], tok[:, 1:], mask, fe


def jax_weights(arch, prepare=None):
    """(JAX config, JAX params passed through `prepare`, a map of the numpy
    tree, where given; port config)."""
    jcfg = jax_smoke(jax_get_config(arch))
    jparams = jax_models.init_params(jcfg, jax.random.PRNGKey(1))
    if prepare is not None:
        jparams = jax.tree.map(jnp.asarray, prepare(jparams))
    return jcfg, jparams, smoke_config(get_config(arch))


def jax_reference(jcfg, jparams, cfg, arch, microbatch_sets):
    """For each set of rows (one per microbatch) the loss, metrics and
    gradients of the JAX single-device step (a microbatched step averages
    its microbatches' gradients and losses, as the JAX scan does), each
    microbatch's forward routing records, and each microbatch's gradients."""
    tokens, targets, mask, fe = make_batch(cfg, arch)
    records, moe_apply = [], jax_layers.moe_apply

    def recorded(c, p, x, capacity_factor=1.25):
        logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p["router"]
        _, idx = lax.top_k(jax.nn.softmax(logits, axis=-1), c.top_k)
        jax.debug.callback(lambda i, lg: records.append((np.asarray(i), np.asarray(lg))),
                           idx, logits, ordered=True)
        return moe_apply(c, p, x, capacity_factor)

    jax_layers.moe_apply = recorded
    try:
        def jloss(p, t, tg, mk, f):
            return jax_models.loss_fn(jcfg, p, t, tg, mask=mk, frontend=f)
        fn = jax.jit(jax.value_and_grad(jloss, has_aux=True))
        out = []
        for rows in microbatch_sets:
            lvs, gs, mets, recs = [], [], [], []
            for r in rows:
                del records[:]
                (lv, met), g = fn(jparams, *(None if a is None else jnp.asarray(a[r])
                                             for a in (tokens, targets, mask, fe)))
                jax.effects_barrier()
                recs += records[:cfg.n_layers]     # the forward's calls, not the remat's
                lvs.append(float(lv))
                mets.append({k: float(v) for k, v in met.items()})
                gs.append(g)
            grads = jax.tree.map(lambda *x: sum(np.asarray(a, np.float32) for a in x) / len(x),
                                 *gs)
            out.append((float(np.mean(lvs)), mets[0] if len(rows) == 1 else None, grads,
                        recs if cfg.n_experts else None,
                        [jax.tree.map(lambda a: np.asarray(a, np.float32), g) for g in gs]))
    finally:
        jax_layers.moe_apply = moe_apply
    return out


MB_ROWS = ([slice(0, 2)], [slice(0, 2), slice(2, 4)])


def run_cases(tmp, cases_by_arch, worlds, prepare=None):
    """The JAX reference of every arch of `cases_by_arch` ({arch: [(mesh,
    microbatches)]}) and the port's results, from one world per entry of
    `worlds` ((ranks, meshes)); returns (references, the results' dir).
    The MoE configs' references come first (the workers replay their JAX
    routing); the others' are computed while the worlds run."""
    refs, cases, later = {}, {}, []
    for arch in cases_by_arch:
        jcfg, jparams, cfg = jax_weights(arch, prepare)
        out = jax_reference(jcfg, jparams, cfg, arch, MB_ROWS) if cfg.n_experts else None
        state = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
        refs[arch] = [jcfg, jparams, cfg, out, state]
        if out is None:
            later.append(arch)
        tok, tgt, mask, fe = make_batch(cfg, arch)
        for mb, rows in ((1, slice(0, 2)), (2, slice(0, 4))):
            cases[f"{arch}_mb{mb}"] = {
                "cfg": cfg, "state": state, "microbatches": mb,
                "frontend": needs_frontend(cfg),
                "records": out[mb - 1][3] if out is not None else None,
                "meshes": [m for m, n in cases_by_arch[arch] if n == mb],
                "batch": {"tokens": torch.from_numpy(tok[rows]),
                          "targets": torch.from_numpy(tgt[rows]),
                          "mask": torch.from_numpy(mask[rows]),
                          "frontend": None if fe is None else to_tensor(fe[rows])}}
    path = tmp / "cases.pt"
    torch.save(cases, path)
    ctxs = [_torch_dist.start_world(tmp, n, "train_worker", str(path), meshes, str(tmp))
            for n, meshes in worlds]
    for arch in later:
        refs[arch][3] = jax_reference(*refs[arch][:3], arch, MB_ROWS)
    for ctx in ctxs:
        _torch_dist.join_world(ctx)
    return refs, tmp


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case's JAX reference and port result: two ranks for (2, 1) and
    (1, 2), four for (2, 2) and (1, 4)."""
    by_arch = {a: [(m, n) for b, m, n in CASES if b == a] for a in TP_ARCHS}
    return run_cases(tmp_path_factory.mktemp("dist_train"), by_arch,
                     ((2, [(2, 1), (1, 2)]), (4, [(2, 2), (1, 4)])))


def grads_by_name(cfg, jgrads):
    tree = jax.tree.map(lambda g: np.asarray(g, np.float32), jgrads)
    return {n: t.numpy() for n, t in params_from_jax(cfg, tree).items()}


@pytest.mark.parametrize("arch,mesh,microbatches", CASES,
                         ids=[f"{a}-{m[0]}x{m[1]}-mb{n}" for a, m, n in CASES])
def test_sharded_step_matches_jax_single_device(results, arch, mesh, microbatches):
    check(results, arch, mesh, microbatches)


def check(results, arch, mesh, microbatches, tol=TOL):
    """The port's case against the JAX reference (see the module's note),
    the loss, its parts and the gradients within `tol`."""
    refs, tmp = results
    jcfg, jparams, cfg, out, _ = refs[arch]
    jloss, jmet, jgrads, _, jparts = out[microbatches - 1]
    got = torch.load(tmp / f"{arch}_mb{microbatches}_{mesh[0]}x{mesh[1]}.pt",
                     weights_only=False)
    want = grads_by_name(cfg, jgrads)
    assert abs(got["loss"] - jloss) < tol * max(1.0, abs(jloss))
    if jmet is not None:
        for k in ("ce", "z_loss", "aux", "tokens"):
            assert abs(got["met"][k] - jmet[k]) < tol * max(1.0, abs(jmet[k])), k
        assert (jmet["aux"] > 0) == bool(cfg.n_experts)
    assert set(want) == set(got["grads"])
    for n, g in got["grads"].items():
        g = g.float().numpy()
        if n.endswith(".bk") and not cfg.rope_fraction:
            # without RoPE 0 in exact arithmetic (test_torch_train_configs)
            scale = np.linalg.norm(want[n[:-1] + "q"])
            assert max(np.linalg.norm(g), np.linalg.norm(want[n])) < tol * scale, n
            continue
        if n.endswith(".xgate"):
            # a scalar, each microbatch's a sum over every token and channel
            # that nearly cancels, and the microbatches' can cancel in their
            # mean too: held to the mean of the microbatches' own norms (with
            # one microbatch, the plain rule)
            scale = np.mean([np.linalg.norm(grads_by_name(cfg, p)[n]) for p in jparts])
            assert np.linalg.norm(g - want[n]) < tol * scale, (n, g, want[n], scale)
            continue
        assert rel_fro(g, want[n]) < tol, (n, rel_fro(g, want[n]))
    # one AdamW update on the gathered gradients, in JAX: the sharded step's
    # norm, clipping and decay are the single-device step's
    jopt = jt.AdamW(lr=jt.constant_schedule(1e-2), weight_decay=0.1)
    jg = params_to_jax(cfg, {n: g.float() for n, g in got["grads"].items()})
    jg = {k: v for k, v in jg.items() if k in jparams}     # no empty remainder
    jg = jax.tree.map(lambda a, p: jnp.asarray(a, jnp.float32).reshape(p.shape), jg, jparams)
    _, jst, jstats = jopt.update(jg, jopt.init(jparams), jparams)
    assert abs(got["grad_norm"] - float(jstats["grad_norm"])) < 2e-5 * float(jstats["grad_norm"])
    master = params_from_jax(cfg, jax.tree.map(lambda a: np.asarray(a, np.float32),
                                               jst.master))
    for n, m in got["master"].items():
        w = master[n].numpy()
        assert np.abs(m.numpy() - w).max() <= 2e-5 * max(1.0, np.abs(w).max()), n
