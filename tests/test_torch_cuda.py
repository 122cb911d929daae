"""The port's hand-written kernels and model on a CUDA card.

Every test here is marked ``cuda`` and skips on a host without a card. The
file imports neither JAX nor the JAX package, so it also runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.) Each kernel is held
against its plain PyTorch version on the same card tensors, and the model's
kernel path against its plain path on the CPU, at the kernel tests'
tolerances: relative error to the largest output below 2e-2 in bf16 and
2e-5 in fp32. In bf16 each kernel is also held element by element: the
Triton kernels within one bf16 rounding, the attention kernels within
2^-6 |b| + 2^-5 of the rms of b's row (the bound ``chip_smoke.py`` derives
in ``attention_excess``). The WKV kernel takes fp32 only and is held to 1e-4,
the JAX wkv tests' bound, since its sums run in another order.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.kernels as TK
from repro_torch import models
from repro_torch.configs import ARCHS, EXTRA_ARCHS, get_config, smoke_config
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gelu.ref import gelu_ref, silu_mul_ref
from repro_torch.kernels.rmsnorm.ref import layernorm_ref, rmsnorm_ref
from repro_torch.kernels.wkv.ref import wkv_ref
from repro_torch.models.lm import LM
from repro_torch.serving import Engine, Request
from repro_torch.serving import engine as engine_mod

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 references in fp32
    return torch.device("cuda")


def rel_err(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-9)).item()


def attention_excess(a, b):
    """Largest |a - b| / (2^-6 |b| + 2^-5 rms(b's row over D)); <= 1 passes."""
    a, b = a.float().cpu(), b.float().cpu()
    rms = b.pow(2).mean(-1, keepdim=True).sqrt()
    return ((a - b).abs() / (2.0 ** -6 * b.abs() + 2.0 ** -5 * rms)).max().item()


def normal(seed, shape, device, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device, dtype)


def kernel_case(name, device, dtype):
    """(args, plain version) at small shapes with ragged edges."""
    def t(seed, shape):
        return normal(seed, shape, device, dtype)
    if name == "rmsnorm":
        return (t(0, (100, 512)), t(1, (512,)).float()), rmsnorm_ref
    if name == "layernorm":
        return (t(0, (90, 384)) * 3 + 1, t(1, (384,)).float(),
                t(2, (384,)).float()), layernorm_ref
    if name == "gelu":
        return (t(0, (100, 256)) * 4,), gelu_ref
    if name == "silu_mul":
        return (t(0, (100, 256)), t(1, (100, 256))), silu_mul_ref
    if name == "flash_attention":
        return (t(0, (2, 8, 130, 64)), t(1, (2, 2, 130, 64)),
                t(2, (2, 2, 130, 64))), attention_ref
    lens = torch.tensor([200, 100, 66], dtype=torch.int32, device=device)
    return (t(0, (3, 1, 8, 64)), t(1, (3, 200, 1, 64)), t(2, (3, 200, 1, 64)),
            lens), decode_attention_ref


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(set(TK.KERNELS) - {"wkv"}))
def test_kernel_matches_plain_on_card(cuda, name, dtype):
    args, plain = kernel_case(name, cuda, DTYPES[dtype])
    before = TK.KERNELS[name].launches
    got = TK.KERNELS[name](*args)
    torch.cuda.synchronize()
    assert TK.KERNELS[name].launches == before + 1
    want = plain(*args)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert rel_err(got, want) < TOL[dtype]
    if name in ("rmsnorm", "layernorm", "gelu", "silu_mul") and dtype == "bfloat16":
        # one rounding apart at most, element by element
        g, w = got.float(), want.float()
        assert ((g - w).abs() <= 2.0 ** -7 * w.abs() + 1e-3).all()
    if name in ("flash_attention", "decode_attention") and dtype == "bfloat16":
        assert attention_excess(got, want) <= 1


# (B, T, H, N, lengths or None, nonzero state0): the JAX kernel tests' rows
# (u tiled over the heads), a T that is no multiple of the kernel's chunk,
# the served prefill's heads with prompt lengths, and the decode step
WKV_CASES = [(2, 96, 2, 32, None, False), (2, 100, 2, 32, None, False),
             (3, 77, 4, 64, [77, 40, 1], True), (2, 70, 3, 32, [70, 33], True),
             (8, 160, 64, 64, [160, 128, 33, 97, 1, 150, 64, 159], False),
             (8, 1, 64, 64, None, True)]


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv_matches_plain_on_card(cuda, case):
    B, T, H, N, lens, with_state = case
    r, k, v = (normal(i, (B, T, H, N), cuda, torch.float32) for i in range(3))
    w = torch.sigmoid(normal(3, (B, T, H, N), cuda, torch.float32)) * 0.5 + 0.45
    u = normal(4, (H, N), cuda, torch.float32)
    s0 = normal(5, (B, H, N, N), cuda, torch.float32) if with_state else None
    lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                     device=cuda)
    want_out, want_state = wkv_ref(r, k, v, w, u, s0, lengths)
    before = TK.KERNELS["wkv"].launches
    if with_state:     # in place, as the decode step updates its cache
        state_in = s0.clone()
        out, state = TK.KERNELS["wkv"](r, k, v, w, u, state_in, lengths,
                                       state_out=state_in)
        assert state is state_in
    else:
        out, state = TK.KERNELS["wkv"](r, k, v, w, u, None, lengths)
    torch.cuda.synchronize()
    assert TK.KERNELS["wkv"].launches == before + 1
    assert out.shape == (B, T, H, N) and state.shape == (B, H, N, N)
    assert rel_err(out, want_out) < 1e-4 and rel_err(state, want_state) < 1e-4
    for b, n in enumerate(lens or []):
        assert not out[b, n:].any()


def test_rwkv6_launches_per_step_on_card(cuda):
    """2L+1 LayerNorms and L wkv launches per prefill and per decode step,
    and no attention kernel."""
    cfg = dataclasses.replace(smoke_config(get_config("rwkv6-7b")), n_layers=3)
    model = models.init_params(cfg, seed=0, device=cuda)
    cache = models.init_cache(cfg, 2, 32, device=cuda)
    toks = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    want = {name: 0 for name in TK.KERNELS}
    want.update(layernorm=7, wkv=3)
    TK.reset_launches()
    model.prefill(toks, cache, torch.tensor([8, 5], dtype=torch.int32, device=cuda))
    assert TK.launches() == want
    TK.reset_launches()
    model.decode_step(toks[:, 0], cache)
    assert TK.launches() == want


# (query heads, kv-heads, d_head) of the served models
SERVED_HEADS = {"qwen3-1.7b": (16, 8, 128), "stablelm-1.6b": (32, 32, 64),
                "gpt3-175b": (96, 96, 128)}


@pytest.mark.parametrize("arch", sorted(SERVED_HEADS))
def test_attention_served_head_layouts_on_card(cuda, arch):
    """Flash (causal, 384 tokens) and decode (mixed cache lengths) attention
    in bf16 at each served model's head layout, element by element."""
    hq, hkv, d = SERVED_HEADS[arch]
    q = normal(0, (2, hq, 384, d), cuda, torch.bfloat16)
    k = normal(1, (2, hkv, 384, d), cuda, torch.bfloat16)
    v = normal(2, (2, hkv, 384, d), cuda, torch.bfloat16)
    got = TK.KERNELS["flash_attention"](q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    assert rel_err(got, want) < TOL["bfloat16"]
    assert attention_excess(got, want) <= 1
    qd = normal(3, (3, hkv, hq // hkv, d), cuda, torch.bfloat16)
    kd = normal(4, (3, 640, hkv, d), cuda, torch.bfloat16)
    vd = normal(5, (3, 640, hkv, d), cuda, torch.bfloat16)
    lens = torch.tensor([640, 333, 129], dtype=torch.int32, device=cuda)
    got = TK.KERNELS["decode_attention"](qd, kd, vd, lens)
    want = decode_attention_ref(qd, kd, vd, lens)
    assert rel_err(got, want) < TOL["bfloat16"]
    assert attention_excess(got, want) <= 1


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("r,c", [(5, 12288), (3, 10000)])
def test_layernorm_wide_rows_on_card(cuda, r, c, dtype):
    """Rows wider than one chunk (gpt3's 12288, and a ragged last chunk),
    off zero mean, against the plain version."""
    x = normal(0, (r, c), cuda, DTYPES[dtype]) * 3 + 50
    g, b = normal(1, (c,), cuda, torch.float32), normal(2, (c,), cuda, torch.float32)
    got = TK.KERNELS["layernorm"](x, g, b)
    want = layernorm_ref(x, g, b)
    assert got.dtype == x.dtype and rel_err(got, want) < TOL[dtype]


@pytest.mark.parametrize("window,cap", [(0, 0.0), (32, 0.0), (0, 30.0)])
def test_flash_attention_model_layout_views_on_card(cuda, window, cap):
    """(B, S, H, D) tensors passed as transposed views, with the window and
    softcap masks, as the model would."""
    q = normal(0, (2, 96, 4, 128), cuda, torch.bfloat16)
    k = normal(1, (2, 96, 2, 128), cuda, torch.bfloat16)
    v = normal(2, (2, 96, 2, 128), cuda, torch.bfloat16)
    got = models.layers.flash_attention(q, k, v, causal=True, window=window,
                                        logit_softcap=cap)
    want = models.layers.attention_reference(q, k, v, causal=True, window=window,
                                             logit_softcap=cap)
    assert got.shape == (2, 96, 4, 128)
    assert rel_err(got, want) < TOL["bfloat16"]


@pytest.mark.parametrize("arch", sorted(ARCHS) + sorted(EXTRA_ARCHS))
def test_model_on_card_matches_cpu(cuda, arch):
    """Forward, prefill and decode logits of the kernel path on the card
    against the plain path on the CPU, on the same weights."""
    cfg = smoke_config(get_config(arch))
    cpu = models.init_params(cfg, seed=0, device="cpu")
    gpu = LM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 12), dtype=np.int32))
    lens = torch.tensor([12, 7, 3], dtype=torch.int32)
    V = cfg.vocab_size
    assert rel_err(gpu(toks.to(cuda))[..., :V], cpu(toks)[..., :V]) < TOL["bfloat16"]
    cg = models.init_cache(cfg, 3, 32, device=cuda)
    cc = models.init_cache(cfg, 3, 32, device="cpu")
    lg = gpu.prefill(toks.to(cuda), cg, lens.to(cuda))
    lc = cpu.prefill(toks, cc, lens)
    assert rel_err(lg[:, :V], lc[:, :V]) < TOL["bfloat16"]
    for step in range(3):
        tok = toks[:, step]
        lg = gpu.decode_step(tok.to(cuda), cg)
        lc = cpu.decode_step(tok, cc)
        assert rel_err(lg[:, :V], lc[:, :V]) < TOL["bfloat16"]
    assert cg["pos"].tolist() == cc["pos"].tolist()


def test_launches_per_step_on_card(cuda):
    cfg = dataclasses.replace(smoke_config(get_config("qwen3-1.7b")), n_layers=3)
    model = models.init_params(cfg, seed=0, device=cuda)
    cache = models.init_cache(cfg, 2, 32, device=cuda)
    toks = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    TK.reset_launches()
    model.prefill(toks, cache)
    assert TK.launches() == {"rmsnorm": 13, "layernorm": 0, "gelu": 0,
                             "silu_mul": 3, "flash_attention": 3,
                             "decode_attention": 0, "wkv": 0}
    TK.reset_launches()
    model.decode_step(toks[:, 0], cache)
    assert TK.launches() == {"rmsnorm": 13, "layernorm": 0, "gelu": 0,
                             "silu_mul": 3, "flash_attention": 0,
                             "decode_attention": 3, "wkv": 0}


@pytest.mark.parametrize("arch,gate", [("stablelm-1.6b", "silu_mul"),
                                       ("gpt3-175b", "gelu")])
def test_layernorm_launches_per_step_on_card(cuda, arch, gate):
    """2L+1 LayerNorms and L MLP activations per step, no RMSNorm."""
    cfg = dataclasses.replace(smoke_config(get_config(arch)), n_layers=3)
    model = models.init_params(cfg, seed=0, device=cuda)
    cache = models.init_cache(cfg, 2, 32, device=cuda)
    toks = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    other = ({"gelu", "silu_mul"} - {gate}).pop()
    TK.reset_launches()
    model.prefill(toks, cache)
    assert TK.launches() == {"rmsnorm": 0, "layernorm": 7, gate: 3, other: 0,
                             "flash_attention": 3, "decode_attention": 0, "wkv": 0}
    TK.reset_launches()
    model.decode_step(toks[:, 0], cache)
    assert TK.launches() == {"rmsnorm": 0, "layernorm": 7, gate: 3, other: 0,
                             "flash_attention": 0, "decode_attention": 3, "wkv": 0}


def test_engine_on_card_matches_cpu(cuda):
    """Greedy serving on the card, with staggered budgets so that freed
    slots are refilled by per-slot prefill and insert, emits the CPU
    engine's tokens (the smoke model at its init scale decodes with wide
    top-2 margins)."""
    cfg = smoke_config(get_config("qwen3-1.7b"))
    cpu = models.init_params(cfg, seed=0, device="cpu")
    gpu = LM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(3, 12, size=5)]
    n_new = [3, 8, 5, 6, 4]

    def serve(model, device):
        eng = Engine(cfg, model, batch_size=2, max_len=64, device=device)
        inserts = []
        insert = eng._insert
        eng._insert = lambda one, slot: (inserts.append(slot), insert(one, slot))
        done = eng.run([Request(uid=i, prompt=p, max_new_tokens=n)
                        for i, (p, n) in enumerate(zip(prompts, n_new))])
        assert inserts == [0, 0, 1]
        return {r.uid: r.output for r in done}, eng.cache

    # no greedy step of the CPU run is a near tie within the logit tolerance
    for p, n in zip(prompts, n_new):
        cache = models.init_cache(cfg, 1, 64, device="cpu")
        lg = cpu.prefill(torch.tensor([p]), cache)
        for _ in range(n):
            row = lg[0, :cfg.vocab_size].float()
            top2 = row.topk(2).values
            assert top2[0] - top2[1] > 2 * TOL["bfloat16"] * row.abs().max()
            lg = cpu.decode_step(row.argmax().view(1).int(), cache)
    want, cache_cpu = serve(cpu, "cpu")
    assert [len(want[i]) for i in range(5)] == n_new
    got, cache_gpu = serve(gpu, cuda)
    assert got == want
    # the refilled slots' K/V and positions too: at this init scale the
    # greedy stream hardly depends on its context
    assert cache_gpu["pos"].tolist() == cache_cpu["pos"].tolist()
    for name in ("k", "v"):
        assert rel_err(cache_gpu[name], cache_cpu[name]) < TOL["bfloat16"]


def test_rwkv6_engine_on_card_matches_cpu(cuda, monkeypatch):
    """rwkv6-7b's smoke model served on two slots, a wave of unequal
    prompts and three refills, on the card and on the CPU. Its greedy steps
    come near ties, so the card's engine is teacher-forced on the CPU
    engine's tokens: every row of logits it sampled from against the CPU's
    row for that request and step, and the final states, token shifts and
    positions."""
    cfg = smoke_config(get_config("rwkv6-7b"))
    cpu = models.init_params(cfg, seed=0, device="cpu")
    gpu = LM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in (9, 4, 7, 11, 3)]
    n_new = [3, 8, 5, 6, 4]
    sample = engine_mod.sample_per_request

    def serve(model, device, want=None):
        reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, n_new))]
        by_sampling = {id(r.sampling): r for r in reqs}
        rows = {}

        def recorded(logits, generator, sampling):
            got = sample(logits, generator, sampling).tolist()
            out = []
            for j, (row, sp) in enumerate(zip(logits, sampling)):
                r = by_sampling[id(sp)]
                rows[r.uid, len(r.output)] = row.float().cpu()
                out.append(got[j] if want is None else want[r.uid][len(r.output)])
            return torch.tensor(out, dtype=torch.int32)

        monkeypatch.setattr(engine_mod, "sample_per_request", recorded)
        eng = Engine(cfg, model, batch_size=2, max_len=64, device=device)
        done = eng.run(reqs)
        return {r.uid: r.output for r in done}, rows, eng.cache

    want, rows_cpu, cache_cpu = serve(cpu, "cpu")
    got, rows_gpu, cache_gpu = serve(gpu, cuda, want)
    assert got == want and rows_gpu.keys() == rows_cpu.keys()
    V = cfg.vocab_size
    for key, row in rows_cpu.items():
        assert rel_err(rows_gpu[key][:V], row[:V]) < TOL["bfloat16"], key
    assert cache_gpu["pos"].tolist() == cache_cpu["pos"].tolist()
    for name in ("state", "sx_t", "sx_c"):
        assert rel_err(cache_gpu[name], cache_cpu[name]) < TOL["bfloat16"], name
