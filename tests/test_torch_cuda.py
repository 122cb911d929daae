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
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.matmul.kernel import (INT8_MAX_K, MMA_SYNC_TILES, TILES, split_plan,
                                               tma_eligible)
from repro_torch.kernels.matmul.ref import (dequant_matmul_ref, matmul_fp8_ref, matmul_int8_ref,
                                            matmul_reduce_ref, matmul_ref, quantize_fp8,
                                            quantize_int8)
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
@pytest.mark.parametrize("name", sorted(set(TK.KERNELS) - {"wkv", "matmul", "matmul_wgmma", "matmul_reduce",
                                                     "matmul_int8"}))
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
                             "decode_attention": 0, "wkv": 0,
                             "matmul": 0, "matmul_wgmma": 0, "matmul_reduce": 0,
                             "matmul_int8": 0}
    TK.reset_launches()
    model.decode_step(toks[:, 0], cache)
    assert TK.launches() == {"rmsnorm": 13, "layernorm": 0, "gelu": 0,
                             "silu_mul": 3, "flash_attention": 0,
                             "decode_attention": 3, "wkv": 0,
                             "matmul": 0, "matmul_wgmma": 0, "matmul_reduce": 0,
                             "matmul_int8": 0}


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
                             "flash_attention": 3, "decode_attention": 0, "wkv": 0,
                             "matmul": 0, "matmul_wgmma": 0, "matmul_reduce": 0,
                             "matmul_int8": 0}
    TK.reset_launches()
    model.decode_step(toks[:, 0], cache)
    assert TK.launches() == {"rmsnorm": 0, "layernorm": 7, gate: 3, other: 0,
                             "flash_attention": 0, "decode_attention": 3, "wkv": 0,
                             "matmul": 0, "matmul_wgmma": 0, "matmul_reduce": 0,
                             "matmul_int8": 0}


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


# ---------------- GEMMs ----------------

# the JAX kernel tests' shapes (ragged K breaks the mma k-step and 16-byte
# rows) and one gpt3-175b layer GEMM at full width (decode batch of 8)
GEMM_SHAPES = [(128, 128, 128), (256, 512, 128), (100, 200, 50), (1, 300, 77),
               (513, 129, 257), (8, 12288, 12288)]
GEMM_TOL = {"bfloat16": 2e-2, "float32": 2e-5, "fp8": 2e-5, "int8": 1e-4}
WGMMA_DTYPES = (torch.bfloat16, torch.float8_e4m3fn)


def gemm_excess(got, want, a, b):
    """Largest |got - want| / (r |want| + 2^-16 (|a| @ |b|)) over the
    elements (a, b: the operands' values in fp32; r = 2^-7, one bf16 ulp
    apart, for a bf16 output, else 0); <= 1 passes. Dropping a k-step of 16
    products or transposing a 16x16 tile of b moves an element by the sum of
    ~16 products, ~4 at unit-normal operands, against 2^-16 of ~0.64 K."""
    r = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    got, want = got.float(), want.float()
    mag = torch.matmul(a.float().nan_to_num().abs(), b.float().nan_to_num().abs())
    den = (r * want.abs() + 2.0 ** -16 * mag).clamp_min(1e-30)
    return ((got - want).abs() / den).nan_to_num(0.0).max().item()


def gemm_case(kind, m, k, n, device):
    """(op's kernel output, plain output, operand values) of one case."""
    a, b = normal(m + k, (m, k), device, torch.float32), normal(n, (k, n), device, torch.float32)
    if kind in ("bfloat16", "float32"):
        a, b = a.to(DTYPES[kind]), b.to(DTYPES[kind])
        return mm_ops.matmul(a, b, bm=128, bk=128, bn=128), matmul_ref(a, b), a, b
    if kind == "fp8":
        return (mm_ops.matmul_fp8(a, b, bm=128, bk=128, bn=128), matmul_fp8_ref(a, b),
                quantize_fp8(a), quantize_fp8(b))
    qa, sa = quantize_int8(a, 1)
    qb, sb = quantize_int8(b, 0)
    return (mm_ops.matmul_int8(a, b, bm=128, bk=128, bn=128), matmul_int8_ref(a, b),
            qa.float() * sa, qb.float() * sb)


@pytest.mark.parametrize("kind", sorted(GEMM_TOL))
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_gemm_ops_match_plain_on_card(cuda, kind, m, k, n):
    """Each op's kernel against its plain version: relative error to the
    largest output and element by element (``gemm_excess``)."""
    names = ("matmul_int8",) if kind == "int8" else ("matmul", "matmul_wgmma")
    before = sum(TK.KERNELS[name].launches for name in names)
    got, want, a, b = gemm_case(kind, m, k, n, cuda)
    torch.cuda.synchronize()
    assert sum(TK.KERNELS[name].launches for name in names) == before + 1
    assert got.shape == want.shape == (m, n) and got.dtype == want.dtype
    assert rel_err(got, want) < GEMM_TOL[kind]
    assert gemm_excess(got, want, a, b) <= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float8_e4m3fn,
                                   torch.int8], ids=str)
def test_every_compiled_gemm_tile_on_card(cuda, dtype):
    """Every compiled tile of the mma.sync, SIMT and int8 kernels at ragged
    shapes, element by element against the plain version."""
    for m, k, n in ((513, 129, 257), (1, 300, 77), (70, 96, 130)):
        a = normal(1, (m, k), cuda, torch.float32)
        b = normal(2, (k, n), cuda, torch.float32)
        for tile in MMA_SYNC_TILES if dtype in WGMMA_DTYPES else TILES[dtype]:
            bm, bk, bn = tile
            if dtype == torch.int8:
                qa, sa = quantize_int8(a, 1)
                qbt, sbt = quantize_int8(b.t().contiguous(), 1)
                got = TK.KERNELS["matmul_int8"](qa, qbt.t(), sa, sbt.t(), bm=bm, bk=bk, bn=bn)
                want = dequant_matmul_ref(qa, qbt.t(), sa, sbt.t())
                x, y = qa.float() * sa, (qbt.float() * sbt).t()
            elif dtype == torch.float8_e4m3fn:
                x, y = quantize_fp8(a), quantize_fp8(b.t().contiguous()).t()
                got = TK.KERNELS["matmul"](x, y, bm=bm, bk=bk, bn=bn, out_dtype=torch.float32)
                want = matmul_ref(x, y, out_dtype=torch.float32)
            else:
                x, y = a.to(dtype), b.to(dtype)
                got = TK.KERNELS["matmul"](x, y, bm=bm, bk=bk, bn=bn)
                want = matmul_ref(x, y)
            torch.cuda.synchronize()
            assert gemm_excess(got, want, x, y) <= 1, (tile, m, k, n)


def wgmma_operands(dtype, m, k, n, device, seed=1):
    """fp32 normals a (m,k), b (k,n) as the wgmma kernel's operands (e4m3:
    b column-major)."""
    a = normal(seed, (m, k), device, torch.float32)
    b = normal(seed + 1, (k, n), device, torch.float32)
    if dtype == torch.bfloat16:
        return a.bfloat16(), b.bfloat16()
    return quantize_fp8(a), quantize_fp8(b.t().contiguous()).t()


@pytest.mark.parametrize("dtype", WGMMA_DTYPES, ids=str)
@pytest.mark.parametrize("m", [1, 8, 63, 65, 200])
def test_every_wgmma_tile_on_card(cuda, dtype, m):
    """Every compiled tile of the TMA + wgmma kernel at M = 1, 8, 63, 65 and
    200, with a K tail (K not a multiple of the k-tile) and an N edge, whole
    and split, element by element against the plain version."""
    k, n = (200, 264) if dtype == torch.bfloat16 else (208, 136)
    x, y = wgmma_operands(dtype, m, k, n, cuda)
    assert tma_eligible(dtype, m, k, n, x.data_ptr(), y.data_ptr())
    out = torch.float32 if dtype == torch.float8_e4m3fn else dtype
    want = matmul_ref(x, y, out_dtype=out)
    for bm, bk, bn in TILES[dtype]:
        got = TK.KERNELS["matmul_wgmma"](x, y, bm=bm, bk=bk, bn=bn, out_dtype=out)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype
        assert gemm_excess(got, want, x, y) <= 1, (bm, bk, bn, m)


@pytest.mark.parametrize("dtype", WGMMA_DTYPES, ids=str)
def test_wgmma_split_k_on_card(cuda, dtype):
    """gpt3-175b's out projection at M = 8 splits K (48 or 96 output tiles):
    the partials' reduction is launched once and counted, the result passes
    the per-element check and is the same bits in a second run."""
    m, k, n = 8, 12288, 12288
    tile = TILES[dtype][0]
    assert len(split_plan(m, n, k, tile)) > 1
    x, y = wgmma_operands(dtype, m, k, n, cuda)
    out = torch.float32 if dtype == torch.float8_e4m3fn else dtype
    before = TK.launches()
    got = TK.KERNELS["matmul_wgmma"](x, y, bm=tile[0], bk=tile[1], bn=tile[2], out_dtype=out)
    again = TK.KERNELS["matmul_wgmma"](x, y, bm=tile[0], bk=tile[1], bn=tile[2], out_dtype=out)
    torch.cuda.synchronize()
    after = TK.launches()
    assert after["matmul_wgmma"] - before["matmul_wgmma"] == 2
    assert after["matmul_reduce"] - before["matmul_reduce"] == 2
    assert torch.equal(got, again)
    want = matmul_ref(x, y, out_dtype=out)
    assert rel_err(got, want) < GEMM_TOL["fp8" if out == torch.float32 else "bfloat16"]
    assert gemm_excess(got, want, x, y) <= 1


def test_matmul_reduce_matches_plain_on_card(cuda):
    """The split-K reduction sums the partials in split order: the same bits
    as the plain version, fp32 and bf16, with an odd element count."""
    p = normal(5, (6, 9, 13), cuda, torch.float32)
    for dt in (torch.float32, torch.bfloat16):
        c = torch.empty((9, 13), device=cuda, dtype=dt)
        got = TK.KERNELS["matmul_reduce"](p, c)
        torch.cuda.synchronize()
        assert got is c and torch.equal(got, matmul_reduce_ref(p, dt))


def test_gemm_paths_and_their_launches_on_card(cuda):
    """The path is chosen by shape and alignment before the launch: a
    TMA-describable bf16 or e4m3 GEMM launches the wgmma kernel only, a
    ragged one (K = 129) the mma.sync kernel only, and an operand viewed at
    a storage offset that breaks 16-byte alignment takes the mma.sync path
    and agrees with the plain version; the wgmma wrapper refuses it."""
    for op, kind in ((mm_ops.matmul, "bfloat16"), (mm_ops.matmul_fp8, "fp8")):
        for (m, k, n), path in (((64, 256, 128), "matmul_wgmma"), ((513, 129, 257), "matmul")):
            a = normal(3, (m, k), cuda, torch.float32)
            b = normal(4, (k, n), cuda, torch.float32)
            if kind == "bfloat16":
                a, b = a.bfloat16(), b.bfloat16()
            before = TK.launches()
            op(a, b)
            torch.cuda.synchronize()
            after = TK.launches()
            grown = {name for name in after if after[name] != before[name]}
            tile = TILES[torch.bfloat16 if kind == "bfloat16" else torch.float8_e4m3fn][0]
            split = path == "matmul_wgmma" and len(split_plan(m, n, k, tile)) > 1
            assert grown == {path} | ({"matmul_reduce"} if split else set()), (kind, grown)
    m, k, n = 64, 256, 128
    flat = normal(6, (m * k + 1,), cuda, torch.float32).bfloat16()
    a = flat[1:].view(m, k)                       # data_ptr 2 bytes past an aligned base
    b = normal(7, (k, n), cuda, torch.float32).bfloat16()
    assert a.data_ptr() % 16 == 2 and not tma_eligible(a.dtype, m, k, n, a.data_ptr(),
                                                       b.data_ptr())
    before = TK.launches()
    got = mm_ops.matmul(a, b)
    torch.cuda.synchronize()
    assert TK.launches()["matmul"] == before["matmul"] + 1
    assert TK.launches()["matmul_wgmma"] == before["matmul_wgmma"]
    assert gemm_excess(got, matmul_ref(a, b), a, b) <= 1
    with pytest.raises(ValueError, match="16-byte"):
        TK.KERNELS["matmul_wgmma"](a, b)


def test_fp8_nan_placement_on_card(cuda):
    """Inputs beyond e4m3's range and +-inf give NaN in exactly the plain
    version's places (ROADMAP C1); the other outputs agree."""
    a = normal(3, (70, 96), cuda, torch.float32)
    b = normal(4, (96, 130), cuda, torch.float32)
    a[3, 5], a[10, 0], a[11, 95] = 500.0, float("inf"), -465.0
    b[7, 9], b[0, 129] = float("-inf"), 1e4
    a[20, 20], b[30, 30] = 464.0, -448.0     # in range: rounds to +-448
    got, want = mm_ops.matmul_fp8(a, b), matmul_fp8_ref(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan()) and got.isnan().any()
    ok = ~want.isnan()
    assert rel_err(got[ok], want[ok]) < GEMM_TOL["fp8"]


def test_gemm_kernels_refuse_what_they_do_not_take_on_card(cuda):
    """No quiet fallback: fp16 operands, a tile outside a kernel's set, a
    block that is not positive, an int8 K whose int32 sums could overflow.
    A small positive request runs at the nearest compiled tile."""
    a = torch.zeros((8, 32), device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16, fp32 or e4m3"):
        TK.KERNELS["matmul"](a, a.t().contiguous())
    x = torch.zeros((8, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="compiled tiles"):
        TK.KERNELS["matmul"](x, x.t().contiguous(), bm=256, bk=512, bn=256)
    with pytest.raises(ValueError, match="compiled tiles"):
        TK.KERNELS["matmul_wgmma"](x, x.t().contiguous(), bm=128, bk=32, bn=128)
    with pytest.raises(ValueError, match="positive"):
        mm_ops.matmul(x, x.t().contiguous(), bm=0, bk=8, bn=8)
    y = normal(8, (8, 32), cuda, torch.float32).bfloat16()
    yt = y.t().contiguous()
    got = mm_ops.matmul(y, yt, bm=8, bk=8, bn=8)
    torch.cuda.synchronize()
    assert gemm_excess(got, matmul_ref(y, yt), y, yt) <= 1
    q = torch.zeros((1, 140000), device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError, match="int32"):
        TK.KERNELS["matmul_int8"](q, q.t(), torch.ones((1, 1), device=cuda),
                                  torch.ones((1, 1), device=cuda))


def test_int8_kernel_is_exact_at_its_k_limit_on_card(cuda):
    """At K = INT8_MAX_K the int32 sums of -128 * -128 products stay exact;
    one more k is refused."""
    for bm, bk, bn in TILES[torch.int8]:
        q = torch.full((max(bm, bn), INT8_MAX_K), -128, device=cuda, dtype=torch.int8)
        ones_m, ones_n = torch.ones((bm, 1), device=cuda), torch.ones((1, bn), device=cuda)
        got = TK.KERNELS["matmul_int8"](q[:bm], q[:bn].t(), ones_m, ones_n, bm=bm, bk=bk,
                                        bn=bn)
        torch.cuda.synchronize()
        assert torch.equal(got, torch.full_like(got, float(INT8_MAX_K * 128 * 128)))
    q = torch.zeros((16, INT8_MAX_K + 1), device=cuda, dtype=torch.int8)
    ones = torch.ones((16, 1), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        TK.KERNELS["matmul_int8"](q, q.t(), ones, ones.t())
