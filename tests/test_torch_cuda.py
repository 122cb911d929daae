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
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref, attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.gelu.ref import (gelu_bwd_ref, gelu_mul_bwd_ref, gelu_mul_ref, gelu_ref,
                                         silu_mul_bwd_ref, silu_mul_ref)
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.rglru.kernel import SEGMENT_STEPS, segments as rglru_segments
from repro_torch.kernels.rglru.kernel import picks_chunked as rglru_picks_chunked
from repro_torch.kernels.rglru.ref import rglru_bwd_ref, rglru_chunked_ref, rglru_ref
from repro_torch.kernels.matmul import ops as mm_ops
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.kernel import (MMA_UNIT_KEYS, chunk_keys,
                                                         chunked_eligible, decode_kernel,
                                                         picks_chunked)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.kernel import bwd_wgmma_eligible, wgmma_eligible
from repro_torch.kernels.matmul.kernel import (INT8_MAX_K, INT8_MMA_SYNC_TILES, MMA_SYNC_TILES,
                                               SIMT_TILES, TILES, split_plan, tma_eligible)
from repro_torch.kernels.matmul.ref import (dequant_matmul_ref, matmul_fp8_ref, matmul_int8_ref,
                                            matmul_reduce_ref, matmul_ref, quantize_fp8,
                                            quantize_int8)
from repro_torch.kernels.rmsnorm.ref import (layernorm_bwd_ref, layernorm_ref, rmsnorm_bwd_ref,
                                            rmsnorm_ref)
from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.kernels.wkv.kernel import segments as wkv_segments, SEGMENT_STEPS as WKV_SEG
from repro_torch.kernels.wkv.ref import wkv_bwd_ref, wkv_ref
from repro_torch.models.lm import LM, loss_fn, needs_frontend
from repro_torch import training
from repro_torch.serving import Engine, Request
from repro_torch.serving import engine as engine_mod

from _torch_routing import record_routing, replay_routing

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
    if name == "gelu_mul":
        return (t(0, (100, 256)) * 4, t(1, (100, 256))), gelu_mul_ref
    if name == "flash_attention":
        return (t(0, (2, 8, 130, 64)), t(1, (2, 2, 130, 64)),
                t(2, (2, 2, 130, 64))), attention_ref
    lens = torch.tensor([200, 100, 66], dtype=torch.int32, device=device)
    return (t(0, (3, 1, 8, 64)), t(1, (3, 200, 1, 64)), t(2, (3, 200, 1, 64)),
            lens), decode_attention_ref


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(set(TK.KERNELS) - {
    "wkv", "matmul", "matmul_wgmma", "matmul_reduce", "matmul_int8", "matmul_int8_wgmma",
    "flash_attention_wgmma", "matmul_f32_tma", "decode_attention_chunked",
    "decode_attention_mma", "wkv_chunked",
    "rglru", "rglru_chunked", "flash_attention_bwd", "flash_attention_bwd_wgmma",
    "rmsnorm_bwd", "silu_mul_bwd", "layernorm_bwd", "layernorm_bwd_triton", "gelu_bwd",
    "gelu_mul_bwd", "rglru_bwd",
    "wkv_bwd", "mapper_tables"}))
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


# (B, T, H, N, lengths or None, nonzero state0, decays): the JAX kernel
# tests' rows (u tiled over the heads), a T that is no multiple of either
# kernel's chunk, T below the chunked kernel's 16 steps, the served prefill's
# heads with prompt lengths, a batch-1 refill (256 blocks of 16 columns),
# decays with exact 0, 1e-30 and exact 1 among them (ragged, a length of 0),
# and the decode step; each on the kernel the op picks (T > 1: wkv_chunked)
WKV_CASES = [(2, 96, 2, 32, None, False, "uniform"), (2, 100, 2, 32, None, False, "uniform"),
             (3, 77, 4, 64, [77, 40, 1], True, "uniform"),
             (2, 70, 3, 32, [70, 33], True, "uniform"), (2, 5, 2, 64, [5, 3], True, "uniform"),
             (8, 160, 64, 64, [160, 128, 33, 97, 1, 150, 64, 159], False, "uniform"),
             (1, 452, 64, 64, [452], False, "uniform"),
             (3, 90, 4, 64, [90, 41, 0], True, "edge"), (2, 37, 2, 32, None, True, "edge"),
             (8, 1, 64, 64, None, True, "uniform")]


def wkv_decays(seed, shape, kind, device):
    """w in (0.45, 0.95) as the JAX wkv tests draw it; "edge": a fifth each
    exact 0, 1e-30 and exact 1 among those."""
    w = torch.sigmoid(normal(seed, shape, device, torch.float32)) * 0.5 + 0.45
    if kind == "edge":
        pick = torch.from_numpy(np.random.default_rng(seed + 1).integers(0, 5, shape)).to(device)
        w = torch.where(pick == 0, 0.0, torch.where(pick == 1, 1e-30, torch.where(
            pick == 2, 1.0, w)))
    return w


@pytest.mark.parametrize("case", WKV_CASES, ids=str)
def test_wkv_matches_plain_on_card(cuda, case):
    """The op's kernel against the plain version, 1e-4 relative to the
    largest output and state; pads' outputs exactly zero; a nonzero state
    updated in place, as the decode step updates its cache."""
    B, T, H, N, lens, with_state, kind = case
    r, k, v = (normal(i, (B, T, H, N), cuda, torch.float32) for i in range(3))
    w = wkv_decays(3, (B, T, H, N), kind, cuda)
    u = normal(4, (H, N), cuda, torch.float32)
    s0 = normal(5, (B, H, N, N), cuda, torch.float32) if with_state else None
    lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                     device=cuda)
    want_out, want_state = wkv_ref(r, k, v, w, u, s0, lengths)
    name = "wkv_chunked" if T > 1 else "wkv"
    before = TK.launches()
    state_in = None if s0 is None else s0.clone()
    out, state = wkv_ops.wkv(r, k, v, w, u, state_in, lengths, state_out=state_in)
    torch.cuda.synchronize()
    assert state_in is None or state is state_in
    after = TK.launches()
    assert {n: after[n] - before[n] for n in ("wkv", "wkv_chunked")} == \
        {"wkv": int(name == "wkv"), "wkv_chunked": int(name == "wkv_chunked")}
    assert out.shape == (B, T, H, N) and state.shape == (B, H, N, N)
    assert rel_err(out, want_out) < 1e-4 and rel_err(state, want_state) < 1e-4
    for b, n in enumerate(lens or []):
        assert not out[b, n:].any()


@pytest.mark.parametrize("columns", [16, 32, 64])
def test_wkv_chunked_column_splits_on_card(cuda, columns):
    """Every column slice the chunked kernel compiles at N = 64 gives the
    plain version's result (the wave's 8 slots, ragged)."""
    B, T, H, N = 8, 40, 4, 64
    r, k, v = (normal(i, (B, T, H, N), cuda, torch.float32) for i in range(3))
    w = wkv_decays(3, (B, T, H, N), "uniform", cuda)
    u, s0 = normal(4, (H, N), cuda, torch.float32), normal(5, (B, H, N, N), cuda, torch.float32)
    lengths = torch.tensor([40, 1, 17, 16, 32, 33, 0, 39], dtype=torch.int32, device=cuda)
    want_out, want_state = wkv_ref(r, k, v, w, u, s0, lengths)
    out, state = TK.KERNELS["wkv_chunked"](r, k, v, w, u, s0, lengths, columns=columns)
    assert rel_err(out, want_out) < 1e-4 and rel_err(state, want_state) < 1e-4


def test_rwkv6_launches_per_step_on_card(cuda):
    """2L+1 LayerNorms per prefill and per decode step, L wkv_chunked
    launches per prefill and L wkv per decode step, and no attention
    kernel."""
    cfg = dataclasses.replace(smoke_config(get_config("rwkv6-7b")), n_layers=3)
    model = models.init_params(cfg, seed=0, device=cuda)
    cache = models.init_cache(cfg, 2, 32, device=cuda)
    toks = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    want = {name: 0 for name in TK.KERNELS}
    TK.reset_launches()
    model.prefill(toks, cache, torch.tensor([8, 5], dtype=torch.int32, device=cuda))
    assert TK.launches() == {**want, "layernorm": 7, "wkv_chunked": 3}
    TK.reset_launches()
    model.decode_step(toks[:, 0], cache)
    assert TK.launches() == {**want, "layernorm": 7, "wkv": 3}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(8, 49152), (4096, 49152), (3, 1001)])
def test_gelu_served_shapes_on_card(cuda, shape, dtype):
    """The GELU kernel at gpt3-175b's decode (8 slots) and prefill-wave
    shapes of its FFN, and a ragged element count: one launch, each
    element within one rounding of the plain version (bf16: 2^-7 |b| +
    1e-3; fp32: 2e-5 relative to the largest)."""
    x = normal(7, shape, cuda, DTYPES[dtype]) * 3
    before = TK.KERNELS["gelu"].launches
    got = TK.KERNELS["gelu"](x)
    torch.cuda.synchronize()
    assert TK.KERNELS["gelu"].launches == before + 1
    want = gelu_ref(x)
    assert got.dtype == x.dtype and got.shape == x.shape
    g, w = got.float(), want.float()
    if dtype == "bfloat16":
        assert ((g - w).abs() <= 2.0 ** -7 * w.abs() + 1e-3).all()
    else:
        assert rel_err(got, want) < TOL["float32"]
    # a base 2 bytes off 16: the kernel's scalar loop
    off = torch.empty(x.numel() + 8, dtype=x.dtype, device=cuda)[1:1 + x.numel()].view(shape)
    off.copy_(x)
    assert torch.equal(TK.KERNELS["gelu"](off), got)


# (query heads, kv-heads, d_head) of the served models
SERVED_HEADS = {"qwen3-1.7b": (16, 8, 128), "stablelm-1.6b": (32, 32, 64),
                "gpt3-175b": (96, 96, 128), "llama-3.2-vision-11b": (32, 8, 128),
                "whisper-tiny": (6, 6, 64)}


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


def unhide_cross_attention(model):
    """In place: ``xgate`` 0.5, the qkv biases seeded normal values of 0.2,
    the cross-attention output projections 8 times their init, so that a
    wrong cross-attention moves the logits past the tolerance (the init's
    zero gate and biases hide it)."""
    gen = torch.Generator().manual_seed(4)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "xgate":
            p.data.fill_(0.5)
        elif leaf in ("bq", "bk", "bv"):
            p.data.copy_(torch.randn(p.shape, generator=gen) * 0.2)
        elif name.endswith("xattn.wo"):
            p.data.mul_(8)


@pytest.mark.parametrize("arch", sorted(ARCHS) + sorted(EXTRA_ARCHS))
def test_model_on_card_matches_cpu(cuda, monkeypatch, arch):
    """Forward, prefill and decode logits of the kernel path on the card
    against the plain path on the CPU, on the same weights; an MoE model's
    routing on the CPU replayed on the card; a cross-attending model with a
    full-length frontend and its cross-attention unhidden, its cross K/V
    held too."""
    cfg = smoke_config(get_config(arch))
    cpu = models.init_params(cfg, seed=0, device="cpu")
    unhide_cross_attention(cpu)
    gpu = LM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 12), dtype=np.int32))
    lens = torch.tensor([12, 7, 3], dtype=torch.int32)
    fe = normal(9, (3, cfg.n_frontend_tokens, cfg.d_model), "cpu", torch.bfloat16) \
        if cfg.n_frontend_tokens else None
    V = cfg.vocab_size

    def run(model, device):
        cache = models.init_cache(cfg, 3, 32, device=device)
        f = None if fe is None else fe.to(device)
        out = [model(toks.to(device), f), model.prefill(toks.to(device), cache, lens.to(device), f)]
        out += [model.decode_step(toks[:, step].to(device), cache) for step in range(3)]
        out += [cache[name] for name in ("xk", "xv") if name in cache]
        return [lg[..., :V] for lg in out], cache["pos"].tolist()

    with monkeypatch.context() as m:
        records = record_routing(m)
        want, pos = run(cpu, "cpu")
    assert len(records) == (5 * cfg.n_layers if cfg.n_experts else 0)
    with monkeypatch.context() as m:
        calls = replay_routing(m, records)
        got, gpu_pos = run(gpu, cuda)
        assert next(calls, None) is None
    for g, w in zip(got, want):
        assert rel_err(g, w) < TOL["bfloat16"]
    assert gpu_pos == pos


def moe_layer_case(arch, full_width, B, S, device):
    """(cfg, MoE params on `device` from one CPU draw, x (B, S, d) bf16)."""
    cfg = get_config(arch) if full_width else smoke_config(get_config(arch))
    p = models.layers.moe_init(cfg, torch.Generator().manual_seed(0), "cpu")
    x = normal(1, (B, S, cfg.d_model), "cpu", torch.bfloat16)
    return cfg, {n: w.to(device) for n, w in p.items()}, x


@pytest.mark.parametrize("arch,full_width,B,S", [
    ("granite-moe-3b-a800m", False, 2, 16), ("grok-1-314b", False, 2, 16),
    ("granite-moe-3b-a800m", True, 8, 1), ("granite-moe-3b-a800m", True, 8, 64)])
def test_moe_apply_on_card_matches_cpu(cuda, monkeypatch, arch, full_width, B, S):
    """The MoE layer on the card against its CPU path (smoke widths, and
    granite's full width at an 8-slot decode step and a wave): its own
    experts those of the CPU but where the k-th and (k+1)-th probabilities
    lie within 1e-6 (the router in IEEE fp32 on both), y within 2e-2 with
    the CPU's routing replayed, the aux loss within 1e-5, one launch of the
    expert activation's kernel."""
    cfg, p, x = moe_layer_case(arch, full_width, B, S, cuda)
    pc = {n: w.cpu() for n, w in p.items()}
    k = cfg.top_k
    with monkeypatch.context() as m:
        records = record_routing(m)
        want, want_aux = models.layers.moe_apply(cfg, pc, x)
    probs, _, idx = models.layers.moe_route(cfg, p, x.view(B * S, -1).to(cuda))
    cpu_probs = torch.sort(torch.softmax(records[0][1], -1), -1, descending=True).values
    tied = cpu_probs[:, k - 1] - cpu_probs[:, k] < 1e-6
    same = (idx.sort(-1).values.cpu() == records[0][0].sort(-1).values).all(-1)
    assert (same | tied).all()
    with monkeypatch.context() as m:
        replay_routing(m, records)
        TK.reset_launches()
        got, aux = models.layers.moe_apply(cfg, p, x.to(cuda))
        torch.cuda.synchronize()
    gate = "gelu_mul" if cfg.activation == "gelu" else "silu_mul"
    assert {n: c for n, c in TK.launches().items() if c} == {gate: 1}
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert rel_err(got, want) < TOL["bfloat16"]
    assert abs(aux.item() - want_aux.item()) < 1e-5


@pytest.mark.parametrize("arch,gate", [("granite-moe-3b-a800m", "silu_mul"),
                                       ("grok-1-314b", "gelu_mul")])
def test_moe_decode_step_on_card_syncs_nothing(cuda, arch, gate):
    """An MoE model's decode step launches 2L+1 RMSNorms, L expert
    activations and L decode attentions, and runs under
    ``set_sync_debug_mode("error")``: nothing on it waits for the host."""
    cfg = smoke_config(get_config(arch))
    model = models.init_params(cfg, seed=0, device=cuda)
    cache = models.init_cache(cfg, 2, 32, device=cuda)
    toks = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    model.prefill(toks, cache)
    model.decode_step(toks[:, 0], cache)
    torch.cuda.synchronize()
    TK.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.decode_step(toks[:, 1], cache)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    L = cfg.n_layers
    assert {n: c for n, c in TK.launches().items() if c} == {
        "rmsnorm": 2 * L + 1, gate: L, "decode_attention_mma": L}


def test_launches_per_step_on_card(cuda):
    cfg = dataclasses.replace(smoke_config(get_config("qwen3-1.7b")), n_layers=3)
    model = models.init_params(cfg, seed=0, device=cuda)
    cache = models.init_cache(cfg, 2, 32, device=cuda)
    toks = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    TK.reset_launches()
    model.prefill(toks, cache)
    assert TK.launches() == {"rmsnorm": 13, "layernorm": 0, "gelu": 0,
                             "silu_mul": 3, "flash_attention": 3, "flash_attention_wgmma": 0,
                             "decode_attention": 0, "decode_attention_chunked": 0,
                             "decode_attention_mma": 0, "wkv": 0,
                             "wkv_chunked": 0, "gelu_mul": 0, "rglru": 0, "rglru_chunked": 0,
                             "matmul": 0, "matmul_wgmma": 0, "matmul_f32_tma": 0,
                             "matmul_reduce": 0,
                             "matmul_int8": 0, "matmul_int8_wgmma": 0,
                             "flash_attention_bwd": 0, "flash_attention_bwd_wgmma": 0,
                             "rmsnorm_bwd": 0, "silu_mul_bwd": 0, "layernorm_bwd": 0,
                             "layernorm_bwd_triton": 0,
                             "gelu_bwd": 0, "gelu_mul_bwd": 0, "rglru_bwd": 0,
                             "wkv_bwd": 0, "mapper_tables": 0}
    TK.reset_launches()
    model.decode_step(toks[:, 0], cache)
    assert TK.launches() == {"rmsnorm": 13, "layernorm": 0, "gelu": 0,
                             "silu_mul": 3, "flash_attention": 0, "flash_attention_wgmma": 0,
                             "decode_attention": 0, "decode_attention_chunked": 0,
                             "decode_attention_mma": 3, "wkv": 0,
                             "wkv_chunked": 0, "gelu_mul": 0, "rglru": 0, "rglru_chunked": 0,
                             "matmul": 0, "matmul_wgmma": 0, "matmul_f32_tma": 0,
                             "matmul_reduce": 0,
                             "matmul_int8": 0, "matmul_int8_wgmma": 0,
                             "flash_attention_bwd": 0, "flash_attention_bwd_wgmma": 0,
                             "rmsnorm_bwd": 0, "silu_mul_bwd": 0, "layernorm_bwd": 0,
                             "layernorm_bwd_triton": 0,
                             "gelu_bwd": 0, "gelu_mul_bwd": 0, "rglru_bwd": 0,
                             "wkv_bwd": 0, "mapper_tables": 0}


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
                             "flash_attention": 3, "flash_attention_wgmma": 0,
                             "decode_attention": 0, "decode_attention_chunked": 0,
                             "decode_attention_mma": 0, "wkv": 0,
                             "wkv_chunked": 0, "gelu_mul": 0, "rglru": 0, "rglru_chunked": 0,
                             "matmul": 0, "matmul_wgmma": 0, "matmul_f32_tma": 0,
                             "matmul_reduce": 0,
                             "matmul_int8": 0, "matmul_int8_wgmma": 0,
                             "flash_attention_bwd": 0, "flash_attention_bwd_wgmma": 0,
                             "rmsnorm_bwd": 0, "silu_mul_bwd": 0, "layernorm_bwd": 0,
                             "layernorm_bwd_triton": 0,
                             "gelu_bwd": 0, "gelu_mul_bwd": 0, "rglru_bwd": 0,
                             "wkv_bwd": 0, "mapper_tables": 0}
    TK.reset_launches()
    model.decode_step(toks[:, 0], cache)
    assert TK.launches() == {"rmsnorm": 0, "layernorm": 7, gate: 3, other: 0,
                             "flash_attention": 0, "flash_attention_wgmma": 0,
                             "decode_attention": 0, "decode_attention_chunked": 0,
                             "decode_attention_mma": 3, "wkv": 0,
                             "wkv_chunked": 0, "gelu_mul": 0, "rglru": 0, "rglru_chunked": 0,
                             "matmul": 0, "matmul_wgmma": 0, "matmul_f32_tma": 0,
                             "matmul_reduce": 0,
                             "matmul_int8": 0, "matmul_int8_wgmma": 0,
                             "flash_attention_bwd": 0, "flash_attention_bwd_wgmma": 0,
                             "rmsnorm_bwd": 0, "silu_mul_bwd": 0, "layernorm_bwd": 0,
                             "layernorm_bwd_triton": 0,
                             "gelu_bwd": 0, "gelu_mul_bwd": 0, "rglru_bwd": 0,
                             "wkv_bwd": 0, "mapper_tables": 0}


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
    names = ("matmul_int8", "matmul_int8_wgmma") if kind == "int8" else \
        ("matmul", "matmul_wgmma", "matmul_f32_tma")
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
    """Every compiled tile of the mma.sync, SIMT and int8 mma.sync kernels at
    ragged shapes, element by element against the plain version."""
    tiles = MMA_SYNC_TILES if dtype in WGMMA_DTYPES else \
        INT8_MMA_SYNC_TILES if dtype == torch.int8 else SIMT_TILES
    for m, k, n in ((513, 129, 257), (1, 300, 77), (70, 96, 130)):
        a = normal(1, (m, k), cuda, torch.float32)
        b = normal(2, (k, n), cuda, torch.float32)
        for tile in tiles:
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
    """No quiet fallback: fp64 operands (fp16 computes since ROADMAP C9 was
    resolved), a tile outside a kernel's set, a block that is not positive.
    A small positive request runs at the nearest compiled tile, and an int8
    K past the exact int32 sum computes the exact sum (ROADMAP C8)."""
    a = torch.zeros((8, 32), device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="bf16, fp16, fp32 or e4m3"):
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
    q = torch.full((1, 140000), -128, device=cuda, dtype=torch.int8)
    got = TK.KERNELS["matmul_int8"](q, q.t(), torch.ones((1, 1), device=cuda),
                                    torch.ones((1, 1), device=cuda), bm=16, bk=128, bn=128)
    torch.cuda.synchronize()
    assert got.item() == 140000.0 * 128 * 128


def test_int8_kernel_is_exact_at_its_k_limit_on_card(cuda):
    """At K = INT8_MAX_K the int32 sums of -128 * -128 products stay exact;
    one more k, and more, computes the exact sum too: chunks of at most
    INT8_MAX_K summed in int32, added in fp32 (ROADMAP C8), on every tile of
    the mma.sync kernel and, where K is a multiple of 16, of the wgmma one."""
    for bm, bk, bn in INT8_MMA_SYNC_TILES:
        for k in (INT8_MAX_K, INT8_MAX_K + 1, INT8_MAX_K + 2):
            q = torch.full((max(bm, bn), k), -128, device=cuda, dtype=torch.int8)
            ones_m, ones_n = torch.ones((bm, 1), device=cuda), torch.ones((1, bn), device=cuda)
            got = TK.KERNELS["matmul_int8"](q[:bm], q[:bn].t(), ones_m, ones_n, bm=bm, bk=bk,
                                            bn=bn)
            torch.cuda.synchronize()
            assert torch.equal(got, torch.full_like(got, float(k * 128 * 128))), (bm, bk, bn, k)
    for bm, bk, bn in TILES[torch.int8]:
        for k in (INT8_MAX_K + 1, 140000):
            q = torch.full((max(bm, bn), k), -128, device=cuda, dtype=torch.int8)
            ones_m, ones_n = torch.ones((bm, 1), device=cuda), torch.ones((1, bn), device=cuda)
            got = TK.KERNELS["matmul_int8_wgmma"](q[:bm], q[:bn].t(), ones_m, ones_n, bm=bm,
                                                  bk=bk, bn=bn)
            torch.cuda.synchronize()
            assert torch.equal(got, torch.full_like(got, float(k * 128 * 128))), (bm, bk, bn, k)


@pytest.mark.parametrize("m,k,n", [(8, INT8_MAX_K + 1, 64), (33, 140000, 200),
                                   (5, INT8_MAX_K + 2, 40)])
def test_int8_past_the_int32_limit_matches_plain_on_card(cuda, m, k, n):
    """ROADMAP C8: the int8 op at K > INT8_MAX_K on the card, normal
    operands, against the plain version at 1e-4 and element by element; K a
    multiple of 16 on the wgmma kernel (its split plan cuts K into chunks of
    at most INT8_MAX_K, summed with the scales by matmul_reduce), else on the
    mma.sync kernel."""
    before = TK.launches()
    got, want, a, b = gemm_case("int8", m, k, n, cuda)
    torch.cuda.synchronize()
    after = TK.launches()
    path = "matmul_int8_wgmma" if k % 16 == 0 else "matmul_int8"
    assert after[path] == before[path] + 1
    assert (after["matmul_reduce"] > before["matmul_reduce"]) == (path == "matmul_int8_wgmma")
    assert rel_err(got, want) < GEMM_TOL["int8"]
    assert gemm_excess(got, want, a, b) <= 1


@pytest.mark.parametrize("m", [1, 8, 63, 65, 200])
def test_every_int8_wgmma_tile_on_card(cuda, m):
    """Every compiled tile of the int8 mode of the TMA + wgmma kernel at M =
    1, 8, 63, 65 and 200, with a K tail and an N edge, whole and split,
    element by element against the plain version; the split's result is the
    same bits in a second run."""
    k, n = 208, 264
    a, b = normal(1, (m, k), cuda, torch.float32), normal(2, (k, n), cuda, torch.float32)
    qa, sa = quantize_int8(a, 1)
    qbt, sbt = quantize_int8(b.t().contiguous(), 1)
    qb, sb = qbt.t(), sbt.t()
    assert tma_eligible(torch.int8, m, k, n, qa.data_ptr(), qb.data_ptr())
    want = dequant_matmul_ref(qa, qb, sa, sb)
    for bm, bk, bn in TILES[torch.int8]:
        got = TK.KERNELS["matmul_int8_wgmma"](qa, qb, sa, sb, bm=bm, bk=bk, bn=bn)
        again = TK.KERNELS["matmul_int8_wgmma"](qa, qb, sa, sb, bm=bm, bk=bk, bn=bn)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, again)
        assert gemm_excess(got, want, qa.float() * sa, qb.float() * sb) <= 1, (bm, bk, bn, m)


def test_matmul_reduce_applies_the_int8_scales_on_card(cuda):
    """With scales the reduction multiplies the in-order sum by a_scale and
    then b_scale: the plain version's bits."""
    p = normal(5, (3, 9, 13), cuda, torch.float32)
    sa, sb = normal(6, (9, 1), cuda, torch.float32), normal(7, (1, 13), cuda, torch.float32)
    got = TK.KERNELS["matmul_reduce"](p, torch.empty((9, 13), device=cuda), sa, sb)
    torch.cuda.synchronize()
    assert torch.equal(got, matmul_reduce_ref(p, torch.float32, sa, sb))


@pytest.mark.parametrize("arch", sorted(SERVED_HEADS))
def test_flash_wgmma_served_head_layouts_on_card(cuda, arch):
    """The TMA + wgmma flash kernel at each served head layout, through the
    model's entry with (B, S, H, D) tensors (transposed views, no copy),
    causal over 384 tokens: one launch of it and none of the mma.sync
    kernel, element by element against the plain version."""
    hq, hkv, d = SERVED_HEADS[arch]
    q = normal(0, (2, 384, hq, d), cuda, torch.bfloat16)
    k = normal(1, (2, 384, hkv, d), cuda, torch.bfloat16)
    v = normal(2, (2, 384, hkv, d), cuda, torch.bfloat16)
    assert wgmma_eligible(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    before = TK.launches()
    got = models.layers.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    after = TK.launches()
    assert after["flash_attention_wgmma"] == before["flash_attention_wgmma"] + 1
    assert after["flash_attention"] == before["flash_attention"]
    want = models.layers.attention_reference(q, k, v, causal=True)
    assert rel_err(got, want) < TOL["bfloat16"]
    assert attention_excess(got, want) <= 1


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,window,cap,sq,sk", [(True, 32, 0.0, 300, 300),
                                                     (True, 0, 30.0, 130, 130),
                                                     (False, 0, 0.0, 70, 200),
                                                     (False, 40, 50.0, 200, 70)])
def test_flash_wgmma_masks_and_softcap_on_card(cuda, d, causal, window, cap, sq, sk):
    """The TMA + wgmma flash kernel with window and softcap masks, ragged
    query and key axes (no multiple of its 128-row tiles) and rows whose
    keys are all masked (the non-causal window past the last key: 0),
    element by element against the plain version."""
    q = normal(3, (2, sq, 4, d), cuda, torch.bfloat16).transpose(1, 2)
    k = normal(4, (2, sk, 2, d), cuda, torch.bfloat16).transpose(1, 2)
    v = normal(5, (2, sk, 2, d), cuda, torch.bfloat16).transpose(1, 2)
    kw = dict(causal=causal, window=window, softcap=cap)
    got = TK.KERNELS["flash_attention_wgmma"](q, k, v, **kw)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, **kw)
    if not causal and window:   # rows past Sk + window - 1 see no key: 0 here
        dead = torch.arange(sq, device=cuda) > sk - 1 + window - 1
        assert not got[:, :, dead].any()
        got, want = got[:, :, ~dead], want[:, :, ~dead]
    assert rel_err(got, want) < TOL["bfloat16"]
    assert attention_excess(got, want) <= 1


def test_flash_paths_on_card(cuda):
    """D = 32, a sequence stride TMA cannot take and fp32 run on the mma.sync
    / fp32 kernel through the op, one launch each, against the plain
    version; the wgmma wrapper refuses them."""
    x32 = normal(6, (2, 4, 70, 32), cuda, torch.bfloat16)
    odd = normal(7, (2, 4, 70, 68), cuda, torch.bfloat16)[..., :64]
    f32 = normal(8, (2, 4, 70, 64), cuda, torch.float32)
    for x, tol in ((x32, TOL["bfloat16"]), (odd, TOL["bfloat16"]), (f32, TOL["float32"])):
        assert not wgmma_eligible(x, x, x)
        before = TK.launches()
        got = flash_ops.flash_attention(x, x, x, causal=True)
        torch.cuda.synchronize()
        after = TK.launches()
        assert after["flash_attention"] == before["flash_attention"] + 1
        assert after["flash_attention_wgmma"] == before["flash_attention_wgmma"]
        assert rel_err(got, attention_ref(x, x, x, causal=True)) < tol
        with pytest.raises(ValueError):
            TK.KERNELS["flash_attention_wgmma"](x, x, x)


def test_card_computes_what_it_once_refused(cuda):
    """ROADMAP C9, resolved: inputs the card refused compute on a hand-written
    kernel, each through its op, with the kernel's launch count to show
    which, against the plain version. fp16 GEMM operands on the TMA +
    wgmma kernel's fp16 mode (and on mma.sync where TMA cannot take the
    pitch), matmul_fp8 writing fp16; held at 1e-3 relative, tighter than
    bf16's 2e-2 (fp16 keeps 11 bits; one rounding of the fp32 sum). Flash
    attention at D = 256 (wgmma; fp32 on the fp32 kernel) and at 16, 48, 96
    and 200, zero-padded to the next kernel dim; decode attention at 16, at
    200 and 256 in fp32 (the split kernel's D = 256); wkv at 16 and 48
    (padded) and 128 (the step-by-step kernel, also for T > 1). Only dims
    past the kernels' (attention D = 320, wkv N = 192) still raise."""
    def launched(op, *args, **kw):
        before = TK.launches()
        out = op(*args, **kw)
        torch.cuda.synchronize()
        return out, {k: n - before[k] for k, n in TK.launches().items() if n != before[k]}

    h = normal(9, (256, 320), cuda, torch.float16)
    b = normal(10, (320, 192), cuda, torch.float16)
    for (x, y), kern in (((h, b), "matmul_wgmma"), ((h[:, :129], b[:129]), "matmul")):
        got, n = launched(mm_ops.matmul, x, y)
        assert set(n) - {"matmul_reduce"} == {kern} and n[kern] == 1   # K may be split
        assert got.dtype == torch.float16 and rel_err(got, matmul_ref(x, y)) < 1e-3
    got, n = launched(mm_ops.matmul_fp8, h, b)
    assert set(n) - {"matmul_reduce"} == {"matmul_wgmma"} and got.dtype == torch.float16
    assert rel_err(got, matmul_fp8_ref(h, b)) < 1e-3
    for d, dtype, kern in ((256, torch.bfloat16, "flash_attention_wgmma"),
                           (256, torch.float32, "flash_attention"),
                           (16, torch.bfloat16, "flash_attention"),
                           (48, torch.bfloat16, "flash_attention_wgmma"),
                           (96, torch.bfloat16, "flash_attention_wgmma"),
                           (200, torch.bfloat16, "flash_attention_wgmma"),
                           (200, torch.float32, "flash_attention")):
        q = normal(11, (2, 4, 150, d), cuda, dtype)
        k, v = normal(12, (2, 1, 150, d), cuda, dtype), normal(13, (2, 1, 150, d), cuda, dtype)
        got, n = launched(flash_ops.flash_attention, q, k, v, causal=True, window=70)
        want = attention_ref(q, k, v, causal=True, window=70)
        assert n == {kern: 1}, (d, dtype, n)
        assert got.shape == q.shape and rel_err(got, want) < TOL[str(dtype)[6:]]
        if dtype == torch.bfloat16:
            assert attention_excess(got, want) <= 1, d
    lens = torch.tensor([150, 33], dtype=torch.int32, device=cuda)
    # 10 query heads a kv-head: the mma kernel in bf16 (G > CHUNKED_MAX_G),
    # the split kernel in fp32
    for d, dtype, kern in ((16, torch.bfloat16, "decode_attention_mma"),
                           (200, torch.float32, "decode_attention"),
                           (256, torch.float32, "decode_attention")):
        q = normal(14, (2, 1, 10, d), cuda, dtype)
        k, v = normal(15, (2, 150, 1, d), cuda, dtype), normal(16, (2, 150, 1, d), cuda, dtype)
        got, n = launched(decode_ops.decode_attention, q, k, v, lens)
        want = decode_attention_ref(q, k, v, lens)
        assert n == {kern: 1}, (d, dtype, n)
        assert got.shape == q.shape and rel_err(got, want) < TOL[str(dtype)[6:]]
    for N, T, kern in ((16, 9, "wkv_chunked"), (48, 9, "wkv_chunked"), (128, 9, "wkv"),
                       (128, 1, "wkv"), (48, 1, "wkv")):
        r, k, v = (normal(17 + i, (2, T, 2, N), cuda, torch.float32) for i in range(3))
        w = torch.sigmoid(normal(20, (2, T, 2, N), cuda, torch.float32)) * 0.5 + 0.45
        u, s0 = normal(21, (2, N), cuda, torch.float32), normal(22, (2, 2, N, N), cuda,
                                                                  torch.float32)
        want_out, want_state = wkv_ref(r, k, v, w, u, s0)
        state = s0.clone()
        (out, got_state), n = launched(wkv_ops.wkv, r, k, v, w, u, state, state_out=state)
        assert n == {kern: 1}, (N, T, n)
        assert got_state is state
        assert rel_err(out, want_out) < 1e-4 and rel_err(state, want_state) < 1e-4
    q = normal(23, (1, 4, 40, 320), cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="up to 256"):
        flash_ops.flash_attention(q, q[:, :1], q[:, :1])
    with pytest.raises(ValueError, match="up to 256"):
        decode_ops.decode_attention(q[:, :1, :4], q[:, :1].transpose(1, 2).contiguous(),
                                    q[:, :1].transpose(1, 2).contiguous(),
                                    torch.tensor([40], dtype=torch.int32, device=cuda))
    r = normal(24, (1, 8, 2, 192), cuda, torch.float32)
    with pytest.raises(ValueError, match="up to 128"):
        wkv_ops.wkv(r, r, r, r, normal(25, (2, 192), cuda, torch.float32))


@pytest.mark.parametrize("window", [0, 100, 700])
def test_flash_d256_on_card(cuda, window):
    """The wgmma kernel's D = 256 mode at recurrentgemma-2b's prefill layout
    (8 slots x 512 tokens, 10 query heads on one kv-head, the model's
    transposed (B, S, H, D) views), causal, with windows that cut key tiles
    (100, 700) and none: one flash_attention_wgmma launch, relative and per
    element against the plain version."""
    q = normal(30, (8, 512, 10, 256), cuda, torch.bfloat16).transpose(1, 2)
    k = normal(31, (8, 512, 1, 256), cuda, torch.bfloat16).transpose(1, 2)
    v = normal(32, (8, 512, 1, 256), cuda, torch.bfloat16).transpose(1, 2)
    assert wgmma_eligible(q, k, v)
    before = TK.launches()["flash_attention_wgmma"]
    got = flash_ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert TK.launches()["flash_attention_wgmma"] == before + 1
    want = attention_ref(q, k, v, causal=True, window=window)
    assert rel_err(got, want) < TOL["bfloat16"] and attention_excess(got, want) <= 1


@pytest.mark.parametrize("shape", [(8, 7680), (4096, 7680), (3, 1001)])
def test_gelu_mul_served_shapes_on_card(cuda, shape):
    """The gated-GELU mode at recurrentgemma-2b's decode (8 slots) and
    prefill-wave MLP shapes and a ragged count: one gelu_mul launch, each
    element within one bf16 rounding of the plain version."""
    g = normal(33, shape, cuda, torch.bfloat16) * 3
    u = normal(34, shape, cuda, torch.bfloat16)
    before = TK.launches()["gelu_mul"]
    got = TK.KERNELS["gelu_mul"](g, u)
    torch.cuda.synchronize()
    assert TK.launches()["gelu_mul"] == before + 1
    want = gelu_mul_ref(g, u)
    assert bool(((got.float() - want.float()).abs()
                 <= 2.0 ** -7 * want.float().abs() + 1e-3).all())


def rglru_case(device, B, T, d, seed, with_h0):
    g = torch.Generator(device).manual_seed(seed)

    def rnd(shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale
    u, gate = rnd((B, T, d)).bfloat16(), rnd((B, T, d)).bfloat16()
    ga, gx = rnd((B, T, d), 3.0), rnd((B, T, d), 3.0)
    lam = torch.linspace(-6.0, 12.0, d, device=device)  # decays near 1 and near 0
    h0 = rnd((B, d)) if with_h0 else None
    return u, ga, gx, lam, gate, h0


@pytest.mark.parametrize("B,T,lens,with_h0", [
    (8, 300, [300, 291, 150, 64, 17, 5, 1, 0], False),   # a wave of unequal prompts
    (1, 452, None, False),                               # a batch-1 refill
    (1, 2304, None, False),                              # the ring phase's prefill
    (3, 201, [201, 130, 0], True),                       # no chunk or tile divides T
    (8, 1, None, True),                                  # the decode step, h in place
    (3, 40, [40, 7, 40], True)])
def test_rglru_on_card(cuda, B, T, lens, with_h0):
    """The rglru op against its plain step loop at recurrentgemma's width
    (d = 2560): output and final h within 1e-4 relative (fp32, the gates'
    exponentials and the scan in another order), one launch of the kernel
    the op picks (``rglru_chunked`` for T > 1, ``rglru`` for the decode
    step) and of no other; h written in place where the caller gives h0."""
    u, ga, gx, lam, gate, h0 = rglru_case(cuda, B, T, 2560, 35 + T, with_h0)
    lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    want_y, want_h = rglru_ref(u, ga, gx, lam, gate, h0, lengths)
    h_out = h0.clone() if with_h0 else None
    name = "rglru_chunked" if T > 1 else "rglru"
    assert rglru_picks_chunked(u, ga, gx, gate) == (T > 1)
    before = TK.launches()
    y, h = rglru_ops.rglru(u, ga, gx, lam, gate, h_out, lengths, h_out=h_out)
    torch.cuda.synchronize()
    assert TK.launches() == {**before, name: before[name] + 1}
    assert h_out is None or h is h_out
    assert rel_err(y, want_y) < 1e-4 and rel_err(h, want_h) < 1e-4


@pytest.mark.parametrize("steps", SEGMENT_STEPS)
@pytest.mark.parametrize("B,T,d,lens,with_h0", [
    (8, 436, 2560, [239, 347, 332, 238, 396, 273, 424, 436], False),  # the served wave
    (1, 452, 2560, None, True),
    (2, 67, 2552, [67, 0], True),                                    # a ragged channel tile
    (2, 2, 64, None, True)])
def test_rglru_chunked_on_card(cuda, steps, B, T, d, lens, with_h0):
    """``rglru_chunked_cuda`` at each segment length against its own
    arithmetic in PyTorch (``rglru_chunked_ref``) and the step loop, y and
    the final h within 1e-4 relative; h0 updated in place."""
    u, ga, gx, lam, gate, h0 = rglru_case(cuda, B, T, d, 70 + T, with_h0)
    lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=cuda)
    want_y, want_h = rglru_ref(u, ga, gx, lam, gate, h0, lengths)
    ref_y, ref_h = rglru_chunked_ref(u, ga, gx, lam, gate, h0, lengths, chunk=steps)
    h_out = h0.clone() if with_h0 else None
    before = TK.launches()["rglru_chunked"]
    y, h = TK.KERNELS["rglru_chunked"](u, ga, gx, lam, gate, h_out, lengths, h_out=h_out,
                                       steps=steps)
    torch.cuda.synchronize()
    assert TK.launches()["rglru_chunked"] == before + 1
    assert h_out is None or h is h_out
    for got, want in ((y, ref_y), (h, ref_h), (y, want_y), (h, want_h)):
        assert rel_err(got, want) < 1e-4


@pytest.mark.parametrize("m", [8, 300, 4096])
def test_fp16_gemm_tiles_on_card(cuda, m):
    """fp16 operands on every compiled fp16 tile of the wgmma kernel and on
    every mma.sync tile, written fp16 and fp32, against the plain version
    at 1e-3 relative."""
    a = normal(40, (m, 512), cuda, torch.float16)
    b = normal(41, (512, 768), cuda, torch.float16)
    want = matmul_ref(a, b, out_dtype=torch.float32)
    for tile in TILES[torch.float16]:
        for out in (torch.float16, torch.float32):
            got = TK.KERNELS["matmul_wgmma"](a, b, bm=tile[0], bk=tile[1], bn=tile[2],
                                             out_dtype=out)
            assert got.dtype == out and rel_err(got, want) < 1e-3, (tile, out)
    for tile in MMA_SYNC_TILES:
        got = TK.KERNELS["matmul"](a, b, bm=tile[0], bk=tile[1], bn=tile[2])
        assert got.dtype == torch.float16 and rel_err(got, want) < 1e-3, tile


def test_griffin_launches_per_step_on_card(cuda):
    """recurrentgemma's smoke model at 8 layers (two units and the
    remainder): per prefill 2L+1 RMSNorms, L gelu_mul, one gelu and one
    rglru_chunked per RG-LRU layer (6) and one flash attention per attention
    layer (2, the mma.sync kernel at the smoke head dim 32); per decode step
    the same with rglru in place of rglru_chunked and the mma decode kernel
    in place of flash attention (4 query heads on one kv-head at the smoke
    size: G > CHUNKED_MAX_G)."""
    cfg = dataclasses.replace(smoke_config(get_config("recurrentgemma-2b")), n_layers=8)
    model = models.init_params(cfg, seed=0, device=cuda)
    cache = models.init_cache(cfg, 2, 32, device=cuda)
    toks = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    want = {name: 0 for name in TK.KERNELS}
    step = {**want, "rmsnorm": 17, "gelu_mul": 8, "gelu": 6}
    TK.reset_launches()
    model.prefill(toks, cache, torch.tensor([8, 5], dtype=torch.int32, device=cuda))
    assert TK.launches() == {**step, "rglru_chunked": 6, "flash_attention": 2}
    TK.reset_launches()
    model.decode_step(toks[:, 0], cache)
    assert TK.launches() == {**step, "rglru": 6, "decode_attention_mma": 2}


@pytest.mark.parametrize("what,b,hq,hkv,sq,sk,d", [
    ("llama-3.2-vision cross at a wave", 2, 32, 8, 300, 1601, 128),
    ("whisper encoder", 2, 6, 6, 1500, 1500, 64),
    ("whisper cross at a wave", 2, 6, 6, 300, 1500, 64),
    ("llama-3.2-vision cross, one query", 3, 32, 8, 1, 1601, 128)])
def test_flash_non_causal_cross_shapes_on_card(cuda, what, b, hq, hkv, sq, sk, d):
    """Non-causal flash with Sq != Sk and Sk no multiple of a key tile, at
    the cross-attending models' head layouts, through the model's entry on
    (B, S, H, D) tensors: one launch of the wgmma kernel, per element
    against the plain version."""
    q = normal(30, (b, sq, hq, d), cuda, torch.bfloat16)
    k = normal(31, (b, sk, hkv, d), cuda, torch.bfloat16)
    v = normal(32, (b, sk, hkv, d), cuda, torch.bfloat16)
    before = TK.launches()
    got = models.layers.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    after = TK.launches()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == \
        {"flash_attention_wgmma": 1}
    want = models.layers.attention_reference(q, k, v, causal=False)
    assert rel_err(got, want) < TOL["bfloat16"] and attention_excess(got, want) <= 1, what


@pytest.mark.parametrize("hkv,g,nf,d,kern", [(8, 4, 1601, 128, "decode_attention_mma"),
                                             (6, 1, 1500, 64, "decode_attention_chunked")])
def test_cross_attention_at_decode_on_card(cuda, hkv, g, nf, d, kern):
    """A decode step's cross-attention at the served shapes through
    ``attend_all_keys`` over a layer of the cross cache (B, nf, Hkv * dh):
    whisper's G = 1 on the decode op's chunked kernel, llama-3.2-vision's
    G = 4 on its mma kernel, one launch, per element against the decode
    op's plain version with every length nf; and the decode op itself over
    the same keys (the same kernel) against the same."""
    b = 3
    cache = normal(33, (2, 2, b, nf, hkv * d), cuda, torch.bfloat16)
    k, v = cache[0, 1].view(b, nf, hkv, d), cache[1, 1].view(b, nf, hkv, d)
    q = normal(34, (b, hkv, g, d), cuda, torch.bfloat16)
    lengths = torch.full((b,), nf, dtype=torch.int32, device=cuda)
    want = decode_attention_ref(q, k, v, lengths)
    for op in (decode_ops.attend_all_keys,
               lambda q, k, v: decode_ops.decode_attention(q, k, v, lengths)):
        before = TK.launches()
        got = op(q, k, v)
        torch.cuda.synchronize()
        after = TK.launches()
        launched = {n: after[n] - before[n] for n in after if after[n] != before[n]}
        assert launched == {kern: 1}
        assert rel_err(got, want) < TOL["bfloat16"] and attention_excess(got, want) <= 1


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_cross_models_launches_per_step_on_card(cuda, arch):
    """Per prefill step of the smoke models (head dim 32: the mma.sync
    flash kernel; G = 2: the mma decode kernel): every norm, activation
    and attention of the decoder's self and cross layers, and whisper's
    encoder (2 norms, a gelu and a non-causal flash a layer, its final
    norm); per decode step the decoder's, the cross layers' on the decode
    kernel."""
    cfg = smoke_config(get_config(arch))
    model = models.init_params(cfg, seed=0, device=cuda)
    cache = models.init_cache(cfg, 2, 32, device=cuda)
    toks = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    fe = normal(35, (2, cfg.n_frontend_tokens, cfg.d_model), cuda, torch.bfloat16)
    want = {name: 0 for name in TK.KERNELS}
    if arch == "whisper-tiny":    # 2 encdec layers, 2 encoder layers
        prefill = {"layernorm": 12, "gelu": 4, "flash_attention": 6}
        decode = {"layernorm": 7, "gelu": 2, "decode_attention_mma": 4}
    else:                         # layers (attn, xattn)
        prefill = {"rmsnorm": 5, "silu_mul": 2, "flash_attention": 2}
        decode = {"rmsnorm": 5, "silu_mul": 2, "decode_attention_mma": 2}
    TK.reset_launches()
    model.prefill(toks, cache, frontend=fe)
    assert TK.launches() == {**want, **prefill}
    TK.reset_launches()
    model.decode_step(toks[:, 0], cache)
    assert TK.launches() == {**want, **decode}


# ---------------- the chunked decode kernel ----------------

def edge_lengths(d, t):
    """Cache lengths at the unit edges of head dim d (1, UK - 1, UK, UK + 1)
    and the full cache t."""
    c = chunk_keys(d)
    return [1, c - 1, c, c + 1, t]


@pytest.mark.parametrize("g", [1, 2, 3, 6, 8, 10])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_chunked_decode_matches_plain_on_card(cuda, d, g):
    """The chunked kernel against its plain version at every head dim and
    group size (granite's 3 and grok's 6 among them), lengths at the unit
    edges and the full cache, with softcap for groups of 2, 6 and 10: one
    launch a call, relative and per element."""
    t = 3 * chunk_keys(d) + 5
    hkv, cap = 2, 30.0 if g in (2, 6, 10) else 0.0
    lens = edge_lengths(d, t)
    q = normal(20, (len(lens), hkv, g, d), cuda, torch.bfloat16)
    k = normal(21, (len(lens), t, hkv, d), cuda, torch.bfloat16)
    v = normal(22, (len(lens), t, hkv, d), cuda, torch.bfloat16)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    assert chunked_eligible(q, k, v)
    before = TK.launches()
    got = TK.KERNELS["decode_attention_chunked"](q, k, v, lengths, softcap=cap)
    torch.cuda.synchronize()
    after = TK.launches()
    assert {n for n in after if after[n] != before[n]} == {"decode_attention_chunked"}
    assert after["decode_attention_chunked"] == before["decode_attention_chunked"] + 1
    want = decode_attention_ref(q, k, v, lengths, cap)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert rel_err(got, want) < TOL["bfloat16"]
    assert attention_excess(got, want) <= 1
    again = TK.KERNELS["decode_attention_chunked"](q, k, v, lengths, softcap=cap)
    assert torch.equal(got, again)       # the merge adds the chunks in order


@pytest.mark.parametrize("arch", sorted(SERVED_HEADS))
def test_chunked_decode_cache_views_on_card(cuda, arch):
    """The model's cache views (a layer of the fused (L, B, T, Hkv * D)
    cache viewed as (B, T, Hkv, D)) at each served head layout and mixed
    lengths, through the op: the chunked kernel takes every one of them,
    and the op runs it where G <= CHUNKED_MAX_G, the mma kernel beyond
    (qwen3-1.7b's G = 2, llama-3.2-vision's G = 4), per element, and no
    other kernel."""
    hq, hkv, d = SERVED_HEADS[arch]
    b, t = 4, 700
    cache = normal(23, (2, 2, b, t, hkv * d), cuda, torch.bfloat16)
    k, v = cache[0, 1].view(b, t, hkv, d), cache[1, 1].view(b, t, hkv, d)
    q = normal(24, (b, hkv, hq // hkv, d), cuda, torch.bfloat16)
    lengths = torch.tensor([700, 1, 333, 64], dtype=torch.int32, device=cuda)
    assert chunked_eligible(q, k, v)
    kern = "decode_attention_chunked" if picks_chunked(q, k, v) else "decode_attention_mma"
    assert decode_kernel(q, k, v) == kern
    before = TK.launches()
    got = decode_ops.decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    after = TK.launches()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == {kern: 1}
    want = decode_attention_ref(q, k, v, lengths)
    assert rel_err(got, want) < TOL["bfloat16"] and attention_excess(got, want) <= 1


def test_decode_op_reads_nothing_back_on_card(cuda):
    """The decode op on CUDA tensors under sync debug mode "error", on the
    chunked kernel (G = 1) and on the mma kernel (G = 4, and G = 20: two
    items of 16 heads): neither wrapper nor kernel reads the lengths (or
    anything else) back to the host, so a decode step can be captured in a
    CUDA graph."""
    lengths = torch.tensor([300, 1, 64, 65, 129, 200, 2, 299], dtype=torch.int32, device=cuda)
    k = normal(26, (8, 300, 8, 128), cuda, torch.bfloat16)
    for g, kern in ((1, "decode_attention_chunked"), (4, "decode_attention_mma"),
                    (20, "decode_attention_mma")):
        q = normal(25, (8, 8, g, 128), cuda, torch.bfloat16)
        decode_ops.decode_attention(q, k, k, lengths)       # builds and loads the library
        torch.cuda.synchronize()
        before = TK.launches()[kern]
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = decode_ops.decode_attention(q, k, k, lengths)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert TK.launches()[kern] == before + 1
        assert attention_excess(got, decode_attention_ref(q, k, k, lengths)) <= 1


def test_decode_paths_on_card(cuda):
    """fp32, and bf16 whose head stride no 16-byte load takes, run on the
    split kernel through the op, one launch each, against the plain version,
    at G = 2 and at G = 4 alike; the chunked and the mma wrappers refuse
    them."""
    lengths = torch.tensor([90, 7], dtype=torch.int32, device=cuda)
    for g in (2, 4):
        q32 = normal(27, (2, 2, g, 64), cuda, torch.float32)
        k32 = normal(28, (2, 90, 2, 64), cuda, torch.float32)
        odd = normal(29, (2, 90, 2, 68), cuda, torch.bfloat16)[..., :64]   # head stride 68
        for q, k, tol in ((q32, k32, TOL["float32"]), (q32.bfloat16(), odd, TOL["bfloat16"])):
            assert not chunked_eligible(q, k, k) and decode_kernel(q, k, k) == "decode_attention"
            before = TK.launches()
            got = decode_ops.decode_attention(q, k, k, lengths)
            torch.cuda.synchronize()
            after = TK.launches()
            assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == \
                {"decode_attention": 1}
            assert rel_err(got, decode_attention_ref(q, k, k, lengths)) < tol
            for name in ("decode_attention_chunked", "decode_attention_mma"):
                with pytest.raises(ValueError):
                    TK.KERNELS[name](q, k, k, lengths)


# ---------------- the mma decode kernel ----------------

def mma_edge_lengths(t):
    """Cache lengths 0 (the kernels write zeros), 1, at the mma kernel's unit
    edges (15, 16, 17 keys) and the full cache t."""
    u = MMA_UNIT_KEYS
    return [0, 1, u - 1, u, u + 1, t]


def hold_mma(q, k, v, lens, cap=0.0):
    """One launch of the mma kernel against its plain version: the rows of a
    slot at length 0 are zeros, the others relative and per element; a
    rerun gives the same bits. Returns the output."""
    lengths = torch.tensor(lens, dtype=torch.int32, device=q.device)
    before = TK.launches()
    got = TK.KERNELS["decode_attention_mma"](q, k, v, lengths, softcap=cap)
    torch.cuda.synchronize()
    after = TK.launches()
    assert {n: after[n] - before[n] for n in after if after[n] != before[n]} == \
        {"decode_attention_mma": 1}
    want = decode_attention_ref(q, k, v, lengths, cap)
    assert got.shape == want.shape and got.dtype == want.dtype
    live = [i for i, n in enumerate(lens) if n > 0]
    assert all((got[i] == 0).all() for i, n in enumerate(lens) if n == 0)
    assert rel_err(got[live], want[live]) < TOL["bfloat16"]
    assert attention_excess(got[live], want[live]) <= 1
    again = TK.KERNELS["decode_attention_mma"](q, k, v, lengths, softcap=cap)
    assert torch.equal(got, again)       # the merge adds the segments in order
    return got


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("g", [2, 3, 4, 6, 8, 10, 16])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_mma_decode_matches_plain_on_card(cuda, d, g, cap):
    """The mma kernel against its plain version at every head dim and group
    size (qwen3's 2, granite's 3, llama-3.2-vision's 4, grok's 6 and
    recurrentgemma's 10 among them), with and without a softcap, lengths 0,
    1, at the unit
    edges and the full cache: one launch a call, relative and per element,
    the same bits in a rerun."""
    t, hkv = 3 * MMA_UNIT_KEYS + 5, 2
    lens = mma_edge_lengths(t)
    q = normal(40, (len(lens), hkv, g, d), cuda, torch.bfloat16) * (4.0 if cap else 1.0)
    k = normal(41, (len(lens), t, hkv, d), cuda, torch.bfloat16)
    v = normal(42, (len(lens), t, hkv, d), cuda, torch.bfloat16)
    assert chunked_eligible(q, k, v)
    hold_mma(q, k, v, lens, cap)


# (hq, hkv, d, softcap) of the served models that run the mma kernel
MMA_SERVED = {"qwen3-1.7b": (16, 8, 128, 0.0), "granite-moe-3b-a800m": (24, 8, 64, 0.0),
              "llama-3.2-vision-11b": (32, 8, 128, 0.0), "grok-1-314b": (48, 8, 128, 30.0),
              "recurrentgemma-2b": (10, 1, 256, 0.0)}


@pytest.mark.parametrize("arch", sorted(MMA_SERVED))
def test_mma_decode_cache_views_on_card(cuda, arch):
    """The served G >= 2 head layouts on the model's cache views (a layer of
    the fused (L, B, T, Hkv * D) cache), 8 slots over T = 1024 at the
    served mixed lengths with a slot at 0 (runs of one segment and of
    several): the wrapper held, and the op on the same kernel, the same
    bits."""
    hq, hkv, d, cap = MMA_SERVED[arch]
    b, t = 8, 1024
    cache = normal(43, (2, 2, b, t, hkv * d), cuda, torch.bfloat16)
    k, v = cache[0, 1].view(b, t, hkv, d), cache[1, 1].view(b, t, hkv, d)
    q = normal(44, (b, hkv, hq // hkv, d), cuda, torch.bfloat16)
    lens = [1024, 0, 322, 419, 516, 196, 293, 390]
    got = hold_mma(q, k, v, lens, cap)
    assert decode_kernel(q, k, v) == "decode_attention_mma"
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    assert torch.equal(decode_ops.decode_attention(q, k, v, lengths, softcap=cap), got)


# ---------------- the fp32 GEMM on the TMA ring ----------------

@pytest.mark.parametrize("m", [1, 8, 63, 65, 200])
def test_every_f32_tma_tile_on_card(cuda, m):
    """Every compiled tile of the fp32 mode at M = 1, 8, 63, 65 and 200, with
    a K tail (K not a multiple of 32) and an N edge (N not a multiple of
    128), relative (2e-5) and element by element (``gemm_excess``)."""
    k, n = 300, 132
    a = normal(30, (m, k), cuda, torch.float32)
    b = normal(31, (k, n), cuda, torch.float32)
    assert tma_eligible(torch.float32, m, k, n, a.data_ptr(), b.data_ptr())
    want = matmul_ref(a, b)
    for bm, bk, bn in TILES[torch.float32]:
        got = TK.KERNELS["matmul_f32_tma"](a, b, bm=bm, bk=bk, bn=bn)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype
        assert rel_err(got, want) < GEMM_TOL["float32"], (bm, bk, bn, m)
        assert gemm_excess(got, want, a, b) <= 1, (bm, bk, bn, m)


def test_f32_tma_split_k_on_card(cuda):
    """gpt3-175b's out projection at M = 8 splits K three ways on the decode
    tile: one reduction a GEMM, counted; bit-identical results on two runs;
    2e-5 and the per-element check."""
    m, k, n = 8, 12288, 12288
    tile = TILES[torch.float32][0]
    assert len(split_plan(m, n, k, tile)) == 3
    a = normal(32, (m, k), cuda, torch.float32)
    b = normal(33, (k, n), cuda, torch.float32)
    before = TK.launches()
    got = TK.KERNELS["matmul_f32_tma"](a, b, bm=tile[0], bk=tile[1], bn=tile[2])
    again = TK.KERNELS["matmul_f32_tma"](a, b, bm=tile[0], bk=tile[1], bn=tile[2])
    torch.cuda.synchronize()
    after = TK.launches()
    assert after["matmul_f32_tma"] - before["matmul_f32_tma"] == 2
    assert after["matmul_reduce"] - before["matmul_reduce"] == 2
    assert torch.equal(got, again)
    want = matmul_ref(a, b)
    assert rel_err(got, want) < GEMM_TOL["float32"]
    assert gemm_excess(got, want, a, b) <= 1


def test_f32_gemm_paths_on_card(cuda):
    """The fp32 op routes before the launch: K and N multiples of 4 at
    aligned bases to the TMA ring's fp32 mode only; K = 130, N = 77 and an
    operand 4 bytes past an aligned base to the SIMT kernel of matmul.cu
    only, each against the plain version (a split of K adds its
    reduction); the fp32 TMA wrapper refuses those."""
    flat = normal(34, (64 * 256 + 1,), cuda, torch.float32)
    cases = [(normal(35, (64, 256), cuda, torch.float32),
              normal(36, (256, 96), cuda, torch.float32), "matmul_f32_tma"),
             (normal(37, (33, 130), cuda, torch.float32),
              normal(38, (130, 64), cuda, torch.float32), "matmul"),
             (normal(39, (33, 64), cuda, torch.float32),
              normal(40, (64, 77), cuda, torch.float32), "matmul"),
             (flat[1:].view(64, 256), normal(41, (256, 96), cuda, torch.float32), "matmul")]
    for a, b, path in cases:
        before = TK.launches()
        got = mm_ops.matmul(a, b)
        torch.cuda.synchronize()
        after = TK.launches()
        grown = {n for n in after if after[n] != before[n]}
        assert grown - {"matmul_reduce"} == {path} and after[path] == before[path] + 1
        assert gemm_excess(got, matmul_ref(a, b), a, b) <= 1
        if path == "matmul":
            assert "matmul_reduce" not in grown
            with pytest.raises(ValueError, match="16-byte"):
                TK.KERNELS["matmul_f32_tma"](a, b)


# ---------------- backward kernels and the train step ----------------

def within_one_rounding(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return bool(((a - b).abs() <= 2.0 ** -7 * b.abs() + 1e-3).all())


def attention_operands(seed, B, H, S, D, layout, device):
    """(B, H, S, D) bf16: contiguous, or a transposed view of (B, S, H, D)
    as the model passes them."""
    if layout == "bshd":
        return normal(seed, (B, S, H, D), device, torch.bfloat16).transpose(1, 2)
    return normal(seed, (B, H, S, D), device, torch.bfloat16)


# (B, Hq, Hkv, S, D, causal, layout): qwen3-1.7b's heads (16 on 8, D 128),
# qwen2-0.5b's (14 on 2, D 64), MHA, lengths that cut a 64-row tile, and the
# model's transposed views
FLASH_BWD_CASES = [(2, 16, 8, 128, 128, True, "bhsd"), (2, 14, 2, 100, 64, True, "bshd"),
                   (1, 4, 4, 77, 64, False, "bhsd"), (2, 8, 8, 130, 128, False, "bshd"),
                   (1, 6, 2, 33, 128, True, "bshd")]


@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=str)
def test_flash_attention_bwd_matches_plain_on_card(cuda, case):
    B, Hq, Hkv, S, D, causal, layout = case
    q = attention_operands(50, B, Hq, S, D, layout, cuda)
    k = attention_operands(51, B, Hkv, S, D, layout, cuda)
    v = attention_operands(52, B, Hkv, S, D, layout, cuda)
    do = attention_operands(53, B, Hq, S, D, layout, cuda)
    o = flash_ops.flash_attention(q, k, v, causal=causal)
    fn = TK.KERNELS["flash_attention_bwd"]
    before = fn.launches
    got = fn(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = attention_bwd_ref(q, k, v, o, do, causal=causal)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype and g.stride() == t.stride()
        assert rel_err(g, w) < TOL["bfloat16"]


# the wgmma backward: FLASH_BWD_CASES and lengths that cut its 128-row
# query tile (333, 130)
FLASH_BWD_WGMMA_CASES = FLASH_BWD_CASES + [(2, 16, 8, 333, 128, True, "bshd"),
                                           (2, 14, 2, 130, 64, True, "bshd"),
                                           (1, 8, 8, 130, 128, False, "bhsd")]


@pytest.mark.parametrize("case", FLASH_BWD_WGMMA_CASES, ids=str)
def test_flash_attention_bwd_wgmma_matches_plain_on_card(cuda, case):
    """The TMA + wgmma backward, given the forward's log-sum-exp, against
    the plain version; dq, dk, dv keep q's and k's layouts and are the same
    bits in a second run (no atomics); one launch counted, none on the
    mma.sync backward."""
    B, Hq, Hkv, S, D, causal, layout = case
    q = attention_operands(50, B, Hq, S, D, layout, cuda)
    k = attention_operands(51, B, Hkv, S, D, layout, cuda)
    v = attention_operands(52, B, Hkv, S, D, layout, cuda)
    do = attention_operands(53, B, Hq, S, D, layout, cuda)
    assert bwd_wgmma_eligible(q, k, v, q, do)
    o, lse = flash_kernel.attention_cuda(q, k, v, causal=causal, with_lse=True)
    fn = TK.KERNELS["flash_attention_bwd_wgmma"]
    before, old = fn.launches, TK.KERNELS["flash_attention_bwd"].launches
    got = flash_kernel.attention_bwd_cuda(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and TK.KERNELS["flash_attention_bwd"].launches == old
    want = attention_bwd_ref(q, k, v, o, do, causal=causal)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype and g.stride() == t.stride()
        assert rel_err(g, w) < TOL["bfloat16"]
    again = fn(q, k, v, o, do, lse, causal=causal)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_flash_attention_bwd_old_route_for_strides_tma_cannot_take_on_card(cuda):
    """Operands whose sequence stride TMA cannot describe (132 elements a
    row of D = 128), even given a log-sum-exp, and operands TMA can take
    but no log-sum-exp, go to the mma.sync backward, which stays right."""
    def heads(i):
        return 16 if i in (0, 3) else 8
    wide = [normal(60 + i, (2, heads(i), 100, 132), cuda, torch.bfloat16)[..., :128]
            for i in range(4)]
    view = [attention_operands(64 + i, 2, heads(i), 100, 128, "bshd", cuda) for i in range(4)]
    assert not wgmma_eligible(*wide[:3]) and bwd_wgmma_eligible(*view[:3], view[0], view[3])
    for (q, k, v, do), lse in ((wide, torch.zeros(2, 16, 100, device=cuda)), (view, None)):
        o = flash_ops.flash_attention(q, k, v, causal=True)
        new = TK.KERNELS["flash_attention_bwd_wgmma"].launches
        old = TK.KERNELS["flash_attention_bwd"].launches
        got = flash_kernel.attention_bwd_cuda(q, k, v, o, do, lse, causal=True)
        torch.cuda.synchronize()
        assert TK.KERNELS["flash_attention_bwd"].launches == old + 1
        assert TK.KERNELS["flash_attention_bwd_wgmma"].launches == new
        for g, w, t in zip(got, attention_bwd_ref(q, k, v, o, do, causal=True), (q, k, v)):
            assert g.shape == t.shape and rel_err(g, w) < TOL["bfloat16"]


@pytest.mark.parametrize("case", [(2, 16, 8, 128, 128, True, "bshd"),
                                  (2, 14, 2, 100, 64, True, "bshd"),
                                  (1, 4, 4, 77, 64, False, "bhsd"),
                                  (2, 10, 1, 130, 256, True, "bshd")], ids=str)
def test_flash_forward_lse_matches_plain_on_card(cuda, case):
    """The wgmma forward's log-sum-exp against ``attention_lse_ref`` at fp32
    2e-5 relative (to max(|L|, 1)); the served forward, which writes none,
    gives the same output bits as the forward that writes it."""
    B, Hq, Hkv, S, D, causal, layout = case
    q = attention_operands(70, B, Hq, S, D, layout, cuda)
    k = attention_operands(71, B, Hkv, S, D, layout, cuda)
    v = attention_operands(72, B, Hkv, S, D, layout, cuda)
    lse = torch.full((B, Hq, S), float("nan"), device=cuda)
    fwd = TK.KERNELS["flash_attention_wgmma"]
    o = fwd(q, k, v, causal=causal, lse=lse)
    served = fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = attention_lse_ref(q, k, causal=causal)
    assert ((lse - want).abs() / want.abs().clamp_min(1.0)).max().item() < TOL["float32"]
    assert torch.equal(o, served)


def test_flash_attention_bwd_refuses_what_it_does_not_take_on_card(cuda):
    """What the backward kernels still refuse: D = 256 on the mma.sync one
    (ROADMAP B28), a head dim neither has, fp32, and strides TMA cannot take
    on the wgmma one; a window and a softcap they now take."""
    q = normal(54, (1, 2, 16, 64), cuda, torch.bfloat16)
    lse = torch.zeros(1, 2, 16, device=cuda)
    fn = TK.KERNELS["flash_attention_bwd"]
    new = TK.KERNELS["flash_attention_bwd_wgmma"]
    wide256 = normal(57, (1, 2, 16, 260), cuda, torch.bfloat16)[..., :256]
    with pytest.raises(ValueError, match="B28"):
        fn(wide256, wide256, wide256, wide256, wide256)
    for t in (normal(55, (1, 2, 16, 32), cuda, torch.bfloat16), q.float()):
        with pytest.raises(ValueError):
            fn(t, t, t, t, t)
        with pytest.raises(ValueError):
            new(t, t, t, t, t, torch.zeros(t.shape[:3], device=cuda))
    wide = normal(56, (1, 2, 16, 68), cuda, torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        new(wide, wide, wide, wide, wide, lse)
    for kw in ({"window": 8}, {"softcap": 30.0}):
        fn(q, q, q, q, q, **kw)
        new(q, q, q, q, q, lse, **kw)
    torch.cuda.synchronize()


# (B, Hq, Hkv, S, D, window, softcap, q scale): recurrentgemma's 10 heads on
# 1 at D = 256, causal and under windows that cut key tiles; windows of 32
# and 48 at D 64 and 128 on odd lengths; grok's softcap of 30 on logits of
# about 8 (q x 8); window and softcap together, also at D = 256; at D = 256
# a softcap alone and a window alone on lengths off the 64-row tile, and
# recurrentgemma's train shape, whose dk/dv tiles split over several blocks
# each (bwd_dkdv_plan)
FLASH_BWD_MODE_CASES = [(1, 10, 1, 130, 256, 0, 0.0, 1.0), (2, 10, 1, 300, 256, 64, 0.0, 1.0),
                        (1, 4, 2, 333, 64, 32, 0.0, 1.0), (1, 4, 2, 301, 128, 48, 0.0, 1.0),
                        (2, 6, 1, 200, 128, 0, 30.0, 8.0), (1, 4, 2, 257, 128, 40, 20.0, 6.0),
                        (1, 10, 1, 200, 256, 70, 30.0, 8.0), (2, 10, 1, 333, 256, 0, 30.0, 8.0),
                        (1, 10, 1, 77, 256, 40, 0.0, 1.0), (8, 10, 1, 512, 256, 2048, 0.0, 1.0)]


@pytest.mark.parametrize("case", FLASH_BWD_MODE_CASES, ids=str)
def test_flash_attention_bwd_wgmma_modes_match_plain_on_card(cuda, case):
    """The wgmma forward's L and the wgmma backward under a window, a
    softcap and at D = 256, on the model's (B, S, H, D) views: L within
    2e-5 of ``attention_lse_ref`` (relative to max(|L|, 1)); dq, dk, dv
    within 2e-2 of ``attention_bwd_ref``, the same bits in a second run,
    one launch and none on the mma.sync backward."""
    B, Hq, Hkv, S, D, window, cap, qs = case
    q = attention_operands(80, B, Hq, S, D, "bshd", cuda) * qs
    k = attention_operands(81, B, Hkv, S, D, "bshd", cuda)
    v = attention_operands(82, B, Hkv, S, D, "bshd", cuda)
    do = attention_operands(83, B, Hq, S, D, "bshd", cuda)
    kw = dict(causal=True, window=window, softcap=cap)
    o, lse = flash_kernel.attention_cuda(q, k, v, **kw, with_lse=True)
    assert bwd_wgmma_eligible(q, k, v, o, do)
    want_lse = attention_lse_ref(q, k, **kw)
    assert ((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max().item() < TOL["float32"]
    fn = TK.KERNELS["flash_attention_bwd_wgmma"]
    before, old = fn.launches, TK.KERNELS["flash_attention_bwd"].launches
    got = flash_kernel.attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and TK.KERNELS["flash_attention_bwd"].launches == old
    want = attention_bwd_ref(q, k, v, o, do, **kw)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == t.dtype and g.stride() == t.stride()
        assert rel_err(g, w) < TOL["bfloat16"]
    again = fn(q, k, v, o, do, lse, **kw)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("D,window,cap", [(64, 32, 0.0), (128, 0, 30.0), (128, 24, 20.0)])
def test_flash_attention_bwd_modes_at_strides_tma_cannot_take_on_card(cuda, D, window, cap):
    """The mma.sync backward under a window, a softcap and both, at a
    sequence stride of D + 4 (which TMA cannot describe): within 2e-2 of
    the plain version, one launch on it."""
    def wide(seed, h):
        return normal(seed, (2, h, 150, D + 4), cuda, torch.bfloat16)[..., :D]
    q, k, v, do = wide(90, 8) * 6, wide(91, 2), wide(92, 2), wide(93, 8)
    kw = dict(causal=True, window=window, softcap=cap)
    assert not wgmma_eligible(q, k, v)
    o = flash_ops.flash_attention(q, k, v, **kw)
    old = TK.KERNELS["flash_attention_bwd"].launches
    got = flash_kernel.attention_bwd_cuda(q, k, v, o, do, None, **kw)
    torch.cuda.synchronize()
    assert TK.KERNELS["flash_attention_bwd"].launches == old + 1
    for g, w in zip(got, attention_bwd_ref(q, k, v, o, do, **kw)):
        assert rel_err(g, w) < TOL["bfloat16"]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("r,c", [(300, 2048), (1000, 128), (7, 1024), (4099, 896),
                                 (65536, 128), (32768, 128)])
def test_rmsnorm_bwd_matches_plain_on_card(cuda, r, c, dtype):
    x = normal(56, (r, c), cuda, DTYPES[dtype]) * 3
    g = normal(57, (c,), cuda, torch.float32)
    dy = normal(58, (r, c), cuda, DTYPES[dtype])
    fn = TK.KERNELS["rmsnorm_bwd"]
    before = fn.launches
    dx, dg = fn(x, g, dy)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want_dx, want_dg = rmsnorm_bwd_ref(x, g, dy)
    assert dx.dtype == x.dtype and dg.dtype == torch.float32
    assert rel_err(dx, want_dx) < TOL[dtype]
    assert rel_err(dg, want_dg) < TOL["float32"]
    if dtype == "bfloat16":
        assert within_one_rounding(dx, want_dx)
    again = fn(x, g, dy)[1]
    assert torch.equal(again, dg)      # the column sum has a fixed order


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(100, 256), (1000, 1536), (3, 1001)])
def test_silu_mul_bwd_matches_plain_on_card(cuda, shape, dtype):
    g = normal(59, shape, cuda, DTYPES[dtype]) * 3
    u = normal(60, shape, cuda, DTYPES[dtype])
    dy = normal(61, shape, cuda, DTYPES[dtype])
    fn = TK.KERNELS["silu_mul_bwd"]
    before = fn.launches
    got = fn(g, u, dy)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    for a, w in zip(got, silu_mul_bwd_ref(g, u, dy)):
        assert a.dtype == g.dtype and rel_err(a, w) < TOL[dtype]
        if dtype == "bfloat16":
            assert within_one_rounding(a, w)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("r,c,pad", [(300, 2048, 0), (4096, 384, 0), (7, 1024, 0),
                                     (4099, 896, 0), (100, 12288, 0), (33, 2100, 0),
                                     (1, 5000, 0), (4096, 4096, 0), (4096, 12288, 0),
                                     (300, 2048, 2), (4096, 384, 2)])
def test_layernorm_bwd_matches_plain_on_card(cuda, r, c, pad, dtype):
    """Through the router ``layernorm_bwd``, rows `pad` elements apart
    beyond c: the ring kernel (``csrc/layernorm_bwd.cu``) at the model rows,
    whole or ragged, and the Triton kernel where the ring does not take the
    rows (2100 in bf16, a 4200-byte pitch; 12288 in fp32, wider than the
    plan; the pitches of 2050 and 386 elements) or runs slower (4096 in
    bf16: one Triton chunk a row); the launch count of the kernel the route
    names moves by one and the other's not at all; dx within one bf16
    rounding, dg and db to 2e-5 in fp32 and the same bits in a second run.
    Where the ring takes rows the router sends to the Triton kernel, the
    ring kernel is held the same way."""
    from repro_torch.kernels.rmsnorm import kernel as K
    x = (normal(62, (r, c + pad), cuda, DTYPES[dtype]) * 3 + 1.5)[:, :c]
    g = normal(63, (c,), cuda, torch.float32)
    dy = normal(64, (r, c + pad), cuda, DTYPES[dtype])[:, :c]
    route = K.layernorm_bwd_route(x, dy)
    bf16 = dtype == "bfloat16"
    triton = pad or (c == 2100 or 2048 < c <= 4096) and bf16 or c == 12288 and not bf16
    assert route == ("layernorm_bwd_triton" if triton else "layernorm_bwd")
    want_dx, want_dg, want_db = layernorm_bwd_ref(x, g, dy)
    kernels = {route: K.layernorm_bwd}
    if route == "layernorm_bwd_triton" and K._ring_plan_of(x, dy) is not None:
        kernels["layernorm_bwd"] = TK.KERNELS["layernorm_bwd"]
    for name, fn in kernels.items():
        before = TK.launches()
        dx, dg, db = fn(x, g, dy)
        torch.cuda.synchronize()
        after = TK.launches()
        assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {name: 1}
        assert dx.dtype == x.dtype and dg.dtype == db.dtype == torch.float32
        assert rel_err(dx, want_dx) < TOL[dtype]
        assert rel_err(dg, want_dg) < TOL["float32"] and rel_err(db, want_db) < TOL["float32"]
        if bf16:
            assert within_one_rounding(dx, want_dx)
        again = fn(x, g, dy)
        assert torch.equal(again[1], dg) and torch.equal(again[2], db)   # fixed-order sums


def test_layernorm_bwd_back_to_back_on_card(cuda):
    """Three launches of the ring kernel of three shapes on one stream, with
    no synchronise between them: the grid barrier's counters and the partial
    rows carry nothing from one launch to the next (each held to its plain
    version), and the counters are back at 0 after."""
    from repro_torch.kernels.rmsnorm import kernel as K
    ins = [(normal(70 + i, (r, c), cuda, torch.bfloat16) * 3 + 1.5,
            normal(80 + i, (c,), cuda, torch.float32), normal(90 + i, (r, c), cuda, torch.bfloat16))
           for i, (r, c) in enumerate(((4096, 2048), (33, 384), (500, 4096)))]
    before = TK.KERNELS["layernorm_bwd"].launches
    outs = [TK.KERNELS["layernorm_bwd"](*a) for a in ins]
    torch.cuda.synchronize()
    assert TK.KERNELS["layernorm_bwd"].launches == before + 3
    for a, (dx, dg, db) in zip(ins, outs):
        want_dx, want_dg, want_db = layernorm_bwd_ref(*a)
        assert within_one_rounding(dx, want_dx)
        assert rel_err(dg, want_dg) < TOL["float32"] and rel_err(db, want_db) < TOL["float32"]
    device = ins[0][0].device
    assert not K._counter(device, torch.cuda.current_stream(device).cuda_stream).any()


def gelu_inputs(seed, shape, device, dtype, n):
    """n tensors of `shape`, the first with elements where gelu' saturates
    and where x^3 overflows fp32."""
    ts = [normal(seed + i, shape, device, dtype) for i in range(n)]
    ts[0] = ts[0] * 3
    tails = torch.tensor([-1e30, -1e4, -20.0, -9.5, 9.5, 20.0, 1e4, 1e30], device=device)
    k = min(8, ts[0].numel())
    ts[0].view(-1)[:k] = tails[:k].to(dtype)
    return ts


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(100, 256), (1000, 1536), (3, 1001), (8, 49152)])
def test_gelu_bwd_matches_plain_on_card(cuda, shape, dtype):
    x, dy = gelu_inputs(65, shape, cuda, DTYPES[dtype], 2)
    fn = TK.KERNELS["gelu_bwd"]
    before = fn.launches
    got = fn(x, dy)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = gelu_bwd_ref(x, dy)
    assert got.dtype == x.dtype and torch.isfinite(got).all()
    assert rel_err(got, want) < TOL[dtype]
    assert within_one_rounding(got.view(-1)[:8], want.view(-1)[:8])      # the tails
    if dtype == "bfloat16":
        assert within_one_rounding(got, want)
    off = fn(x.view(-1)[1:], dy.view(-1)[1:])        # bases off 16 bytes: the scalar variant
    assert rel_err(off, gelu_bwd_ref(x.view(-1)[1:], dy.view(-1)[1:])) < TOL[dtype]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(100, 256), (4096, 7680), (3, 1001)])
def test_gelu_mul_bwd_matches_plain_on_card(cuda, shape, dtype):
    g, u, dy = gelu_inputs(68, shape, cuda, DTYPES[dtype], 3)
    fn = TK.KERNELS["gelu_mul_bwd"]
    before = fn.launches
    got = fn(g, u, dy)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    for a, w in zip(got, gelu_mul_bwd_ref(g, u, dy)):
        assert a.dtype == g.dtype and torch.isfinite(a).all()
        # past the tails: du = dy gelu(g) at g = 1e30 would swamp the rest
        assert rel_err(a.view(-1)[8:], w.view(-1)[8:]) < TOL[dtype]
        assert within_one_rounding(a.view(-1)[:8], w.view(-1)[:8])
        if dtype == "bfloat16":
            assert within_one_rounding(a, w)


@pytest.mark.parametrize("steps", SEGMENT_STEPS)
@pytest.mark.parametrize("B,T,d,with_h0", [(2, 333, 256, False), (1, 1100, 64, True),
                                           (3, 5, 2552, True), (2, 1, 64, False)])
def test_rglru_bwd_matches_plain_on_card(cuda, steps, B, T, d, with_h0):
    """``rglru_bwd_cuda`` from the segments' states the chunked forward
    wrote, against ``rglru_bwd_ref``: the fp32 dga, dgx, dlam and dh0 within
    1e-4 relative to the largest, the bf16 du and dgate within one bf16
    rounding of each element (both sides round their fp32 value once), ga
    at -40 on a quarter of the channels (the clamp holds there), the final
    state's gradient given; the same bits in a second run; one launch
    counted."""
    u, ga, gx, lam, gate, h0 = rglru_case(cuda, B, T, d, 90 + T, with_h0)
    ga[..., : d // 4] = -40.0
    dy = normal(95, (B, T, d), cuda, torch.float32)
    dh_last = normal(96, (B, d), cuda, torch.float32)
    h_seg = torch.empty((B, rglru_segments(T, steps), d), device=cuda)
    y, h = TK.KERNELS["rglru_chunked"](u, ga, gx, lam, gate, h0, steps=steps, h_seg=h_seg)
    fn = TK.KERNELS["rglru_bwd"]
    before = fn.launches
    got = fn(u, ga, gx, lam, gate, h_seg, dy, dh_last, steps=steps, with_dh0=with_h0)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = rglru_bwd_ref(u, ga, gx, lam, gate, h0, dy, dh_last)
    assert (got[5] is None) == (want[5] is None)
    for name, g, w in zip(("du", "dga", "dgx", "dlam", "dgate", "dh0"), got, want):
        if w is None:
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if w.dtype == torch.bfloat16:
            assert within_one_rounding(g, w), name
        else:
            assert rel_err(g, w) < 1e-4, (name, rel_err(g, w))
    again = fn(u, ga, gx, lam, gate, h_seg, dy, dh_last, steps=steps, with_dh0=with_h0)
    assert all(a is None or torch.equal(a, g) for a, g in zip(again, got))


def test_rglru_op_trains_through_its_kernels_on_card(cuda):
    """The op with a gradient due: the forward on the chunked kernel (one
    launch, its output the served one's bits), the backward on
    ``rglru_bwd`` (one launch), autograd's gradients those of the plain
    backward (fp32 at 1e-4, bf16 within one rounding)."""
    u, ga, gx, lam, gate, h0 = rglru_case(cuda, 2, 200, 512, 7, True)
    leaves = [t.clone().requires_grad_(True) for t in (u, ga, gx, lam, gate, h0)]
    TK.reset_launches()
    y, _ = rglru_ops.rglru(*leaves)
    dy = normal(97, y.shape, cuda, torch.float32)
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    counts = TK.launches()
    assert counts["rglru_chunked"] == 1 and counts["rglru_bwd"] == 1 and counts["rglru"] == 0
    served, _ = rglru_ops.rglru(u, ga, gx, lam, gate, h0)
    assert torch.equal(y.detach(), served)
    for name, g, w in zip(("du", "dga", "dgx", "dlam", "dgate", "dh0"), grads,
                          rglru_bwd_ref(u, ga, gx, lam, gate, h0, dy)):
        assert g.dtype == w.dtype, name
        if w.dtype == torch.bfloat16:
            assert within_one_rounding(g, w), name
        else:
            assert rel_err(g, w) < 1e-4, (name, rel_err(g, w))


# ---------------- the wkv backward ----------------

def wkv_train_case(device, B, T, H, seed, with_state, edge=False):
    """r, k, v, the output's and the final state's gradients normal; w
    across (0.05, 0.999) (the init's w0 = -6 would put every decay near
    0.9975 and hide them), with a fifth each of exact 0, 1e-30 and exact 1
    where `edge`; u at the init's scale of 0.3; state0 normal if asked."""
    N = 64
    r, k, v, dout = (normal(seed + i, (B, T, H, N), device, torch.float32) for i in range(4))
    w = 0.05 + 0.949 * torch.rand((B, T, H, N), generator=torch.Generator().manual_seed(seed),
                                  dtype=torch.float32).to(device)
    if edge:
        pick = torch.from_numpy(np.random.default_rng(seed).integers(0, 5, w.shape)).to(device)
        w = torch.where(pick == 0, 0.0, torch.where(pick == 1, 1e-30, torch.where(
            pick == 2, 1.0, w)))
    u = 0.3 * normal(seed + 4, (H, N), device, torch.float32)
    s0 = normal(seed + 5, (B, H, N, N), device, torch.float32) if with_state else None
    dstate = normal(seed + 6, (B, H, N, N), device, torch.float32)
    return r, k, v, w, u, s0, dout, dstate


def segment_states(r, k, v, w, s0):
    """The plain states at the start of every segment of WKV_SEG steps."""
    B, T, H, N = r.shape
    S = torch.zeros((B, H, N, N), device=r.device) if s0 is None else s0.clone()
    out = []
    for t in range(T):
        if t % WKV_SEG == 0:
            out.append(S)
        S = S * w[:, t, :, :, None] + k[:, t, :, :, None] * v[:, t, :, None, :]
    return torch.stack(out, 2)


@pytest.mark.parametrize("B,T,H,with_state", [(2, 200, 4, True), (1, 64, 2, False),
                                              (3, 65, 2, True), (2, 2, 3, False)])
def test_wkv_chunked_writes_segment_states_on_card(cuda, B, T, H, with_state):
    """Given s_seg, the chunked forward writes each segment's starting state
    (1e-4 of the largest, as the output), and its output and final state
    are the bits of the served call without it; with lengths it refuses."""
    r, k, v, w, u, s0, _, _ = wkv_train_case(cuda, B, T, H, 30 + T, with_state)
    s_seg = torch.empty((B, H, wkv_segments(T), 64, 64), device=cuda)
    fn = TK.KERNELS["wkv_chunked"]
    out, state = fn(r, k, v, w, u, s0, s_seg=s_seg)
    served_out, served_state = fn(r, k, v, w, u, s0)
    assert torch.equal(out, served_out) and torch.equal(state, served_state)
    assert rel_err(s_seg, segment_states(r, k, v, w, s0)) < 1e-4
    with pytest.raises(ValueError, match="no lengths"):
        fn(r, k, v, w, u, s0, torch.full((B,), T, dtype=torch.int32, device=cuda), s_seg=s_seg)


@pytest.mark.parametrize("B,T,H,with_state,edge", [(2, 333, 4, True, False),
                                                   (1, 64, 2, False, False),
                                                   (8, 512, 8, False, False),
                                                   (3, 90, 2, True, True),
                                                   (2, 17, 3, True, False),
                                                   (2, 2, 1, False, False),
                                                   (1, 200, 64, True, False),
                                                   (4, 48, 33, False, False),
                                                   (1, 129, 5, True, True)])
def test_wkv_bwd_matches_plain_on_card(cuda, B, T, H, with_state, edge):
    """``wkv_bwd_cuda`` from the segments' states the chunked forward
    wrote, against ``wkv_bwd_ref``: every gradient within 1e-4 of the
    largest (the wkv tolerance), the final state's gradient given, dw 0
    where the forward clamps log w (exact 0 and 1e-30); the same bits in a
    second run; one launch counted."""
    r, k, v, w, u, s0, dout, dstate = wkv_train_case(cuda, B, T, H, 40 + T, with_state, edge)
    s_seg = torch.empty((B, H, wkv_segments(T), 64, 64), device=cuda)
    TK.KERNELS["wkv_chunked"](r, k, v, w, u, s0, s_seg=s_seg)
    fn = TK.KERNELS["wkv_bwd"]
    before = fn.launches
    got = fn(r, k, v, w, u, s_seg, dout, dstate, with_dstate0=with_state)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = wkv_bwd_ref(r, k, v, w, u, s0, dout, dstate)
    assert (got[5] is None) == (want[5] is None)
    for name, g, x in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got, want):
        if x is None:
            continue
        assert g.shape == x.shape and g.dtype == torch.float32, name
        assert rel_err(g, x) < 1e-4, (name, rel_err(g, x))
    if edge:
        assert not got[3][w <= 1e-30].any()
    again = fn(r, k, v, w, u, s_seg, dout, dstate, with_dstate0=with_state)
    assert all(a is None or torch.equal(a, g) for a, g in zip(again, got))


def test_wkv_op_trains_through_its_kernels_on_card(cuda):
    """The op with a gradient due: the forward on the chunked kernel (one
    launch, its output the served one's bits), the backward on wkv_bwd
    (one launch), autograd's gradients those of the plain backward at
    1e-4; with lengths the backward raises, and so does a head size the
    backward kernel does not take, or a bad input to it."""
    r, k, v, w, u, s0, dout, _ = wkv_train_case(cuda, 2, 150, 4, 7, True)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u, s0)]
    TK.reset_launches()
    out, _ = wkv_ops.wkv(*leaves)
    grads = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    counts = TK.launches()
    assert counts["wkv_chunked"] == 1 and counts["wkv_bwd"] == 1 and counts["wkv"] == 0
    served, _ = wkv_ops.wkv(r, k, v, w, u, s0)
    assert torch.equal(out.detach(), served)
    for name, g, x in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), grads,
                          wkv_bwd_ref(r, k, v, w, u, s0, dout)):
        assert rel_err(g, x) < 1e-4, (name, rel_err(g, x))
    out, _ = wkv_ops.wkv(*leaves, torch.full((2,), 150, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="no lengths"):
        out.sum().backward()
    with pytest.raises(ValueError, match="B30"):
        wkv_ops.wkv(*(t[..., :32] for t in leaves[:5]))
    s_seg = torch.empty((2, 4, wkv_segments(150), 64, 64), device=cuda)
    with pytest.raises(ValueError, match="B30"):
        TK.KERNELS["wkv_bwd"](*(t[..., :32].contiguous() for t in (r, k, v, w, u)),
                              s_seg[..., :32, :32].contiguous(), dout[..., :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        TK.KERNELS["wkv_bwd"](r.transpose(0, 1).contiguous().transpose(0, 1), k, v, w, u,
                              s_seg, dout)


def opened_smoke(arch):
    """`arch` at smoke size with the backward kernel's head dim 64."""
    return dataclasses.replace(smoke_config(get_config(arch)), d_head=64)


def opened_bwd_launches(cfg):
    """The backward launches of one train step of `cfg` (no qk-norm): a
    flash backward per self-, cross- and encoder attention, a norm backward
    per norm (two a layer, an encoder-decoder's lnx, the final norms), one
    of the MLP's activation per layer (an MoE layer's experts share one),
    and per RG-LRU layer one RG-LRU backward and one GELU backward (its
    gate branch) in place of the flash one; RWKV6: two LayerNorm backwards
    a layer and the final one's, and one wkv backward a layer. The
    LayerNorm backward runs on the kernel the router picks for bf16 rows of
    d_model (``ring_preferred``: the ring kernel, ``layernorm_bwd``, at
    every smoke width), the other LayerNorm kernel no time."""
    from repro_torch.kernels.rmsnorm.kernel import ring_preferred
    L, E = cfg.n_layers, cfg.n_encoder_layers
    ln = "layernorm_bwd" if ring_preferred(cfg.d_model, torch.bfloat16) else "layernorm_bwd_triton"
    if cfg.attention_free:
        return {ln: 2 * L + 1, "wkv_bwd": L}
    rec = sum(cfg.block_kind(i) == "rglru" for i in range(L)) if cfg.block_pattern else 0
    cross = L if cfg.cross_attention else 0
    norm = ln if cfg.norm == "layernorm" else "rmsnorm_bwd"
    mlp = ("silu_mul_bwd" if cfg.activation == "silu" else "gelu_mul_bwd") if cfg.mlp_gated \
        else "gelu_bwd"
    want = {"flash_attention_bwd_wgmma": L - rec + E + cross,
            norm: 2 * (L + E) + 1 + (1 if E else 0) + cross, mlp: L + E}
    if rec:
        want.update({"rglru_bwd": rec, "gelu_bwd": rec})
    return want


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "stablelm-1.6b", "gpt3-175b",
                                  "whisper-tiny", "llama-3.2-vision-11b", "recurrentgemma-2b",
                                  "grok-1-314b", "rwkv6-7b"])
def test_opened_train_step_on_card_matches_cpu(cuda, monkeypatch, arch):
    """Each config the LayerNorm, GELU, MoE aux, windowed and softcapped
    flash and RG-LRU backward opened, at smoke size: the loss (aux too)
    and every parameter's gradient of the kernel path against the plain
    path on the CPU, on the same weights, frontend and routing (the MoE
    models' recorded on the CPU and replayed on the card); recurrentgemma's
    96 tokens past its smoke window of 64, grok under its softcap, rwkv6
    with its base decays w0 across (-6.9, 1.1) (w from about 0.999 to 0.05
    rather than the init's 0.9975 everywhere); then one train step with
    exact backward launches."""
    cfg = opened_smoke(arch)
    cpu = models.init_params(cfg, seed=0, device="cpu").requires_grad_(True)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if name.endswith("xgate"):
                p.fill_(0.5)
            if name.endswith("tmix.w0"):
                p.copy_(torch.rand(p.shape, generator=gen) * 8.0 - 6.9)
    gpu = LM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    gpu.requires_grad_(True)
    rng = np.random.default_rng(2)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 97), dtype=np.int32))
    fe = None
    if needs_frontend(cfg):
        fe = torch.from_numpy(rng.standard_normal((2, cfg.n_frontend_tokens, cfg.d_model),
                                                  dtype=np.float32)).bfloat16()
    grads = []
    records = []
    for model, device in ((cpu, "cpu"), (gpu, cuda)):
        with monkeypatch.context() as m:
            if cfg.n_experts:
                if device == "cpu":
                    records = record_routing(m)
                else:
                    replay_routing(m, records)
            loss, met = loss_fn(model, tok[:, :-1].to(device), tok[:, 1:].to(device),
                                frontend=None if fe is None else fe.to(device))
            params = dict(model.named_parameters())
            grads.append((loss.item(), met["aux"].item(), dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))))
    (want_loss, want_aux, want), (got_loss, got_aux, got) = grads
    assert abs(got_loss - want_loss) < 2e-2 and abs(got_aux - want_aux) < 2e-2 * max(want_aux, 1)
    assert (want_aux > 0) == bool(cfg.n_experts)
    for n, g in got.items():
        w = want[n].float()
        assert g.dtype == want[n].dtype
        if n.endswith(".bk"):       # 0 in exact arithmetic: the softmax ignores a row's shift
            assert g.float().norm() < 2e-2 * want[n[:-1] + "q"].float().norm(), n
            continue
        assert ((g.float().cpu() - w).norm() / w.norm().clamp_min(1e-30)).item() < 2e-2, n
    opt = training.AdamW(lr=training.constant_schedule(1e-3))
    state = training.TrainState(gpu, opt.init(dict(gpu.named_parameters())))
    step = training.make_train_step(cfg, opt, has_frontend=fe is not None)
    batch = {"tokens": tok[:, :-1].to(cuda), "targets": tok[:, 1:].to(cuda)}
    if fe is not None:
        batch["frontend"] = fe.to(cuda)
    TK.reset_launches()
    state, met = step(state, batch)
    torch.cuda.synchronize()
    counts = TK.launches()
    bwd = {k: n for k, n in counts.items() if "_bwd" in k}
    assert bwd == {**dict.fromkeys(bwd, 0), **opened_bwd_launches(cfg)}
    assert torch.isfinite(met["loss"]) and int(state.opt.step) == 1


@pytest.mark.parametrize("arch", ["gpt3-175b", "granite-moe-3b-a800m", "whisper-tiny",
                                  "rwkv6-7b"])
def test_opened_serving_with_grad_enabled_builds_no_graph_on_card(cuda, arch):
    """LayerNorm, GELU, MoE and RWKV6 models serve with grad mode on
    through their forward kernels alone: no backward launch, no graph."""
    cfg = opened_smoke(arch)
    model = models.init_params(cfg, seed=0, device=cuda)
    cache = models.init_cache(cfg, 2, 32, device=cuda)
    toks = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    fe = None
    if needs_frontend(cfg):
        fe = torch.zeros((2, cfg.n_frontend_tokens, cfg.d_model), dtype=torch.bfloat16,
                         device=cuda)
    with torch.enable_grad():
        TK.reset_launches()
        out = [model.prefill(toks, cache, frontend=fe), model.decode_step(toks[:, 0], cache),
               model(toks, fe)]
        torch.cuda.synchronize()
        assert all(o.grad_fn is None for o in out)
        counts = TK.launches()
        assert not any(n for k, n in counts.items() if "bwd" in k)
        assert counts["layernorm" if cfg.norm == "layernorm" else "rmsnorm"] > 0


def trainable_smoke():
    """qwen3-1.7b at smoke size with the backward kernel's head dim 64."""
    return dataclasses.replace(smoke_config(get_config("qwen3-1.7b")), d_head=64)


def test_train_step_on_card_matches_cpu(cuda):
    """The loss and every parameter's gradient of the kernel path (three
    backward kernels) against the plain path on the CPU, on the same
    weights; then one train step with its exact backward launches: per
    layer one flash backward, four RMSNorm backwards (two norms, q- and
    k-norm) and one SwiGLU backward, and one for the final norm."""
    cfg = trainable_smoke()
    cpu = models.init_params(cfg, seed=0, device="cpu").requires_grad_(True)
    gpu = LM(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    gpu.requires_grad_(True)
    rng = np.random.default_rng(2)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 97), dtype=np.int32))
    grads = []
    for model, device in ((cpu, "cpu"), (gpu, cuda)):
        loss, _ = loss_fn(model, tok[:, :-1].to(device), tok[:, 1:].to(device))
        params = dict(model.named_parameters())
        grads.append((float(loss), dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))))
    (want_loss, want), (got_loss, got) = grads
    assert abs(got_loss - want_loss) < 2e-2
    for n, g in got.items():
        w = want[n].float()
        assert g.dtype == want[n].dtype
        assert ((g.float().cpu() - w).norm() / w.norm().clamp_min(1e-30)).item() < 2e-2, n
    opt = training.AdamW(lr=training.constant_schedule(1e-3))
    state = training.TrainState(gpu, opt.init(dict(gpu.named_parameters())))
    step = training.make_train_step(cfg, opt)
    TK.reset_launches()
    state, met = step(state, {"tokens": tok[:, :-1].to(cuda), "targets": tok[:, 1:].to(cuda)})
    torch.cuda.synchronize()
    L = cfg.n_layers
    counts = TK.launches()
    assert {k: counts[k] for k in ("flash_attention_bwd", "flash_attention_bwd_wgmma",
                                   "rmsnorm_bwd", "silu_mul_bwd")} == \
        {"flash_attention_bwd": 0, "flash_attention_bwd_wgmma": L, "rmsnorm_bwd": 4 * L + 1,
         "silu_mul_bwd": L}
    assert counts["flash_attention_wgmma"] == L and counts["rmsnorm"] == 4 * L + 1
    assert torch.isfinite(met["loss"]) and int(state.opt.step) == 1


def test_serving_with_grad_enabled_builds_no_graph_on_card(cuda):
    """Serving parameters need no gradient, so the ops call their forward
    kernels directly: no backward launch, no graph, with grad mode on; a
    trainable model under no_grad the same."""
    cfg = trainable_smoke()
    model = models.init_params(cfg, seed=0, device=cuda)
    cache = models.init_cache(cfg, 2, 32, device=cuda)
    toks = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    with torch.enable_grad():
        TK.reset_launches()
        out = [model.prefill(toks, cache), model.decode_step(toks[:, 0], cache), model(toks)]
        torch.cuda.synchronize()
        assert all(o.grad_fn is None for o in out)
        counts = TK.launches()
        assert counts["flash_attention_bwd"] == counts["flash_attention_bwd_wgmma"] == \
            counts["rmsnorm_bwd"] == counts["silu_mul_bwd"] == 0
        assert counts["rmsnorm"] > 0 and counts["silu_mul"] > 0
        model.requires_grad_(True)
        with torch.no_grad():
            assert model(toks).grad_fn is None


# ---------------- the mapper's candidate tables (csrc/mapper_tables.cu) ----------------

MAPPER_SHAPES = [(64, 4096, 4096, 1, 2, 2, 2, 2, False, 1.0),
                 (1, 4096, 11008, 1, 2, 1, 2, 4, False, 2.0),
                 (512, 128, 512, 32, 2, 2, 2, 4, True, 1.0),
                 (4096, 12288, 49152, 1, 2, 2, 2, 2, False, 1.0),
                 (1, 4096, 11008, 1, 2, 0.5, 2, 4, False, 2.0),
                 (2048, 2048, 6144, 1, 0.5, 0.5, 0.5, 4, False, 4.0),
                 (3, 5, 7, 2, 1, 0.5, 2, 0.5, False, 1.0)]


def _mapper_chunk(devs, shapes):
    from repro_torch.core import mapper
    rows = [mapper._candidate_rows(d, s) for d, s in zip(devs, shapes)]
    return mapper._gather_chunk(devs, shapes, [r[0] for r in rows], [r[1] for r in rows])


@pytest.mark.parametrize("widths", ["int", "sub_byte"])
@pytest.mark.parametrize("preset", ["nvidia_a100", "nvidia_h100", "google_tpu_v5e", "amd_mi210",
                                    "designs"])
def test_mapper_tables_match_plain_and_numpy_on_card(cuda, preset, widths):
    """Every output column of the kernel equals the numpy tables and the
    plain version on the card, as bytes (dtypes too)."""
    from repro_torch.core import hardware, mapper
    from repro_torch.kernels.mapper_tables import ops as tables_ops
    from repro_torch.kernels.mapper_tables.ref import tables_ref
    shapes = MAPPER_SHAPES[:4] if widths == "int" else MAPPER_SHAPES[4:]
    if preset == "designs":      # per-row device columns
        devs = [hardware.compute_design(c) for c in "ABCDE" for _ in shapes]
        shapes = shapes * 5
    else:
        devs = [getattr(hardware, preset)()] * len(shapes)
    g = _mapper_chunk(devs, shapes)
    want = mapper._tables(g)
    before = TK.launches()["mapper_tables"]
    got = tables_ops.chunk_tables(g)
    assert TK.launches()["mapper_tables"] == before + 1
    plain = {k: v.cpu().numpy() for k, v in tables_ref(tables_ops.to_tensors(g, "cuda")).items()}
    for name, out in (("kernel", got), ("plain on the card", plain)):
        for k in want:
            assert out[k].dtype == want[k].dtype and out[k].shape == want[k].shape, (name, k)
            assert out[k].tobytes() == want[k].tobytes(), (name, k)


def _study_rows(device):
    from repro_torch.core import fusion, graph, hardware, mapper, precision, result_cache
    from repro_torch.core.study import Study
    from repro_torch.core.workload import Workload
    mapper.clear_matmul_cache()
    with result_cache.disabled():
        return Study(systems=[hardware.dgx_a100(2), hardware.make_system(hardware.nvidia_h100(), 2)],
                     configs=[smoke_config(get_config("qwen3-1.7b")),
                              smoke_config(get_config("gpt3-175b"))],
                     plans=[graph.Plan(tp=2), graph.Plan(tp=1, dp=2)],
                     workloads={"short": Workload(2, 64, 8, samples=4)},
                     policies={"fp16": precision.DEFAULT,
                               "int4": precision.POLICIES["int4-weights"]},
                     fusions={"serial": fusion.SERIAL, "overlap": fusion.OVERLAP},
                     verify="off", device=device).run().to_rows()


def test_cuda_study_equals_cpu_study_on_card(cuda):
    """A Study whose stacked search prices its tables with the kernel gives
    the numpy Study's rows, and launched the kernel to do so."""
    TK.reset_launches()
    got = _study_rows("cuda")
    assert TK.launches()["mapper_tables"] > 0
    assert got == _study_rows("cpu")


def test_serve_plan_report_on_card_equals_cpu(cuda):
    """The serving launcher's planner on the card (``--device cuda``) prints
    the CPU's ``[planner]`` line, and priced its tables with the kernel."""
    from repro_torch.core import mapper, result_cache
    from repro_torch.launch.serve import plan_report
    cfg = get_config("qwen1.5-0.5b")
    with result_cache.disabled():
        mapper.clear_matmul_cache()
        TK.reset_launches()
        got = plan_report(cfg, 1, 4, 16, "cuda")
        assert TK.launches()["mapper_tables"] > 0
        mapper.clear_matmul_cache()
        want = plan_report(cfg, 1, 4, 16, "cpu")
    assert got == want and "tp=1 pp=1 dp=1" in got


def test_cuda_tables_raise_when_the_library_fails_to_load(cuda, monkeypatch):
    """No fallback to numpy: a kernel that cannot load fails the search."""
    from repro_torch.core import hardware, mapper, result_cache
    from repro_torch.kernels import _build
    from repro_torch.kernels.mapper_tables import kernel as tables_kernel, ops as tables_ops

    def refuse(name):
        raise OSError(f"cannot load lib{name}")

    monkeypatch.setattr(_build, "load", refuse)
    tables_kernel._entry.cache_clear()
    try:
        dev = hardware.nvidia_a100()
        g = _mapper_chunk([dev], MAPPER_SHAPES[:1])
        with pytest.raises(OSError, match="libmapper_tables"):
            tables_ops.chunk_tables(g)
        mapper.clear_matmul_cache()
        with pytest.raises(OSError, match="libmapper_tables"), result_cache.disabled():
            mapper.matmul_perf_batch_multi([(dev, MAPPER_SHAPES[1])], device="cuda")
    finally:
        monkeypatch.undo()
        tables_kernel._entry.cache_clear()
        mapper.clear_matmul_cache()


# ---------------- the trace CLI and the roofline with the tables on the card ----------------

def _trace_run(argv, where, monkeypatch, capsys):
    from repro_torch.trace import main
    where.mkdir()
    monkeypatch.chdir(where)
    rc = main(argv + ["--csv", "ops.csv"])
    return rc, capsys.readouterr().out, {p.name: p.read_bytes() for p in sorted(where.iterdir())}


@pytest.mark.parametrize("stage", ["layer", "serve"])
def test_trace_cli_on_card_writes_the_cpu_files(cuda, stage, tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.trace`` at gpt3-175b with its tables on the card
    writes the trace and CSV the numpy tables give, byte for byte, and
    launched the kernel to do so."""
    from repro_torch.core import mapper, result_cache
    argv = ["--config", "gpt3_175b", "--stage", stage, "--device", "h100"]
    with result_cache.disabled():
        mapper.clear_matmul_cache()
        TK.reset_launches()
        got = _trace_run(argv + ["--tables-device", "cuda"], tmp_path / "cuda", monkeypatch, capsys)
        assert TK.launches()["mapper_tables"] > 0
        mapper.clear_matmul_cache()
        want = _trace_run(argv + ["--tables-device", "cpu"], tmp_path / "cpu", monkeypatch, capsys)
    assert got == want
    assert got[0] == 0 and f"gpt3-175b_{stage}.perfetto.json" in got[2]


def test_mapper_never_beats_the_roofline_on_card(cuda):
    """Paper Table V with the tables on the card: no GEMM's mapped latency is
    below its roofline's compute term, nor below 0.35 of its memory term
    (the C-tile write-back may overlap), and the winners are numpy's."""
    from repro_torch.core import hardware, mapper, result_cache
    from repro_torch.core.roofline import matmul_roofline
    shapes = [(m, k, n, 1, 2.0, 2.0, 2.0, 2.0, False, 1.0)
              for m in (1, 16, 512, 4096) for k in (64, 12288) for n in (128, 12288)]
    with result_cache.disabled():
        for preset in ("a100", "h100", "tpuv5e", "design-C"):
            dev = hardware.get_device(preset)
            mapper.clear_matmul_cache()
            TK.reset_launches()
            got = mapper.matmul_perf_batch(dev, shapes, device="cuda")
            assert TK.launches()["mapper_tables"] > 0
            for s, r in zip(shapes, got):
                bound = matmul_roofline(dev, *s[:3])
                assert r.latency >= bound.compute_s * 0.999, (preset, s)
                assert r.latency >= bound.memory_s * 0.35, (preset, s)
            mapper.clear_matmul_cache()
            assert got == mapper.matmul_perf_batch(dev, shapes, device="cpu"), preset


# ---------------- the distributed half: gloo ranks sharing the card ----------------

def test_tensor_parallel_step_on_two_ranks_of_the_card(cuda, tmp_path):
    """qwen3-smoke (heads of 64, the wgmma kernels' size) at (data, model) =
    (1, 2), two spawned gloo ranks on the one card: the gathered gradients within 2e-2 (relative Frobenius) of
    the single-rank card step's, the loss within 2e-2, and each rank's
    launches, at its local shapes, those of the single-rank step."""
    import _torch_dist
    from repro_torch.training import step_grads
    cfg = dataclasses.replace(smoke_config(get_config("qwen3-1.7b")), d_head=64)
    model = models.init_params(cfg, seed=1, device="cuda").requires_grad_(True)
    g = torch.Generator().manual_seed(2)
    tok = torch.randint(0, cfg.vocab_size, (2, 65), generator=g)
    batch = {"tokens": tok[:, :-1], "targets": tok[:, 1:],
             "mask": (torch.rand((2, 64), generator=g) > 0.2).float()}
    case = {"cfg": cfg, "state": {n: p.detach().cpu() for n, p in model.state_dict().items()},
            "microbatches": 1, "frontend": False, "records": None, "meshes": [(1, 2)],
            "batch": batch}
    torch.save({"qwen3": case}, tmp_path / "cases.pt")
    _torch_dist.run_world(tmp_path, 2, "train_worker", str(tmp_path / "cases.pt"), [(1, 2)],
                          str(tmp_path), "cuda", device="cuda")
    got = torch.load(tmp_path / "qwen3_1x2.pt", weights_only=False)
    TK.reset_launches()
    loss, grads, _ = step_grads(model, {k: v.cuda() for k, v in batch.items()})
    one = TK.launches()
    assert abs(got["loss"] - float(loss)) < 2e-2
    for n, gr in grads.items():
        want = gr.float().cpu()
        assert ((got["grads"][n] - want).norm() / want.norm().clamp_min(1e-30)) < 2e-2, n
    assert got["launches"]["flash_attention_wgmma"] == one["flash_attention_wgmma"] == 2
    assert got["launches"]["flash_attention_bwd_wgmma"] == 2
    assert got["launches"] == one


def test_pipeline_apply_on_the_card_equals_the_cpu(cuda, tmp_path):
    """pipeline_apply over pod 2 with the stages on the card (gloo's
    send/recv staged through the host, ``collectives.NATIVE``): the tanh
    stack within 2e-5 of the same stages on the CPU, qwen3-smoke's 4
    blocks within 2e-2 of the unsplit CPU forward."""
    import _torch_dist
    cfg = dataclasses.replace(smoke_config(get_config("qwen3-1.7b")), n_layers=4, d_head=64)
    model = models.init_params(cfg, seed=2, device="cpu")
    gen = torch.Generator().manual_seed(3)
    h = torch.randn((4, 64, cfg.d_model), generator=gen).bfloat16()
    inp = {"w": torch.randn((4, 16, 16), generator=gen) / 4, "x": torch.randn((6, 16),
                                                                              generator=gen),
           "n_microbatches": 2, "cfg": cfg, "state": model.state_dict(), "h": h}
    torch.save(inp, tmp_path / "inputs.pt")
    for dev in ("cuda", "cpu"):
        _torch_dist.run_world(tmp_path, 2, "pipeline_worker", str(tmp_path / "inputs.pt"),
                              str(tmp_path / f"{dev}.pt"), dev, device=dev)
    card, host = (torch.load(tmp_path / f"{d}.pt", weights_only=False) for d in ("cuda", "cpu"))
    with torch.no_grad():
        want = model.apply_layers(h, range(4)).float()
    for r in range(2):
        assert (card[r]["tanh"] - host[r]["tanh"]).abs().max() < 2e-5
        got = card[r]["blocks"].float()
        assert ((got - want).norm() / want.norm()) < 2e-2, r
