"""The port's kernel modules against the JAX package's kernels.

On the CPU each op of ``repro_torch.kernels`` runs its plain PyTorch
version; it is held against the JAX op on the same numpy inputs, with the
Pallas kernel run in interpret mode as ``tests/test_kernels.py`` runs it, at
that file's shapes and tolerances (bf16 2e-2, fp32 2e-5 relative to the
largest output; the fp32 WKV recurrence 1e-4). Block sizes are left at the JAX ops' defaults: they change
how the interpreter walks the grid, not the function. The hand-written
kernels themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py`` (marked ``cuda``) and by ``chip_smoke.py``.
"""
import math

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import kernels as K
from repro.models import layers as jax_layers
from repro.models import recurrent as jax_recurrent
import repro_torch.kernels as TK
from repro_torch.kernels.decode_attention import kernel as t_decode_kernel
from repro_torch.kernels.decode_attention import ops as t_decode
from repro_torch.kernels.flash_attention import kernel as t_flash_kernel
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.kernels.flash_attention.kernel import wgmma_eligible
from repro_torch.kernels.gelu import ops as t_gelu
from repro_torch.kernels.gelu.ref import gelu_mul_ref, gelu_ref, silu_mul_ref
from repro_torch.kernels.rglru import ops as t_rglru
from repro_torch.kernels.rglru import kernel as t_rglru_kernel
from repro_torch.kernels.rglru.ref import rglru_chunked_ref, rglru_ref
from repro_torch.kernels.rmsnorm import ops as t_rmsnorm
from repro_torch.kernels.rmsnorm.ref import layernorm_ref, rmsnorm_ref
from repro_torch.kernels.wkv import kernel as t_wkv_kernel
from repro_torch.kernels.wkv import ops as t_wkv
from repro_torch.kernels.wkv.ref import CHUNK, wkv_chunked_ref, wkv_ref
from repro_torch.models import layers as t_layers

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def tol(name):
    return 2e-2 if name == "bfloat16" else 2e-5


def both(x, name):
    """One numpy float32 array as a JAX and a torch array of `name` dtype
    (both round float32 to bf16 to nearest even: identical bits)."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def t2np(t):
    return t.float().numpy()


def normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------- rmsnorm ----------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("r,c", [(64, 256), (100, 512), (7, 1024)])
def test_rmsnorm_plain_matches_jax(r, c, dtype):
    jx, tx = both(normal(8, (r, c)), dtype)
    g = normal(9, (c,))
    want = K.rmsnorm.rmsnorm(jx, jnp.asarray(g))
    got = t_rmsnorm.rmsnorm(tx, torch.from_numpy(g))
    assert got.dtype == tx.dtype and got.shape == (r, c)
    assert rel_err(t2np(got), want) < tol(dtype)


# ---------------- layernorm ----------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("r,c", [(90, 384), (64, 256), (7, 1024)])
def test_layernorm_plain_matches_jax(r, c, dtype):
    """Rows off zero mean (the mean must come out before the variance) with
    a gain and bias far from 1 and 0."""
    jx, tx = both(normal(10, (r, c)) * 3.0 + 1.5, dtype)
    g = normal(11, (c,)) * 2.0
    b = normal(12, (c,))
    want = K.rmsnorm.layernorm(jx, jnp.asarray(g), jnp.asarray(b))
    got = t_rmsnorm.layernorm(tx, torch.from_numpy(g), torch.from_numpy(b))
    assert got.dtype == tx.dtype and got.shape == (r, c)
    assert rel_err(t2np(got), want) < tol(dtype)


# ---------------- gelu ----------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("r,c", [(90, 384), (64, 256), (7, 1024)])
def test_gelu_plain_matches_jax(r, c, dtype):
    jx, tx = both(normal(15, (r, c)) * 2.0, dtype)
    want = K.gelu.gelu(jx)
    got = t_gelu.gelu(tx)
    assert got.dtype == tx.dtype and got.shape == (r, c)
    assert rel_err(t2np(got), want) < tol(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gelu_plain_matches_jax_where_tanh_saturates(dtype):
    """|x| up to 20: tanh is +-1 to fp32 precision and GELU is x or 0."""
    x = np.linspace(-20.0, 20.0, 64 * 128, dtype=np.float32).reshape(64, 128)
    jx, tx = both(x, dtype)
    want = np.asarray(K.gelu.gelu(jx), np.float32)
    got = t2np(t_gelu.gelu(tx))
    assert rel_err(got, want) < tol(dtype)
    assert np.array_equal(got[x >= 6.0], t2np(tx)[x >= 6.0])
    assert np.abs(got[x <= -6.0]).max() < 1e-6


# ---------------- silu_mul ----------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_silu_mul_plain_matches_jax(dtype):
    jg, tg = both(normal(13, (100, 256)), dtype)
    ju, tu = both(normal(14, (100, 256)), dtype)
    want = K.gelu.silu_mul(jg, ju)
    got = t_gelu.silu_mul(tg, tu)
    assert got.dtype == tg.dtype
    assert rel_err(t2np(got), want) < tol(dtype)


# ---------------- flash attention ----------------

FLASH_CASES = [
    (4, 4, 128, 128, True, 0, 0.0),      # MHA causal
    (8, 2, 130, 130, True, 0, 0.0),      # GQA, non-divisible seq
    (4, 1, 64, 200, False, 0, 0.0),      # MQA cross-attn
    (4, 2, 128, 128, True, 32, 0.0),     # local window
    (4, 2, 96, 96, True, 0, 30.0),       # logit softcap
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hq,hkv,sq,sk,causal,window,cap", FLASH_CASES)
def test_flash_attention_plain_matches_jax(hq, hkv, sq, sk, causal, window,
                                           cap, dtype):
    jq, tq = both(normal(1, (2, hq, sq, 64)), dtype)
    jk, tk = both(normal(2, (2, hkv, sk, 64)), dtype)
    jv, tv = both(normal(3, (2, hkv, sk, 64)), dtype)
    want = K.flash_attention.flash_attention(jq, jk, jv, causal=causal,
                                             window=window, softcap=cap)
    got = t_flash.flash_attention(tq, tk, tv, causal=causal, window=window,
                                  softcap=cap)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    assert rel_err(t2np(got), want) < tol(dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_model_layout_matches_jax_layers(dtype):
    """The model-layout (B, S, H, D) entry against the JAX model's chunked
    attention, which the JAX model calls on its prefill path."""
    jq, tq = both(normal(0, (2, 70, 4, 32)), dtype)
    jk, tk = both(normal(1, (2, 70, 2, 32)), dtype)
    jv, tv = both(normal(2, (2, 70, 2, 32)), dtype)
    want = jax_layers.flash_attention(jq, jk, jv, causal=True, chunk_q=32,
                                      chunk_k=32)
    got = t_layers.flash_attention(tq, tk, tv, causal=True)
    ref = t_layers.attention_reference(tq, tk, tv, causal=True)
    assert got.shape == (2, 70, 4, 32)
    assert rel_err(t2np(got), want) < tol(dtype)
    assert rel_err(t2np(ref), want) < tol(dtype)


# ---------------- the card's attention paths ----------------

def test_flash_path_predicate_routes_shapes():
    """``wgmma_eligible``: the model's transposed (B, S, H, D) views of the
    four served head layouts (D = 64, 128 and recurrentgemma's 256) and
    contiguous (B, H, S, D) tensors go to the TMA + wgmma kernel; D = 32 or
    48, a sequence stride that is no multiple of 8 elements, a base off 16
    bytes, fp32 and an empty key axis do not."""
    bf = torch.bfloat16
    for hq, hkv, d in ((16, 8, 128), (32, 32, 64), (96, 96, 128), (4, 2, 64), (10, 1, 256)):
        q = torch.zeros(2, 40, hq, d, dtype=bf).transpose(1, 2)
        k = torch.zeros(2, 33, hkv, d, dtype=bf).transpose(1, 2)
        assert wgmma_eligible(q, k, k)
        assert wgmma_eligible(q.contiguous(), k.contiguous(), k.contiguous())
        assert not wgmma_eligible(q.float(), k.float(), k.float())
    for d in (32, 48):
        x = torch.zeros(2, 4, 40, d, dtype=bf)
        assert not wgmma_eligible(x, x, x)
    x = torch.zeros(2, 4, 40, 64, dtype=bf)
    wide = torch.zeros(2, 4, 40, 68, dtype=bf)[..., :64]          # sequence stride 68
    assert wgmma_eligible(x, x, x) and not wgmma_eligible(wide, x, x)
    flat = torch.zeros(x.numel() + 8, dtype=bf)
    for offset in range(8):                                        # 0-14 bytes past the base
        view = flat[offset:offset + x.numel()].view(x.shape)
        assert wgmma_eligible(x, view, x) == (view.data_ptr() % 16 == 0)
    assert not wgmma_eligible(x, x[:, :, :0], x[:, :, :0])
    one = torch.zeros(1, 1, 5, 64, dtype=bf)                       # axes of extent 1
    assert wgmma_eligible(one, one, one)


def test_flash_dispatch_picks_the_path_before_the_launch(monkeypatch):
    """``attention_cuda`` routes by ``wgmma_eligible`` alone and never calls
    the other wrapper (CPU tensors, the wrappers replaced by recorders); the
    op sends a CUDA-bound call there and nowhere else."""
    calls = []
    for name in ("flash_attention_cuda", "flash_attention_wgmma_cuda"):
        monkeypatch.setattr(t_flash_kernel, name,
                            lambda q, k, v, _n=name, **kw: calls.append((_n, q.shape[-1], kw))
                            or q)
    bf = torch.bfloat16
    view = torch.zeros(2, 40, 4, 128, dtype=bf).transpose(1, 2)
    cases = [((view, view, view), "flash_attention_wgmma_cuda", 128),
             ((torch.zeros(2, 4, 40, 64, dtype=bf),) * 3, "flash_attention_wgmma_cuda", 64),
             ((torch.zeros(2, 4, 40, 256, dtype=bf),) * 3, "flash_attention_wgmma_cuda", 256),
             ((torch.zeros(2, 4, 40, 48, dtype=bf),) * 3, "flash_attention_wgmma_cuda", 64),
             ((torch.zeros(2, 4, 40, 32, dtype=bf),) * 3, "flash_attention_cuda", 32),
             ((torch.zeros(2, 4, 40, 68, dtype=bf)[..., :64],) * 3, "flash_attention_cuda", 64),
             ((torch.zeros(2, 4, 40, 64),) * 3, "flash_attention_cuda", 64),
             ((torch.zeros(2, 4, 40, 200),) * 3, "flash_attention_cuda", 256)]
    kw = dict(causal=False, window=8, softcap=30.0)
    for args, path, dk in cases:
        calls.clear()
        d = args[0].shape[-1]
        assert t_flash_kernel.attention_cuda(*args, **kw).shape == args[0].shape
        assert calls == [(path, dk, dict(kw, scale=1.0 / math.sqrt(d)))]
    calls.clear()
    monkeypatch.setattr(t_flash, "runs_plain", lambda t: False)
    t_flash.flash_attention(view, view, view, **kw)
    assert calls == [("flash_attention_wgmma_cuda", 128, dict(kw, scale=1.0 / math.sqrt(128)))]
    with pytest.raises(ValueError, match="up to 256"):
        t_flash_kernel.attention_cuda(*(torch.zeros(1, 1, 4, 320, dtype=bf),) * 3)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_outside_the_kernels_head_dims_runs_plain_on_cpu(dtype):
    """Head dims off the kernels' 32/64/128 (16, 48 and 96, which the card
    runs zero-padded, and 256, recurrentgemma-2b's, which it runs as it is):
    on the CPU the flash and decode ops compute them and equal the JAX ops
    (``test_padded_head_dims_match_jax`` runs the card's padding)."""
    for d in (16, 48, 96, 256):
        jq, tq = both(normal(30, (1, 4, 40, d)), dtype)
        jk, tk = both(normal(31, (1, 1, 40, d)), dtype)
        got = t_flash.flash_attention(tq, tk, tk, causal=True)
        want = K.flash_attention.flash_attention(jq, jk, jk, causal=True)
        assert got.shape == tq.shape and rel_err(t2np(got), want) < tol(dtype)
        jq, tq = both(normal(32, (2, 1, 4, d)), dtype)
        jk, tk = both(normal(33, (2, 50, 1, d)), dtype)
        lens = np.array([50, 17], np.int32)
        got = t_decode.decode_attention(tq, tk, tk, torch.from_numpy(lens))
        want = K.decode_attention.decode_attention(jq, jk, jk, jnp.asarray(lens))
        assert got.shape == tq.shape and rel_err(t2np(got), want) < tol(dtype)


# ---------------- decode attention ----------------

def edge_lengths(d, t):
    """Cache lengths at the chunked decode kernel's unit edges at head dim
    d (1, UK - 1, UK, UK + 1) and the full cache t."""
    c = t_decode_kernel.chunk_keys(d)
    return [1, c - 1, c, c + 1, t]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hkv,g,t,d,lens", [
    (2, 4, 128, 64, None), (1, 8, 200, 64, None), (4, 1, 64, 64, None),
    (2, 2, 197, 128, edge_lengths(128, 197)), (1, 10, 101, 256, edge_lengths(256, 101)),
    (2, 1, 389, 64, edge_lengths(64, 389))], ids=str)
def test_decode_attention_plain_matches_jax(hkv, g, t, d, lens, dtype):
    """The JAX kernel tests' rows (D = 64, lengths t, t/2, t/3), and D = 128
    and 256 and 64 with lengths at the chunked kernel's unit edges."""
    lens = np.array(lens or [t, max(1, t // 2), max(1, t // 3)], np.int32)
    B = len(lens)
    jq, tq = both(normal(5, (B, hkv, g, d)), dtype)
    jk, tk = both(normal(6, (B, t, hkv, d)), dtype)
    jv, tv = both(normal(7, (B, t, hkv, d)), dtype)
    want = K.decode_attention.decode_attention(jq, jk, jv, jnp.asarray(lens))
    got = t_decode.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert got.shape == tq.shape and got.dtype == tq.dtype
    assert rel_err(t2np(got), want) < tol(dtype)


def live_chunks(length, t, d):
    """Units the kernel walks for a slot of `length` keys, as the source
    computes them on the device: at least 1, the length clamped to [0, t]."""
    return max(1, -(-min(max(length, 0), t) // t_decode_kernel.chunk_keys(d)))


def test_decode_chunk_and_scratch_arithmetic():
    """A unit is 4 KB of K (and of V) in bf16 (UK = 64, 32, 16, 8 keys at
    D = 32, 64, 128, 256); a slot walks max(1, ceil(length / UK)) units, its
    length clamped to [0, T]; the scratch holds m, l and acc[D] for
    ``max_chunks(T, D)`` partials of every (b, kv-head, query head): sized
    from T alone, it covers every length."""
    assert [t_decode_kernel.chunk_keys(d) for d in (32, 64, 128, 256)] == [64, 32, 16, 8]
    for d in t_decode_kernel.CHUNKED_HEAD_DIMS:
        c = t_decode_kernel.chunk_keys(d)
        assert c * d * 2 == 4096
        t = 3 * c + 5
        assert [live_chunks(n, t, d) for n in edge_lengths(d, t)] == [1, 1, 1, 2, 4]
        assert live_chunks(0, t, d) == live_chunks(-3, t, d) == 1
        assert live_chunks(t + 100, t, d) == 4
        assert t_decode_kernel.max_chunks(t, d) == 4 and t_decode_kernel.max_chunks(0, d) == 1
        assert all(live_chunks(n, t, d) <= t_decode_kernel.max_chunks(t, d)
                   for n in range(-1, t + 3))
        assert t_decode_kernel.scratch_floats(8, 2, 3, t, d) == 8 * 2 * 3 * 4 * (d + 2)
    # the served shapes: gpt3's slot at 1024 keys (D = 128) takes 64 units
    assert t_decode_kernel.max_chunks(1024, 128) == 64
    assert sum(live_chunks(n, 1024, 128)
               for n in (1024, 225, 322, 419, 516, 196, 293, 390)) == 217


def test_decode_path_predicate_routes_shapes():
    """``chunked_eligible``: the model's cache views (a layer of the fused
    (L, B, T, Hkv * D) cache) at D = 32, 64, 128 and 256 go to the chunked
    kernel; fp32, D = 16, a head stride that is no multiple of 8 elements, a
    K or q base off 16 bytes and a q that is not contiguous do not."""
    bf = torch.bfloat16
    for hkv, g, d in ((8, 2, 128), (32, 1, 64), (96, 1, 128), (1, 10, 256), (2, 2, 32)):
        cache = torch.zeros(2, 2, 3, 40, hkv * d, dtype=bf)
        k, v = cache[0, 1].view(3, 40, hkv, d), cache[1, 1].view(3, 40, hkv, d)
        q = torch.zeros(3, hkv, g, d, dtype=bf)
        assert t_decode_kernel.chunked_eligible(q, k, v)
        assert not t_decode_kernel.chunked_eligible(q.float(), k.float(), v.float())
    x = torch.zeros(2, 30, 2, 16, dtype=bf)
    assert not t_decode_kernel.chunked_eligible(torch.zeros(2, 2, 1, 16, dtype=bf), x, x)
    q = torch.zeros(2, 2, 1, 64, dtype=bf)
    k = torch.zeros(2, 30, 2, 64, dtype=bf)
    wide = torch.zeros(2, 30, 2, 68, dtype=bf)[..., :64]           # head stride 68
    assert t_decode_kernel.chunked_eligible(q, k, k)
    assert not t_decode_kernel.chunked_eligible(q, wide, wide)
    flat = torch.zeros(k.numel() + 8, dtype=bf)
    for offset in range(8):                                        # 0-14 bytes past the base
        view = flat[offset:offset + k.numel()].view(k.shape)
        assert t_decode_kernel.chunked_eligible(q, view, k) == (view.data_ptr() % 16 == 0)
        qv = flat[offset:offset + q.numel()].view(q.shape)
        assert t_decode_kernel.chunked_eligible(qv, k, k) == (qv.data_ptr() % 16 == 0)
    assert not t_decode_kernel.chunked_eligible(torch.zeros(2, 2, 2, 64, dtype=bf).transpose(1, 2),
                                                k, k)


def test_decode_dispatch_picks_the_path_before_the_launch(monkeypatch):
    """``decode_cuda`` routes by ``picks_chunked`` (``chunked_eligible`` and
    G at most ``CHUNKED_MAX_G``) and never calls the other wrapper (CPU
    tensors, the wrappers replaced by recorders); the op sends a CUDA-bound
    call there and nowhere else."""
    calls, seen = [], []

    def recorder(name):
        def record(q, k, v, lengths, **kw):
            calls.append((name, kw))
            seen[:] = [q.shape[-1]]
            return q
        return record

    for name in ("decode_attention_cuda", "decode_attention_chunked_cuda"):
        monkeypatch.setattr(t_decode_kernel, name, recorder(name))
    bf = torch.bfloat16
    lens = torch.full((2,), 5, dtype=torch.int32)
    cases = [((torch.zeros(2, 2, 2, 128, dtype=bf), torch.zeros(2, 9, 2, 128, dtype=bf)),
              "decode_attention_chunked_cuda"),
             ((torch.zeros(2, 1, 10, 256, dtype=bf), torch.zeros(2, 9, 1, 256, dtype=bf)),
              "decode_attention_cuda"),
             ((torch.zeros(2, 8, 4, 128, dtype=bf), torch.zeros(2, 9, 8, 128, dtype=bf)),
              "decode_attention_cuda"),
             ((torch.zeros(2, 6, 1, 64, dtype=bf), torch.zeros(2, 9, 6, 64, dtype=bf)),
              "decode_attention_chunked_cuda"),
             ((torch.zeros(2, 2, 2, 64), torch.zeros(2, 9, 2, 64)), "decode_attention_cuda"),
             ((torch.zeros(2, 2, 2, 64, dtype=bf),
               torch.zeros(2, 9, 2, 68, dtype=bf)[..., :64]), "decode_attention_cuda")]
    for (q, k), path in cases:
        calls.clear()
        t_decode_kernel.decode_cuda(q, k, k, lens, softcap=30.0)
        assert calls == [(path, {"softcap": 30.0, "scale": 1.0 / math.sqrt(q.shape[-1])})]
    for q, k, dk in ((torch.zeros(2, 1, 10, 48, dtype=bf), torch.zeros(2, 9, 1, 48, dtype=bf), 64),
                     (torch.zeros(2, 2, 2, 200), torch.zeros(2, 9, 2, 200), 256)):
        calls.clear()
        assert t_decode_kernel.decode_cuda(q, k, k, lens).shape == q.shape
        path = "decode_attention_cuda"     # G = 10 and fp32 both go to the split kernel
        assert calls == [(path, {"softcap": 0.0, "scale": 1.0 / math.sqrt(q.shape[-1])})]
        assert seen == [dk]
    calls.clear()
    monkeypatch.setattr(t_decode, "runs_plain", lambda t: False)
    q, k = cases[0][0]
    t_decode.decode_attention(q, k, k, lens)
    assert calls == [("decode_attention_chunked_cuda",
                      {"softcap": 0.0, "scale": 1.0 / math.sqrt(128)})]



def test_attend_all_keys_routes_chunked_calls_to_the_decode_op(monkeypatch):
    """``attend_all_keys`` (one query over every key) sends a card call the
    chunked decode kernel takes (``picks_chunked``: whisper-tiny's cross
    shape, G = 1) to the decode op with every length Sk, and every other
    (llama-3.2-vision's G = 4, fp32, a CPU call) to flash attention on the
    one query, non-causal, over the keys' (B, Hkv, Sk, D) view (CPU
    tensors, the two paths replaced by recorders)."""
    calls = []

    def decode(q, k, v, lengths, **kw):
        calls.append(("decode", q.shape, k.shape, lengths.tolist(), kw))
        return torch.zeros_like(q)

    def flash(q, k, v, **kw):
        calls.append(("flash", q.shape, k.shape, kw))
        return torch.zeros_like(q)

    monkeypatch.setattr(t_decode, "decode_cuda", decode)
    monkeypatch.setattr(t_decode, "flash_attention", flash)
    bf = torch.bfloat16
    whisper = (torch.zeros(2, 6, 1, 64, dtype=bf), torch.zeros(2, 15, 6, 64, dtype=bf))
    llama = (torch.zeros(2, 8, 4, 128, dtype=bf), torch.zeros(2, 17, 8, 128, dtype=bf))
    fp32 = (torch.zeros(2, 6, 1, 64), torch.zeros(2, 15, 6, 64))
    t_decode.attend_all_keys(whisper[0], whisper[1], whisper[1])
    assert not t_decode.all_keys_on_decode(whisper[0], whisper[1], whisper[1])
    assert calls == [("flash", (2, 6, 1, 64), (2, 6, 15, 64), {"causal": False})]
    monkeypatch.setattr(t_decode, "runs_plain", lambda t: False)
    for (q, k), want in ((whisper, ("decode", (2, 6, 1, 64), (2, 15, 6, 64), [15, 15], {})),
                         (llama, ("flash", (2, 32, 1, 128), (2, 8, 17, 128),
                                  {"causal": False})),
                         (fp32, ("flash", (2, 6, 1, 64), (2, 6, 15, 64), {"causal": False}))):
        calls.clear()
        assert t_decode.attend_all_keys(q, k, k).shape == q.shape
        assert t_decode.all_keys_on_decode(q, k, k) == (want[0] == "decode")
        assert calls == [want]


@pytest.mark.parametrize("hkv,g,d", [(6, 1, 64), (8, 4, 128)])
def test_attend_all_keys_is_decode_attention_over_every_key(hkv, g, d):
    """On the CPU ``attend_all_keys`` (flash's plain version on the one
    query) is the decode op's plain version with every length Sk, within
    bf16's 2e-2 of the largest value."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.bfloat16)
               for s in ((3, hkv, g, d), (3, 37, hkv, d), (3, 37, hkv, d)))
    got = t_decode.attend_all_keys(q, k, v)
    want = t_decode.decode_attention(q, k, v, torch.full((3,), 37, dtype=torch.int32))
    assert got.shape == want.shape
    assert (got.float() - want.float()).abs().max() <= 2e-2 * want.float().abs().max()

# ---------------- wkv ----------------

WKV_TOL = 1e-4


def wkv_inputs(seed, shape):
    """r, k, v normal and w in (0.45, 0.95), as the JAX kernel tests draw
    them, fp32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    w = (0.5 / (1.0 + np.exp(-rng.standard_normal(shape))) + 0.45).astype(np.float32)
    return r, k, v, w


def rows(a):
    """(B, T, H, N) -> the TPU kernel's (B*H, T, N)."""
    B, T, H, N = a.shape
    return np.ascontiguousarray(np.moveaxis(a, 2, 1).reshape(B * H, T, N))


@pytest.mark.parametrize("t,chunk", [(96, 32), (64, 64), (100, 32)])
def test_wkv_plain_matches_jax_kernel_and_ref(t, chunk):
    """``tests/test_kernels.py``'s cases (4 rows of N=32, one u for every
    row, a zero state) as B=2 x H=2 with u tiled over the heads: the plain
    version against JAX ``wkv_ref`` and against the Pallas op in interpret
    mode."""
    B, H, N = 2, 2, 32
    r, k, v, w = wkv_inputs(15, (B, t, H, N))
    u = normal(19, (N,))
    jargs = [jnp.asarray(rows(a)) for a in (r, k, v, w)]
    out, state = t_wkv.wkv(*(torch.from_numpy(a) for a in (r, k, v, w)),
                           torch.from_numpy(np.tile(u, (H, 1))))
    assert out.shape == (B, t, H, N) and out.dtype == torch.float32
    got_out, got_state = rows(out.numpy()), state.numpy().reshape(B * H, N, N)
    for want_out, want_state in (K.wkv.reference(*jargs, jnp.asarray(u)),
                                 K.wkv.wkv(*jargs, jnp.asarray(u), chunk=chunk)):
        assert rel_err(got_out, want_out) < WKV_TOL
        assert rel_err(got_state, want_state) < WKV_TOL


def test_wkv_head_sizes_outside_the_kernel_run_plain_on_cpu():
    """Head sizes off the chunked kernel's 32 and 64 (16 and 48, which the
    card runs zero-padded, and 128, which it runs step by step): the CPU op
    computes them and equals the JAX model's scan
    (``test_wkv_padded_head_sizes_match_jax`` runs the card's padding)."""
    for N in (16, 48, 128):
        B, T, H = 2, 20, 2
        r, k, v, w = wkv_inputs(26, (B, T, H, N))
        u, s0 = normal(27, (H, N)), normal(28, (B, H, N, N))
        want_out, want_state = jax_recurrent.wkv_scan(
            *(jnp.asarray(a) for a in (r, k, v, w)), jnp.asarray(u), jnp.asarray(s0),
            chunk=16)
        out, state = t_wkv.wkv(*(torch.from_numpy(a) for a in (r, k, v, w, u, s0)))
        assert rel_err(out.numpy(), want_out) < WKV_TOL
        assert rel_err(state.numpy(), want_state) < WKV_TOL


def test_wkv_plain_matches_model_scan():
    """A per-head u and a nonzero initial state, against the JAX model's
    chunked ``wkv_scan``, over a T that is no multiple of its chunk."""
    B, T, H, N = 2, 70, 3, 32
    r, k, v, w = wkv_inputs(20, (B, T, H, N))
    u, s0 = normal(24, (H, N)), normal(25, (B, H, N, N))
    want_out, want_state = jax_recurrent.wkv_scan(
        *(jnp.asarray(a) for a in (r, k, v, w)), jnp.asarray(u), jnp.asarray(s0),
        chunk=16)
    out, state = t_wkv.wkv(*(torch.from_numpy(a) for a in (r, k, v, w, u, s0)))
    assert rel_err(out.numpy(), want_out) < WKV_TOL
    assert rel_err(state.numpy(), want_state) < WKV_TOL


def test_wkv_lengths_match_jax_on_the_unpadded_sequence():
    """Right-padded rows with random pads: each row's output and final state
    are JAX's on its real steps alone; the pads' outputs are zero."""
    B, T, H, N = 3, 40, 2, 32
    r, k, v, w = wkv_inputs(30, (B, T, H, N))
    u, s0 = normal(31, (H, N)), normal(32, (B, H, N, N))
    lens = [40, 23, 1]
    out, state = t_wkv.wkv(*(torch.from_numpy(a) for a in (r, k, v, w, u, s0)),
                           torch.tensor(lens, dtype=torch.int32))
    for b, n in enumerate(lens):
        want_out, want_state = jax_recurrent.wkv_scan(
            *(jnp.asarray(a[b:b + 1, :n]) for a in (r, k, v, w)), jnp.asarray(u),
            jnp.asarray(s0[b:b + 1]), chunk=16)
        assert rel_err(out[b:b + 1, :n].numpy(), want_out) < WKV_TOL
        assert rel_err(state[b:b + 1].numpy(), want_state) < WKV_TOL
        assert not out[b, n:].any()


def test_wkv_writes_the_state_in_place():
    """``state_out=state0``, as the decode step passes its cache: the result
    is written into it and equals the out-of-place result."""
    B, T, H, N = 2, 1, 2, 32
    args = [torch.from_numpy(a) for a in wkv_inputs(40, (B, T, H, N))]
    u, s0 = torch.from_numpy(normal(41, (H, N))), torch.from_numpy(normal(42, (B, H, N, N)))
    want_out, want_state = t_wkv.wkv(*args, u, s0)
    cache = s0.clone()
    out, state = t_wkv.wkv(*args, u, cache, state_out=cache)
    assert state is cache
    assert torch.equal(out, want_out) and torch.equal(cache, want_state)


def decays(rng, shape, kind):
    """w of one kind: "uniform" in (0.45, 0.95) as the JAX kernel tests draw
    it; "served" near exp(-exp(-6)) = 0.9975, the decay the model's init
    gives (``repro/models/recurrent.py:44``); "edge" a fifth each of exact 0,
    1e-30, exact 1 and the rest uniform."""
    w = 0.5 / (1.0 + np.exp(-rng.standard_normal(shape))) + 0.45
    if kind == "served":
        w = np.exp(-np.exp(-6.0 + 0.5 * rng.standard_normal(shape)))
    if kind == "edge":
        pick = rng.integers(0, 5, shape)
        w = np.select([pick == 0, pick == 1, pick == 2], [0.0, 1e-30, 1.0], w)
    return w.astype(np.float32)


# (T, decays, lengths or None, nonzero state0): T below the chunk, one chunk,
# a multiple of it, off a multiple, and T = 1; ragged lengths with a 0
WKV_CHUNKED_CASES = [(5, "uniform", None, False), (CHUNK, "served", None, False),
                     (3 * CHUNK, "uniform", None, False), (37, "edge", None, False),
                     (1, "uniform", None, False), (37, "uniform", [37, 20, 0], True),
                     (3 * CHUNK, "edge", [48, 16, 0], True), (70, "served", [70, 33, 1], True),
                     (5, "edge", [5, 3, 0], True), (1, "edge", [1, 0, 1], True)]


@pytest.mark.parametrize("case", WKV_CHUNKED_CASES, ids=str)
def test_wkv_chunked_ref_matches_jax(case):
    """The chunked kernel's arithmetic (``wkv_chunked_ref``: the same
    log-cumsum, clamp and guarded factorization) against JAX: with a zero
    state and no lengths, ``wkv_ref`` and the Pallas op in interpret mode
    (one u for every head, as they take it); with a nonzero state and
    ragged lengths, each row's real steps against the JAX model's
    ``wkv_scan``, pads' outputs zero and a length of 0 leaving the state."""
    T, kind, lens, with_state = case
    B, H, N = (2, 2, 32) if lens is None else (3, 2, 64)
    rng = np.random.default_rng(50 + T)
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32) for _ in range(3))
    w = decays(rng, (B, T, H, N), kind)
    if lens is None:
        u = normal(51, (N,))
        out, state = wkv_chunked_ref(*(torch.from_numpy(a) for a in (r, k, v, w)),
                                     torch.from_numpy(np.tile(u, (H, 1))))
        got_out, got_state = rows(out.numpy()), state.numpy().reshape(B * H, N, N)
        jargs = [jnp.asarray(rows(a)) for a in (r, k, v, w)]
        for want_out, want_state in (K.wkv.reference(*jargs, jnp.asarray(u)),
                                     K.wkv.wkv(*jargs, jnp.asarray(u))):
            assert rel_err(got_out, want_out) < WKV_TOL
            assert rel_err(got_state, want_state) < WKV_TOL
        return
    u, s0 = normal(52, (H, N)), normal(53, (B, H, N, N))
    out, state = wkv_chunked_ref(*(torch.from_numpy(a) for a in (r, k, v, w, u, s0)),
                                 torch.tensor(lens, dtype=torch.int32))
    assert out.shape == (B, T, H, N) and torch.isfinite(out).all()
    for b, n in enumerate(lens):
        assert not out[b, n:].any()
        if n == 0:
            assert torch.equal(state[b], torch.from_numpy(s0[b]))
            continue
        want_out, want_state = jax_recurrent.wkv_scan(
            *(jnp.asarray(a[b:b + 1, :n]) for a in (r, k, v, w)), jnp.asarray(u),
            jnp.asarray(s0[b:b + 1]), chunk=16)
        assert rel_err(out[b:b + 1, :n].numpy(), want_out) < WKV_TOL
        assert rel_err(state[b:b + 1].numpy(), want_state) < WKV_TOL


def test_wkv_chunked_predicate_and_column_split():
    """``chunked_eligible``: the model's (B, T, H, N) views of its fp32
    projections at T > 1 go to the chunked kernel; T = 1 (the decode step),
    fp32 off N in (32, 64), bf16, a stride or base off 16 bytes do not.
    ``column_split``: the slice whose busiest SM has the least work (the
    wave: 64 columns; a batch-1 refill on 132 SMs: 32; on 1000: 16)."""
    x = torch.zeros(2, 9, 3 * 64)
    r = x.view(2, 9, 3, 64)
    assert t_wkv_kernel.chunked_eligible(r, r, r, r)
    assert t_wkv_kernel.chunked_eligible(*(torch.zeros(1, 2, 4, 32),) * 4)
    assert not t_wkv_kernel.chunked_eligible(*(r[:, :1],) * 4)
    assert not t_wkv_kernel.chunked_eligible(*(torch.zeros(2, 9, 3, 16),) * 4)
    assert not t_wkv_kernel.chunked_eligible(*(r.bfloat16(),) * 4)
    wide = torch.zeros(2, 9, 3, 66)[..., :64]                      # head stride 66
    assert not t_wkv_kernel.chunked_eligible(r, r, wide, r)
    flat = torch.zeros(r.numel() + 4)
    for offset in range(4):                                        # 0-12 bytes past the base
        view = flat[offset:offset + r.numel()].view(r.shape)
        assert t_wkv_kernel.chunked_eligible(r, r, r, view) == (view.data_ptr() % 16 == 0)
    assert t_wkv_kernel.column_split(8, 64, 64, 132) == 64
    assert t_wkv_kernel.column_split(1, 64, 64, 132) == 32
    assert t_wkv_kernel.column_split(2, 64, 64, 132) == 64
    assert t_wkv_kernel.column_split(1, 64, 64, 32) == 64
    assert t_wkv_kernel.column_split(1, 64, 64, 1000) == 16
    assert t_wkv_kernel.column_split(8, 64, 32, 132) == 32


def test_wkv_dispatch_picks_the_kernel_by_steps(monkeypatch):
    """The op sends a CUDA-bound call of more than one step that
    ``chunked_eligible`` accepts to ``wkv_chunked_cuda``, the rest (the
    decode step, a misaligned view) to ``wkv_cuda`` (CPU tensors, the
    wrappers replaced by recorders)."""
    calls = []
    for name in ("wkv_cuda", "wkv_chunked_cuda"):
        monkeypatch.setattr(t_wkv_kernel, name,
                            lambda *a, _n=name, **kw: calls.append((_n, a[1].shape[1], kw)))
    monkeypatch.setattr(t_wkv, "runs_plain", lambda t: False)
    u = torch.zeros(2, 32)
    for T, want in ((2, "wkv_chunked_cuda"), (437, "wkv_chunked_cuda"), (1, "wkv_cuda")):
        x = torch.zeros(3, T, 2, 32)
        calls.clear()
        t_wkv.wkv(x, x, x, x, u, None, None, state_out=None)
        assert calls == [(want, T, {"state_out": None})]
    odd = torch.zeros(3 * 5 * 2 * 32 + 1)[1:].view(3, 5, 2, 32)
    calls.clear()
    t_wkv.wkv(odd, odd, odd, odd, u)
    assert calls == [("wkv_cuda", 5, {"state_out": None})]


# ---------------- the card's padding of head dims, run with plain kernels ----------------

def _plain_at_kernel_dims(dims):
    """Fake kernel wrappers for the padding tests: the plain attention at the
    head dim the wrapper was handed, which must be a kernel one, with the
    scale it was handed."""
    def flash(q, k, v, *, causal, window, softcap, scale):
        assert q.shape[-1] in dims
        qs = (q.float() * (scale * math.sqrt(q.shape[-1]))).to(q.dtype)
        return t_flash.attention_ref(qs, k, v, causal=causal, window=window, softcap=softcap)

    def decode(q, k, v, lengths, *, softcap, scale):
        assert q.shape[-1] in dims
        qs = (q.float() * (scale * math.sqrt(q.shape[-1]))).to(q.dtype)
        return t_decode.decode_attention_ref(qs, k, v, lengths, softcap)
    return flash, decode


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_padded_head_dims_match_jax(dtype, monkeypatch):
    """The card's path for head dims between the kernels' (16, 48, 96 and
    200): zero-padded to the next kernel head dim at the true dim's scale,
    the output sliced back, with the kernels replaced by plain versions that
    check the dim they are handed. Equals the JAX ops at the kernel tests'
    tolerances: the padding is exact. (In fp32 the fake kernel's q is scaled
    exactly as the kernel scales its logits; in bf16 the scaled q is rounded
    once more.)"""
    flash, decode = _plain_at_kernel_dims(t_flash_kernel.HEAD_DIMS)
    for name in ("flash_attention_cuda", "flash_attention_wgmma_cuda"):
        monkeypatch.setattr(t_flash_kernel, name, flash)
    for name in ("decode_attention_cuda", "decode_attention_chunked_cuda"):
        monkeypatch.setattr(t_decode_kernel, name, decode)
    for d in (16, 48, 96, 200):
        jq, tq = both(normal(40, (1, 4, 40, d)), dtype)
        jk, tk = both(normal(41, (1, 2, 40, d)), dtype)
        jv, tv = both(normal(42, (1, 2, 40, d)), dtype)
        got = t_flash_kernel.attention_cuda(tq, tk, tv, causal=True, window=16)
        want = K.flash_attention.flash_attention(jq, jk, jv, causal=True, window=16)
        assert got.shape == tq.shape and rel_err(t2np(got), want) < tol(dtype), d
        jq, tq = both(normal(43, (2, 1, 4, d)), dtype)
        jk, tk = both(normal(44, (2, 50, 1, d)), dtype)
        lens = np.array([50, 17], np.int32)
        got = t_decode_kernel.decode_cuda(tq, tk, tk, torch.from_numpy(lens))
        want = K.decode_attention.decode_attention(jq, jk, jk, jnp.asarray(lens))
        assert got.shape == tq.shape and rel_err(t2np(got), want) < tol(dtype), d


def test_wkv_padded_head_sizes_match_jax(monkeypatch):
    """The card's path for head sizes 16 and 48: r, k, v, u zero-padded and
    w one-padded to the next kernel size, the state's padded rows and
    columns zero, output and state sliced back (into ``state_out`` in
    place), with the kernels replaced by the plain version at the padded
    size. Equals the JAX model's scan at the wkv bound: the padding is
    exact."""
    def plain(r, k, v, w, u, state0=None, lengths=None, *, state_out=None):
        assert r.shape[-1] in t_wkv_kernel.HEAD_SIZES
        out, state = wkv_ref(r, k, v, w, u, state0, lengths)
        return out, state if state_out is None else state_out.copy_(state)

    for name in ("wkv_cuda", "wkv_chunked_cuda"):
        monkeypatch.setattr(t_wkv_kernel, name, plain)
    monkeypatch.setattr(t_wkv, "runs_plain", lambda t: False)
    for N in (16, 48):
        B, T, H = 2, 20, 2
        r, k, v, w = wkv_inputs(46, (B, T, H, N))
        u, s0 = normal(47, (H, N)), normal(48, (B, H, N, N))
        want_out, want_state = jax_recurrent.wkv_scan(
            *(jnp.asarray(a) for a in (r, k, v, w)), jnp.asarray(u), jnp.asarray(s0),
            chunk=16)
        state = torch.from_numpy(s0.copy())
        out, got_state = t_wkv.wkv(*(torch.from_numpy(a) for a in (r, k, v, w, u)), state,
                                   state_out=state)
        assert got_state is state and out.shape == (B, T, H, N)
        assert rel_err(out.numpy(), want_out) < WKV_TOL
        assert rel_err(state.numpy(), want_state) < WKV_TOL


# ---------------- gated GELU ----------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gelu_mul_plain_matches_jax(dtype):
    """gelu(g) * u against JAX's ``jax.nn.gelu(g, approximate=True) * u``
    (the gated-GELU MLP's product): one rounding here, two in JAX's bf16."""
    jg, tg = both(normal(50, (64, 384)) * 3, dtype)
    ju, tu = both(normal(51, (64, 384)), dtype)
    got = t_gelu.gelu_mul(tg, tu)
    want = jax.nn.gelu(jg, approximate=True) * ju
    assert got.dtype == tg.dtype and rel_err(t2np(got), want) < tol(dtype)
    assert torch.equal(got, gelu_mul_ref(tg, tu))


def test_gelu_mul_matches_jax_gated_mlp():
    """recurrentgemma's MLP (smoke size, the same bf16 weights): the port's
    ``mlp_apply`` through gelu_mul against JAX's ``mlp_apply``, at 2e-2."""
    import dataclasses

    from repro.configs import get_config as jax_get_config, smoke_config as jax_smoke
    from repro_torch.configs import ModelConfig
    jcfg = jax_smoke(jax_get_config("recurrentgemma-2b"))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = jax_layers.mlp_init(jcfg, jax.random.PRNGKey(3))
    tp = torch.nn.ParameterDict({n: torch.nn.Parameter(torch.from_numpy(
        np.asarray(a, np.float32)).bfloat16(), requires_grad=False) for n, a in jp.items()})
    jx, tx = both(normal(52, (2, 9, cfg.d_model)), "bfloat16")
    want = jax_layers.mlp_apply(jcfg, jp, jx)
    got = t_layers.mlp_apply(cfg, tp, tx)
    assert got.dtype == torch.bfloat16 and rel_err(t2np(got), want) < 2e-2


# ---------------- the RG-LRU scan ----------------

RGLRU_TOL = 1e-4


def rglru_pair(d=64):
    """(JAX config, JAX params, port config, port params) of an RG-LRU block,
    every leaf fp32 (the comparison of the algorithm)."""
    import dataclasses

    from repro.configs import get_config as jax_get_config, smoke_config as jax_smoke
    from repro_torch.configs import ModelConfig
    jcfg = dataclasses.replace(jax_smoke(jax_get_config("recurrentgemma-2b")), d_model=d)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jax_recurrent.rglru_init(jcfg, jax.random.PRNGKey(4)))
    jp["lam"] = jnp.asarray(np.linspace(-4.0, 9.0, d, dtype=np.float32))  # decays near 1 and 0
    tp = torch.nn.ParameterDict({n: torch.nn.Parameter(torch.from_numpy(np.array(a)),
                                                       requires_grad=False)
                                 for n, a in jp.items()})
    return jcfg, jp, ModelConfig(**dataclasses.asdict(jcfg)), tp


def test_rglru_gates_match_jax():
    """a and b of the recurrence from the port's gates against JAX's
    ``_rglru_gates`` on the same fp32 input, at fp32 rounding."""
    from repro_torch.kernels.rglru.ref import rglru_gates
    _, jp, _, tp = rglru_pair()
    u = normal(53, (2, 7, 64))
    ja, jb = jax_recurrent._rglru_gates(jp, jnp.asarray(u))
    uf = torch.from_numpy(u)
    a, b = rglru_gates(uf, uf @ tp["w_a"], uf @ tp["w_x"], tp["lam"])
    assert rel_err(a.numpy(), ja) < 1e-5 and rel_err(b.numpy(), jb) < 1e-5


def test_rglru_plain_matches_jax_block_with_state():
    """The port's RG-LRU block (gelu branch, conv, gates, the rglru op's
    plain scan) against JAX's ``rglru_apply`` in fp32 from a nonzero h0 and
    conv carry, output, final h and carry at 1e-4; then three steps against
    ``rglru_decode_step``, h updated in place."""
    from repro_torch.models import recurrent as t_recurrent
    jcfg, jp, cfg, tp = rglru_pair()
    x, h0 = normal(54, (2, 19, 64)), normal(55, (2, 64))
    carry = normal(56, (2, cfg.rglru_conv_width - 1, 64))
    jy, (jh, jc) = jax_recurrent.rglru_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(h0),
                                             jnp.asarray(carry))
    y, (h, c) = t_recurrent.rglru_apply(cfg, tp, torch.from_numpy(x), torch.from_numpy(h0),
                                        torch.from_numpy(carry))
    for got, want in ((y, jy), (h, jh), (c, jc)):
        assert rel_err(got.numpy(), want) < RGLRU_TOL
    h, c, jh, jc = h.clone(), c, jh, jc
    for s in range(3):
        xs = normal(57 + s, (2, 1, 64))
        jy, (jh, jc) = jax_recurrent.rglru_decode_step(jcfg, jp, jnp.asarray(xs), jh, jc)
        y, (h_new, c) = t_recurrent.rglru_decode_step(cfg, tp, torch.from_numpy(xs), h, c)
        assert h_new is h
        for got, want in ((y, jy), (h, jh), (c, jc)):
            assert rel_err(got.numpy(), want) < RGLRU_TOL


def test_rglru_lengths_match_jax_on_the_unpadded_sequence():
    """Per-sequence lengths: each sequence's output on its real steps, final
    h and conv carry (its last W - 1 real inputs) equal JAX's block run on
    that sequence alone, unpadded; the op's h_out is written in place."""
    from repro_torch.models import recurrent as t_recurrent
    jcfg, jp, cfg, tp = rglru_pair()
    x = normal(60, (3, 17, 64))
    lens = [17, 9, 2]
    h_out = torch.full((3, 64), 7.0)
    y, (h, c) = t_recurrent.rglru_apply(cfg, tp, torch.from_numpy(x),
                                        lengths=torch.tensor(lens, dtype=torch.int32),
                                        h_out=h_out)
    assert h is h_out
    for b, n in enumerate(lens):
        jy, (jh, jc) = jax_recurrent.rglru_apply(jcfg, jp, jnp.asarray(x[b:b + 1, :n]))
        assert rel_err(y[b:b + 1, :n].numpy(), jy) < RGLRU_TOL
        assert rel_err(h[b:b + 1].numpy(), jh) < RGLRU_TOL
        assert rel_err(c[b:b + 1].numpy(), jc) < RGLRU_TOL


def test_rglru_op_plain_is_the_step_loop():
    """The op on CPU tensors is ``rglru_ref``: bf16 u and gate, fp32 gates,
    the wave, a batch-1 call and T = 1 from h0, equal bit for bit; the
    output past a sequence's length is the gate times its frozen h."""
    rng = np.random.default_rng(61)
    B, T, d = 3, 12, 32
    u = torch.from_numpy(rng.standard_normal((B, T, d)).astype(np.float32)).bfloat16()
    gate = torch.from_numpy(rng.standard_normal((B, T, d)).astype(np.float32)).bfloat16()
    ga, gx = (torch.from_numpy(rng.standard_normal((B, T, d)).astype(np.float32) * 3)
              for _ in range(2))
    lam = torch.from_numpy(np.linspace(-3, 8, d, dtype=np.float32))
    h0 = torch.from_numpy(rng.standard_normal((B, d)).astype(np.float32))
    lens = torch.tensor([12, 5, 1], dtype=torch.int32)
    for args in ((u, ga, gx, lam, gate, h0, lens), (u[:1], ga[:1], gx[:1], lam, gate[:1]),
                 (u[:, :1], ga[:, :1], gx[:, :1], lam, gate[:, :1], h0)):
        y, h = t_rglru.rglru(*args)
        wy, wh = rglru_ref(*args)
        assert torch.equal(y, wy) and torch.equal(h, wh)
    y, h = t_rglru.rglru(u, ga, gx, lam, gate, h0, lens)
    assert torch.equal(y[1, 5:], gate[1, 5:].float() * h[1])


def rglru_inputs(seed, B, T, d, lam=(-6.0, 12.0), with_h0=True):
    """u and the gate bf16, ga and gx fp32 at 3 sigma, lam over `lam` (or
    one value), h0 nonzero or None: numpy draws as torch tensors."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    lam = torch.full((d,), float(lam)) if np.isscalar(lam) else torch.linspace(*lam, d)
    return (draw(B, T, d).bfloat16(), draw(B, T, d) * 3, draw(B, T, d) * 3, lam,
            draw(B, T, d).bfloat16(), draw(B, d) if with_h0 else None)


@pytest.mark.parametrize("B,T,chunk,lens,lam,with_h0", [
    (3, 37, 8, None, (-6.0, 12.0), True),           # the chunk does not divide T
    (2, 5, 8, None, (-6.0, 12.0), True),            # T < chunk
    (2, 1, 8, None, (-6.0, 12.0), True),            # T = 1
    (4, 29, 4, [29, 0, 13, 4], (-6.0, 12.0), False),  # unequal lengths, one of 0
    (3, 40, 8, [40, 17, 0], (-6.0, 12.0), True),    # lengths and a nonzero h0
    (2, 70, 8, None, -6.0, True),                   # decays near 1
    (2, 70, 8, [70, 33], 12.0, True),               # near 0: a chunk's product underflows
    (1, 130, 16, None, (-6.0, 12.0), True)])
def test_rglru_chunked_ref_is_the_step_loop(B, T, chunk, lens, lam, with_h0):
    """The chunked kernel's arithmetic (chunk products in log space, the
    carry fold, the fix-up) against the step loop, y and the final h within
    1e-5 of the largest: the same recurrence summed in another order."""
    u, ga, gx, lam_t, gate, h0 = rglru_inputs(62 + T, B, T, 256, lam, with_h0)
    lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    y, h = rglru_chunked_ref(u, ga, gx, lam_t, gate, h0, lengths, chunk=chunk)
    wy, wh = rglru_ref(u, ga, gx, lam_t, gate, h0, lengths)
    assert y.shape == wy.shape and h.shape == wh.shape
    assert rel_err(y.numpy(), wy.numpy()) < 1e-5 and rel_err(h.numpy(), wh.numpy()) < 1e-5
    if lam == 12.0:   # the underflow is exercised: a chunk's product is 0
        log_a = -8 * torch.sigmoid(ga) * torch.nn.functional.softplus(lam_t)
        assert torch.exp(log_a[:, :chunk].sum(1)).eq(0).any()
    for b, n in enumerate(lens or []):
        if n == 0:   # no real step: h stays h0 (or 0)
            assert torch.equal(h[b], torch.zeros(256) if h0 is None else h0[b])
        if n < T:   # past its length a sequence's output is the gate times its h
            assert torch.allclose(y[b, n:], gate[b, n:].float() * h[b], rtol=1e-6, atol=0)


@pytest.mark.parametrize("chunk", [4, 8])
def test_rglru_chunked_ref_matches_jax_associative_scan(chunk, monkeypatch):
    """The port's RG-LRU block with its scan computed as the chunked kernel
    computes it, against JAX's ``rglru_apply`` (``lax.associative_scan``,
    h0 folded into the first step) on the same numpy inputs in fp32, at
    full length: output, final h and conv carry at 1e-4."""
    from repro_torch.models import recurrent as t_recurrent
    jcfg, jp, cfg, tp = rglru_pair()
    x, h0 = normal(63, (2, 37, 64)), normal(64, (2, 64))
    carry = normal(65, (2, cfg.rglru_conv_width - 1, 64))

    def scan(u, ga, gx, lam, gate, h0=None, lengths=None, *, h_out=None):
        y, h = rglru_chunked_ref(u, ga, gx, lam, gate, h0, lengths, chunk=chunk)
        return y, h if h_out is None else h_out.copy_(h)
    monkeypatch.setattr(t_recurrent, "rglru", scan)
    jy, (jh, jc) = jax_recurrent.rglru_apply(jcfg, jp, jnp.asarray(x), jnp.asarray(h0),
                                             jnp.asarray(carry))
    y, (h, c) = t_recurrent.rglru_apply(cfg, tp, torch.from_numpy(x), torch.from_numpy(h0),
                                        torch.from_numpy(carry))
    for got, want in ((y, jy), (h, jh), (c, jc)):
        assert rel_err(got.numpy(), want) < RGLRU_TOL


def test_rglru_op_routes_prefill_to_the_chunked_kernel(monkeypatch):
    """Without a card: the op's predicate (``kernel.picks_chunked``) sends
    a call of T > 1 to ``rglru_chunked`` and T = 1 (the decode step) to
    ``rglru``, as the op routes a CUDA tensor; a d that is no multiple of 8
    and a base off 16 bytes, which the chunked kernel cannot take
    (``kernel.chunked_eligible``), go to ``rglru`` too."""
    called = []
    monkeypatch.setattr(t_rglru, "runs_plain", lambda t: False)
    for name in ("rglru_cuda", "rglru_chunked_cuda"):
        monkeypatch.setattr(t_rglru_kernel, name,
                            lambda *a, h_out=None, name=name: called.append(name))
    for T, d, offset, want in ((452, 64, 0, "rglru_chunked_cuda"),
                               (2, 64, 0, "rglru_chunked_cuda"),
                               (1, 64, 0, "rglru_cuda"),
                               (9, 60, 0, "rglru_cuda"),
                               (9, 64, 1, "rglru_cuda")):
        u, ga, gx, lam, gate, h0 = rglru_inputs(66, 2, T, d)
        if offset:   # a view one element into its storage
            u = torch.cat([u.flatten(), u.new_zeros(offset)])[offset:].view(u.shape)
        assert t_rglru_kernel.picks_chunked(u, ga, gx, gate) == (want != "rglru_cuda")
        assert t_rglru_kernel.chunked_eligible(u, ga, gx, gate) == (d % 8 == 0 and not offset)
        t_rglru.rglru(u, ga, gx, lam, gate, h0)
        assert called.pop() == want and not called


# ---------------- dispatch ----------------

def test_cpu_tensors_run_plain_and_count_no_launch():
    TK.reset_launches()
    x = torch.from_numpy(normal(0, (4, 32)))
    g = torch.ones(32)
    assert torch.equal(t_rmsnorm.rmsnorm(x, g), rmsnorm_ref(x, g))
    assert torch.equal(t_gelu.silu_mul(x, x), silu_mul_ref(x, x))
    assert torch.equal(t_rmsnorm.layernorm(x, g, g), layernorm_ref(x, g, g))
    assert torch.equal(t_gelu.gelu(x), gelu_ref(x))
    r = x.view(1, 4, 1, 32)
    assert torch.equal(t_wkv.wkv(r, r, r, r, g.view(1, 32))[0],
                       wkv_ref(r, r, r, r, g.view(1, 32))[0])
    assert TK.launches() == {name: 0 for name in TK.KERNELS}


@pytest.mark.parametrize("name", sorted(TK.KERNELS))
def test_kernel_wrappers_refuse_cpu_tensors(name):
    """A wrapper never falls back to the plain version: a tensor it cannot
    launch on is refused before anything is built."""
    x = torch.zeros(2, 4, 8, 32)
    args = {"rmsnorm": (x[0, 0], torch.ones(32)),
            "layernorm": (x[0, 0], torch.ones(32), torch.zeros(32)),
            "gelu": (x,),
            "gelu_mul": (x, x),
            "silu_mul": (x, x),
            "flash_attention": (x, x, x),
            "flash_attention_wgmma": (torch.zeros(2, 4, 8, 64, dtype=torch.bfloat16),) * 3,
            "decode_attention": (x, x.transpose(1, 2).contiguous(), x.transpose(1, 2).contiguous(),
                                 torch.full((2,), 8, dtype=torch.int32)),
            "decode_attention_chunked": (x.bfloat16(), x.transpose(1, 2).contiguous().bfloat16(),
                                         x.transpose(1, 2).contiguous().bfloat16(),
                                         torch.full((2,), 8, dtype=torch.int32)),
            "wkv": (x, x, x, x, torch.zeros(8, 32)),
            "wkv_chunked": (x, x, x, x, torch.zeros(8, 32)),
            "rglru": (x[0].bfloat16(), x[0], x[0], torch.zeros(32), x[0].bfloat16()),
            "rglru_chunked": (x[0].bfloat16(), x[0], x[0], torch.zeros(32),
                              x[0].bfloat16()),
            "matmul": (x[0, 0], x[0, 0].t()),
            "matmul_wgmma": (x[0, 0].bfloat16(), x[0, 0].t().contiguous().bfloat16()),
            "matmul_f32_tma": (x[0, 0], x[0, 0].t().contiguous()),
            "matmul_reduce": (x[0], x[0, 0]),
            "matmul_int8": (x[0, 0].to(torch.int8), x[0, 0].t().to(torch.int8),
                            torch.ones(4, 1), torch.ones(1, 4)),
            "matmul_int8_wgmma": (x[0, 0].to(torch.int8), x[0, 0].t().to(torch.int8),
                                  torch.ones(4, 1), torch.ones(1, 4))}[name]
    with pytest.raises(ValueError, match="CUDA"):
        TK.KERNELS[name](*args)


def test_ops_refuse_other_devices():
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_rmsnorm.rmsnorm(torch.zeros(2, 8, device="meta"), torch.ones(8))
