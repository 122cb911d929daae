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
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro import kernels as K
from repro.models import layers as jax_layers
from repro.models import recurrent as jax_recurrent
import repro_torch.kernels as TK
from repro_torch.kernels.decode_attention import ops as t_decode
from repro_torch.kernels.flash_attention import ops as t_flash
from repro_torch.kernels.gelu import ops as t_gelu
from repro_torch.kernels.gelu.ref import gelu_ref, silu_mul_ref
from repro_torch.kernels.rmsnorm import ops as t_rmsnorm
from repro_torch.kernels.rmsnorm.ref import layernorm_ref, rmsnorm_ref
from repro_torch.kernels.wkv import ops as t_wkv
from repro_torch.kernels.wkv.ref import wkv_ref
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


# ---------------- decode attention ----------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hkv,g,t", [(2, 4, 128), (1, 8, 200), (4, 1, 64)])
def test_decode_attention_plain_matches_jax(hkv, g, t, dtype):
    B = 3
    jq, tq = both(normal(5, (B, hkv, g, 64)), dtype)
    jk, tk = both(normal(6, (B, t, hkv, 64)), dtype)
    jv, tv = both(normal(7, (B, t, hkv, 64)), dtype)
    lens = np.array([t, max(1, t // 2), max(1, t // 3)], np.int32)
    want = K.decode_attention.decode_attention(jq, jk, jv, jnp.asarray(lens))
    got = t_decode.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    assert got.shape == tq.shape and got.dtype == tq.dtype
    assert rel_err(t2np(got), want) < tol(dtype)


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
            "silu_mul": (x, x),
            "flash_attention": (x, x, x),
            "decode_attention": (x, x.transpose(1, 2).contiguous(), x.transpose(1, 2).contiguous(),
                                 torch.full((2,), 8, dtype=torch.int32)),
            "wkv": (x, x, x, x, torch.zeros(8, 32)),
            "matmul": (x[0, 0], x[0, 0].t()),
            "matmul_wgmma": (x[0, 0].bfloat16(), x[0, 0].t().contiguous().bfloat16()),
            "matmul_reduce": (x[0], x[0, 0]),
            "matmul_int8": (x[0, 0].to(torch.int8), x[0, 0].t().to(torch.int8),
                            torch.ones(4, 1), torch.ones(1, 4))}[name]
    with pytest.raises(ValueError, match="CUDA"):
        TK.KERNELS[name](*args)


def test_ops_refuse_other_devices():
    with pytest.raises(ValueError, match="cpu or cuda"):
        t_rmsnorm.rmsnorm(torch.zeros(2, 8, device="meta"), torch.ones(8))
