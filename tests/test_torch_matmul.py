"""The port's GEMM ops and its analytical copy against the JAX package.

On the CPU ``repro_torch.kernels.matmul.ops`` runs its plain PyTorch
versions; each op is held against the JAX op on the same numpy inputs, the
Pallas kernels run in interpret mode as ``tests/test_kernels.py`` runs them,
at that file's shapes, blocks and tolerances (relative to the largest output:
bf16 2e-2, fp32 and fp8 2e-5, int8 1e-4). The quantizers are held bit for
bit, the e4m3 cast on values beyond e4m3's range too (ROADMAP C1), and the
port's mapper copy to the JAX mapper on every preset both have. The
hand-written kernels are held against the plain versions on the card by
``tests/test_torch_cuda.py`` (marked ``cuda``) and by ``chip_smoke.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import kernels as K
from repro.core import hardware as jax_hw
from repro.core import mapper as jax_mapper
from repro.kernels.matmul import ref as jax_ref
import repro_torch.kernels as TK
from repro_torch.core import hardware as t_hw
from repro_torch.core import mapper as t_mapper
from repro_torch.kernels.matmul import ops as t_mm
from repro_torch.kernels.matmul import ref as t_ref
from repro_torch.kernels.matmul.kernel import TILES, select_tile
from test_torch_cuda import gemm_excess

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(128, 128, 128), (256, 512, 128), (100, 200, 50), (1, 300, 77), (513, 129, 257)]


def rel_err(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-9))


def both(x, name="float32"):
    """One numpy float32 array as a JAX and a torch array of `name` dtype
    (both round float32 to bf16 to nearest even: identical bits)."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def t2np(t):
    return t.float().numpy()


def normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------- ops against the JAX ops ----------------

@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_matmul_matches_jax(m, k, n, name):
    ja, ta = both(normal(m * 1000 + k + n, (m, k)), name)
    jb, tb = both(normal(n, (k, n)), name)
    want = K.matmul.matmul(ja, jb, bm=128, bk=128, bn=128)
    got = t_mm.matmul(ta, tb, bm=128, bk=128, bn=128)
    assert got.shape == (m, n) and got.dtype == DTYPES[name][1]
    assert rel_err(t2np(got), want) < (2e-2 if name == "bfloat16" else 2e-5)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_matmul_int8_matches_jax(m, k, n):
    ja, ta = both(normal(m * 1000 + k + n, (m, k)))
    jb, tb = both(normal(3, (k, n)))
    want = K.matmul.matmul_int8(ja, jb, bm=128, bk=128, bn=128)
    got = t_mm.matmul_int8(ta, tb, bm=128, bk=128, bn=128)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert rel_err(t2np(got), want) < 1e-4
    assert rel_err(t2np(got), K.matmul.reference_int8(ja, jb)) < 1e-4


@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (100, 200, 50), (513, 129, 257)])
def test_matmul_fp8_matches_jax(m, k, n):
    ja, ta = both(normal(m + k + n, (m, k)))
    jb, tb = both(normal(9, (k, n)))
    want = K.matmul.matmul_fp8(ja, jb, bm=128, bk=128, bn=128)
    got = t_mm.matmul_fp8(ta, tb, bm=128, bk=128, bn=128)
    assert got.dtype == torch.float32
    assert rel_err(t2np(got), want) < 2e-5
    assert rel_err(t2np(got), K.matmul.reference(ja, jb)) < 8e-2   # e4m3's 3-bit mantissa


def test_matmul_fp8_keeps_a_bf16_dtype():
    ja, ta = both(normal(1, (33, 64)), "bfloat16")
    jb, tb = both(normal(2, (64, 40)), "bfloat16")
    want = K.matmul.matmul_fp8(ja, jb, bm=128, bk=128, bn=128)
    got = t_mm.matmul_fp8(ta, tb, bm=128, bk=128, bn=128)
    assert got.dtype == torch.bfloat16 and rel_err(t2np(got), want) < 2e-2


def test_matmul_int8_approximates_exact():
    """Per-row/per-column symmetric int8 keeps the GEMM within a few % of
    the exact fp32 result on normal data (test_kernels.py:65)."""
    a, b = torch.from_numpy(normal(42, (192, 384))), torch.from_numpy(normal(43, (384, 160)))
    out = t_mm.matmul_int8(a, b, bm=64, bk=128, bn=64)
    assert rel_err(t2np(out), t2np(t_ref.matmul_ref(a, b))) < 5e-2


def test_matmul_int8_scale_invariance():
    """Per-row input scaling passes through the symmetric per-vector scales
    up to quantization error (test_kernels.py:76)."""
    a, b = torch.from_numpy(normal(7, (64, 256))), torch.from_numpy(normal(8, (256, 96)))
    rows = torch.linspace(0.01, 100.0, 64)[:, None]
    out = t_mm.matmul_int8(a * rows, b, bm=64, bk=64, bn=64)
    ref = t_mm.matmul_int8(a, b, bm=64, bk=64, bn=64) * rows
    assert rel_err(t2np(out), t2np(ref)) < 5e-2


def test_reference_aliases():
    assert t_mm.reference is t_ref.matmul_ref
    assert t_mm.reference_int8 is t_ref.matmul_int8_ref
    assert t_mm.reference_fp8 is t_ref.matmul_fp8_ref


# ---------------- quantizers, bit for bit ----------------

@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_int8_is_bit_exact(axis, name):
    x = normal(11, (37, 53)) * np.float32(3.0)
    x[5] = 0.0                                  # a zero row
    x[:, 7] = 0.0                               # and a zero column
    x[9] *= np.float32(1e-6)                    # a row of tiny values
    jx, tx = both(x, name)
    jq, js = jax_ref.quantize_int8(jx, axis=axis)
    tq, ts = t_ref.quantize_int8(tx, axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


def test_quantize_int8_rounds_half_to_even():
    # amax 127 gives scale 1: x / scale lands on exact halves
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5]], np.float32)
    jx, tx = both(x)
    jq, _ = jax_ref.quantize_int8(jx, axis=1)
    tq, _ = t_ref.quantize_int8(tx, axis=1)
    assert tq.tolist() == [[127, 0, 2, 2, 0, -2, 126]]
    assert np.array_equal(tq.numpy(), np.asarray(jq))


SPECIAL = [447.0, 448.0, 464.0, 465.0, 500.0, 1e4, np.inf]


def test_quantize_fp8_puts_nan_where_jax_does():
    """ROADMAP C1: torch's own e4m3 cast saturates to +-448; the port's gives
    NaN wherever ml_dtypes does (|x| > 464, +-inf, NaN) and the same e4m3
    value elsewhere, subnormals and ties included."""
    vals = np.array(SPECIAL + [-v for v in SPECIAL] + [np.nan, 0.0, 2.0 ** -9, 2.0 ** -10,
                                                        3 * 2.0 ** -11, 239.9, 240.1, 1.0625],
                    np.float32)
    vals = np.concatenate([vals, normal(5, (4096,)) * np.float32(100.0)])
    jx, tx = both(vals)
    want = np.asarray(jx.astype(jnp.float8_e4m3fn).astype(jnp.float32))
    got = t_ref.quantize_fp8(tx)
    assert got.dtype == torch.float8_e4m3fn
    got = got.float().numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).sum() >= 9          # 465, 500, 1e4, inf of both signs, NaN
    ok = ~np.isnan(want)
    assert np.array_equal(got[ok], want[ok])
    # torch's own cast would saturate instead
    assert not torch.from_numpy(vals).to(torch.float8_e4m3fn).float().isnan()[3]


def test_matmul_fp8_nan_places_match_jax():
    a, b = normal(3, (20, 48)), normal(4, (48, 30))
    a[3, 5], a[10, 0], a[11, 47] = 500.0, np.inf, -465.0
    b[7, 9], b[0, 29] = -np.inf, 1e4
    a[12, 12], b[13, 13] = 464.0, -448.0
    ja, ta = both(a)
    jb, tb = both(b)
    want = np.asarray(K.matmul.matmul_fp8(ja, jb, bm=128, bk=128, bn=128))
    got = t_mm.matmul_fp8(ta, tb).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want)) and np.isnan(got).any()
    ok = ~np.isnan(want)
    assert rel_err(got[ok], want[ok]) < 2e-5


# ---------------- the per-element GEMM check ----------------

def test_gemm_check_catches_a_dropped_k_step_and_a_transposed_b_tile():
    """``gemm_excess`` (the card's per-element GEMM check) passes the plain
    version against a float64 product and fails the two mutants a tiled
    kernel can make: one k-step of 16 products dropped, one 16x16 tile of B
    used transposed."""
    m, k, n = 64, 12288, 96
    a = torch.from_numpy(normal(1, (m, k))).bfloat16()
    b = torch.from_numpy(normal(2, (k, n))).bfloat16()
    want = t_ref.matmul_ref(a, b)
    exact = (a.double() @ b.double()).bfloat16()
    assert gemm_excess(exact, want, a, b) <= 1
    drop = (a.double() @ b.double() - a[:, 4096:4112].double() @ b[4096:4112].double())
    bt = b.clone()
    bt[512:528, 32:48] = b[512:528, 32:48].t()
    for mutant in (drop.bfloat16(), (a.double() @ bt.double()).bfloat16()):
        assert gemm_excess(mutant, want, a, b) > 1


# ---------------- tiles and dispatch ----------------

def test_select_tile_maps_inside_the_request_or_refuses():
    bf = torch.bfloat16
    assert select_tile(bf, 256, 512, 256) == (128, 32, 128)    # the JAX default
    assert select_tile(bf, 128, 128, 128) == (128, 32, 128)
    assert select_tile(bf, 64, 64, 64) == (64, 32, 64)
    assert select_tile(torch.int8, 128, 128, 128) == (128, 64, 128)
    assert select_tile(torch.float32, 64, 64, 64) == (64, 16, 64)
    for dtype, tiles in TILES.items():
        assert all(select_tile(dtype, *t) == t for t in tiles)
    with pytest.raises(ValueError, match="compiled tiles are"):
        select_tile(bf, 8, 512, 256)
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="compiled tiles are"):
        t_mm.matmul_int8(x, x, bm=16, bk=16, bn=16)


def test_cpu_tensors_run_plain_and_count_no_launch():
    TK.reset_launches()
    a, b = torch.from_numpy(normal(0, (5, 40))), torch.from_numpy(normal(1, (40, 6)))
    assert torch.equal(t_mm.matmul(a, b), t_ref.matmul_ref(a, b))
    assert torch.equal(t_mm.matmul_int8(a, b), t_ref.matmul_int8_ref(a, b))
    assert torch.equal(t_mm.matmul_fp8(a, b), t_ref.matmul_fp8_ref(a, b))
    assert TK.launches() == {name: 0 for name in TK.KERNELS}


def test_ops_never_fall_back_to_the_plain_version(monkeypatch):
    """Where the dispatch picks the kernel, a tensor the kernel cannot take
    raises; on a host without CUDA the wrappers refuse and nothing is
    built."""
    monkeypatch.setattr(t_mm, "runs_plain", lambda t: False)
    a = torch.zeros(4, 8)
    for op in (t_mm.matmul, t_mm.matmul_int8, t_mm.matmul_fp8):
        with pytest.raises(ValueError, match="CUDA"):
            op(a, a.t())
    assert TK.launches()["matmul"] == 0 and TK.launches()["matmul_int8"] == 0


# ---------------- the analytical copy ----------------

MAPPER_SHAPES = [(1, 4096, 4096), (8, 12288, 36864), (8, 49152, 12288), (4096, 12288, 12288),
                 (513, 129, 257), (64, 128, 2048), (2048, 2048, 2048)]


@pytest.mark.parametrize("preset", sorted(jax_hw.PRESETS))
def test_port_mapper_equals_jax_mapper(preset):
    """The same winning mapping and latency (to 1e-12 relative) on every
    preset both packages have, including narrow widths and a batch."""
    jdev, tdev = jax_hw.PRESETS[preset](), t_hw.PRESETS[preset]()
    assert dataclasses.asdict(jdev) == dataclasses.asdict(tdev)
    cases = [((m, k, n), {}) for m, k, n in MAPPER_SHAPES] + [
        ((256, 1024, 512), dict(bytes_a=1, bytes_b=1, bytes_out=4, mac_scale=2.0)),
        ((128, 128, 512), dict(batch=8, b_shared=True))]
    for (m, k, n), kw in cases:
        want = jax_mapper.matmul_perf(jdev, m, k, n, **kw)
        got = t_mapper.matmul_perf(tdev, m, k, n, **kw)
        assert dataclasses.astuple(got.mapping) == dataclasses.astuple(want.mapping)
        assert abs(got.latency - want.latency) <= 1e-12 * want.latency
        assert (got.flops, got.main_memory_bytes, got.candidates_searched) == \
            (want.flops, want.main_memory_bytes, want.candidates_searched)


def test_h100_preset_reproduces_its_peaks():
    dev = t_hw.get_device("h100")
    assert dev.core_count == 132 and dev.core.lanes == 4
    assert abs(dev.peak_matmul_flops - 989.4e12) < 0.001 * 989.4e12
    assert abs(dev.peak_vector_flops - 67e12) < 0.01 * 67e12
    assert dev.memory_bandwidth == 3.35e12 and dev.global_buffer_bytes == 50 * t_hw.MB
    assert dev.core.local_buffer_bytes == 228 * t_hw.KB


@pytest.mark.parametrize("m,k,n", [(4096, 4096, 4096), (8, 12288, 49152), (513, 129, 257),
                                   (4096, 49152, 12288)])
def test_mapper_blocks_are_compiled_hopper_tiles(m, k, n):
    """Mirrors tests/test_mapper.py:113 with Hopper's tiles in place of the
    MXU's 128 alignment."""
    assert t_mm.mapper_blocks(m, k, n) in TILES[torch.bfloat16]
