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
from repro_torch.kernels.matmul.kernel import (MMA_SYNC_TILES, SMS, TILES, nearest_tile,
                                               select_tile, split_plan, tma_eligible)
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

def test_select_tile_maps_every_request_to_a_compiled_tile():
    """The largest compiled tile inside a request, else the nearest (least
    sum of |log2| distances, ties to the larger tile); only a block that is
    not positive raises."""
    bf, f8 = torch.bfloat16, torch.float8_e4m3fn
    assert select_tile(bf, 256, 512, 256) == (128, 64, 256)    # the JAX default
    assert select_tile(bf, 128, 128, 128) == (128, 64, 256)    # nearest: none inside
    assert select_tile(bf, 64, 64, 64) == (64, 64, 256)
    assert select_tile(bf, 8, 512, 256) == (64, 64, 256)       # decode: M = 8 clamps bm
    assert select_tile(f8, 8, 512, 256) == (64, 128, 128)
    assert select_tile(f8, 256, 512, 256) == (128, 128, 128)
    assert select_tile(torch.int8, 128, 128, 128) == (128, 64, 128)
    assert select_tile(torch.float32, 64, 64, 64) == (64, 16, 64)
    assert select_tile(bf, 1, 128, 77, tiles=MMA_SYNC_TILES) == (16, 64, 128)
    for dtype, tiles in TILES.items():
        assert all(select_tile(dtype, *t) == t for t in tiles)
        for request in REFUSED_BEFORE:
            assert select_tile(dtype, *request) in tiles
    # a tie (4 + 3 + 0 against 3 + 3 + 1) goes to the larger tile
    assert nearest_tile(((64, 64, 128), (128, 64, 256)), (8, 512, 256)) == (128, 64, 256)
    for bad in ((0, 16, 16), (16, -1, 16), (16, 16, 0)):
        with pytest.raises(ValueError, match="positive"):
            select_tile(bf, *bad)
    x = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="positive"):
        t_mm.matmul_int8(x, x, bm=0, bk=16, bn=16)


#: block requests that no compiled tile fitted inside before every request
#: was mapped to the nearest tile
REFUSED_BEFORE = [(16, 16, 16), (32, 32, 32), (8, 512, 256), (8, 8, 8)]


@pytest.mark.parametrize("bm,bk,bn", REFUSED_BEFORE)
def test_small_block_requests_match_jax(bm, bk, bn):
    """Requests the port once refused run and equal the JAX ops (interpret
    mode) on the same numpy operands: matmul in fp32 and bf16, matmul_int8
    and matmul_fp8, at the file's tolerances."""
    blocks = dict(bm=bm, bk=bk, bn=bn)
    a, b = normal(40, (40, 48)), normal(24, (48, 24))
    for name in sorted(DTYPES):
        (ja, ta), (jb, tb) = both(a, name), both(b, name)
        got = t_mm.matmul(ta, tb, **blocks)
        assert got.dtype == DTYPES[name][1]
        assert rel_err(t2np(got), K.matmul.matmul(ja, jb, **blocks)) < \
            (2e-2 if name == "bfloat16" else 2e-5)
    (ja, ta), (jb, tb) = both(a), both(b)
    assert rel_err(t2np(t_mm.matmul_int8(ta, tb, **blocks)),
                   K.matmul.matmul_int8(ja, jb, **blocks)) < 1e-4
    assert rel_err(t2np(t_mm.matmul_fp8(ta, tb, **blocks)),
                   K.matmul.matmul_fp8(ja, jb, **blocks)) < 2e-5


GPT3_GEMMS = [(12288, 36864), (12288, 12288), (12288, 49152), (49152, 12288)]


def test_tma_eligibility_routes_shapes():
    """The wgmma path's predicate: gpt3-175b's GEMMs (bf16 and e4m3, M = 8
    and 4096) go to it; the JAX test shapes whose row pitches are not
    multiples of 16 bytes (K = 129, 300 in bf16; N = 77, 50; e4m3 K = 200)
    and operands at a base that is not 16-byte aligned go to mma.sync; fp32
    never does."""
    bf, f8 = torch.bfloat16, torch.float8_e4m3fn
    for m in (8, 4096):
        for k, n in GPT3_GEMMS:
            assert tma_eligible(bf, m, k, n) and tma_eligible(f8, m, k, n)
    for m, k, n in ((513, 129, 257), (1, 300, 77), (100, 200, 50)):
        assert not tma_eligible(bf, m, k, n) and not tma_eligible(f8, m, k, n)
    assert tma_eligible(bf, 128, 128, 128) and tma_eligible(f8, 256, 512, 128)
    assert tma_eligible(f8, 1, 16, 77)                       # B is stored (N,K): only K counts
    assert not tma_eligible(torch.float32, 128, 128, 128)
    flat = torch.zeros(64 * 64 + 8, dtype=bf)
    a, b = flat[:4096].view(64, 64), torch.zeros((64, 64), dtype=bf)
    assert tma_eligible(bf, 64, 64, 64, a.data_ptr(), b.data_ptr()) == \
        (a.data_ptr() % 16 == 0)
    for offset in range(1, 8):                               # 2-14 bytes past the base
        view = flat[offset:offset + 4096].view(64, 64)
        assert tma_eligible(bf, 64, 64, 64, view.data_ptr(), b.data_ptr()) == \
            (view.data_ptr() % 16 == 0)
    assert not tma_eligible(bf, 64, 64, 64, 8, 0) and not tma_eligible(bf, 64, 64, 64, 0, 2)


@pytest.mark.parametrize("m,k,n", [(8, k, n) for k, n in GPT3_GEMMS] +
                         [(4096, k, n) for k, n in GPT3_GEMMS] +
                         [(128, 128, 128), (8, 200, 264), (1, 208, 136), (65, 12288, 512)])
def test_split_plan_covers_k_once_in_whole_k_tiles(m, k, n):
    """Each split is a whole number of k-tiles but the last, which ends at K;
    the ranges cover K once, in order; no split where the output tiles
    already number 2 x 132 or more; else each split takes the k-tiles of K
    shared among as many splits as bring the blocks to 2 x 132 (at most one
    split per k-tile)."""
    for dtype in (torch.bfloat16, torch.float8_e4m3fn):
        for tile in TILES[dtype]:
            bm, bk, bn = tile
            plan = split_plan(m, n, k, tile)
            assert plan[0][0] == 0 and plan[-1][1] == k
            assert all(p[1] == q[0] for p, q in zip(plan, plan[1:]))
            assert all(k0 % bk == 0 and k0 < k1 for k0, k1 in plan)
            assert all((k1 - k0) % bk == 0 for k0, k1 in plan[:-1])
            per = plan[0][1] - plan[0][0]
            assert all(k1 - k0 == per for k0, k1 in plan[:-1]) and plan[-1][1] - plan[-1][0] <= per
            tiles, kt = -(-m // bm) * -(-n // bn), -(-k // bk)
            if tiles >= 2 * SMS:
                assert len(plan) == 1
            else:
                wanted = min(kt, -(-2 * SMS // tiles))
                assert per == -(-kt // wanted) * bk and len(plan) == -(-kt // (per // bk))
    assert len(split_plan(8, 12288, 12288, (64, 64, 256))) == 6
    assert len(split_plan(4096, 49152, 12288, (128, 64, 256))) == 1


def test_gemm_dispatch_picks_the_path_before_the_launch(monkeypatch):
    """``gemm_cuda`` routes by ``tma_eligible`` alone, with the tile of the
    path's own set, and never calls the other wrapper (CPU tensors, the
    wrappers replaced by recorders)."""
    from repro_torch.kernels.matmul import kernel as t_kernel
    calls = []
    for name in ("matmul_cuda", "matmul_wgmma_cuda"):
        monkeypatch.setattr(t_kernel, name, lambda a, b, _n=name, **kw: calls.append((_n, kw)))
    bf = torch.bfloat16
    cases = [((64, 256, 128), bf, "matmul_wgmma_cuda", (64, 64, 256)),
             ((513, 129, 257), bf, "matmul_cuda", (128, 32, 128)),
             ((100, 200, 50), bf, "matmul_cuda", (64, 64, 128)),
             ((64, 256, 128), torch.float32, "matmul_cuda", (64, 16, 64))]
    for (m, k, n), dtype, path, tile in cases:
        calls.clear()
        a, b = torch.zeros((m, k), dtype=dtype), torch.zeros((k, n), dtype=dtype)
        t_kernel.gemm_cuda(a, b, (min(256, m), min(512, k), min(256, n)))
        assert [c[0] for c in calls] == [path]
        kw = calls[0][1]
        assert (kw["bm"], kw["bk"], kw["bn"]) == tile, (m, k, n, dtype)
    calls.clear()
    a8 = torch.zeros((8, 256), dtype=torch.float8_e4m3fn)
    b8 = torch.zeros((512, 256), dtype=torch.float8_e4m3fn).t()
    t_kernel.gemm_cuda(a8, b8, (8, 256, 256), out_dtype=torch.float32)
    assert calls == [("matmul_wgmma_cuda", dict(bm=64, bk=128, bn=128,
                                                out_dtype=torch.float32))]


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
