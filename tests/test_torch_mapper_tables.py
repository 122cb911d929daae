"""The port's stacked mapper search and its candidate tables against the JAX
package's (``repro.core.mapper``), on the CPU.

* ``_gather_chunk`` gathers the same columns (values and dtypes) from the
  same (device, shape) pairs;
* the numpy ``_tables`` and the plain PyTorch ``kernels/mapper_tables/ref.py``
  give ``_chunk_tables_numpy``'s every output column bit for bit (compared
  as bytes, dtypes too), on chunks of one device and of five, with int64
  byte columns and with the float64 ones a sub-byte width promotes to;
  ``ops.pack`` lays out what the kernel reads, per pair;
* ``matmul_perf_batch_multi(..., device="cpu")`` gives the JAX mapper's
  winners (compared exactly), latencies, traffic and candidate counts, with
  pruning on, off and as its own oracle, and ``matmul_perf_reference`` is
  the JAX dense oracle's;
* the disk layer returns what it stored, keyed per table device;
* ``device="cuda"`` raises where there is no card, before any table runs.

Bit-equal is expected everywhere; no column needs a tolerance. The kernel
itself runs only on the card: ``tests/test_torch_cuda.py`` (marked
``cuda``) and ``chip_smoke.py``'s study phase hold it to these versions.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import hardware as jax_hw
from repro.core import mapper as jax_mapper
from repro.core import result_cache as jax_cache
from repro_torch.core import evaluator as t_evaluator
from repro_torch.core import hardware as t_hw
from repro_torch.core import mapper as t_mapper
from repro_torch.core import result_cache as t_cache
from repro_torch.core import study as t_study
from repro_torch.kernels.mapper_tables import kernel as t_kernel
from repro_torch.kernels.mapper_tables import ops as t_ops
from repro_torch.kernels.mapper_tables.ref import tables_ref

# (m, k, n, batch, bytes_a, bytes_b, bytes_out, bytes_acc, b_shared, mac_scale)
INT_SHAPES = [(64, 4096, 4096, 1, 2, 2, 2, 2, False, 1.0),
              (1, 4096, 11008, 1, 2, 1, 2, 4, False, 2.0),
              (512, 128, 512, 32, 2, 2, 2, 4, True, 1.0),
              (7, 333, 1000, 3, 1, 1, 1, 4, False, 2.0),
              (4096, 12288, 2048, 1, 2, 2, 2, 2, False, 1.0)]
SUB_BYTE_SHAPES = [(1, 4096, 11008, 1, 2, 0.5, 2, 4, False, 2.0),
                   (2048, 2048, 6144, 1, 0.5, 0.5, 0.5, 4, False, 4.0),
                   (96, 128, 4096, 96, 2, 0.5, 2, 2, True, 1.0),
                   (3, 5, 7, 2, 1, 0.5, 2, 0.5, False, 1.0)]
PRESETS = ["nvidia_a100", "nvidia_h100", "google_tpu_v5e", "amd_mi210", "design_C"]


def to_jax(obj):
    """The JAX package's hardware value equal to a port one (its dataclasses
    have the same names and fields), for presets only the port has."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(jax_hw, type(obj).__name__)
        return cls(**{f.name: to_jax(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    return obj


def device_pair(name):
    dev = t_hw.compute_design("C") if name == "design_C" else getattr(t_hw, name)()
    return dev, to_jax(dev)


def gathered(devs, shapes, mod):
    rows = [mod._candidate_rows(d, s) for d, s in zip(devs, shapes)]
    return mod._gather_chunk(devs, shapes, [r[0] for r in rows], [r[1] for r in rows])


def chunks(preset, widths):
    """(port chunk, JAX chunk) of one preset's shapes, or of all five
    compute designs A-E (per-row device columns) for preset 'designs'."""
    shapes = INT_SHAPES if widths == "int" else SUB_BYTE_SHAPES
    if preset == "designs":
        tdevs = [t_hw.compute_design(c) for c in "ABCDE" for _ in shapes]
        shapes = shapes * 5
    else:
        tdevs = [device_pair(preset)[0]] * len(shapes)
    jdevs = [to_jax(d) for d in tdevs]
    return gathered(tdevs, shapes, t_mapper), gathered(jdevs, shapes, jax_mapper)


def same_array(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def test_h100_converts_to_an_equal_jax_device():
    tdev, jdev = device_pair("nvidia_h100")
    assert dataclasses.asdict(tdev) == dataclasses.asdict(jdev)
    assert jdev.memory_bandwidth == tdev.memory_bandwidth


@pytest.mark.parametrize("widths", ["int", "sub_byte"])
@pytest.mark.parametrize("preset", PRESETS + ["designs"])
def test_gather_chunk_equals_jax(preset, widths):
    got, want = chunks(preset, widths)
    assert got.keys() == want.keys()
    for k in want:
        if k == "counts":
            assert got[k] == want[k]
        elif np.ndim(want[k]) == 0:        # a collapsed device scalar
            assert type(got[k]) is type(want[k]) and got[k] == want[k], k
        else:
            same_array(got[k], want[k], k)
    if widths == "sub_byte":
        assert want["bytes_b"].dtype == np.float64


@pytest.mark.parametrize("widths", ["int", "sub_byte"])
@pytest.mark.parametrize("preset", PRESETS + ["designs"])
def test_tables_equal_jax_bit_for_bit(preset, widths):
    """numpy `_tables`, the plain PyTorch version and the JAX package's
    numpy tables, every output column as bytes."""
    g, jg = chunks(preset, widths)
    want = jax_mapper._chunk_tables_numpy(jg)
    plain = {k: v.numpy() for k, v in tables_ref(t_ops.to_tensors(g, "cpu")).items()}
    for name, got in (("numpy", t_mapper._tables(g)), ("ref.py", plain)):
        assert got.keys() == want.keys()
        for k in want:
            same_array(got[k], want[k], (name, k))
    assert np.isfinite(want["totals"]).any()
    if preset == "designs":          # some pipeline options do not fit
        assert np.isinf(want["totals"]).any()


@pytest.mark.parametrize("preset", ["designs", "google_tpu_v5e"])
def test_pack_lays_out_each_pair(preset):
    """What the kernel reads: the six tile columns, the flags, and one row of
    scalars a pair read at its first row (device scalars not densified)."""
    g, _ = chunks(preset, "sub_byte")
    buf, n, pairs, mask = t_ops.pack(g)
    assert (n, pairs) == (g["tm"].size, len(g["counts"]))
    assert mask == 0b1111                         # all four promoted here
    assert t_ops.pack(chunks(preset, "int")[0])[3] == 0
    cols, p_ok, offs, pint, pflt, pbytes, m = t_ops.device_args(
        torch.from_numpy(buf), n, pairs, mask)
    assert m == mask and cols.shape == (6, n) and p_ok.shape == (n, 4)
    for i, name in enumerate(("tm", "tk", "tn", "sm", "sk", "sn")):
        assert np.array_equal(cols[i].numpy(), g[name])
    assert np.array_equal(p_ok.numpy().astype(bool), g["p_ok"])
    assert np.array_equal(offs.numpy(), g["offs"])
    row = np.repeat(np.arange(pairs), g["counts"])
    for i, name in enumerate(t_kernel.PAIR_INTS):
        assert np.array_equal(np.broadcast_to(g[name], (n,)), pint[:, i].numpy()[row]), name
    for i, name in enumerate(t_kernel.PAIR_FLOATS):
        assert np.array_equal(np.broadcast_to(g[name], (n,)), pflt[:, i].numpy()[row]), name
    for i, name in enumerate(t_kernel.WIDTHS):
        col = pbytes[:, i].numpy()[row]
        if mask >> i & 1:
            col = col.view(np.float64)
        assert np.array_equal(g[name], col), name


def test_pack_refuses_a_fractional_integer_column():
    g, _ = chunks("nvidia_a100", "int")
    g = dict(g, gb_bw_cyc=5120.5)
    with pytest.raises(TypeError, match="gb_bw_cyc"):
        t_ops.pack(g)


def test_empty_chunk_has_numpy_dtypes():
    g, jg = chunks("nvidia_a100", "int")
    keep = np.zeros(g["tm"].size, bool)
    empty = {k: (v[keep] if isinstance(v, np.ndarray) and v.shape[:1] == keep.shape else v)
             for k, v in g.items()}
    want = t_mapper._tables(empty)
    got = t_ops.chunk_tables(empty)      # no launch for no rows
    for k in want:
        same_array(got[k], want[k], k)


def pairs_both(presets, shapes):
    tpairs, jpairs = [], []
    for p in presets:
        tdev, jdev = device_pair(p)
        tpairs += [(tdev, s) for s in shapes]
        jpairs += [(jdev, s) for s in shapes]
    return tpairs, jpairs


def same_result(a, b):
    assert dataclasses.astuple(a.mapping) == dataclasses.astuple(b.mapping)
    assert a.latency == b.latency
    assert (a.flops, a.main_memory_bytes, a.candidates_searched) == \
        (b.flops, b.main_memory_bytes, b.candidates_searched)


@pytest.mark.parametrize("prune", ["on", "off", "oracle"])
def test_batch_multi_equals_jax(prune):
    """Winners, latencies, traffic and candidate counts of a multi-device,
    multi-width stacked search, with the disk layers off and memos cold."""
    tpairs, jpairs = pairs_both(PRESETS, INT_SHAPES + SUB_BYTE_SHAPES)
    tprev, jprev = t_mapper.set_mapper_prune(prune), jax_mapper.set_mapper_prune(prune)
    try:
        with t_cache.disabled(), jax_cache.disabled():
            t_mapper.clear_matmul_cache()
            jax_mapper.clear_matmul_cache()
            got = t_mapper.matmul_perf_batch_multi(tpairs, device="cpu")
            want = jax_mapper.matmul_perf_batch_multi(jpairs)
    finally:
        t_mapper.set_mapper_prune(tprev)
        jax_mapper.set_mapper_prune(jprev)
    assert len(got) == len(want) == len(tpairs)
    for a, b in zip(got, want):
        same_result(a, b)
    for (dev, shape), r in zip(tpairs, got):     # the per-shape path agrees
        same_result(t_mapper.matmul_perf(dev, *shape), r)


@pytest.mark.parametrize("shape", [(64, 256, 512), (5, 300, 77, 3, 1, 0.5, 2, 4, True, 2.0)])
def test_dense_reference_equals_jax(shape):
    tdev, jdev = device_pair("nvidia_a100")
    same_result(t_mapper.matmul_perf_reference(tdev, *shape),
                jax_mapper.matmul_perf_reference(jdev, *shape))
    same_result(t_mapper.matmul_perf_reference(tdev, *shape),
                t_mapper.matmul_perf(tdev, *shape))


def test_disk_layer_round_trip(tmp_path):
    tpairs, _ = pairs_both(["nvidia_h100", "design_C"], INT_SHAPES[:3] + SUB_BYTE_SHAPES[:2])
    with t_cache.overridden(root=tmp_path, enabled=True):
        t_mapper.clear_matmul_cache()
        stats = t_mapper.MapperCacheStats()
        cold = t_mapper.matmul_perf_batch_multi(tpairs, device="cpu")
        assert stats.misses == len(tpairs) and stats.disk_hits == 0
        assert len(t_mapper._disk_cache()) == len(tpairs)
        assert (tmp_path / t_mapper.NAMESPACE).is_dir()
        t_mapper.clear_matmul_cache()                 # a fresh process's memo
        warm = t_mapper.matmul_perf_batch_multi(tpairs, device="cpu")
        assert stats.disk_hits == len(tpairs) and stats.misses == len(tpairs)
    for a, b in zip(cold, warm):
        same_result(a, b)
    dev, shape = tpairs[0]
    assert t_mapper._pair_key(dev, shape, "cpu") != t_mapper._pair_key(dev, shape, "cuda")
    t_mapper.clear_matmul_cache()


def test_cuda_raises_without_a_card(monkeypatch):
    """With no card, device='cuda' raises at every entry point, before any
    table runs, and nothing falls back to numpy."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tpairs, _ = pairs_both(["nvidia_a100"], INT_SHAPES[:1])
    t_mapper.clear_matmul_cache()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_mapper.matmul_perf_batch_multi(tpairs)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_mapper.matmul_perf_batch(tpairs[0][0], [tpairs[0][1]], device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_evaluator.Evaluator(t_hw.dgx_a100(2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_study.Study(cases=[], device="cuda")
    with pytest.raises(ValueError, match="unknown mapper table device"):
        t_mapper.matmul_perf_batch_multi(tpairs, device="tpu")
