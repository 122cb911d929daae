"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's: the same cells, inputs, parameters and caches; every kernel
wrapper traced on fake tensors; a full-width rank program traced; and the
trace held to a real world of gloo ranks running the same program.

* ``SHAPES``, ``shape_applicable`` and ``dryrun_cells`` equal JAX's;
  ``input_specs`` and ``abstract_params`` (leaf for leaf through
  ``models.bridge``'s names) equal JAX's for every arch; ``abstract_cache``
  holds JAX's bytes by kind. The replicated-kv rule: qwen3-1.7b at model
  16 (8 kv heads) caches, per rank, the one whole kv head its q head reads,
  128 channels, where the JAX ``cache_spec`` gives a device 64 of the fused
  1024: the port's per-rank cache is twice JAX's.
* Every wrapper of ``kernels.KERNELS`` under ``FakeTensorMode``, on fake
  CUDA tensors and on fake CPU tensors standing for the card
  (``device.card_standin``), returns the plain version's shapes and dtypes
  on the same inputs, counts one launch under the name of the route the
  real call takes and its operations, and never reaches ``_build.load``.
* qwen3-1.7b ``decode_32k`` on the single mesh, traced at full width: rank
  0's parameters are the sum of its ``leaf_spec`` slices, and the trace's
  argument bytes are those, the cache's and the inputs'.
* rwkv6-7b ``long_500k`` on the single mesh, traced at full width: its
  one row replicated over data, rank 0's parameters the sum of its
  ``leaf_spec`` slices, its cache 4 wkv heads' fp32 state a layer and the
  whole token shifts. The token shifts are the model axis's size times
  JAX's per device (ROADMAP C18), the state JAX's.
* A refused arch records ``ok: false`` with its error.
* Rank 0's trace on an abstract (2, 2) mesh (the CPU path, ``--device
  cpu``) records the same launches, collectives (kind, count, bytes), FLOPs
  and peak bytes as rank 0 of a real world of 4 gloo ranks running the same
  smoke programs (train with two microbatches, prefill, decode; qwen3 and
  rwkv6), and a batch of one decoded on rows replicated over data, with no
  collective over data.
"""
import json

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro import models as jmodels
from repro_torch import configs as tconfigs
from repro_torch import kernels as K
from repro_torch import models as tmodels
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import card_standin
from repro_torch.distributed.sharding import cache_spec, jax_leaf, leaf_spec, plan
from repro_torch.kernels import _build
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh

import _torch_dist

ARCHS = sorted(tconfigs.ARCHS) + sorted(tconfigs.EXTRA_ARCHS)


def dtype_name(d) -> str:
    return str(d).replace("torch.", "")


def test_shapes_and_cells_equal_jax():
    assert {n: (s.name, s.kind, s.seq_len, s.global_batch, s.tokens)
            for n, s in tconfigs.SHAPES.items()} == \
        {n: (s.name, s.kind, s.seq_len, s.global_batch, s.tokens)
         for n, s in jconfigs.SHAPES.items()}
    assert tconfigs.dryrun_cells() == jconfigs.dryrun_cells()
    for arch in ARCHS:
        for name in tconfigs.SHAPES:
            assert tconfigs.shape_applicable(tconfigs.get_config(arch), tconfigs.SHAPES[name]) \
                == jconfigs.shape_applicable(jconfigs.get_config(arch), jconfigs.SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_jax(arch):
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for name in tconfigs.SHAPES:
        got = tmodels.input_specs(cfg, tconfigs.SHAPES[name])
        want = jmodels.input_specs(jcfg, jconfigs.SHAPES[name])
        assert {k: (tuple(s), dtype_name(d)) for k, (s, d) in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}, name


def jax_leaves(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = leaf
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_jax_leaf_for_leaf(arch):
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    got = {}
    for name, (shape, dtype) in tmodels.abstract_params(cfg).items():
        path, jshape, stacked = jax_leaf(cfg, name, shape)
        got.setdefault(path, []).append((jshape, dtype_name(dtype)))
    want = {p: (tuple(v.shape), str(v.dtype)) for p, v in
            jax_leaves(jmodels.abstract_params(jcfg)).items()}
    assert set(got) == set(want)
    for path, seen in got.items():
        # a stacked leaf: one port leaf a unit, each of the stack's shape
        assert set(seen) == {want[path]}, path
        assert len(seen) == (want[path][0][0] if path.startswith(("units/", "enc/layers/"))
                             else 1), path


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_cache_bytes_by_kind_equal_jax(arch):
    """The cache of 2 sequences of 80 slots: the bytes of each kind (k, v,
    xk, xv, h, conv, state, sx_t, sx_c, pos) as in the JAX cache; the JAX
    cache's ``enc_out`` (read by no decode step) the port does not keep."""
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    got = {}
    for name, (shape, dtype) in tmodels.abstract_cache(cfg, 2, 80).items():
        got[name] = got.get(name, 0) + int(np.prod(shape)) * torch.empty(
            (), dtype=dtype).element_size()
    want = {}
    for path, leaf in jax_leaves(jmodels.abstract_cache(jcfg, 2, 80)).items():
        kind = path.split("/")[-1]
        want[kind] = want.get(kind, 0) + leaf.size * leaf.dtype.itemsize
    want.pop("enc_out", None)
    assert got == want


def test_replicated_kv_cache_is_twice_jax_per_rank():
    """qwen3-1.7b decode_32k on the single mesh, rank 0: the port caches one
    whole kv head (128 channels) where JAX's "channel" cache_spec gives the
    device 64 of the 1024 fused channels."""
    cfg = tconfigs.get_config("qwen3-1.7b")
    shape = tconfigs.SHAPES["decode_32k"]
    mesh = Mesh.abstract((16, 16), ("data", "model"))
    par = plan(cfg, mesh)
    assert par.kv_heads == (0, 1) and par.cache_cfg.n_kv_heads == 1
    rows = shape.global_batch // 16
    port = sum(int(np.prod(s)) * 2 for n, (s, _) in tmodels.abstract_cache(
        par.cache_cfg, rows, shape.seq_len).items() if n in ("k", "v"))
    jcache = jax_leaves(jmodels.abstract_cache(jconfigs.get_config("qwen3-1.7b"),
                                               shape.global_batch, shape.seq_len))
    jax_bytes = 0
    for path, leaf in jcache.items():
        if path.split("/")[-1] not in ("k", "v"):
            continue
        spec = cache_spec(mesh, path, leaf.shape, shape.global_batch, "channel")
        ways = int(np.prod([mesh.axis_size(a) for a in spec if a]))
        jax_bytes += leaf.size * leaf.dtype.itemsize // ways
    assert port == 2 * jax_bytes


# ---------------------------------------------------------------------------
# every kernel wrapper on fake tensors
# ---------------------------------------------------------------------------

def _wrapper_cases():
    """{kernel name: (make(rnd) -> (args, kwargs), plain(args, kwargs) ->
    outputs)} at small shapes each wrapper's own route takes."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref
    from repro_torch.kernels.gelu import ref as G
    from repro_torch.kernels.matmul.ref import dequant_matmul_ref, matmul_ref, matmul_reduce_ref
    from repro_torch.kernels.rglru.kernel import segments as rglru_segments
    from repro_torch.kernels.rglru.ref import rglru_bwd_ref, rglru_ref
    from repro_torch.kernels.rmsnorm import ref as N
    from repro_torch.kernels.wkv.kernel import segments as wkv_segments
    from repro_torch.kernels.wkv.ref import wkv_bwd_ref, wkv_ref
    bf, f32 = torch.bfloat16, torch.float32

    def t(rnd, shape, dtype=bf):
        return torch.from_numpy(rnd.standard_normal(shape).astype(np.float32)).to(dtype)

    def qkv(rnd, dtype, D=64):
        return (t(rnd, (1, 4, 64, D), dtype), t(rnd, (1, 2, 64, D), dtype),
                t(rnd, (1, 2, 64, D), dtype))

    def dec(rnd, dtype, G):
        return (t(rnd, (2, 2, G, 64), dtype), t(rnd, (2, 32, 2, 64), dtype),
                t(rnd, (2, 32, 2, 64), dtype), torch.tensor([5, 32], dtype=torch.int32))

    def wkv_in(rnd, T):
        r, k, v = (t(rnd, (1, T, 2, 64), f32) for _ in range(3))
        return r, k, v, torch.rand(1, T, 2, 64), t(rnd, (2, 64), f32)

    def rg_in(rnd, T):
        return (t(rnd, (2, T, 16)), t(rnd, (2, T, 16), f32), t(rnd, (2, T, 16), f32),
                t(rnd, (16,), f32), t(rnd, (2, T, 16)))

    def int8(rnd):
        a = torch.randint(-127, 128, (64, 128), dtype=torch.int8)
        b = torch.randint(-127, 128, (256, 128), dtype=torch.int8).t()
        return a, b, torch.rand(64, 1), torch.rand(1, 256)

    def bwd(rnd):
        q, k, v = qkv(rnd, bf)
        o = attention_ref(q, k, v)
        return q, k, v, o, t(rnd, o.shape)

    def mapper(rnd):
        from repro_torch.kernels.mapper_tables.kernel import PAIR_FLOATS, PAIR_INTS, WIDTHS
        rows, pairs = 5, 2
        return ((torch.ones(6, rows, dtype=torch.int64), torch.ones(rows, 4, dtype=torch.bool),
                 torch.tensor([0, 2, 5]), torch.ones(pairs, len(PAIR_INTS), dtype=torch.int64),
                 torch.ones(pairs, len(PAIR_FLOATS), dtype=torch.float64),
                 torch.ones(pairs, len(WIDTHS), dtype=torch.int64), 0), {})

    def mapper_plain(a, kw):
        from repro_torch.kernels.mapper_tables.kernel import OUT_BYTES_PER_ROW
        return torch.empty(a[0].shape[1] * OUT_BYTES_PER_ROW, dtype=torch.uint8)

    steps = {"wkv": 64, "rglru": 4}
    return {
        "rmsnorm": (lambda r: ((t(r, (8, 128)), t(r, (128,), f32)), {}),
                    lambda a, kw: N.rmsnorm_ref(*a)),
        "layernorm": (lambda r: ((t(r, (8, 128)), t(r, (128,), f32), t(r, (128,), f32)), {}),
                      lambda a, kw: N.layernorm_ref(*a)),
        "gelu": (lambda r: ((t(r, (8, 256)),), {}), lambda a, kw: G.gelu_ref(*a)),
        "gelu_mul": (lambda r: ((t(r, (8, 256)), t(r, (8, 256))), {}),
                     lambda a, kw: G.gelu_mul_ref(*a)),
        "silu_mul": (lambda r: ((t(r, (8, 256)), t(r, (8, 256))), {}),
                     lambda a, kw: G.silu_mul_ref(*a)),
        "flash_attention": (lambda r: (qkv(r, f32), {"causal": True}),
                            lambda a, kw: attention_ref(*a, **kw)),
        "flash_attention_wgmma": (lambda r: (qkv(r, bf), {"causal": True}),
                                  lambda a, kw: attention_ref(*a, **kw)),
        "decode_attention": (lambda r: (dec(r, f32, 2), {}),
                             lambda a, kw: decode_attention_ref(*a)),
        "decode_attention_chunked": (lambda r: (dec(r, bf, 1), {}),
                                     lambda a, kw: decode_attention_ref(*a)),
        "decode_attention_mma": (lambda r: (dec(r, bf, 4), {}),
                                 lambda a, kw: decode_attention_ref(*a)),
        "wkv": (lambda r: (wkv_in(r, 1), {}), lambda a, kw: wkv_ref(*a)),
        "wkv_chunked": (lambda r: (wkv_in(r, 16), {}), lambda a, kw: wkv_ref(*a)),
        "rglru": (lambda r: (rg_in(r, 1), {}), lambda a, kw: rglru_ref(*a)),
        "rglru_chunked": (lambda r: (rg_in(r, 16), {}), lambda a, kw: rglru_ref(*a)),
        "matmul": (lambda r: ((t(r, (64, 64)), t(r, (64, 128))), {"bm": 64, "bk": 32,
                                                                   "bn": 64}),
                   lambda a, kw: matmul_ref(*a)),
        "matmul_wgmma": (lambda r: ((t(r, (128, 64)), t(r, (64, 256))), {}),
                         lambda a, kw: matmul_ref(*a)),
        "matmul_f32_tma": (lambda r: ((t(r, (256, 32), f32), t(r, (32, 128), f32)), {}),
                           lambda a, kw: matmul_ref(*a)),
        "matmul_reduce": (lambda r: ((t(r, (3, 16, 32), f32), torch.empty(16, 32, dtype=bf)),
                                     {}),
                          lambda a, kw: matmul_reduce_ref(a[0], a[1].dtype)),
        "matmul_int8": (lambda r: (int8(r), {"bm": 64, "bk": 64, "bn": 64}),
                        lambda a, kw: dequant_matmul_ref(*a)),
        "matmul_int8_wgmma": (lambda r: (int8(r), {}), lambda a, kw: dequant_matmul_ref(*a)),
        "flash_attention_bwd": (lambda r: (bwd(r), {}), lambda a, kw: attention_bwd_ref(*a)),
        "flash_attention_bwd_wgmma": (
            lambda r: ((*bwd(r), torch.zeros(1, 4, 64)), {}),
            lambda a, kw: attention_bwd_ref(*a[:5])),
        "rmsnorm_bwd": (lambda r: ((t(r, (8, 128)), t(r, (128,), f32), t(r, (8, 128))), {}),
                        lambda a, kw: N.rmsnorm_bwd_ref(*a)),
        "silu_mul_bwd": (lambda r: ((t(r, (8, 256)), t(r, (8, 256)), t(r, (8, 256))), {}),
                         lambda a, kw: G.silu_mul_bwd_ref(*a)),
        "layernorm_bwd": (lambda r: ((t(r, (64, 128)), t(r, (128,), f32), t(r, (64, 128))), {}),
                          lambda a, kw: N.layernorm_bwd_ref(*a)),
        "layernorm_bwd_triton": (
            lambda r: ((t(r, (33, 2100)), t(r, (2100,), f32), t(r, (33, 2100))), {}),
            lambda a, kw: N.layernorm_bwd_ref(*a)),
        "gelu_bwd": (lambda r: ((t(r, (8, 256)), t(r, (8, 256))), {}),
                     lambda a, kw: G.gelu_bwd_ref(*a)),
        "gelu_mul_bwd": (lambda r: ((t(r, (8, 256)), t(r, (8, 256)), t(r, (8, 256))), {}),
                         lambda a, kw: G.gelu_mul_bwd_ref(*a)),
        "rglru_bwd": (
            lambda r: ((*rg_in(r, 16), torch.zeros(2, rglru_segments(16, steps["rglru"]), 16),
                        t(r, (2, 16, 16), f32)), {}),
            lambda a, kw: rglru_bwd_ref(*a[:5], None, a[6])),
        "wkv_bwd": (
            lambda r: ((*wkv_in(r, 16), torch.zeros(1, 2, wkv_segments(16), 64, 64),
                        t(r, (1, 16, 2, 64), f32)), {}),
            lambda a, kw: wkv_bwd_ref(*a[:5], None, a[6])),
        "mapper_tables": (mapper, mapper_plain),
    }


WRAPPER_CASES = _wrapper_cases()


def test_every_wrapper_has_a_case():
    assert set(WRAPPER_CASES) == set(K.KERNELS)


def _flat(out):
    out = out if isinstance(out, (tuple, list)) else (out,)
    return [(tuple(o.shape), o.dtype) if o is not None else None for o in out]


@pytest.mark.parametrize("standin", [False, True], ids=["fake-cuda", "fake-cpu-standin"])
@pytest.mark.parametrize("name", sorted(WRAPPER_CASES))
def test_wrapper_traces_its_route_on_fake_tensors(monkeypatch, name, standin):
    def refuse(*a, **kw):
        raise AssertionError("a traced wrapper reached _build.load")

    monkeypatch.setattr(_build, "load", refuse)
    make, plain = WRAPPER_CASES[name]
    args, kwargs = make(np.random.default_rng(0))
    want = _flat(plain(args, kwargs))
    K.reset_launches()
    with FakeTensorMode():
        dev = "cpu" if standin else "cuda"
        fake = [torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device=dev)
                if isinstance(a, torch.Tensor) else a for a in args]
        with card_standin() if standin else torch.no_grad():
            got = _flat(K.KERNELS[name](*fake, **kwargs))
    assert got == want
    launched = {n: c for n, c in K.launches().items() if c}
    assert launched == {name: 1}, launched
    assert (K.ops()[name] > 0) == (name != "mapper_tables")


@pytest.mark.parametrize("case", ["fwd", "fwd-state0", "fwd-lengths", "bwd", "bwd-state0-dstate"])
def test_plain_wkv_loop_on_fake_tensors_holds_the_whole_loops_bytes(monkeypatch, case):
    """The plain wkv loops on fake tensors run ``TRACED_STEPS`` steps (the
    CPU program's trace, ``--device cpu``): the storages they hold at their
    peak and at their end, and their outputs' shapes, are those of every
    step run."""
    from repro_torch.kernels.wkv import ref as W
    from repro_torch.launch.analysis import LiveBytes
    B, T, H, N = 2, 9, 2, 4
    state0 = "state0" in case

    def run(steps):
        monkeypatch.setattr(W, "TRACED_STEPS", steps)
        with FakeTensorMode():
            r, k, v, w, dout = (torch.empty((B, T, H, N)) for _ in range(5))
            u = torch.empty((H, N))
            s0 = torch.empty((B, H, N, N)) if state0 else None
            entry = [a for a in (r, k, v, w, dout, u, s0) if a is not None]
            with LiveBytes(entry) as live:
                if case.startswith("bwd"):
                    dstate = torch.empty((B, H, N, N)) if "dstate" in case else None
                    out = W.wkv_bwd_ref(r, k, v, w, u, s0, dout, dstate)
                else:
                    lengths = torch.tensor([5, 9], dtype=torch.int32) \
                        if "lengths" in case else None
                    out = W.wkv_ref(r, k, v, w, u, s0, lengths)
                held = live.held([o for o in out if o is not None])
            return live.peak, held, _flat(out)

    assert run(W.TRACED_STEPS) == run(T)
    assert W._steps(torch.empty((B, T, H, N)), T) == T


# ---------------------------------------------------------------------------
# rank programs
# ---------------------------------------------------------------------------

def test_full_width_decode_trace_holds_rank_shards():
    cfg = tconfigs.get_config("qwen3-1.7b")
    shape = tconfigs.SHAPES["decode_32k"]
    mesh = Mesh.abstract((16, 16), ("data", "model"))
    want = 0
    for name, (s, dtype) in tmodels.abstract_params(cfg).items():
        spec = leaf_spec(mesh, cfg, name, s)
        n = int(np.prod(s)) // int(np.prod([mesh.axis_size(a) for a in spec if a]))
        want += n * torch.empty((), dtype=dtype).element_size()
    with FakeTensorMode(), card_standin():
        prog = dryrun.RankProgram(cfg, shape, Mesh.abstract((16, 16), ("data", "model")), "cpu")
        params = sum(p.numel() * p.element_size() for p in prog.model.parameters())
        rest = sum(t.numel() * t.element_size() for t in [*prog.state.values(),
                                                          *prog.inputs.values()])
    assert params == want
    res = dryrun.trace(cfg, shape, "single")
    assert res["memory"]["argument_size_in_bytes"] == params + rest
    assert res["kernels"] == {"rmsnorm": 4 * 28 + 1, "silu_mul": 28,
                              "decode_attention_chunked": 28}
    # the embedding, then attention and MLP of each layer: g over model
    assert res["collectives"] == {"bytes": res["collectives"]["bytes"], "count": 1 + 2 * 28,
                                  "by_kind": {"all-reduce": res["collectives"]["bytes"]}}


def _cache_bytes_by_kind(cache: dict) -> dict:
    return {n: int(np.prod(s)) * torch.empty((), dtype=d).element_size()
            for n, (s, d) in cache.items()}


def test_full_width_rwkv6_long_500k_trace_holds_rank_shards():
    cfg = tconfigs.get_config("rwkv6-7b")
    shape = tconfigs.SHAPES["long_500k"]
    mesh = Mesh.abstract((16, 16), ("data", "model"))
    want = 0
    for name, (s, dtype) in tmodels.abstract_params(cfg).items():
        spec = leaf_spec(mesh, cfg, name, s)
        n = int(np.prod(s)) // int(np.prod([mesh.axis_size(a) for a in spec if a]))
        want += n * torch.empty((), dtype=dtype).element_size()
    with FakeTensorMode(), card_standin():
        prog = dryrun.RankProgram(cfg, shape, mesh, "cpu")
        params = sum(p.numel() * p.element_size() for p in prog.model.parameters())
        cache = {n: (tuple(t.shape), t.dtype) for n, t in prog.cache.items()}
        rest = sum(t.numel() * t.element_size() for t in [*prog.state.values(),
                                                          *prog.inputs.values()])
    assert params == want and prog.par.batch_axes == ()
    L, d = cfg.n_layers, cfg.d_model
    assert cache == {"state": ((L, 1, 4, 64, 64), torch.float32),
                     "sx_t": ((L, 1, d), torch.bfloat16), "sx_c": ((L, 1, d), torch.bfloat16),
                     "pos": ((1,), torch.int32)}
    res = dryrun.trace(cfg, shape, "single")
    assert res["memory"]["argument_size_in_bytes"] == params + rest
    # two LayerNorms a layer and the final one, one wkv decode step a layer
    assert res["kernels"] == {"layernorm": 2 * L + 1, "wkv": L}
    # the embedding, then the time and the channel mix of each layer: g
    assert res["collectives"]["count"] == 1 + 2 * L
    assert res["collectives_by_axis"] == {"model": res["collectives"]["bytes"]}


def test_rwkv6_token_shifts_are_model_times_jax_per_rank():
    """rwkv6-7b decode_32k on the single mesh, rank 0 (ROADMAP C18): the
    port keeps the token shifts whole on every model rank, where JAX's
    ``cache_spec`` shards their d over model, so a rank's ``sx_t`` and
    ``sx_c`` bytes are 16 times JAX's per device; its wkv state, 4 of the
    64 heads, is JAX's per device."""
    cfg = tconfigs.get_config("rwkv6-7b")
    shape = tconfigs.SHAPES["decode_32k"]
    mesh = Mesh.abstract((16, 16), ("data", "model"))
    par = plan(cfg, mesh)
    rows = shape.global_batch // 16
    port = _cache_bytes_by_kind({n: (tuple(t.shape), t.dtype) for n, t in par.init_cache(
        rows, shape.seq_len, "meta").items()})
    jcache = jax_leaves(jmodels.abstract_cache(jconfigs.get_config("rwkv6-7b"),
                                               shape.global_batch, shape.seq_len))
    jax_bytes = {}
    for path, leaf in jcache.items():
        kind = path.split("/")[-1]
        spec = cache_spec(mesh, path, leaf.shape, shape.global_batch, "channel")
        ways = int(np.prod([mesh.axis_size(a) for a in spec if a]))
        jax_bytes[kind] = jax_bytes.get(kind, 0) + leaf.size * leaf.dtype.itemsize // ways
    assert port["state"] == jax_bytes["state"]
    for kind in ("sx_t", "sx_c"):
        assert port[kind] == 16 * jax_bytes[kind], kind


@pytest.mark.parametrize("arch,shape,word", [("grok-1-314b", "decode_32k", "A12b"),
                                             ("llama-3.2-vision-11b", "train_4k", "A12b"),
                                             ("qwen2-0.5b", "prefill_32k", "n_heads = 14")])
def test_refused_cell_records_its_error(tmp_path, arch, shape, word):
    rec = dryrun.run_cell(arch, shape, "single", out_dir=str(tmp_path), verbose=False)
    assert rec["ok"] is False and word in rec["error"]
    assert json.load(open(tmp_path / f"{arch}__{shape}__single.json"))["ok"] is False


def test_rank0_is_the_largest_under_expert_padding():
    granite = tconfigs.get_config("granite-moe-3b-a800m")    # 40 experts over 16
    assert dryrun.rank0_largest(granite, Mesh.abstract((16, 16), ("data", "model")))


SMOKE = tconfigs.smoke_config(tconfigs.get_config("qwen3-1.7b"))
RWKV = tconfigs.smoke_config(tconfigs.get_config("rwkv6-7b"))
PROGRAMS = {"train": (SMOKE, ShapeConfig("smoke_train", "train", 16, 8), 2),
            "prefill": (SMOKE, ShapeConfig("smoke_prefill", "prefill", 16, 4), 1),
            "decode": (SMOKE, ShapeConfig("smoke_decode", "decode", 32, 4), 1),
            "rwkv6_train": (RWKV, ShapeConfig("smoke_train", "train", 16, 8), 2),
            "rwkv6_prefill": (RWKV, ShapeConfig("smoke_prefill", "prefill", 16, 4), 1),
            "rwkv6_decode": (RWKV, ShapeConfig("smoke_decode", "decode", 32, 4), 1),
            # one row on data 2: replicated over data
            "decode_b1": (SMOKE, ShapeConfig("smoke_decode", "decode", 32, 1), 1),
            "rwkv6_decode_b1": (RWKV, ShapeConfig("smoke_decode", "decode", 32, 1), 1)}


@pytest.fixture(scope="module")
def world_programs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_world")
    torch.save(PROGRAMS, tmp / "cases.pt")
    _torch_dist.run_world(tmp, 4, "rank_program_worker", str(tmp / "cases.pt"), str(tmp))
    return tmp


@pytest.mark.parametrize("kind", list(PROGRAMS))
def test_trace_records_what_a_gloo_world_runs(world_programs, kind):
    cfg, shape, microbatches = PROGRAMS[kind]
    real = torch.load(world_programs / f"program_{kind}.pt", weights_only=False)
    traced = dryrun.trace(cfg, shape, ((2, 2), ("data", "model")), "cpu", microbatches)
    if shape.global_batch == 1:
        assert set(traced["collectives_by_axis"]) == {"model"}
    assert traced["kernels"] == real["kernels"]
    assert traced["collectives"] == real["collectives"]
    assert traced["cost"] == real["cost"]
    assert traced["collectives"]["count"] > 0 and traced["cost"]["flops"] > 0
    assert traced["memory"]["total_bytes"] == real["memory"]["total_bytes"]
