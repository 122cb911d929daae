"""The port's sharding rules, meshes and ``remesh`` against the JAX
package's (``repro.distributed.sharding``, ``repro.launch.mesh``,
``repro.distributed.fault_tolerance.remesh``), and the execution of a spec
on local shards.

The rules are pure functions of a mesh's shape: the JAX side runs on
``_fake_mesh``-style meshes (one device repeated, as
``tests/test_sharding.py`` builds them), the port's on ``Mesh.abstract``.
Every leaf of every one of the eleven full configs (the port's leaf, the
JAX spec with the leading unit axis of a stacked layer dropped), every
cache leaf under each kv layout, and every batch size up to 48 are held
equal at (data, model) = (4, 2), (2, 16), (16, 16) and (pod, data, model) =
(2, 16, 16). The production and host meshes' shapes and axis names come
from a JAX subprocess with 512 forced host devices (once for the file).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from repro import models as jax_models
from repro.configs import get_config as jax_get_config
from repro.distributed import fault_tolerance as jft
from repro.distributed import sharding as jshd
from repro_torch.configs import ARCHS, EXTRA_ARCHS, get_config, smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault_tolerance import remesh_shape
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch.mesh import Mesh
from repro_torch.models.lm import LM, init_params

ALL_ARCHS = sorted(ARCHS) + sorted(EXTRA_ARCHS)
MESHES = (((4, 2), ("data", "model")), ((2, 16), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")))
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]
KV_MODES = ("channel", "sequence", "auto")


def fake_mesh(shape, axes):
    dev = jax.devices()[0]
    return JaxMesh(np.array([dev] * int(np.prod(shape))).reshape(shape), axes)


def jax_leaves(tree):
    """{path string: (JAX path, leaf)} of an abstract tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jshd._path_str(p): (p, leaf) for p, leaf in flat}


@pytest.fixture(scope="module")
def abstract():
    """Each arch's JAX abstract parameters and the port's leaves (name,
    shape) of its full config, built on the meta device."""
    out = {}
    for arch in ALL_ARCHS:
        jcfg = jax_get_config(arch)
        meta = LM(get_config(arch), None, "meta")
        out[arch] = (jcfg, jax_leaves(jax_models.abstract_params(jcfg)),
                     [(n, tuple(p.shape)) for n, p in meta.named_parameters()])
    return out


@pytest.mark.parametrize("mesh_shape,axes", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_zero_specs_equal_jax_leaf_for_leaf(abstract, arch, mesh_shape, axes):
    jcfg, jleaves, leaves = abstract[arch]
    cfg = get_config(arch)
    jmesh, mesh = fake_mesh(mesh_shape, axes), Mesh.abstract(mesh_shape, axes)
    jshd.set_model_config(jcfg)
    try:
        seen = set()
        for name, shape in leaves:
            path, jshape, stacked = shd.jax_leaf(cfg, name, shape)
            jpath, jleaf = jleaves[path]
            assert tuple(jleaf.shape) == jshape, name
            seen.add(path)
            lead = 1 if stacked else 0      # the JAX spec's unit axis
            want = tuple(jshd.param_spec(jmesh, jpath, jleaf))[lead:]
            assert shd.leaf_spec(mesh, cfg, name, shape) == want, (name, want)
            assert shd.param_spec(mesh, path, jshape, cfg)[lead:] == want, name
            want = tuple(jshd.zero_spec(jmesh, jpath, jleaf))[lead:]
            assert shd.zero_spec(mesh, path, jshape, cfg)[lead:] == want, (name, want)
        assert seen == set(jleaves)      # every JAX leaf is some port leaf's
    finally:
        jshd.set_model_config(None)


@pytest.mark.parametrize("mesh_shape,axes", MESHES, ids=MESH_IDS)
def test_batch_spec_and_data_shardings_equal_jax(mesh_shape, axes):
    jmesh, mesh = fake_mesh(mesh_shape, axes), Mesh.abstract(mesh_shape, axes)
    for batch in range(1, 49):
        assert shd.batch_spec(mesh, batch) == tuple(jshd.batch_spec(jmesh, batch)), batch
    for batch in (1, 2, 3, 4, 8, 16, 32, 48, 64, 256, 512, 1024):
        shapes = {"tokens": (batch, 128), "targets": (batch, 128), "mask": (batch, 128),
                  "frontend": (batch, 16, 64)}
        want = jshd.data_shardings(jmesh, {k: jax.ShapeDtypeStruct(s, np.float32)
                                           for k, s in shapes.items()})
        got = shd.data_shardings(mesh, shapes)
        assert got == {k: tuple(v.spec) for k, v in want.items()}, batch


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_specs_equal_jax_under_each_kv_layout(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    batch = 32
    cache = jax.eval_shape(lambda: jax_models.init_cache(jcfg, batch, 4096))
    leaves = {p: tuple(leaf.shape) for p, (_, leaf) in jax_leaves(cache).items()}
    assert leaves
    jshd.set_model_config(jcfg)
    try:
        for mesh_shape, axes in MESHES:
            jmesh, mesh = fake_mesh(mesh_shape, axes), Mesh.abstract(mesh_shape, axes)
            for mode in KV_MODES:
                want = {jshd._path_str(p): tuple(s.spec) for p, s in
                        jax.tree_util.tree_flatten_with_path(
                            jshd.cache_shardings(jmesh, cache, batch, mode))[0]}
                got = shd.cache_shardings(mesh, leaves, batch, mode, cfg)
                assert got == want, (mesh_shape, mode)
                if mode != "auto":
                    for path, (jpath, leaf) in jax_leaves(cache).items():
                        assert shd.cache_spec(mesh, path, leaf.shape, batch, mode) == tuple(
                            jshd.cache_spec(jmesh, jpath, leaf, batch, mode)), path
    finally:
        jshd.set_model_config(None)


@pytest.mark.parametrize("pods", (1, 2))
@pytest.mark.parametrize("model_parallel", (1, 2, 4))
def test_remesh_shape_equals_jax(model_parallel, pods):
    dev = jax.devices()[0]
    for n in range(1, 13):
        want = None
        try:
            want = tuple(jft.remesh([dev] * n, model_parallel, pods).shape.values())
        except Exception:      # a mesh with an empty axis: JAX builds none
            assert 0 in remesh_shape(n, model_parallel, pods), n
            continue
        assert remesh_shape(n, model_parallel, pods) == want, n


MESH_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    sys.path.insert(0, "src")
    from repro.launch.mesh import make_host_mesh, make_production_mesh
    out = {"production": [[list(m.devices.shape), list(m.axis_names)]
                          for m in (make_production_mesh(), make_production_mesh(multi_pod=True))],
           "host": [[list(m.devices.shape), list(m.axis_names)]
                    for m in (make_host_mesh(*a) for a in HOST)]}
    print("MESHES " + json.dumps(out))
""")
HOST = [(1, 1, 1), (4, 2, 1), (2, 16, 1), (16, 16, 1), (16, 16, 2), (2, 2, 2), (1, 4, 4)]


@pytest.fixture(scope="module")
def jax_meshes():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", MESH_SCRIPT.replace("HOST", repr(HOST))],
                       capture_output=True, text=True, cwd=root, env=env, timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("MESHES ")]
    assert line, r.stderr[-2000:]
    return json.loads(line[0][len("MESHES "):])


@pytest.mark.parametrize("multi_pod", (False, True))
def test_production_mesh_equals_jax_and_needs_its_ranks(jax_meshes, multi_pod):
    shape, axes = port_mesh.production_mesh_shape(multi_pod)
    assert [list(shape), list(axes)] == jax_meshes["production"][int(multi_pod)]
    with pytest.raises(ValueError, match=f"needs {int(np.prod(shape))} ranks.*world size is 1"):
        port_mesh.make_production_mesh(multi_pod=multi_pod)


@pytest.mark.parametrize("i", range(len(HOST)))
def test_host_mesh_shape_equals_jax(jax_meshes, i):
    shape, axes = port_mesh.host_mesh_shape(*HOST[i])
    assert [list(shape), list(axes)] == jax_meshes["host"][i]


# ---------------- executing a spec ----------------

def test_shard_and_abstract_mesh_index_in_row_major_order():
    """(pod, data, model) = (2, 2, 2): rank 5 is (1, 0, 1); a tuple of axes
    takes its first as the major one."""
    mesh = Mesh.abstract((2, 2, 2), ("pod", "data", "model"), rank=5)
    assert mesh.coords == {"pod": 1, "data": 0, "model": 1}
    assert mesh.index(("pod", "data")) == 2 and mesh.axis_size(("pod", "data")) == 4
    t = torch.arange(8 * 6).reshape(8, 6)
    assert torch.equal(shd.shard(t, (("pod", "data"), "model"), mesh), t[4:6, 3:6])
    assert torch.equal(shd.shard(t, (), mesh), t)


INIT_CASES = [(a, m) for a in ("qwen2-0.5b", "qwen3-1.7b", "granite-moe-3b-a800m",
                                "grok-1-314b", "rwkv6-7b", "whisper-tiny")
              for m in ((2, 1), (1, 2), (2, 2), (1, 4))
              if m[1] == 1 or (a, m[1]) not in (("whisper-tiny", 2), ("whisper-tiny", 4),
                                                ("rwkv6-7b", 4))]


@pytest.mark.parametrize("arch,mesh_shape", INIT_CASES)
def test_sharded_init_is_the_single_rank_models_slice(arch, mesh_shape):
    """Every rank's shard from ``init_sharded`` equals its slice of the
    single-rank model drawn from the same seed, leaf for leaf, bit for bit
    (whisper, which takes no model axis, at data 2 only; rwkv6's two smoke
    heads not over model 4)."""
    cfg = smoke_config(get_config(arch))
    whole = dict(init_params(cfg, seed=4, device="cpu").named_parameters())
    for rank in range(int(np.prod(mesh_shape))):
        mesh = Mesh.abstract(mesh_shape, ("data", "model"), rank=rank)
        model = shd.init_sharded(cfg, mesh, seed=4, device="cpu")
        par = model.par
        for n, p in model.named_parameters():
            assert torch.equal(p, shd.shard(whole[n], par.specs[n], mesh)), (rank, n)
        assert model.cfg.n_heads == cfg.n_heads // mesh_shape[1]


@pytest.mark.parametrize("arch,field", [("rwkv6-7b", None),
                                        ("recurrentgemma-2b", "block_pattern"),
                                        ("whisper-tiny", "cross_attention"),
                                        ("llama-3.2-vision-11b", "cross_attn_layers")])
def test_tensor_parallelism_of_the_recurrent_and_cross_models_names_a12b(arch, field):
    """Griffin and the cross-attending models refuse a model axis, naming
    A12b. RWKV6 (`field` None) plans at model 2: rank 1 runs the second of
    the smoke config's two wkv heads, its r/k/v/g projections'
    columns and its wo's rows, the shift mixes and the replicated time-mix
    leaves summed over model, and its decode cache holds that head's state
    and the whole token shifts."""
    cfg = smoke_config(get_config(arch))
    mesh = Mesh.abstract((1, 2), ("data", "model"), rank=1)
    if field is None:
        par = shd.plan(cfg, mesh)
        assert par.rwkv_heads == (1, 1) and par.rwkv_channels == (64, 128)
        assert par.local.d_model == cfg.d_model and par.local.n_heads == 0
        for n in ("wr", "wk", "wv", "wg"):
            assert par.specs[f"blocks.0.tmix.{n}"] == (None, "model")
        assert par.specs["blocks.0.tmix.wo"] == ("model", None)
        assert par.specs["blocks.0.cmix.w_up"] == (None, "model")
        assert par.specs["blocks.0.cmix.w_down"] == ("model", None)
        assert par.model_partial == {f"blocks.{i}.{n}" for i in range(cfg.n_layers) for n in (
            "tmix.mu", "tmix.w0", "tmix.w_lora_a", "tmix.w_lora_b", "tmix.u", "tmix.ln_x",
            "cmix.mu")}
        cache = par.init_cache(3, 8, "meta")
        assert tuple(cache["state"].shape) == (cfg.n_layers, 3, 1, 64, 64)
        assert tuple(cache["sx_t"].shape) == tuple(cache["sx_c"].shape) == (
            cfg.n_layers, 3, cfg.d_model)
    else:
        with pytest.raises(NotImplementedError, match=f"\\({field}\\) is ROADMAP A12b"):
            shd.plan(cfg, mesh)
    shd.plan(cfg, Mesh.abstract((2, 1), ("data", "model")))


@pytest.mark.parametrize("arch,model,dim,change", [
    ("qwen2-0.5b", 4, "n_heads", {}), ("qwen2-0.5b", 16, "n_heads", {}),
    ("qwen3-1.7b", 4, "d_ff", {"d_ff": 258}), ("qwen3-1.7b", 4, "q heads", {"n_kv_heads": 3,
                                                                          "n_heads": 12}),
    ("rwkv6-7b", 16, "rwkv heads", {"d_model": 4032}),
    ("rwkv6-7b", 4, "channel-mix width", {"d_model": 4100, "rwkv_head_dim": 1025})])
def test_heads_that_do_not_divide_the_model_axis_raise_naming_the_dim(arch, model, dim,
                                                                      change):
    """qwen2-0.5b's 14 heads split 3.5 a rank at model 4 (JAX shards wq's
    896 channels all the same, and pays in communication); local shards
    cannot. Nor a d_ff of 258 over 4, nor 3 local q heads over groups of 4
    around replicated kv heads; nor RWKV6's 63 wkv heads at a d_model of
    4032 over 16, nor a channel mix int(3.5 x 4100) = 14350 wide over 4 (its
    4 heads of 1025 dividing it)."""
    import dataclasses
    cfg = dataclasses.replace(get_config(arch), **change)
    with pytest.raises(ValueError, match=dim):
        shd.check_executable(cfg, Mesh.abstract((1, model), ("data", "model")))


def test_replicated_kv_heads_are_those_each_ranks_q_heads_read():
    """The smoke configs' 4 q heads on 2 kv heads at model 4: the kv
    projections replicate (the GQA rule) and rank r keeps kv head r // 2;
    at model 2 they shard."""
    cfg = smoke_config(get_config("qwen3-1.7b"))
    for r in range(4):
        par = shd.plan(cfg, Mesh.abstract((1, 4), ("data", "model"), rank=r))
        assert par.kv_heads == (r // 2, 1) and par.local.n_kv_heads == 2
        assert par.specs["blocks.0.attn.wk"] == () and par.local.n_heads == 1
        assert par.model_partial == {"blocks.0.attn.q_norm", "blocks.1.attn.q_norm"}
    par = shd.plan(cfg, Mesh.abstract((1, 2), ("data", "model"), rank=1))
    assert par.kv_heads is None and par.local.n_kv_heads == 1
    assert par.specs["blocks.0.attn.wk"] == (None, "model")
