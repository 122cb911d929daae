"""ZeRO's optimizer state and the pod axis of the port's sharded train step,
on gloo worlds of four CPU ranks, against the JAX package's single-device
step, with ``test_torch_dist_train.py::check``'s tolerances and leaves.

ZeRO (``AdamW.init(params, par)``, ``ModelShard.zero``): the fp32 master
copy and moments take ``zero_spec``'s extra data axis; each rank updates
its slice and all-gathers the new bf16 values. Held at (pod, data, model) =
(1, 2, 2) for qwen2 (qkv biases, whose ZeRO axis the JAX rule puts on the
stacked unit axis: the port puts it on the layer leaf's own dim, ROADMAP
C17), qwen3 (qk-norm) and stablelm (layernorm), one and two microbatches.
The pod axis as a data axis: (2, 2, 1), four rows in one microbatch over
pod x data, for qwen3 and granite (MoE: the rows gathered over data and pod,
routing the whole batch's, the JAX routing replayed). Each rank's state
bytes equal the JAX ``zero_spec`` slices of the whole state, and the
parameters after the update are the gathered master copy rounded to bf16.
"""
import jax
import numpy as np
import pytest
import torch

from repro.distributed import sharding as jshd
from repro_torch.launch.mesh import Mesh
from repro_torch.models.bridge import params_from_jax

import _torch_dist
from test_torch_dist_train import check, jax_reference, jax_weights, make_batch

ZERO = {"qwen2-0.5b": (1, 2, 2), "qwen3-1.7b": (1, 2, 2), "stablelm-1.6b": (1, 2, 2)}
POD = {"qwen3-1.7b": (2, 2, 1), "granite-moe-3b-a800m": (2, 2, 1)}
ROWS = {"zero": ([slice(0, 2)], [slice(0, 2), slice(2, 4)]), "pod": ([slice(0, 4)],)}


def cases_of(kind, meshes):
    """(refs as ``check`` reads them, the workers' cases)."""
    refs, cases = {}, {}
    for arch, mesh in meshes.items():
        jcfg, jparams, cfg = jax_weights(arch)
        out = jax_reference(jcfg, jparams, cfg, arch, ROWS[kind])
        state = params_from_jax(cfg, jax.tree.map(np.asarray, jparams))
        refs[arch] = [jcfg, jparams, cfg, out, state]
        tok, tgt, mask, _ = make_batch(cfg, arch)
        for mb, rows in enumerate(ROWS[kind], start=1):
            rows = slice(rows[0].start, rows[-1].stop)
            cases[f"{arch}_mb{mb}"] = {
                "cfg": cfg, "state": state, "mesh": mesh, "microbatches": mb,
                "records": out[mb - 1][3],
                "batch": {"tokens": torch.from_numpy(tok[rows]),
                          "targets": torch.from_numpy(tgt[rows]),
                          "mask": torch.from_numpy(mask[rows])}}
    return refs, cases


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    ctxs = []
    for kind, meshes in (("zero", ZERO), ("pod", POD)):
        tmp = tmp_path_factory.mktemp(f"dist_{kind}")
        refs, cases = cases_of(kind, meshes)
        torch.save(cases, tmp / "cases.pt")
        ctxs.append(_torch_dist.start_world(tmp, 4, "zero_worker", str(tmp / "cases.pt"),
                                            str(tmp)))
        out[kind] = (refs, tmp, cases)
    for ctx in ctxs:
        _torch_dist.join_world(ctx)
    # the files under check's names: <arch>_mb<n>_<pod x data>x<model>.pt
    for kind, (refs, tmp, cases) in out.items():
        for name, case in cases.items():
            got = torch.load(tmp / f"zero_{name}.pt", weights_only=False)
            pod, data, model = case["mesh"]
            torch.save(got, tmp / f"{name}_{pod * data}x{model}.pt")
    return out


CASES = [("zero", a, mb) for a in ZERO for mb in (1, 2)] + [("pod", a, 1) for a in POD]


@pytest.mark.parametrize("kind,arch,microbatches", CASES,
                         ids=[f"{k}-{a}-mb{n}" for k, a, n in CASES])
def test_step_matches_jax_single_device(worlds, kind, arch, microbatches):
    refs, tmp, cases = worlds[kind]
    pod, data, model = cases[f"{arch}_mb{microbatches}"]["mesh"]
    check((refs, tmp), arch, (pod * data, model), microbatches)


@pytest.mark.parametrize("kind,arch,microbatches", CASES,
                         ids=[f"{k}-{a}-mb{n}" for k, a, n in CASES])
def test_state_bytes_are_the_zero_spec_slices(worlds, kind, arch, microbatches):
    """Every rank's master copy holds the bytes of its slices under the JAX
    ``zero_spec`` (fp32, the whole state's), and the parameters after the
    update are the gathered master copy in the parameters' dtype."""
    refs, tmp, cases = worlds[kind]
    jcfg, jparams, cfg = refs[arch][:3]
    pod, data, model = cases[f"{arch}_mb{microbatches}"]["mesh"]
    mesh = Mesh.abstract((pod, data, model), ("pod", "data", "model"))
    jshd.set_model_config(jcfg)
    try:
        want = 0
        for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
            spec = jshd.zero_spec(mesh, path, leaf)
            ways = 1
            for entry in spec:
                for axis in (entry if isinstance(entry, tuple) else (entry,)):
                    ways *= mesh.shape[axis] if axis else 1
            want += leaf.size // ways * 4
    finally:
        jshd.set_model_config(None)
    got = torch.load(tmp / f"zero_{arch}_mb{microbatches}.pt", weights_only=False)
    assert got["state_bytes"] == [want] * 4, (got["state_bytes"], want)
    for n, p in got["params"].items():
        assert torch.equal(p, got["master"][n].to(p.dtype)), n
