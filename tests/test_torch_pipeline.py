"""The port's GPipe schedule over the ``pod`` axis
(``distributed.pipeline.pipeline_apply``) on gloo worlds of 2 and 4 CPU
ranks, against the JAX package's ``pipeline_apply`` (shard_map over forced
host devices, in a subprocess) on the same stage function and stacked
weights (a 4-unit ``tanh(x @ W)`` stack, 3 microbatches), and against the
port's own forward through qwen3-smoke's blocks (cut to 4 layers) split
across the stages (each stage holds its own blocks only).

Tolerances: fp32, 2e-5 against JAX (the same products, XLA's against
PyTorch's); the split blocks equal the unsplit ones bit for bit (the same
ops on the same rows; a microbatch is a batch of its own, and no op of a
block mixes rows).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.models.lm import init_params

import _torch_dist

UNITS, B, D, N_MB = 4, 6, 8, 3

JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.pipeline import pipeline_apply
    from repro.launch.mesh import make_host_mesh
    w, x = np.load(sys.argv[1]), np.load(sys.argv[2])

    def stage(ws, h):
        for i in range(ws.shape[0]):
            h = jnp.tanh(h @ ws[i])
        return h

    out = {}
    for pod in (2, 4):
        mesh = make_host_mesh(pod=pod)
        out[pod] = np.asarray(pipeline_apply(mesh, stage, jnp.asarray(w), jnp.asarray(x),
                                             N_MB)).tolist()
    print("PIPE " + json.dumps(out))
""").replace("N_MB", str(N_MB))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((UNITS, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    np.save(tmp / "w.npy", w)
    np.save(tmp / "x.npy", x)
    cfg = dataclasses.replace(smoke_config(get_config("qwen3-1.7b")), n_layers=4)
    model = init_params(cfg, seed=2, device="cpu")
    h = torch.randn((6, 12, cfg.d_model), generator=torch.Generator().manual_seed(3)).bfloat16()
    torch.save({"w": torch.from_numpy(w), "x": torch.from_numpy(x), "n_microbatches": N_MB,
                "cfg": cfg, "state": model.state_dict(), "h": h}, tmp / "inputs.pt")
    worlds = [_torch_dist.start_world(tmp, n, "pipeline_worker", str(tmp / "inputs.pt"),
                                      str(tmp / f"out_{n}.pt")) for n in (2, 4)]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(tmp / "w.npy"),
                        str(tmp / "x.npy")], capture_output=True, text=True, cwd=root,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300)
    for ctx in worlds:
        _torch_dist.join_world(ctx)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("PIPE ")]
    assert line, r.stderr[-2000:]
    jax_out = {int(k): np.array(v, np.float32)
               for k, v in json.loads(line[0][len("PIPE "):]).items()}
    with torch.no_grad():
        blocks = model.apply_layers(h, range(cfg.n_layers))
    return jax_out, {n: torch.load(tmp / f"out_{n}.pt", weights_only=False) for n in (2, 4)}, \
        w, x, blocks


@pytest.mark.parametrize("stages", (2, 4))
def test_pipeline_apply_equals_jax_on_every_stage(results, stages):
    jax_out, outs, w, x, _ = results
    plain = x
    for i in range(UNITS):
        plain = np.tanh(plain @ w[i])
    assert np.abs(jax_out[stages] - plain).max() < 2e-5
    for rank, got in enumerate(outs[stages]):      # the last stage's, broadcast
        assert np.abs(got["tanh"].numpy() - jax_out[stages]).max() < 2e-5, rank


@pytest.mark.parametrize("stages", (2, 4))
def test_pipeline_of_blocks_equals_the_unsplit_forward(results, stages):
    _, outs, _, _, blocks = results
    for rank, got in enumerate(outs[stages]):
        assert got["blocks"].dtype == blocks.dtype
        assert torch.equal(got["blocks"], blocks), rank
