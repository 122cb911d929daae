"""Package rules of the PyTorch port (``src/repro_torch``).

* it imports neither JAX nor the JAX package ``repro``: every module imports
  with both blocked, and no source line imports them;
* its entry points run on ``cuda`` unless told otherwise, and on a host
  without a card they raise an error that names ``device="cpu"``;
* ``params_from_jax`` carries bf16 across bit for bit.
"""
import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jax_models
from repro.configs import ARCHS as JAX_ARCHS, smoke_config as jax_smoke
from repro_torch import models
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve
from repro_torch.models.bridge import to_tensor
from repro_torch.serving import Engine

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_every_module_imports_with_jax_and_repro_blocked():
    script = f"""
import importlib, importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Block())
for name in {_modules()!r}:
    importlib.import_module(name)
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro") for m in sys.modules)
print("imported", len({_modules()!r}))
"""
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=_env(), timeout=120)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(_modules())}" in res.stdout


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path}: imports {bad}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(no_cuda):
    cfg = smoke_config(get_config("qwen3-1.7b"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        models.init_params(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        models.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        models.lm.LM(cfg)
    model = models.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Engine(cfg, model, batch_size=1, max_len=8)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve.main(["--arch", "qwen3-1.7b", "--requests", "1"])
    done = serve.main(["--arch", "qwen3-1.7b", "--requests", "3", "--batch", "2",
                       "--max-new", "3", "--device", "cpu"])
    assert len(done) == 3 and all(len(r.output) == 3 for r in done)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "gpt3-175b", "rwkv6-7b"])
def test_launcher_serves_the_layernorm_archs_on_cpu(arch):
    """``--arch`` resolves through ``get_config``, gpt3-175b (outside
    ``ARCHS``) included; ``--layers`` cuts the depth. rwkv6-7b's prompts
    (5-11 tokens) are of unequal lengths in one wave."""
    done = serve.main(["--arch", arch, "--requests", "3", "--batch", "2",
                       "--max-new", "3", "--layers", "1", "--device", "cpu"])
    assert len(done) == 3 and all(len(r.output) == 3 for r in done)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "grok-1-314b"])
def test_launcher_serves_the_moe_archs_on_cpu(arch):
    """The two MoE archs through ``--arch`` at the tiny preset (their smoke
    configs: 4 experts, top-2; grok-1-314b with its softcap), a wave of
    unequal prompts and a refill."""
    done = serve.main(["--arch", arch, "--requests", "3", "--batch", "2",
                       "--max-new", "3", "--device", "cpu"])
    assert len(done) == 3 and all(len(r.output) == 3 for r in done)


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-11b"])
def test_launcher_serves_the_cross_archs_on_cpu(arch):
    """The two cross-attending archs through ``--arch`` at the tiny preset,
    each request with its seeded stub frontend: a wave and a refill."""
    done = serve.main(["--arch", arch, "--requests", "3", "--batch", "2",
                       "--max-new", "3", "--device", "cpu"])
    assert len(done) == 3 and all(len(r.output) == 3 for r in done)
    assert all(r.frontend.shape == (16, 128) for r in done)


def test_engine_refuses_a_model_on_another_device():
    cfg = smoke_config(get_config("qwen3-1.7b"))
    model = models.init_params(cfg, device="meta")
    with pytest.raises(ValueError, match="engine runs on"):
        Engine(cfg, model, batch_size=1, max_len=8, device="cpu")


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the chip script exits non-zero and prints no result."""
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=_env(), timeout=120,
                         cwd=ROOT)
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the script would run")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_bf16_crosses_bit_exactly():
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -3e38, 1.0],
                       np.float32)
    rng = np.random.default_rng(0)
    x = jnp.asarray(np.concatenate([special, rng.standard_normal(1000)
                                    .astype(np.float32) * 1e3]), jnp.bfloat16)
    want = np.asarray(x).view(np.uint16)
    t = to_tensor(np.asarray(x))
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16), want)


def test_params_from_jax_round_trips_every_leaf():
    jcfg = jax_smoke(JAX_ARCHS["qwen1.5-0.5b"])      # qkv bias, tied head
    jparams = jax.tree.map(np.asarray,
                           jax_models.init_params(jcfg, jax.random.PRNGKey(1)))
    cfg = smoke_config(get_config("qwen1.5-0.5b"))
    model = models.lm.LM(cfg, device="cpu")
    sd = models.params_from_jax(cfg, jparams)
    model.load_state_dict(sd)                       # strict: every name matches
    state = model.state_dict()

    def bits(a):
        a = np.ascontiguousarray(a)
        return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)

    def tbits(t):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy().view(np.uint32)

    assert np.array_equal(tbits(state["embed"]), bits(jparams["embed"]))
    unit = jparams["units"]["u0"]
    for i in range(cfg.n_layers):
        for group in ("ln1", "attn", "ln2", "mlp"):
            for name, stacked in unit[group].items():
                got = state[f"blocks.{i}.{group}.{name}"]
                assert got.shape == stacked.shape[1:]
                assert np.array_equal(tbits(got), bits(stacked[i])), (i, group, name)
