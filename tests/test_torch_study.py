"""The port's design-space Study (``repro_torch.core.study``) against the JAX
package's numpy Study (``repro.core.study``), on the CPU.

On a smoke grid (two hardware presets, the qwen3-1.7b and gpt3-175b smoke
configs, two plans, two workloads, DEFAULT and the int8-weights policy,
SERIAL and the overlap fusion) the port's ``to_rows()`` equal the JAX
Study's field for field, for the generate stage and the prefill, decode and
layer stages; a ``stage="serve"`` case's ``SimResult`` equals the JAX
simulator's; each preset's die area and cost are the JAX models'; a warm
rerun from the port's disk layer and a ``workers=2`` run give the cold
serial rows; ``verify="warn"`` raises the JAX verifier's diagnostics; and
importing the Study, or the trace, verify and unitcheck CLIs, loads neither
JAX nor the JAX package.

Every comparison is exact (``==`` on floats): the port prices with the
same numpy operations, and its mapper tables on ``device="cpu"`` are the
JAX package's numpy tables bit for bit. The card's run of the same grid
(``device="cuda"``) is held to the CPU rows by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import warnings

import pytest

from repro.configs import get_config as jax_config, smoke_config as jax_smoke
from repro.core import area as jax_area
from repro.core import cost as jax_cost
from repro.core import fusion as jax_fusion
from repro.core import graph as jax_graph
from repro.core import hardware as jax_hw
from repro.core import mapper as jax_mapper
from repro.core import precision as jax_precision
from repro.core import result_cache as jax_cache
from repro.core import simulator as jax_sim
from repro.core import study as jax_study
from repro.core import workload as jax_workload
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import area, cost, fusion, graph, hardware, mapper, precision
from repro_torch.core import result_cache, simulator, study, workload
from test_torch_mapper_tables import to_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]

# one side of the comparison: the port's modules, or the JAX package's
PORT = dict(hw=hardware, graph=graph, fusion=fusion, precision=precision, workload=workload,
            study=study, sim=simulator, cfg=lambda a: smoke_config(get_config(a)),
            kw=dict(device="cpu"))
JAX = dict(hw=jax_hw, graph=jax_graph, fusion=jax_fusion, precision=jax_precision,
           workload=jax_workload, study=jax_study, sim=jax_sim,
           cfg=lambda a: jax_smoke(jax_config(a)), kw={})


def grid(side, stage="generate", **kw):
    """The smoke grid as a Study of one side: 2 x 2 x 2 x 2 x 2 x 2 cases."""
    hw, P = side["hw"], side["precision"]
    return side["study"].Study(
        systems=[hw.dgx_a100(2), hw.make_system(hw.google_tpu_v5e(), 2, 400.0)],
        configs=[side["cfg"]("qwen3-1.7b"), side["cfg"]("gpt3-175b")],
        plans=[side["graph"].Plan(tp=2), side["graph"].Plan(tp=1, dp=2)],
        workloads={"short": side["workload"].Workload(2, 64, 8, samples=4),
                   "long": side["workload"].Workload(1, 160, 4, samples=2)},
        policies={"fp16": P.DEFAULT, "int8": P.POLICIES["int8-weights"]},
        fusions={"serial": side["fusion"].SERIAL, "overlap": side["fusion"].OVERLAP},
        stage=stage, **side["kw"], **kw)


def cold(side, stage="generate", workers=None, **kw):
    """A cold run: memo cleared, no disk layer, no verifier output."""
    side_mapper = mapper if side is PORT else jax_mapper
    side_cache = result_cache if side is PORT else jax_cache
    side_mapper.clear_matmul_cache()
    with side_cache.disabled(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return grid(side, stage, verify="off", **kw).run(workers=workers)


@pytest.mark.parametrize("stage", ["generate", "prefill", "decode", "layer"])
def test_grid_rows_equal_jax(stage):
    got, want = cold(PORT, stage), cold(JAX, stage)
    assert len(got) == len(want) == 64
    assert got.to_rows() == want.to_rows()
    assert got.stats.matmul_pairs_presolved == want.stats.matmul_pairs_presolved > 0
    assert got.stats.evaluated == want.stats.evaluated
    for a, b in zip(got, want):     # the attribution behind the rows' columns
        assert (a.attribution.to_doc() if a.attribution else None) == \
            (b.attribution.to_doc() if b.attribution else None)
        assert a.critical == b.critical
    assert {r["fusion"] for r in got.to_rows()} == {"serial", "overlap"}
    assert {r["policy"] for r in got.to_rows()} == {"fp16", "int8"}


def test_warm_rerun_is_bit_identical(tmp_path):
    """A fresh Study over the same grid serves every case from the disk
    layer and gives the cold rows."""
    want = cold(PORT)
    with result_cache.overridden(root=tmp_path, enabled=True), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mapper.clear_matmul_cache()
        first = grid(PORT).run()
        mapper.clear_matmul_cache()
        warm = grid(PORT).run()
    assert first.stats.case_cache_misses == len(want)
    assert warm.stats.case_cache_hits == len(want) and warm.stats.matmul_pairs_presolved == 0
    assert (tmp_path / study.CASES_NAMESPACE).is_dir()
    assert first.to_rows() == warm.to_rows() == want.to_rows()


def test_workers_equal_the_serial_run():
    """Two spawned shards give the serial rows and the serial counts."""
    serial = cold(PORT)
    two = cold(PORT, workers=2)
    assert two.to_rows() == serial.to_rows()
    assert two.to_csv() == serial.to_csv()
    assert (two.stats.cases, two.stats.evaluated) == (serial.stats.cases, serial.stats.evaluated)


def serve_case(side):
    hw, W = side["hw"], side["workload"]
    trace = W.Trace.poisson(10, rate=25.0, in_len=(16, 96), out_len=(4, 12), seed=3)
    traffic = W.TrafficWorkload.from_trace(trace, slots=4, policy="continuous",
                                           kv_samples=4, seq_samples=4)
    return side["study"].Case(hw.dgx_a100(2), side["cfg"]("qwen3-1.7b"),
                              side["graph"].Plan(tp=2), traffic, stage="serve",
                              policy=side["precision"].POLICIES["int8-kv"],
                              fusion=side["fusion"].FUSED)


def test_serve_case_equals_jax():
    got, want = (side["study"].Study(cases=[serve_case(side)], verify="off",
                                     **side["kw"]).run()[0] for side in (PORT, JAX))
    assert dataclasses.asdict(got.sim) == dataclasses.asdict(want.sim)
    assert got.to_row() == want.to_row()
    assert got.sim.tokens_out == sum(r.out_len for r in serve_case(PORT).workload.trace)
    # and simulate() alone, static batching, with its own evaluator
    for pol in ("static", "continuous"):
        sims = []
        for side in (PORT, JAX):
            c = serve_case(side)
            w = dataclasses.replace(c.workload, policy=pol)
            sims.append(side["sim"].simulate(c.system, c.cfg, c.plan, w, verify="off",
                                             **side["kw"]))
        assert dataclasses.asdict(sims[0]) == dataclasses.asdict(sims[1])


PRICED = sorted(hardware.PRESETS)


@pytest.mark.parametrize("preset", PRICED)
def test_area_and_cost_equal_jax(preset):
    dev = hardware.PRESETS[preset]()
    jdev = to_jax(dev)
    for link in (600.0, 900.0):
        got, want = area.device_area(dev, link), jax_area.device_area(jdev, link)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.total_mm2 == want.total_mm2
        assert dataclasses.asdict(cost.device_cost(dev, got.total_mm2)) == \
            dataclasses.asdict(jax_cost.device_cost(jdev, want.total_mm2))
    int8 = hardware.with_mac_dtype(dev, "int8")
    assert area.device_area(int8).total_mm2 == jax_area.device_area(to_jax(int8)).total_mm2


def diagnostics(side):
    """The verifier's warnings of one side's Study over plans that trip its
    rules: pp not dividing the layers, tp past the kv heads."""
    hw, G = side["hw"], side["graph"]
    cfg = side["cfg"]("qwen3-1.7b")
    st = side["study"].Study(
        systems=[hw.dgx_a100(8)], configs=[dataclasses.replace(cfg, n_layers=3)],
        plans=[G.Plan(pp=2, dp=4), G.Plan(tp=4, dp=2)],
        workloads=[side["workload"].Workload(2, 64, 4, samples=2)],
        verify="warn", result_cache=False, **side["kw"])
    (mapper if side is PORT else jax_mapper).clear_matmul_cache()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        rows = st.run().to_rows()
    return [str(w.message) for w in seen], rows


def test_verify_warn_gives_the_jax_diagnostics():
    (got, got_rows), (want, want_rows) = diagnostics(PORT), diagnostics(JAX)
    assert got == want
    assert any("plan.pp-layers" in m for m in got)
    assert any("plan.tp-kv-heads" in m for m in got)
    assert got_rows == want_rows


def test_study_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, repro_torch.core.study, repro_torch.core.planner; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("modules", [
    "repro_torch.trace, repro_torch.verify, repro_torch.unitcheck",
    "repro_torch.core.roofline, repro_torch.core.trace_export, repro_torch.core.unitcheck",
], ids=["clis", "core"])
def test_analytical_clis_import_neither_jax_nor_the_jax_package(modules):
    """The trace, verify and unitcheck CLIs and the modules under them."""
    code = (f"import sys, {modules}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "grok-1-314b"])
def test_serve_plan_report_equals_jax_planner(arch):
    """The serving launcher's ``[planner]`` line on the CPU: the JAX
    planner's best plan and numbers on the same H100 node, or its refusal
    where nothing fits (grok-1-314b on one card)."""
    from repro.core import planner as jax_planner
    from repro_torch.launch.serve import plan_report
    mapper.clear_matmul_cache()
    jax_mapper.clear_matmul_cache()
    with result_cache.disabled(), jax_cache.disabled():
        got = plan_report(get_config(arch), 1, 4, 16, "cpu")
        node = jax_hw.make_system(to_jax(hardware.nvidia_h100()), 1, link_gbps=900.0)
        try:
            best = jax_planner.best_plan(node, jax_config(arch), batch=4, in_len=512, out_len=16)
        except ValueError as e:
            assert got == f"[planner] {e}"
            return
    p = best.plan
    assert got == (f"[planner] {arch} on 1x h100: tp={p.tp} pp={p.pp} dp={p.dp} ep={p.ep}  "
                   f"pred latency={best.latency * 1e3:.1f}ms  "
                   f"pred throughput={best.throughput:.0f} tok/s  "
                   f"mem/chip={best.memory_per_device / 2 ** 30:.2f}GiB")


def test_study_refuses_an_evaluator_on_another_device():
    ev = study.Evaluator(hardware.dgx_a100(2), device="cpu")
    st = study.Study(cases=[serve_case(PORT)], evaluators={hardware.dgx_a100(2): ev},
                     device="cpu", verify="off")
    assert st._evaluator(hardware.dgx_a100(2)) is ev
    ev.tables_device = "cuda"          # as one made for the card
    with pytest.raises(ValueError, match="'cuda' was given to a Study on 'cpu'"):
        st._evaluator(hardware.dgx_a100(2))
