"""The port's trace export (``repro_torch.core.trace_export``) and trace CLI
(``python -m repro_torch.trace``) against the JAX package's, on the CPU.

* Schedule traces of qwen2-0.5b at TP 2 on 2x A100 (prefill and decode,
  under the serial, overlap and full fusion presets) and the serving
  replay of a seeded Poisson trace serialize to the JAX exporter's bytes;
  both validate, and their span is the makespan bit for bit.
* The validator catches the planted errors of ``tests/test_trace_export.py``
  and passes what the JAX validator passes; ``_ts`` quantizes as JAX's.
* For every stage, ``repro_torch.trace.main(argv + ["--tables-device",
  "cpu"])`` writes the JAX CLI's trace and CSV byte for byte, prints the
  same lines and returns the same exit code; ``--tables-device cuda``
  raises where there is no card.

Every comparison is exact: the port prices with the same numpy operations,
and its mapper tables on ``cpu`` are the JAX package's numpy tables.
"""
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import fusion as jax_fusion
from repro.core import hardware as jax_hw
from repro.core import mapper as jax_mapper
from repro.core import schedule as jax_schedule
from repro.core import simulator as jax_sim
from repro.core import trace_export as jax_te
from repro.core import workload as jax_workload
from repro.core.evaluator import Evaluator as JaxEvaluator
from repro.core.graph import Plan as JaxPlan, build_model as jax_build_model
from repro.trace import main as jax_main
from repro_torch.configs import get_config
from repro_torch.core import fusion, hardware, mapper, schedule, simulator
from repro_torch.core import trace_export as te
from repro_torch.core import workload
from repro_torch.core.evaluator import Evaluator
from repro_torch.core.graph import Plan, build_model
from repro_torch.trace import main

# one side of the comparison: the port's modules, or the JAX package's
PORT = dict(cfg=get_config, hw=hardware, fusion=fusion, sched=schedule,
            sim=simulator, te=te, workload=workload, plan=Plan,
            build=build_model, ev=lambda s: Evaluator(s, verify="off", device="cpu"),
            clear=mapper.clear_matmul_cache)
JAX = dict(cfg=jax_config, hw=jax_hw, fusion=jax_fusion, sched=jax_schedule,
           sim=jax_sim, te=jax_te, workload=jax_workload, plan=JaxPlan,
           build=jax_build_model, ev=lambda s: JaxEvaluator(s, verify="off"),
           clear=jax_mapper.clear_matmul_cache)

FUSIONS = ["SERIAL", "OVERLAP", "FULL"]
STAGES = {"prefill": (2, 128, 128), "decode": (2, 1, 256)}


def schedule_events(side, stage, fus_name):
    """The schedule trace of qwen2-0.5b at TP 2 (the CLI's display path for
    a serially priced graph); returns (events, the schedule's makespan)."""
    batch, seq, kv = STAGES[stage]
    fus = getattr(side["fusion"], fus_name)
    side["clear"]()
    g = side["fusion"].fuse(side["build"](side["cfg"]("qwen2-0.5b"), side["plan"](tp=2),
                                          batch, seq, kv_len=kv), fus)
    cost = side["ev"](side["hw"].dgx_a100(2)).evaluate(g, overlap=fus.overlap)
    sch = cost.schedule
    if sch is None:
        sch = side["sched"].schedule_graph(g, [o.latency for o in cost.ops],
                                           pipeline_collectives=False)
    return side["te"].schedule_trace_events(sch, g, process_name=stage), sch.makespan


def serve_events(side):
    system = side["hw"].dgx_a100(2)
    traffic = side["workload"].TrafficWorkload.from_trace(
        side["workload"].Trace.poisson(8, 16.0, 128, 8, seed=0), slots=4)
    side["clear"]()
    sim = side["sim"].simulate(system, side["cfg"]("qwen2-0.5b"), side["plan"](tp=2), traffic,
                               evaluator=side["ev"](system))
    return side["te"].simulation_trace_events(sim), sim.makespan


@pytest.mark.parametrize("fus_name", FUSIONS)
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_schedule_trace_equals_jax_bytes(stage, fus_name):
    (got, makespan), (want, _) = (schedule_events(PORT, stage, fus_name),
                                  schedule_events(JAX, stage, fus_name))
    assert te.to_perfetto_json(got) == jax_te.to_perfetto_json(want)
    assert te.validate_trace_events(got) == []
    assert te.total_span_us(got) == te._ts(makespan)
    if fus_name == "FULL":
        assert any(e["ph"] == "B" and e["args"].get("kind") == "FusedMatmulSpec" for e in got)


def test_simulation_trace_equals_jax_bytes():
    (got, makespan), (want, _) = serve_events(PORT), serve_events(JAX)
    assert te.to_perfetto_json(got) == jax_te.to_perfetto_json(want)
    assert te.validate_trace_events(got) == []
    assert te.total_span_us(got) == te._ts(makespan)
    assert any(e["ph"] == "C" and e["name"] == "live_slots" for e in got)


def test_write_trace_writes_the_jax_file(tmp_path):
    events, _ = schedule_events(PORT, "prefill", "FULL")
    text = te.write_trace(str(tmp_path / "port.json"), events)
    assert text == jax_te.write_trace(str(tmp_path / "jax.json"), events)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()


BASE = {"pid": 0, "tid": 0}
PLANTED = {
    "no name": [{"ph": "B", "ts": 0, **BASE}],
    "bad phase": [{"name": "x", "ph": "Z", "ts": 0, **BASE}],
    "negative ts": [{"name": "x", "ph": "B", "ts": -1.0, **BASE}],
    "E without B": [{"name": "x", "ph": "E", "ts": 0, **BASE}],
    "mismatched E": [{"name": "x", "ph": "B", "ts": 0, **BASE},
                     {"name": "y", "ph": "E", "ts": 1, **BASE}],
    "backwards": [{"name": "x", "ph": "B", "ts": 5, **BASE},
                  {"name": "x", "ph": "E", "ts": 9, **BASE},
                  {"name": "y", "ph": "B", "ts": 4, **BASE},
                  {"name": "y", "ph": "E", "ts": 9, **BASE}],
    "unclosed": [{"name": "x", "ph": "B", "ts": 0, **BASE}],
}


@pytest.mark.parametrize("case", sorted(PLANTED))
def test_validator_catches_the_planted_errors_as_jax(case):
    got = te.validate_trace_events(PLANTED[case])
    assert got and got == jax_te.validate_trace_events(PLANTED[case])


def test_validator_passes_a_good_lane():
    ok = [{"name": "x", "ph": "B", "ts": 0, **BASE},
          {"name": "x", "ph": "E", "ts": 2.5, **BASE}]
    assert te.validate_trace_events(ok) == [] == jax_te.validate_trace_events(ok)


def test_ts_quantizes_as_jax():
    xs = [0.0, 1.0, 1.0 + 1e-15, 1.0 + 1e-11, 0.1, 0.2, 0.30000000001, 16.107322693123]
    assert [te._ts(x) for x in xs] == [jax_te._ts(x) for x in xs]
    assert te._ts(1.0) == 1_000_000.0
    assert te._ts(1.0 + 1e-15) == te._ts(1.0) != te._ts(1.0 + 1e-11)
    assert max(te._ts(x) for x in xs) == te._ts(max(xs))


# ---------------------------------------------------------------------------
# the CLI: the same argv, the same files
# ---------------------------------------------------------------------------

SMALL = ["--config", "qwen2_0.5b", "--devices", "2", "--tp", "2", "--batch", "2",
         "--in-len", "128", "--out-len", "8", "--requests", "6", "--rate", "16"]
CLI_CASES = {
    "qwen2-small": SMALL,
    "qwen2-small-serial-int8": SMALL + ["--fusion", "serial", "--policy", "int8-weights"],
    "gpt3-default": ["--config", "gpt3_175b"],
}
CLI_STAGES = ("prefill", "decode", "generate", "layer", "serve")


def run_cli(fn, argv, where, monkeypatch, capsys):
    """Run one CLI in its own directory with relative paths, so that the
    two packages' printed lines can be compared as they are."""
    where.mkdir()
    monkeypatch.chdir(where)
    rc = fn(argv + ["--csv", "ops.csv"])
    out = capsys.readouterr().out
    files = {p.name: p.read_bytes() for p in sorted(where.iterdir())}
    return rc, out, files


@pytest.mark.parametrize("stage", CLI_STAGES)
@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_trace_cli_writes_the_jax_files(case, stage, tmp_path, monkeypatch, capsys):
    argv = CLI_CASES[case] + ["--stage", stage]
    mapper.clear_matmul_cache()
    jax_mapper.clear_matmul_cache()
    got = run_cli(main, argv + ["--tables-device", "cpu"], tmp_path / "port", monkeypatch,
                  capsys)
    want = run_cli(jax_main, argv, tmp_path / "jax", monkeypatch, capsys)
    assert got == want
    rc, out, files = got
    assert rc == 0 and "== modeled makespan" in out
    name = [n for n in files if n.endswith(f"_{stage}.perfetto.json")]
    assert len(name) == 1                      # the default trace path
    assert ("ops.csv" in files) == (stage != "serve")


def test_trace_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal is for one without")
    with pytest.raises(RuntimeError, match="need a CUDA card"):
        main(SMALL + ["--stage", "prefill", "--out", str(tmp_path / "t.json")])
    assert not (tmp_path / "t.json").exists()


def test_trace_cli_refuses_an_unknown_table_device(capsys):
    with pytest.raises(SystemExit) as e:
        main(SMALL + ["--tables-device", "tpu"])
    assert e.value.code == 2
    assert "invalid choice: 'tpu'" in capsys.readouterr().err
