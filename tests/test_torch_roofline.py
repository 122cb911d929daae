"""The port's roofline (``repro_torch.core.roofline``) and eager graph
conveniences (``graph.layer_ops`` / ``graph.model_ops``) against the JAX
package's, on the CPU.

* On every hardware preset and every arch (gpt3-175b included), the
  roofline point of each node of the serial and the fully fused graph, the
  graph's three-term roofline and the scheduled cost's resource roofline
  equal the JAX package's exactly; so do ``matmul_roofline``,
  ``op_roofline`` and ``three_term`` (whose default rates are the JAX
  module's), and the H100 preset, which only the port has, against the JAX
  functions on the same values.
* ``layer_ops`` and ``model_ops`` on the port's ``Evaluator`` with its
  mapper tables on ``cpu`` give the JAX costs op for op, exactly.
* The paper's Table V property holds on the port: the mapper's latency is
  never below the roofline's compute term (and not below 0.35 of its memory
  term, the C-tile write-back overlapping), per GEMM and per spec, on every
  preset. ``tests/test_torch_cuda.py`` holds it with the tables on the card.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import ARCHS as JAX_ARCHS, get_config as jax_config
from repro.core import fusion as jax_fusion
from repro.core import graph as jax_graph
from repro.core import hardware as jax_hw
from repro.core import roofline as jax_rf
from repro.core.evaluator import Evaluator as JaxEvaluator
from repro_torch.configs import get_config
from repro_torch.core import fusion, graph, hardware, mapper, roofline as rf
from repro_torch.core.evaluator import Evaluator
from repro_torch.core.ir import Graph, MatmulSpec, Node, NormSpec, SoftmaxSpec
from test_torch_mapper_tables import to_jax

PRESETS = sorted(hardware.PRESETS)           # the JAX presets and the H100
ARCHS = sorted(JAX_ARCHS) + ["gpt3-175b"]
POINTS = [("prefill", 2, 128, 128), ("decode", 2, 1, 256)]


def pt(p):
    return (p.compute_s, p.memory_s, p.collective_s, p.latency, p.bound)


def systems(preset):
    dev = hardware.get_device(preset)
    return hardware.make_system(dev, 4), jax_hw.make_system(to_jax(dev), 4)


def evaluators(preset):
    port, jax = systems(preset)
    return (Evaluator(port, verify="off", device="cpu"),
            JaxEvaluator(jax, verify="off"))


def same_cost(got, want):
    """Two LayerCosts: latency, each op and the schedule's makespan exactly."""
    assert got.latency == want.latency
    assert [(o.name, o.bound, o.latency, o.flops, o.main_memory_bytes,
             o.mapping and dataclasses.astuple(o.mapping)) for o in got.ops] == \
        [(o.name, o.bound, o.latency, o.flops, o.main_memory_bytes,
          o.mapping and dataclasses.astuple(o.mapping)) for o in want.ops]
    assert (got.schedule is None) == (want.schedule is None)
    if got.schedule is not None:
        assert got.schedule.makespan == want.schedule.makespan


@pytest.mark.parametrize("preset", PRESETS)
def test_rooflines_equal_jax_on_every_arch(preset):
    port, jax = systems(preset)
    for arch in ARCHS:
        for _, batch, seq, kv in POINTS:
            for fus, jfus in ((fusion.SERIAL, jax_fusion.SERIAL), (fusion.FULL, jax_fusion.FULL)):
                g = fusion.fuse(graph.build_model(get_config(arch), graph.Plan(tp=4), batch, seq,
                                                  kv_len=kv), fus)
                jg = jax_fusion.fuse(jax_graph.build_model(jax_config(arch), jax_graph.Plan(tp=4),
                                                           batch, seq, kv_len=kv), jfus)
                assert [pt(rf.spec_roofline(port.device, n.spec)) for n in g] == \
                    [pt(jax_rf.spec_roofline(jax.device, n.spec)) for n in jg], arch
                assert pt(rf.graph_roofline(port, g)) == pt(jax_rf.graph_roofline(jax, jg)), arch


@pytest.mark.parametrize("preset", PRESETS)
def test_layer_and_model_ops_equal_jax_on_every_arch(preset):
    (ev, jev), (port, jax) = evaluators(preset), systems(preset)
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_config(arch)
        for _, batch, seq, kv in POINTS:
            same_cost(graph.model_ops(cfg, port, graph.Plan(tp=4), batch, seq, kv, evaluator=ev),
                      jax_graph.model_ops(jcfg, jax, jax_graph.Plan(tp=4), batch, seq, kv,
                                          evaluator=jev))
            same_cost(graph.layer_ops(cfg, port, graph.Plan(tp=2), 0, batch, seq, kv,
                                      evaluator=ev),
                      jax_graph.layer_ops(jcfg, jax, jax_graph.Plan(tp=2), 0, batch, seq, kv,
                                          evaluator=jev))


def test_model_ops_makes_its_own_evaluator_on_the_given_device():
    port, jax = systems("a100")
    cfg, jcfg = get_config("qwen2-0.5b"), jax_config("qwen2-0.5b")
    same_cost(graph.model_ops(cfg, port, graph.Plan(tp=4), 2, 128, 128, device="cpu"),
              jax_graph.model_ops(jcfg, jax, jax_graph.Plan(tp=4), 2, 128, 128))
    same_cost(graph.layer_ops(cfg, port, graph.Plan(tp=4), 0, 2, 1, 256, device="cpu"),
              jax_graph.layer_ops(jcfg, jax, jax_graph.Plan(tp=4), 0, 2, 1, 256))


@pytest.mark.parametrize("preset", ["a100", "h100", "tpuv5e", "design-C"])
def test_schedule_roofline_equals_jax(preset):
    (ev, jev), (port, jax) = evaluators(preset), systems(preset)
    for arch in ("gpt3-175b", "granite-moe-3b-a800m", "rwkv6-7b"):
        g = fusion.fuse(graph.build_model(get_config(arch), graph.Plan(tp=4), 2, 128, 128),
                        fusion.FULL)
        jg = jax_fusion.fuse(jax_graph.build_model(jax_config(arch), jax_graph.Plan(tp=4),
                                                   2, 128, 128), jax_fusion.FULL)
        cost, jcost = ev.evaluate(g, overlap=True), jev.evaluate(jg, overlap=True)
        got = rf.schedule_roofline(cost)
        assert pt(got) == pt(jax_rf.schedule_roofline(jcost))
        assert cost.schedule.makespan >= got.latency


def test_point_functions_and_three_term_equal_jax():
    rnd = np.random.default_rng(0)
    for preset in PRESETS:
        dev = hardware.get_device(preset)
        jdev = to_jax(dev)
        for _ in range(8):
            m, k, n = (int(x) for x in rnd.integers(1, 8192, size=3))
            widths = [float(x) for x in rnd.choice([0.5, 1.0, 2.0, 4.0], size=3)]
            scale = float(rnd.choice([0.5, 1.0, 2.0, 4.0]))
            assert pt(rf.matmul_roofline(dev, m, k, n, 3, *widths, scale)) == \
                pt(jax_rf.matmul_roofline(jdev, m, k, n, 3, *widths, scale))
            flops, nbytes = float(rnd.uniform(1e6, 1e12)), float(rnd.uniform(1e3, 1e10))
            for mxu in (False, True):
                assert pt(rf.op_roofline(dev, flops, nbytes, mxu)) == \
                    pt(jax_rf.op_roofline(jdev, flops, nbytes, mxu))
    for args in ((1e15, 1e12, 1e10), (3.5e12, 0.0, 7e9), (0.0, 2e9, 0.0)):
        assert pt(rf.three_term(*args)) == pt(jax_rf.three_term(*args))
        h100 = hardware.nvidia_h100()
        assert pt(rf.three_term(*args, peak=h100.peak_matmul_flops,
                                hbm=h100.memory_bandwidth, ici=450e9)) == \
            pt(jax_rf.three_term(*args, peak=h100.peak_matmul_flops,
                                 hbm=h100.memory_bandwidth, ici=450e9))
    assert (rf.TPU_V5E_PEAK_BF16, rf.TPU_V5E_HBM_BW, rf.TPU_V5E_ICI_BW, rf.TPU_V5E_ICI_LINKS) \
        == (jax_rf.TPU_V5E_PEAK_BF16, jax_rf.TPU_V5E_HBM_BW, jax_rf.TPU_V5E_ICI_BW,
            jax_rf.TPU_V5E_ICI_LINKS)


def test_collective_spec_has_no_device_roofline():
    from repro_torch.core.ir import CollectiveSpec
    assert pt(rf.spec_roofline(hardware.nvidia_h100(), CollectiveSpec("all_reduce", 1e6))) == \
        (0.0, 0.0, 0.0, 0.0, "compute")
    with pytest.raises(TypeError, match="no roofline for spec type"):
        rf.spec_roofline(hardware.nvidia_h100(), object())


# ---------------------------------------------------------------------------
# paper Table V: the mapper never beats the roofline
# ---------------------------------------------------------------------------

GEMMS = [(m, k, n) for m in (1, 16, 512, 4096) for k in (64, 12288) for n in (128, 12288)]
# the mapper's shape key: (m, k, n, batch, bytes a, b, out, acc, b shared, mac scale)
SHAPES = [(m, k, n, 1, 2.0, 2.0, 2.0, 2.0, False, 1.0) for m, k, n in GEMMS]
SPECS = [MatmulSpec(512, 4096, 1024), SoftmaxSpec(4096, 2048),
         NormSpec("rmsnorm", 4096, 4096), NormSpec("layernorm", 4096, 4096)]


@pytest.mark.parametrize("preset", PRESETS)
def test_mapper_never_beats_the_roofline(preset):
    dev = hardware.get_device(preset)
    mapper.clear_matmul_cache()
    got = mapper.matmul_perf_batch(dev, SHAPES, device="cpu")
    for (m, k, n), r in zip(GEMMS, got):
        bound = rf.matmul_roofline(dev, m, k, n)
        assert r.latency >= bound.compute_s * 0.999, (m, k, n)
        assert r.latency >= bound.memory_s * 0.35, (m, k, n)
    ev = Evaluator(hardware.make_system(dev, 1), verify="off", device="cpu")
    for spec in SPECS:
        cost = ev.evaluate(Graph((Node(spec, "x"),)))
        assert cost.latency >= rf.spec_roofline(dev, spec).compute_s * 0.999, spec
