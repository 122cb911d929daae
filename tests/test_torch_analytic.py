"""The port's analytical stack (``repro_torch.core``: operators, precision,
ir, graph, fusion, interconnect, evaluator, inference_model, planner) against the JAX package's (``repro.core``), on the CPU.

On every hardware preset both packages have, the port's numbers equal the
JAX package's to 1e-12 relative and its winners (mappings, plan order) are
the same; the graphs it builds are the same node for node; its launcher
prints the planner report. The port also reproduces the frozen seed numbers
of ``tests/data/seed_reference.json`` on its own, as
``tests/test_ir_evaluator.py`` reads them for the JAX package.
"""
import dataclasses
import json
import math
import os

import pytest

from repro.configs import ARCHS as JAX_ARCHS, get_config as jax_config
from repro.core import fusion as jax_fusion
from repro.core import graph as jax_graph
from repro.core import hardware as jax_hw
from repro.core import inference_model as jax_im
from repro.core import ir as jax_ir
from repro.core import operators as jax_ops
from repro.core import planner as jax_planner
from repro.core.evaluator import Evaluator as JaxEvaluator
from repro_torch.configs import get_config
from repro_torch.core import fusion, graph, hardware, inference_model as im, ir
from repro_torch.core import operators as ops
from repro_torch.core import planner
from repro_torch.core.evaluator import Evaluator
from repro_torch.launch import serve

REL = 1e-12
PRESETS = sorted(jax_hw.PRESETS)
ARCHS = sorted(JAX_ARCHS) + ["gpt3-175b"]
# one dense decoder, the two recurrent ones and an MoE decoder
IM_ARCHS = ["qwen3-1.7b", "rwkv6-7b", "recurrentgemma-2b", "granite-moe-3b-a800m"]
IM_PLANS = [dict(tp=4), dict(tp=2, pp=2, sequence_parallel=True)]
FUSED = dict(fuse_epilogues=True, flash_stream=True)


def close(got, want):
    """Equal to 1e-12 relative; infinities and strings exactly."""
    if isinstance(want, float) and math.isinf(want):
        return got == want
    if isinstance(want, (int, float)) and not isinstance(want, bool):
        return abs(got - want) <= REL * abs(want)
    return got == want


def same_result(got, want):
    """One OpResult: name, bound and mapping exactly, numbers to 1e-12."""
    assert (got.name, got.bound) == (want.name, want.bound)
    for f in ("latency", "flops", "main_memory_bytes"):
        assert close(getattr(got, f), getattr(want, f)), (got.name, f)
    if want.mapping is None:
        assert got.mapping is None
    else:
        assert dataclasses.astuple(got.mapping) == dataclasses.astuple(want.mapping)


def same_dict(got, want):
    assert set(got) == set(want)
    for k in want:
        assert close(got[k], want[k]), k


def same_report(got, want):
    for f in ("latency", "flops", "bytes"):
        assert close(getattr(got, f), getattr(want, f)), f
    same_dict(got.breakdown, want.breakdown)
    same_dict(got.bound, want.bound)
    assert got.dominant == want.dominant


def spec_doc(spec):
    return type(spec).__name__, dataclasses.asdict(spec)


def same_graph(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (spec_doc(a.spec), a.name, a.repeat, a.deps) == \
            (spec_doc(b.spec), b.name, b.repeat, b.deps)


@pytest.mark.parametrize("preset", PRESETS)
def test_operators_equal_jax(preset):
    """Every operator model at a few shapes, narrow widths and a batch
    among the GEMMs; the norms also with rows longer than a core's local
    buffer (the chunked reduction), the scan at the wkv and RG-LRU
    arguments ``graph.build_rwkv`` / ``build_rglru`` pass."""
    jdev, tdev = jax_hw.PRESETS[preset](), hardware.PRESETS[preset]()
    long_row = 3 * tdev.core.local_buffer_bytes // 4      # 3 chunks at 2 bytes
    assert -(-long_row // (tdev.core.local_buffer_bytes // 4)) > 1
    calls = [
        ("matmul", (8, 12288, 49152), {}),
        ("matmul", (4096, 2048, 6144), {}),
        ("matmul", (256, 1024, 512), dict(bytes_a=1, bytes_b=1, bytes_out=4,
                                          bytes_acc=4, mac_scale=2.0)),
        ("matmul", (64, 128, 513), dict(batch=64)),
        ("softmax", (8 * 16 * 512, 512), {}),
        ("softmax", (64, 1 << 20), {}),
        ("layernorm", (4096, 12288), {}),
        ("layernorm", (8, long_row), {}),
        ("rmsnorm", (65536, 128), {}),
        ("rmsnorm", (3, long_row), dict(bytes_in=4, bytes_out=4)),
        ("gelu", (4096 * 49152,), {}),
        ("silu_mul", (34880 * 512,), {}),
        ("elementwise", (4096 * 2560, 4.0, 2), {}),
        ("memory_traffic", (8 * 2 * 8 * 128 * 2,), {}),
        ("recurrent_scan", (436, 8, 4096 * 64, 6.0 * 4096 * 64, 6 * 8 * 436 * 4096 * 2), {}),
        ("recurrent_scan", (2304, 1, 2560, 12.0 * 2560, 4 * 2304 * 2560 * 2), {}),
    ]
    for fn, args, kw in calls:
        same_result(getattr(ops, fn)(tdev, *args, **kw), getattr(jax_ops, fn)(jdev, *args, **kw))
    for kind, args in (("SoftmaxSpec", (512, 512)), ("NormSpec", ("layernorm", 8, long_row)),
                       ("NormSpec", ("rmsnorm", 4096, 2048)),
                       ("ElementwiseSpec", ("gelu", 1 << 20)),
                       ("ElementwiseSpec", ("silu_mul", 1 << 20)),
                       ("ElementwiseSpec", ("generic", 1 << 20, 3.0))):
        got = ops.fused_epilogue(tdev, getattr(ir, kind)(*args))
        want = jax_ops.fused_epilogue(jdev, getattr(jax_ir, kind)(*args))
        assert all(close(g, w) for g, w in zip(got, want)) and len(got) == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_build_model_equals_jax(arch):
    """Every layer kind the port serves (attention, rwkv, rglru, MoE,
    cross-attention layers and the encoder) builds the JAX graph at full
    size, for a prefill and a decode step under two plans, and the fusion
    pass rewrites it the same way."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    for plan in (dict(), dict(tp=2, pp=2, ep=2, sequence_parallel=True)):
        for batch, seq, kv in ((8, 436, 436), (8, 1, 513)):
            got = graph.build_model(cfg, graph.Plan(**plan), batch, seq, kv)
            want = jax_graph.build_model(jcfg, jax_graph.Plan(**plan), batch, seq, kv)
            same_graph(got, want)
            same_graph(fusion.fuse(got, fusion.FusionPolicy(**FUSED)),
                       jax_fusion.fuse(want, jax_fusion.FusionPolicy(**FUSED)))


@pytest.mark.parametrize("plan", IM_PLANS, ids=["tp4", "tp2pp2sp"])
@pytest.mark.parametrize("arch", IM_ARCHS)
def test_inference_model_equals_jax(arch, plan):
    """prefill, decode_step, generate, throughput, memory_per_device and
    max_batch on ``dgx_a100(4)``; prefill and the decode step also under
    the fused + flash execution model ``chip_smoke.py`` prices."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    tsys, jsys = hardware.dgx_a100(4), jax_hw.dgx_a100(4)
    tplan, jplan = graph.Plan(**plan), jax_graph.Plan(**plan)
    tev = Evaluator(tsys, verify="off", device="cpu")
    jev = JaxEvaluator(jsys, verify="off")
    same_report(im.prefill(tsys, cfg, tplan, 4, 512, evaluator=tev),
                jax_im.prefill(jsys, jcfg, jplan, 4, 512, evaluator=jev))
    same_report(im.decode_step(tsys, cfg, tplan, 8, 513, evaluator=tev),
                jax_im.decode_step(jsys, jcfg, jplan, 8, 513, evaluator=jev))
    same_report(im.generate(tsys, cfg, tplan, 4, 512, 64, evaluator=tev),
                jax_im.generate(jsys, jcfg, jplan, 4, 512, 64, evaluator=jev))
    fused, jfused = fusion.FusionPolicy(**FUSED), jax_fusion.FusionPolicy(**FUSED)
    same_report(im.prefill(tsys, cfg, tplan, 4, 512, evaluator=tev, fusion=fused),
                jax_im.prefill(jsys, jcfg, jplan, 4, 512, evaluator=jev, fusion=jfused))
    same_report(im.decode_step(tsys, cfg, tplan, 8, 513, evaluator=tev, fusion=fused),
                jax_im.decode_step(jsys, jcfg, jplan, 8, 513, evaluator=jev, fusion=jfused))
    assert close(im.throughput(tsys, cfg, tplan, 4, 512, 64, evaluator=tev),
                 jax_im.throughput(jsys, jcfg, jplan, 4, 512, 64, evaluator=jev))
    assert close(im.memory_per_device(cfg, tplan, 4, 576),
                 jax_im.memory_per_device(jcfg, jplan, 4, 576))
    assert im.max_batch(tsys, cfg, tplan, 1024) == jax_im.max_batch(jsys, jcfg, jplan, 1024)


@pytest.mark.parametrize("objective", ["latency", "throughput"])
@pytest.mark.parametrize("arch,n", [("qwen3-1.7b", 4), ("gpt3-175b", 4), ("gpt3-175b", 8)])
def test_rank_plans_equal_jax(arch, n, objective):
    """The port prices each plan as the JAX planner's Study prices it: the
    same plans in the same order, with the same numbers (plans that do not
    fit at infinite latency: all of gpt3-175b's on four A100s, some on
    eight), and the same best plan or the same refusal."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    tsys, jsys = hardware.dgx_a100(n), jax_hw.dgx_a100(n)
    got = planner.rank_plans(tsys, cfg, 8, 512, 32, objective, device="cpu")
    want = jax_planner.rank_plans(jsys, jcfg, 8, 512, 32, objective)
    assert [dataclasses.astuple(r.plan) for r in got] == \
        [dataclasses.astuple(r.plan) for r in want]
    for a, b in zip(got, want):
        assert a.fits == b.fits
        for f in ("latency", "throughput", "memory_per_device"):
            assert close(getattr(a, f), getattr(b, f)), (a.plan, f)
    if not any(r.fits for r in want):
        with pytest.raises(ValueError, match="does not fit") as refused:
            planner.best_plan(tsys, cfg, 8, 512, 32, objective, device="cpu")
        with pytest.raises(ValueError) as jax_refused:
            jax_planner.best_plan(jsys, jcfg, 8, 512, 32, objective)
        assert str(refused.value) == str(jax_refused.value)
        return
    best, jbest = (planner.best_plan(tsys, cfg, 8, 512, 32, objective, device="cpu"),
                   jax_planner.best_plan(jsys, jcfg, 8, 512, 32, objective))
    assert dataclasses.astuple(best.plan) == dataclasses.astuple(jbest.plan)
    assert close(best.latency, jbest.latency) and close(best.throughput, jbest.throughput)


def test_best_plan_refuses_what_does_not_fit_as_jax():
    with pytest.raises(ValueError) as got:
        planner.best_plan(hardware.dgx_a100(4), get_config("grok-1-314b"), 8, 512, 32,
                          device="cpu")
    with pytest.raises(ValueError) as want:
        jax_planner.best_plan(jax_hw.dgx_a100(4), jax_config("grok-1-314b"), 8, 512, 32)
    assert str(got.value) == str(want.value) == \
        "grok-1-314b does not fit on 4xnvidia-a100 under any plan"


_REF_PATH = os.path.join(os.path.dirname(__file__), "data", "seed_reference.json")
SEED_REL = 1e-9    # tests/test_ir_evaluator.py's bound on the same numbers


def test_port_reproduces_frozen_seed_numbers():
    """``tests/test_ir_evaluator.py``'s frozen seed cases, on the port alone:
    the layernorm-only configs' prefill, decode and generate, and
    stablelm-1.6b's plan ranking on a v5e pod of 16."""
    ref = json.load(open(_REF_PATH))
    cases = {
        "gpt3-175b": [("dgx_a100_4", hardware.dgx_a100(4), graph.Plan(tp=4)),
                      ("dgx_a100_4_pp", hardware.dgx_a100(4), graph.Plan(tp=2, pp=2)),
                      ("tpu_v5e_16", hardware.tpu_v5e_pod(16), graph.Plan(tp=4, pp=4))],
        "stablelm-1.6b": [("tpu_v5e_16", hardware.tpu_v5e_pod(16), graph.Plan(tp=2, dp=8)),
                          ("dgx_a100_4", hardware.dgx_a100(4), graph.Plan(tp=1, dp=4))],
        "whisper-tiny": [("tpu_v5e_16", hardware.tpu_v5e_pod(16),
                          graph.Plan(tp=2, pp=2, dp=4))],
        "rwkv6-7b": [("tpu_v5e_16", hardware.tpu_v5e_pod(16), graph.Plan(tp=4, dp=4))],
    }
    for arch, sysplans in cases.items():
        cfg = get_config(arch)
        for tag, system, plan in sysplans:
            r = ref[f"{arch}/{tag}"]
            ev = Evaluator(system, device="cpu")
            pf = im.prefill(system, cfg, plan, batch=4, seq=512, evaluator=ev)
            got = {"prefill": pf.latency, "prefill_flops": pf.flops,
                   "prefill_bytes": pf.bytes,
                   "decode": im.decode_step(system, cfg, plan, batch=4, kv_len=768,
                                            evaluator=ev).latency,
                   "generate": im.generate(system, cfg, plan, 4, 512, 64, evaluator=ev).latency}
            for k, v in got.items():
                assert abs(v - r[k]) <= SEED_REL * abs(r[k]), (arch, tag, k)
    ranked = ref["rank_plans/stablelm-1.6b/tpu_v5e_16"]
    checked = 0
    for r in planner.rank_plans(hardware.tpu_v5e_pod(16), get_config("stablelm-1.6b"),
                                8, 1024, 128, device="cpu"):
        if not r.fits or r.plan.sequence_parallel:
            continue     # the frozen ranking predates the sequence-parallel plans
        lat, thr = ranked[f"tp{r.plan.tp}_pp{r.plan.pp}_dp{r.plan.dp}"]
        assert abs(r.latency - lat) <= SEED_REL * lat, r.plan
        assert abs(r.throughput - thr) <= SEED_REL * thr, r.plan
        checked += 1
    assert checked > 0


def test_launcher_prints_the_planner_report_first(capsys):
    """The launcher plans the arch's full config on one H100 before it
    serves, in the JAX launcher's ``[planner]`` format, and reports a
    config that does not fit with the planner's error."""
    serve.main(["--device", "cpu", "--preset", "tiny", "--requests", "2", "--max-new", "2"])
    out = capsys.readouterr().out.splitlines()
    best = planner.best_plan(hardware.make_system(hardware.nvidia_h100(), 1, 900.0),
                             get_config("qwen1.5-0.5b"), batch=4, in_len=512, out_len=2,
                             device="cpu")
    assert out[0] == (f"[planner] qwen1.5-0.5b on 1x h100: tp=1 pp=1 dp=1 ep=1  "
                      f"pred latency={best.latency * 1e3:.1f}ms  "
                      f"pred throughput={best.throughput:.0f} tok/s  "
                      f"mem/chip={best.memory_per_device / 2 ** 30:.2f}GiB")
    assert out[-1].startswith("served 2 requests")
    serve.main(["--device", "cpu", "--arch", "gpt3-175b", "--layers", "1", "--requests", "1",
                "--max-new", "1"])
    assert capsys.readouterr().out.splitlines()[0] == \
        "[planner] gpt3-175b does not fit on 1xnvidia-h100 under any plan"
