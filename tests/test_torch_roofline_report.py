"""The port's roofline report (``repro_torch.launch.roofline_report``) and
its collective pricing (``launch.analysis``) against the JAX package's.

``build_rows`` given the TPU v5e's rates, its 16 GiB and
``tpu_v5e_pod(256)`` equals the JAX ``build_rows`` row for row on the same
dry-run records (written here, with the JAX records' ``hlo_cost`` FLOPs); at
its defaults it prices the same records on the H100: 989.4 TFLOP/s,
3.35 TB/s, collectives at 50 GB/s (a 16-rank axis spans two DGX H100
nodes) and 80 GB. ``predicted_collective_time`` equals JAX's on the same
``CollectiveStats``.
"""
import dataclasses
import json

import pytest

from repro.core import hardware as jhw
from repro.launch import analysis as janalysis
from repro.launch import roofline_report as jreport
from repro_torch.core import hardware as hw
from repro_torch.core.roofline import TPU_V5E_HBM_BW, TPU_V5E_ICI_BW, TPU_V5E_PEAK_BF16
from repro_torch.launch import analysis, roofline_report as report

RECORDS = [("qwen3-1.7b", "decode_32k", "single", 256, 7.2e9, 3.9e9, 1.8e6),
           ("stablelm-1.6b", "prefill_32k", "multi", 512, 1.2e13, 1.2e9, 6.5e9),
           ("qwen1.5-0.5b", "decode_32k", "multi", 512, 1.0e9, 90e9, 4.0e5)]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_records")
    for arch, shape, mesh, n, flops, mem, coll in RECORDS:
        rec = {"arch": arch, "shape": shape, "mesh": mesh, "devices": n, "ok": True,
               "hlo_cost": {"flops": flops}, "cost": {"flops": flops},
               "memory": {"total_bytes": mem},
               "collectives": {"bytes": coll, "count": 3, "by_kind": {"all-reduce": coll}}}
        with open(tmp / f"{arch}__{shape}__{mesh}.json", "w") as f:
            json.dump(rec, f)
    with open(tmp / "grok-1-314b__decode_32k__single.json", "w") as f:
        json.dump({"arch": "grok-1-314b", "shape": "decode_32k", "mesh": "single",
                   "ok": False, "error": "NotImplementedError: A12b"}, f)
    return tmp


def test_build_rows_at_tpu_rates_equals_jax(records):
    want = jreport.build_rows(str(records))
    got = report.build_rows(str(records), peak=TPU_V5E_PEAK_BF16, hbm_bw=TPU_V5E_HBM_BW,
                            link_bw=TPU_V5E_ICI_BW, capacity=16 * 2 ** 30,
                            system=hw.tpu_v5e_pod(256), device="cpu")
    assert len(got) == len(want) == len(RECORDS)
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


def test_build_rows_prices_the_h100_by_default(records):
    rows = {(r.arch, r.shape, r.mesh): r for r in report.build_rows(str(records), device="cpu")}
    for arch, shape, mesh, n, flops, mem, coll in RECORDS:
        r = rows[(arch, shape, mesh)]
        assert r.compute_s == flops / 989.42976e12
        assert r.collective_s == coll / 50e9
        assert r.fits == (mem <= 80e9)
    assert not rows[("qwen1.5-0.5b", "decode_32k", "multi")].fits
    assert hw.dgx_h100_link_rate(8) == 450e9 and hw.dgx_h100_link_rate(16) == 50e9
    table = report.markdown_table(list(rows.values()), "single")
    assert "fits<=80GB" in table and "at 50 GB/s" in table


@pytest.mark.parametrize("n", [16, 256])
def test_predicted_collective_time_equals_jax(n):
    by_kind = {"all-reduce": 3.5e9, "all-gather": 1.25e9, "collective-permute": 2e6}
    total = sum(by_kind.values())
    got = analysis.predicted_collective_time(
        hw.tpu_v5e_pod(256), analysis.CollectiveStats(total, by_kind, 9), n, "cpu")
    want = janalysis.predicted_collective_time(
        jhw.tpu_v5e_pod(256), janalysis.CollectiveStats(total, by_kind, 9), n)
    assert got == want > 0
    assert analysis.predicted_collective_time(hw.dgx_h100_cluster(n),
                                              analysis.CollectiveStats(), 0, "cpu") == 0.0
