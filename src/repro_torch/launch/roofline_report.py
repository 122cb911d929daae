"""The three-term roofline of every dry-run cell, priced on the H100:
``repro.launch.roofline_report`` on the port's dry-run records.

    PYTHONPATH=src python -m repro_torch.launch.roofline_report \
        [--dir experiments/dryrun_torch] [--device cpu]

    compute    = FLOPs a chip / 989.4 TFLOP/s (``nvidia_h100``'s dense bf16;
                 the aten FLOPs and the kernels' operations of the rank's
                 traced program)
    memory     = device-memory bytes a chip / 3.35 TB/s (the LLMCompass
                 model's traffic of the cell, ``simulated_hbm_bytes``, on an
                 H100 cluster of the mesh's size)
    collective = collective bytes a chip / the slowest link they cross: a
                 16-rank axis spans two DGX H100 nodes, so 50 GB/s (a GPU's
                 NDR port, ``core.hardware.dgx_h100_link_rate``)

``fits`` holds the rank's peak (the trace's live bytes) to 80 GB. The
LLMCompass model's mapper tables run on the card unless ``--device cpu``
(a host with no card).
``build_rows`` takes the rates, the capacity and the system as arguments, so
that the JAX report's TPU v5e arithmetic is the same function at its rates
(tests/test_torch_roofline_report.py). MODEL_FLOPS: train = 6 N_active
tokens, prefill = 2 N_active tokens, decode = 2 N_active batch.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from dataclasses import dataclass

from ..configs import SHAPES, get_config
from ..core import hardware as hw
from ..core.evaluator import Evaluator
from ..core.graph import Plan, build_model

DRYRUN_DIR = "experiments/dryrun_torch"

H100 = hw.nvidia_h100()
H100_PEAK_BF16 = H100.peak_matmul_flops
H100_HBM_BW = H100.memory_bandwidth
#: the slowest link of a 16-rank axis on DGX H100 nodes
H100_AXIS_LINK = hw.dgx_h100_link_rate(16)
#: an H100's device memory, 80 GB
H100_CAPACITY = 80e9


def model_flops(cfg, shape) -> float:
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch      # decode: one token per seq


_SIM = {}
_EVALUATORS = {}   # one evaluator a system: specs dedup across the grid


def simulated_hbm_bytes(arch: str, shape, system=None, device: str = "cuda") -> float:
    """Per-chip device-memory traffic of a cell from the LLMCompass model
    (paper Sec. III-B) on `system` (256 H100s by default), TP 16 x DP 16,
    the mapper tables on `device`."""
    system = system or hw.dgx_h100_cluster(256)
    key = (arch, shape.name, system.device.name, system.device_count)
    if key in _SIM:
        return _SIM[key]
    sys_key = (system.device.name, system.device_count, system.link, system.topology, device)
    if sys_key not in _EVALUATORS:
        _EVALUATORS[sys_key] = Evaluator(system, device=device)
    ev = _EVALUATORS[sys_key]
    cfg = get_config(arch)
    plan = Plan(tp=16, dp=16)
    if shape.kind == "decode":
        g = build_model(cfg, plan, batch=max(shape.global_batch // 16, 1),
                        seq=1, kv_len=shape.seq_len)
        bytes_ = ev.evaluate(g).bytes
    else:
        g = build_model(cfg, plan, batch=max(shape.global_batch // 16, 1),
                        seq=shape.seq_len, kv_len=shape.seq_len)
        bytes_ = ev.evaluate(g).bytes
        if shape.kind == "train":
            bytes_ *= 3.5       # bwd + remat re-reads (the JAX report's factor)
    _SIM[key] = bytes_
    return bytes_


@dataclass
class Row:
    arch: str
    shape: str
    mesh: str
    fits: bool
    mem_gib: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_ratio: float
    dominant: str
    note: str


NOTES = {
    "compute": "more chips / lower precision / cut remat recompute",
    "memory": "wider batch per chip or KV/weight quantization to raise "
              "arithmetic intensity",
    "collective": "shard KV along sequence / overlap TP collectives (SP) / "
                  "larger per-chip shards",
}


def build_rows(dryrun_dir: str = DRYRUN_DIR, peak: float = H100_PEAK_BF16,
               hbm_bw: float = H100_HBM_BW, link_bw: float = H100_AXIS_LINK,
               capacity: float = H100_CAPACITY, system=None, device: str = "cuda"):
    """A ``Row`` of every ok record in `dryrun_dir`, priced at `peak`
    FLOP/s, `hbm_bw` and `link_bw` bytes a second, fitting in `capacity`
    bytes; `system` prices ``simulated_hbm_bytes``, its mapper tables on
    `device`."""
    rows = []
    for f in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if rec.get("skipped") or not rec.get("ok"):
            continue
        arch, shape_name, mesh = rec["arch"], rec["shape"], rec["mesh"]
        shape = SHAPES[shape_name]
        cfg = get_config(arch)
        n_dev = rec["devices"]
        flops_dev = rec["cost"]["flops"]
        coll_dev = rec["collectives"]["bytes"]
        hbm_dev = simulated_hbm_bytes(arch, shape, system, device) \
            * (256 / n_dev if shape.kind != "decode" else 1.0)
        ct = flops_dev / peak
        mt = hbm_dev / hbm_bw
        lt = coll_dev / link_bw
        terms = {"compute": ct, "memory": mt, "collective": lt}
        dom = max(terms, key=terms.get)
        ratio = model_flops(cfg, shape) / max(flops_dev * n_dev, 1.0)
        rows.append(Row(
            arch=arch, shape=shape_name, mesh=mesh,
            fits=rec["memory"]["total_bytes"] <= capacity,
            mem_gib=rec["memory"]["total_bytes"] / 2 ** 30,
            compute_s=ct, memory_s=mt, collective_s=lt,
            model_flops_ratio=ratio, dominant=dom, note=NOTES[dom]))
    return rows


def markdown_table(rows, mesh: str = "single", capacity: float = H100_CAPACITY,
                   link_bw: float = H100_AXIS_LINK) -> str:
    out = [f"| arch | shape | fits<={capacity / 1e9:g}GB | mem/chip GiB | compute s | "
           f"memory s | collective s (at {link_bw / 1e9:g} GB/s) | dominant | MODEL/traced | "
           "next lever |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.mesh != mesh:
            continue
        out.append(
            f"| {r.arch} | {r.shape} | {'Y' if r.fits else 'N'} "
            f"| {r.mem_gib:.1f} | {r.compute_s:.3e} | {r.memory_s:.3e} "
            f"| {r.collective_s:.3e} | **{r.dominant}** "
            f"| {r.model_flops_ratio:.2f} | {r.note} |")
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default=DRYRUN_DIR)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the LLMCompass model's mapper tables run")
    args = ap.parse_args(argv)
    rows = build_rows(args.dir, device=args.device)
    print(f"{len(rows)} cells analyzed on NVIDIA H100 SXM5: {H100_PEAK_BF16 / 1e12:.1f} "
          f"TFLOP/s bf16, {H100_HBM_BW / 1e12:.2f} TB/s, collectives at "
          f"{H100_AXIS_LINK / 1e9:g} GB/s, {H100_CAPACITY / 1e9:g} GB")
    for mesh in ("single", "multi"):
        print(f"\n{mesh} mesh:")
        print(markdown_table([r for r in rows if r.mesh == mesh], mesh))
    return rows


if __name__ == "__main__":
    main()
