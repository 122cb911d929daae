"""Naive roofline baseline (paper Table V: fast but over-optimistic).

Used two ways:
  * as the lower-bound sanity check for the tile-level model (property test:
    mapper latency >= roofline latency, always);
  * in the dry-run analyzer, where the three-term roofline (compute, memory,
    collective) is derived from a step's flop and byte counts.

The PyTorch port's copy of the JAX package's module, whole: the same points
for the same specs (tests/test_torch_roofline.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

from .hardware import Device, System
from .operators import (GELU_FLOPS_PER_ELT, LAYERNORM_FLOPS_PER_ELT,
                        RMSNORM_FLOPS_PER_ELT, SILU_MUL_FLOPS_PER_ELT,
                        SOFTMAX_FLOPS_PER_ELT)
from .units import Bytes, BytesPerSecond, Elements, Flops, FlopsPerElement, \
    FlopsPerSecond, Ratio, Seconds

if TYPE_CHECKING:
    from .ir import Graph


@dataclass(frozen=True)
class RooflinePoint:
    compute_s: Seconds
    memory_s: Seconds
    collective_s: Seconds = 0.0

    @property
    def latency(self) -> Seconds:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms.items(), key=lambda kv: kv[1])[0]


def matmul_roofline(dev: Device, m: int, k: int, n: int, batch: int = 1,
                    bytes_a: float = 2, bytes_b: float = 2,
                    bytes_out: float = 2,
                    mac_scale: Ratio = 1.0) -> RooflinePoint:
    """Memory term = sum of per-operand widths (each tensor streamed once);
    compute term scaled by the narrow-datatype issue rate so it stays a
    lower bound for the mapper's scaled cycle counts."""
    flops: Flops = 2.0 * batch * m * k * n
    bytes_: Bytes = batch * (m * k * bytes_a + k * n * bytes_b
                             + m * n * bytes_out)
    return RooflinePoint(flops / (dev.peak_matmul_flops * mac_scale),
                         bytes_ / dev.memory_bandwidth)


def op_roofline(dev: Device, flops: Flops, bytes_: Bytes,
                on_mxu: bool = False) -> RooflinePoint:
    peak: FlopsPerSecond = dev.peak_matmul_flops if on_mxu \
        else dev.peak_vector_flops
    return RooflinePoint(flops / peak, bytes_ / dev.memory_bandwidth)


# --- symbolic-IR entry points ----------------------------------------------

def spec_roofline(dev: Device, spec: object) -> RooflinePoint:
    """Optimistic roofline bound for one ir.OpSpec (no tiling effects).

    Property: the mapper/operator latency for the same spec is never below
    this bound (tested) — the paper's Table V criticism of rooflines.
    """
    from .ir import (CollectiveSpec, ElementwiseSpec, FusedMatmulSpec,
                     MatmulSpec, NormSpec, ScanSpec, SoftmaxSpec, TrafficSpec)
    if isinstance(spec, FusedMatmulSpec):
        # fused kernel: the GEMM's roofline at its rescaled (elided) output
        # traffic, plus the epilogues' vector flops on the compute term
        base = spec_roofline(dev, spec.gemm)
        extra: Seconds = sum(spec_roofline(dev, e).compute_s
                             for e in spec.epilogue)
        return RooflinePoint(base.compute_s + extra, base.memory_s)
    if isinstance(spec, MatmulSpec):
        return matmul_roofline(dev, spec.m, spec.k, spec.n, spec.batch,
                               spec.bytes_a, spec.bytes_b, spec.bytes_out,
                               spec.mac_scale)
    if isinstance(spec, SoftmaxSpec):
        n: Elements = spec.rows * spec.cols
        return op_roofline(dev, SOFTMAX_FLOPS_PER_ELT * n,
                           n * (spec.bytes_in + spec.bytes_out))
    if isinstance(spec, NormSpec):
        rate: FlopsPerElement = (LAYERNORM_FLOPS_PER_ELT
                                 if spec.kind == "layernorm"
                                 else RMSNORM_FLOPS_PER_ELT)
        nn: Elements = spec.rows * spec.cols
        return op_roofline(dev, rate * nn,
                           nn * (spec.bytes_in + spec.bytes_out))
    if isinstance(spec, ElementwiseSpec):
        per: FlopsPerElement = {
            "gelu": GELU_FLOPS_PER_ELT,
            "silu_mul": SILU_MUL_FLOPS_PER_ELT,
        }.get(spec.kind, spec.flops_per_elt)
        n_in = 2 if spec.kind == "silu_mul" else spec.n_in
        return op_roofline(dev, per * spec.n_elements,
                           spec.n_elements * (n_in + 1) * spec.bytes_elt)
    if isinstance(spec, ScanSpec):
        return op_roofline(dev, spec.flops_per_step * spec.seq * spec.batch,
                           spec.bytes_io)
    if isinstance(spec, TrafficSpec):
        return op_roofline(dev, 0.0, spec.n_bytes)
    if isinstance(spec, CollectiveSpec):
        return RooflinePoint(0.0, 0.0, 0.0)   # link-bound; see graph_roofline
    raise TypeError(f"no roofline for spec type {type(spec).__name__}")


def graph_roofline(system: System, graph: "Graph") -> RooflinePoint:
    """Three-term roofline for a whole ir.Graph: compute and memory terms sum
    each node's optimistic bound x repeat; collective bytes go through the
    link at its raw bandwidth (framing/latency ignored — optimistic, like the
    rest of the roofline)."""
    from .ir import CollectiveSpec
    dev = system.device
    compute: Seconds = 0.0
    memory: Seconds = 0.0
    coll_bytes: Bytes = 0.0
    for node in graph:
        if isinstance(node.spec, CollectiveSpec):
            n = node.spec.n_devices or system.device_count
            if n > 1:
                factor: Ratio = {"all_reduce": 2.0 * (n - 1) / n,
                                 "reduce_scatter": (n - 1) / n,
                                 "all_gather": (n - 1) / n,
                                 "all_to_all": (n - 1) / n,
                                 "p2p": 1.0}.get(node.spec.kind, 1.0)
                coll_bytes += node.spec.n_bytes * factor * node.repeat
            continue
        pt = spec_roofline(dev, node.spec)
        compute += pt.compute_s * node.repeat
        memory += pt.memory_s * node.repeat
    return RooflinePoint(compute, memory,
                         coll_bytes / system.link.bandwidth_bytes)


def schedule_roofline(cost: Any) -> RooflinePoint:
    """Three-term resource roofline of a scheduled LayerCost (DESIGN.md §9):
    per-resource busy times from the dataflow schedule — compute (MXU),
    memory (vector/HBM streaming), collective (link). The scheduled makespan
    is never below `.latency` of this point (max of the busy times), and the
    gap between them is exactly the critical-path serialization the list
    scheduler priced — the attribution a naive additive breakdown cannot
    give. Works on serially-priced costs too (busy times from spec resource
    tags)."""
    busy = cost.by_resource()
    return RooflinePoint(compute_s=busy.get("compute", 0.0),
                         memory_s=busy.get("vector", 0.0),
                         collective_s=busy.get("link", 0.0))


# --- three_term's default design point ------------------------------------
# The JAX package's constants, kept so that both packages give the same
# points; a caller prices another device by passing its own rates.
TPU_V5E_PEAK_BF16: FlopsPerSecond = 197e12
TPU_V5E_HBM_BW: BytesPerSecond = 819e9
TPU_V5E_ICI_BW: BytesPerSecond = 50e9
TPU_V5E_ICI_LINKS = 4


def three_term(flops_per_chip: Flops, hbm_bytes_per_chip: Bytes,
               collective_bytes_per_chip: Bytes,
               peak: FlopsPerSecond = TPU_V5E_PEAK_BF16,
               hbm: BytesPerSecond = TPU_V5E_HBM_BW,
               ici: BytesPerSecond = TPU_V5E_ICI_BW) -> RooflinePoint:
    return RooflinePoint(
        compute_s=flops_per_chip / peak,
        memory_s=hbm_bytes_per_chip / hbm,
        collective_s=collective_bytes_per_chip / ici,
    )
