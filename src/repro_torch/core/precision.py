"""Precision subsystem: datatype-aware compute, memory, and area modeling.

The paper evaluates everything at fp16 (its Sec. III compute model prices a
"16-bit MAC" systolic array and all traffic at 2 bytes/element). Deployed
LLM serving leans hard on narrower datatypes — int8/fp8 weights, quantized
KV caches, int8 systolic datapaths — and the surveys this repo tracks
(2410.04466 Sec. IV, 2411.00136) show precision is the single biggest
lever after parallelism. This module makes precision a first-class axis:

  * ``DType`` — a frozen registry entry: byte width, MAC throughput relative
    to the fp16 datapath (paper Sec. III-B1: an int8 PE issues 2 MACs per
    fp16-MAC slot on the same array), and PE area relative to an fp16 MAC
    (area.py prices narrow datapaths with it).
  * ``PrecisionPolicy`` — a frozen value type assigning one DType per tensor
    class (weights / activations / KV cache / accumulator). Policies ride
    Study grids exactly like Plans and Workloads: hashable, taggable,
    cheap to enumerate.

Threading: graph.py builders stamp per-operand byte widths
and the compute-rate scale onto every OpSpec; the mapper prices A/B/C/
partial traffic at those widths and scales systolic cycles by ``mac_scale``;
inference_model's memory model and the planner/simulator capacity gates read
the policy instead of a hardwired ``bytes_per=2``.

The DEFAULT policy is fp16 everywhere — including the accumulator, because
the seed mapper staged C tiles and k-split partials at the 2-byte element
width. DEFAULT must reproduce the frozen seed numbers bit-for-bit
(tests/test_torch_analytic.py); honest int8/fp8 presets carry fp32 accumulators.

The PyTorch port's copy of the JAX package's precision module, whole.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Union


@dataclass(frozen=True)
class DType:
    """One numeric format as the analytical stack sees it.

    mac_throughput: MACs per cycle relative to the fp16 datapath *on the
        same systolic array* (paper Sec. III-B1 compute model). Powers of
        two only — the mapper divides cycle counts by this exactly.
    mac_area_rel: area of one PE built natively for this format, relative
        to the calibrated fp16 MAC (area.MAC_AREA); multiplier area shrinks
        roughly quadratically with operand width.
    """
    name: str
    bits: int
    mac_throughput: float
    mac_area_rel: float

    @property
    def bytes(self) -> Union[int, float]:
        """Byte width; int when whole so the default mapper path stays on
        exact int64 arithmetic (int4 -> 0.5)."""
        return self.bits // 8 if self.bits % 8 == 0 else self.bits / 8

    def __str__(self) -> str:
        return self.name


FP32 = DType("fp32", 32, 0.5, 4.0)
BF16 = DType("bf16", 16, 1.0, 1.0)
FP16 = DType("fp16", 16, 1.0, 1.0)
FP8 = DType("fp8", 8, 2.0, 0.5)      # e4m3 storage; e5m2 prices the same
INT8 = DType("int8", 8, 2.0, 0.3)
INT4 = DType("int4", 4, 4.0, 0.1)

DTYPES: Dict[str, DType] = {d.name: d for d in
                            (FP32, BF16, FP16, FP8, INT8, INT4)}


def get_dtype(name: str) -> DType:
    try:
        return DTYPES[name]
    except KeyError:
        raise KeyError(f"unknown dtype '{name}'; have {sorted(DTYPES)}")


def mac_scale(a: DType, b: DType) -> float:
    """Compute-rate scale of a GEMM whose operands are a x b, relative to
    the fp16 datapath. Mixed-width GEMMs run at the slower operand's rate:
    int8 weights against fp16 activations dequantize into fp16 MACs (1.0);
    only an all-int8 (or all-fp8) GEMM earns the 2x issue rate."""
    return min(a.mac_throughput, b.mac_throughput)


@dataclass(frozen=True)
class PrecisionPolicy:
    """Datatype assignment per tensor class — one point on the precision axis.

    weights:     every parameter matrix (QKV/O, MLP, experts, embedding)
    activations: layer inputs/outputs, attention probabilities, collectives
    kv_cache:    the resident K/V tensors (attention B operands + capacity)
    accumulator: matmul partial sums staged in on-chip buffers (C tiles and
                 the scheme-2 k-split partials in the mapper)
    """
    weights: DType = FP16
    activations: DType = FP16
    kv_cache: DType = FP16
    accumulator: DType = FP16

    @property
    def tag(self) -> str:
        return (f"w{self.weights.name}_a{self.activations.name}"
                f"_kv{self.kv_cache.name}_acc{self.accumulator.name}")

    # -- spec kwargs for graph builders ------------------------------------
    def weight_gemm(self) -> Dict[str, Union[int, float]]:
        """MatmulSpec width kwargs for activation x weight GEMMs."""
        return dict(bytes_a=self.activations.bytes,
                    bytes_b=self.weights.bytes,
                    bytes_out=self.activations.bytes,
                    bytes_acc=self.accumulator.bytes,
                    mac_scale=mac_scale(self.activations, self.weights))

    def attn_gemm(self) -> Dict[str, Union[int, float]]:
        """MatmulSpec width kwargs for attention score/value GEMMs, whose B
        operand streams from the KV cache."""
        return dict(bytes_a=self.activations.bytes,
                    bytes_b=self.kv_cache.bytes,
                    bytes_out=self.activations.bytes,
                    bytes_acc=self.accumulator.bytes,
                    mac_scale=mac_scale(self.activations, self.kv_cache))

    def with_(self, **kw: DType) -> "PrecisionPolicy":
        """Named-field variant (`DEFAULT.with_(weights=INT8)`)."""
        return replace(self, **kw)


#: the seed model's implicit policy: 2 bytes everywhere, fp16 MAC rate.
DEFAULT = PrecisionPolicy()

#: named presets for Study grids (quantization design space). Quantized
#: presets accumulate in fp32, as the port's GEMM kernels never accumulate
#: narrower than fp32 (kernels/matmul).
POLICIES: Dict[str, PrecisionPolicy] = {
    "fp16": DEFAULT,
    "bf16": PrecisionPolicy(BF16, BF16, BF16, BF16),
    "int8-weights": PrecisionPolicy(weights=INT8, accumulator=FP32),
    "int8-kv": PrecisionPolicy(kv_cache=INT8, accumulator=FP32),
    "w8kv8": PrecisionPolicy(weights=INT8, kv_cache=INT8, accumulator=FP32),
    "w8a8": PrecisionPolicy(weights=INT8, activations=INT8, kv_cache=INT8,
                            accumulator=FP32),
    "fp8": PrecisionPolicy(FP8, FP8, FP8, FP32),
    "int4-weights": PrecisionPolicy(weights=INT4, accumulator=FP32),
}


def get_policy(name: str) -> PrecisionPolicy:
    try:
        return POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown precision policy '{name}'; "
                       f"have {sorted(POLICIES)}")


def policy_tag(policy: PrecisionPolicy) -> str:
    """Preset name when the policy is a registered preset, else the
    structural tag — the Study's `policy` result column."""
    for name, p in POLICIES.items():
        if p == policy:
            return name
    return policy.tag
