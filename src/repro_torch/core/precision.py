"""Precision: the datatype registry and the per-tensor-class policy.

The paper prices everything at fp16: a "16-bit MAC" systolic array and all
traffic at 2 bytes an element. Here precision is an axis of the model:

  * ``DType`` — a frozen registry entry: byte width, MAC throughput relative
    to the fp16 datapath (an int8 PE issues 2 MACs per fp16-MAC slot on the
    same array), and PE area relative to an fp16 MAC.
  * ``PrecisionPolicy`` — a frozen value type assigning one DType per tensor
    class (weights / activations / KV cache / accumulator).

graph.py's builders stamp per-operand byte widths and the compute-rate
scale onto every OpSpec; the mapper prices A/B/C/partial traffic at those
widths and scales systolic cycles by ``mac_scale``; inference_model's
memory model reads the policy.

The DEFAULT policy is fp16 everywhere, the accumulator included, which
reproduces the seed's frozen numbers (tests/data/seed_reference.json).

The PyTorch port's copy of the JAX package's registry, without the policy
presets of its study grids.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Union


@dataclass(frozen=True)
class DType:
    """One numeric format as the analytical stack sees it.

    mac_throughput: MACs per cycle relative to the fp16 datapath *on the
        same systolic array* (paper Sec. III-B1 compute model). Powers of
        two only — the mapper divides cycle counts by this exactly.
    mac_area_rel: area of one PE built natively for this format, relative
        to the calibrated fp16 MAC; multiplier area shrinks
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


#: the seed model's implicit policy: 2 bytes everywhere, fp16 MAC rate.
DEFAULT = PrecisionPolicy()
