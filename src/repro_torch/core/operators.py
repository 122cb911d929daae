"""Operator-level performance models (paper Sec. III-B1/B3).

Matmul delegates to the mapper search. Softmax / LayerNorm / GELU follow the
same tile-by-tile methodology minus the systolic array: fewer dimensions, no
MXU, vector-unit compute, special-function throughput for exp/tanh/rsqrt.
Softmax uses the online algorithm [Milakov & Gimelshein], GELU the tanh
approximation [Hendrycks & Gimpel] — as in the paper.

Every model returns an OpResult carrying latency, flops, bytes and the
binding resource, so graph-level accounting (and the roofline comparison)
stays interpretable — the paper's "no fudge factors" principle.

Quantities are unit-annotated (core/units.py): per-element flop rates are
module constants typed ``FlopsPerElement`` so ``rate * n`` is ``Flops``.

This is the PyTorch port's copy of the JAX package's operator models, whole:
on each preset both packages have it gives the same numbers
(tests/test_torch_analytic.py), and `chip_smoke.py` holds its
``nvidia_h100()`` predictions against the card's kernels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .hardware import Device
from .mapper import Mapping, matmul_perf
from .units import Bytes, BytesPerElement, Cycles, Elements, Flops, \
    FlopsPerElement, FlopsPerSecond, Ratio, Seconds

#: per-element flop counts of the vector-op models (paper Sec. III-B3)
SOFTMAX_FLOPS_PER_ELT: FlopsPerElement = 4.0    # exp + max/accum/divide
LAYERNORM_FLOPS_PER_ELT: FlopsPerElement = 8.0  # Welford + (x-mu)*rsqrt*g+b
RMSNORM_FLOPS_PER_ELT: FlopsPerElement = 4.0    # x*x accum + x*rsqrt(ms)*g
GELU_FLOPS_PER_ELT: FlopsPerElement = 10.0      # tanh approximation
SILU_MUL_FLOPS_PER_ELT: FlopsPerElement = 6.0   # silu(a) * b

#: cross-chunk norm partials are staged in fp32 (4 bytes per value). The
#: earlier code charged 8 bytes per fp32 value here — a units bug the
#: dimensional-analysis annotation surfaced; fixing it halves the chunked-
#: reduction byte penalty (only visible when a row exceeds the local buffer).
FP32_BYTES: BytesPerElement = 4.0


@dataclass(frozen=True)
class OpResult:
    name: str
    latency: Seconds                # incl. launch overhead
    flops: Flops
    main_memory_bytes: Bytes
    bound: str                      # compute | memory | overhead | link
    mapping: Optional[Mapping] = None

    def __add__(self, other: "OpResult") -> "OpResult":
        # the dominant (slower) operand decides the bound and contributes its
        # mapping, so combined results keep their tile hints
        dom, sub = (self, other) if self.latency >= other.latency \
            else (other, self)
        return OpResult(
            name=f"{self.name}+{other.name}",
            latency=self.latency + other.latency,
            flops=self.flops + other.flops,
            main_memory_bytes=self.main_memory_bytes + other.main_memory_bytes,
            bound=dom.bound,
            mapping=dom.mapping if dom.mapping is not None else sub.mapping,
        )


ZERO = OpResult("zero", 0.0, 0, 0, "overhead")


def _finish(name: str, dev: Device, compute_t: Seconds, mem_t: Seconds,
            flops: Flops, bytes_: Bytes,
            mapping: Optional[Mapping] = None) -> OpResult:
    body: Seconds = max(compute_t, mem_t)  # vector ops pipeline with compute
    lat: Seconds = body + dev.kernel_launch_overhead_s
    if dev.kernel_launch_overhead_s > body:
        bound = "overhead"
    elif compute_t >= mem_t:
        bound = "compute"
    else:
        bound = "memory"
    return OpResult(name, lat, flops, bytes_, bound, mapping)


def matmul(dev: Device, m: int, k: int, n: int, batch: int = 1,
           bytes_a: BytesPerElement = 2, bytes_b: BytesPerElement = 2,
           bytes_out: BytesPerElement = 2, bytes_acc: BytesPerElement = 2,
           b_shared: bool = False, mac_scale: Ratio = 1.0,
           name: str = "matmul") -> OpResult:
    r = matmul_perf(dev, m, k, n, batch=batch, bytes_a=bytes_a,
                    bytes_b=bytes_b, bytes_out=bytes_out, bytes_acc=bytes_acc,
                    b_shared=b_shared, mac_scale=mac_scale)
    return OpResult(name, r.latency + dev.kernel_launch_overhead_s, r.flops,
                    r.main_memory_bytes, r.mapping.bound, r.mapping)


def _vector_time(dev: Device, flops: Flops,
                 special_frac: Ratio = 0.0) -> Seconds:
    """Time for elementwise/reduction work on the vector units.

    special_frac: fraction of operations that are special functions
    (exp/tanh/rsqrt), which run at VectorUnit.special_ratio of peak.
    """
    peak: FlopsPerSecond = dev.peak_vector_flops
    sp: Ratio = dev.core.lane.vector_unit.special_ratio
    return flops * ((1 - special_frac) + special_frac / sp) / peak


def _row_parallel_util(dev: Device, rows: int) -> Ratio:
    """Row-parallel ops (softmax/norms) assign rows to cores: with fewer
    rows than cores, the idle cores cannot help — the paper's Fig. 5d trend
    (throughput drops at extreme reduction dims) comes from exactly this."""
    return min(1.0, rows / dev.core_count)


def softmax(dev: Device, rows: int, cols: int, bytes_in: BytesPerElement = 2,
            bytes_out: BytesPerElement = 2,
            name: str = "softmax") -> OpResult:
    """Row-wise softmax on (rows, cols), online algorithm (one read pass for
    running max+sum, one read+write pass to normalize). If a row's working set
    exceeds the global buffer, the second pass re-reads from main memory."""
    n: Elements = rows * cols
    row_bytes: Bytes = cols * bytes_in
    fits = rows * row_bytes <= dev.global_buffer_bytes
    reads = 1 if fits else 2
    bytes_: Bytes = n * (reads * bytes_in + bytes_out)
    mem_t: Seconds = bytes_ / dev.memory_bandwidth
    flops: Flops = SOFTMAX_FLOPS_PER_ELT * n
    cmp_t: Seconds = _vector_time(dev, flops, special_frac=0.25) \
        / _row_parallel_util(dev, rows)
    return _finish(name, dev, cmp_t, mem_t, flops, bytes_)


def layernorm(dev: Device, rows: int, cols: int,
              bytes_in: BytesPerElement = 2, bytes_out: BytesPerElement = 2,
              name: str = "layernorm") -> OpResult:
    """Welford-style mean/var + normalize; reduction cost grows with cols.

    When one row exceeds the per-core local buffer, partial stats make extra
    trips through the global buffer — this is what makes throughput *drop* at
    extreme reduction dims (paper Fig. 5d) where a roofline model stays flat.
    """
    n: Elements = rows * cols
    bytes_: Bytes = n * (bytes_in + bytes_out)
    mem_t: Seconds = bytes_ / dev.memory_bandwidth
    flops: Flops = LAYERNORM_FLOPS_PER_ELT * n
    cmp_t: Seconds = _vector_time(dev, flops, special_frac=0.05) \
        / _row_parallel_util(dev, rows)
    # cross-tile reduction penalty: rows are strip-mined into col-chunks that
    # fit a core's local buffer; partial (mean, M2) fp32 pairs traverse the GB
    chunk = max(1, dev.core.local_buffer_bytes // (2 * bytes_in))
    n_chunks = -(-cols // chunk)
    if n_chunks > 1:
        part_elems: Elements = rows * n_chunks * 2   # (mean, M2) per chunk
        part_bytes: Bytes = part_elems * FP32_BYTES
        mem_t += 2 * part_bytes / dev.global_buffer_bandwidth
        combine_flops: Flops = rows * n_chunks * 8.0
        cmp_t += _vector_time(dev, combine_flops) \
            / _row_parallel_util(dev, rows)
    return _finish(name, dev, cmp_t, mem_t, flops, bytes_)


def rmsnorm(dev: Device, rows: int, cols: int,
            bytes_in: BytesPerElement = 2, bytes_out: BytesPerElement = 2,
            name: str = "rmsnorm") -> OpResult:
    """RMSNorm: sum-of-squares reduction + x * rsqrt(ms) * g.

    First-class model (no layernorm fudge factors): one fused read pass
    accumulates the sum of squares and normalizes, ~4 flops/element (square-
    accumulate, scale, one rsqrt per row amortized). The chunked-reduction
    penalty is the same mechanism as layernorm's — rows strip-mined into
    col-chunks that fit a core's local buffer — but each chunk carries a
    single fp32 partial (sum of squares) instead of a (mean, M2) pair.
    """
    n: Elements = rows * cols
    bytes_: Bytes = n * (bytes_in + bytes_out)
    mem_t: Seconds = bytes_ / dev.memory_bandwidth
    flops: Flops = RMSNORM_FLOPS_PER_ELT * n
    cmp_t: Seconds = _vector_time(dev, flops, special_frac=0.05) \
        / _row_parallel_util(dev, rows)
    chunk = max(1, dev.core.local_buffer_bytes // (2 * bytes_in))
    n_chunks = -(-cols // chunk)
    if n_chunks > 1:
        part_elems: Elements = rows * n_chunks     # one fp32 partial / chunk
        part_bytes: Bytes = part_elems * FP32_BYTES
        mem_t += 2 * part_bytes / dev.global_buffer_bandwidth
        combine_flops: Flops = rows * n_chunks * 4.0
        cmp_t += _vector_time(dev, combine_flops) \
            / _row_parallel_util(dev, rows)
    return _finish(name, dev, cmp_t, mem_t, flops, bytes_)


def gelu(dev: Device, n_elements: Elements, bytes_in: BytesPerElement = 2,
         bytes_out: BytesPerElement = 2, name: str = "gelu") -> OpResult:
    """tanh-approximated GELU: ~10 flops/element, half special."""
    bytes_: Bytes = n_elements * (bytes_in + bytes_out)
    mem_t: Seconds = bytes_ / dev.memory_bandwidth
    flops: Flops = GELU_FLOPS_PER_ELT * n_elements
    cmp_t: Seconds = _vector_time(dev, flops, special_frac=0.5)
    return _finish(name, dev, cmp_t, mem_t, flops, bytes_)


def silu_mul(dev: Device, n_elements: Elements,
             bytes_in: BytesPerElement = 2, bytes_out: BytesPerElement = 2,
             name: str = "silu_mul") -> OpResult:
    """SwiGLU gate: silu(a) * b — reads two operands."""
    bytes_: Bytes = n_elements * (2 * bytes_in + bytes_out)
    mem_t: Seconds = bytes_ / dev.memory_bandwidth
    flops: Flops = SILU_MUL_FLOPS_PER_ELT * n_elements
    cmp_t: Seconds = _vector_time(dev, flops, special_frac=0.4)
    return _finish(name, dev, cmp_t, mem_t, flops, bytes_)


def elementwise(dev: Device, n_elements: Elements,
                flops_per_elt: FlopsPerElement = 1.0, n_in: int = 1,
                bytes_elt: BytesPerElement = 2,
                name: str = "elementwise") -> OpResult:
    bytes_: Bytes = n_elements * (n_in + 1) * bytes_elt
    mem_t: Seconds = bytes_ / dev.memory_bandwidth
    flops: Flops = flops_per_elt * n_elements
    cmp_t: Seconds = _vector_time(dev, flops)
    return _finish(name, dev, cmp_t, mem_t, flops, bytes_)


def fused_epilogue(dev: Device, spec: object) -> Tuple[Seconds, Flops]:
    """(seconds, flops) an op adds when fused into a producing matmul's
    epilogue.

    The epilogue runs tile-by-tile on the vector units after the GEMM
    mainloop: its input arrives in on-chip buffers (no HBM read), its
    launch overhead is amortized into the GEMM's, and — by the fusion
    pass's construction — its output write replaces the GEMM's C write
    (already repriced via the fused spec's bytes_out). What remains is the
    vector-unit compute, with the same special-function ratios and
    row-parallel utilization as the standalone models; softmax runs its
    online single-pass form by construction (the flash-attention trick), so
    the spill second-read never happens.
    """
    from .ir import ElementwiseSpec, NormSpec, SoftmaxSpec
    if isinstance(spec, SoftmaxSpec):
        n: Elements = spec.rows * spec.cols
        flops: Flops = SOFTMAX_FLOPS_PER_ELT * n
        return (_vector_time(dev, flops, special_frac=0.25)
                / _row_parallel_util(dev, spec.rows), flops)
    if isinstance(spec, NormSpec):
        rate: FlopsPerElement = (LAYERNORM_FLOPS_PER_ELT
                                 if spec.kind == "layernorm"
                                 else RMSNORM_FLOPS_PER_ELT)
        nn: Elements = spec.rows * spec.cols
        nflops: Flops = rate * nn
        return (_vector_time(dev, nflops, special_frac=0.05)
                / _row_parallel_util(dev, spec.rows), nflops)
    if isinstance(spec, ElementwiseSpec):
        if spec.kind == "gelu":
            gflops: Flops = GELU_FLOPS_PER_ELT * spec.n_elements
            return _vector_time(dev, gflops, special_frac=0.5), gflops
        if spec.kind == "silu_mul":
            sflops: Flops = SILU_MUL_FLOPS_PER_ELT * spec.n_elements
            return _vector_time(dev, sflops, special_frac=0.4), sflops
        eflops: Flops = spec.flops_per_elt * spec.n_elements
        return _vector_time(dev, eflops), eflops
    raise TypeError(f"cannot fuse {type(spec).__name__} as an epilogue")


def memory_traffic(dev: Device, bytes_: Bytes, name: str = "io") -> OpResult:
    """Pure data movement (e.g. KV-cache append, embedding gather)."""
    mem_t: Seconds = bytes_ / dev.memory_bandwidth
    return _finish(name, dev, 0.0, mem_t, 0.0, bytes_)


def recurrent_scan(dev: Device, seq: int, batch: int, d_state: float,
                   flops_per_step: float, bytes_io: Bytes,
                   chunk: int = 128, name: str = "scan") -> OpResult:
    """Linear-recurrence scan (RWKV6 WKV / RG-LRU) — paper-model extension.

    Modeled as a chunked scan: inside a chunk the state stays in the local
    buffer (vector compute); between chunks the carry is tiny. IO = stream the
    inputs/outputs once. Not in the paper's operator set (it models dense
    transformer ops).
    """
    mem_t: Seconds = bytes_io / dev.memory_bandwidth
    total_flops: Flops = flops_per_step * seq * batch
    cmp_t: Seconds = _vector_time(dev, total_flops, special_frac=0.2)
    # sequential dependency floor: chunks pipeline across batch*heads, but a
    # single (batch, head) chain is seq/chunk sequential carries deep, one
    # vector-width slice of state per clock
    chain_cycles: Cycles = (seq / chunk) * (
        d_state / max(dev.core.lane.vector_unit.width, 1))
    chain: Seconds = chain_cycles / dev.frequency_hz
    cmp_t = max(cmp_t, chain)
    return _finish(name, dev, cmp_t, mem_t, total_flops, bytes_io)
