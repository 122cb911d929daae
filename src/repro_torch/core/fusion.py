"""Kernel-fusion pass over the dataflow IR.

Pattern-rewrite rules fold elementwise / norm / softmax consumers into their
producing matmul as fused epilogues — the analytical counterpart of what
kernels/matmul's fused dequant epilogue and kernels/flash_attention actually
emit. A fused epilogue's input read and the producer's output write are
elided (the tile stays in on-chip buffers); the epilogue contributes only
its vector-unit compute time, which the fused kernel pays after the GEMM
mainloop tile-by-tile. The flash rule goes one step further: a fused-softmax
result whose sole consumer is another matmul is streamed on-chip into that
GEMM's A operand (`bytes_a=0`), so the attention-score matrix never touches
HBM at all — flash-attention's defining property.

The pass is a pure Graph -> Graph rewrite: it never looks at a Device, so
fused graphs memoize exactly like built ones, and the evaluator's spec-level
cache dedups fused kernels across plans and KV depths. `fuse()` iterates the
rules to a fixpoint, so it is idempotent: fuse(fuse(g)) == fuse(g) (tested).

Honesty line: the flash rule's `bytes_a=0` removes the A stream from BOTH
the mapper's HBM-traffic terms (correct — the scores never leave the chip)
and its on-chip buffer-residency masks (optimistic — a real flash kernel
still stages one score subtile in SRAM while it streams). The error is one
subtile of residency, second-order next to the elided traffic; a dedicated
residency-only width on MatmulShape would remove it at the cost of an 11th
mapper axis.

`FusionPolicy` is the execution-model knob threaded through
inference_model / planner / simulator / study (a Study grid axis): which
fusion rules run, and whether evaluation prices the dataflow schedule
(comm/compute overlap, core/schedule.py) or the seed's serial sum. The
default SERIAL policy is the identity — bit-for-bit the seed numbers.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

from .ir import (ElementwiseSpec, FusedMatmulSpec, Graph, MatmulSpec, Node,
                 NormSpec, OpSpec, SoftmaxSpec)
from .units import Bytes, BytesPerElement, Elements


@dataclass(frozen=True)
class FusionPolicy:
    """Execution-model point: fusion rules + schedule mode.

    fuse_epilogues — fold elementwise/norm/softmax consumers into their
        producing matmul (HBM round-trip of the intermediate elided);
    flash_stream  — stream a fused-softmax output straight into its consumer
        GEMM's A operand (flash-attention; requires fuse_epilogues);
    overlap       — price graphs with the resource-timeline list scheduler
        (comm/compute overlap) instead of the serial sum.
    """
    fuse_epilogues: bool = False
    flash_stream: bool = False
    overlap: bool = False

    def __post_init__(self):
        if self.flash_stream and not self.fuse_epilogues:
            raise ValueError("flash_stream streams a *fused* softmax into "
                             "the consumer GEMM; enable fuse_epilogues too")

    @property
    def fuses(self) -> bool:
        return self.fuse_epilogues or self.flash_stream


SERIAL = FusionPolicy()                                   # seed-exact
FUSED = FusionPolicy(fuse_epilogues=True, flash_stream=True)
OVERLAP = FusionPolicy(overlap=True)
FULL = FusionPolicy(fuse_epilogues=True, flash_stream=True, overlap=True)

_PRESET_TAGS = {SERIAL: "serial", FUSED: "fused", OVERLAP: "overlap",
                FULL: "fused+overlap"}


def fusion_tag(policy: FusionPolicy) -> str:
    """Row label for a policy: preset name or a structural tag."""
    tag = _PRESET_TAGS.get(policy)
    if tag is not None:
        return tag
    parts = [p for p, on in [("epi", policy.fuse_epilogues),
                             ("flash", policy.flash_stream),
                             ("overlap", policy.overlap)] if on]
    return "+".join(parts) if parts else "serial"


# ---------------------------------------------------------------------------
# pattern matching helpers
# ---------------------------------------------------------------------------

def _out_elems(spec: OpSpec) -> Optional[Elements]:
    """Elements the node's output tensor holds (None: not fusible over)."""
    if isinstance(spec, MatmulSpec):
        return float(spec.batch * spec.m * spec.n)
    if isinstance(spec, FusedMatmulSpec):
        return _out_elems(spec.epilogue[-1])
    if isinstance(spec, (SoftmaxSpec, NormSpec)):
        return float(spec.rows * spec.cols)
    if isinstance(spec, ElementwiseSpec):
        return float(spec.n_elements)
    return None


def _in_elems(spec: OpSpec) -> Optional[Elements]:
    """Elements the node reads from its (sole) producer tensor."""
    if isinstance(spec, (SoftmaxSpec, NormSpec)):
        return float(spec.rows * spec.cols)
    if isinstance(spec, ElementwiseSpec):
        n_in = 2 if spec.kind == "silu_mul" else spec.n_in
        return float(spec.n_elements * n_in)
    return None


def _out_write_bytes(spec: OpSpec) -> Bytes:
    """Bytes the epilogue's output tensor writes to main memory."""
    if isinstance(spec, (SoftmaxSpec, NormSpec)):
        return spec.rows * spec.cols * spec.bytes_out
    if isinstance(spec, ElementwiseSpec):
        return spec.n_elements * spec.bytes_elt
    raise TypeError(f"not an epilogue spec: {type(spec).__name__}")


def _epilogue_ok(spec: OpSpec) -> bool:
    return isinstance(spec, (SoftmaxSpec, NormSpec, ElementwiseSpec))


def _rescaled(gemm: MatmulSpec, out_bytes: Bytes) -> MatmulSpec:
    """The effective mapper shape once the kernel writes `out_bytes` instead
    of its own C tensor (byte widths are per-element multipliers, so the
    rescale is exact even for fractional widths)."""
    c_elems: Elements = gemm.batch * gemm.m * gemm.n
    width: BytesPerElement = out_bytes / c_elems if c_elems else 0.0
    return replace(gemm, bytes_out=width)


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

def _fuse_once(nodes: List[Node], edges: List[Tuple[int, ...]],
               policy: FusionPolicy) -> bool:
    """Apply the first matching rewrite in graph order. Mutates `nodes` and
    `edges` in place (removed nodes become None); returns True if rewritten.
    """
    n = len(nodes)
    consumers: List[List[int]] = [[] for _ in range(n)]
    for j in range(n):
        if nodes[j] is None:
            continue
        for d in edges[j]:
            consumers[d].append(j)

    for i in range(n):
        node = nodes[i]
        if node is None:
            continue
        spec = node.spec

        # -- rule 1: matmul (+existing epilogue) absorbs its sole consumer --
        if isinstance(spec, (MatmulSpec, FusedMatmulSpec)) \
                and not (isinstance(spec, FusedMatmulSpec) and spec.stream_out):
            cons = consumers[i]
            if len(cons) == 1:
                j = cons[0]
                nj = nodes[j]
                if _epilogue_ok(nj.spec) and edges[j] == (i,) \
                        and nj.repeat == node.repeat \
                        and _in_elems(nj.spec) == _out_elems(spec):
                    gemm = spec.gemm if isinstance(spec, FusedMatmulSpec) \
                        else spec
                    epi = (spec.epilogue if isinstance(spec, FusedMatmulSpec)
                           else ()) + (nj.spec,)
                    # HBM bytes this absorption removes, per instance: the
                    # producer's current effective output write plus the
                    # epilogue's serial input read (its own output write
                    # becomes the fused kernel's write, so it cancels)
                    prev: Bytes = spec.elided \
                        if isinstance(spec, FusedMatmulSpec) else 0.0
                    saved: Bytes = (gemm.batch * gemm.m * gemm.n
                                    * gemm.bytes_out
                                    + _in_read_bytes(nj.spec))
                    fused = FusedMatmulSpec(
                        _rescaled(gemm, _out_write_bytes(nj.spec)), epi,
                        elided=prev + saved)
                    nodes[i] = Node(fused, f"{node.name}+{nj.name}",
                                    node.repeat, node.deps)
                    # rewire: j's consumers now read the fused node
                    for k in range(j + 1, n):
                        if nodes[k] is None:
                            continue
                        edges[k] = tuple(i if d == j else d
                                         for d in edges[k])
                    nodes[j] = None
                    return True

        # -- rule 2 (flash): fused softmax streamed into the consumer GEMM --
        if policy.flash_stream and isinstance(spec, FusedMatmulSpec) \
                and not spec.stream_out \
                and isinstance(spec.epilogue[-1], SoftmaxSpec):
            cons = consumers[i]
            if len(cons) == 1:
                j = cons[0]
                nj = nodes[j]
                mj = nj.spec
                if isinstance(mj, MatmulSpec) and nj.repeat == node.repeat \
                        and float(mj.batch * mj.m * mj.k) == _out_elems(spec):
                    # streaming removes the producer's remaining effective
                    # write AND the consumer GEMM's activation read
                    g0 = spec.gemm
                    streamed: Bytes = (g0.batch * g0.m * g0.n * g0.bytes_out
                                       + mj.batch * mj.m * mj.k * mj.bytes_a)
                    nodes[i] = Node(
                        FusedMatmulSpec(_rescaled(spec.gemm, 0.0),
                                        spec.epilogue, stream_out=True,
                                        elided=spec.elided + streamed),
                        node.name, node.repeat, node.deps)
                    nodes[j] = Node(replace(mj, bytes_a=0), nj.name,
                                    nj.repeat, nj.deps)
                    return True
    return False


@functools.lru_cache(maxsize=4096)
def fuse(graph: Graph, policy: FusionPolicy = SERIAL) -> Graph:
    """Rewrite `graph` under `policy`'s fusion rules (identity for SERIAL /
    OVERLAP). Deterministic, cached, idempotent: re-running on its own
    output finds no new patterns."""
    if not policy.fuses:
        return graph
    nodes: List[Optional[Node]] = list(graph.nodes)
    edges = graph.edges()
    while _fuse_once(nodes, edges, policy):
        pass
    # compact: drop removed nodes, remap all (now explicit) edges
    remap, kept = {}, []
    for i, nd in enumerate(nodes):
        if nd is not None:
            remap[i] = len(kept)
            kept.append((nd, edges[i]))
    return Graph(tuple(Node(nd.spec, nd.name, nd.repeat,
                            tuple(remap[d] for d in deps))
                       for nd, deps in kept))


def _in_read_bytes(spec: OpSpec) -> Bytes:
    """Bytes the epilogue op would read from main memory when not fused."""
    if isinstance(spec, (SoftmaxSpec, NormSpec)):
        return spec.rows * spec.cols * spec.bytes_in
    if isinstance(spec, ElementwiseSpec):
        n_in = 2 if spec.kind == "silu_mul" else spec.n_in
        return spec.n_elements * n_in * spec.bytes_elt
    raise TypeError(f"not an epilogue spec: {type(spec).__name__}")


def elided_bytes(graph: Graph, fused: Graph) -> Bytes:
    """Main-memory traffic the fusion rewrite removed, by spec accounting
    (producer output writes + epilogue input reads + streamed outputs).

    Each rewrite in `_fuse_once` now records its per-instance savings in
    `FusedMatmulSpec.elided`, so this is a straight sum over the fused
    graph — the identical numbers the attribution reports (core/obs.py)
    surface per op, with no second derivation that could drift. `graph` is
    kept in the signature for call-site symmetry (and so a non-fusing
    policy trivially reports 0). The evaluator's per-kernel totals remain
    the ground truth (the mapper may also re-tile the cheaper fused
    shape)."""
    del graph  # savings live on the fused specs themselves
    total: Bytes = 0.0
    for node in fused:
        s = node.spec
        if isinstance(s, FusedMatmulSpec):
            total += node.repeat * s.elided
    return total
