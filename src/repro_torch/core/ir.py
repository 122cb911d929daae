"""Symbolic operator IR: describe the computation, evaluate it later.

The seed code called the operator performance models (operators.py) eagerly
while walking the model graph, so every planner candidate and every KV sample
point re-paid the full cost-model walk. This module splits "what computation
happens" from "how long it takes on a device": graph.py builds a Graph of
hashable OpSpec nodes, and evaluator.Evaluator turns a Graph (or many Graphs)
into latencies — deduplicating identical specs, memoizing results, and
batching the vectorized mapper search over unique matmul shapes.

Design rules:
  * every spec is a frozen, hashable dataclass — specs ARE cache keys;
  * specs carry no device/system state: the same Graph can be evaluated on
    any hardware description;
  * a Node pairs a spec with a display name (for breakdowns) and a repeat
    count — the n identical transformer layers of a stage become one node
    with repeat=n, exactly mirroring the seed's evaluate-once-multiply path.

Dataflow edges: a Graph is a DAG, not just an
ordered list. Each Node carries `deps`, the indices of its producers within
the Graph. `deps=None` means "the previous node" — so a graph built without
explicit edges is a pure chain whose scheduled latency equals the serial
sum bit-for-bit, recovering the pre-DAG behavior exactly. Every spec kind
occupies one of three device resources (`resource_of`): the systolic/MXU
datapath ("compute"), the vector/SIMD units + HBM streaming ("vector"), or
the interconnect ("link"); core/schedule.py places nodes on per-resource
timelines to price comm/compute overlap.

The PyTorch port's copy of the JAX package's IR, whole.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Tuple, Union

from .units import Bytes, BytesPerElement, Elements, FlopsPerElement, Ratio


@dataclass(frozen=True)
class MatmulSpec:
    """C[M,N] = A[M,K] @ B[K,N], `batch` independent instances.

    Evaluated through the mapper's tiling/scheduling search (mapper.py);
    unique shapes across a whole sweep are solved in one batched search.

    Per-operand byte widths: A (activations), B (weights or KV
    cache), C (output activations), and the accumulator width the partials
    are staged at in on-chip buffers. `mac_scale` is the systolic issue rate
    relative to the fp16 datapath (precision.mac_scale; power of two).
    Widths may be fractional for sub-byte types (int4 -> 0.5).
    """
    m: int
    k: int
    n: int
    batch: int = 1
    bytes_a: BytesPerElement = 2
    bytes_b: BytesPerElement = 2
    bytes_out: BytesPerElement = 2
    bytes_acc: BytesPerElement = 2
    b_shared: bool = False
    mac_scale: Ratio = 1.0

    @property
    def shape(self) -> Tuple[int, int, int, int, float, float, float,
                             float, bool, float]:
        """The mapper's MatmulShape tuple for this spec."""
        return (self.m, self.k, self.n, self.batch, self.bytes_a,
                self.bytes_b, self.bytes_out, self.bytes_acc, self.b_shared,
                self.mac_scale)


@dataclass(frozen=True)
class SoftmaxSpec:
    """Row-wise online softmax over (rows, cols)."""
    rows: int
    cols: int
    bytes_in: BytesPerElement = 2
    bytes_out: BytesPerElement = 2


@dataclass(frozen=True)
class NormSpec:
    """layernorm (Welford mean/var) or rmsnorm (sum-of-squares) over rows."""
    kind: str                       # "layernorm" | "rmsnorm"
    rows: int
    cols: int
    bytes_in: BytesPerElement = 2
    bytes_out: BytesPerElement = 2


@dataclass(frozen=True)
class ElementwiseSpec:
    """Pointwise map. kind selects the specialised model:
    "gelu" (tanh approx), "silu_mul" (SwiGLU gate, 2 inputs), or "generic"
    (flops_per_elt flops, n_in operand streams)."""
    kind: str                       # "generic" | "gelu" | "silu_mul"
    n_elements: Elements
    flops_per_elt: FlopsPerElement = 1.0
    n_in: int = 1
    bytes_elt: BytesPerElement = 2


@dataclass(frozen=True)
class ScanSpec:
    """Linear-recurrence scan (RWKV6 WKV / RG-LRU) — an extension op."""
    seq: int
    batch: int
    d_state: float
    flops_per_step: float
    bytes_io: Bytes
    chunk: int = 128


@dataclass(frozen=True)
class CollectiveSpec:
    """Device-device communication primitive under the LogGP link model.

    n_bytes follows each primitive's convention in interconnect.py (e.g. the
    full gathered size for all_gather). n_devices is the participating group
    size, NOT the system size — the evaluator supplies the link parameters.
    bytes_elt is the element width of the payload: all_reduce prices its
    reduction vector work at the collective's actual element count
    (n_bytes / bytes_elt adds) instead of assuming 2-byte elements.
    """
    kind: str     # "all_reduce" | "reduce_scatter" | "all_gather" | "all_to_all" | "p2p"
    n_bytes: Bytes
    n_devices: int = 0              # 0 -> whole system
    bytes_elt: BytesPerElement = 2


@dataclass(frozen=True)
class TrafficSpec:
    """Pure main-memory data movement (KV append, embedding gather)."""
    n_bytes: Bytes


@dataclass(frozen=True)
class FusedMatmulSpec:
    """A matmul with elementwise/norm/softmax consumers fused as epilogues
    (core/fusion.py): the intermediate tensor never round-trips HBM.

    `gemm` is the *effective* mapper shape — its bytes_out is already
    rescaled to the bytes the fused kernel actually writes (the final
    epilogue's output; 0 when `stream_out` hands the result straight to the
    next GEMM, flash-attention style). `epilogue` ops contribute only their
    vector-unit compute time: their input reads and intermediate writes are
    elided, exactly what kernels/flash_attention and kernels/matmul's fused
    dequant epilogues do on real hardware.

    `elided` records the HBM bytes this fusion removed relative to the
    serial graph (intermediate writes + epilogue re-reads, and for
    stream_out also the consumer GEMM's activation read), accumulated by
    the fusion rewrites per instance of this node. It is the single source
    of truth for fusion savings: both `fusion.elided_bytes` and the
    attribution reports (core/obs.py) sum it rather than re-deriving
    traffic deltas.
    """
    gemm: MatmulSpec
    epilogue: Tuple["OpSpec", ...]
    stream_out: bool = False
    elided: Bytes = 0.0


OpSpec = Union[MatmulSpec, SoftmaxSpec, NormSpec, ElementwiseSpec, ScanSpec,
               CollectiveSpec, TrafficSpec, FusedMatmulSpec]


def resource_of(spec: OpSpec) -> str:
    """The device resource a spec occupies while executing:
    "compute" (systolic/MXU datapath), "link" (interconnect), or "vector"
    (vector units + HBM streaming) for everything else."""
    if isinstance(spec, (MatmulSpec, FusedMatmulSpec)):
        return "compute"
    if isinstance(spec, CollectiveSpec):
        return "link"
    return "vector"


@dataclass(frozen=True)
class Node:
    """One IR node: a spec, a breakdown name, a repeat multiplier, and its
    producer edges.

    `deps` are indices of this node's producers within the owning Graph.
    `deps=None` (the default) means "the immediately preceding node" — the
    chain — so graphs built without explicit edges keep the exact serial
    semantics of the pre-DAG IR. `deps=()` marks a source node.
    """
    spec: OpSpec
    name: str
    repeat: int = 1
    deps: Optional[Tuple[int, ...]] = None

    @property
    def resource(self) -> str:
        return resource_of(self.spec)


def _shift(node: Node, offset: int) -> Node:
    if node.deps is None or offset == 0:
        return node
    return Node(node.spec, node.name, node.repeat,
                tuple(d + offset for d in node.deps))


@dataclass(frozen=True)
class Graph:
    """A dataflow computation: a tuple of Nodes with producer edges.

    Node order is a valid topological order (deps always point backwards) and
    fixes the float-summation order of serial totals — a pure chain evaluates
    bit-for-bit like the seed eager path. Concatenation (`+`, and
    GraphBuilder.extend) chains across the seam: the first node of the second
    graph depends on the last node of the first, matching both the serial
    semantics and the residual-stream dataflow of stacked layers.
    """
    nodes: Tuple[Node, ...] = ()

    def __iter__(self) -> Iterator[Node]:
        return iter(self.nodes)

    def __len__(self) -> int:
        return len(self.nodes)

    def __add__(self, other: "Graph") -> "Graph":
        off = len(self.nodes)
        return Graph(self.nodes + tuple(_shift(n, off) for n in other.nodes))

    def scaled(self, repeat: int, prefix: str = "") -> "Graph":
        """Multiply every node's repeat (identical layers -> one node x n)."""
        return Graph(tuple(Node(n.spec, prefix + n.name, n.repeat * repeat,
                                n.deps)
                           for n in self.nodes))

    def specs(self) -> List[OpSpec]:
        return [n.spec for n in self.nodes]

    def edges(self) -> List[Tuple[int, ...]]:
        """Resolved producer edges per node: explicit `deps` where given,
        else the chain (previous node). Validates topological order."""
        out: List[Tuple[int, ...]] = []
        for i, n in enumerate(self.nodes):
            deps = ((i - 1,) if i else ()) if n.deps is None else n.deps
            if any(d >= i or d < 0 for d in deps):
                raise ValueError(
                    f"node {i} ({n.name!r}) has a forward/negative dep "
                    f"{deps}; deps must point at earlier nodes")
            out.append(deps)
        return out

    def consumers(self) -> List[List[int]]:
        """Inverse of edges(): for each node, who reads its output."""
        cons: List[List[int]] = [[] for _ in self.nodes]
        for i, deps in enumerate(self.edges()):
            for d in deps:
                cons[d].append(i)
        return cons


class GraphBuilder:
    """Mutable accumulator for Graph construction.

    `add` returns the new node's index so builders can wire explicit
    producer->consumer edges (`deps=`); omitting deps chains to the
    previous node.
    """

    def __init__(self) -> None:
        self._nodes: List[Node] = []

    def __len__(self) -> int:
        return len(self._nodes)

    def add(self, spec: OpSpec, name: str, repeat: int = 1,
            deps: Optional[Tuple[int, ...]] = None) -> int:
        self._nodes.append(Node(spec, name, repeat, deps))
        return len(self._nodes) - 1

    def extend(self, graph_or_nodes: Union[Graph, Iterable[Node]]
               ) -> "GraphBuilder":
        off = len(self._nodes)
        self._nodes.extend(_shift(n, off) for n in graph_or_nodes)
        return self

    def build(self) -> Graph:
        return Graph(tuple(self._nodes))
