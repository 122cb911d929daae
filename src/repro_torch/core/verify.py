"""Static model verifier: invariant linter over the analytical IR.

The stack's credibility rests on internal consistency — a Graph that drops
bytes at a fusion seam, a Plan whose tp doesn't divide the head count, or a
Schedule that double-books the link timeline would silently corrupt every
number downstream. This module turns those implicit modeling assumptions
into machine-checked contracts: a registry of small pure rules, each
examining one artifact kind (Graph, Plan, PrecisionPolicy, Schedule) and
emitting structured `Diagnostic` records instead of asserting.

Severity model:

  error — the artifact is inconsistent with the cost model's assumptions;
          numbers computed from it are wrong, not just approximate.
  warn  — suspicious but conceivably intended; evaluation proceeds.
  info  — a modeling note (deliberate approximations, known replication).

Mode plumbing — `Evaluator`, `Study`, and `simulator.simulate` accept
``verify="error"|"warn"|"off"`` (default: the REPRO_VERIFY environment
variable, else "warn"):

  off   — skip verification entirely;
  warn  — every diagnostic becomes a `VerificationWarning`; never raises;
  error — error-severity diagnostics raise ONE `VerificationError` listing
          every diagnostic found (CI runs this mode); warn/info still warn.

The schedule rules are a *certificate validator*: scheduler output is
re-checked against the DAG (deps respected, no resource double-booking,
makespan within [max-resource-busy, serial] bounds, pipelined-collective
completion), so a scheduler bug cannot silently ship an impossible timeline.

Adding a rule: write a generator taking the kind's context dataclass and
yielding Diagnostics, decorate with ``@rule("kind.name", kind, summary)``.

The PyTorch port's copy of the JAX package's verifier, whole: its rules and
diagnostics are the JAX package's (tests/test_torch_study.py).
"""
from __future__ import annotations

import math
import os
import warnings
from dataclasses import dataclass
from typing import (TYPE_CHECKING, Any, Callable, Dict, Iterable, Iterator,
                    List, Optional, Sequence, Tuple, TypeVar, get_args)

from .ir import (CollectiveSpec, ElementwiseSpec, FusedMatmulSpec, Graph,
                 MatmulSpec, Node, NormSpec, OpSpec, ScanSpec, SoftmaxSpec,
                 TrafficSpec, resource_of)
from .fusion import (_epilogue_ok, _in_elems, _out_elems, _out_write_bytes)
from .hardware import Device, System
from .precision import DEFAULT, PrecisionPolicy, get_dtype, mac_scale
from .obs import metrics
from .schedule import RESOURCES, Schedule

if TYPE_CHECKING:                                   # annotation-only imports
    from ..configs.base import ModelConfig
    from .graph import Plan

__all__ = [
    "Diagnostic", "VerificationError", "VerificationWarning", "Rule",
    "MODES", "RULES", "rule", "resolve_mode", "apply_mode",
    "graph_diagnostics", "plan_diagnostics", "policy_diagnostics",
    "schedule_diagnostics", "registry_diagnostics",
    "verify_graph", "verify_plan", "verify_policy", "verify_schedule",
    "verify_case",
]

# ---------------------------------------------------------------------------
# diagnostics, errors, modes
# ---------------------------------------------------------------------------

SEVERITIES: Tuple[str, ...] = ("error", "warn", "info")


@dataclass(frozen=True)
class Diagnostic:
    """One finding: which rule fired, how bad, where, and how to fix it."""
    rule: str                       # registry id, e.g. "graph.acyclic"
    severity: str                   # "error" | "warn" | "info"
    message: str
    location: str = ""              # "node 3 ('softmax')", "plan tp=4", ...
    hint: str = ""                  # how to fix it

    def __str__(self) -> str:
        where = f" @ {self.location}" if self.location else ""
        tail = f" (hint: {self.hint})" if self.hint else ""
        return f"{self.severity}[{self.rule}]{where}: {self.message}{tail}"


class VerificationWarning(UserWarning):
    """A diagnostic surfaced in ``verify="warn"`` mode."""


class VerificationError(ValueError):
    """Verification failed: one clean exception listing ALL diagnostics.

    Raised in ``verify="error"`` mode when any error-severity diagnostic is
    present — malformed inputs fail here with every finding attached instead
    of a deep stack trace from the mapper.
    """

    def __init__(self, diagnostics: Sequence[Diagnostic]) -> None:
        ordered = sorted(diagnostics,
                         key=lambda d: SEVERITIES.index(d.severity))
        self.diagnostics: Tuple[Diagnostic, ...] = tuple(ordered)
        counts = {s: sum(1 for d in ordered if d.severity == s)
                  for s in SEVERITIES}
        head = ", ".join(f"{n} {s}{'s' if n != 1 else ''}"
                         for s, n in counts.items() if n)
        body = "\n".join(f"  {d}" for d in ordered)
        super().__init__(f"verification failed: {head}\n{body}")


MODES: Tuple[str, ...] = ("error", "warn", "off")
_ENV_MODE = "REPRO_VERIFY"


def resolve_mode(mode: Optional[str]) -> str:
    """Explicit mode, else $REPRO_VERIFY, else the "warn" default."""
    if mode is None:
        mode = os.environ.get(_ENV_MODE, "warn").strip().lower() or "warn"
    if mode not in MODES:
        raise ValueError(f"verify mode must be one of {MODES}, got {mode!r}")
    return mode


def apply_mode(diagnostics: Sequence[Diagnostic], mode: str,
               stacklevel: int = 3) -> List[Diagnostic]:
    """Enforce `mode` over collected diagnostics (see module docstring)."""
    diags = list(diagnostics)
    for d in diags:     # counted even when mode silences them (core/obs.py)
        metrics().inc(f"verify.diagnostics.{d.severity}")
    if mode == "off" or not diags:
        return diags
    if mode == "error" and any(d.severity == "error" for d in diags):
        raise VerificationError(diags)
    for d in diags:
        warnings.warn(str(d), VerificationWarning, stacklevel=stacklevel)
    return diags


# ---------------------------------------------------------------------------
# the rule registry
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GraphContext:
    """Inputs to graph rules. `device` enables datapath-aware checks."""
    graph: Graph
    device: Optional[Device] = None


@dataclass(frozen=True)
class PlanContext:
    """Inputs to plan-legality rules."""
    system: System
    cfg: "ModelConfig"
    plan: "Plan"
    policy: PrecisionPolicy
    batch: int = 1
    max_len: int = 1
    check_memory: bool = True


@dataclass(frozen=True)
class PolicyContext:
    """Inputs to precision-policy rules."""
    policy: PrecisionPolicy
    device: Optional[Device] = None


@dataclass(frozen=True)
class ScheduleContext:
    """A scheduler run to certify: the DAG, its inputs, and the output."""
    graph: Graph
    latencies: Tuple[float, ...]
    schedule: Schedule
    pipeline_collectives: bool = True


@dataclass(frozen=True)
class Rule:
    """Registry entry: a pure checker over one artifact kind."""
    id: str
    kind: str                       # "graph" | "plan" | "policy" | "schedule"
    summary: str
    check: Callable[[Any], Iterable[Diagnostic]]


RULES: Dict[str, Rule] = {}

_F = TypeVar("_F", bound=Callable[[Any], Iterable[Diagnostic]])

KINDS: Tuple[str, ...] = ("graph", "plan", "policy", "schedule", "registry")


def rule(rule_id: str, kind: str, summary: str) -> Callable[[_F], _F]:
    """Register a checker under `rule_id` (see module docstring)."""
    if kind not in KINDS:
        raise ValueError(f"rule kind must be one of {KINDS}, got {kind!r}")

    def deco(fn: _F) -> _F:
        if rule_id in RULES:
            raise ValueError(f"duplicate rule id {rule_id!r}")
        RULES[rule_id] = Rule(rule_id, kind, summary, fn)
        return fn
    return deco


def _run_rules(kind: str, ctx: object) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    for r in RULES.values():
        if r.kind == kind:
            out.extend(r.check(ctx))
    return out


# ---------------------------------------------------------------------------
# graph rules
# ---------------------------------------------------------------------------

#: every member of the OpSpec union (isinstance target + coverage contract)
_SPEC_KINDS: Tuple[type, ...] = get_args(OpSpec)

#: one minimal instance per spec kind — the resource-coverage contract:
#: adding a kind to OpSpec without a sample here is itself a diagnostic.
_SAMPLE_SPECS: Tuple[OpSpec, ...] = (
    MatmulSpec(1, 1, 1),
    SoftmaxSpec(1, 1),
    NormSpec("rmsnorm", 1, 1),
    ElementwiseSpec("generic", 1),
    ScanSpec(1, 1, 1.0, 1.0, 2.0),
    CollectiveSpec("all_reduce", 2.0),
    TrafficSpec(2.0),
    FusedMatmulSpec(MatmulSpec(1, 1, 1), (SoftmaxSpec(1, 1),)),
)

_NORM_KINDS = ("layernorm", "rmsnorm")
_ELEMENTWISE_KINDS = ("generic", "gelu", "silu_mul")
_COLLECTIVE_KINDS = ("all_reduce", "reduce_scatter", "all_gather",
                     "all_to_all", "p2p")

_REL_TOL = 1e-9


def _loc(i: int, node: Node) -> str:
    return f"node {i} ({node.name!r})"


def _raw_edges(graph: Graph) -> List[Tuple[int, ...]]:
    """Resolved producer edges WITHOUT Graph.edges()'s ValueError — the
    verifier must survive malformed graphs to report them."""
    out: List[Tuple[int, ...]] = []
    for i, n in enumerate(graph.nodes):
        out.append((((i - 1,) if i else ()) if n.deps is None else n.deps))
    return out


def _valid_edges(graph: Graph) -> List[Tuple[int, ...]]:
    """Raw edges restricted to in-range producers (for derived checks)."""
    n = len(graph.nodes)
    return [tuple(d for d in deps if 0 <= d < n and d != i)
            for i, deps in enumerate(_raw_edges(graph))]


def _gemm_of(spec: OpSpec) -> Optional[MatmulSpec]:
    if isinstance(spec, MatmulSpec):
        return spec
    if isinstance(spec, FusedMatmulSpec):
        return spec.gemm
    return None


def _close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=_REL_TOL, abs_tol=0.0)


@rule("graph.producers", "graph",
      "every dep points at an existing, distinct node")
def _check_producers(ctx: GraphContext) -> Iterator[Diagnostic]:
    n = len(ctx.graph.nodes)
    for i, deps in enumerate(_raw_edges(ctx.graph)):
        node = ctx.graph.nodes[i]
        for d in deps:
            if d < 0 or d >= n:
                yield Diagnostic(
                    "graph.producers", "error",
                    f"dep {d} is out of range for a {n}-node graph "
                    f"(dangling producer)", _loc(i, node),
                    "deps must index nodes of the same Graph; check "
                    "GraphBuilder offsets when concatenating")
            elif d == i:
                yield Diagnostic(
                    "graph.producers", "error",
                    "node depends on itself", _loc(i, node),
                    "a node cannot be its own producer")


@rule("graph.acyclic", "graph", "the dataflow graph is a DAG")
def _check_acyclic(ctx: GraphContext) -> Iterator[Diagnostic]:
    nodes = ctx.graph.nodes
    edges = _valid_edges(ctx.graph)
    indeg = [len(deps) for deps in edges]
    consumers: List[List[int]] = [[] for _ in nodes]
    for i, deps in enumerate(edges):
        for d in deps:
            consumers[d].append(i)
    ready = [i for i, k in enumerate(indeg) if k == 0]
    done = 0
    while ready:
        i = ready.pop()
        done += 1
        for c in consumers[i]:
            indeg[c] -= 1
            if indeg[c] == 0:
                ready.append(c)
    if done < len(nodes):
        cyc = [i for i, k in enumerate(indeg) if k > 0]
        names = ", ".join(_loc(i, nodes[i]) for i in cyc[:6])
        yield Diagnostic(
            "graph.acyclic", "error",
            f"dependency cycle through {len(cyc)} nodes: {names}",
            hint="dataflow graphs must be DAGs; break the cycle or drop "
                 "the back edge")


@rule("graph.topo-order", "graph",
      "node order is a topological order (deps point backwards)")
def _check_topo(ctx: GraphContext) -> Iterator[Diagnostic]:
    n = len(ctx.graph.nodes)
    for i, deps in enumerate(_raw_edges(ctx.graph)):
        for d in deps:
            if i < d < n:
                yield Diagnostic(
                    "graph.topo-order", "error",
                    f"dep {d} points forward", _loc(i, ctx.graph.nodes[i]),
                    "Graph node order must be topological: producers before "
                    "consumers (Graph.edges() and the scheduler require it)")


@rule("graph.unconsumed", "graph",
      "every non-terminal node's output is consumed")
def _check_unconsumed(ctx: GraphContext) -> Iterator[Diagnostic]:
    nodes = ctx.graph.nodes
    if len(nodes) < 2:
        return
    consumed = set()
    for deps in _valid_edges(ctx.graph):
        consumed.update(deps)
    for i, node in enumerate(nodes[:-1]):
        if i not in consumed:
            yield Diagnostic(
                "graph.unconsumed", "info",
                "output is never consumed (dead node, or a missing edge)",
                _loc(i, node),
                "wire the consumer's deps, or drop the node")


@rule("graph.resource", "graph",
      "every spec is a known OpSpec kind with a valid resource tag")
def _check_resource(ctx: GraphContext) -> Iterator[Diagnostic]:
    for i, node in enumerate(ctx.graph.nodes):
        if not isinstance(node.spec, _SPEC_KINDS):
            yield Diagnostic(
                "graph.resource", "error",
                f"spec type {type(node.spec).__name__} is not a member of "
                f"ir.OpSpec", _loc(i, node),
                "add the kind to ir.OpSpec, ir.resource_of, the evaluator "
                "dispatch, and verify._SAMPLE_SPECS")
            continue
        res = resource_of(node.spec)
        if res not in RESOURCES:
            yield Diagnostic(
                "graph.resource", "error",
                f"resource_of returned {res!r}, not one of {RESOURCES}",
                _loc(i, node),
                "fix ir.resource_of for this spec kind")


@rule("graph.values", "graph",
      "spec fields are in-range and kind strings are known")
def _check_values(ctx: GraphContext) -> Iterator[Diagnostic]:
    for i, node in enumerate(ctx.graph.nodes):
        loc = _loc(i, node)
        if node.repeat < 1:
            yield Diagnostic(
                "graph.values", "error",
                f"repeat={node.repeat} silently zeroes or negates this "
                f"node's cost", loc, "repeat must be >= 1")
        for spec in _flat_specs(node.spec):
            yield from _spec_value_diags(spec, loc)


def _flat_specs(spec: OpSpec) -> Iterator[OpSpec]:
    if isinstance(spec, FusedMatmulSpec):
        yield spec.gemm
        yield from spec.epilogue
    else:
        yield spec


def _spec_value_diags(spec: OpSpec, loc: str) -> Iterator[Diagnostic]:
    if isinstance(spec, MatmulSpec):
        if min(spec.m, spec.k, spec.n, spec.batch) < 1:
            yield Diagnostic("graph.values", "error",
                             f"non-positive GEMM dims m={spec.m} k={spec.k} "
                             f"n={spec.n} batch={spec.batch}", loc)
        if min(spec.bytes_a, spec.bytes_b, spec.bytes_out,
               spec.bytes_acc) < 0:
            yield Diagnostic("graph.values", "error",
                             "negative operand byte width", loc)
    elif isinstance(spec, (SoftmaxSpec, NormSpec)):
        if min(spec.rows, spec.cols) < 1:
            yield Diagnostic("graph.values", "error",
                             f"non-positive rows={spec.rows} "
                             f"cols={spec.cols}", loc)
        if min(spec.bytes_in, spec.bytes_out) <= 0:
            yield Diagnostic("graph.values", "error",
                             "non-positive element byte width", loc)
        if isinstance(spec, NormSpec) and spec.kind not in _NORM_KINDS:
            yield Diagnostic(
                "graph.values", "error",
                f"unknown norm kind {spec.kind!r} would silently be priced "
                f"as rmsnorm", loc, f"use one of {_NORM_KINDS}")
    elif isinstance(spec, ElementwiseSpec):
        if spec.kind not in _ELEMENTWISE_KINDS:
            yield Diagnostic(
                "graph.values", "error",
                f"unknown elementwise kind {spec.kind!r} would silently be "
                f"priced as generic", loc, f"use one of {_ELEMENTWISE_KINDS}")
        if spec.n_elements < 1 or spec.n_in < 1 or spec.bytes_elt <= 0 \
                or spec.flops_per_elt < 0:
            yield Diagnostic("graph.values", "error",
                             "non-positive elementwise field", loc)
    elif isinstance(spec, CollectiveSpec):
        if spec.kind not in _COLLECTIVE_KINDS:
            yield Diagnostic(
                "graph.values", "error",
                f"unknown collective kind {spec.kind!r} (the evaluator "
                f"raises deep inside interconnect.py)", loc,
                f"use one of {_COLLECTIVE_KINDS}")
        if spec.n_bytes < 0 or spec.n_devices < 0 or spec.bytes_elt <= 0:
            yield Diagnostic("graph.values", "error",
                             "non-positive collective field", loc)
    elif isinstance(spec, TrafficSpec):
        if spec.n_bytes < 0:
            yield Diagnostic("graph.values", "error",
                             f"negative traffic bytes {spec.n_bytes}", loc)
    elif isinstance(spec, ScanSpec):
        if min(spec.seq, spec.batch, spec.chunk) < 1 or spec.d_state <= 0 \
                or spec.flops_per_step < 0 or spec.bytes_io < 0:
            yield Diagnostic("graph.values", "error",
                             "non-positive scan field", loc)


@rule("graph.accumulator", "graph",
      "GEMM accumulators are at least as wide as their operands")
def _check_accumulator(ctx: GraphContext) -> Iterator[Diagnostic]:
    for i, node in enumerate(ctx.graph.nodes):
        gemm = _gemm_of(node.spec)
        if gemm is None:
            continue
        widest = max(gemm.bytes_a, gemm.bytes_b)
        if gemm.bytes_acc < widest:
            yield Diagnostic(
                "graph.accumulator", "error",
                f"accumulator width {gemm.bytes_acc}B is narrower than the "
                f"widest operand ({widest}B): partial sums would lose "
                f"precision the cost model doesn't charge for",
                _loc(i, node),
                "stage partials at >= the operand width (quantized "
                "policies accumulate fp32)")


@rule("graph.mac-scale", "graph",
      "systolic issue-rate scales are positive powers of two")
def _check_mac_scale(ctx: GraphContext) -> Iterator[Diagnostic]:
    for i, node in enumerate(ctx.graph.nodes):
        gemm = _gemm_of(node.spec)
        if gemm is None:
            continue
        s = gemm.mac_scale
        if s <= 0 or not math.log2(s).is_integer():
            yield Diagnostic(
                "graph.mac-scale", "error",
                f"mac_scale={s} is not a positive power of two (the mapper "
                f"divides cycle counts by it exactly)", _loc(i, node),
                "derive it from precision.mac_scale()")


@rule("graph.dataflow", "graph",
      "bytes/elements are conserved across edges and fusion seams")
def _check_dataflow(ctx: GraphContext) -> Iterator[Diagnostic]:
    nodes = ctx.graph.nodes
    edges = _valid_edges(ctx.graph)
    consumers: List[List[int]] = [[] for _ in nodes]
    for i, deps in enumerate(edges):
        for d in deps:
            consumers[d].append(i)

    for i, node in enumerate(nodes):
        spec = node.spec
        loc = _loc(i, node)

        # ---- fused-kernel seams: exact rescale invariants ----------------
        if isinstance(spec, FusedMatmulSpec):
            yield from _fused_diags(spec, loc)
            if spec.stream_out:
                yield from _stream_diags(spec, i, loc, nodes, consumers)

        # ---- a GEMM reading its A operand "for free" needs a streamer ----
        gemm = _gemm_of(spec)
        if gemm is not None and gemm.bytes_a == 0:
            streamers = [d for d in edges[i]
                         if isinstance(nodes[d].spec, FusedMatmulSpec)
                         and nodes[d].spec.stream_out]
            if not streamers:
                yield Diagnostic(
                    "graph.dataflow", "error",
                    "GEMM reads its A operand for free (bytes_a=0) but no "
                    "producer streams it on-chip", loc,
                    "only the flash rule's consumer may set bytes_a=0 "
                    "(paired with a stream_out producer)")

        # ---- general single-producer conservation ------------------------
        # A softmax/elementwise consumer is mid-stream: reading more
        # elements than its sole producer emits means bytes appeared from
        # nowhere (the fusion-seam bug class). A NORM consumer may open a
        # new stream — block-boundary re-normalization (the whisper encoder
        # stack chains after the decoder as an ordering seam; SP shards
        # re-enter at 1/tp the tokens) — so a norm mismatch is only a note.
        if isinstance(spec, (SoftmaxSpec, NormSpec, ElementwiseSpec)) \
                and len(edges[i]) == 1:
            d = edges[i][0]
            prod = nodes[d]
            if prod.repeat != node.repeat:
                continue
            out = _out_elems(prod.spec)
            inn = _in_elems(spec)
            if out is None or inn is None or out <= 0:
                continue
            if inn > out * (1 + _REL_TOL):
                if isinstance(spec, NormSpec):
                    yield Diagnostic(
                        "graph.dataflow", "info",
                        f"norm reads {inn:g} elements but its producer "
                        f"{_loc(d, prod)} outputs {out:g} (block-boundary "
                        f"norms may open a new stream)", loc)
                else:
                    yield Diagnostic(
                        "graph.dataflow", "warn",
                        f"reads {inn:g} elements but its sole producer "
                        f"{_loc(d, prod)} outputs {out:g}", loc,
                        "bytes are not conserved across this edge; check "
                        "the builder's shapes")


def _fused_diags(spec: FusedMatmulSpec, loc: str) -> Iterator[Diagnostic]:
    gemm = spec.gemm
    if not spec.epilogue:
        yield Diagnostic("graph.dataflow", "error",
                         "FusedMatmulSpec with an empty epilogue", loc,
                         "use a plain MatmulSpec instead")
        return
    bad = [type(e).__name__ for e in spec.epilogue if not _epilogue_ok(e)]
    if bad:
        yield Diagnostic(
            "graph.dataflow", "error",
            f"epilogue contains non-epilogue specs: {', '.join(bad)}", loc,
            "only softmax/norm/elementwise ops fuse as epilogues")
        return
    prev_out = float(gemm.batch * gemm.m * gemm.n)
    for k, epi in enumerate(spec.epilogue):
        inn = _in_elems(epi)
        if inn is not None and not _close(inn, prev_out):
            yield Diagnostic(
                "graph.dataflow", "error",
                f"epilogue stage {k} ({type(epi).__name__}) reads {inn:g} "
                f"elements but the previous stage produces {prev_out:g}",
                loc, "fusion requires exact element-count matches "
                     "(fusion._fuse_once checks _in_elems == _out_elems)")
        nxt = _out_elems(epi)
        prev_out = nxt if nxt is not None else prev_out
    c_elems = float(gemm.batch * gemm.m * gemm.n)
    expected = 0.0 if spec.stream_out else _out_write_bytes(spec.epilogue[-1])
    actual = gemm.bytes_out * c_elems
    if not (_close(actual, expected) or actual == expected):
        yield Diagnostic(
            "graph.dataflow", "error",
            f"fused kernel writes {actual:g} bytes but the final epilogue's "
            f"output is {expected:g} bytes (bytes_out rescale broken)", loc,
            "rebuild the effective shape with fusion._rescaled")


def _stream_diags(spec: FusedMatmulSpec, i: int, loc: str,
                  nodes: Tuple[Node, ...],
                  consumers: List[List[int]]) -> Iterator[Diagnostic]:
    cons = consumers[i]
    if not cons:
        yield Diagnostic(
            "graph.dataflow", "error",
            "streams its output on-chip (stream_out) but has no consumer",
            loc, "flash streaming requires the consumer GEMM edge")
        return
    out = _out_elems(spec)
    for c in cons:
        cg = _gemm_of(nodes[c].spec)
        if cg is None:
            yield Diagnostic(
                "graph.dataflow", "error",
                f"streamed output is consumed by non-GEMM "
                f"{_loc(c, nodes[c])}", loc,
                "flash streaming hands the tile to a matmul A operand")
            continue
        if cg.bytes_a != 0:
            yield Diagnostic(
                "graph.dataflow", "error",
                f"consumer {_loc(c, nodes[c])} re-reads the streamed "
                f"operand from HBM (bytes_a={cg.bytes_a})", loc,
                "the flash consumer must set bytes_a=0")
        a_elems = float(cg.batch * cg.m * cg.k)
        if out is not None and not _close(a_elems, out):
            yield Diagnostic(
                "graph.dataflow", "error",
                f"consumer {_loc(c, nodes[c])} A operand holds {a_elems:g} "
                f"elements but the streamed tensor has {out:g}", loc)


@rule("graph.datapath", "graph",
      "operand widths fit the device's native systolic datapath")
def _check_datapath(ctx: GraphContext) -> Iterator[Diagnostic]:
    if ctx.device is None:
        return
    sa = ctx.device.core.lane.systolic_array
    try:
        sa_bits = get_dtype(sa.dtype).bits
    except KeyError:
        yield Diagnostic(
            "graph.datapath", "error",
            f"device {ctx.device.name!r} has an unknown systolic datapath "
            f"dtype {sa.dtype!r}", hint="register it in precision.DTYPES")
        return
    for i, node in enumerate(ctx.graph.nodes):
        gemm = _gemm_of(node.spec)
        if gemm is None:
            continue
        op_bits = max(gemm.bytes_a, gemm.bytes_b) * 8
        if op_bits > sa_bits:
            yield Diagnostic(
                "graph.datapath", "error",
                f"{op_bits:g}-bit GEMM operands on device "
                f"{ctx.device.name!r}'s {sa_bits}-bit {sa.dtype!r} systolic "
                f"datapath: the timing model would silently price it at "
                f"full rate", _loc(i, node),
                "narrow the policy operands or widen the datapath "
                "(hardware.with_mac_dtype)")


# ---------------------------------------------------------------------------
# plan rules
# ---------------------------------------------------------------------------

def _plan_loc(plan: "Plan") -> str:
    sp = ",sp" if plan.sequence_parallel else ""
    return (f"plan tp={plan.tp},pp={plan.pp},dp={plan.dp},"
            f"ep={plan.ep}{sp}")


@rule("plan.devices", "plan",
      "the plan's device grid fits the system")
def _check_devices(ctx: PlanContext) -> Iterator[Diagnostic]:
    used = ctx.plan.devices
    have = ctx.system.device_count
    if used > have:
        yield Diagnostic(
            "plan.devices", "error",
            f"plan needs tp*pp*dp={used} devices but the system has {have}",
            _plan_loc(ctx.plan), "shrink the plan or grow the system")
    elif used < have:
        yield Diagnostic(
            "plan.devices", "info",
            f"plan uses {used} of {have} devices", _plan_loc(ctx.plan))


@rule("plan.tp-heads", "plan",
      "tensor parallelism divides the attention head count")
def _check_tp_heads(ctx: PlanContext) -> Iterator[Diagnostic]:
    cfg, tp = ctx.cfg, ctx.plan.tp
    if tp <= 1 or cfg.n_heads <= 0:
        return
    if cfg.n_heads % tp:
        modeled = max(1, cfg.n_heads // tp) * tp
        yield Diagnostic(
            "plan.tp-heads", "error",
            f"tp={tp} does not divide n_heads={cfg.n_heads}: the graph "
            f"builder would model {modeled} heads and silently drop the "
            f"rest of the attention work", _plan_loc(ctx.plan),
            "choose tp dividing the head count "
            "(planner.enumerate_plans only emits such plans)")


@rule("plan.tp-kv-heads", "plan",
      "tp beyond the KV head count replicates KV (modeled, but noted)")
def _check_tp_kv_heads(ctx: PlanContext) -> Iterator[Diagnostic]:
    cfg, tp = ctx.cfg, ctx.plan.tp
    if 0 < cfg.n_kv_heads < tp:
        yield Diagnostic(
            "plan.tp-kv-heads", "info",
            f"tp={tp} exceeds n_kv_heads={cfg.n_kv_heads}: KV heads "
            f"replicate across tp ranks (compute and per-device KV memory "
            f"are modeled replicated)", _plan_loc(ctx.plan))


@rule("plan.pp-layers", "plan",
      "pipeline stages do not outnumber the layers")
def _check_pp_layers(ctx: PlanContext) -> Iterator[Diagnostic]:
    cfg, pp = ctx.cfg, ctx.plan.pp
    if pp <= 1:
        return
    if pp > cfg.n_layers:
        yield Diagnostic(
            "plan.pp-layers", "error",
            f"pp={pp} exceeds n_layers={cfg.n_layers}: some pipeline "
            f"stages would hold zero layers while the model prices "
            f"ceil-sized stages", _plan_loc(ctx.plan),
            "cap pp at the layer count "
            "(planner.enumerate_plans only emits such plans)")
    elif cfg.n_layers % pp:
        yield Diagnostic(
            "plan.pp-layers", "info",
            f"pp={pp} does not divide n_layers={cfg.n_layers}: stages are "
            f"ceil-sized and the slowest stage is priced",
            _plan_loc(ctx.plan))


@rule("plan.ep-experts", "plan",
      "expert parallelism divides the expert count")
def _check_ep(ctx: PlanContext) -> Iterator[Diagnostic]:
    cfg, plan = ctx.cfg, ctx.plan
    if plan.ep <= 1:
        return
    if cfg.n_experts <= 0:
        yield Diagnostic(
            "plan.ep-experts", "error",
            f"ep={plan.ep} on a dense model (n_experts=0)",
            _plan_loc(plan), "expert parallelism needs experts to shard")
        return
    if cfg.n_experts % plan.ep:
        yield Diagnostic(
            "plan.ep-experts", "error",
            f"ep={plan.ep} does not divide n_experts={cfg.n_experts}: the "
            f"builder would model {max(1, cfg.n_experts // plan.ep) * plan.ep} "
            f"experts and drop the rest", _plan_loc(plan),
            "use a divisor of the expert count (planner uses gcd)")
    if plan.ep > plan.dp:
        yield Diagnostic(
            "plan.ep-experts", "warn",
            f"ep={plan.ep} exceeds dp={plan.dp}: experts would shard over "
            f"more ranks than the data-parallel group has",
            _plan_loc(plan))


@rule("plan.memory", "plan",
      "the model + KV + activations fit per-device memory under the policy")
def _check_memory(ctx: PlanContext) -> Iterator[Diagnostic]:
    if not ctx.check_memory:
        return
    from .inference_model import memory_per_device   # lazy: import cycle
    need = memory_per_device(ctx.cfg, ctx.plan, ctx.batch, ctx.max_len,
                             ctx.policy)
    cap = ctx.system.device.memory_capacity
    if need > cap:
        yield Diagnostic(
            "plan.memory", "error",
            f"needs {need / 2 ** 30:.2f} GiB per device but "
            f"{ctx.system.device.name!r} has {cap / 2 ** 30:.2f} GiB "
            f"(batch={ctx.batch}, max_len={ctx.max_len}, "
            f"policy={ctx.policy.tag})", _plan_loc(ctx.plan),
            "raise tp/pp, shrink the batch/context, or quantize "
            "(weights/kv_cache dtypes)")


# ---------------------------------------------------------------------------
# policy rules
# ---------------------------------------------------------------------------

@rule("policy.accumulator", "policy",
      "the accumulator is at least as wide as every operand class")
def _check_policy_acc(ctx: PolicyContext) -> Iterator[Diagnostic]:
    p = ctx.policy
    widest = max(p.weights.bits, p.activations.bits, p.kv_cache.bits)
    if p.accumulator.bits < widest:
        yield Diagnostic(
            "policy.accumulator", "error",
            f"accumulator {p.accumulator.name} ({p.accumulator.bits}b) is "
            f"narrower than the widest operand class ({widest}b)",
            f"policy {p.tag}",
            "accumulate at >= operand width (quantized presets use fp32)")


@rule("policy.mac-scale", "policy",
      "derived GEMM issue rates are positive powers of two")
def _check_policy_mac(ctx: PolicyContext) -> Iterator[Diagnostic]:
    p = ctx.policy
    for label, a, b in (("activations x weights", p.activations, p.weights),
                        ("activations x kv", p.activations, p.kv_cache)):
        s = mac_scale(a, b)
        if s <= 0 or not math.log2(s).is_integer():
            yield Diagnostic(
                "policy.mac-scale", "error",
                f"mac_scale({label}) = {s} is not a positive power of two",
                f"policy {p.tag}",
                "DType.mac_throughput must be a power of two")


@rule("policy.datapath", "policy",
      "policy operand widths fit the device's native datapath")
def _check_policy_datapath(ctx: PolicyContext) -> Iterator[Diagnostic]:
    if ctx.device is None:
        return
    p = ctx.policy
    sa = ctx.device.core.lane.systolic_array
    try:
        sa_bits = get_dtype(sa.dtype).bits
    except KeyError:
        yield Diagnostic(
            "policy.datapath", "error",
            f"device {ctx.device.name!r} has an unknown systolic datapath "
            f"dtype {sa.dtype!r}", f"policy {p.tag}",
            "register it in precision.DTYPES")
        return
    widest = max(p.weights.bits, p.activations.bits, p.kv_cache.bits)
    if widest > sa_bits:
        yield Diagnostic(
            "policy.datapath", "error",
            f"{widest}-bit operands on device {ctx.device.name!r}'s "
            f"{sa_bits}-bit {sa.dtype!r} systolic datapath: the timing "
            f"model would not stop you, but the numbers would be wrong",
            f"policy {p.tag}",
            "quantize the policy to the datapath width, or price an "
            "fp16-native design (hardware.with_mac_dtype)")


# ---------------------------------------------------------------------------
# schedule certificate rules
# ---------------------------------------------------------------------------

def _sched_eps(ctx: ScheduleContext) -> float:
    return _REL_TOL * max(abs(ctx.schedule.serial), 1e-30)


def _pipelined(ctx: ScheduleContext, i: int,
               deps: Tuple[int, ...]) -> bool:
    return (ctx.pipeline_collectives
            and ctx.schedule.slots[i].resource == "link"
            and isinstance(ctx.graph.nodes[i].spec, CollectiveSpec)
            and bool(deps))


@rule("schedule.deps", "schedule",
      "no slot starts before its producers allow")
def _check_sched_deps(ctx: ScheduleContext) -> Iterator[Diagnostic]:
    slots = ctx.schedule.slots
    eps = _sched_eps(ctx)
    for i, deps in enumerate(_valid_edges(ctx.graph)):
        s = slots[i]
        pipelined = _pipelined(ctx, i, deps)
        for d in deps:
            ready = slots[d].start if pipelined else slots[d].end
            if s.start + eps < ready:
                kind = "starts" if pipelined else "finishes"
                yield Diagnostic(
                    "schedule.deps", "error",
                    f"slot starts at {s.start:g} but its producer "
                    f"{_loc(d, ctx.graph.nodes[d])} only {kind} at "
                    f"{ready:g}", _loc(i, ctx.graph.nodes[i]),
                    "the certificate re-checks scheduler output; this "
                    "schedule violates its own DAG")


@rule("schedule.exclusive", "schedule",
      "no resource timeline is double-booked")
def _check_sched_exclusive(ctx: ScheduleContext) -> Iterator[Diagnostic]:
    eps = _sched_eps(ctx)
    by_res: Dict[str, List[int]] = {}
    for i, s in enumerate(ctx.schedule.slots):
        by_res.setdefault(s.resource, []).append(i)
    for r, idxs in sorted(by_res.items()):
        idxs.sort(key=lambda i: (ctx.schedule.slots[i].start, i))
        for a, b in zip(idxs, idxs[1:]):
            sa, sb = ctx.schedule.slots[a], ctx.schedule.slots[b]
            if sb.start + eps < sa.start + sa.duration:
                yield Diagnostic(
                    "schedule.exclusive", "error",
                    f"{r!r} is double-booked: "
                    f"{_loc(a, ctx.graph.nodes[a])} occupies "
                    f"[{sa.start:g}, {sa.start + sa.duration:g}) but "
                    f"{_loc(b, ctx.graph.nodes[b])} starts at {sb.start:g}",
                    hint="one resource runs one op at a time; occupancy is "
                         "`duration`, not the pipelined `end`")


@rule("schedule.makespan", "schedule",
      "makespan lies in [max resource busy, serial sum]")
def _check_sched_makespan(ctx: ScheduleContext) -> Iterator[Diagnostic]:
    sch = ctx.schedule
    eps = _sched_eps(ctx)
    if sch.slots:
        last = max(s.end for s in sch.slots)
        if abs(sch.makespan - last) > eps:
            yield Diagnostic(
                "schedule.makespan", "error",
                f"recorded makespan {sch.makespan:g} != last completion "
                f"{last:g}")
    max_busy = max(sch.busy.values(), default=0.0)
    if sch.makespan + eps < max_busy:
        yield Diagnostic(
            "schedule.makespan", "error",
            f"makespan {sch.makespan:g} is below the busiest resource's "
            f"occupancy {max_busy:g} — faster than the roofline allows")
    if sch.makespan > sch.serial + eps:
        yield Diagnostic(
            "schedule.makespan", "error",
            f"makespan {sch.makespan:g} exceeds the serial sum "
            f"{sch.serial:g} — the schedule lost time a chain wouldn't")


@rule("schedule.pipelining", "schedule",
      "slot completion matches the (pipelined-)collective model")
def _check_sched_pipelining(ctx: ScheduleContext) -> Iterator[Diagnostic]:
    slots = ctx.schedule.slots
    eps = _sched_eps(ctx)
    for i, deps in enumerate(_valid_edges(ctx.graph)):
        s = slots[i]
        if _pipelined(ctx, i, deps):
            expect = max([s.start + s.duration]
                         + [slots[d].end for d in deps])
        else:
            expect = s.start + s.duration
        if abs(s.end - expect) > eps:
            yield Diagnostic(
                "schedule.pipelining", "error",
                f"slot ends at {s.end:g} but the execution model says "
                f"{expect:g} (pipelined collectives end at "
                f"max(start+duration, producer ends); everything else at "
                f"start+duration)", _loc(i, ctx.graph.nodes[i]))


@rule("schedule.busy", "schedule",
      "per-resource busy accounting matches slot durations")
def _check_sched_busy(ctx: ScheduleContext) -> Iterator[Diagnostic]:
    sch = ctx.schedule
    eps = _sched_eps(ctx)
    totals: Dict[str, float] = {}
    for s in sch.slots:                 # node order = scheduler's sum order
        totals[s.resource] = totals.get(s.resource, 0.0) + s.duration
    for r in sorted(set(totals) | set(sch.busy)):
        a, b = totals.get(r, 0.0), sch.busy.get(r, 0.0)
        if abs(a - b) > eps:
            yield Diagnostic(
                "schedule.busy", "error",
                f"busy[{r!r}] records {b:g}s but slot durations sum to "
                f"{a:g}s")
    serial = 0.0
    for s in sch.slots:
        serial += s.duration
    if abs(serial - sch.serial) > eps:
        yield Diagnostic(
            "schedule.busy", "error",
            f"serial records {sch.serial:g}s but durations sum to "
            f"{serial:g}s")
    if len(sch.slots) != len(ctx.graph.nodes) \
            or len(ctx.latencies) != len(ctx.graph.nodes):
        yield Diagnostic(
            "schedule.busy", "error",
            f"{len(sch.slots)} slots / {len(ctx.latencies)} latencies for "
            f"a {len(ctx.graph.nodes)}-node graph")


# ---------------------------------------------------------------------------
# registry self-checks (the resource-tag coverage contract)
# ---------------------------------------------------------------------------

def registry_diagnostics() -> List[Diagnostic]:
    """`ir.resource_of` must be total over every OpSpec kind: each union
    member needs a sample here, and each sample must map to a known
    resource. Run by the CLI and the test suite."""
    out: List[Diagnostic] = []
    sampled = {type(s) for s in _SAMPLE_SPECS}
    for kind in _SPEC_KINDS:
        if kind not in sampled:
            out.append(Diagnostic(
                "ir.resource-coverage", "error",
                f"OpSpec kind {kind.__name__} has no sample in "
                f"verify._SAMPLE_SPECS: resource coverage is unproven",
                hint="add a minimal instance so the contract stays total"))
    for s in _SAMPLE_SPECS:
        if type(s) not in _SPEC_KINDS:
            out.append(Diagnostic(
                "ir.resource-coverage", "error",
                f"sample {type(s).__name__} is not a member of ir.OpSpec"))
        res = resource_of(s)
        if res not in RESOURCES:
            out.append(Diagnostic(
                "ir.resource-coverage", "error",
                f"resource_of({type(s).__name__}) = {res!r}, not one of "
                f"{RESOURCES}", hint="fix ir.resource_of"))
    return out


# ---------------------------------------------------------------------------
# collectors + public entry points
# ---------------------------------------------------------------------------

def graph_diagnostics(graph: Graph,
                      device: Optional[Device] = None) -> List[Diagnostic]:
    """All graph-rule diagnostics (no mode applied)."""
    return _run_rules("graph", GraphContext(graph, device))


def plan_diagnostics(system: System, cfg: "ModelConfig", plan: "Plan", *,
                     policy: Optional[PrecisionPolicy] = None,
                     batch: int = 1, max_len: int = 1,
                     check_memory: bool = True) -> List[Diagnostic]:
    """All plan-rule diagnostics (no mode applied)."""
    ctx = PlanContext(system, cfg, plan, policy or DEFAULT,
                      batch, max_len, check_memory)
    return _run_rules("plan", ctx)


def policy_diagnostics(policy: PrecisionPolicy,
                       device: Optional[Device] = None) -> List[Diagnostic]:
    """All policy-rule diagnostics (no mode applied)."""
    return _run_rules("policy", PolicyContext(policy, device))


def schedule_diagnostics(graph: Graph, latencies: Sequence[float],
                         schedule: Schedule,
                         pipeline_collectives: bool = True
                         ) -> List[Diagnostic]:
    """All schedule-certificate diagnostics (no mode applied)."""
    ctx = ScheduleContext(graph, tuple(latencies), schedule,
                          pipeline_collectives)
    return _run_rules("schedule", ctx)


def verify_graph(graph: Graph, device: Optional[Device] = None,
                 mode: Optional[str] = None) -> List[Diagnostic]:
    """Lint one Graph; enforce the resolved mode. Returns the diagnostics."""
    m = resolve_mode(mode)
    if m == "off":
        return []
    return apply_mode(graph_diagnostics(graph, device), m)


def verify_plan(system: System, cfg: "ModelConfig", plan: "Plan", *,
                policy: Optional[PrecisionPolicy] = None,
                batch: int = 1, max_len: int = 1, check_memory: bool = True,
                mode: Optional[str] = None) -> List[Diagnostic]:
    """Lint one (system, config, plan) point; enforce the resolved mode."""
    m = resolve_mode(mode)
    if m == "off":
        return []
    diags = plan_diagnostics(system, cfg, plan, policy=policy, batch=batch,
                             max_len=max_len, check_memory=check_memory)
    return apply_mode(diags, m)


def verify_policy(policy: PrecisionPolicy, device: Optional[Device] = None,
                  mode: Optional[str] = None) -> List[Diagnostic]:
    """Lint one PrecisionPolicy (against a device's datapath if given)."""
    m = resolve_mode(mode)
    if m == "off":
        return []
    return apply_mode(policy_diagnostics(policy, device), m)


def verify_schedule(graph: Graph, latencies: Sequence[float],
                    schedule: Schedule, pipeline_collectives: bool = True,
                    mode: Optional[str] = None) -> List[Diagnostic]:
    """Validate a scheduler-output certificate; enforce the resolved mode."""
    m = resolve_mode(mode)
    if m == "off":
        return []
    diags = schedule_diagnostics(graph, latencies, schedule,
                                 pipeline_collectives)
    return apply_mode(diags, m)


def verify_case(case: Any, mode: Optional[str] = None,
                check_memory: bool = False) -> List[Diagnostic]:
    """Lint one study.Case (plan + policy rules; its graphs are linted by
    the Evaluator when the case prices). Memory is off by default: the
    Study's enforce_fits gate owns that decision per-case."""
    m = resolve_mode(mode)
    if m == "off":
        return []
    w = case.workload
    diags = plan_diagnostics(case.system, case.cfg, case.plan,
                             policy=case.policy, batch=w.batch,
                             max_len=w.total_len, check_memory=check_memory)
    diags += policy_diagnostics(case.policy, case.system.device)
    return apply_mode(diags, m)
