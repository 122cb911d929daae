"""Workload value types: the "what are we serving" axis of a Study.

A Workload is a frozen, hashable description of one inference traffic shape:
`batch` concurrent requests of `in_len` prompt tokens generating `out_len`
output tokens, with the decode-KV trapezoid integrated over `samples` points
(inference_model.generate). Because it is a value type it can key dicts,
deduplicate across grids, and live inside a frozen study.Case.

Request-level traffic: a `Trace` is a fixed sequence of timed
requests (Poisson/gamma arrivals or an explicit list, each with its own
in/out lengths), and a `TrafficWorkload` wraps a Trace plus an engine shape
(slot count, batching policy) so a Study grid can sweep systems x schedulers
x traces through `core/simulator.py` (stage="serve").

Presets cover the paper's six in/out evaluation shapes (Table IV / Fig. 10:
256/256, 512/1024, 1024/1024, 2048/256, 256/2048, 2048/2048 at batch 16)
and the repository's serving shapes.

The precision axis: `PRECISION_POLICIES` re-exports the named
quantization points (core/precision.py) so a grid declares
``Study(..., workloads=WORKLOADS, policies=PRECISION_POLICIES)`` and one
stacked mapper search prices systems x plans x workloads x policies.

The PyTorch port's copy of the JAX package's module, whole.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Sequence, Tuple, Union

import numpy as np

from .precision import POLICIES as PRECISION_POLICIES  # noqa: F401  (axis
#   preset re-export: workload.py is the "grid axes" module users import)


@dataclass(frozen=True)
class Workload:
    """One inference traffic shape: batch x (in_len -> out_len)."""
    batch: int
    in_len: int
    out_len: int
    samples: int = 8        # decode-KV trapezoid sample points in generate()

    @property
    def total_len(self) -> int:
        """Maximum resident context: prompt + every generated token."""
        return self.in_len + self.out_len

    @property
    def tokens_in(self) -> int:
        return self.batch * self.in_len

    @property
    def tokens_out(self) -> int:
        return self.batch * self.out_len

    @property
    def tag(self) -> str:
        return f"b{self.batch}_in{self.in_len}_out{self.out_len}"

    def with_batch(self, batch: int) -> "Workload":
        return replace(self, batch=batch)


# ---------------------------------------------------------------------------
# request-level traffic: traces + the serve-stage Study axis
# ---------------------------------------------------------------------------

#: length spec for synthetic traces: a fixed int or an inclusive (lo, hi)
#: range sampled uniformly per request
LenSpec = Union[int, Tuple[int, int]]


def _sample_len(spec: LenSpec, rng: np.random.Generator) -> int:
    if isinstance(spec, tuple):
        lo, hi = spec
        return int(rng.integers(lo, hi + 1))
    return int(spec)


@dataclass(frozen=True)
class TraceRequest:
    """One timed request: arrives at `arrival` seconds, brings `in_len`
    prompt tokens, and generates exactly `out_len` output tokens."""
    arrival: float
    in_len: int
    out_len: int


@dataclass(frozen=True)
class Trace:
    """A fixed, replayable request sequence (sorted by arrival time)."""
    requests: Tuple[TraceRequest, ...]
    tag: str = ""

    def __post_init__(self):
        arr = [r.arrival for r in self.requests]
        if arr != sorted(arr):
            object.__setattr__(
                self, "requests",
                tuple(sorted(self.requests, key=lambda r: r.arrival)))

    def __len__(self) -> int:
        return len(self.requests)

    def __iter__(self):
        return iter(self.requests)

    @property
    def max_in_len(self) -> int:
        return max((r.in_len for r in self.requests), default=1)

    @property
    def max_total_len(self) -> int:
        return max((r.in_len + r.out_len for r in self.requests), default=1)

    @property
    def tokens_out(self) -> int:
        return sum(r.out_len for r in self.requests)

    # -- constructors ------------------------------------------------------
    @classmethod
    def explicit(cls, requests: Sequence[Tuple[float, int, int]],
                 tag: str = "explicit") -> "Trace":
        return cls(tuple(TraceRequest(*r) for r in requests), tag=tag)

    @classmethod
    def constant(cls, n: int, interval: float, in_len: LenSpec,
                 out_len: LenSpec, seed: int = 0) -> "Trace":
        """Deterministic arrivals every `interval` seconds (interval=0:
        one batch at t=0). Lengths may still be sampled ranges."""
        rng = np.random.default_rng(seed)
        reqs = tuple(TraceRequest(i * interval, _sample_len(in_len, rng),
                                  _sample_len(out_len, rng))
                     for i in range(n))
        return cls(reqs, tag=f"const_n{n}_iv{interval:g}")

    @classmethod
    def poisson(cls, n: int, rate: float, in_len: LenSpec, out_len: LenSpec,
                seed: int = 0) -> "Trace":
        """Poisson arrivals at `rate` requests/second."""
        if rate <= 0:
            raise ValueError("arrival rate must be > 0")
        rng = np.random.default_rng(seed)
        t = np.cumsum(rng.exponential(1.0 / rate, size=n))
        reqs = tuple(TraceRequest(float(t[i]), _sample_len(in_len, rng),
                                  _sample_len(out_len, rng))
                     for i in range(n))
        return cls(reqs, tag=f"poisson_n{n}_r{rate:g}")

    @classmethod
    def gamma(cls, n: int, rate: float, cv: float, in_len: LenSpec,
              out_len: LenSpec, seed: int = 0) -> "Trace":
        """Gamma inter-arrivals: mean 1/rate, coefficient of variation `cv`
        (cv=1 reduces to Poisson; cv>1 is burstier than Poisson; for
        deterministic cv=0 arrivals use Trace.constant)."""
        if rate <= 0:
            raise ValueError("arrival rate must be > 0")
        if cv <= 0:
            raise ValueError("cv must be > 0 (use Trace.constant for "
                             "deterministic arrivals)")
        rng = np.random.default_rng(seed)
        shape = 1.0 / (cv * cv)
        scale = cv * cv / rate
        t = np.cumsum(rng.gamma(shape, scale, size=n))
        reqs = tuple(TraceRequest(float(t[i]), _sample_len(in_len, rng),
                                  _sample_len(out_len, rng))
                     for i in range(n))
        return cls(reqs, tag=f"gamma_n{n}_r{rate:g}_cv{cv:g}")


@dataclass(frozen=True)
class TrafficWorkload(Workload):
    """A Trace served by an engine of `batch` slots under `policy`.

    Subclasses Workload so it slots into the existing Study axes: `batch` is
    the engine slot count and `in_len`/`out_len` are the trace maxima, which
    makes the planner memory-fit pre-pass (`total_len` = worst resident
    context) work unchanged. Use with stage="serve".
    """
    trace: Trace = field(default_factory=lambda: Trace(()))
    policy: str = "continuous"          # scheduler.POLICIES
    kv_samples: int = 8                 # decode-KV interpolation points
    seq_samples: int = 8                # prefill-length interpolation points

    def __post_init__(self):
        from .scheduler import POLICIES     # leaf module, no cycle
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; "
                             f"have {POLICIES}")
        if self.kv_samples < 2 or self.seq_samples < 2:
            # a single sample point would price every round at the axis
            # minimum — grossly wrong whenever the trace spans a range
            raise ValueError("kv_samples and seq_samples must be >= 2")

    @classmethod
    def from_trace(cls, trace: Trace, slots: int,
                   policy: str = "continuous", kv_samples: int = 8,
                   seq_samples: int = 8) -> "TrafficWorkload":
        if not len(trace):
            raise ValueError("trace has no requests")
        return cls(batch=slots, in_len=trace.max_in_len,
                   out_len=max(r.out_len for r in trace),
                   trace=trace, policy=policy, kv_samples=kv_samples,
                   seq_samples=seq_samples)

    @property
    def total_len(self) -> int:
        """Worst-case resident context of any single request."""
        return self.trace.max_total_len if len(self.trace) \
            else super().total_len

    @property
    def tag(self) -> str:
        return f"b{self.batch}_{self.policy}_{self.trace.tag}"


# The paper's six (in_len, out_len) evaluation shapes, in Fig. 10 order.
PAPER_SHAPES: Tuple[Tuple[int, int], ...] = (
    (256, 256), (512, 1024), (1024, 1024),
    (2048, 256), (256, 2048), (2048, 2048))


def paper_workloads(batch: int = 16, samples: int = 8) -> Dict[str, Workload]:
    """The paper's six in/out shapes as named Workloads (Fig. 10: batch 16)."""
    return {f"in{i}_out{o}": Workload(batch, i, o, samples)
            for i, o in PAPER_SHAPES}


# Our serving shapes: the traffic classes the launch/ stack plans for.
SERVING_WORKLOADS: Dict[str, Workload] = {
    "serve-chat": Workload(8, 2048, 256),          # planner probe workload
    "serve-chat-batch64": Workload(64, 2048, 256),  # throughput-heavy chat
    "serve-prefill-32k": Workload(32, 32768, 1),    # prefill_32k shape
    "serve-decode-32k": Workload(16, 32768, 1024),  # decode_32k shape
}

WORKLOADS: Dict[str, Workload] = {
    **{f"paper-{k}": v for k, v in paper_workloads().items()},
    **SERVING_WORKLOADS,
}


def get_workload(name: str) -> Workload:
    try:
        return WORKLOADS[name]
    except KeyError:
        raise KeyError(
            f"unknown workload preset '{name}'; have {sorted(WORKLOADS)}")
