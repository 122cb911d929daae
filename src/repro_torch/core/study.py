"""Declarative Study API: the one front-door for design-space sweeps.

The paper's headline workflow is the systems x models x workloads grid
(Sec. V-VII). A `Study` makes that grid the first-class object: declare
cross-products of Systems, ModelConfigs, Plans and Workloads (or an explicit
`Case` list) and `run()` them as one unit. Under the hood the Study

  * owns ONE shared Evaluator per System (spec-level dedup across every case
    that targets it),
  * pre-collects every un-memoized (device, GEMM-shape) pair across the WHOLE
    grid and solves them in one device-axis stacked mapper search
    (`mapper.matmul_perf_batch_multi`) before any case is priced — the
    cross-System analog of the per-call shapes axis,
  * prices die area and cost once per distinct device (area.py / cost.py),
  * applies the planner's memory-fit check before paying for evaluation
    (`enforce_fits=False` to reproduce paper microbenchmarks regardless),
  * serves previously-priced cases from the persistent content-hashed
    CaseResult cache (core/result_cache.py): a rerun of an
    overlapping grid — same process or a later session — re-prices only the
    new cases, bit-identically to the uncached path. serve-stage cases are
    not cached (their SimResult carries full latency distributions); disable
    per Study with `result_cache=False` or globally via REPRO_DISK_CACHE=0.

Every case's numbers are bit-for-bit identical to the single-case seed path
(`inference_model.generate` et al. with a cold Evaluator).

The PyTorch port's copy of the JAX package's Study, whole. Its stacked
mapper search prices candidate tables on `device`: ``"cuda"`` (the default:
the kernel of ``kernels/mapper_tables``, which raises without a card) or
``"cpu"`` (numpy); a Study gives the same rows on both, and the JAX
package's numpy Study's (tests/test_torch_study.py).
"""
from __future__ import annotations

import csv
import io
import math
import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import (Any, Dict, Iterable, Iterator, List, Mapping, Optional,
                    Sequence, Tuple, Union, cast)

from ..configs.base import ModelConfig
from . import area as area_mod
from . import cost as cost_mod
from . import inference_model as im
from .evaluator import Evaluator
from .fusion import FusionPolicy, fuse, fusion_tag
from .fusion import SERIAL as SERIAL_FUSION
from .graph import Plan, build_layer, build_model
from .hardware import Device, System
from .ir import FusedMatmulSpec, Graph, MatmulSpec
from . import mapper
from .mapper import check_device, is_memoized, matmul_perf_batch_multi
from . import obs
from .precision import DEFAULT, PrecisionPolicy, policy_tag
from . import result_cache as result_cache_mod
from .result_cache import MODEL_VERSION, DiskCache, content_key
from . import simulator as sim_mod
from . import verify as verify_mod
from .workload import TrafficWorkload, Workload

#: evaluation stages a Case can request
#:   generate — prefill + decode trapezoid (the end-to-end request metric)
#:   prefill  — one full-model prefill pass at in_len
#:   decode   — one full-model decode step at kv = in_len + out_len
#:   layer    — single-layer prefill AND decode microbenchmark (paper
#:              Table III / Fig. 8 / Fig. 9 convention: prefill at seq=in_len,
#:              decode at kv = in_len + out_len, no lm head, no pipeline fill)
#:   serve    — trace-driven continuous-batching replay (core/simulator.py);
#:              requires a TrafficWorkload (slots + trace + policy)
STAGES = ("generate", "prefill", "decode", "layer", "serve")

#: the Study's CaseResult namespace under the cache root: the port's own, so
#: that it never serves an entry that another package wrote
CASES_NAMESPACE = "torch-cases"


@dataclass(frozen=True)
class Case:
    """One point of the evaluation grid — frozen, hashable, declarative.

    `policy` is the precision axis: it stamps per-operand byte
    widths and compute rates on every graph this case builds, and prices the
    memory-fit gate at quantized weight/KV footprints. (Not to be confused
    with TrafficWorkload.policy, the scheduler policy string.)
    `fusion` is the execution-model axis: which kernel-fusion
    rewrites apply and whether latency is the overlap-scheduled makespan or
    the serial sum. `policy_label` / `fusion_label` name the grid-axis
    points in result rows (default to the preset name / structural tag)."""
    system: System
    cfg: ModelConfig
    plan: Plan
    workload: Workload
    stage: str = "generate"
    label: str = ""
    policy: PrecisionPolicy = DEFAULT
    policy_label: str = ""
    fusion: FusionPolicy = SERIAL_FUSION
    fusion_label: str = ""

    def __post_init__(self):
        if self.stage not in STAGES:
            raise ValueError(f"unknown stage {self.stage!r}; have {STAGES}")
        if not isinstance(self.policy, PrecisionPolicy):
            raise TypeError(
                f"Case.policy must be a precision.PrecisionPolicy, got "
                f"{self.policy!r} — the scheduler policy string "
                f"('continuous'/'static') belongs on the TrafficWorkload")
        if not isinstance(self.fusion, FusionPolicy):
            raise TypeError(f"Case.fusion must be a fusion.FusionPolicy, "
                            f"got {self.fusion!r}")
        if self.stage == "serve" and not isinstance(self.workload,
                                                    TrafficWorkload):
            raise ValueError("stage='serve' needs a TrafficWorkload "
                             "(slots + trace + policy)")

    @property
    def policy_tag(self) -> str:
        """Row name of this case's precision point: the grid-axis label when
        one was given, else the preset name / structural tag."""
        return self.policy_label or policy_tag(self.policy)

    @property
    def fusion_tag(self) -> str:
        """Row name of this case's execution-model point."""
        return self.fusion_label or fusion_tag(self.fusion)


@dataclass(frozen=True)
class CaseResult:
    """Structured result row for one Case (latency in seconds)."""
    case: Case
    latency: float              # stage metric: generate/prefill/decode lat.
    throughput: float           # output tok/s (pipeline-full steady state)
    memory_per_device: float    # bytes, planner memory model
    fits: bool
    dominant: str               # binding resource of the (prefill) breakdown
    decode_dominant: str        # binding resource of the decode step ("layer")
    flops: float
    bytes: float
    prefill_latency: float
    decode_latency: float
    area_mm2: float             # die area of ONE device
    device_cost_usd: float      # manufacturing cost of ONE device
    system_cost_usd: float      # device cost x device_count
    perf_per_dollar: float      # throughput / system_cost_usd
    sim: Optional[sim_mod.SimResult] = None   # serve stage: the full replay
    #: per-op attribution of this case's evaluated graph(s) (core/obs.py);
    #: None for serve-stage cases (the SimResult carries the replay)
    attribution: Optional[obs.Attribution] = None
    #: the primary graph's schedule.critical_breakdown(), largest first:
    #: ((op name | "(stall)", seconds), ...) — queryable straight from CSV
    critical: Tuple[Tuple[str, float], ...] = ()

    def to_row(self) -> dict:
        c = self.case
        w = c.workload
        s = self.sim
        return {
            "label": c.label, "stage": c.stage,
            "device": c.system.device.name,
            "n_devices": c.system.device_count,
            "model": c.cfg.name,
            "policy": c.policy_tag,
            "fusion": c.fusion_tag,
            "tp": c.plan.tp, "pp": c.plan.pp, "dp": c.plan.dp,
            "ep": c.plan.ep, "sp": c.plan.sequence_parallel,
            "batch": w.batch, "in_len": w.in_len, "out_len": w.out_len,
            "latency_s": self.latency,
            "throughput_tok_s": self.throughput,
            "memory_per_device_gib": self.memory_per_device / 2 ** 30,
            "fits": self.fits,
            "dominant_bound": self.dominant,
            "prefill_s": self.prefill_latency,
            "decode_s": self.decode_latency,
            "area_mm2": self.area_mm2,
            "system_cost_usd": self.system_cost_usd,
            "perf_per_usd": self.perf_per_dollar,
            "ttft_p50_s": s.ttft(50) if s else "",
            "ttft_p99_s": s.ttft(99) if s else "",
            "tpot_p50_s": s.tpot(50) if s else "",
            "goodput_tok_s": s.goodput if s else "",
            "elided_bytes": self.attribution.elided
            if self.attribution is not None else "",
            "critical_breakdown": "|".join(
                f"{k}={v:.6g}" for k, v in self.critical),
        }


@dataclass
class StudyStats:
    """Grid-level accounting: what one run() shared and pre-solved."""
    cases: int = 0
    evaluated: int = 0
    skipped_unfit: int = 0
    systems: int = 0
    devices: int = 0
    matmul_pairs_presolved: int = 0   # unique un-memoized (device, shape)
    case_cache_hits: int = 0          # CaseResults served from disk
    case_cache_misses: int = 0        # cacheable cases actually evaluated
    presolve_seconds: float = 0.0
    total_seconds: float = 0.0

    def summary(self) -> str:
        return (f"cases={self.cases} evaluated={self.evaluated} "
                f"skipped_unfit={self.skipped_unfit} "
                f"systems={self.systems} devices={self.devices} "
                f"matmul_pairs_presolved={self.matmul_pairs_presolved} "
                f"case_cache_hits={self.case_cache_hits} "
                f"case_cache_misses={self.case_cache_misses} "
                f"presolve_s={self.presolve_seconds:.2f} "
                f"total_s={self.total_seconds:.2f}")


_OBJECTIVES = {
    "latency": (lambda r: r.latency, False),
    "throughput": (lambda r: r.throughput, True),
    "perf_per_dollar": (lambda r: r.perf_per_dollar, True),
}


class StudyResult:
    """Ordered CaseResult rows + grid stats + the shared evaluators."""

    def __init__(self, results: List[CaseResult], stats: StudyStats,
                 evaluators: Dict[System, Evaluator]) -> None:
        self.results = results
        self.stats = stats
        self.evaluators = evaluators

    def __iter__(self) -> Iterator[CaseResult]:
        return iter(self.results)

    def __len__(self) -> int:
        return len(self.results)

    def __getitem__(self, i) -> CaseResult:
        return self.results[i]

    # -- structured access -------------------------------------------------
    def to_rows(self) -> List[dict]:
        return [r.to_row() for r in self.results]

    def to_csv(self, path: Optional[str] = None) -> str:
        rows = self.to_rows()
        buf = io.StringIO()
        if rows:
            w = csv.DictWriter(buf, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
        text = buf.getvalue()
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def filter(self, **kw) -> List[CaseResult]:
        """Select rows by case attributes: device (name), model (cfg name),
        system, plan, workload, stage, label, policy (a PrecisionPolicy, or
        a string matching the row's policy tag — the grid-axis key / preset
        name / structural tag shown in to_rows()), fusion (a FusionPolicy
        or its tag string), batch, in_len, out_len."""
        def matches(r: CaseResult, key: str, v) -> bool:
            c = r.case
            if key == "policy":
                if isinstance(v, str):
                    return v in (c.policy_tag, policy_tag(c.policy))
                return c.policy == v
            if key == "fusion":
                if isinstance(v, str):
                    return v in (c.fusion_tag, fusion_tag(c.fusion))
                return c.fusion == v
            try:
                return v == {
                    "device": c.system.device.name,
                    "model": c.cfg.name,
                    "system": c.system,
                    "plan": c.plan,
                    "workload": c.workload,
                    "stage": c.stage,
                    "label": c.label,
                    "batch": c.workload.batch,
                    "in_len": c.workload.in_len,
                    "out_len": c.workload.out_len,
                }[key]
            except KeyError:
                raise KeyError(f"unknown filter key {key!r}")

        return [r for r in self.results
                if all(matches(r, k, v) for k, v in kw.items())]

    def get(self, **kw) -> CaseResult:
        hits = self.filter(**kw)
        if len(hits) != 1:
            raise KeyError(f"filter {kw} matched {len(hits)} rows, need 1")
        return hits[0]

    def best(self, objective: str = "latency") -> CaseResult:
        """Best FITTING row under the objective (latency | throughput |
        perf_per_dollar)."""
        try:
            key, maximize = _OBJECTIVES[objective]
        except KeyError:
            raise ValueError(f"unknown objective {objective!r}; "
                             f"have {sorted(_OBJECTIVES)}")
        fitting = [r for r in self.results if r.fits]
        if not fitting:
            raise ValueError("no case fits device memory under any plan")
        return (max if maximize else min)(fitting, key=key)


PlanAxis = Union[str, Sequence[Plan], None]


class Study:
    """Declarative sweep: systems x configs x plans x workloads, or explicit
    cases. Construct, then `run()` once; rerunning reuses the evaluators."""

    def __init__(self,
                 systems: Optional[Sequence[System]] = None,
                 configs: Optional[Sequence[ModelConfig]] = None,
                 plans: PlanAxis = None,
                 workloads: Union[Mapping[str, Workload],
                                  Sequence[Workload], None] = None,
                 policies: Union[Mapping[str, PrecisionPolicy],
                                 Sequence[PrecisionPolicy], None] = None,
                 fusions: Union[Mapping[str, FusionPolicy],
                                Sequence[FusionPolicy], None] = None,
                 cases: Optional[Iterable[Case]] = None,
                 stage: str = "generate",
                 enforce_fits: bool = True,
                 evaluators: Optional[Mapping[System, Evaluator]] = None,
                 result_cache: Optional[bool] = None,
                 verify: Optional[str] = None,
                 device: str = "cuda"
                 ) -> None:
        if cases is not None:
            if any(x is not None for x in (systems, configs, workloads,
                                           policies, fusions)) \
                    or plans is not None:
                raise ValueError("pass either an explicit case list OR grid "
                                 "axes, not both")
            self.cases = list(cases)
        else:
            if not systems or not configs or not workloads:
                raise ValueError("a grid Study needs systems, configs and "
                                 "workloads (plans default to [Plan()], "
                                 "policies to [precision.DEFAULT], fusions "
                                 "to [fusion.SERIAL])")
            self.cases = self._expand(systems, configs, plans, workloads,
                                      policies, fusions, stage)
        self.enforce_fits = enforce_fits
        # where the stacked mapper search runs its candidate tables: "cuda"
        # (the kernel) or "cpu" (numpy); the Study's evaluators and shards
        # run theirs there too
        self.device = check_device(device)
        self._evaluators: Dict[System, Evaluator] = \
            dict(evaluators) if evaluators else {}
        self._prices: Dict[tuple, tuple] = {}   # (device, link_bw) -> price
        # persistent CaseResult layer: re-running an overlapping
        # grid re-prices only new cases. result_cache=None follows the
        # global disk switch (result_cache.configure / REPRO_DISK_CACHE),
        # True forces the layer on for this Study, False opts out.
        self._case_cache = None if result_cache is False \
            else DiskCache(CASES_NAMESPACE, enabled=result_cache)
        # the caller's tri-state (None=follow global / True / False), so
        # run(workers=N) shard processes rebuild the same cache policy
        self._result_cache_opt = result_cache
        # static verification mode: plan/policy rules run once per
        # unique grid point before any evaluation; graphs are linted by the
        # shared Evaluators as cases price. enforce_fits owns the memory
        # decision, so verify_case skips the capacity rule here.
        self.verify_mode = verify_mod.resolve_mode(verify)

    @staticmethod
    def _expand(systems, configs, plans, workloads, policies, fusions,
                stage) -> List[Case]:
        if isinstance(workloads, Mapping):
            wl_items = list(workloads.items())
        else:
            wl_items = [(w.tag, w) for w in workloads]
        if policies is None:
            pol_items = [("", DEFAULT)]
        elif isinstance(policies, Mapping):
            pol_items = list(policies.items())    # keys name the row points
        else:
            pol_items = [("", p) for p in policies]
        if fusions is None:
            fus_items = [("", SERIAL_FUSION)]
        elif isinstance(fusions, Mapping):
            fus_items = list(fusions.items())
        else:
            fus_items = [("", f) for f in fusions]
        if plans is None:
            plans = [Plan()]
        elif plans != "auto":
            plans = list(plans)    # once: survive one-shot iterables
        out = []
        for system in systems:
            for cfg in configs:
                if plans == "auto":
                    from .planner import enumerate_plans   # avoid cycle
                    plan_list = enumerate_plans(system, cfg)
                else:
                    plan_list = plans
                for plan in plan_list:
                    for pname, pol in pol_items:
                        for fname, fus in fus_items:
                            for label, w in wl_items:
                                out.append(Case(system, cfg, plan, w,
                                                stage=stage, label=label,
                                                policy=pol,
                                                policy_label=pname,
                                                fusion=fus,
                                                fusion_label=fname))
        return out

    # ------------------------------------------------------------------
    def _evaluator(self, system: System) -> Evaluator:
        """One Evaluator per System for the Study's lifetime: provided ones
        are validated, created ones are kept so rerunning run() reuses them."""
        given = self._evaluators.get(system)
        if given is not None and given.tables_device != self.device:
            raise ValueError(
                f"an evaluator whose mapper tables run on "
                f"{given.tables_device!r} was given to a Study on "
                f"{self.device!r}")
        ev = im._evaluator(system, given, verify=self.verify_mode,
                           device=self.device)
        self._evaluators[system] = ev
        return ev

    @staticmethod
    def _graphs(case: Case) -> List[Graph]:
        """The symbolic graphs this case will evaluate (for shape pre-pass
        AND, for the layer stage, the evaluation itself), already rewritten
        under the case's fusion policy so the pre-pass collects the fused
        GEMM shapes the evaluation will actually solve."""
        w, cfg, plan, pol = case.workload, case.cfg, case.plan, case.policy
        fus = case.fusion
        if case.stage == "generate":
            graphs, _ = im.generate_graphs(cfg, plan, w.batch, w.in_len,
                                           w.out_len, w.samples, pol, fus)
            return graphs
        if case.stage == "prefill":
            return [fuse(build_model(cfg, plan, w.batch, w.in_len,
                                     kv_len=w.in_len, policy=pol), fus)]
        if case.stage == "decode":
            return [fuse(build_model(cfg, plan, w.batch, seq=1,
                                     kv_len=w.total_len, policy=pol), fus)]
        if case.stage == "serve":
            return sim_mod.trace_graphs(cfg, plan, w, pol, fus)
        # layer: single-layer prefill + decode microbenchmark graphs
        return [fuse(build_layer(cfg, plan, 0, w.batch, w.in_len, w.in_len,
                                 pol), fus),
                fuse(build_layer(cfg, plan, 0, w.batch, 1, w.total_len,
                                 pol), fus)]

    def _price(self, system: System) -> tuple:
        """(area_mm2, device_cost_usd) — computed once per distinct device
        (and link bandwidth, which sets the SerDes PHY area share)."""
        dev: Device = system.device
        link_gbps = system.link.bandwidth_bytes / 1e9
        key = (dev, link_gbps)
        if key not in self._prices:
            a = area_mod.device_area(dev, link_gbps).total_mm2
            c = cost_mod.device_cost(dev, a).total_usd
            self._prices[key] = (a, c)
        return self._prices[key]

    # ---- persistent CaseResult layer -----------------------
    _CASE_DOC_FIELDS = ("latency", "throughput", "dominant",
                        "decode_dominant", "flops", "bytes", "prefill",
                        "decode", "critical", "attribution")

    def _case_key(self, case: Case) -> str:
        """Content hash of everything that determines a case's numbers:
        the full System/config/plan/workload/policy/fusion value tree, the
        stage, the model-version salt, and the table device (salted as the
        mapper's disk keys are, so that a warm rerun serves the entries of
        its own cold path). Display labels are deliberately excluded:
        relabeling a grid point reuses its numbers."""
        return content_key(
            case.system, case.cfg, case.plan, case.workload, case.policy,
            case.fusion, case.stage,
            salt=f"{MODEL_VERSION}/case/{mapper._DISK_SALT[self.device]}")

    def _case_to_doc(self, r: CaseResult) -> dict:
        return {"latency": r.latency, "throughput": r.throughput,
                "dominant": r.dominant, "decode_dominant": r.decode_dominant,
                "flops": r.flops, "bytes": r.bytes,
                "prefill": r.prefill_latency, "decode": r.decode_latency,
                "critical": [[k, v] for k, v in r.critical],
                "attribution": r.attribution.to_doc()
                if r.attribution is not None else None}

    def _case_from_doc(self, doc: dict, case: Case, mem: float,
                       fits: bool) -> Optional[CaseResult]:
        if not all(f in doc for f in self._CASE_DOC_FIELDS):
            return None                     # malformed/older entry: miss
        try:
            att = None
            if doc["attribution"] is not None:
                att = obs.Attribution.from_doc(doc["attribution"])
                if att is None:
                    return None             # malformed attribution: miss
            crit = tuple((str(k), float(v)) for k, v in doc["critical"])
            price_a, price_c = self._price(case.system)
            sys_cost = price_c * case.system.device_count
            thr = float(doc["throughput"])
            return CaseResult(
                case, float(doc["latency"]), thr, mem, fits,
                str(doc["dominant"]), str(doc["decode_dominant"]),
                float(doc["flops"]), float(doc["bytes"]),
                float(doc["prefill"]), float(doc["decode"]),
                price_a, price_c, sys_cost,
                thr / sys_cost if sys_cost > 0 else 0.0,
                attribution=att, critical=crit)
        except (TypeError, ValueError):
            return None

    # ------------------------------------------------------------------
    def run(self, workers: Optional[int] = None) -> StudyResult:
        """Evaluate the grid. `workers=N` (N >= 2) shards the cases across
        a ProcessPoolExecutor — deterministic round-robin by case index, so
        `StudyResult` rows come back byte-identical to the serial path (the
        paper's core invariant: case numbers depend only on case content).
        Each worker runs an ordinary serial Study over its shard with its
        own Evaluators, sharing warmth through the content-hashed disk
        caches (atomic per-entry writes make concurrent same-key puts
        safe); stats, EvalStats and MetricsRegistry counters merge at join
        (`MetricsRegistry.merge_delta`). `workers=None`/0/1 is the
        unchanged serial path. The shards start by `spawn`: a forked child
        cannot use a CUDA context its parent already opened."""
        n = 1 if workers is None else int(workers)
        if n < 0:
            raise ValueError(f"workers must be >= 0, got {workers}")
        if n <= 1 or len(self.cases) < 2:
            return self._run_serial()
        return self._run_parallel(min(n, len(self.cases)))

    def _run_parallel(self, workers: int) -> StudyResult:
        t0 = time.perf_counter()
        reg = obs.metrics()
        common = (self.enforce_fits, self._result_cache_opt,
                  self.verify_mode, self.device, mapper.get_mapper_prune(),
                  str(result_cache_mod.cache_root()),
                  result_cache_mod.cache_enabled(), reg.enabled)
        idx_shards = [list(range(w, len(self.cases), workers))
                      for w in range(workers)]
        payloads = [([self.cases[i] for i in sh],) + common
                    for sh in idx_shards]
        with ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            outs = list(pool.map(_study_worker, payloads))

        results: List[Optional[CaseResult]] = [None] * len(self.cases)
        stats = StudyStats(cases=len(self.cases))
        evaluators: Dict[System, Evaluator] = {}
        for case in self.cases:
            if case.system not in evaluators:
                evaluators[case.system] = self._evaluator(case.system)
        stats.systems = len(evaluators)
        stats.devices = len({s.device for s in evaluators})
        for sh, (shard_results, wstats, ev_docs, delta) in zip(idx_shards,
                                                               outs):
            for i, r in zip(sh, shard_results):
                results[i] = r
            stats.evaluated += wstats.evaluated
            stats.skipped_unfit += wstats.skipped_unfit
            stats.matmul_pairs_presolved += wstats.matmul_pairs_presolved
            stats.case_cache_hits += wstats.case_cache_hits
            stats.case_cache_misses += wstats.case_cache_misses
            stats.presolve_seconds += wstats.presolve_seconds
            reg.merge_delta(delta)
            for system, doc in ev_docs:
                ev = evaluators.get(system)
                if ev is None:
                    evaluators[system] = ev = self._evaluator(system)
                ev.stats.merge(doc)
        stats.total_seconds = time.perf_counter() - t0
        return StudyResult(cast(List[CaseResult], results), stats,
                           evaluators)

    def _run_serial(self) -> StudyResult:
        t0 = time.perf_counter()
        stats = StudyStats(cases=len(self.cases))
        evaluators: Dict[System, Evaluator] = {}
        for case in self.cases:
            if case.system not in evaluators:
                evaluators[case.system] = self._evaluator(case.system)
        stats.systems = len(evaluators)
        stats.devices = len({s.device for s in evaluators})

        # ---- static verification pre-pass ----------------------
        # plan + policy rules once per unique grid point, before any mapper
        # or memory work; cases sharing a point share one lint.
        reg = obs.metrics()
        if self.verify_mode != "off":
            with reg.phase("verify"):
                linted = set()
                for case in self.cases:
                    w = case.workload
                    point = (case.system, case.cfg, case.plan, case.policy,
                             w.batch, w.total_len)
                    if point in linted:
                        continue
                    linted.add(point)
                    verify_mod.verify_case(case, mode=self.verify_mode)

        # ---- memory-fit pre-pass (planner model; no evaluation cost) -----
        prelim = []
        for case in self.cases:
            w = case.workload
            mem = im.memory_per_device(case.cfg, case.plan, w.batch,
                                       w.total_len, case.policy)
            fits = mem <= case.system.device.memory_capacity
            prelim.append((case, mem, fits))

        # ---- persistent CaseResult layer: hits skip graph building, the
        # ---- mapper presolve AND evaluation (re-price only new cases) ----
        cached: Dict[int, CaseResult] = {}
        keys: Dict[int, str] = {}
        cc = self._case_cache
        if cc is not None and cc.enabled:
            for idx, (case, mem, fits) in enumerate(prelim):
                if case.stage == "serve":
                    continue        # sim replays carry full distributions
                if self.enforce_fits and not fits:
                    continue
                key = self._case_key(case)
                keys[idx] = key
                doc = cc.get(key)
                r = self._case_from_doc(doc, case, mem, fits) \
                    if doc is not None else None
                if r is not None:
                    cached[idx] = r
                    stats.case_cache_hits += 1
                    evaluators[case.system].stats.case_hits += 1
                    reg.inc("study.case_hits")
                else:
                    stats.case_cache_misses += 1
                    evaluators[case.system].stats.case_misses += 1
                    reg.inc("study.case_misses")

        # ---- grid-wide device-axis stacked mapper search -----------------
        t_pre = time.perf_counter()
        pairs, seen = [], set()
        for idx, (case, _, fits) in enumerate(prelim):
            if idx in cached:
                continue
            if self.enforce_fits and not fits:
                continue
            ev = evaluators[case.system]
            if ev.use_reference_mapper or not ev.batch_matmuls:
                continue    # seed-replica evaluators keep the eager path
            dev = case.system.device
            for g in self._graphs(case):
                for node in g:
                    s = node.spec
                    if isinstance(s, FusedMatmulSpec):
                        s = s.gemm     # presolve the fused kernel's GEMM
                    if not isinstance(s, MatmulSpec):
                        continue
                    pair = (dev, s.shape)
                    if pair not in seen and not is_memoized(*pair):
                        seen.add(pair)
                        pairs.append(pair)
        if pairs:
            with reg.phase("presolve"):
                matmul_perf_batch_multi(pairs, device=self.device)
        stats.matmul_pairs_presolved = len(pairs)
        stats.presolve_seconds = time.perf_counter() - t_pre

        # ---- per-case evaluation (all mapper work is now memo hits) ------
        results = []
        for idx, (case, mem, fits) in enumerate(prelim):
            if idx in cached:
                stats.evaluated += 1
                results.append(cached[idx])
                continue
            price_a, price_c = self._price(case.system)
            sys_cost = price_c * case.system.device_count
            if self.enforce_fits and not fits:
                stats.skipped_unfit += 1
                results.append(CaseResult(
                    case, math.inf, 0.0, mem, False, "n/a", "n/a",
                    0.0, 0.0, math.inf, math.inf,
                    price_a, price_c, sys_cost, 0.0))
                continue
            stats.evaluated += 1
            with reg.phase("evaluate"):
                r = self._evaluate(case, mem, fits, evaluators[case.system],
                                   price_a, price_c, sys_cost)
            if idx in keys:
                cc.put(keys[idx], self._case_to_doc(r))
            results.append(r)
        stats.total_seconds = time.perf_counter() - t0
        return StudyResult(results, stats, evaluators)

    def _evaluate(self, case: Case, mem: float, fits: bool, ev: Evaluator,
                  price_a: float, price_c: float,
                  sys_cost: float) -> CaseResult:
        w, cfg, plan, system = case.workload, case.cfg, case.plan, case.system
        pol, fus = case.policy, case.fusion
        dec_dom = "n/a"
        sim = None
        if case.stage == "serve":
            sim = sim_mod.simulate(system, cfg, plan, w, evaluator=ev,
                                   policy=pol, fusion=fus)
            latency = sim.e2e(50)           # median request e2e
            thr = sim.goodput
            pf, dc = sim.prefill_busy, sim.decode_busy
            dom, flops, bytes_ = sim.dominant, sim.flops, sim.bytes
        elif case.stage == "generate":
            rep = im.generate(system, cfg, plan, w.batch, w.in_len, w.out_len,
                              samples=w.samples, evaluator=ev, policy=pol,
                              fusion=fus)
            latency = rep.latency
            thr = im.throughput_from_generate(rep, plan, w.batch, w.out_len)
            pf, dc = rep.breakdown["prefill"], rep.breakdown["decode"]
            dom, flops, bytes_ = rep.dominant, rep.flops, rep.bytes
        elif case.stage == "prefill":
            rep = im.prefill(system, cfg, plan, w.batch, w.in_len,
                             evaluator=ev, policy=pol, fusion=fus)
            latency = pf = rep.latency
            dc = 0.0
            thr = w.tokens_in * plan.dp * plan.pp / latency
            dom, flops, bytes_ = rep.dominant, rep.flops, rep.bytes
        elif case.stage == "decode":
            rep = im.decode_step(system, cfg, plan, w.batch, w.total_len,
                                 evaluator=ev, policy=pol, fusion=fus)
            latency = dc = rep.latency
            pf = 0.0
            thr = w.batch * plan.dp * plan.pp / latency
            dom, flops, bytes_ = rep.dominant, rep.flops, rep.bytes
        else:   # layer microbenchmark: prefill + decode single-layer graphs
            pf_c, dc_c = ev.evaluate_many(self._graphs(case),
                                          overlap=fus.overlap)
            latency = pf = pf_c.latency
            dc = dc_c.latency
            thr = 0.0
            dom = max(pf_c.by_bound(), key=pf_c.by_bound().get)
            dec_dom = max(dc_c.by_bound(), key=dc_c.by_bound().get)
            flops = pf_c.flops + dc_c.flops
            bytes_ = pf_c.bytes + dc_c.bytes
        att, crit = self._attribution(case, ev)
        return CaseResult(case, latency, thr, mem, fits, dom, dec_dom,
                          flops, bytes_, pf, dc, price_a, price_c, sys_cost,
                          thr / sys_cost if sys_cost > 0 else 0.0, sim=sim,
                          attribution=att, critical=crit)

    def _attribution(self, case: Case, ev: Evaluator
                     ) -> Tuple[Optional[obs.Attribution],
                                Tuple[Tuple[str, float], ...]]:
        """Per-op attribution + critical-path breakdown of this case's
        primary graph(s). Every spec is already in the Evaluator's cache
        after _evaluate, so this re-prices nothing — it only re-assembles
        the per-op rows the stage helpers collapsed into scalars. Serve
        cases carry their SimResult instead."""
        if case.stage == "serve":
            return None, ()
        graphs = self._graphs(case)
        if case.stage in ("generate", "layer") and len(graphs) > 1:
            sections = [("prefill/", graphs[0]), ("decode/", graphs[1])]
        else:
            sections = [("", graphs[0])]
        costs = ev.evaluate_many([g for _, g in sections],
                                 overlap=case.fusion.overlap)
        atts = [obs.attribute(g, c, label=case.stage, prefix=pre)
                for (pre, g), c in zip(sections, costs)]
        att = atts[0] if len(atts) == 1 else obs.combine(case.stage, atts)
        crit = tuple(sorted(costs[0].critical_breakdown().items(),
                            key=lambda kv: (-kv[1], kv[0])))
        return att, crit


def _study_worker(payload: Tuple[Any, ...]) -> Tuple[Any, ...]:
    """Entry point of one `Study.run(workers=N)` shard process.

    The parent ships its resolved configuration explicitly (cache root +
    enabled flag, table device and prune mode, verify mode, phase-span
    switch) rather than relying on inherited globals, so a spawned shard
    behaves as the parent — runtime overrides like
    `result_cache.overridden(root=...)` are re-applied here. The shard runs
    as a plain serial Study (its own Evaluators, its own case-cache
    lookups) and returns its ordered CaseResults plus the stats and the
    registry counter delta the parent merges at join."""
    (cases, enforce_fits, use_cache, verify_mode, device, prune,
     cache_root, cache_enabled, spans) = payload
    result_cache_mod.configure(root=cache_root, enabled=cache_enabled)
    mapper.set_mapper_prune(prune)
    reg = obs.metrics()
    reg.set_enabled(spans)
    base = reg.snapshot()
    st = Study(cases=list(cases), enforce_fits=enforce_fits,
               result_cache=use_cache, verify=verify_mode, device=device)
    res = st._run_serial()
    snap = reg.snapshot()
    delta = {k: v - base.get(k, 0.0) for k, v in sorted(snap.items())
             if v != base.get(k, 0.0)}
    ev_docs = [(system, ev.stats.to_doc())
               for system, ev in res.evaluators.items()]
    return res.results, res.stats, ev_docs, delta
