"""Purity lint of the port: its cache-keyed and trace-export paths held to
the rules of ``tests/test_purity_lint.py`` (the same AST lint, imported,
not copied): no wall clocks or entropy, no environment reads, no
process-local identity, no bare dict-order iteration.

The linted set mirrors the JAX package's: the mapper's batched-search
stages, whose winners go to the persistent matmul cache (the port has no
``_chunk_tables_numpy``; its numpy tables are ``mapper._tables`` and its
card tables ``kernels/mapper_tables/ops.py::chunk_tables``),
``result_cache``'s canonicalization and keying, the Study's case keying and
serialization, the attribution it stores, and every exporter of
``core/trace_export.py``, whose traces must be byte-identical run to run;
and what the dry run writes into its records (``launch/analysis.py``'s
summaries, the collective recorder's, the ZeRO placement, the largest-rank
rule), which must be the same from run to run of a cell.
"""
import pytest

from repro_torch.core import mapper, obs, result_cache, trace_export
from repro_torch.core.study import Study
from repro_torch.distributed.collectives import Recorder
from repro_torch.distributed.sharding import zero_placement
from repro_torch.launch import analysis, dryrun
from repro_torch.kernels.mapper_tables import ops as tables_ops
from test_purity_lint import _violations

LINTED = [
    mapper._gather_chunk,
    mapper._chunk_tables,
    mapper._tables,
    tables_ops.chunk_tables,
    mapper._pick_winners,
    mapper._solve_chunk,
    mapper._pair_key,
    mapper._pair_sig,
    mapper._result_to_doc,
    mapper._row_lower_bounds,
    mapper._seed_rows,
    mapper._prune_pairs,
    result_cache.canonical,
    result_cache.content_key,
    Study._case_key,                # staticmethod resolves to the function
    Study._case_to_doc,
    obs.attribute,
    obs.Attribution.to_doc,         # feeds Study._case_to_doc
    trace_export._ts,
    *(getattr(trace_export, name) for name in trace_export.__all__),
    analysis.cost_summary,
    analysis.memory_summary,
    analysis.collectives_to_graph,
    Recorder.stats,
    Recorder.by_axis,
    zero_placement,
    dryrun.rank0_largest,
]


@pytest.mark.parametrize("fn", LINTED, ids=lambda f: f"{f.__module__}.{f.__qualname__}")
def test_port_cache_keyed_and_trace_paths_are_pure(fn):
    assert _violations(fn) == []


def _planted_dict_iter(d):
    return [k for k, v in d.items()]


def test_lint_catches_a_planted_violation_here():
    assert _violations(_planted_dict_iter)


def test_every_exporter_is_linted():
    names = {f.__name__ for f in LINTED if f.__module__ == trace_export.__name__}
    assert names == {"_ts", *trace_export.__all__}
    assert len(LINTED) == len(set(LINTED))
