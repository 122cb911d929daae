"""The port's verify CLI (``python -m repro_torch.verify``) against the JAX
package's (``repro.verify``), on the CPU.

Over the same matrix (every registered arch, and gpt3-175b with
``--all-configs``, on ``dgx-a100-4`` and ``tpu-v5e-16``; every plan the
planner enumerates; every precision preset; graphs per fusion preset at a
prefill and a decode point; schedule certificates) the port's
``lint_all`` gives the JAX rows, row for row, and its CLI prints the same
lines, writes the same JSON report and returns the same exit code: 0 on the
shipped matrix, 1 with a planted policy whose accumulator is narrower than
its weights.
"""
import json

import pytest

from repro import verify as jax_verify
from repro.core import precision as jax_precision
from repro_torch import verify
from repro_torch.core import precision


@pytest.mark.parametrize("all_configs", [False, True], ids=["archs", "all-configs"])
def test_lint_all_equals_jax_row_for_row(all_configs):
    got = verify.lint_all(all_configs=all_configs)
    assert got == jax_verify.lint_all(all_configs=all_configs)
    assert [r for r in got if r["severity"] != "info"] == []
    # the info notes of both systems (whisper's encoder seam, KV replication)
    assert {r["where"].split("/")[0] for r in got} == {"dgx-a100-4", "tpu-v5e-16"}


def test_systems_are_the_jax_matrix():
    got, want = verify._systems(), jax_verify._systems()
    assert list(got) == list(want) == ["dgx-a100-4", "tpu-v5e-16"]
    for name in got:
        assert (got[name].device.name, got[name].device_count) == \
            (want[name].device.name, want[name].device_count)


def run_main(mod, argv, capsys):
    rc = mod.main(argv)
    return rc, capsys.readouterr().out


def test_cli_summary_report_and_exit_code_equal_jax(tmp_path, capsys):
    got = run_main(verify, ["--all-configs", "--json", str(tmp_path / "port.json")], capsys)
    want = run_main(jax_verify, ["--all-configs", "--json", str(tmp_path / "jax.json")], capsys)
    assert got == want
    rc, out = got
    assert rc == 0
    assert out.splitlines()[-1].startswith("verify: 0 errors, 0 warns, ")
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    doc = json.loads((tmp_path / "port.json").read_text())
    assert doc["counts"]["error"] == doc["counts"]["warn"] == 0


def test_cli_fails_a_planted_policy_as_jax(monkeypatch, capsys):
    """A policy accumulating narrower than its weights is an error in both
    packages' matrices, on the same rows, with exit code 1."""
    monkeypatch.setattr(verify, "POLICIES", {**precision.POLICIES, "bad": precision.PrecisionPolicy(
        weights=precision.FP32, accumulator=precision.FP16)})
    monkeypatch.setattr(jax_verify, "POLICIES", {**jax_precision.POLICIES,
                                                 "bad": jax_precision.PrecisionPolicy(
                                                     weights=jax_precision.FP32,
                                                     accumulator=jax_precision.FP16)})
    got, want = run_main(verify, [], capsys), run_main(jax_verify, [], capsys)
    assert got == want
    rc, out = got
    assert rc == 1
    assert "error[policy.accumulator] dgx-a100-4/policy:bad" in out
    assert "error[policy.accumulator] tpu-v5e-16/policy:bad" in out
