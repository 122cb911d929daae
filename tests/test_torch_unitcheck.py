"""The port's static unit checker (``repro_torch.core.unitcheck``) and its CLI
(``python -m repro_torch.unitcheck``) against the JAX package's, on the CPU.

* Over both core trees, every sample mutant of either registry and every
  planted mutant of ``tests/test_unitcheck.py`` (and its corrected twin),
  the port's checker gives the JAX checker's diagnostics, rule, severity,
  location, message and hint; the rule registries are equal.
* Both core trees lint clean, and each rule fires on the port's sample
  mutant, which imports ``repro_torch.core.units``.
* The port's CLI exits 0 on its own core (its default path, from any
  directory) and 1 on a mutant; ``--mode warn``, ``--mode off``, ``--json``
  and ``--selfcheck`` behave as the JAX CLI's, with the same report.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro.core import unitcheck as jax_uc
from repro_torch.core import unitcheck as uc

ROOT = pathlib.Path(__file__).resolve().parents[1]
CORES = {"jax": ROOT / "src" / "repro" / "core", "port": ROOT / "src" / "repro_torch" / "core"}

# the planted mutants of tests/test_unitcheck.py (rule, line; None: a clean twin)
PLANTED = {
    "bytes-plus-seconds": ("unit.add-mismatch", 3, """\
        from repro.core.units import Bytes, Seconds
        def f(n: Bytes, t: Seconds) -> float:
            return n + t
        """),
    "bytes-plus-seconds-fixed": (None, None, """\
        from repro.core.units import Bytes, BytesPerSecond, Seconds
        def f(n: Bytes, bw: BytesPerSecond, t: Seconds) -> Seconds:
            return n / bw + t
        """),
    "cycles-as-seconds": ("unit.return-mismatch", 3, """\
        from repro.core.units import Cycles, Seconds
        def f(c: Cycles) -> Seconds:
            return c
        """),
    "cycles-as-seconds-fixed": (None, None, """\
        from repro.core.units import Cycles, Hertz, Seconds
        def f(c: Cycles, freq: Hertz) -> Seconds:
            return c / freq
        """),
    "elements-into-bytes-field": ("unit.field-mismatch", 10, """\
        from dataclasses import dataclass
        from repro.core.units import Bytes, Elements

        @dataclass
        class Spec:
            n_bytes: Bytes = 0.0

        def f(n: Elements) -> Spec:
            s = Spec()
            s.n_bytes = n
            return s
        """),
    "elements-into-bytes-field-fixed": (None, None, """\
        from dataclasses import dataclass
        from repro.core.units import Bytes, BytesPerElement, Elements

        @dataclass
        class Spec:
            n_bytes: Bytes = 0.0

        def f(n: Elements, width: BytesPerElement) -> Spec:
            s = Spec()
            s.n_bytes = n * width
            return s
        """),
    "missing-bandwidth-divide": ("unit.assign-mismatch", 3, """\
        from repro.core.units import Bytes, BytesPerSecond, Seconds
        def f(n: Bytes, bw: BytesPerSecond) -> Seconds:
            t: Seconds = n
            return t
        """),
    "missing-bandwidth-divide-fixed": (None, None, """\
        from repro.core.units import Bytes, BytesPerSecond, Seconds
        def f(n: Bytes, bw: BytesPerSecond) -> Seconds:
            t: Seconds = n / bw
            return t
        """),
    "compare": ("unit.compare-mismatch", 3, """\
        from repro.core.units import Flops, Seconds
        def f(x: Flops, t: Seconds) -> bool:
            return x > t
        """),
    "compare-fixed": (None, None, """\
        from repro.core.units import Seconds
        def f(a: Seconds, b: Seconds) -> bool:
            return a > b
        """),
    "call": ("unit.call-mismatch", 5, """\
        from repro.core.units import Bytes, Seconds
        def launch(t: Seconds) -> Seconds:
            return t
        def f(n: Bytes) -> Seconds:
            return launch(n)
        """),
    "call-fixed": (None, None, """\
        from repro.core.units import Seconds
        def launch(t: Seconds) -> Seconds:
            return t
        def f(t: Seconds) -> Seconds:
            return launch(t)
        """),
    "constructor-field": ("unit.field-mismatch", 9, """\
        from dataclasses import dataclass
        from repro.core.units import Cycles, Seconds

        @dataclass
        class Slot:
            start: Seconds = 0.0

        def f(c: Cycles) -> Slot:
            return Slot(start=c)
        """),
    "augassign": ("unit.add-mismatch", 4, """\
        from repro.core.units import Bytes, Seconds
        def f(n: Bytes) -> Seconds:
            t: Seconds = 0.0
            t += n
            return t
        """),
    "gradual": (None, None, """\
        from repro.core.units import Ratio, Seconds
        def f(t: Seconds, util: Ratio, k: int) -> Seconds:
            body = t * util * 2.0 + t
            mystery = helper(k)
            return body + mystery * 1.0
        def helper(k):
            return k
        """),
    "parse-error": ("unit.parse-error", 1, "def broken(:\n"),
}


def docs(diags):
    return [dataclasses.asdict(d) for d in diags]


def test_rule_registry_equals_jax():
    assert {k: dataclasses.astuple(r) for k, r in uc.RULES.items()} == \
        {k: dataclasses.astuple(r) for k, r in jax_uc.RULES.items()}
    assert set(uc._SAMPLE_MUTANTS) == set(uc.RULES)
    assert uc.DEFAULT_TARGETS == jax_uc.DEFAULT_TARGETS


@pytest.mark.parametrize("tree", sorted(CORES))
def test_core_tree_diagnostics_equal_jax(tree):
    got = uc.check_paths([str(CORES[tree])])
    assert docs(got) == docs(jax_uc.check_paths([str(CORES[tree])]))
    assert got == []


@pytest.mark.parametrize("rule_id", sorted(jax_uc.RULES))
@pytest.mark.parametrize("registry", ["port", "jax"])
def test_sample_mutants_give_the_jax_diagnostics(registry, rule_id):
    src = (uc if registry == "port" else jax_uc)._SAMPLE_MUTANTS[rule_id]
    got = uc.check_source(src)
    assert docs(got) == docs(jax_uc.check_source(src))
    assert got and all(d.rule == rule_id for d in got)
    if registry == "port":
        assert "from repro_torch.core.units import" in src


@pytest.mark.parametrize("name", sorted(PLANTED))
def test_planted_mutants_give_the_jax_diagnostics(name):
    rule, line, src = PLANTED[name]
    src = textwrap.dedent(src)
    for text in (src, src.replace("repro.core.units", "repro_torch.core.units")):
        got = uc.check_source(text, filename="<m>")
        assert docs(got) == docs(jax_uc.check_source(text, filename="<m>"))
        if rule is None:
            assert got == []
        else:
            assert f"<m>:{line}" in [d.location for d in got if d.rule == rule]


def test_registry_selfcheck_passes():
    uc.registry_selfcheck()
    by_rule = uc.registry_diagnostics()
    assert sorted(by_rule) == sorted(uc.RULES) and all(by_rule.values())


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def run_cli(pkg, *args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", f"{pkg}.unitcheck", *args],
                          capture_output=True, text=True, cwd=cwd, env=env, timeout=120)


@pytest.fixture()
def mutant(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""\
        from repro_torch.core.units import Bytes, Seconds
        def f(n: Bytes, t: Seconds) -> float:
            return n + t
        """))
    return bad


def test_cli_default_path_is_the_port_core_from_anywhere(tmp_path):
    p = run_cli("repro_torch", "--selfcheck", cwd=tmp_path)
    assert p.returncode == 0, p.stdout + p.stderr
    assert p.stdout.strip() == (f"unitcheck: 0 diagnostic(s) across {len(uc.RULES)} rules "
                                f"({CORES['port']})")


def test_cli_error_warn_and_off_modes_as_jax(mutant):
    out = {}
    for mode, rc in (("error", 1), ("warn", 0), ("off", 0)):
        got, want = run_cli("repro_torch", "--mode", mode, str(mutant)), \
            run_cli("repro", "--mode", mode, str(mutant))
        assert (got.returncode, got.stdout) == (want.returncode, want.stdout), mode
        assert got.returncode == rc, mode
        out[mode] = got.stdout
    for mode in ("error", "warn"):
        assert f"error[unit.add-mismatch] {mutant}:3" in out[mode]
    assert out["off"] == "unitcheck: mode=off, nothing checked\n"


def test_cli_json_report_as_jax(mutant, tmp_path):
    got, want = tmp_path / "port.json", tmp_path / "jax.json"
    p = run_cli("repro_torch", "--json", str(got), str(mutant))
    q = run_cli("repro", "--json", str(want), str(mutant))
    assert p.returncode == q.returncode == 1
    assert got.read_text() == want.read_text()
    doc = json.loads(got.read_text())
    assert doc["count"] == 1 and doc["diagnostics"][0]["rule"] == "unit.add-mismatch"
    assert doc["rules"] == sorted(uc.RULES)


def test_cli_on_both_cores_as_jax():
    for core in CORES.values():
        got, want = run_cli("repro_torch", "--selfcheck", str(core)), \
            run_cli("repro", "--selfcheck", str(core))
        assert (got.returncode, got.stdout) == (want.returncode, want.stdout) == \
            (0, f"unitcheck: 0 diagnostic(s) across 6 rules ({core})\n")
