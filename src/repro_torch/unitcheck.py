"""CLI for the dimensional-analysis pass: ``python -m repro_torch.unitcheck``.

Lints the pricing core's unit annotations (core/units.py vocabulary,
core/unitcheck.py engine) and exits nonzero on error-severity diagnostics —
the CI gate. Mirrors ``python -m repro_torch.verify``. With no paths it
lints the port's own ``core`` directory, wherever it is run from.

    PYTHONPATH=src python -m repro_torch.unitcheck
    PYTHONPATH=src python -m repro_torch.unitcheck --json report.json src/repro_torch/core
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from pathlib import Path

from .core.unitcheck import (DEFAULT_TARGETS, RULES, check_paths,
                             registry_selfcheck)

MODES = ("error", "warn", "off")

#: the default targets, as paths under this package
_DEFAULT_PATHS = [str(Path(__file__).resolve().parent / t)
                  for t in DEFAULT_TARGETS]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.unitcheck",
        description="static unit/dimension checker for the pricing core")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories to lint "
                         "(default: the port's core directory)")
    ap.add_argument("--mode", choices=MODES, default="error",
                    help="error: exit 1 on diagnostics (CI gate); "
                         "warn: report but exit 0; off: do nothing")
    ap.add_argument("--json", metavar="PATH",
                    help="write the diagnostic report as JSON")
    ap.add_argument("--selfcheck", action="store_true",
                    help="also prove every rule fires on its sample mutant")
    args = ap.parse_args(argv)

    if args.mode == "off":
        print("unitcheck: mode=off, nothing checked")
        return 0

    if args.selfcheck:
        registry_selfcheck()

    paths = args.paths or _DEFAULT_PATHS
    diags = check_paths(paths)

    if args.json:
        report = {
            "rules": sorted(RULES),
            "count": len(diags),
            "diagnostics": [
                {"rule": d.rule, "severity": d.severity,
                 "location": d.location, "message": d.message,
                 "hint": d.hint}
                for d in diags
            ],
        }
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")

    for d in diags:
        print(f"{d.severity}[{d.rule}] {d.location}: {d.message}"
              + (f" (hint: {d.hint})" if d.hint else ""))
    print(f"unitcheck: {len(diags)} diagnostic(s) across "
          f"{len(RULES)} rules ({', '.join(paths)})")
    if args.mode == "error" and any(d.severity == "error" for d in diags):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
