"""graftlint CLI.

    python -m jepsen_etcd_tpu_torch.lint [paths...] [--rule DET,COL...]
        [--json] [--baseline PATH] [--write-baseline] [--list-rules]

Exit 0 iff no non-suppressed, non-baselined findings (the tier-1
gate). Suppressed/baselined findings are shown only with --verbose.
"""

from __future__ import annotations

import argparse
import json
import sys

from .engine import (DEFAULT_BASELINE, META_RULES, load_baseline,
                     run_lint, write_baseline)
from .policy import Policy
from .rules import ALL_RULES, FAMILIES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m jepsen_etcd_tpu_torch.lint",
        description="graftlint: determinism / columnar / torch / "
                    "thread / telemetry static analysis")
    ap.add_argument("paths", nargs="*",
                    help="files or directories (default: the package)")
    ap.add_argument("--rule", action="append", default=None,
                    metavar="ID|FAMILY",
                    help="restrict to rule ids or families "
                         "(comma-separable, repeatable)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    metavar="PATH",
                    help="baseline file (default: the committed one); "
                         "'' disables")
    ap.add_argument("--write-baseline", action="store_true",
                    help="grandfather all current findings into "
                         "--baseline and exit 0")
    ap.add_argument("--verbose", action="store_true",
                    help="also show suppressed/baselined findings")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for fam in FAMILIES:
            for rid in sorted(fam.RULES):
                print(f"{rid}  {fam.RULES[rid]}")
        for rid in sorted(META_RULES):
            print(f"{rid}  {META_RULES[rid]}")
        return 0

    rules = None
    if args.rule:
        rules = [r for part in args.rule for r in part.split(",") if r]
    try:
        report = run_lint(paths=args.paths or None, rules=rules,
                          baseline_path=args.baseline or None)
    except ValueError as e:   # unknown --rule selector
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline:
        old = load_baseline(args.baseline)
        kept = write_baseline(args.baseline, report.findings, old)
        print(f"baseline: {len(kept)} entries -> {args.baseline}")
        return 0

    if args.as_json:
        print(json.dumps(report.to_dict(), indent=1))
        return 1 if report.errors else 0

    shown = report.findings if args.verbose else report.errors
    for f in shown:
        tag = " [suppressed]" if f.suppressed else (
            " [baselined]" if f.baselined else "")
        print(f"{f.location()}: {f.rule}{tag}: {f.message}")
        if f.snippet:
            print(f"    {f.snippet}")
    n = len(report.errors)
    print(f"graftlint: {report.files} files, "
          f"{len(report.rules_run)} rules, {n} error(s), "
          f"{sum(f.suppressed for f in report.findings)} suppressed, "
          f"{sum(f.baselined for f in report.findings)} baselined")
    return 1 if n else 0


if __name__ == "__main__":
    sys.exit(main())
