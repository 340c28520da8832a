"""``python -m repro_torch.analysis`` — the port's contract linter.

Exit status: 0 when no un-suppressed, un-baselined findings remain;
1 otherwise.  Designed to run on a bare Python install in seconds —
nothing under :mod:`repro_torch.analysis` imports the modules it lints
(no torch, no numpy), so it needs no dependency install at all.
"""
from __future__ import annotations

import argparse
import json
import sys

import repro_torch.analysis.rules  # noqa: F401  (registers the built-in rules)
from repro_torch.analysis.core import (BASELINE_DEFAULT, Baseline, all_rules,
                                 run_paths)

JSON_SCHEMA_VERSION = 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST lint suite encoding the port's runtime contracts "
                    "(determinism, float64 scoping, sync-free device "
                    "bodies, registry completeness, tracer no-op cost, "
                    "ledger discipline) as static checks.")
    p.add_argument("paths", nargs="*", default=["src/repro_torch"],
                   help="files/directories to lint (default: "
                        "src/repro_torch)")
    p.add_argument("--format", choices=("text", "json"), default="text",
                   help="report format (default: text)")
    p.add_argument("--baseline", default=BASELINE_DEFAULT, metavar="FILE",
                   help="grandfathered-findings file (default: "
                        f"{BASELINE_DEFAULT}; silently ignored if absent)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, baseline or not")
    p.add_argument("--write-baseline", action="store_true",
                   help="rewrite --baseline from the current findings "
                        "and exit 0")
    p.add_argument("--select", metavar="RULES",
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule table and exit")
    return p


def _selected_rules(spec):
    rules = all_rules()
    if not spec:
        return rules
    wanted = {s.strip() for s in spec.split(",") if s.strip()}
    unknown = wanted - {r.id for r in rules}
    if unknown:
        raise SystemExit(f"unknown rule id(s): {', '.join(sorted(unknown))}; "
                         f"known: {', '.join(r.id for r in rules)}")
    return [r for r in rules if r.id in wanted]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rules = _selected_rules(args.select)

    if args.list_rules:
        for r in rules:
            print(f"{r.id}  {r.title:20s} {r.description}")
        return 0

    findings = run_paths(args.paths, rules=rules)

    if args.write_baseline:
        path = Baseline.from_findings(findings).write(args.baseline)
        print(f"wrote {len(findings)} finding(s) to {path}")
        return 0

    baselined = 0
    if not args.no_baseline:
        findings, baselined = Baseline.load(args.baseline).filter(findings)

    if args.format == "json":
        print(json.dumps({
            "version": JSON_SCHEMA_VERSION,
            "rules": {r.id: r.description for r in rules},
            "findings": [f.as_json() for f in findings],
            "baselined": baselined,
        }, indent=1, sort_keys=True))
    else:
        for f in findings:
            print(f.render())
            if f.snippet:
                print(f"    {f.snippet}")
        tail = f" ({baselined} baselined)" if baselined else ""
        print(f"repro_torch.analysis: {len(findings)} finding(s){tail}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
