"""Run the registered analyzer rules over the port (the golangci-lint-style
command line of ``mpi_operator_tpu_torch/analysis``).

Usage:

    python -m mpi_operator_tpu_torch.cmd.analyze            # text report
    python -m mpi_operator_tpu_torch.cmd.analyze --format json
    python -m mpi_operator_tpu_torch.cmd.analyze --fail-on-new
    python -m mpi_operator_tpu_torch.cmd.analyze --select TPU4
    python -m mpi_operator_tpu_torch.cmd.analyze --select TPU5   # torch perf
    python -m mpi_operator_tpu_torch.cmd.analyze --update-baseline
    python -m mpi_operator_tpu_torch.cmd.analyze --list-rules

It lints the port package and ``chip_smoke.py`` under ``--root`` (the
repo holding this package by default). The committed baseline
(``mpi_operator_tpu_torch/analysis/baseline.json``) tracks legacy
findings by ``rule|file|message`` key so they stay visible without
failing the gate; anything beyond the baselined count is "new" and fails
``--fail-on-new``.  Suppress a single site with ``# noqa: TPUxxx``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ..analysis import framework

PACKAGE = Path(__file__).resolve().parent.parent
REPO = PACKAGE.parent
DEFAULT_BASELINE = PACKAGE / "analysis" / "baseline.json"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_operator_tpu_torch.cmd.analyze",
        description=__doc__.splitlines()[0],
    )
    parser.add_argument("--format", choices=("text", "json", "github"),
                        default="text",
                        help="github emits Actions workflow annotations "
                             "(::error for new findings, ::notice for "
                             "baselined) so CI failures are clickable")
    parser.add_argument("--fail-on-new", action="store_true",
                        help="exit 1 when findings exceed the baseline")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the baseline from current findings")
    parser.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE)
    parser.add_argument("--select", default="",
                        help="comma-separated rule-ID prefixes (TPU4,TPU101)")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("--root", type=Path, default=REPO)
    args = parser.parse_args(argv)

    if args.list_rules:
        for r in framework.all_rules():
            alias = framework.LEGACY_ALIASES.get(r.id)
            alias_txt = f" (alias {alias})" if alias else ""
            print(f"{r.id}{alias_txt}  {r.name}: {r.description}")
        return 0

    # The registry gate: a rule module silently dropping out of the
    # import chain must fail loudly, not pass with fewer rules.
    missing = framework.missing_rule_families()
    if missing:
        print("analyze: FATAL required rule families missing from the "
              f"registry: {', '.join(missing)}", file=sys.stderr)
        return 2

    select = [s.strip() for s in args.select.split(",") if s.strip()] or None
    repo = framework.RepoView(args.root)
    findings = framework.run(repo, select=select)

    if args.update_baseline:
        # The baseline always snapshots the FULL rule set — a selected
        # subset would silently drop every other family's legacy keys.
        if select:
            findings = framework.run(repo)
        old = framework.load_baseline(args.baseline)
        new = framework.baseline_payload(findings)["findings"]
        framework.write_baseline(args.baseline, findings)
        added = sorted(k for k in new if k not in old)
        removed = sorted(k for k in old if k not in new)
        print(f"baseline: wrote {len(findings)} finding(s) to "
              f"{args.baseline} (+{len(added)} added, "
              f"-{len(removed)} stale)")
        for key in added:
            print(f"  + {key}")
        for key in removed:
            print(f"  - {key}")
        return 0

    baseline = framework.load_baseline(args.baseline)
    fresh = framework.new_findings(findings, baseline)
    syntax = [f for f in findings
              if f.rule_id == framework.SYNTAX_RULE_ID]

    if args.format == "github":
        # GitHub Actions workflow commands: new findings annotate the
        # diff as errors; baselined ones stay visible as notices.
        for f in findings:
            level = "error" if f in fresh else "notice"
            print(f"::{level} file={f.file},line={f.line},"
                  f"title={f.rule_id}::{f.message}")
        print(f"analyze: {len(repo.files)} files, {len(findings)} "
              f"finding(s), {len(fresh)} new vs baseline")
    elif args.format == "json":
        print(json.dumps({
            "files": len(repo.files),
            "rules": [r.id for r in framework.all_rules()],
            "findings": [f.to_dict() for f in findings],
            "new": [f.to_dict() for f in fresh],
            "baselined": len(findings) - len(fresh),
            "baseline": str(args.baseline),
        }, indent=2))
    else:
        for f in findings:
            marker = "NEW " if f in fresh else "base"
            print(f"[{marker}] {f.render()}")
        print(f"analyze: {len(repo.files)} files, {len(findings)} "
              f"finding(s), {len(fresh)} new vs baseline")

    if syntax:
        return 1
    if args.fail_on_new and fresh:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
