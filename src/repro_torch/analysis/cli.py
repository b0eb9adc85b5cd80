"""``repro-torch-lint`` — the concurrency + I/O-discipline lint entry
point, the port of the JAX package's ``repro-lint``.

Stdlib only: the job that runs this needs no numpy/torch install (the
``src/repro_torch`` tree is parsed, never imported).

Exit codes: 0 clean (or everything baselined), 1 new findings, 2 usage
error.

Typical invocations::

    repro-torch-lint                      # lint src/repro_torch
    repro-torch-lint --baseline analysis_baseline_torch.json
    repro-torch-lint --baseline analysis_baseline_torch.json --write-baseline
    repro-torch-lint --only unscheduled-io      # one checker family
    repro-torch-lint --format=json              # report JSON on stdout
    repro-torch-lint --report lint-report.json  # CI artifact
    python -m repro_torch.analysis.cli --baseline analysis_baseline_torch.json
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis.baseline import Baseline, Finding
from repro_torch.analysis.callgraph import Package
from repro_torch.analysis.checks import run_checks
from repro_torch.analysis.iochecks import run_io_checks
from repro_torch.analysis.lockorder import LockOrderGraph, build_lock_order
from repro_torch.analysis.locks import LockTable, collect_locks

DEFAULT_ROOT = Path(__file__).resolve().parents[1]   # src/repro_torch


@dataclass
class Report:
    findings: List[Finding]
    new: List[Finding]
    suppressed: List[Finding]
    stale: List[str]
    pkg: Package = field(repr=False, default=None)
    table: LockTable = field(repr=False, default=None)
    graph: LockOrderGraph = field(repr=False, default=None)

    def to_dict(self) -> dict:
        return {
            "summary": {
                "total": len(self.findings),
                "new": len(self.new),
                "suppressed": len(self.suppressed),
                "stale_baseline_entries": len(self.stale),
            },
            "new": [f.to_dict() for f in self.new],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "stale": self.stale,
            "lock_order_edges": sorted(
                f"{o} -> {i}" for o, i in self.graph.pairs()),
            "locks": {
                ident: {"kind": d.kind, "file": d.file, "line": d.line}
                for ident, d in sorted(self.table.defs.items())
            },
        }


def run_analysis(roots: Optional[List[Path]] = None,
                 baseline_path: Optional[Path] = None,
                 include_analysis: bool = False,
                 only: Optional[List[str]] = None) -> Report:
    roots = roots or [DEFAULT_ROOT]
    exclude = () if include_analysis else ("analysis",)
    pkg = Package.load(roots, exclude_parts=exclude)
    table = collect_locks(pkg)
    graph = build_lock_order(pkg, table)
    findings = run_checks(pkg, table, graph) + run_io_checks(pkg)
    if only:
        findings = [f for f in findings if f.check in only]
    baseline = Baseline.load(baseline_path) if baseline_path else Baseline()
    new, suppressed, stale = baseline.split(findings)
    if only:
        # a scoped run can't tell whether other checkers' entries are
        # stale — only report staleness for the checks actually run
        fps = {e["fingerprint"]: e for e in baseline.raw}
        stale = [fp for fp in stale
                 if fps.get(fp, {}).get("check") in only]
    return Report(findings=findings, new=new, suppressed=suppressed,
                  stale=stale, pkg=pkg, table=table, graph=graph)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch-lint",
        description="Concurrency + I/O-discipline lint for the startup "
                    "stack (lock order, blocking-under-lock, leaks, "
                    "priority dataflow, scheduler/accounting coverage).")
    ap.add_argument("--root", action="append", type=Path, default=None,
                    help="source root(s) to lint (default: src/repro_torch)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="known-good baseline JSON; only NEW findings fail")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current findings: "
                         "stale entries are pruned, existing "
                         "justifications kept")
    ap.add_argument("--only", action="append", default=None,
                    metavar="CHECK",
                    help="run only this checker (repeatable), e.g. "
                         "--only unscheduled-io")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="output format; json prints the full report "
                         "to stdout")
    ap.add_argument("--report", type=Path, default=None,
                    help="write the full JSON report here (CI artifact)")
    ap.add_argument("--include-analysis", action="store_true",
                    help="also lint the analysis package itself")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print suppressed findings")
    args = ap.parse_args(argv)

    rep = run_analysis(roots=args.root, baseline_path=args.baseline,
                       include_analysis=args.include_analysis,
                       only=args.only)

    if args.report:
        args.report.write_text(json.dumps(rep.to_dict(), indent=2) + "\n")
    if args.write_baseline:
        if args.baseline is None:
            print("--write-baseline requires --baseline", file=sys.stderr)
            return 2
        base = Baseline.load(args.baseline)
        keep = None
        if args.only:
            # scoped rewrite: leave other checkers' entries untouched
            keep = [e for e in base.raw
                    if e.get("check") not in set(args.only)]
        base.save(args.baseline, rep.findings, keep=keep)
        pruned = len(rep.stale)
        print(f"baseline rewritten: {len(rep.findings)} suppression(s), "
              f"{pruned} stale entr{'y' if pruned == 1 else 'ies'} "
              f"pruned -> {args.baseline}")
        return 0

    if args.format == "json":
        print(json.dumps(rep.to_dict(), indent=2))
        return 1 if rep.new else 0

    print(f"repro-torch-lint: {len(rep.findings)} finding(s), "
          f"{len(rep.suppressed)} baselined, {len(rep.new)} new; "
          f"{len(rep.graph.pairs())} lock-order edge(s), "
          f"{len(rep.table.defs)} lock(s)")
    for f in rep.new:
        print("NEW " + f.format())
    if args.verbose:
        for f in rep.suppressed:
            print("baselined " + f.format())
    for fp in rep.stale:
        print(f"warning: stale baseline entry {fp} (finding no longer "
              f"produced — run --write-baseline to prune)")
    return 1 if rep.new else 0


if __name__ == "__main__":
    sys.exit(main())
