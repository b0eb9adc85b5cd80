"""Startup-stage report: render the StageAnalysisService's view of one or
more jobs as the tables the paper's dashboards show (§4.1 Fig. 8
"visualization", §3 breakdowns).

    PYTHONPATH=src python -m repro_torch.core.report <records.json>
"""

from __future__ import annotations

import sys
from typing import Optional

from repro_torch.core.profiler import StageAnalysisService
from repro_torch.core.stages import GPU_CONSUMING, STAGE_ORDER, Stage


def render_job(svc: StageAnalysisService, job: str) -> str:
    lines = [f"== job {job} =="]
    stats = svc.stage_stats(job)
    header = (f"  {'stage':<16} {'min':>8} {'median':>8} {'max':>8} "
              f"{'max/med':>8} {'nodes':>6}")
    lines.append(header)
    lines.append("  " + "-" * (len(header) - 2))
    for stage in STAGE_ORDER:
        s = stats.get(stage.value)
        if not s:
            continue
        ratio = s["max"] / s["median"] if s["median"] > 0 else float("inf")
        gpu = "*" if stage in GPU_CONSUMING else " "
        lines.append(
            f" {gpu}{stage.value:<16} {s['min']:8.2f} {s['median']:8.2f} "
            f"{s['max']:8.2f} {ratio:8.2f} {s['n']:6d}")
    node = svc.node_level_overhead(job)
    if node:
        med = sorted(node.values())[len(node) // 2]
        lines.append(f"  node-level overhead (median): {med:.2f}s")
    jl = svc.job_level_overhead(job)
    lines.append(f"  job-level overhead: {jl:.2f}s"
                 f"  (* = GPU-consuming stages)")
    gco = svc.gpu_consuming_overhead(job)
    lines.append(f"  GPU-consuming overhead: {gco:.2f}s")
    return "\n".join(lines)


def render_critical_paths(crit: dict) -> str:
    """Render a ``StartupResult.notes["critical_path"]`` mapping: which
    task chain gated TRAINING on each node, plus the job-wide share of
    nodes gated by each dominant task."""
    from repro_torch.core.straggler import gating_share

    lines = ["== critical-path attribution =="]
    share = gating_share(crit)
    if share:
        lines.append("  share of nodes whose gating chain each task "
                     "dominates:")
        for task, frac in share.items():
            lines.append(f"    {task:<24} {frac:6.0%}")
    for node in sorted(crit):
        attr = crit[node]
        chain = attr.get("chain", [])
        if not chain:
            continue
        dom = attr.get("dominant")
        parts = " -> ".join(
            t + ("*" if t == dom else "") for t in chain)
        lines.append(f"  {node}: {parts}  "
                     f"(train-ready {attr.get('train_ready_s', 0.0):.2f}s, "
                     f"* = dominant)")
    return "\n".join(lines)


def render_all(svc: StageAnalysisService) -> str:
    return "\n\n".join(render_job(svc, j) for j in svc.jobs())


def main(argv: Optional[list] = None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return
    svc = StageAnalysisService.load(argv[0])
    print(render_all(svc))


if __name__ == "__main__":
    main()
