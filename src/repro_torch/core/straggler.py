"""Straggler analytics (§3.3): Max/Median ratios, long-tail summaries."""

from __future__ import annotations

import statistics
from typing import Iterable, Sequence


def max_median_ratio(durations: Sequence[float]) -> float:
    if not durations:
        return float("nan")
    med = statistics.median(durations)
    return max(durations) / med if med > 0 else float("inf")


def tail_summary(durations: Sequence[float]) -> dict:
    """Long-tail description: p50/p90/p99/max + tail fraction (Fig. 7)."""
    if not durations:
        return {}
    xs = sorted(durations)
    n = len(xs)
    q = lambda p: xs[min(int(p * (n - 1)), n - 1)]
    p99 = q(0.99)
    return {
        "n": n, "p50": q(0.50), "p90": q(0.90), "p99": p99, "max": xs[-1],
        "mean": statistics.fmean(xs),
        "max_median_ratio": max_median_ratio(xs),
        "tail_fraction_over_1p5x_median": sum(
            1 for x in xs if x > 1.5 * q(0.50)) / n,
    }


def barrier_cost(durations: Sequence[float]) -> float:
    """GPU-seconds wasted waiting at a sync barrier: sum(max - d_i)."""
    if not durations:
        return 0.0
    mx = max(durations)
    return sum(mx - d for d in durations)


def gating_share(critical_paths: dict) -> dict:
    """Per task, the fraction of nodes whose gating chain it DOMINATES
    (normalized ``repro_torch.core.pipeline.gating_counts``): under the
    pipelined DAG the straggler question shifts from "which node was
    slowest" to "which chain kept TRAINING waiting, and which link of it
    is worth optimizing next"."""
    from repro_torch.core.pipeline import gating_counts

    counts = gating_counts(critical_paths)
    total = sum(counts.values())
    if not total:
        return {}
    return {task: n / total for task, n in counts.items()}
