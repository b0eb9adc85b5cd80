"""The program's spans (``repro_torch.core.profiler.spans()``) of the traced
timeline window, for the readers of ``program_span`` metrics.

The harness traces two windows of ``run.trace.units`` units each, the
timeline's and then the one with the operators' shapes, whose host runs
slower: so of the root spans named for the cell's unit, the last 2 N are
the two windows', and the first N of those the timeline's. A program
without spans, a window with fewer roots, or one that may have lost
records to the program's bound on them, gives None.
"""

from __future__ import annotations


def units(run, root: str):
    """[the records of each unit's trace, its root first] for the N units
    of the timeline window whose root span is ``root``, or None."""
    try:
        from repro_torch.core.profiler import spans, spans_dropped
    except ImportError:
        return None
    tr = run.trace
    if tr is None or not tr.units:
        return None
    n = tr.units
    records = spans()
    roots = [r for r in records if r.parent is None and r.name == root]
    if len(roots) < 2 * n:
        return None
    chosen = roots[-2 * n:][:n]
    # the dropped are the oldest, ended before the oldest kept one did
    if spans_dropped() and records[0].end_ns > chosen[0].start_ns:
        return None
    by_trace = {r.id: [r] for r in chosen}
    for r in records:
        if r.trace in by_trace and r.parent is not None:
            by_trace[r.trace].append(r)
    return [by_trace[r.id] for r in chosen]


def seconds(record) -> float:
    return (record.end_ns - record.start_ns) / 1e9


def total(unit: list, name: str) -> float:
    """Seconds of every span named ``name`` in one unit's records."""
    return sum(seconds(r) for r in unit if r.name == name)


def mean_per_unit(run, root: str, name: str):
    """Seconds of ``name`` a unit over the timeline window, or None when
    the window has no such span."""
    window = units(run, root)
    if not window or not any(r.name == name for u in window for r in u):
        return None
    return sum(total(u, name) for u in window) / len(window)
