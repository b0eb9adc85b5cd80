"""BootSeer's profiling system (§4.1, Fig. 8), and the port's spans.

Worker nodes emit stage-transition log lines ("print/echo instrumentation");
a per-node LogParser extracts StageEvents; the central StageAnalysisService
groups them into per-node and per-job stage durations, which power both the
§3 characterization and the §5 evaluation.

``span(name)`` marks work that repeats (a training step and its phases, a
restore's reads) while a ``torch.profiler`` session records: a
``record_function`` of that name on the profiler's timeline, beside the
card's kernels, and a ``SpanRecord`` kept in memory (``spans()``) on the
trace's clock, ``time.time_ns()``. Spans nest by context: a span's
``trace`` is its root's id, its ``parent`` the span it ran inside, and work
handed to another thread under ``contextvars.copy_context()`` keeps both.
While nothing records a span is one flag check and a shared no-op context.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import re
import statistics
import threading
import time
from collections import defaultdict, deque
from contextvars import ContextVar
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, NamedTuple, Optional, TextIO

from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

from repro_torch.core.stages import GPU_CONSUMING, STAGE_ORDER, Stage

_LINE = "BOOTSEER_STAGE ts={ts:.6f} job={job} node={node} stage={stage} ev={ev}\n"
_RE = re.compile(
    r"BOOTSEER_STAGE ts=(?P<ts>[\d.]+) job=(?P<job>\S+) node=(?P<node>\S+) "
    r"stage=(?P<stage>\S+) ev=(?P<ev>BEGIN|END)")


@dataclass(frozen=True)
class StageEvent:
    ts: float
    job: str
    node: str
    stage: str
    ev: str  # BEGIN | END


class StageLogger:
    """Per-node logger: writes the 'print' instrumentation lines."""

    def __init__(self, job: str, node: str, sink: Optional[TextIO] = None,
                 clock=time.perf_counter):
        self.job = job
        self.node = node
        self.sink = sink if sink is not None else io.StringIO()
        self.clock = clock

    def begin(self, stage: Stage | str, ts: Optional[float] = None):
        self._emit(stage, "BEGIN", ts)

    def end(self, stage: Stage | str, ts: Optional[float] = None):
        self._emit(stage, "END", ts)

    def _emit(self, stage, ev, ts):
        name = stage.value if isinstance(stage, Stage) else str(stage)
        self.sink.write(_LINE.format(
            ts=self.clock() if ts is None else ts, job=self.job,
            node=self.node, stage=name, ev=ev))

    class _Ctx:
        def __init__(self, logger, stage):
            self.logger, self.stage = logger, stage

        def __enter__(self):
            self.logger.begin(self.stage)

        def __exit__(self, *exc):
            self.logger.end(self.stage)

    def stage(self, stage: Stage | str) -> "_Ctx":
        return self._Ctx(self, stage)

    def lines(self) -> str:
        return self.sink.getvalue() if isinstance(self.sink, io.StringIO) \
            else ""


class SpanRecord(NamedTuple):
    """One span: ``trace`` is its root's ``id`` (its own for a root),
    ``parent`` the id of the span it ran inside (None for a root),
    ``thread`` the native id of the thread it ran on, ``start_ns`` and
    ``end_ns`` on ``time.time_ns()``."""
    name: str
    id: int
    trace: int
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int


SPAN_LIMIT = 1 << 16     # records kept; the oldest go first
_span_lock = threading.Lock()
_span_records: deque = deque(maxlen=SPAN_LIMIT)
_span_dropped = 0
_span_ids = itertools.count(1)
# (trace, id) of the span the running code is inside
_span_current: ContextVar[Optional[tuple]] = ContextVar(
    "repro_torch_span", default=None)
_SPAN_OFF = contextlib.nullcontext()


def _add_seconds(times: dict, key: str, ns: int) -> None:
    times[key] = times.get(key, 0.0) + ns / 1e9


class _Timed:
    """A span's duration added to ``times[key]``, nothing recorded."""
    __slots__ = ("times", "key", "start")

    def __init__(self, times: dict, key: str):
        self.times, self.key = times, key

    def __enter__(self):
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        _add_seconds(self.times, self.key,
                     time.perf_counter_ns() - self.start)


class _Span:
    __slots__ = ("name", "times", "key", "scope", "token", "id", "trace",
                 "parent", "start")

    def __init__(self, name, times, key):
        self.name, self.times, self.key = name, times, key

    def __enter__(self):
        self.scope = record_function(self.name)
        self.scope.__enter__()
        outer = _span_current.get()
        self.id = next(_span_ids)
        self.trace, self.parent = ((self.id, None) if outer is None
                                   else outer)
        self.token = _span_current.set((self.trace, self.id))
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _span_dropped
        end = time.time_ns()
        _span_current.reset(self.token)
        self.scope.__exit__(*exc)
        rec = SpanRecord(self.name, self.id, self.trace, self.parent,
                         threading.get_native_id(), self.start, end)
        with _span_lock:
            if len(_span_records) == SPAN_LIMIT:
                _span_dropped += 1
            _span_records.append(rec)
        if self.times is not None:
            _add_seconds(self.times, self.key, end - self.start)


def span(name: str, times: Optional[dict] = None, key: str = ""):
    """A context that marks ``name``'s work while a ``torch.profiler``
    session records (a ``record_function`` and a ``SpanRecord``). With
    ``times`` it also adds its seconds to ``times[key]``, recorded or not:
    from the record's two clock reads, or from ``time.perf_counter_ns()``
    while nothing records; without, while nothing records, it is a shared
    no-op."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name, times, key)
    return _SPAN_OFF if times is None else _Timed(times, key)


def spans() -> list[SpanRecord]:
    """A copy of the kept records, oldest first."""
    with _span_lock:
        return list(_span_records)


def spans_dropped() -> int:
    """Records dropped to keep ``SPAN_LIMIT``, always the oldest."""
    return _span_dropped


def parse_log(text: str | Iterable[str]) -> list[StageEvent]:
    """The per-node Log Parser: log lines -> StageEvents."""
    if isinstance(text, str):
        text = text.splitlines()
    out = []
    for line in text:
        m = _RE.search(line)
        if m:
            out.append(StageEvent(ts=float(m["ts"]), job=m["job"],
                                  node=m["node"], stage=m["stage"],
                                  ev=m["ev"]))
    return out


class StageAnalysisService:
    """Central aggregation: events -> stage durations -> job analytics."""

    def __init__(self):
        # job -> node -> stage -> [begin, end]
        self._spans: dict = defaultdict(lambda: defaultdict(dict))

    def ingest(self, events: Iterable[StageEvent]):
        for e in events:
            span = self._spans[e.job][e.node].setdefault(
                e.stage, [None, None])
            span[0 if e.ev == "BEGIN" else 1] = e.ts

    def ingest_log(self, text: str):
        self.ingest(parse_log(text))

    # ----- queries -----

    def jobs(self) -> list[str]:
        return sorted(self._spans)

    def node_stage_durations(self, job: str) -> dict[str, dict[str, float]]:
        """{node: {stage: seconds}} (only completed spans)."""
        out = {}
        for node, stages in self._spans[job].items():
            d = {s: span[1] - span[0] for s, span in stages.items()
                 if span[0] is not None and span[1] is not None}
            out[node] = d
        return out

    def node_level_overhead(self, job: str) -> dict[str, float]:
        """Per node: sum of all startup stage durations (§3 definition —
        excludes waiting for other nodes).  Fine-grained ``task:`` spans
        are excluded: they subdivide the coarse stages and would double
        count (and, under the pipelined DAG, stages themselves overlap in
        wall time — this remains a *work* metric, not a span union)."""
        return {node: sum(v for s, v in d.items()
                          if not s.startswith("task:"))
                for node, d in self.node_stage_durations(job).items()}

    def task_spans(self, job: str) -> dict[str, dict[str, tuple]]:
        """{node: {task name: (begin, end)}} for the pipelined startup
        DAG's fine-grained ``task:`` spans (empty for pre-DAG logs) — the
        raw material of critical-path attribution, persisted through
        ``save``/``load`` like every other span."""
        out: dict = {}
        for node, stages in self._spans[job].items():
            d = {s[len("task:"):]: (span[0], span[1])
                 for s, span in stages.items()
                 if s.startswith("task:") and span[0] is not None
                 and span[1] is not None}
            if d:
                out[node] = d
        return out

    def task_overlap_s(self, job: str) -> dict[str, float]:
        """Per node: total pairwise overlap seconds between task spans —
        > 0 proves stages actually ran concurrently (the pipelined-DAG
        regression metric that replaces brittle wall-clock ratios on
        GIL-convoy-prone 2-CPU runners)."""
        out = {}
        for node, spans in self.task_spans(job).items():
            xs = sorted(spans.values())
            total = 0.0
            for i, (b1, e1) in enumerate(xs):
                for b2, e2 in xs[i + 1:]:
                    total += max(0.0, min(e1, e2) - max(b1, b2))
            out[node] = total
        return out

    def job_level_overhead(self, job: str) -> float:
        """Submission -> training begin (includes barriers/stragglers)."""
        begins, train_begin = [], []
        for node, stages in self._spans[job].items():
            spans = [s for s in stages.values() if s[0] is not None]
            if spans:
                begins.append(min(s[0] for s in spans))
            tr = stages.get(Stage.TRAINING.value)
            if tr and tr[0] is not None:
                train_begin.append(tr[0])
        if not begins or not train_begin:
            return float("nan")
        return max(train_begin) - min(begins)

    def stage_stats(self, job: str) -> dict[str, dict[str, float]]:
        """Per stage: min/median/max/mean duration across nodes."""
        per_stage = defaultdict(list)
        for node, d in self.node_stage_durations(job).items():
            for s, v in d.items():
                per_stage[s].append(v)
        out = {}
        for s, vals in per_stage.items():
            out[s] = {"min": min(vals), "median": statistics.median(vals),
                      "max": max(vals), "mean": statistics.fmean(vals),
                      "n": len(vals)}
        return out

    def max_median_ratio(self, job: str, stage: Stage | str) -> float:
        """The §3.3 straggler metric for one stage."""
        name = stage.value if isinstance(stage, Stage) else str(stage)
        vals = [d[name] for d in self.node_stage_durations(job).values()
                if name in d]
        if not vals:
            return float("nan")
        med = statistics.median(vals)
        return max(vals) / med if med > 0 else float("inf")

    def gpu_consuming_overhead(self, job: str) -> float:
        """Job-level duration of the GPU-consuming stages only (the §5
        metric: Image Loading + Environment Setup + Model Initialization,
        measured submission-to-train minus the scheduler stages)."""
        names = {s.value for s in GPU_CONSUMING}
        lo, hi = [], []
        for node, stages in self._spans[job].items():
            spans = [v for k, v in stages.items()
                     if k in names and v[0] is not None and v[1] is not None]
            if spans:
                lo.append(min(s[0] for s in spans))
                hi.append(max(s[1] for s in spans))
        if not lo:
            return float("nan")
        return max(hi) - min(lo)

    def to_records(self) -> list[dict]:
        """Flat records for storage/visualization (one per node-stage)."""
        recs = []
        for job, nodes in self._spans.items():
            for node, stages in nodes.items():
                for stage, (b, e) in stages.items():
                    recs.append({"job": job, "node": node, "stage": stage,
                                 "begin": b, "end": e,
                                 "duration": (e - b) if b is not None
                                 and e is not None else None})
        return recs

    def save(self, path: str | Path):
        Path(path).write_text(json.dumps(self.to_records()))

    @classmethod
    def load(cls, path: str | Path) -> "StageAnalysisService":
        svc = cls()
        for r in json.loads(Path(path).read_text()):
            if r["begin"] is not None:
                svc.ingest([StageEvent(r["begin"], r["job"], r["node"],
                                       r["stage"], "BEGIN")])
            if r["end"] is not None:
                svc.ingest([StageEvent(r["end"], r["job"], r["node"],
                                       r["stage"], "END")])
        return svc
