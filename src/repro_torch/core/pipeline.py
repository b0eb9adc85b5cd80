"""Pipelined startup DAG: per-node task graphs on a bandwidth-aware,
priority-ordered I/O scheduler.

The seed runtime ran the three Worker-Phase stages strictly sequentially
with a full cross-node ``threading.Barrier`` after every stage, so warm
startup wall time was the **sum** of three I/O-bound stages and every
barrier re-amplified stragglers (§3.3).  The stages' true data dependencies
are much finer than "barrier between each": env-cache restore and the
checkpoint params wave depend only on DFS availability, *not* on image
loading finishing — their striped reads can start at t=0 and overlap the
swarm fetch.  This module provides the two pieces that make the critical
path the **max** of the overlappable chains instead of the sum:

``IOScheduler``
    One shared priority-aware token scheduler for all engine I/O.  Each
    named resource (registry egress, DFS preads, peer links) holds a fixed
    number of tokens; acquisition order is strict priority then FIFO, so a
    CRITICAL startup read is granted the next free token even when
    DEFERRED work (cold image streaming, the optimizer-state restore wave)
    arrived first.  Deferred streams acquire one token *per block/batch*,
    so "preemption" happens cooperatively at block granularity — a long
    cold stream can never convoy a later run's hot prefetch on the
    2-CPU-class nodes we simulate.

``run_node_dags``
    Executes one task DAG per worker node, either ``pipelined`` (tasks
    start the moment their declared dependencies finish; the only
    remaining cross-node sync is ONE pre-TRAINING event) or ``sequential``
    (the seed's barrier-per-stage order, kept as the measurable baseline
    and driven through the *same task bodies*, so pipelined-vs-sequential
    comparisons and the hot-update sub-graph share one implementation).
    Every task execution is recorded (start/end/waited) and
    :func:`critical_path` recovers, per node, the dependency chain that
    actually gated TRAINING — the attribution surfaced in
    ``StartupResult.notes`` and the fig13 breakdown.
"""

from __future__ import annotations

import heapq
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from repro_torch.core.stages import Stage

# ----------------------------------------------------------------------
# priority classes (lower = more urgent)
# ----------------------------------------------------------------------

CRITICAL = 0      # gates a node's TRAINING start
ELEVATED = 1      # reserved middle class (no runtime caller today —
                  # candidates: record-phase uploads, restore-ahead)
DEFERRED = 2      # background streams (cold image blocks, opt-state wave)

_PRIORITY_NAMES = {CRITICAL: "critical", ELEVATED: "elevated",
                   DEFERRED: "deferred"}


class _TokenPool:
    __slots__ = ("tokens", "active", "cond", "waiting", "seq", "stats")

    def __init__(self, tokens: int):
        self.tokens = max(1, int(tokens))
        self.active = 0
        self.cond = threading.Condition()
        self.waiting: list[tuple[int, int]] = []   # heap of (priority, seq)
        self.seq = 0
        self.stats = {"acquires": 0, "waits": 0, "wait_s": 0.0,
                      "max_active": 0,
                      "bytes": {n: 0 for n in _PRIORITY_NAMES.values()}}


class IOScheduler:
    """Priority-aware token pools for the startup engines' shared I/O.

    ``tokens`` maps resource name -> concurrent-slot count; unknown
    resources are created on first use with ``default_tokens`` slots.
    The standard resources the runtime wires up:

    * ``"registry"`` — container-registry egress (block fetches),
    * ``"peer"``     — swarm peer-link serves (ACCOUNTING ONLY: no token
      is held across a peer fetch, because ``Swarm.fetch`` can park a
      caller in a singleflight wait; peer-link concurrency is bounded by
      the swarm's own per-holder ``serve_slots``),
    * ``"dfs"``      — striped/plain DFS preads (env archive, checkpoint).

    Waiters are granted strictly by (priority, arrival): a CRITICAL
    request never queues behind DEFERRED ones.  Holders are never
    interrupted — callers acquire per block/batch, which bounds how long a
    deferred stream can occupy a token (cooperative preemption).
    """

    DEFAULT_TOKENS = {"registry": 4, "peer": 8, "dfs": 8}

    def __init__(self, tokens: Optional[dict] = None, *,
                 default_tokens: int = 8):
        self.default_tokens = default_tokens
        self._master = threading.Lock()
        self._pools: dict[str, _TokenPool] = {
            name: _TokenPool(n)
            for name, n in {**self.DEFAULT_TOKENS, **(tokens or {})}.items()}

    def _pool(self, resource: str) -> _TokenPool:
        pool = self._pools.get(resource)
        if pool is None:
            with self._master:
                pool = self._pools.setdefault(
                    resource, _TokenPool(self.default_tokens))
        return pool

    @contextmanager
    def slot(self, resource: str, *, priority: int = CRITICAL,
             nbytes: int = 0):
        """Hold one token of ``resource`` for the duration of the block.

        ``nbytes`` is pure accounting (per-priority byte counters used by
        tests and the benchmark to prove deferred traffic stayed off the
        critical path)."""
        pool = self._pool(resource)
        t0 = time.perf_counter()
        with pool.cond:
            pool.seq += 1
            me = (priority, pool.seq)
            waited = False
            try:
                heapq.heappush(pool.waiting, me)
                while pool.active >= pool.tokens or pool.waiting[0] != me:
                    waited = True
                    pool.cond.wait()
            except BaseException:
                # an interrupted waiter must not wedge the pool: a stale
                # heap entry at the head blocks every later acquire
                if me in pool.waiting:
                    pool.waiting.remove(me)
                    heapq.heapify(pool.waiting)
                pool.cond.notify_all()
                raise
            heapq.heappop(pool.waiting)
            pool.active += 1
            st = pool.stats
            st["acquires"] += 1
            st["max_active"] = max(st["max_active"], pool.active)
            st["bytes"][_PRIORITY_NAMES.get(priority, "deferred")] += nbytes
            if waited:
                st["waits"] += 1
                st["wait_s"] += time.perf_counter() - t0
            # a head-of-heap change may have unblocked another waiter
            pool.cond.notify_all()
        try:
            yield
        finally:
            with pool.cond:
                pool.active -= 1
                pool.cond.notify_all()

    def account(self, resource: str, priority: int, nbytes: int):
        """Post-hoc byte accounting for fetches whose size is only known
        after the transfer (block fetches)."""
        pool = self._pool(resource)
        with pool.cond:
            pool.stats["bytes"][
                _PRIORITY_NAMES.get(priority, "deferred")] += nbytes

    def critical_waiting(self, resource: str) -> bool:
        """Is a better-than-DEFERRED request currently queued?  Utility
        for deferred bulk loops that want to yield mid-batch; the
        runtime's own streams don't need it — they already yield by
        re-acquiring one token per block/batch."""
        pool = self._pool(resource)
        with pool.cond:
            return any(p < DEFERRED for p, _ in pool.waiting)

    def snapshot(self) -> dict:
        """Deep-copied per-resource stats (safe to stash in results)."""
        out = {}
        for name, pool in list(self._pools.items()):
            with pool.cond:
                st = pool.stats
                out[name] = {"tokens": pool.tokens,
                             "acquires": st["acquires"],
                             "waits": st["waits"],
                             "wait_s": st["wait_s"],
                             "max_active": st["max_active"],
                             "bytes": dict(st["bytes"])}
        return out


# ----------------------------------------------------------------------
# task DAG
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class TaskSpec:
    """One unit of per-node startup work.

    ``fn`` receives ``{dep name: dep return value}``.  ``stage`` maps the
    task onto the paper's coarse §2.2 stage for profiler continuity.
    ``gating=False`` marks work that must NOT hold back TRAINING (cold
    image streaming, the optimizer-state wave): the executor hands it back
    as a deferred thunk instead of running it on the critical path.
    """

    name: str
    fn: Callable[[dict], Any]
    deps: tuple = ()
    stage: Optional[Stage] = None
    gating: bool = True


@dataclass
class TaskRecord:
    name: str
    deps: tuple
    start: float = 0.0
    end: float = 0.0
    waited_s: float = 0.0     # start - max(dep ends): scheduling delay

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class NodeDagResult:
    records: dict = field(default_factory=dict)   # name -> TaskRecord
    values: dict = field(default_factory=dict)    # name -> fn return
    deferred: list = field(default_factory=list)  # (name, thunk)


def _check_dag(tasks: Sequence[TaskSpec]):
    names = [t.name for t in tasks]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate task names in DAG: {names}")
    known = set(names)
    non_gating = {t.name for t in tasks if not t.gating}
    for t in tasks:
        missing = [d for d in t.deps if d not in known]
        if missing:
            raise ValueError(f"task {t.name!r} depends on unknown {missing}")
        if t.gating:
            bad = [d for d in t.deps if d in non_gating]
            if bad:
                raise ValueError(
                    f"gating task {t.name!r} depends on deferred {bad}: "
                    "the chain could never release TRAINING")
    # cycle check: Kahn
    done: set = set()
    pending = list(tasks)
    while pending:
        ready = [t for t in pending if all(d in done for d in t.deps)]
        if not ready:
            raise ValueError(
                f"dependency cycle among {[t.name for t in pending]}")
        done.update(t.name for t in ready)
        pending = [t for t in pending if t.name not in done]


class _NodeRun:
    """Scheduling state for one node's DAG during a pipelined run."""

    def __init__(self, tasks: Sequence[TaskSpec], logger=None,
                 clock=time.perf_counter):
        _check_dag(tasks)
        self.tasks = {t.name: t for t in tasks}
        self.logger = logger
        self.clock = clock
        self.result = NodeDagResult()
        self.done: set = set()
        self.launched: set = set()
        # stage bookkeeping: BEGIN on first task of a stage, END when the
        # stage's last gating task completes (deferred tasks are off-stage)
        self._stage_pending: dict = {}
        for t in tasks:
            if t.stage is not None and t.gating:
                self._stage_pending.setdefault(t.stage, set()).add(t.name)
        self._stage_begun: set = set()

    def gating_names(self) -> list:
        return [t.name for t in self.tasks.values() if t.gating]

    def ready(self) -> list:
        out = []
        for t in self.tasks.values():
            if t.name in self.launched or not t.gating:
                continue
            if all(d in self.done for d in t.deps):
                out.append(t)
        return out

    def run_task(self, t: TaskSpec):
        rec = TaskRecord(name=t.name, deps=t.deps)
        dep_end = max((self.result.records[d].end for d in t.deps
                       if d in self.result.records), default=None)
        rec.start = self.clock()
        if dep_end is not None:
            rec.waited_s = max(0.0, rec.start - dep_end)
        if self.logger is not None and t.stage is not None \
                and t.stage not in self._stage_begun:
            self._stage_begun.add(t.stage)
            self.logger.begin(t.stage, ts=rec.start)
        deps_out = {d: self.result.values.get(d) for d in t.deps}
        value = t.fn(deps_out)
        rec.end = self.clock()
        self.result.records[t.name] = rec
        self.result.values[t.name] = value
        if self.logger is not None:
            # fine-grained span: powers StageAnalysisService.task_spans
            # (persists with save/load, unlike in-memory TaskRecords)
            self.logger.begin(f"task:{t.name}", ts=rec.start)
            self.logger.end(f"task:{t.name}", ts=rec.end)
        if self.logger is not None and t.stage is not None:
            pend = self._stage_pending.get(t.stage)
            if pend is not None:
                pend.discard(t.name)
                if not pend:
                    self.logger.end(t.stage, ts=rec.end)
        return rec

    def collect_deferred(self):
        """Non-gating tasks whose deps completed become deferred thunks
        (run later on the runtime's cold pool, with DEFERRED-priority
        I/O).  A non-gating task whose dependency failed is dropped."""
        for t in self.tasks.values():
            if t.gating or t.name in self.launched:
                continue
            if all(d in self.done for d in t.deps):
                deps_out = {d: self.result.values.get(d) for d in t.deps}
                self.result.deferred.append(
                    (t.name, lambda t=t, deps_out=deps_out: t.fn(deps_out)))


def run_node_dags(node_tasks: Sequence[Sequence[TaskSpec]], *,
                  pipelined: bool = True, loggers=None,
                  clock=time.perf_counter,
                  max_workers: Optional[int] = None) -> list:
    """Execute one task DAG per node; returns a ``NodeDagResult`` per node.

    ``pipelined=True``: every gating task starts the moment its declared
    deps finish; no cross-node synchronization happens here at all — the
    caller owns the single pre-TRAINING event.  ``pipelined=False``
    re-creates the seed behaviour: tasks grouped by paper stage, one
    cross-node barrier (wait-for-all) between stages, dependencies *within*
    a stage still honored.

    Tasks are I/O-bound (sleeps and syscalls release the GIL) so the pool
    is sized to the full width of the forest (up to 3 concurrent chains
    per node — image, env, ckpt), with a CPU-scaled cap: on 2-CPU-class
    hosts, thread spawn (~2 ms each) and GIL convoy from very wide pools
    cost MORE than the queueing they avoid (measured: a 96-thread pool
    at 32 nodes doubles pipelined walltime vs a 32-thread pool), while
    larger hosts get proportionally more headroom.
    """
    import os

    n = len(node_tasks)
    loggers = loggers or [None] * n
    runs = [_NodeRun(tasks, logger=loggers[i], clock=clock)
            for i, tasks in enumerate(node_tasks)]
    width = max((len(r.tasks) for r in runs), default=1)
    cap = max(32, 4 * (os.cpu_count() or 2))
    workers = max_workers or min(cap, max(2, n * min(width, 3)))

    errors: list = []
    lock = threading.Lock()
    all_done = threading.Event()
    inflight = 0

    if not pipelined:
        _run_sequential(runs)
        return [r.result for r in runs]

    with ThreadPoolExecutor(workers,
                            thread_name_prefix="bootseer-dag") as pool:

        def finish_one(run: _NodeRun, name: str):
            nonlocal inflight
            launch: list = []
            with lock:
                inflight -= 1
                run.done.add(name)
                if not errors:
                    launch = [t for t in run.ready()
                              if t.name not in run.launched]
                    for t in launch:
                        run.launched.add(t.name)
                        inflight += 1
                if inflight == 0:
                    all_done.set()
            for t in launch:
                pool.submit(exec_task, run, t)

        def exec_task(run: _NodeRun, t: TaskSpec):
            try:
                run.run_task(t)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                with lock:
                    errors.append(e)
                    run.done.add(t.name)
            finish_one(run, t.name)

        seeds: list = []
        with lock:
            for run in runs:
                for t in run.ready():
                    run.launched.add(t.name)
                    inflight += 1
                    seeds.append((run, t))
            if inflight == 0:
                all_done.set()
        for run, t in seeds:
            pool.submit(exec_task, run, t)
        all_done.wait()

    if errors:
        raise errors[0]
    for run in runs:
        remaining = set(run.gating_names()) - run.done
        if remaining:  # a dep chain was starved (should be impossible)
            raise RuntimeError(f"DAG stalled; tasks never ran: {remaining}")
        run.collect_deferred()
    return [r.result for r in runs]


def _run_sequential(runs: list) -> None:
    """The seed's barrier-per-stage schedule over the same task bodies:
    stage k on every node, wait for ALL nodes (the §3.3 straggler wall),
    then stage k+1."""
    stage_order = [Stage.IMAGE_LOAD, Stage.ENV_SETUP, Stage.MODEL_INIT]
    # tasks with no stage run with the stage of their first staged dep
    # fallback: append to the last group
    groups: list[list[tuple[_NodeRun, TaskSpec]]] = [[] for _ in stage_order]
    group_idx: dict[int, dict[str, int]] = {}    # id(run) -> name -> group
    for run in runs:
        group_idx[id(run)] = {}
        for t in run.tasks.values():
            if not t.gating:
                continue
            idx = stage_order.index(t.stage) if t.stage in stage_order \
                else len(stage_order) - 1
            groups[idx].append((run, t))
            group_idx[id(run)][t.name] = idx
    # the stage schedule can only honor deps pointing to the SAME or an
    # EARLIER group — a backward edge would run a task before its dep
    # (with a None dep value) instead of failing loudly
    for run in runs:
        gi = group_idx[id(run)]
        for t in run.tasks.values():
            if not t.gating:
                continue
            for d in t.deps:
                if gi.get(d, -1) > gi[t.name]:
                    raise ValueError(
                        f"sequential schedule cannot honor dependency "
                        f"{t.name!r} -> {d!r}: the dep is in a LATER "
                        f"stage group ({run.tasks[d].stage} after "
                        f"{t.stage})")
    n_threads = max(len(runs), 1)
    with ThreadPoolExecutor(n_threads,
                            thread_name_prefix="bootseer-seq") as pool:
        for group in groups:
            if not group:
                continue
            per_run: dict[int, list[TaskSpec]] = {}
            for run, t in group:
                per_run.setdefault(id(run), []).append(t)
            run_by_id = {id(r): r for r in runs}

            def stage_body(rid):
                run = run_by_id[rid]
                pending = list(per_run[rid])
                names = {x.name for x in per_run[rid]}
                while pending:
                    ready = [t for t in pending
                             if all(d in run.done for d in t.deps
                                    if d in names)]
                    if not ready:   # unreachable: _check_dag is acyclic
                        raise RuntimeError(
                            f"sequential stage stalled on "
                            f"{[t.name for t in pending]}")
                    for t in ready:
                        run.launched.add(t.name)
                        run.run_task(t)
                        run.done.add(t.name)
                        pending.remove(t)

            futs = [pool.submit(stage_body, rid) for rid in per_run]
            for fu in futs:   # <- the cross-node barrier
                fu.result()
    for run in runs:
        run.collect_deferred()


# ----------------------------------------------------------------------
# critical-path attribution
# ----------------------------------------------------------------------

def critical_path(records: dict) -> list:
    """The dependency chain that gated this node's TRAINING start.

    Walk back from the gating task that finished last, at each step
    following the dependency that finished last (the one whose completion
    released the current task).  Returns task names root-first.
    """
    if not records:
        return []
    cur = max(records.values(), key=lambda r: r.end).name
    chain = [cur]
    while True:
        deps = [records[d] for d in records[cur].deps if d in records]
        if not deps:
            break
        cur = max(deps, key=lambda r: r.end).name
        chain.append(cur)
    return chain[::-1]


def attribution(result: NodeDagResult) -> dict:
    """Per-node critical-path report (the ``StartupResult.notes`` form).

    ``chain`` is the gating dependency chain root-first; ``gated_by`` its
    terminal task; ``dominant`` the chain member that consumed the most
    time (the task to optimize next)."""
    chain = critical_path(result.records)
    dominant = max(chain, key=lambda n: result.records[n].seconds) \
        if chain else None
    return {
        "chain": chain,
        "gated_by": chain[-1] if chain else None,
        "dominant": dominant,
        "train_ready_s": max((r.end for r in result.records.values()),
                             default=0.0),
        "tasks": {r.name: {"start": round(r.start, 6),
                           "end": round(r.end, 6),
                           "s": round(r.seconds, 6),
                           "waited_s": round(r.waited_s, 6)}
                  for r in result.records.values()},
    }


def gating_counts(critical_paths: dict) -> dict:
    """Aggregate {dominant gating task: node count} over per-node
    attributions (accepts the ``notes["critical_path"]`` mapping or plain
    {node: [chain]} dicts) — the fig13 / report summary of which task
    chain actually gated TRAINING across the job."""
    counts: dict[str, int] = {}
    for attr in critical_paths.values():
        if isinstance(attr, dict):
            gate = attr.get("dominant") or attr.get("gated_by") \
                or (attr.get("chain") or [None])[-1]
        else:
            gate = attr[-1] if attr else None
        if gate is not None:
            counts[gate] = counts.get(gate, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))
