"""The BootSeer runtime: executes a job's Worker-Phase startup on N (thread)
worker nodes with REAL I/O — lazy/prefetched image loading, env setup vs
env-cache restore, plain vs striped checkpoint resumption — every stage
profiled through the §4.1 logging system.

Startup is a per-node task DAG (repro_torch.core.pipeline), not a barrier-per-
stage pipeline: env-cache restore and the checkpoint params wave depend
only on DFS availability, so under the pipelined executor their striped
reads start at t=0 and overlap the swarm image fetch; ``env.install`` (the
real pip-install fallback) is the only task that truly needs the container
image.  The only remaining cross-node syncs are the single pre-TRAINING
event and the record-phase fences (trace capture inside rank 0's
``image.startup_reads``, env-cache creation inside rank 0's
``env.install``), which are ordinary DAG edges rather than
``threading.Barrier`` walls.  All engine I/O goes through one shared
priority-aware :class:`~repro_torch.core.pipeline.IOScheduler`, so deferred
streams (cold image blocks, the optimizer-state restore wave) can never
convoy a critical-path read.  ``pipeline=False`` keeps the seed's
barrier-per-stage schedule over the *same task bodies*.

A copy of the JAX package's ``core/bootseer.py``. The kernel tuning task
(``tune=True``) sweeps the card's compiled launch configs
(``repro_torch.tune.autotune``) unless ``tune_backend`` names the CPU,
whose sweeps run the plain versions.  The checkpointer it resumes from is
the port's torch ``Checkpointer``; the DAG reads its bytes (the params wave at
CRITICAL, the optimizer-state wave DEFERRED) and the launcher's
``train_loop`` then restores the tensors onto the card.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Optional

from repro_torch.blockstore.lazy import LazyImageClient
from repro_torch.blockstore.prefetch import HotBlockService, prefetch_image
from repro_torch.blockstore.registry import Registry
from repro_torch.blockstore.swarm import Swarm, Topology
from repro_torch.core.pipeline import (CRITICAL, DEFERRED, IOScheduler, TaskSpec,
                                 attribution, gating_counts, run_node_dags)
from repro_torch.core.profiler import StageAnalysisService, StageLogger
from repro_torch.core.stages import Stage, StartupTask
from repro_torch.dfs.fuse import HdfsFuseMount
from repro_torch.dfs.hdfs import HdfsCluster
from repro_torch.envcache.snapshot import EnvCache, job_cache_key, snapshot_dir
from repro_torch.fabric.cache import NodeCache
from repro_torch.fabric.federation import RegionReplicator
from repro_torch.tune import (ProfileStore, capture_launch_profile,
                              profile_drift)


@dataclass
class JobSpec:
    job_id: str
    image: str                       # registry manifest name or digest
    num_nodes: int = 2
    job_params: dict = field(default_factory=dict)
    # the container's startup file accesses (path, offset, length);
    # length -1 = whole file.  These define the image's hot set.
    startup_reads: list = field(default_factory=list)
    # the "install commands": callable(target_dir, node_id) that materializes
    # the dependency tree (and possibly sleeps, like a real pip install).
    env_setup: Optional[Callable] = None
    # checkpoint to resume (step number in the job's Checkpointer), or None
    resume_step: Optional[int] = None
    # per-rank restore planning for the resume stage (repro_torch.ckpt.plan):
    #   "full"  — every node reads the whole checkpoint;
    #   "rows"  — leading-dim row split across nodes (bytes_per_host);
    #   callable (index, rank, nodes) -> list[RestorePlan] — fully
    #   sharding-aware per-rank wave plans (e.g. built from Rules
    #   PartitionSpecs via Checkpointer.plan_restore).
    resume_plan: Any = "full"


@dataclass
class StartupResult:
    """One startup's profile.  ``notes["io_sched"]`` holds the runtime's
    scheduler counters, which are CUMULATIVE over the runtime's lifetime
    (the scheduler is shared across runs so cross-run priority holds);
    per-run figures are deltas against the previous run's snapshot."""

    job_id: str
    run_idx: int
    node_stage_s: dict               # node -> stage -> seconds
    total_s: float
    notes: dict = field(default_factory=dict)

    def critical_path(self, node: str) -> list:
        """The task chain that gated ``node``'s TRAINING start."""
        return self.notes.get("critical_path", {}).get(node, {}) \
            .get("chain", [])


class BootseerRuntime:
    def __init__(self, *, registry: Registry, hdfs: HdfsCluster,
                 workdir: str | Path, optimize: bool = True,
                 analysis: Optional[StageAnalysisService] = None,
                 hot_threads: int = 8, ckpt_threads: int = 8,
                 stripe_width: int = 8, nodes_per_rack: int = 8,
                 topology: Optional[Topology] = None,
                 pipeline: bool = True,
                 hot_root: Optional[str | Path] = None,
                 io_tokens: Optional[dict] = None,
                 cache_bytes: Optional[int] = None,
                 cache_policy: str = "lru",
                 env_cache_bytes: Optional[int] = None,
                 tune: bool = False,
                 tune_workloads: Optional[list] = None,
                 tune_store: Optional[ProfileStore] = None,
                 tune_join_timeout_s: float = 300.0,
                 tune_backend: Optional[str] = None):
        self.registry = registry
        self.hdfs = hdfs
        self.mount = HdfsFuseMount(hdfs)
        self.workdir = Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.optimize = optimize
        # pipeline=True (+optimize): per-node DAG execution — startup
        # critical path is the MAX of the overlappable chains.
        # pipeline=False: the seed's barrier-per-stage schedule over the
        # same task bodies (the sequential-optimized baseline).
        self.pipeline = pipeline
        self.analysis = analysis or StageAnalysisService()
        # one shared priority-aware I/O scheduler for ALL engines: hot
        # prefetch, env-archive windows and checkpoint preads run
        # CRITICAL; cold image streams and the opt-state wave run
        # DEFERRED and can never queue a critical read behind them
        self.io_sched = IOScheduler(io_tokens) if optimize else None
        # hot-block records default inside the workdir but may live on
        # shared storage (hot_root) so fresh nodes see existing records
        self.hot_service = HotBlockService(
            Path(hot_root) if hot_root else self.workdir / "_hotblocks")
        # storage-fabric node caches — one per (job, node), shared across
        # runs so warm restarts inherit the previous run's blocks.
        # ``cache_bytes`` bounds each; ``cache_policy`` picks the eviction
        # order ("lru", or "hot" — hot-block-score-aware, wired to the
        # HotBlockService so the blocks startups actually replay outlive
        # cold-streamed filler)
        self.cache_bytes = cache_bytes
        self.cache_policy = cache_policy
        self._node_caches: dict[tuple, NodeCache] = {}
        self._hot_scores: dict = {"t": float("-inf"), "idx": {}}
        # node-local archive cache: N worker threads restoring the same key
        # cost ONE DFS fetch (singleflight), not N through the shared throttle
        self.env_cache = EnvCache(
            self.mount, local_cache=self.workdir / "_envcache_local",
            local_cache_bytes=env_cache_bytes, sched=self.io_sched)
        self.hot_threads = hot_threads
        self.ckpt_threads = ckpt_threads
        self.stripe_width = stripe_width
        # ONE swarm per runtime, shared by every job/run: membership is
        # keyed by client identity (job+node+digest) and blocks are
        # content-addressed, so concurrent jobs coexist, warm restarts
        # rejoin, and block dedup serves across images.  A caller-built
        # ``topology`` (region pins, region_fn, per-link throttles live
        # on the Swarm) turns this into a multi-region federated swarm.
        self.swarm = (
            Swarm(topology or Topology(nodes_per_rack=nodes_per_rack))
            if optimize else None)
        self._run_counter: dict[str, int] = {}
        # one long-lived I/O pool shared by every node's prefetch across
        # runs: thread-spawn cost is paid once per runtime, and total
        # concurrency stays bounded instead of scaling with node count
        self._io_pool = ThreadPoolExecutor(
            hot_threads, thread_name_prefix="bootseer-io")
        # cold streaming gets its own (small) pool so a previous run's cold
        # remainder can never queue ahead of a later run's hot prefetch
        self._cold_pool = ThreadPoolExecutor(
            2, thread_name_prefix="bootseer-cold")
        # kernel autotuning (ROADMAP A.8): tune=True restores the
        # cluster's TuningProfile from the DFS as a non-gating DEFERRED
        # task on rank 0 — a warm restart fetches the tuned launch configs
        # with ZERO re-tuning (notes["tune_cache_hit"]); the first boot
        # sweeps tune_workloads (default: autotune.tiny_workloads()) once
        # and publishes.  The sweep runs on the card unless tune_backend
        # is autotune.CPU_BACKEND.  The store gets the runtime's
        # scheduler but a sched-less mount: it holds its own "dfs" slot
        # tokens.
        self.tune = bool(tune) and optimize
        self.tune_workloads = tune_workloads
        self.tune_join_timeout_s = tune_join_timeout_s
        self.tune_backend = tune_backend
        self.tune_store = tune_store
        if self.tune and self.tune_store is None:
            self.tune_store = ProfileStore(self.mount, sched=self.io_sched)
        # deferred background work (cold image streaming, optimizer-state
        # restore waves) must not fail silently: futures collect here and
        # drain_deferred() re-raises their failures.  All error state is
        # derived from the futures themselves — no done-callback
        # bookkeeping, which would race the Future waiters.
        self._deferred_futures: list = []

    def _submit_deferred(self, thunk):
        try:
            fut = self._cold_pool.submit(thunk)
        except RuntimeError:  # pool shut down (interpreter exit)
            return None
        self._deferred_futures.append(fut)
        return fut

    def drain_deferred(self):
        """Block until all deferred background work (cold image streaming,
        optimizer-state restore waves) has finished, then re-raise the
        first failure — e.g. a ``StripeMissingError`` from a wave-1 read —
        so a corrupt deferred restore cannot pass unnoticed."""
        futures, self._deferred_futures = self._deferred_futures, []
        errors = [err for err in (fut.exception() for fut in futures)
                  if err is not None]
        if errors:
            raise errors[0]

    def region_replicator(self, **kwargs) -> RegionReplicator:
        """A :class:`~repro_torch.fabric.federation.RegionReplicator` bound to
        this runtime's swarm and hot-block service.  Register each
        region's swarm-attached clients on it, then ``start()`` (or call
        ``replicate_once()`` between startups) to pre-stage hot blocks
        region-locally at DEFERRED priority — the caller owns ``stop()``.
        """
        if self.swarm is None:
            raise ValueError(
                "region replication needs optimize=True (no swarm)")
        return RegionReplicator(self.swarm, self.hot_service, **kwargs)

    def close(self):
        """Release the runtime's worker pools (idempotent).  Does not
        block on deferred work, but failures already observed in
        undrained deferred futures are at least reported before they are
        lost."""
        import sys
        for fut in self._deferred_futures:
            if fut.done() and fut.exception() is not None:
                print("bootseer: deferred background failure was never "
                      f"drained: {fut.exception()!r}", file=sys.stderr)
        self._deferred_futures = []
        self._io_pool.shutdown(wait=False)
        self._cold_pool.shutdown(wait=False)
        self.env_cache.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    # storage-fabric node caches
    # ------------------------------------------------------------------

    def _hot_score(self, key: str) -> float:
        """Hot-block score for the eviction policy; the merged score
        index is re-read from the record store at most every few seconds
        (victim scans must not re-parse trace files per key)."""
        now = time.monotonic()
        if now - self._hot_scores["t"] > 5.0:
            self._hot_scores = {"t": now,
                                "idx": self.hot_service.score_index()}
        return self._hot_scores["idx"].get(key, 0.0)

    def _node_cache(self, job_id: str, rank: int) -> NodeCache:
        """The per-(job, node) block cache: content-addressed and immutable
        blocks, so it survives job restarts (warm restarts re-read, never
        re-fetch) — now byte-bounded with pluggable eviction."""
        cache = self._node_caches.get((job_id, rank))
        if cache is None:
            cache = NodeCache(
                self.workdir / "_blockcache" / job_id / f"n{rank}",
                capacity_bytes=self.cache_bytes,
                policy=self.cache_policy,
                score_fn=self._hot_score)
            self._node_caches[(job_id, rank)] = cache
        return cache

    def _fabric_counters(self) -> dict:
        """Cumulative fabric counters (runtime lifetime): per-run figures
        in ``StartupResult.notes`` are deltas against the run-start
        snapshot."""
        caches = list(self._node_caches.values())
        if self.env_cache._local is not None:
            caches.append(self.env_cache._local)
        out = {"evictions": sum(c.stats["evictions"] for c in caches),
               "evicted_bytes": sum(c.stats["evicted_bytes"]
                                    for c in caches)}
        out.update(self.hdfs.fabric_stats)
        return out

    # ------------------------------------------------------------------
    # the startup task DAG (shared by run_startup and run_hot_update)
    # ------------------------------------------------------------------

    def _node_tasks(self, spec: JobSpec, rank: int, *, job_tag: str,
                    manifest, checkpointer, trace_holder: dict,
                    use_prefetch: bool, include_image: bool) -> list:
        """One node's startup DAG.  Edges are the REAL data dependencies:

            image.hot_prefetch ─→ image.startup_reads ─→ env.install
                                        (container)        ↑
            env.restore (DFS only, t=0) ───────────────────┘
            ckpt.params_wave (DFS only, t=0)
            image.cold_stream / ckpt.opt_wave: deferred (non-gating)

        A hot update is the sub-graph without the image tasks (container
        and image survive, so ``env.install`` loses that edge too).
        """
        node_dir = self.workdir / job_tag.replace("#", "_") / f"n{rank}"
        n = spec.num_nodes
        tasks: list[TaskSpec] = []

        if include_image:
            def img_prefetch(deps):
                node_dir.mkdir(parents=True, exist_ok=True)
                # the block cache is the fabric NodeCache per JOB+NODE,
                # not per run: image blocks are content-addressed and
                # immutable, so a node's local store survives job restarts
                # (warm restarts re-read, never re-fetch); under a byte
                # bound the client pins its startup working set and
                # withdraws evicted blocks from the swarm index
                cache = self._node_cache(spec.job_id, rank)
                client = LazyImageClient(
                    manifest, self.registry, cache.root,
                    node_id=f"node{rank:03d}",
                    peers=self.swarm if self.optimize else None,
                    client_id=(f"{spec.job_id}/n{rank}:"
                               f"{manifest.digest[:8]}"),
                    peer_replace=True, sched=self.io_sched, cache=cache)
                stream_cold = None
                if use_prefetch:
                    _, stream_cold = prefetch_image(
                        client, self.hot_service,
                        hot_threads=self.hot_threads,
                        pool=self._io_pool, defer_cold=True)
                return {"client": client, "stream_cold": stream_cold}

            def img_reads(deps):
                client = deps[StartupTask.IMAGE_HOT_PREFETCH]["client"]
                # container start: perform the startup file reads
                for path, off, ln in spec.startup_reads:
                    client.read_file(path, off, ln)
                if self.optimize and rank == 0 and not use_prefetch:
                    # record-phase fence: the trace is cut exactly when
                    # rank 0's startup reads complete
                    trace_holder["trace"] = client.access_trace()
                return client

            def img_cold(deps):
                stream = deps[StartupTask.IMAGE_HOT_PREFETCH]["stream_cold"]
                if stream is not None:
                    stream()

            tasks.append(TaskSpec(StartupTask.IMAGE_HOT_PREFETCH,
                                  img_prefetch, stage=Stage.IMAGE_LOAD))
            tasks.append(TaskSpec(StartupTask.IMAGE_STARTUP_READS,
                                  img_reads,
                                  deps=(StartupTask.IMAGE_HOT_PREFETCH,),
                                  stage=Stage.IMAGE_LOAD))
            if use_prefetch:
                tasks.append(TaskSpec(StartupTask.IMAGE_COLD_STREAM,
                                      img_cold,
                                      deps=(StartupTask.IMAGE_HOT_PREFETCH,),
                                      stage=Stage.IMAGE_LOAD, gating=False))

        def env_restore(deps):
            # depends only on DFS availability — NOT on the image: under
            # the pipelined executor this striped fetch starts at t=0
            node_dir.mkdir(parents=True, exist_ok=True)
            target = node_dir / "site-packages"
            target.mkdir(exist_ok=True)
            if not self.optimize:
                return None
            key = job_cache_key(spec.job_params)
            return self.env_cache.restore(key, target, priority=CRITICAL)

        def env_install(deps):
            # the real install commands run INSIDE the container, so this
            # is the one env task that truly needs the image
            restored = deps[StartupTask.ENV_RESTORE]
            target = node_dir / "site-packages"
            if restored is None and spec.env_setup is not None:
                before = snapshot_dir(target)
                spec.env_setup(target, rank)
                if self.optimize and rank == 0:
                    # record-phase fence: rank 0 snapshots its own install.
                    # The launch profile (LD_PRELOAD, the card, the CUDA
                    # toolkit, cuBLAS and allocator settings) the
                    # snapshot was captured under rides in
                    # the snapshot meta, so later restores can detect
                    # env drift against the recorded profile.
                    self.env_cache.create(
                        job_cache_key(spec.job_params), target, before,
                        spec.job_params,
                        launch_profile=capture_launch_profile().to_json())
            return restored is not None

        install_deps = (StartupTask.ENV_RESTORE,)
        if include_image:
            install_deps += (StartupTask.IMAGE_STARTUP_READS,)
        tasks.append(TaskSpec(StartupTask.ENV_RESTORE, env_restore,
                              stage=Stage.ENV_SETUP))
        tasks.append(TaskSpec(StartupTask.ENV_INSTALL, env_install,
                              deps=install_deps, stage=Stage.ENV_SETUP))

        def ckpt_params(deps):
            # wave-0 (params) preads depend only on DFS availability:
            # they start at t=0 and overlap the image fetch.  With the
            # optimizer on, the reads first consult the node's fabric
            # cache for ranges staged by restore-ahead prefetch — a warm
            # crash-restart replays the params wave from node-local disk
            if spec.resume_step is None or checkpointer is None:
                return None
            from repro_torch.ckpt.plan import read_plan
            reader, plans = _restore_plans(
                checkpointer, spec.resume_step, rank=rank, nodes=n,
                resume_plan=spec.resume_plan, sched=self.io_sched,
                cache=(self._node_cache(spec.job_id, rank)
                       if self.optimize else None),
                on_hit=lambda nb: self.hdfs.account_fabric(
                    restore_ahead_hit_bytes=nb))
            if not plans:
                return None
            read_plan(reader, plans[0], priority=CRITICAL)
            if not self.optimize:
                # baseline: both waves block model init, as the paper's
                # unoptimized runtime does
                for p in plans[1:]:
                    read_plan(reader, p)
                return None
            return (reader, plans[1:])

        def ckpt_opt(deps):
            handle = deps[StartupTask.CKPT_PARAMS_WAVE]
            if not handle:
                return 0
            from repro_torch.ckpt.plan import read_plan
            reader, tail = handle
            return sum(read_plan(reader, p, priority=DEFERRED)
                       for p in tail)

        tasks.append(TaskSpec(StartupTask.CKPT_PARAMS_WAVE, ckpt_params,
                              stage=Stage.MODEL_INIT))
        if self.optimize and spec.resume_step is not None \
                and checkpointer is not None:
            tasks.append(TaskSpec(StartupTask.CKPT_OPT_WAVE, ckpt_opt,
                                  deps=(StartupTask.CKPT_PARAMS_WAVE,),
                                  stage=Stage.MODEL_INIT, gating=False))

        def tune_restore(deps):
            # non-gating: the profile fetch (tiny, metered DFS read) —
            # or, on the first boot, the full autotune sweep — streams
            # off the startup critical path.  Exceptions stay inside the
            # returned info dict: a failed sweep must degrade to kernel
            # defaults, not poison the next run's drain_deferred().
            info: dict = {"hit": False, "invocations": 0}
            try:
                from repro_torch.tune import autotune
                t0 = autotune.stats["tune_invocations"]
                prof = self.tune_store.fetch()
                if prof is None:
                    wls = self.tune_workloads
                    if wls is None:
                        wls = autotune.tiny_workloads()
                    prof = autotune.build_profile(wls,
                                                  backend=self.tune_backend)
                    prof.store = self.tune_store
                    pub = self.tune_store.publish(prof)
                    info["digest"] = pub["digest"]
                else:
                    info["hit"] = True
                    info["digest"] = prof.digest()
                info["invocations"] = \
                    autotune.stats["tune_invocations"] - t0
                from repro_torch.tune.profile import set_active_profile
                set_active_profile(prof)
            except Exception as exc:  # noqa: BLE001
                info["error"] = repr(exc)
            return info

        if self.tune and rank == 0 and self.tune_store is not None:
            tasks.append(TaskSpec(StartupTask.TUNE_RESTORE, tune_restore,
                                  stage=Stage.MODEL_INIT, gating=False))
        return tasks

    def _run(self, spec: JobSpec, checkpointer, *, include_image: bool,
             tag: str) -> StartupResult:
        self.drain_deferred()
        run_idx = self._run_counter.get(spec.job_id, 0)
        self._run_counter[spec.job_id] = run_idx + 1
        job_tag = f"{spec.job_id}#{tag}{run_idx}"
        n = spec.num_nodes
        manifest = self.registry.get_manifest(spec.image) \
            if include_image else None
        # captured BEFORE the run: has_record() flips during the record
        # phase, so re-querying afterwards would misreport the first run
        use_prefetch = bool(include_image and self.optimize
                            and self.hot_service.has_record(manifest.digest))
        loggers = [StageLogger(job_tag, f"node{i:03d}") for i in range(n)]
        trace_holder: dict = {}
        pipelined = self.optimize and self.pipeline
        node_tasks = [
            self._node_tasks(spec, rank, job_tag=job_tag, manifest=manifest,
                             checkpointer=checkpointer,
                             trace_holder=trace_holder,
                             use_prefetch=use_prefetch,
                             include_image=include_image)
            for rank in range(n)]

        fab0 = self._fabric_counters()
        t_zero = time.perf_counter()

        def clock() -> float:
            # zero-based run clock: task records, stage spans and the
            # TRAINING event all share the run-start epoch, so recorded
            # timestamps read directly as "seconds into this startup"
            return time.perf_counter() - t_zero

        results = run_node_dags(node_tasks, pipelined=pipelined,
                                loggers=loggers, clock=clock)
        # the ONE remaining cross-node sync: every node's gating chains
        # are done, so TRAINING begins everywhere at the same instant
        total = clock()
        for log in loggers:
            log.begin(Stage.TRAINING, ts=total)

        # startup done: the working-set pins drop (the restored blocks are
        # ordinary eviction candidates again) and deferred DAG tasks (cold
        # image remainder, optimizer-state restore waves) stream while
        # training runs
        tune_future = None
        for res in results:
            prefetch_val = res.values.get(StartupTask.IMAGE_HOT_PREFETCH)
            if isinstance(prefetch_val, dict) and "client" in prefetch_val:
                prefetch_val["client"].release_pins()
            for _name, thunk in res.deferred:
                fut = self._submit_deferred(thunk)
                if _name == StartupTask.TUNE_RESTORE:
                    tune_future = fut

        # record phase upload (first optimized run)
        if "trace" in trace_holder:
            self.hot_service.record(manifest.digest, trace_holder["trace"],
                                    window_s=120.0)

        for log in loggers:
            self.analysis.ingest_log(log.lines())
        crit = {f"node{i:03d}": attribution(res)
                for i, res in enumerate(results)}
        fab1 = self._fabric_counters()
        notes = {"optimized": self.optimize, "pipelined": pipelined,
                 "prefetch_used": use_prefetch,
                 "critical_path": crit,
                 "gating_counts": gating_counts(crit),
                 # storage-fabric health of THIS run: parity
                 # reconstructions that saved the restore, and cache
                 # evictions under the byte bound
                 "degraded_reads": fab1["degraded_reads"]
                 - fab0["degraded_reads"],
                 "reconstructed_bytes": fab1["reconstructed_bytes"]
                 - fab0["reconstructed_bytes"],
                 "corrupt_chunks": fab1["corrupt_chunks"]
                 - fab0["corrupt_chunks"],
                 "evictions": fab1["evictions"] - fab0["evictions"],
                 # continuous recovery: params-wave bytes served from
                 # restore-ahead cache entries instead of DFS preads
                 "restore_ahead_hit_bytes":
                     fab1.get("restore_ahead_hit_bytes", 0)
                     - fab0.get("restore_ahead_hit_bytes", 0),
                 "restore_ahead_prefetch_bytes":
                     fab1.get("restore_ahead_prefetch_bytes", 0)
                     - fab0.get("restore_ahead_prefetch_bytes", 0)}
        if self.io_sched is not None:
            notes["io_sched"] = self.io_sched.snapshot()
        if not include_image:
            notes["hot_update"] = True
        if self.tune:
            # join the profile restore AFTER the TRAINING timestamp was
            # cut (total = clock() above): the wait shows up nowhere on
            # the startup critical path, but the notes report the truth
            # about whether this boot re-tuned or hit the cache
            notes["tune_cache_hit"] = False
            notes["tune_invocations"] = 0
            if tune_future is not None:
                try:
                    tinfo = tune_future.result(
                        timeout=self.tune_join_timeout_s)
                except Exception as exc:  # noqa: BLE001
                    notes["tune_error"] = repr(exc)
                else:
                    notes["tune_cache_hit"] = bool(tinfo.get("hit"))
                    notes["tune_invocations"] = tinfo.get("invocations", 0)
                    if "digest" in tinfo:
                        notes["tune_profile_digest"] = tinfo["digest"]
                    if "error" in tinfo:
                        notes["tune_error"] = tinfo["error"]
        # launch-profile drift: each node's env restore carries the
        # profile the snapshot was CREATED under; compare against the
        # env this boot actually runs with
        drift: dict = {}
        for i, res in enumerate(results):
            meta = res.values.get(StartupTask.ENV_RESTORE)
            lp = meta.get("launch_profile") if isinstance(meta, dict) \
                else None
            if lp is not None:
                lines = profile_drift(lp)
                if lines:
                    drift[f"node{i:03d}"] = lines
        notes["launch_profile_drift"] = drift
        return StartupResult(
            job_id=spec.job_id, run_idx=run_idx,
            node_stage_s=self.analysis.node_stage_durations(job_tag),
            total_s=total, notes=notes)

    # ------------------------------------------------------------------
    def run_startup(self, spec: JobSpec,
                    checkpointer=None) -> StartupResult:
        """Execute one Full Startup of ``spec`` across its worker nodes.

        Raises any failure left behind by a previous run's deferred
        background work (see :meth:`drain_deferred`) before starting."""
        return self._run(spec, checkpointer, include_image=True, tag="r")

    # ------------------------------------------------------------------
    def run_hot_update(self, spec: JobSpec,
                       checkpointer=None) -> StartupResult:
        """Hot Update (§2.2): a PARTIAL startup — container and image stay,
        but the environment is set up again and the model re-initialized.
        The same DAG executor runs the sub-graph without the image tasks
        (``env.install`` keeps only its ``env.restore`` edge)."""
        return self._run(spec, checkpointer, include_image=False, tag="h")

    # ------------------------------------------------------------------
    def restore_ahead(self, spec: JobSpec, checkpointer,
                      step: int) -> None:
        """Arm restore-ahead for ``step`` (continuous recovery).

        Call after a checkpoint lands: each of the job's nodes stages its
        wave-0 (params) plan ranges into its fabric ``NodeCache`` as
        range-addressed entries, pinned under the job so cache pressure
        cannot evict them before the restart that needs them.  The
        prefetch runs on the deferred pool at DEFERRED priority — it can
        never convoy a live startup's critical reads.  A later
        crash-restart of the same step recomputes the identical plan, so
        its params wave is served from node-local disk with zero DFS
        preads (reported as ``restore_ahead_hit_bytes`` in
        ``StartupResult.notes``).  Re-arming for a newer step releases
        the previous step's pins first, bounding the pinned set to one
        checkpoint's wave 0 per node.
        """
        if not self.optimize:
            return
        from repro_torch.fabric.cache import prefetch_ranges
        n = spec.num_nodes
        stream = _ckpt_stream(checkpointer, step)
        tag = f"restore-ahead/{spec.job_id}"

        def arm(rank: int):
            def thunk():
                cache = self._node_cache(spec.job_id, rank)
                cache.unpin_job(tag)
                reader, plans = _restore_plans(
                    checkpointer, step, rank=rank, nodes=n,
                    resume_plan=spec.resume_plan, sched=self.io_sched)
                if not plans:
                    return 0
                stored = prefetch_ranges(
                    reader, cache, stream,
                    [(op.offset, op.length) for op in plans[0].reads],
                    job=tag, priority=DEFERRED)
                if stored:
                    self.hdfs.account_fabric(
                        restore_ahead_prefetch_bytes=stored)
                return stored
            return thunk

        for rank in range(n):
            self._submit_deferred(arm(rank))


def _ckpt_stream(checkpointer, step: int) -> str:
    """Cache stream id for a checkpoint step's LOGICAL data stream.

    Range-addressed cache entries (repro_torch.fabric.cache) key on this id +
    logical offsets, so a delta step — whose bytes come from several
    physical files through one ``LayeredReader`` — caches under the same
    keys its planned restore will look up.  Checkpoint steps are immutable
    once written, so the id names immutable bytes."""
    return f"ckpt:{checkpointer.base}/step_{step:08d}"


def _restore_plans(checkpointer, step: int, *, rank: int, nodes: int,
                   resume_plan: Any = "full", sched=None, cache=None,
                   on_hit=None):
    """Resolve ``resume_plan`` into (reader, per-wave RestorePlans).

    With ``cache`` (a fabric ``NodeCache``), the reader consults
    range-addressed entries staged by restore-ahead prefetch before
    issuing DFS preads; ``on_hit(nbytes)`` reports the served bytes."""
    from repro_torch.ckpt.plan import plan_for_rank
    from repro_torch.fabric.cache import CachedRangeReader

    index = checkpointer.load_index(step, sched=sched)
    reader = checkpointer._reader(step, sched=sched, index=index)
    if cache is not None:
        reader = CachedRangeReader(reader, cache,
                                   _ckpt_stream(checkpointer, step),
                                   on_hit=on_hit)
    if callable(resume_plan):
        plans = list(resume_plan(index, rank, nodes))
    else:
        if resume_plan not in ("full", "rows"):
            raise ValueError(
                f"unknown resume_plan {resume_plan!r}; expected 'full', "
                "'rows', or a callable (index, rank, nodes) -> plans")
        eff_nodes = nodes if resume_plan == "rows" else 1
        plans = [plan_for_rank(index, rank, eff_nodes, names=names)
                 for names in index.wave_names()]
    return reader, plans


def planned_restore_bytes(checkpointer, step: int, *, rank: int, nodes: int,
                          resume_plan: Any = "full",
                          defer: Optional[Callable] = None,
                          sched=None) -> int:
    """Read this node's planned share of the checkpoint (I/O only).

    The restore planner (repro_torch.ckpt.plan) turns ``resume_plan`` into
    batched ``pread_many`` reads split into two waves: wave 0 (params,
    tree 0) gates MODEL_INIT and is read synchronously; wave 1 (optimizer
    state) is handed to ``defer`` — a callable accepting a thunk — so the
    runtime can stream it off the startup critical path, overlapping model
    init/training.  Without ``defer`` both waves are read synchronously.
    Returns the bytes read on the critical path (wave 0, plus wave 1 when
    not deferred).
    """
    from repro_torch.ckpt.plan import read_plan

    reader, plans = _restore_plans(checkpointer, step, rank=rank,
                                   nodes=nodes, resume_plan=resume_plan,
                                   sched=sched)
    if not plans:
        return 0
    n = read_plan(reader, plans[0], priority=CRITICAL)
    tail = plans[1:]
    if tail and defer is not None:
        defer(lambda: sum(read_plan(reader, p, priority=DEFERRED)
                          for p in tail))
    else:
        n += sum(read_plan(reader, p) for p in tail)
    return n
