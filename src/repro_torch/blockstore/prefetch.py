"""Hot-block record-and-prefetch (the core of BootSeer §4.2, Fig. 9).

Record phase: the first startup with an image runs lazily; the client's
access trace (absolute file paths + block offsets, first-touch order within
the record window) is uploaded to the HotBlockService keyed by image digest.

Prefetch phase: subsequent startups fetch exactly the recorded hot blocks
*before* container start (parallel, peer-assisted), then stream the cold
remainder in the background (the paper uses 8 threads) so training never
faults to a remote source.

Traces EVOLVE across runs: each new record decays the stored per-block
scores by ``decay`` and adds 1.0 for every block the new trace touched, so
the hot set tracks changing entrypoints — a block the startup stops
touching fades below ``min_score`` after a few runs and is evicted, while a
newly-hot block enters immediately.  ``hot_blocks`` stays in first-touch
order (the startup's critical order); the swarm streams the *cold*
remainder rarest-first for dissemination diversity.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

from repro_torch.blockstore.lazy import LazyImageClient

# process-wide fallback executors for callers that don't pass their own
# ``pool``: spawning a fresh ThreadPoolExecutor per prefetch put thread
# creation on the startup critical path.  Hot and cold phases get
# SEPARATE pools so a previous run's cold remainder can never queue
# ahead of a later run's hot prefetch in the executor itself (the same
# isolation BootseerRuntime keeps with its _io_pool/_cold_pool pair).
# Sized on first use; the per-block IOScheduler tokens (not the pool
# width) bound actual storage concurrency.
_POOL_LOCK = threading.Lock()
_HOT_POOL: Optional[ThreadPoolExecutor] = None
_COLD_POOL: Optional[ThreadPoolExecutor] = None


def _fallback_pool(phase: str, threads: int) -> ThreadPoolExecutor:
    global _HOT_POOL, _COLD_POOL
    with _POOL_LOCK:
        if phase == "hot":
            if _HOT_POOL is None:
                _HOT_POOL = ThreadPoolExecutor(
                    threads, thread_name_prefix="blk-prefetch-hot")
            return _HOT_POOL
        if _COLD_POOL is None:
            _COLD_POOL = ThreadPoolExecutor(
                threads, thread_name_prefix="blk-prefetch-cold")
        return _COLD_POOL


class HotBlockService:
    """Central record store: image digest -> evolving hot block scores.

    ``decay``: multiplier applied to every stored score when a new trace
    merges in (0 < decay < 1; at 0.5 a once-hot block untouched for 3
    runs decays 1.0 -> 0.125, below the default ``min_score``, and is
    evicted).
    ``min_score``: eviction threshold after each merge.
    """

    def __init__(self, root: str | Path, *, decay: float = 0.5,
                 min_score: float = 0.2):
        if not 0.0 < decay < 1.0:
            raise ValueError(f"decay must be in (0, 1), got {decay}")
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.decay = decay
        self.min_score = min_score

    def _path(self, digest: str) -> Path:
        return self.root / f"{digest}.trace.json"

    def has_record(self, digest: str) -> bool:
        return self._path(digest).exists()

    def _load(self, digest: str) -> dict:
        """Stored state as {"runs": int, "blocks": {hash: entry}} where an
        entry is {"score", "t", "file", "block"}.  Reads both the current
        format and the seed's flat trace-list format."""
        if not self.has_record(digest):
            return {"runs": 0, "blocks": {}}
        raw = json.loads(self._path(digest).read_text())
        if isinstance(raw, list):  # seed format: one flat trace
            return {"runs": 1, "blocks": {
                r["hash"]: {"score": 1.0, "t": r.get("t", 0.0),
                            "file": r.get("file", ""),
                            "block": r.get("block", -1)} for r in raw}}
        return raw

    def record(self, digest: str, trace: list[dict],
               window_s: Optional[float] = None):
        """Merge one run's hot-block trace into the stored record
        (optionally cut to a record window — the paper uses 2 minutes)."""
        if window_s is not None:
            trace = [r for r in trace if r["t"] <= window_s]
        state = self._load(digest)
        blocks = state["blocks"]
        for e in blocks.values():
            e["score"] *= self.decay
        for r in trace:
            e = blocks.get(r["hash"])
            if e is None:
                blocks[r["hash"]] = {"score": 1.0, "t": r["t"],
                                     "file": r.get("file", ""),
                                     "block": r.get("block", -1)}
            else:
                e["score"] += 1.0
                e["t"] = r["t"]       # refresh first-touch order
        state["blocks"] = {h: e for h, e in blocks.items()
                           if e["score"] >= self.min_score}
        state["runs"] = state.get("runs", 0) + 1
        tmp = self._path(digest).with_suffix(".tmp")
        tmp.write_text(json.dumps(state))
        tmp.replace(self._path(digest))

    def hot_blocks(self, digest: str) -> list[str]:
        """Current hot set in first-touch order of the latest traces."""
        blocks = self._load(digest)["blocks"]
        return sorted(blocks, key=lambda h: blocks[h]["t"])

    def scores(self, digest: str) -> dict[str, float]:
        return {h: e["score"]
                for h, e in self._load(digest)["blocks"].items()}

    def score_index(self) -> dict[str, float]:
        """Merged {block hash: hot score} across EVERY recorded image —
        the heat map a hot-score-aware eviction policy
        (repro_torch.fabric.cache.HotScorePolicy) ranks node-cache victims by.
        Blocks hot for any image keep the max of their per-image scores;
        blocks no record mentions default to 0.0 (evicted first)."""
        out: dict[str, float] = {}
        for p in self.root.glob("*.trace.json"):
            digest = p.name[:-len(".trace.json")]
            for h, e in self._load(digest)["blocks"].items():
                out[h] = max(out.get(h, 0.0), e["score"])
        return out


def prefetch_image(client: LazyImageClient, service: HotBlockService, *,
                   hot_threads: int = 8, cold_threads: int = 8,
                   background_cold: bool = True,
                   pool: Optional[ThreadPoolExecutor] = None,
                   defer_cold: bool = False):
    """Prefetch hot blocks (blocking), then stream cold blocks.

    Returns ``(hot_seconds, cold_handle)``.  After the blocking phase the
    container can start: every startup-critical block is local.

    ``pool``: optional long-lived executor shared across nodes/runs.
    Without one, process-wide fallback pools are used (one hot, one
    cold) — no caller ever pays thread-spawn cost on the critical path;
    ``hot_threads``/``cold_threads`` size the fallback pools on first
    use.

    ``defer_cold=True`` keeps the cold remainder ENTIRELY off the startup
    critical path: nothing is scanned, spawned or fetched here; instead
    ``cold_handle`` is a callable the caller runs once startup is over (the
    runtime submits it to its I/O pool while training runs, as in §4.2).
    Otherwise ``cold_handle`` is the background thread (or None).

    Hot blocks stream in recorded first-touch order (startup-critical);
    cold blocks stream rarest-first when the client is swarm-attached.
    With a scheduler attached to the client, hot fetches run at CRITICAL
    priority and the cold remainder at DEFERRED — one token per block, so
    cold streams yield to any later run's hot prefetch block-by-block.
    """
    from repro_torch.core.pipeline import DEFERRED

    digest = client.manifest.digest
    hot = [h for h in service.hot_blocks(digest) if not client.has_block(h)]
    t0 = time.perf_counter()
    if pool is not None:
        list(pool.map(client.ensure_block, hot))
    elif len(hot) == 1:
        client.ensure_block(hot[0])
    elif hot:
        ex = _fallback_pool("hot", hot_threads)
        list(ex.map(client.ensure_block, hot))
    hot_s = time.perf_counter() - t0
    hot_set = set(hot)

    def ensure_cold(h):
        return client.ensure_block(h, priority=DEFERRED)

    def cold_order(hashes):
        rarest = getattr(client.peers, "rarest_first", None)
        return rarest(hashes) if rarest is not None else list(hashes)

    if defer_cold:
        # a marker in the block cache records that a full stream already
        # completed for this digest, so warm restarts skip the whole
        # per-block scan (blocks are content-addressed and never evicted)
        marker = client.cache_dir / f".cold_complete_{digest[:16]}"
        if marker.exists():
            return hot_s, None

        def stream_later():
            todo = [h for h in client.manifest.unique_blocks
                    if h not in hot_set and not client.has_block(h)]
            for h in cold_order(todo):
                ensure_cold(h)
            marker.touch()
        return hot_s, stream_later

    cold = [h for h in client.manifest.unique_blocks
            if h not in hot_set and not client.has_block(h)]
    bg = None
    if cold:
        def stream():
            # rarest-first ordering scans the availability index once per
            # block — do it on the streaming side, never on the critical
            # path between the hot phase and returning to the caller
            ex = pool if pool is not None \
                else _fallback_pool("cold", cold_threads)
            list(ex.map(ensure_cold, cold_order(cold)))
        if background_cold:
            bg = threading.Thread(target=stream, daemon=True)
            bg.start()
        else:
            stream()
    return hot_s, bg
