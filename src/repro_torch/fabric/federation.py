"""Region federation: a background replicator that turns WAN fetches
into LAN fetches.

A multi-region swarm (``repro_torch.blockstore.swarm`` with a region tier in
its :class:`Topology`) already prefers same-rack > same-region >
cross-region holders — but a region only BECOMES self-sufficient after
someone in it has pulled each block across the WAN once.  The
:class:`RegionReplicator` makes that first pull proactive instead of
demand-driven: between startups it walks the merged hot-block heat map
(``HotBlockService.score_index()``, hottest first) and pulls any block a
region holds fewer than ``min_region_replicas`` copies of into one of
that region's registered clients, so the NEXT restart storm in that
region finds every hot block region-local.

Discipline rules (the same ones the rest of the startup stack obeys):

* **DEFERRED priority** — every replication pull runs at
  ``repro_torch.core.pipeline.DEFERRED``; with a scheduler attached to the
  client, registry fallbacks hold one metered "registry" token per block
  and peer bytes land in the "peer" accounting pool, so replication can
  never queue a CRITICAL startup fetch behind it.  DEFERRED pulls also
  never pin: a bounded :class:`~repro_torch.fabric.cache.NodeCache` may rotate
  replicated blocks out under pressure.
* **Eviction-withdraw honesty** — replicated blocks land in the pulling
  client's ``NodeCache`` through the ordinary ``ensure_block`` path, so
  the client's eviction listener withdraws them from the availability
  index the moment they leave disk; ``region_holder_count`` then drops
  and the next round simply replicates again.  Cross-region holders are
  never trusted beyond what the index can prove.
* **Bounded rounds** — each round moves at most ``max_bytes_per_round``
  bytes and ``max_blocks_per_round`` blocks per region; convergence is
  incremental, never a WAN burst.
* **No blocking under the lock** — membership is snapshotted under
  ``_lock`` and released before any pull; the I/O never runs inside it.
"""

from __future__ import annotations

import threading
from typing import Optional


class RegionReplicator:
    """Pull hot blocks into under-replicated regions, hottest first.

    Parameters
    ----------
    swarm: the region-aware :class:`~repro_torch.blockstore.swarm.Swarm`.
    hot_service: the :class:`~repro_torch.blockstore.prefetch.HotBlockService`
        whose merged ``score_index()`` ranks what is worth replicating.
    min_region_replicas: target region-local copies per hot block.
    max_bytes_per_round / max_blocks_per_round: per-region WAN budget of
        one :meth:`replicate_once` round.
    interval_s: background-thread cadence (:meth:`start`).
    """

    def __init__(self, swarm, hot_service, *,
                 min_region_replicas: int = 1,
                 max_bytes_per_round: int = 64 << 20,
                 max_blocks_per_round: int = 256,
                 interval_s: float = 5.0):
        if min_region_replicas < 1:
            raise ValueError(
                f"min_region_replicas must be >= 1, "
                f"got {min_region_replicas}")
        self.swarm = swarm
        self.hot_service = hot_service
        self.min_region_replicas = min_region_replicas
        self.max_bytes_per_round = max_bytes_per_round
        self.max_blocks_per_round = max_blocks_per_round
        self.interval_s = interval_s
        self._lock = threading.Lock()
        self._pullers: dict[str, list] = {}      # region -> clients
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"rounds": 0, "replicated_blocks": 0,
                      "replicated_bytes": 0, "skipped_blocks": 0,
                      "errors": 0}

    # ----- membership -------------------------------------------------

    def register(self, client, region: Optional[str] = None):
        """Add ``client`` as a replication target for its region (derived
        from the swarm topology unless given).  The client must be
        swarm-attached — its pulls must publish/withdraw like any other
        member's."""
        region = region or self.swarm.topology.region_of(client.node_id)
        with self._lock:
            self._pullers.setdefault(region, []).append(client)
        return region

    def unregister(self, client):
        with self._lock:
            for clients in self._pullers.values():
                if client in clients:
                    clients.remove(client)

    def regions(self) -> list[str]:
        with self._lock:
            return sorted(r for r, cs in self._pullers.items() if cs)

    # ----- policy -----------------------------------------------------

    def under_replicated(self, region: str,
                         scores: Optional[dict] = None) -> list[str]:
        """Hot blocks with fewer than ``min_region_replicas`` live
        holders inside ``region``, hottest first.  Blocks NO swarm member
        holds are excluded — replication moves existing replicas closer,
        it never originates registry traffic for blocks the fleet has
        already dropped everywhere."""
        if scores is None:
            scores = self.hot_service.score_index()
        out = []
        for h in sorted(scores, key=scores.get, reverse=True):
            held = self.swarm.holder_count(h)
            if held == 0:
                continue
            if self.swarm.region_holder_count(
                    h, region) >= self.min_region_replicas:
                continue
            out.append(h)
        return out

    # ----- one replication round --------------------------------------

    def replicate_once(self) -> int:
        """Run one bounded round over every registered region; returns
        the number of blocks replicated.  Pull targets rotate round-robin
        over the region's clients so the replica set spreads instead of
        concentrating on one node."""
        from repro_torch.core.pipeline import DEFERRED

        with self._lock:
            pullers = {r: list(cs) for r, cs in self._pullers.items()
                       if cs}
        scores = self.hot_service.score_index()
        moved_blocks = moved_bytes = skipped = errors = 0
        for region, clients in pullers.items():
            budget = self.max_bytes_per_round
            pulled = 0
            for i, h in enumerate(self.under_replicated(region, scores)):
                if budget <= 0 or pulled >= self.max_blocks_per_round:
                    break
                client = clients[i % len(clients)]
                if client.has_block(h):
                    # on disk but index-short (e.g. a concurrent
                    # withdraw landed between count and check): let the
                    # next round re-evaluate rather than double-pull
                    skipped += 1
                    continue
                try:
                    data = client.ensure_block(h, priority=DEFERRED)
                except OSError:
                    # holder vanished AND the registry refused: count it
                    # and move on — a round must survive any one block
                    errors += 1
                    continue
                pulled += 1
                moved_blocks += 1
                moved_bytes += len(data)
                budget -= len(data)
        with self._lock:
            self.stats["rounds"] += 1
            self.stats["replicated_blocks"] += moved_blocks
            self.stats["replicated_bytes"] += moved_bytes
            self.stats["skipped_blocks"] += skipped
            self.stats["errors"] += errors
        return moved_blocks

    # ----- background thread ------------------------------------------

    def start(self):
        """Start the background replication loop (idempotent)."""
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="region-replicator", daemon=True)
            thread = self._thread
        thread.start()

    def stop(self, timeout: float = 10.0):
        """Signal the loop to exit and join it (idempotent)."""
        with self._lock:
            thread, self._thread = self._thread, None
        self._stop.set()
        if thread is not None:
            thread.join(timeout)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.replicate_once()
            except Exception:
                # the loop must outlive any one bad round (a vanished
                # client, a torn record file); failures are visible in
                # stats, never fatal to the daemon
                with self._lock:
                    self.stats["errors"] += 1
