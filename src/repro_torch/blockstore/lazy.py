"""Lazy (on-demand) image client with access-trace recording.

Models the container runtime's page-fault-style data path: file reads hit
the local block cache; misses fetch the block from a peer (if a Swarm /
PeerGroup is attached) or the registry.  Every first access is recorded —
(file, block index, monotonic order) — which is exactly the trace the
record-and-prefetch service (repro_torch.blockstore.prefetch) persists per image
digest.

The block cache is a storage-fabric :class:`~repro_torch.fabric.cache.NodeCache`
(content-addressed, optionally byte-bounded): pass one in to share it
across clients/runs and bound it; by default each client builds an
unbounded cache over ``cache_dir`` (the pre-fabric behaviour).  The fabric
interplay rules live here:

* **eviction withdraws availability** — when the cache evicts a block,
  the client's eviction listener removes it from the swarm availability
  index, so no peer is routed to bytes that left this disk;
* **startup accesses pin** — every non-DEFERRED ``ensure_block`` pins the
  block for this client's job, so a concurrent job's cold stream cannot
  evict the working set a startup is replaying (``release_pins`` drops
  them once the startup is over);
* **eviction races are misses** — a block can vanish between ``has_block``
  and the read; every read path treats that as an ordinary miss and
  refetches instead of erroring.

A node may run several clients at once (concurrent jobs, multiple images):
each client carries a swarm-unique ``client_id`` (node + image digest by
default) so per-peer accounting and membership never collide.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Optional

from repro_torch.blockstore.image import ImageManifest
from repro_torch.blockstore.registry import Registry
from repro_torch.fabric.cache import NodeCache


class LazyImageClient:
    def __init__(self, manifest: ImageManifest, registry: Registry,
                 cache_dir: str | Path, *, node_id: str = "node0",
                 peers: Optional["Swarm"] = None,
                 client_id: Optional[str] = None,
                 peer_replace: bool = False, sched=None,
                 cache: Optional[NodeCache] = None):
        self.manifest = manifest
        self.registry = registry
        self.cache = cache if cache is not None else NodeCache(cache_dir)
        self.cache_dir = self.cache.root
        self.node_id = node_id
        self.client_id = client_id or f"{node_id}:{manifest.digest[:8]}"
        self.peers = peers
        # optional repro_torch.core.pipeline.IOScheduler: block fetches then
        # hold one "registry"/"peer" token each, granted by priority —
        # a DEFERRED cold stream (this run's or a previous run's) can
        # never queue a CRITICAL hot prefetch behind it
        self.sched = sched
        self._files = manifest.file_map()
        self._lock = threading.Lock()
        self._trace: list[dict] = []
        self._t0 = time.perf_counter()
        self.stats = {"hits": 0, "misses": 0, "peer_fetches": 0,
                      "registry_fetches": 0, "registry_bytes": 0,
                      "bytes_fetched": 0}
        if peers is not None:
            # an evicted block must leave the availability index the
            # moment it leaves disk; keyed by client_id so a warm
            # restart's client simply replaces its predecessor's listener
            swarm, cid = peers, self.client_id
            self.cache.set_evict_listener(
                cid, lambda h: swarm.withdraw(h, cid))
            peers.join(self, replace=peer_replace)

    # ----- block cache -----

    def _cache_path(self, h: str) -> Path:
        return self.cache.path(h)

    def has_block(self, h: str) -> bool:
        return self.cache.has(h)

    def get_cached_block(self, h: str) -> bytes:
        return self.cache.read(h)

    def cached_hashes(self) -> list[str]:
        """Block hashes already on local disk (warm-cache announcement)."""
        return [k for k in self.cache.keys()
                if len(k) == 64
                and all(c in "0123456789abcdef" for c in k)]

    def release_pins(self):
        """Drop this client's working-set pins (startup finished): its
        blocks become ordinary eviction candidates again."""
        self.cache.unpin_job(self.client_id)

    def _fetch_block(self, h: str, priority: int = 0,
                     pin: bool = False) -> bytes:
        """Peer-first fetch with registry fallback.  With a scheduler
        attached, a registry fetch holds one "registry" token for the
        duration of that single block — the cooperative-preemption
        granularity.  Peer fetches hold NO token: ``Swarm.fetch`` can
        park a caller in a singleflight coalesced wait for tens of
        seconds, and a DEFERRED stream holding a pool token across that
        wait would convoy later CRITICAL fetches — the very thing the
        scheduler exists to prevent.  Peer-link concurrency is already
        bounded inside the swarm (per-holder ``serve_slots``); the
        scheduler's "peer" resource keeps the per-priority byte
        accounting role only."""
        job = self.client_id if pin else None
        if self.peers is not None:
            data = self.peers.fetch(h, requester=self)
            if data is not None:
                self.stats["peer_fetches"] += 1
                if self.sched is not None:
                    self.sched.account("peer", priority, len(data))
                try:
                    self._store(h, data, job=job)
                    # announce: this client is now a holder too, so the
                    # dissemination tree fans out instead of pinning the
                    # seed
                    self.peers.publish(h, self)
                except BaseException:
                    # we may still be the fetcher-of-record: a failed
                    # store/publish must not leave the singleflight
                    # marker armed or coalesced waiters stall out their
                    # full wait budget
                    self.peers.abandon(h, self)
                    raise
                return data
            try:
                # another thread of THIS client may have been the
                # fetcher-of-record while we were parked: the block is
                # already on local disk (publish announces it and clears
                # any marker we re-armed).  An eviction between the check
                # and the read falls through to the registry like any miss.
                data = self.cache.read(h)
                if self.peers is not None:
                    self.peers.publish(h, self)
                self.stats["hits"] += 1
                if job is not None:
                    self.cache.pin(job, h)
                return data
            except FileNotFoundError:
                pass
        try:
            if self.sched is not None:
                with self.sched.slot("registry", priority=priority):
                    data = self.registry.get_block(h)
                self.sched.account("registry", priority, len(data))
            else:
                data = self.registry.get_block(h)
        except BaseException:
            if self.peers is not None:
                # we may be the fetcher-of-record: wake coalesced waiters
                # so exactly one re-arms and retries the registry
                self.peers.abandon(h, self)
            raise
        self.stats["registry_fetches"] += 1
        # registry bytes separately from peer bytes: with a multi-region
        # topology these are the WAN-origin bytes a region's egress
        # budget is measured against (bench_swarm --regions)
        self.stats["registry_bytes"] += len(data)
        try:
            self._store(h, data, job=job)
            if self.peers is not None:
                self.peers.publish(h, self)
        except BaseException:
            # the registry fetch succeeded but the block never became
            # servable — clear the marker so a waiter re-arms and retries
            if self.peers is not None:
                self.peers.abandon(h, self)
            raise
        return data

    def _store(self, h: str, data: bytes, job: Optional[str] = None) -> bool:
        """Write ``data`` to the local cache; returns whether this call
        actually stored it.  Bytes are only counted when written — a lost
        race with a concurrent fetcher is not a fetch."""
        stored = self.cache.put(h, data, job=job)
        if stored:
            self.stats["bytes_fetched"] += len(data)
        return stored

    def ensure_block(self, h: str, *, record: bool = False,
                     file_path: str = "", block_idx: int = -1,
                     priority: int = 0) -> bytes:
        from repro_torch.core.pipeline import DEFERRED

        # startup-critical accesses pin the block for this job; DEFERRED
        # (cold-stream) traffic never pins — bounded caches may rotate it
        pin = priority != DEFERRED
        try:
            data = self.cache.read(h)
            self.stats["hits"] += 1
            if pin:
                self.cache.pin(self.client_id, h)
        except FileNotFoundError:
            self.stats["misses"] += 1
            data = self._fetch_block(h, priority, pin=pin)
        if record:
            with self._lock:
                self._trace.append({
                    "hash": h, "file": file_path, "block": block_idx,
                    "t": time.perf_counter() - self._t0})
        return data

    # ----- file-level reads (what the starting container does) -----

    def read_file(self, path: str, offset: int = 0, length: int = -1) -> bytes:
        fe = self._files[path]
        if length < 0:
            length = fe.size - offset
        length = min(length, fe.size - offset)
        if length <= 0:
            return b""
        bs = self.manifest.block_size
        out = bytearray()
        first, last = offset // bs, (offset + length - 1) // bs
        for bi in range(first, last + 1):
            data = self.ensure_block(fe.blocks[bi], record=True,
                                     file_path=path, block_idx=bi)
            lo = max(offset - bi * bs, 0)
            hi = min(offset + length - bi * bs, len(data))
            out += data[lo:hi]
        return bytes(out)

    def exists(self, path: str) -> bool:
        return path in self._files

    def listdir(self) -> list[str]:
        return sorted(self._files)

    # ----- trace -----

    def access_trace(self) -> list[dict]:
        """Block-level access records in first-touch order (deduped)."""
        seen, out = set(), []
        for rec in self._trace:
            if rec["hash"] not in seen:
                seen.add(rec["hash"])
                out.append(rec)
        return out

    def cached_fraction(self) -> float:
        blocks = self.manifest.unique_blocks
        have = sum(1 for h in blocks if self.has_block(h))
        return have / max(len(blocks), 1)
