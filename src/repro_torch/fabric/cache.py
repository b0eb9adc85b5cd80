"""NodeCache — the fabric's content-addressed, byte-bounded node cache.

Before the fabric existed, three layers each grew their own node-local
cache with no bound and their own singleflight: the blockstore block
cache (a bare directory of content-addressed files), the env-cache
archive cache (directory + per-key locks), and ad-hoc memoization in the
DFS readers.  ``NodeCache`` replaces all of them:

* **content-addressed** — a key names immutable bytes (block digest,
  archive digest).  Keys never change meaning, so admission races are
  benign: whoever publishes first wins and the loser's bytes are
  identical.
* **byte-bounded** — ``capacity_bytes`` caps the on-disk footprint;
  admission evicts victims chosen by a pluggable :class:`EvictionPolicy`
  (LRU by default, hot-block-score-aware via :class:`HotScorePolicy`).
* **singleflight admission** — ``fetch_path``/``get_or_fetch`` coalesce
  concurrent misses on one key into a single producer call per node.
* **per-job pinning** — a running restore pins its working set; pinned
  entries are never eviction victims, so cache pressure from a
  concurrent job cannot evict bytes a startup is actively replaying.
* **eviction listeners** — consumers that *advertise* cached content
  (the swarm availability index) register a listener and withdraw the
  block the moment it leaves disk, so no peer is ever routed to a block
  that is gone.

Files are published atomically (tmp + ``os.link``/``replace``), exactly
like the old blockstore cache, so a crash mid-write never leaves a
half-admitted entry — and the index is rebuilt from the directory on
construction, so warm restarts inherit the previous run's cache.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Set, Tuple


class EvictionPolicy:
    """Victim-selection strategy.  The cache serializes all calls under
    its index lock, so implementations need no locking of their own."""

    def on_admit(self, key: str) -> None:
        raise NotImplementedError

    def on_access(self, key: str) -> None:
        raise NotImplementedError

    def on_remove(self, key: str) -> None:
        raise NotImplementedError

    def victims(self) -> Iterator[str]:
        """Keys in eviction order (best victim first)."""
        raise NotImplementedError


class LRUPolicy(EvictionPolicy):
    """Least-recently-used: the default, matching what an unbounded cache
    degenerates to when capacity is infinite."""

    def __init__(self):
        self._order: "OrderedDict[str, None]" = OrderedDict()

    def on_admit(self, key: str) -> None:
        self._order[key] = None
        self._order.move_to_end(key)

    def on_access(self, key: str) -> None:
        if key in self._order:
            self._order.move_to_end(key)

    def on_remove(self, key: str) -> None:
        self._order.pop(key, None)

    def victims(self) -> Iterator[str]:
        return iter(list(self._order))


class HotScorePolicy(LRUPolicy):
    """Hot-block-score-aware eviction: coldest score first, LRU within a
    score class.

    ``score_fn(key) -> float`` supplies the heat (wire it to
    ``HotBlockService.score_index`` so the image blocks a startup
    actually replays outlive cold-streamed filler); keys the service has
    never seen score 0.0 and go first.
    """

    def __init__(self, score_fn: Callable[[str], float]):
        super().__init__()
        self.score_fn = score_fn

    def victims(self) -> Iterator[str]:
        lru_rank = {k: i for i, k in enumerate(self._order)}
        return iter(sorted(
            lru_rank, key=lambda k: (self.score_fn(k), lru_rank[k])))


def _is_cache_entry(name: str) -> bool:
    return not name.startswith(".") and ".tmp" not in name


# ---------------------------------------------------------------------------
# range-addressed entries (restore-ahead prefetch)
# ---------------------------------------------------------------------------

def range_key(stream: str, offset: int, length: int) -> str:
    """Cache key naming one immutable byte range of an immutable stream.

    Checkpoint data files never change once written, so ``(stream id,
    offset, length)`` names immutable bytes exactly like a content
    digest does — admission races stay benign.  The stream id is folded
    through sha1 so arbitrary DFS paths become filename-safe keys.
    """
    import hashlib
    sid = hashlib.sha1(stream.encode()).hexdigest()[:16]
    return f"range.{sid}.{offset:x}.{length:x}"


class CachedRangeReader:
    """A ``pread_many`` reader that consults a :class:`NodeCache` of
    range-addressed entries before touching the wrapped reader.

    Restore-ahead prefetch (repro_torch.core.bootseer) stores a checkpoint's
    wave-0 plan ranges under :func:`range_key`; a crash-restart's planned
    restore recomputes the SAME plan, so its reads key-match exactly and
    are served from node-local disk with zero DFS preads.  Ranges not in
    the cache fall through to the inner reader in one batched call.
    ``on_hit(nbytes)`` reports served bytes (the runtime wires it to the
    cluster-wide fabric accounting so ``StartupResult.notes`` can show
    per-run ``restore_ahead_hit_bytes``).
    """

    def __init__(self, inner, cache: "NodeCache", stream: str, *,
                 job: Optional[str] = None,
                 on_hit: Optional[Callable[[int], None]] = None):
        self.inner = inner
        self.cache = cache
        self.stream = stream
        self.job = job
        self.on_hit = on_hit
        self.cache_stats = {"hit_bytes": 0, "miss_bytes": 0,
                            "hits": 0, "misses": 0}

    @property
    def stats(self) -> dict:
        """The inner reader's fabric counters (reconstruction deltas flow
        through unchanged — cache hits never reconstruct anything)."""
        return getattr(self.inner, "stats", {})

    def pread(self, offset: int, length: int) -> bytes:
        return self.pread_many([(offset, length)])[0]

    def pread_many(self, ranges, into=None, priority=None):
        out: list = [None] * len(ranges)
        miss_idx: list[int] = []
        hit_bytes = 0
        for i, (off, ln) in enumerate(ranges):
            data = None
            try:
                data = self.cache.read(range_key(self.stream, off, ln))
            except FileNotFoundError:
                pass   # absent or evicted mid-flight: an ordinary miss
            if data is None or len(data) != ln:
                miss_idx.append(i)
                continue
            if self.job is not None:
                self.cache.pin(self.job, range_key(self.stream, off, ln))
            if into is None:
                out[i] = data
            else:
                memoryview(into[i])[:ln] = data
                out[i] = ln
            hit_bytes += ln
            self.cache_stats["hits"] += 1
        self.cache_stats["hit_bytes"] += hit_bytes
        if hit_bytes and self.on_hit is not None:
            self.on_hit(hit_bytes)
        if miss_idx:
            self.cache_stats["misses"] += len(miss_idx)
            self.cache_stats["miss_bytes"] += sum(
                ranges[i][1] for i in miss_idx)
            sub = self.inner.pread_many(
                [ranges[i] for i in miss_idx],
                into=None if into is None else [into[i] for i in miss_idx],
                priority=priority)
            for i, val in zip(miss_idx, sub):
                out[i] = val
        return out


def prefetch_ranges(reader, cache: "NodeCache", stream: str,
                    ranges, *, job: Optional[str] = None,
                    priority: Optional[int] = None,
                    batch_bytes: int = 128 * (1 << 20)) -> int:
    """Pull ``(offset, length)`` ranges of ``stream`` through ``reader``
    into ``cache`` as range-addressed entries (the restore-ahead
    producer).  Already-cached ranges are skipped, so re-arming after
    every checkpoint is cheap when little changed.  Reads are batched to
    bound transient memory; ``priority`` rides through to the reader (the
    runtime prefetches at DEFERRED so restore-ahead can never convoy a
    live startup).  Returns the number of bytes newly admitted."""
    todo = [(off, ln) for off, ln in ranges
            if ln > 0 and not cache.has(range_key(stream, off, ln))]
    stored = 0
    i = 0
    while i < len(todo):
        j, acc = i, 0
        while j < len(todo) and (j == i or acc + todo[j][1] <= batch_bytes):
            acc += todo[j][1]
            j += 1
        payloads = reader.pread_many(todo[i:j], priority=priority)
        for (off, ln), data in zip(todo[i:j], payloads):
            if len(data) != ln:
                raise IOError(
                    f"restore-ahead short read: {len(data)} of {ln} bytes "
                    f"at offset {off}")
            if cache.put(range_key(stream, off, ln), data, job=job):
                stored += ln
        i = j
    return stored


class NodeCache:
    """See module docstring.  ``capacity_bytes=None`` means unbounded
    (the pre-fabric behaviour every consumer starts from)."""

    def __init__(self, root: str | Path, *,
                 capacity_bytes: Optional[int] = None,
                 policy: EvictionPolicy | str = "lru",
                 score_fn: Optional[Callable[[str], float]] = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.capacity_bytes = capacity_bytes
        if isinstance(policy, str):
            if policy == "lru":
                policy = LRUPolicy()
            elif policy == "hot":
                policy = HotScorePolicy(score_fn or (lambda _k: 0.0))
            else:
                raise ValueError(
                    f"unknown eviction policy {policy!r}: expected 'lru', "
                    "'hot', or an EvictionPolicy instance")
        self.policy = policy
        self._lock = threading.Lock()
        self._sizes: Dict[str, int] = {}
        self._bytes = 0
        # job tag -> pinned keys; a key may be pinned by several jobs
        self._pins: Dict[str, Set[str]] = {}
        self._pin_counts: Dict[str, int] = {}
        # keys reserved in the index whose file is still being written:
        # never eviction victims until the write lands (a victim pick
        # would unlink nothing, then the late write would publish bytes
        # the index no longer tracks)
        self._inflight_writes: Set[str] = set()
        self._flights: Dict[str, threading.Lock] = {}
        self._listeners: Dict[str, Callable[[str], None]] = {}
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "evicted_bytes": 0, "over_capacity_admits": 0,
                      "singleflight_hits": 0}
        # warm restart: rebuild the index from whatever survived on disk
        for p in self.root.iterdir():
            if p.is_file() and _is_cache_entry(p.name):
                self._index(p.name, p.stat().st_size)

    # ----- index internals (call under self._lock or during __init__) ---

    def _index(self, key: str, nbytes: int):
        if key not in self._sizes:
            self._bytes += nbytes
            self._sizes[key] = nbytes
            self.policy.on_admit(key)

    def _deindex(self, key: str) -> int:
        nbytes = self._sizes.pop(key, 0)
        self._bytes -= nbytes
        self.policy.on_remove(key)
        return nbytes

    # ----- public surface ----------------------------------------------

    def path(self, key: str) -> Path:
        return self.root / key

    def has(self, key: str) -> bool:
        with self._lock:
            return key in self._sizes

    def keys(self) -> list:
        with self._lock:
            return list(self._sizes)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def read(self, key: str) -> bytes:
        """Entry payload.  Raises ``FileNotFoundError`` when the key is
        absent or was evicted — callers treat that exactly like a miss
        (the swarm's serve path already maps OSError to "drop holder")."""
        with self._lock:
            known = key in self._sizes
            if known:
                self.policy.on_access(key)
        if not known:
            raise FileNotFoundError(f"node cache entry {key!r} not present")
        data = self.path(key).read_bytes()
        with self._lock:
            self.stats["hits"] += 1
        return data

    # ----- pinning ------------------------------------------------------

    def pin(self, job: str, key: str):
        """Pin ``key`` for ``job``: not an eviction victim until every
        pinning job releases (``unpin_job``)."""
        with self._lock:
            held = self._pins.setdefault(job, set())
            if key not in held:
                held.add(key)
                self._pin_counts[key] = self._pin_counts.get(key, 0) + 1

    def unpin_job(self, job: str):
        """Release every pin ``job`` holds (end of its startup/restore)."""
        with self._lock:
            for key in self._pins.pop(job, ()):
                n = self._pin_counts.get(key, 0) - 1
                if n <= 0:
                    self._pin_counts.pop(key, None)
                else:
                    self._pin_counts[key] = n

    def pinned_keys(self) -> set:
        with self._lock:
            return set(self._pin_counts)

    # ----- eviction listeners ------------------------------------------

    def set_evict_listener(self, tag: str, fn: Optional[Callable]):
        """Register (or, with ``None``, remove) a listener called with
        each evicted/invalidated key — e.g. a swarm-availability
        withdrawal.  Keyed by ``tag`` so a warm-restarted client simply
        replaces its predecessor's listener."""
        with self._lock:
            if fn is None:
                self._listeners.pop(tag, None)
            else:
                self._listeners[tag] = fn

    def _notify_evicted(self, keys):
        for fn in list(self._listeners.values()):
            for key in keys:
                try:
                    fn(key)
                except Exception:  # noqa: BLE001 — advisory only
                    pass

    # ----- admission / eviction ----------------------------------------

    def _make_room(self, incoming: int) -> list:
        """Evict (under the lock) until ``incoming`` fits; returns the
        evicted keys.  Pinned keys are skipped; if pins alone exceed
        capacity the admit proceeds over budget (a running restore beats
        a strict bound — counted so benchmarks can see it)."""
        evicted = []
        if self.capacity_bytes is None:
            return evicted
        if self._bytes + incoming > self.capacity_bytes:
            for key in self.policy.victims():
                if self._bytes + incoming <= self.capacity_bytes:
                    break
                if key in self._pin_counts or key in self._inflight_writes \
                        or key not in self._sizes:
                    continue
                nbytes = self._deindex(key)
                self.path(key).unlink(missing_ok=True)
                evicted.append(key)
                self.stats["evictions"] += 1
                self.stats["evicted_bytes"] += nbytes
        if self._bytes + incoming > self.capacity_bytes:
            self.stats["over_capacity_admits"] += 1
        return evicted

    def put(self, key: str, data: bytes, *, job: Optional[str] = None) -> bool:
        """Admit ``data`` under ``key`` (atomic publish).  Returns whether
        THIS call stored it — a lost race with a concurrent writer is not
        an admission.  ``job`` optionally pins the entry for that job.

        The index entry is RESERVED (room made + bytes counted) before the
        file write, atomically under the index lock — otherwise N
        concurrent admits could each see a cache with room and
        collectively blow the byte bound."""
        p = self.path(key)
        tmp = p.with_name(p.name + f".tmp{threading.get_ident():x}")
        reserved = False
        try:
            with self._lock:
                present = key in self._sizes
                if not present:
                    evicted = self._make_room(len(data))
                    self._index(key, len(data))
                    self._inflight_writes.add(key)
                    reserved = True
                else:
                    evicted = []
                    self.policy.on_access(key)
            # inside the try: a raising eviction subscriber must roll the
            # reservation back, not leak the index entry + write marker
            self._notify_evicted(evicted)
            if present:
                if job is not None:
                    self.pin(job, key)
                return False
            tmp.write_bytes(data)
            os.link(tmp, p)        # atomic publish; loser keeps p intact
            stored = True
        except FileExistsError:
            stored = False         # concurrent writer won; bytes identical
        except BaseException:
            if reserved:
                with self._lock:
                    self._deindex(key)
            raise
        finally:
            if reserved:
                tmp.unlink(missing_ok=True)
                with self._lock:
                    self._inflight_writes.discard(key)
        if job is not None:
            self.pin(job, key)
        return stored

    def admit_file(self, key: str, tmp_path: Path, *,
                   job: Optional[str] = None) -> Path:
        """Admit an already-written temp file (streamed producers: env
        archives) by renaming it into the cache.  Returns the entry path."""
        nbytes = Path(tmp_path).stat().st_size
        dest = self.path(key)
        reserved = False
        try:
            with self._lock:
                fresh = key not in self._sizes
                evicted = self._make_room(nbytes if fresh else 0)
                if fresh:
                    self._index(key, nbytes)
                    self._inflight_writes.add(key)
                    reserved = True
            self._notify_evicted(evicted)
            Path(tmp_path).replace(dest)
        except BaseException:
            if reserved:
                with self._lock:
                    self._deindex(key)
            raise
        finally:
            if reserved:
                with self._lock:
                    self._inflight_writes.discard(key)
        if job is not None:
            self.pin(job, key)
        return dest

    # ----- singleflight -------------------------------------------------

    def _flight_lock(self, key: str) -> threading.Lock:
        with self._lock:
            return self._flights.setdefault(key, threading.Lock())

    def _retire_flight(self, key: str) -> None:
        """Drop the flight entry once ``key`` is admitted: future callers
        take the ``has()`` fast path before ever reaching the flight
        lock, and stragglers already blocked on the old lock object
        re-check ``has()`` after acquiring it.  Keeps ``_flights``
        bounded by in-progress fetches instead of every key ever seen."""
        with self._lock:
            self._flights.pop(key, None)

    def fetch_path(self, key: str, producer: Callable[[Path], None], *,
                   job: Optional[str] = None) -> Tuple[Path, bool]:
        """Singleflight admission: returns ``(entry path, was_hit)``.

        On a miss, exactly one caller per node runs ``producer(tmp_path)``
        (which must write the payload to ``tmp_path``); everyone else
        blocks on the flight and then reads the admitted entry.
        """
        if self.has(key):
            with self._lock:
                self.policy.on_access(key)
                self.stats["hits"] += 1
            if job is not None:
                self.pin(job, key)
            return self.path(key), True
        with self._flight_lock(key):
            if self.has(key):
                with self._lock:
                    self.stats["hits"] += 1
                    self.stats["singleflight_hits"] += 1
                if job is not None:
                    self.pin(job, key)
                self._retire_flight(key)
                return self.path(key), True
            with self._lock:
                self.stats["misses"] += 1
            tmp = self.path(key).with_name(
                self.path(key).name + f".tmp{os.getpid():x}")
            try:
                producer(tmp)
                dest = self.admit_file(key, tmp, job=job)
            finally:
                tmp.unlink(missing_ok=True)
        self._retire_flight(key)
        return dest, False

    def get_or_fetch(self, key: str, fetch: Callable[[], bytes], *,
                     job: Optional[str] = None) -> bytes:
        """Singleflight byte fetch (block-sized payloads)."""
        try:
            data = self.read(key)
            if job is not None:
                self.pin(job, key)
            return data
        except FileNotFoundError:
            pass
        with self._flight_lock(key):
            try:
                data = self.read(key)
                with self._lock:
                    self.stats["singleflight_hits"] += 1
                if job is not None:
                    self.pin(job, key)
                self._retire_flight(key)
                return data
            except FileNotFoundError:
                with self._lock:
                    self.stats["misses"] += 1
            data = fetch()
            self.put(key, data, job=job)
        self._retire_flight(key)
        return data

    # ----- invalidation -------------------------------------------------

    def invalidate(self, key: str) -> bool:
        """Drop ``key`` (expiry, corruption): file + index + listeners."""
        with self._lock:
            known = self._deindex(key) > 0 or self.path(key).exists()
        self.path(key).unlink(missing_ok=True)
        if known:
            self._notify_evicted([key])
        return known

    def invalidate_prefix(self, prefix: str) -> int:
        """Drop every entry whose key starts with ``prefix`` (an expired
        env key invalidates all its content-addressed archive versions)."""
        with self._lock:
            doomed = [k for k in self._sizes if k.startswith(prefix)]
        return sum(1 for k in doomed if self.invalidate(k))
