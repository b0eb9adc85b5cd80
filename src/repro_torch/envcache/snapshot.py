"""Job-level environment cache — dependency snapshotting (BootSeer §4.3,
Fig. 10).

First run of a job: snapshot the *target directory* (e.g. site-packages)
before and after the Environment Setup phase on node 0; every file added or
modified is packed into a compressed archive and uploaded to the DFS keyed
by the job's parameters.  Subsequent runs / restarts / node replacements of
the SAME job restore the archive and skip every install command.  If the job
parameters change (dependency versions, GPU type, OS, region...), the key
changes, so the stale cache simply never matches — expiry is structural.

Restore hot path
----------------
Restore is on the warm-restart critical path, so it is built to beat a
fresh install rather than merely match it:

* the packed archive is fetched from the DFS with the striped reader's
  ``width``-way parallel ``pread`` (large windows, not one whole-buffer
  ``read()``);
* with a ``local_cache`` directory configured, the blob is fetched from the
  DFS **once per node** and memoized in a storage-fabric
  :class:`~repro_torch.fabric.cache.NodeCache` — N concurrent restores (one per
  worker thread) share a single DFS fetch instead of hammering the shared
  throttle N times (the cache's singleflight admission), and
  ``local_cache_bytes`` bounds the node's archive footprint (LRU).
  Entries are **content-addressed** (job key + archive digest), so a
  re-snapshot under the same job key can never be served a stale node-local
  archive — the new digest simply never matches the old entry;
* decompression is streamed into the tar reader (no second whole-archive
  buffer);
* extraction replicates the stdlib ``data`` filter's safety checks manually
  (works on Pythons whose ``extractall`` lacks ``filter=``, < 3.12) and
  writes file payloads through a small thread pool.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import stat as stat_mod
import tarfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import BinaryIO, Optional

from repro_torch.fabric.cache import NodeCache

try:
    import zstandard as zstd

    def _compress(data: bytes) -> bytes:
        return zstd.ZstdCompressor(level=3).compress(data)

    def _decompress(data: bytes) -> bytes:
        return zstd.ZstdDecompressor().decompress(data)

    def _decompress_stream(fileobj: BinaryIO) -> BinaryIO:
        return zstd.ZstdDecompressor().stream_reader(fileobj)

    COMPRESSION = "zstd"
except ImportError:  # pragma: no cover
    import gzip

    def _compress(data: bytes) -> bytes:
        return gzip.compress(data, 6)

    def _decompress(data: bytes) -> bytes:
        return gzip.decompress(data)

    def _decompress_stream(fileobj: BinaryIO) -> BinaryIO:
        return gzip.GzipFile(fileobj=fileobj, mode="rb")

    COMPRESSION = "gzip"

# default DFS fetch window: one full stripe row of the default striped
# layout (8 files x 4 MB) so a windowed fetch keeps all spindles busy
FETCH_WINDOW = 32 * 1024 * 1024


def snapshot_dir(target: str | Path) -> dict[str, tuple[int, int]]:
    """{relpath: (size, mtime_ns)} for every file under target."""
    target = Path(target)
    snap = {}
    if not target.exists():
        return snap
    for p in target.rglob("*"):
        if p.is_file():
            st = p.stat()
            snap[str(p.relative_to(target))] = (st.st_size, st.st_mtime_ns)
    return snap


def diff_snapshots(before: dict, after: dict) -> list[str]:
    """Paths added or modified between two snapshots."""
    return sorted(p for p, sig in after.items()
                  if p not in before or before[p] != sig)


def job_cache_key(job_params: dict) -> str:
    """Deterministic cache key over the job's runtime parameters."""
    blob = json.dumps(job_params, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:24]


class _WindowedReader(io.RawIOBase):
    """File-like view over a DFS handle that reads ahead in large windows.

    Decompressors issue many small ``read()`` calls; each ``pread`` on a
    striped file costs a parallel fan-out, so serving small reads from a
    ``window``-sized buffer turns thousands of tiny reads into a handful of
    width-way-parallel ones.
    """

    def __init__(self, handle, size: int, window: int = FETCH_WINDOW,
                 sched=None, priority: int = 0):
        self._h = handle
        self._size = size
        self._window = max(window, 1)
        self._pos = 0
        self._buf = b""
        self._buf_start = 0
        # optional IOScheduler: each window fetch holds one "dfs" token,
        # so archive restores share the DFS with checkpoint preads under
        # priority order instead of free-for-all
        self._sched = sched
        self._priority = priority

    def readable(self) -> bool:
        return True

    def _fetch_window(self, pos: int, ln: int) -> bytes:
        if self._sched is not None:
            with self._sched.slot("dfs", priority=self._priority,
                                  nbytes=ln):
                return self._h.pread(pos, ln)
        return self._h.pread(pos, ln)

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = self._size - self._pos
        out = bytearray()
        while n > 0 and self._pos < self._size:
            off = self._pos - self._buf_start
            if not (0 <= off < len(self._buf)):
                self._buf_start = self._pos
                self._buf = self._fetch_window(
                    self._pos, min(self._window, self._size - self._pos))
                if not self._buf:
                    break
                off = 0
            take = self._buf[off:off + n]
            out += take
            self._pos += len(take)
            n -= len(take)
        return bytes(out)


def _unsafe_path(name: str) -> bool:
    return (name.startswith("/") or os.path.isabs(name)
            or ".." in name.replace("\\", "/").split("/"))


def _check_member(member: tarfile.TarInfo) -> None:
    """Reject archive members that would escape the extraction root
    (absolute paths, ``..`` traversal, devices) — the safety core of the
    stdlib ``data`` filter, replicated so restore works on Pythons whose
    ``extractall`` has no ``filter=`` parameter (< 3.12)."""
    if _unsafe_path(member.name):
        raise tarfile.TarError(f"unsafe path in env archive: {member.name!r}")
    if member.isdev():
        raise tarfile.TarError(f"device node in env archive: {member.name!r}")
    if (member.islnk() or member.issym()) and _unsafe_path(member.linkname):
        raise tarfile.TarError(
            f"unsafe link target in env archive: {member.linkname!r}")


def _write_member(target: Path, member: tarfile.TarInfo, data: bytes):
    dest = target / member.name
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_bytes(data)
    # clamp mode like the data filter: keep owner rwx, drop setuid etc.
    mode = member.mode
    if mode is not None:
        os.chmod(dest, (mode | 0o600) & 0o777 & ~stat_mod.S_ISUID
                 & ~stat_mod.S_ISGID)


class EnvCache:
    """Create/restore environment caches in the DFS (via HDFS-FUSE mount).

    ``local_cache``: optional node-local directory memoizing fetched
    archives in a storage-fabric :class:`NodeCache`, so any number of
    concurrent restores on this node cost one DFS fetch per key;
    ``local_cache_bytes`` bounds it (LRU eviction; ``None`` = unbounded).
    A pre-built :class:`NodeCache` may be passed directly as
    ``local_cache`` to share one fabric cache across consumers.
    ``extract_threads`` sizes the restore-side file writer pool.
    ``placement`` selects the DFS durability strategy for the packed
    archive (striped / replicated / erasure — see repro_torch.fabric.placement).
    """

    def __init__(self, mount, base: str = "/envcache", *,
                 local_cache: Optional[str | Path | NodeCache] = None,
                 local_cache_bytes: Optional[int] = None,
                 extract_threads: int = 4,
                 fetch_window: int = FETCH_WINDOW, sched=None,
                 placement=None):
        self.mount = mount  # HdfsFuseMount
        self.base = base.rstrip("/")
        self.extract_threads = max(1, extract_threads)
        self.fetch_window = fetch_window
        self.placement = placement
        # optional repro_torch.core.pipeline.IOScheduler shared with the other
        # startup engines (window fetches hold "dfs" tokens)
        self.sched = sched
        if isinstance(local_cache, NodeCache):
            self._local: Optional[NodeCache] = local_cache
        elif local_cache is not None:
            self._local = NodeCache(local_cache,
                                    capacity_bytes=local_cache_bytes)
        else:
            self._local = None
        self._flight_master = threading.Lock()
        self._in_flight: dict[str, threading.Lock] = {}
        self._pool: Optional[ThreadPoolExecutor] = None
        # meta blobs are treated as immutable per (key, generation):
        # create() and expire() both invalidate, so concurrent restores
        # share one DFS meta read without ever serving a stale entry
        self._meta_cache: dict[str, dict] = {}
        self.stats = {"dfs_archive_fetches": 0, "local_cache_hits": 0}

    # writes below this size are cheaper inline than through the pool
    # (thread wake-up costs more than a small write syscall)
    INLINE_WRITE_BYTES = 256 * 1024

    def _writer_pool(self) -> ThreadPoolExecutor:
        """Shared, lazily-created extraction pool.  One pool per EnvCache —
        thread spawn cost is paid once per node, not once per restore."""
        with self._flight_master:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    self.extract_threads,
                    thread_name_prefix="envcache-extract")
            return self._pool

    def close(self):
        with self._flight_master:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    def _data_path(self, key: str) -> str:
        return f"{self.base}/{key}.tar.{COMPRESSION}"

    def _meta_path(self, key: str) -> str:
        return f"{self.base}/{key}.meta.json"

    def exists(self, key: str) -> bool:
        return self.mount.exists(self._data_path(key)) and \
            self.mount.exists(self._meta_path(key))

    def expire(self, key: str):
        """Delete ``key``'s DFS archive + meta AND every local trace of it:
        the in-memory meta cache and any node-local cached archive for the
        key (all content-addressed generations).  Skipping either would let
        a re-snapshot under the same job key restore a stale environment."""
        for p in (self._data_path(key), self._meta_path(key)):
            if self.mount.exists(p):
                self.mount.hdfs.delete(self.mount._full(p))
        with self._flight_master:
            self._meta_cache.pop(key, None)
            # retire the key's flight lock too: without this the
            # per-key map grows for every job key ever restored
            self._in_flight.pop(key, None)
        if self._local is not None:
            self._local.invalidate_prefix(f"{key}.")

    # ----- create (first run, node 0) -----

    def create(self, key: str, target: str | Path, before: dict,
               job_params: Optional[dict] = None, *, striped: bool = True,
               launch_profile: Optional[dict] = None) -> dict:
        """Capture the diff of ``target`` vs ``before`` and upload.

        ``launch_profile``: a validated launch-env snapshot
        (``repro_torch.tune.launchprofile.LaunchProfile.to_json()``) stored in
        the meta — every later restore hands it back so the runtime can
        diff the live environment and report drift."""
        target = Path(target)
        after = snapshot_dir(target)
        changed = diff_snapshots(before, after)
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tar:
            for rel in changed:
                tar.add(target / rel, arcname=rel)
        raw = buf.getvalue()
        packed = _compress(raw)
        self.mount.write(self._data_path(key), packed, striped=striped,
                         placement=self.placement)
        meta = {"key": key, "files": len(changed),
                "raw_bytes": len(raw), "packed_bytes": len(packed),
                # content address of this archive generation: node-local
                # cache entries are keyed by it, so a re-snapshot under
                # the SAME job key can never be served a stale archive
                "digest": hashlib.sha256(packed).hexdigest(),
                "compression": COMPRESSION, "created": time.time(),
                "job_params": job_params or {}}
        if launch_profile is not None:
            meta["launch_profile"] = launch_profile
        self.mount.write(self._meta_path(key),
                         json.dumps(meta).encode())
        with self._flight_master:
            self._meta_cache[key] = meta
        if self._local is not None:
            # stale generations of this key are garbage now (expire may
            # not have run on this node before the re-create)
            for stale in self._local.keys():
                if stale.startswith(f"{key}.") \
                        and stale != self._entry_key(key, meta):
                    self._local.invalidate(stale)
        return meta

    # ----- restore (subsequent runs, every node) -----

    @staticmethod
    def _entry_key(key: str, meta: Optional[dict]) -> str:
        """Content-addressed node-cache key for one archive generation."""
        digest = (meta or {}).get("digest", "v0")[:16]
        return f"{key}.{digest}.tar.{COMPRESSION}"

    def _local_path(self, key: str, meta: Optional[dict] = None) -> Path:
        """Node-local path of ``key``'s cached archive.  Without ``meta``,
        resolves the (single live) generation by prefix — a test/debug
        convenience; the restore path always passes the meta through."""
        assert self._local is not None
        if meta is None:
            for k in self._local.keys():
                if k.startswith(f"{key}."):
                    return self._local.path(k)
        return self._local.path(self._entry_key(key, meta))

    def _key_lock(self, key: str) -> threading.Lock:
        with self._flight_master:
            return self._in_flight.setdefault(key, threading.Lock())

    def _fetch_archive(self, key: str, priority: int = 0) -> BinaryIO:
        """DFS fetch of the packed blob: width-way-parallel windowed reads."""
        handle = self.mount.open(self._data_path(key))
        with self._flight_master:
            self.stats["dfs_archive_fetches"] += 1
        return _WindowedReader(handle, len(handle), self.fetch_window,
                               sched=self.sched, priority=priority)

    def _open_archive(self, key: str, meta: Optional[dict],
                      priority: int = 0) -> BinaryIO:
        """Packed-archive byte stream: node-cache entry when enabled (one
        DFS fetch per node — the cache's singleflight admission), direct
        DFS stream otherwise."""
        if self._local is None:
            return self._fetch_archive(key, priority)

        def producer(tmp: Path):
            src = self._fetch_archive(key, priority)
            with open(tmp, "wb") as out:
                while True:
                    chunk = src.read(self.fetch_window)
                    if not chunk:
                        break
                    out.write(chunk)

        # under a byte bound, another key's admission can evict this entry
        # between fetch_path returning and the open — an eviction race is
        # a miss, so retry once and then stream straight from the DFS
        for _attempt in range(2):
            path, hit = self._local.fetch_path(self._entry_key(key, meta),
                                               producer)
            try:
                handle = open(path, "rb")
            except FileNotFoundError:
                continue
            if hit:
                with self._flight_master:
                    self.stats["local_cache_hits"] += 1
            return handle
        return self._fetch_archive(key, priority)

    def _extract_stream(self, packed: BinaryIO, target: Path):
        """Stream-decompress ``packed`` and extract members as they arrive.

        Large file payloads fan out to the shared writer pool (the write
        syscall releases the GIL); small ones are written inline — a thread
        hand-off costs more than the write itself."""
        target.mkdir(parents=True, exist_ok=True)
        futures = []
        try:
            with _decompress_stream(packed) as raw, \
                    tarfile.open(fileobj=raw, mode="r|") as tar:
                for member in tar:
                    _check_member(member)
                    if member.isdir():
                        (target / member.name).mkdir(parents=True,
                                                     exist_ok=True)
                    elif member.isreg():
                        src = tar.extractfile(member)
                        data = src.read() if src is not None else b""
                        if len(data) >= self.INLINE_WRITE_BYTES:
                            futures.append(self._writer_pool().submit(
                                _write_member, target, member, data))
                        else:
                            _write_member(target, member, data)
                    elif member.issym():
                        dest = target / member.name
                        dest.parent.mkdir(parents=True, exist_ok=True)
                        dest.unlink(missing_ok=True)
                        os.symlink(member.linkname, dest)
                    # hard links / other exotic types never come out of
                    # create()
        except BaseException:
            # drain in-flight writes before propagating: a retry (corrupt
            # local archive) must not race stale writes into the target
            for f in futures:
                try:
                    f.result()
                except Exception:  # noqa: BLE001 - original error wins
                    pass
            raise
        for f in futures:
            f.result()

    def restore(self, key: str, target: str | Path,
                priority: int = 0) -> Optional[dict]:
        """Extract the cached environment into ``target``.  Returns the cache
        meta, or None when no valid cache exists (caller falls back to the
        real install commands).  ``priority`` is the scheduler class the
        DFS window fetches run under (CRITICAL on the startup path)."""
        if not self.exists(key):
            return None
        with self._flight_master:
            meta = self._meta_cache.get(key)
        if meta is None:
            # singleflight like the archive fetch: N concurrent restores
            # cost ONE meta read, not a racy handful (also keeps DFS
            # read-byte accounting deterministic for the benchmarks)
            with self._key_lock(key):
                with self._flight_master:
                    meta = self._meta_cache.get(key)
                if meta is None:
                    # under a "dfs" token at the restore's priority, like
                    # the archive's windows: the JAX package's copy reads
                    # the meta outside the scheduler
                    handle = self.mount.open(self._meta_path(key))
                    meta = json.loads(_WindowedReader(
                        handle, len(handle), self.fetch_window,
                        sched=self.sched, priority=priority).read())
                    with self._flight_master:
                        self._meta_cache[key] = meta
            # meta is cached now: future restores take the fast path, so
            # the flight lock has done its job — stragglers already
            # blocked on the old lock object re-check the cache under it
            with self._flight_master:
                self._in_flight.pop(key, None)
        packed = self._open_archive(key, meta, priority)
        try:
            try:
                self._extract_stream(packed, Path(target))
            except Exception:
                if self._local is None:
                    raise
                # node-local archive may be corrupt (torn write, disk rot):
                # invalidate it and retry once straight from the DFS — only
                # a second failure (bad DFS copy) propagates
                packed.close()
                self._local.invalidate(self._entry_key(key, meta))
                packed = self._fetch_archive(key, priority)
                self._extract_stream(packed, Path(target))
        finally:
            packed.close()
        return meta
