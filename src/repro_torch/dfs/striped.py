"""Striped layout for checkpoint files (BootSeer §4.4, Fig. 11) behind the
storage fabric's :class:`~repro_torch.fabric.placement.Placement` abstraction.

The logical file is split into 1 MB chunks; chunks are grouped into 4 MB
stripe units and the units round-robin across ``width`` physical files, each
placed in a DIFFERENT DataNode group.  Reads and writes therefore run with
``width``-way parallelism (one thread per physical file) instead of being
serialized inside a single 512 MB HDFS block.

Layout math for chunk ``i`` (chunk = 1 MB, stripe = 4 MB = ``spc`` chunks):
    unit        u = i // spc
    file        f = u % width
    unit-in-file  = u // width
    offset-in-file = (u // width) * stripe + (i % spc) * chunk

``StripedReader.pread`` reads an arbitrary (offset, length) range touching
only the chunks it needs — this is what makes *sharding-aware* checkpoint
resumption possible (each host fetches only its shard's byte ranges).
``StripedReader.pread_many`` batches a whole *set* of ranges (a restore
plan's reads, see repro_torch.ckpt.plan): all chunk sub-reads are grouped per
physical stripe file, each file is opened AT MOST ONCE per call, and the
per-file jobs run on one shared long-lived I/O pool instead of a fresh
``ThreadPoolExecutor`` per read.

Durability is a placement property, not a reader property:

* ``striped`` (default) — the pre-fabric behaviour, byte-identical
  layout and metadata: a missing/truncated physical file raises
  :class:`StripeMissingError` naming the file and DataNode group.
* ``replicated`` — a failed data file fails over to its mirror copies.
* ``erasure`` — Reed-Solomon parity files; a missing or truncated data
  file is **reconstructed transparently** inside ``pread_many`` (the
  caller sees correct bytes), a *corrupted* chunk (bad bytes, right
  length) is detected by its stored CRC and reconstructed too.
  Reconstruction I/O runs under the reader's ``IOScheduler`` priority
  and lands in the cluster's byte accounting like any other read; the
  reader's ``stats`` (and ``HdfsCluster.fabric_stats``) count
  ``degraded_reads`` / ``reconstructed_bytes`` /
  ``reconstruction_read_bytes`` / ``corrupt_chunks``.
"""

from __future__ import annotations

import os
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.dfs.hdfs import BlockMeta, HdfsCluster
from repro_torch.fabric.gf256 import cauchy_matrix, gf_mul_bytes, rs_decode
from repro_torch.fabric.placement import ERASURE, REPLICATED, Placement

CHUNK = 1 * 1024 * 1024
STRIPE = 4 * 1024 * 1024


class StripeMissingError(RuntimeError):
    """A physical stripe file backing a striped DFS file is missing (or
    truncated): the logical file cannot be read completely.  Raised instead
    of returning silently corrupt bytes; names the exact physical file and
    DataNode group so operators know which replica to repair."""

    def __init__(self, logical_path: str, *, file_index: int, group: int,
                 name: str, detail: str = "missing"):
        self.logical_path = logical_path
        self.file_index = file_index
        self.group = group
        self.name = name
        super().__init__(
            f"striped file '{logical_path}': physical stripe file '{name}' "
            f"(stripe index {file_index}, DataNode group {group}) is "
            f"{detail}")


class StripeCorruptError(StripeMissingError):
    """A stripe chunk failed its stored CRC (bad bytes, correct length)
    and could not be reconstructed from parity — detected by the erasure
    placement's per-chunk digests instead of being returned as payload."""

    def __init__(self, logical_path: str, *, file_index: int, group: int,
                 name: str, detail: str = "corrupt"):
        super().__init__(logical_path, file_index=file_index, group=group,
                         name=name, detail=detail)


def pread_many_fallback(pread, ranges, into=None, priority=None):
    """Per-range ``pread_many`` for non-striped readers, matching
    ``StripedReader.pread_many``'s return contract (bytes list, or byte
    counts with ``into`` buffers filled).  Independent ranges run
    concurrently on the shared I/O pool, so the plain path keeps the
    multi-tensor fetch parallelism the old restore had.  ``priority`` is
    accepted for signature parity with ``StripedReader.pread_many`` (the
    plain path is not scheduler-metered)."""
    results: list = [None] * len(ranges)

    def one(i):
        off, ln = ranges[i]
        data = pread(off, ln)
        if into is None:
            results[i] = data
        else:
            memoryview(into[i])[:len(data)] = data
            results[i] = len(data)

    if len(ranges) <= 1:
        for i in range(len(ranges)):
            one(i)
    else:
        pool = shared_io_pool()
        for fu in [pool.submit(one, i) for i in range(len(ranges))]:
            fu.result()
    return results


_IO_POOL: Optional[ThreadPoolExecutor] = None
_IO_POOL_LOCK = threading.Lock()


def shared_io_pool() -> ThreadPoolExecutor:
    """Process-wide long-lived pool for striped-DFS file jobs.

    Every reader/writer shares it, so the per-call executor spawn cost
    (~ms per thread on small boxes) is paid once per process and total
    I/O concurrency stays bounded by the pool size instead of scaling
    with the number of concurrent readers.  Tasks submitted here are pure
    file I/O and never wait on other tasks in this pool, so it cannot
    deadlock.
    """
    global _IO_POOL
    with _IO_POOL_LOCK:
        if _IO_POOL is None:
            _IO_POOL = ThreadPoolExecutor(
                max(4, 2 * (os.cpu_count() or 2)),
                thread_name_prefix="dfs-io")
        return _IO_POOL


@dataclass(frozen=True)
class StripedMeta:
    size: int
    width: int
    chunk: int
    stripe: int
    files: tuple  # (group, name) per physical file

    @property
    def spc(self) -> int:  # chunks per stripe unit
        return self.stripe // self.chunk

    def locate(self, chunk_idx: int) -> tuple[int, int]:
        """-> (file index, offset within that physical file)."""
        u = chunk_idx // self.spc
        f = u % self.width
        off = (u // self.width) * self.stripe + (chunk_idx % self.spc) * self.chunk
        return f, off


class StripedWriter:
    """Parallel striped write of a logical stream, placement-aware.

    ``placement``: a :class:`repro_torch.fabric.placement.Placement` (or its
    kind string).  ``replicated`` mirrors every data-file write through
    to its replica handles; ``erasure`` accumulates Reed-Solomon parity
    byte-wise (at identical file offsets, so no stripe-row alignment is
    needed on read) plus a CRC per written chunk, and writes the parity
    files at :meth:`close`.  Plain striping writes byte-identical data
    AND metadata to the pre-fabric format.
    """

    def __init__(self, hdfs: HdfsCluster, path: str, *, width: int = 8,
                 chunk: int = CHUNK, stripe: int = STRIPE,
                 threads: Optional[int] = None,
                 placement: Placement | str | None = None):
        assert stripe % chunk == 0
        self.hdfs = hdfs
        self.path = path
        self.width = min(width, hdfs.num_groups)
        self.chunk = chunk
        self.stripe = stripe
        self.threads = threads or self.width
        self.placement = Placement.parse(placement)
        self._buf = bytearray()
        self._size = 0
        self._flushed = 0
        self._files = []
        self._handles = []
        tag = zlib.crc32(path.encode()) % 10 ** 8
        for f in range(self.width):
            group = (f * max(hdfs.num_groups // self.width, 1)) % hdfs.num_groups
            name = f"stripe_{tag:08d}_{f}"
            self._files.append((group, name))
            self._handles.append(hdfs.open_group_file(group, name, "wb"))
        self._file_len = [0] * self.width          # bytes written per file
        # replicated: mirror handles per data file
        self._replicas: list[list[tuple[int, str]]] = []
        self._replica_handles: list[list] = []
        if self.placement.kind == REPLICATED:
            # region-spread: each mirror jumps a whole region of groups,
            # so replica r lives in region (data_region + r + 1) — a
            # lost region still leaves a full copy, and a remote
            # region's reader fails over to a region-LOCAL mirror.
            # Falls back to the adjacent-group layout on single-region
            # clusters (where the stride would degenerate to 0 mod n).
            spread = (self.placement.region_spread
                      and hdfs.num_regions > 1)
            stride = hdfs.region_stride() if spread else 1
            for f in range(self.width):
                names, handles = [], []
                for r in range(self.placement.replicas):
                    group = (self._files[f][0]
                             + (r + 1) * stride) % hdfs.num_groups
                    if group == self._files[f][0]:
                        # stride wrapped a full lap (replicas >= regions
                        # or >= groups): never mirror into the data
                        # file's own group
                        group = (group + 1) % hdfs.num_groups
                    name = f"stripe_{tag:08d}_{f}r{r}"
                    names.append((group, name))
                    handles.append(hdfs.open_group_file(group, name, "wb"))
                self._replicas.append(names)
                self._replica_handles.append(handles)
        # erasure: byte-wise parity accumulators + per-chunk CRCs
        self._parity_arr: list[np.ndarray] = []
        self._coef: list[list[int]] = []
        self._crcs: list[dict[int, int]] = [dict() for _ in range(self.width)]
        if self.placement.kind == ERASURE:
            self._coef = cauchy_matrix(self.placement.parity, self.width)
            self._parity_arr = [np.zeros(0, np.uint8)
                                for _ in range(self.placement.parity)]

    def write(self, data: bytes):
        """Appends ``data`` (any bytes-like object) to the stream. Whole
        chunks are written from the caller's buffer without a copy (the
        reference's writer copied every byte three times, which held a
        40 GB checkpoint's save to ~0.3 GB/s); only a partial chunk is
        kept. The files get the same bytes at the same offsets."""
        view = memoryview(data).cast("B")
        self._size += len(view)
        if self._buf:
            need = min(self.chunk - len(self._buf), len(view))
            self._buf += view[:need]
            view = view[need:]
            if len(self._buf) < self.chunk:
                return
            self._flush(bytes(self._buf))
            self._buf.clear()
        full = (len(view) // self.chunk) * self.chunk
        if full:
            self._flush(view[:full])
        self._buf += view[full:]

    def _ensure_parity(self, nbytes: int):
        for j, arr in enumerate(self._parity_arr):
            if len(arr) < nbytes:
                grown = np.zeros(max(nbytes, 2 * len(arr)), np.uint8)
                grown[:len(arr)] = arr
                self._parity_arr[j] = grown

    def _flush(self, data: bytes):
        meta = self._meta_for(self._size)  # width/chunk/stripe fixed
        start_chunk = self._flushed // self.chunk
        self._flushed += len(data)
        # group chunk writes per file, then write in parallel
        per_file: dict[int, list[tuple[int, bytes]]] = {}
        for j in range(0, len(data), self.chunk):
            ci = start_chunk + j // self.chunk
            f, off = meta.locate(ci)
            payload = data[j:j + self.chunk]
            per_file.setdefault(f, []).append((off, payload))
            self._file_len[f] = max(self._file_len[f], off + len(payload))
            if self.placement.kind == ERASURE:
                self._crcs[f][off // self.chunk] = zlib.crc32(payload)
                self._ensure_parity(off + len(payload))
                src = np.frombuffer(payload, np.uint8)
                for p, row in enumerate(self._coef):
                    dst = self._parity_arr[p][off:off + len(payload)]
                    np.bitwise_xor(dst, gf_mul_bytes(row[f], src), out=dst)

        def write_file(f):
            h = self._handles[f]
            n = 0
            for off, payload in per_file[f]:
                h.seek(off)
                h.write(payload)
                n += len(payload)
            for rh in (self._replica_handles[f] if self._replica_handles
                       else ()):
                for off, payload in per_file[f]:
                    rh.seek(off)
                    rh.write(payload)
                    n += len(payload)
            self.hdfs.account_write(n)
            if self.hdfs.throttle:
                with self.hdfs.throttle:
                    self.hdfs.throttle.charge(n)

        # a single-file flush (small archives) runs inline instead of
        # round-tripping through the pool
        if len(per_file) == 1:
            write_file(next(iter(per_file)))
        else:
            pool = shared_io_pool()
            for fu in [pool.submit(write_file, f) for f in per_file]:
                fu.result()

    def _meta_for(self, size: int) -> StripedMeta:
        return StripedMeta(size=size, width=self.width, chunk=self.chunk,
                           stripe=self.stripe, files=tuple(self._files))

    def _close_parity(self) -> Placement:
        """Write the parity files and return the fully-populated
        erasure Placement record."""
        tag = zlib.crc32(self.path.encode()) % 10 ** 8
        parity_len = max(self._file_len) if any(self._file_len) else 0
        parity_files, parity_crcs = [], []
        for p in range(self.placement.parity):
            group = (self.width + p) % self.hdfs.num_groups
            name = f"stripe_{tag:08d}_p{p}"
            parity_files.append((group, name))
            buf = self._parity_arr[p][:parity_len]
            with self.hdfs.open_group_file(group, name, "wb") as h:
                h.write(buf.tobytes())
            self.hdfs.account_write(parity_len)
            if self.hdfs.throttle:
                with self.hdfs.throttle:
                    self.hdfs.throttle.charge(parity_len)
            parity_crcs.append(
                [zlib.crc32(buf[o:o + self.chunk])
                 for o in range(0, parity_len, self.chunk)])
        data_crcs = [[crcs[i] for i in sorted(crcs)] for crcs in self._crcs]
        return Placement(
            kind=ERASURE, parity=self.placement.parity,
            verify=self.placement.verify,
            parity_files=tuple(parity_files),
            file_lengths=tuple(self._file_len), parity_length=parity_len,
            chunk_crc={"data": data_crcs, "parity": parity_crcs})

    def close(self):
        if self._buf:
            pad = bytes(self._buf)
            self._buf.clear()
            self._flush(pad + b"\0" * ((-len(pad)) % self.chunk))
        for h in self._handles:
            h.close()
        for handles in self._replica_handles:
            for h in handles:
                h.close()
        placement = self.placement
        if placement.kind == ERASURE:
            placement = self._close_parity()
        elif placement.kind == REPLICATED:
            placement = Placement(kind=REPLICATED,
                                  replicas=placement.replicas,
                                  region_spread=placement.region_spread,
                                  replica_files=tuple(
                                      tuple(r) for r in self._replicas))
        meta = self._meta_for(self._size)
        blocks = [BlockMeta(group=g, path=n, length=0)
                  for g, n in meta.files]
        attrs = {"striped": {
            "size": meta.size, "width": meta.width, "chunk": meta.chunk,
            "stripe": meta.stripe, "files": list(meta.files)}}
        placement_attrs = placement.to_attrs()
        if placement_attrs is not None:
            attrs["placement"] = placement_attrs
        self.hdfs.register_raw(self.path, self._size, blocks, attrs=attrs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StripedReader:
    """Parallel positional reads of a striped file.

    All read paths funnel through :meth:`pread_many`: sub-reads are grouped
    per physical stripe file, sorted and merged into sequential runs, each
    file is opened at most once per call, and the per-file jobs run on the
    shared long-lived I/O pool (``threads`` is kept for API compat but the
    pool bounds actual concurrency).

    The file's :class:`Placement` (recorded at write time) decides what a
    failed physical file means: plain striping raises
    :class:`StripeMissingError` exactly as before the fabric; replication
    fails over to mirror copies; erasure placement reconstructs the
    missing/corrupt chunks from parity inside this call.
    """

    def __init__(self, hdfs: HdfsCluster, path: str,
                 threads: Optional[int] = None,
                 pool: Optional[ThreadPoolExecutor] = None,
                 sched=None, priority: int = 0,
                 prefer_region: Optional[int] = None):
        self.hdfs = hdfs
        self.path = path
        # region-local reads: with region-spread replicated placement, a
        # reader in DataNode region ``prefer_region`` serves each stripe
        # from whichever copy (primary or mirror) lives in its own
        # region, so a remote region's restore never crosses the WAN for
        # data it has a local mirror of.  None keeps primary-first.
        self.prefer_region = prefer_region
        attrs = hdfs.attrs(path)
        raw = attrs["striped"]
        self.meta = StripedMeta(size=raw["size"], width=raw["width"],
                                chunk=raw["chunk"], stripe=raw["stripe"],
                                files=tuple(tuple(f) for f in raw["files"]))
        self.placement = Placement.from_attrs(attrs.get("placement"))
        self.threads = threads or self.meta.width
        self._pool = pool
        # optional bandwidth-aware scheduler (repro_torch.core.pipeline
        # IOScheduler): each per-file read job holds one "dfs" token, so
        # concurrent readers of different priority classes cannot convoy
        # each other — a CRITICAL params-wave pread is granted the next
        # free token even when a DEFERRED opt-state wave queued first
        self.sched = sched
        self.priority = priority
        self.stats = {"degraded_reads": 0, "reconstructed_bytes": 0,
                      "reconstruction_read_bytes": 0, "corrupt_chunks": 0}

    @property
    def size(self) -> int:
        return self.meta.size

    def pread(self, offset: int, length: int) -> bytes:
        return self.pread_many([(offset, length)])[0]

    def _account_fabric(self, **kw):
        for key, n in kw.items():
            self.stats[key] += n
        self.hdfs.account_fabric(**kw)

    def pread_many(self, ranges: Sequence[tuple[int, int]],
                   into: Optional[Sequence] = None,
                   priority: Optional[int] = None):
        """Batched positional reads.

        ``ranges``: (offset, length) pairs over the logical stream; each is
        clamped at EOF like :meth:`pread`.  Without ``into``, returns one
        ``bytes`` per range.  With ``into`` — parallel writable buffers
        (anything supporting the buffer protocol, e.g. numpy uint8 views) —
        bytes land zero-copy via ``readinto`` and the per-range byte counts
        are returned.  ``priority`` overrides the reader's scheduler
        priority class for this call (ignored without a scheduler).

        Raises :class:`StripeMissingError` if a physical stripe file is
        gone or short *and the placement cannot recover it* (plain
        striping never can; replication/erasure raise only past their
        failure budget).
        """
        m = self.meta
        prio = self.priority if priority is None else priority
        clamped: list[tuple[int, int]] = []
        views: list[Optional[memoryview]] = []
        out: list = []
        for i, (off, ln) in enumerate(ranges):
            ln = max(0, min(ln, m.size - off))
            clamped.append((off, ln))
            if into is None:
                buf = bytearray(ln)
                out.append(buf)
                views.append(memoryview(buf))
            else:
                out.append(ln)
                views.append(memoryview(into[i]) if ln else None)

        # chunk sub-reads grouped per physical file:
        # (file_offset, length, range_idx, dest_offset)
        jobs: dict[int, list[tuple[int, int, int, int]]] = {}
        for i, (off, ln) in enumerate(clamped):
            if ln <= 0:
                continue
            first = off // m.chunk
            last = (off + ln - 1) // m.chunk
            for ci in range(first, last + 1):
                f, base = m.locate(ci)
                lo = max(off - ci * m.chunk, 0)
                hi = min(off + ln - ci * m.chunk, m.chunk)
                dst = ci * m.chunk + lo - off
                jobs.setdefault(f, []).append((base + lo, hi - lo, i, dst))

        # sort by file offset and merge file- and dest-contiguous sub-reads
        # so full-tensor restores become a few big sequential readintos
        for f, subs in jobs.items():
            subs.sort()
            merged = [subs[0]]
            for off, ln, i, dst in subs[1:]:
                poff, pln, pi, pdst = merged[-1]
                if off == poff + pln and i == pi and dst == pdst + pln:
                    merged[-1] = (poff, pln + ln, pi, pdst)
                else:
                    merged.append((off, ln, i, dst))
            jobs[f] = merged

        if self.placement.kind == ERASURE:
            self._pread_erasure(jobs, views, prio)
        else:
            self._pread_direct(jobs, views, prio)
        if into is None:
            return [bytes(b) for b in out]
        return out

    # ----- striped / replicated path -----------------------------------

    def _pread_direct(self, jobs, views, prio):
        def read_file(f):
            if self.sched is not None:
                nbytes = sum(ln for _, ln, _, _ in jobs[f])
                with self.sched.slot("dfs", priority=prio, nbytes=nbytes):
                    return read_file_inner(f)
            return read_file_inner(f)

        def read_file_inner(f):
            group, name = self.meta.files[f]
            candidates = [(group, name)]
            if self.placement.kind == REPLICATED:
                replicas = (self.placement.replica_files[f]
                            if f < len(self.placement.replica_files) else ())
                candidates += [tuple(r) for r in replicas]
                if self.prefer_region is not None:
                    # region-local copies first (stable: primary-before-
                    # mirror within each region class).  A mirror read
                    # chosen for locality is NOT a degraded read — only
                    # falling past a FAILED primary is.
                    candidates.sort(key=lambda gn: self.hdfs.group_region(
                        gn[0]) != self.prefer_region)
            primary_failed = False
            last_err = None
            for g, n in candidates:
                try:
                    self._read_subs(f, g, n, jobs[f], views)
                except StripeMissingError as err:
                    last_err = err
                    if (g, n) == (group, name):
                        primary_failed = True
                        if self.placement.kind != REPLICATED:
                            raise
                    continue
                if (g, n) != (group, name) and primary_failed:
                    self._account_fabric(degraded_reads=1)
                return
            raise StripeMissingError(
                self.path, file_index=f, group=group, name=name,
                detail=f"missing and all {len(candidates) - 1} replicas "
                       "are missing or truncated") from last_err

        # single-file calls (sub-stripe ranges) skip the pool entirely
        if len(jobs) == 1:
            read_file(next(iter(jobs)))
        elif jobs:
            pool = self._pool or shared_io_pool()
            futs = [pool.submit(read_file, f) for f in jobs]
            for fu in futs:
                fu.result()

    def _read_subs(self, f, group, name, subs, views):
        """One physical file's merged sub-reads straight into ``views``
        (the pre-fabric hot path, unchanged)."""
        n = 0
        try:
            h = self.hdfs.open_group_file(group, name, "rb")
        except FileNotFoundError as e:
            raise StripeMissingError(self.path, file_index=f,
                                     group=group, name=name) from e
        # accounting in finally: a truncated attempt has already moved
        # its partial bytes off the DataNode, and replica retries repeat
        # the cost — failed attempts bill like successful ones
        try:
            with h:
                for off, ln, i, dst in subs:
                    h.seek(off)
                    got = h.readinto(views[i][dst:dst + ln])
                    n += max(0, int(got or 0))
                    if got != ln:
                        raise StripeMissingError(
                            self.path, file_index=f, group=group, name=name,
                            detail=f"truncated (wanted {ln} bytes at offset "
                                   f"{off}, got {got})")
        finally:
            if n:
                self.hdfs.account_read(n)
                if self.hdfs.throttle:
                    with self.hdfs.throttle:
                        self.hdfs.throttle.charge(n)

    # ----- erasure path -------------------------------------------------

    @staticmethod
    def _rows_of(subs, chunk) -> list:
        rows = set()
        for off, ln, _i, _dst in subs:
            rows.update(range(off // chunk, (off + ln - 1) // chunk + 1))
        return sorted(rows)

    def _read_rows(self, group, name, rows, *, length, crcs, f_idx,
                   pad_missing=False):
        """Read whole chunk rows of one physical file.

        Returns ``(chunks: {row: np.uint8 array}, bad_rows: set)`` where
        ``bad_rows`` are rows whose CRC failed verification.  Rows past
        the recorded ``length`` are all-zero without touching disk when
        ``pad_missing`` (reconstruction sources: RS coding zero-pads the
        shorter data files).  Raises :class:`StripeMissingError` when the
        file itself is gone or shorter than its recorded length.
        """
        chunk = self.meta.chunk
        chunks: dict[int, np.ndarray] = {}
        bad: set[int] = set()
        disk_rows = []
        for r in rows:
            if (r + 1) * chunk > length:
                if not pad_missing:
                    raise StripeMissingError(
                        self.path, file_index=f_idx, group=group, name=name,
                        detail=f"chunk {r} beyond recorded length {length}")
                chunks[r] = np.zeros(chunk, np.uint8)
            else:
                disk_rows.append(r)
        # merge contiguous rows into sequential runs
        runs: list[list[int]] = []
        for r in disk_rows:
            if runs and runs[-1][-1] == r - 1:
                runs[-1].append(r)
            else:
                runs.append([r])
        n = 0
        if disk_rows:
            try:
                h = self.hdfs.open_group_file(group, name, "rb")
            except FileNotFoundError as e:
                raise StripeMissingError(self.path, file_index=f_idx,
                                         group=group, name=name) from e
            # bill in finally: a truncation detected mid-run has already
            # moved its partial bytes (same discipline as _read_subs)
            try:
                with h:
                    for run in runs:
                        buf = np.empty(len(run) * chunk, np.uint8)
                        h.seek(run[0] * chunk)
                        got = h.readinto(memoryview(buf))
                        n += max(0, int(got or 0))
                        if got != len(buf):
                            raise StripeMissingError(
                                self.path, file_index=f_idx, group=group,
                                name=name,
                                detail=f"truncated (wanted {len(buf)} bytes "
                                       f"at offset {run[0] * chunk}, "
                                       f"got {got})")
                        for j, r in enumerate(run):
                            chunks[r] = buf[j * chunk:(j + 1) * chunk]
            finally:
                if n:
                    self.hdfs.account_read(n)
                    if self.hdfs.throttle:
                        with self.hdfs.throttle:
                            self.hdfs.throttle.charge(n)
        if self.placement.verify and crcs is not None:
            for r in disk_rows:
                if r < len(crcs) and zlib.crc32(chunks[r]) != crcs[r]:
                    bad.add(r)
        return chunks, bad, n

    def _pread_erasure(self, jobs, views, prio):
        m = self.meta
        crc = self.placement.chunk_crc or {}
        data_crcs = crc.get("data", [])
        lengths = self.placement.file_lengths

        results: dict[int, dict[int, np.ndarray]] = {}
        failed: dict[int, set[int]] = {}

        verify = self.placement.verify

        def attempt(f):
            group, name = m.files[f]
            if not verify:
                # no CRCs to check: the healthy path reads exact ranges
                # like plain striping (zero read amplification); only a
                # failure falls back to chunk-row reconstruction
                try:
                    if self.sched is not None:
                        nb = sum(ln for _, ln, _, _ in jobs[f])
                        with self.sched.slot("dfs", priority=prio,
                                             nbytes=nb):
                            self._read_subs(f, group, name, jobs[f], views)
                    else:
                        self._read_subs(f, group, name, jobs[f], views)
                    return f, None, set()
                except StripeMissingError:
                    return f, {}, set(self._rows_of(jobs[f], m.chunk))
            rows = self._rows_of(jobs[f], m.chunk)
            crcs = data_crcs[f] if f < len(data_crcs) else None
            length = lengths[f] if f < len(lengths) else m.size
            nbytes = len(rows) * m.chunk

            def inner():
                try:
                    chunks, bad, _n = self._read_rows(
                        group, name, rows, length=length, crcs=crcs,
                        f_idx=f)
                except StripeMissingError:
                    return f, {}, set(rows)
                if bad:
                    self._account_fabric(corrupt_chunks=len(bad))
                return f, chunks, bad

            if self.sched is not None:
                with self.sched.slot("dfs", priority=prio, nbytes=nbytes):
                    return inner()
            return inner()

        if len(jobs) == 1:
            outs = [attempt(next(iter(jobs)))]
        else:
            pool = self._pool or shared_io_pool()
            outs = [fu.result()
                    for fu in [pool.submit(attempt, f) for f in jobs]]
        for f, chunks, bad in outs:
            results[f] = chunks
            if bad:
                failed[f] = set(bad)

        if failed:
            self._recover(failed, results, prio)
        for f, subs in jobs.items():
            # chunks=None marks a file already scattered zero-copy by the
            # exact-range path
            if results[f] is not None:
                self._scatter(results[f], subs, views)

    def _recover(self, failed: dict[int, set[int]],
                 results: dict[int, dict[int, np.ndarray]], prio):
        """Reconstruct the failed chunk rows from k surviving shards.

        ``failed`` maps data-file index -> rows lost (missing file,
        truncation, or CRC mismatch); reconstructed chunks are CRC-checked
        against the stored digests before being trusted.  Source reads
        hold DFS scheduler tokens at the caller's priority and land in
        normal read accounting — the measured read amplification of
        degraded mode.
        """
        m = self.meta
        k = m.width
        par = self.placement.parity
        crc = self.placement.chunk_crc or {}
        data_crcs = crc.get("data", [])
        parity_crcs = crc.get("parity", [])
        lengths = self.placement.file_lengths

        need_rows = sorted(set().union(*failed.values()))
        have: dict[int, dict[int, np.ndarray]] = {r: {} for r in need_rows}
        # seed with survivor chunks this very call already read (and CRC
        # verified): a planned restore sweeps all files at aligned
        # offsets, so most of the k source ranges per missing chunk are
        # in hand and reconstruction only fetches the gaps + parity —
        # read amplification ~1 + 1/k instead of 1 + (k-1)/k
        for f2, chunks in results.items():
            if f2 in failed or chunks is None:
                continue
            for r in need_rows:
                blk = chunks.get(r)
                if blk is not None:
                    have[r][f2] = blk
        # exclude any shard with failures from the source pool entirely:
        # with k+m shards and <= m failures there are always >= k clean
        # candidates, and a partially-corrupt source is not worth the
        # bookkeeping of per-row trust
        candidates = ([f for f in range(k) if f not in failed]
                      + [k + j for j in range(par)])
        src_bytes = 0
        for shard in candidates:
            missing = [r for r in need_rows
                       if len(have[r]) < k and shard not in have[r]]
            if not missing:
                if all(len(have[r]) >= k for r in need_rows):
                    break
                continue
            if shard < k:
                group, name = m.files[shard]
                crcs = data_crcs[shard] if shard < len(data_crcs) else None
                length = lengths[shard] if shard < len(lengths) else 0
            else:
                j = shard - k
                if j >= len(self.placement.parity_files):
                    continue
                group, name = self.placement.parity_files[j]
                crcs = parity_crcs[j] if j < len(parity_crcs) else None
                length = self.placement.parity_length
            nbytes = len(missing) * m.chunk

            def read_source():
                try:
                    chunks, bad, n = self._read_rows(
                        group, name, missing, length=length, crcs=crcs,
                        f_idx=shard, pad_missing=True)
                except StripeMissingError:
                    return {}, 0
                return ({r: c for r, c in chunks.items() if r not in bad},
                        n)

            if self.sched is not None:
                with self.sched.slot("dfs", priority=prio, nbytes=nbytes):
                    good, n = read_source()
            else:
                good, n = read_source()
            src_bytes += n
            for r, blk in good.items():
                have[r][shard] = blk

        recon_bytes = 0
        for r in need_rows:
            want = [f for f in failed if r in failed[f]]
            if len(have[r]) < k:
                group, name = m.files[want[0]]
                raise StripeMissingError(
                    self.path, file_index=want[0], group=group, name=name,
                    detail=f"unrecoverable: chunk {r} has only "
                           f"{len(have[r])} of the k={k} source shards "
                           f"needed (parity m={par} exhausted)")
            decoded = rs_decode(have[r], k, par, want)
            for f in want:
                blk = decoded[f]
                crcs = data_crcs[f] if f < len(data_crcs) else None
                if (self.placement.verify and crcs is not None
                        and r < len(crcs)
                        and zlib.crc32(blk) != crcs[r]):
                    group, name = m.files[f]
                    raise StripeCorruptError(
                        self.path, file_index=f, group=group, name=name,
                        detail=f"chunk {r} reconstruction failed its "
                               "stored CRC (more corrupt shards than "
                               "parity can absorb)")
                results[f][r] = blk
                recon_bytes += len(blk)
        self._account_fabric(degraded_reads=len(failed),
                             reconstructed_bytes=recon_bytes,
                             reconstruction_read_bytes=src_bytes)

    def _scatter(self, chunks: dict[int, np.ndarray], subs, views):
        c = self.meta.chunk
        for off, ln, i, dst in subs:
            for r in range(off // c, (off + ln - 1) // c + 1):
                blk = chunks[r]
                lo = max(off - r * c, 0)
                hi = min(off + ln - r * c, c)
                views[i][dst + (r * c + lo - off):
                         dst + (r * c + hi - off)] = memoryview(blk[lo:hi])

    def read_all(self) -> bytes:
        return self.pread(0, self.meta.size)


def write_striped(hdfs: HdfsCluster, path: str, data: bytes, *,
                  width: int = 8, chunk: int = CHUNK, stripe: int = STRIPE,
                  placement: Placement | str | None = None):
    with StripedWriter(hdfs, path, width=width, chunk=chunk,
                       stripe=stripe, placement=placement) as w:
        w.write(data)
