"""A userspace distributed-filesystem model over real directories.

Mirrors the HDFS structure the paper describes (§4.4): a NameNode holding
file -> block metadata, and DataNode *replication groups* holding the block
data.  In the original layout, a file is written as sequential large blocks
(512 MB by default) and **each block lives inside a single group**, so reads
of one block are served by one group — this is the I/O-parallelism limit the
striped layout (repro_torch.dfs.striped) removes.

Real files + real threads; an optional ``ThrottleModel`` adds deterministic
service delay so laptop-scale benchmarks expose the same contention shapes as
the production measurements (tests run with no throttle).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

DEFAULT_BLOCK = 512 * 1024 * 1024


class ThrottleModel:
    """Deterministic shared-bandwidth delay model.

    ``bandwidth`` bytes/s shared among concurrent readers of one source;
    ``per_stream`` caps a single sequential stream (the reason parallel
    striped reads and multi-threaded prefetch beat serial faulting);
    above ``throttle_after`` concurrent requests the source rate-limits by
    ``throttle_factor`` (the paper's SCM/registry behaviour, §3.4).
    ``timescale`` shrinks wall-clock sleeps so tests stay fast.
    """

    def __init__(self, bandwidth: float = 1e9, throttle_after: int = 64,
                 throttle_factor: float = 4.0, timescale: float = 1e-3,
                 per_stream: float = float("inf")):
        self.bandwidth = bandwidth
        self.per_stream = per_stream
        self.throttle_after = throttle_after
        self.throttle_factor = throttle_factor
        self.timescale = timescale
        self._lock = threading.Lock()
        self._active = 0
        self.served_bytes = 0
        self.max_concurrency = 0

    def __enter__(self):
        with self._lock:
            self._active += 1
            self.max_concurrency = max(self.max_concurrency, self._active)
        return self

    def __exit__(self, *exc):
        with self._lock:
            self._active -= 1

    def delay(self, nbytes: int) -> float:
        with self._lock:
            k = max(self._active, 1)
            self.served_bytes += nbytes
        rate = min(self.bandwidth / k, self.per_stream)
        if k > self.throttle_after:
            rate /= self.throttle_factor
        return nbytes / rate * self.timescale

    def charge(self, nbytes: int):
        time.sleep(self.delay(nbytes))


@dataclass
class BlockMeta:
    group: int
    path: str          # path within the group dir
    length: int


@dataclass
class FileMeta:
    size: int
    block_size: int
    blocks: list = field(default_factory=list)  # list[BlockMeta]
    attrs: dict = field(default_factory=dict)


class HdfsCluster:
    """NameNode metadata + DataNode-group directories."""

    def __init__(self, root: str | Path, num_groups: int = 8,
                 block_size: int = DEFAULT_BLOCK,
                 throttle: Optional[ThrottleModel] = None,
                 num_regions: int = 1):
        self.root = Path(root)
        self.num_groups = num_groups
        self.block_size = block_size
        self.throttle = throttle
        # region tier over the DataNode groups: contiguous runs of
        # num_groups // num_regions groups form one region each (the
        # remainder folds into the last region).  Region-spread
        # replicated placement (repro_torch.fabric.placement) uses this to put
        # each mirror a whole region away from its data file.
        if not 1 <= num_regions <= num_groups:
            raise ValueError(
                f"num_regions must be in [1, num_groups={num_groups}], "
                f"got {num_regions}")
        self.num_regions = num_regions
        self._meta: dict[str, FileMeta] = {}
        self._lock = threading.Lock()
        self._counter = 0
        # deterministic byte accounting (always on, unlike the optional
        # throttle): every DataNode read/write lands here, including the
        # per-group files behind striped layouts.  The perf-regression
        # tests assert on these counters instead of wall clock.
        self.read_bytes = 0
        self.write_bytes = 0
        # storage-fabric degraded-mode counters (see repro_torch.dfs.striped):
        # aggregated cluster-wide so the runtime can report per-run deltas
        # without holding every short-lived reader
        self.fabric_stats = {"degraded_reads": 0, "reconstructed_bytes": 0,
                             "reconstruction_read_bytes": 0,
                             "corrupt_chunks": 0,
                             # restore-ahead prefetch (repro_torch.core.bootseer):
                             # checkpoint bytes staged into / served from
                             # node caches instead of DFS preads
                             "restore_ahead_prefetch_bytes": 0,
                             "restore_ahead_hit_bytes": 0}
        for g in range(num_groups):
            (self.root / f"group{g:02d}").mkdir(parents=True, exist_ok=True)
        self._meta_path = self.root / "namenode.json"
        if self._meta_path.exists():
            self._load_meta()

    # ----- namenode persistence -----

    def refresh(self):
        """Reload the namenode's metadata from disk: the files another
        process (another rank of a mesh) wrote since this one loaded it."""
        with self._lock:
            if self._meta_path.exists():
                self._load_meta()

    def _load_meta(self):
        raw = json.loads(self._meta_path.read_text())
        self._counter = raw.get("counter", 0)
        self._meta = {
            p: FileMeta(size=m["size"], block_size=m["block_size"],
                        blocks=[BlockMeta(**b) for b in m["blocks"]],
                        attrs=m.get("attrs", {}))
            for p, m in raw["files"].items()}

    def _save_meta(self):
        raw = {"counter": self._counter, "files": {
            p: {"size": m.size, "block_size": m.block_size,
                "blocks": [vars(b) for b in m.blocks], "attrs": m.attrs}
            for p, m in self._meta.items()}}
        tmp = self._meta_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(raw))
        tmp.replace(self._meta_path)

    # ----- block placement -----

    def _alloc_block(self, logical_path: str, idx: int) -> tuple[int, Path]:
        with self._lock:
            self._counter += 1
            n = self._counter
        import zlib
        group = (zlib.crc32(logical_path.encode()) + idx) % self.num_groups
        rel = f"blk_{n:08d}"
        return group, self.root / f"group{group:02d}" / rel

    def _block_file(self, bm: BlockMeta) -> Path:
        return self.root / f"group{bm.group:02d}" / bm.path

    def group_region(self, group: int) -> int:
        """The region index a DataNode group belongs to (contiguous
        partition; the remainder groups fold into the last region)."""
        gpr = max(self.num_groups // self.num_regions, 1)
        return min(group // gpr, self.num_regions - 1)

    def region_stride(self) -> int:
        """Groups per region — the offset that moves a placement one
        whole region over."""
        return max(self.num_groups // self.num_regions, 1)

    # ----- byte accounting -----

    def account_read(self, nbytes: int):
        with self._lock:
            self.read_bytes += int(nbytes)

    def account_write(self, nbytes: int):
        with self._lock:
            self.write_bytes += int(nbytes)

    def account_fabric(self, **counters: int):
        with self._lock:
            for key, n in counters.items():
                self.fabric_stats[key] = self.fabric_stats.get(key, 0) + n

    def reset_counters(self):
        with self._lock:
            self.read_bytes = 0
            self.write_bytes = 0

    # ----- public API -----

    def exists(self, path: str) -> bool:
        return path in self._meta

    def listdir(self, prefix: str) -> list[str]:
        prefix = prefix.rstrip("/") + "/"
        return sorted(p for p in self._meta if p.startswith(prefix))

    def delete(self, path: str):
        meta = self._meta.pop(path, None)
        if meta:
            for bm in meta.blocks:
                self._block_file(bm).unlink(missing_ok=True)
            self._save_meta()

    def size(self, path: str) -> int:
        return self._meta[path].size

    def write(self, path: str, data: bytes, attrs: Optional[dict] = None):
        """Write a file as sequential blocks (original HDFS layout)."""
        meta = FileMeta(size=len(data), block_size=self.block_size,
                        attrs=attrs or {})
        for idx in range(0, max(1, -(-len(data) // self.block_size))):
            lo = idx * self.block_size
            chunk = data[lo:lo + self.block_size]
            group, blk_path = self._alloc_block(path, idx)
            blk_path.write_bytes(chunk)
            meta.blocks.append(BlockMeta(group=group, path=blk_path.name,
                                         length=len(chunk)))
            self.account_write(len(chunk))
            if self.throttle:
                with self.throttle:
                    self.throttle.charge(len(chunk))
        with self._lock:
            self._meta[path] = meta
            self._save_meta()

    def read(self, path: str) -> bytes:
        return self.pread(path, 0, self._meta[path].size)

    def pread(self, path: str, offset: int, length: int) -> bytes:
        """Positional read.  In the original layout this walks blocks
        SEQUENTIALLY (each block lives in one group) — the baseline the
        paper's striping beats."""
        meta = self._meta[path]
        length = min(length, meta.size - offset)
        if length <= 0:
            return b""
        out = bytearray()
        bs = meta.block_size
        first = offset // bs
        last = (offset + length - 1) // bs
        for idx in range(first, last + 1):
            bm = meta.blocks[idx]
            lo = max(offset - idx * bs, 0)
            hi = min(offset + length - idx * bs, bm.length)
            with open(self._block_file(bm), "rb") as f:
                f.seek(lo)
                data = f.read(hi - lo)
            self.account_read(len(data))
            if self.throttle:
                with self.throttle:
                    self.throttle.charge(len(data))
            out += data
        return bytes(out)

    def attrs(self, path: str) -> dict:
        return self._meta[path].attrs

    # striped files need raw per-group file handles
    def open_group_file(self, group: int, name: str, mode: str = "rb"):
        return open(self.root / f"group{group:02d}" / name, mode)

    def register_raw(self, path: str, size: int, blocks: list[BlockMeta],
                     attrs: Optional[dict] = None,
                     block_size: Optional[int] = None):
        """Register an externally-written (e.g. striped) physical layout."""
        with self._lock:
            self._meta[path] = FileMeta(
                size=size, block_size=block_size or self.block_size,
                blocks=blocks, attrs=attrs or {})
            self._save_meta()
