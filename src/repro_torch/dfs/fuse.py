"""HDFS-FUSE: a file-like mounted view of the DFS.

The paper mounts remote HDFS directories into worker containers via a FUSE
sidecar; kernel mounts are unavailable in this sandbox, so the "mount" is an
object exposing ``open(path)`` -> file-like handles.  Striped files
transparently get the parallel reader.

A mount may carry an ``IOScheduler`` (``sched=``): every pread — striped
or plain — then runs under a "dfs" slot token at the mount's default
``priority``, overridable per read.  Leave ``sched`` unset when a higher
layer already meters the reads (e.g. ``EnvCache`` passes its own
scheduler) — nesting two "dfs" slot acquisitions on one thread would
double-count and risk token starvation.
"""

from __future__ import annotations

import io
from typing import Optional

from repro_torch.dfs.hdfs import HdfsCluster
from repro_torch.dfs.striped import StripedReader


class HdfsFuseFile:
    """Read-only file handle with read/seek/pread over a DFS file."""

    def __init__(self, mount: "HdfsFuseMount", path: str):
        self._mount = mount
        self.path = path
        self._pos = 0
        meta = mount.hdfs.attrs(path)
        if "striped" in meta:
            self._reader: Optional[StripedReader] = StripedReader(
                mount.hdfs, path, sched=mount.sched,
                priority=mount.priority)
            self._size = self._reader.size
        else:
            self._reader = None
            self._size = mount.hdfs.size(path)

    def __len__(self):
        return self._size

    def seek(self, pos: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            self._pos = pos
        elif whence == io.SEEK_CUR:
            self._pos += pos
        else:
            self._pos = self._size + pos
        return self._pos

    def tell(self) -> int:
        return self._pos

    def pread(self, offset: int, length: int, priority=None) -> bytes:
        """Single positional read.  Delegates to ``pread_many`` so the
        scheduling class survives — ``pread`` used to drop it while its
        batched sibling forwarded it, and single-range callers silently
        lost their priority."""
        return self.pread_many([(offset, length)], priority=priority)[0]

    def pread_many(self, ranges, into=None, priority=None):
        """Batched ranged reads (see ``StripedReader.pread_many``).  Plain
        files fall back to per-range preads with the same return contract,
        metered under the mount's scheduler when it has one."""
        if self._reader is not None:
            return self._reader.pread_many(ranges, into=into,
                                           priority=priority)
        from repro_torch.dfs.striped import pread_many_fallback
        sched = self._mount.sched
        if sched is None:
            return pread_many_fallback(self._pread_raw, ranges, into=into)
        prio = self._mount.priority if priority is None else priority
        nbytes = sum(max(0, ln) for _, ln in ranges)
        with sched.slot("dfs", priority=prio, nbytes=nbytes):
            return pread_many_fallback(self._pread_raw, ranges, into=into)

    def _pread_raw(self, offset: int, length: int) -> bytes:
        return self._mount.hdfs.pread(self.path, offset, length)

    def read(self, length: int = -1) -> bytes:
        if length < 0:
            length = self._size - self._pos
        data = self.pread(self._pos, length)
        self._pos += len(data)
        return data

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


class HdfsFuseMount:
    """The 'mounted directory': open() remote paths as local file objects."""

    def __init__(self, hdfs: HdfsCluster, prefix: str = "", *,
                 sched=None, priority: int = 0):
        self.hdfs = hdfs
        self.prefix = prefix.rstrip("/")
        self.sched = sched
        self.priority = priority

    def _full(self, path: str) -> str:
        return f"{self.prefix}/{path.lstrip('/')}" if self.prefix else path

    def open(self, path: str) -> HdfsFuseFile:
        return HdfsFuseFile(self, self._full(path))

    def exists(self, path: str) -> bool:
        return self.hdfs.exists(self._full(path))

    def listdir(self, path: str = "") -> list[str]:
        return self.hdfs.listdir(self._full(path) if path else self.prefix)

    def write(self, path: str, data: bytes, striped: bool = False,
              width: int = 8, placement=None):
        """``placement``: optional repro_torch.fabric.placement.Placement (or
        kind string) for striped writes — replicated/erasure durability."""
        full = self._full(path)
        if striped:
            from repro_torch.dfs.striped import write_striped
            write_striped(self.hdfs, full, data, width=width,
                          placement=placement)
        else:
            self.hdfs.write(full, data)
