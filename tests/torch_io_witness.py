"""A test-side I/O witness for the port: every byte read through the
port's ``HdfsCluster`` (``pread`` and the raw group-file handles of
striped files) and through its ``Registry`` (image blocks), and every
byte written whole through ``HdfsCluster.write`` (the tuning profiles'
blobs and HEAD), is attributed to the scheduler slot its thread holds at
the time, by resource and priority. The JAX package's ``--io-witness`` patches only the reference's
classes, so the port's tests install this one (``install(monkeypatch)``).
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

from repro_torch.blockstore.registry import Registry
from repro_torch.core.pipeline import CRITICAL, DEFERRED, IOScheduler
from repro_torch.dfs.hdfs import HdfsCluster


class IoWitness:
    """``read`` holds the DFS bytes by the priority of the "dfs" slot held
    while they were read (None: outside any "dfs" slot); ``written`` the
    bytes of whole-file DFS writes likewise; ``registry`` the image-block
    bytes by the "registry" slot's priority."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.read = {}          # priority or None -> bytes
        self.written = {}       # priority or None -> bytes
        self.registry = {}      # priority or None -> bytes

    def held(self, resource: str = "dfs"):
        for res, priority in reversed(getattr(self.local, "stack", [])):
            if res == resource:
                return priority
        return None

    def count(self, nbytes: int, resource: str = "dfs", ledger=None):
        if ledger is None:
            ledger = self.read if resource == "dfs" else self.registry
        with self.lock:
            key = self.held(resource)
            ledger[key] = ledger.get(key, 0) + nbytes

    def check(self, critical: int, deferred: int):
        """Every DFS byte read inside a dfs slot, at the stated
        priorities."""
        assert self.read.get(None, 0) == 0, (
            f"{self.read[None]} bytes read outside any dfs slot")
        want = {p: n for p, n in ((CRITICAL, critical), (DEFERRED, deferred))
                if n}
        assert self.read == want, self.read

    def check_scheduler(self, sched: IOScheduler, *, writes: bool = False):
        """Every DFS and registry byte read inside a slot of its resource,
        and the bytes by priority equal to what ``sched`` metered; with
        ``writes``, the DFS bytes written whole as well, metered with the
        reads (a ``ProfileStore`` meters its publish in the same slots)."""
        snap = sched.snapshot()
        names = {CRITICAL: "critical", DEFERRED: "deferred"}
        dfs = dict(self.read)
        if writes:
            for p, n in self.written.items():
                dfs[p] = dfs.get(p, 0) + n
        for resource, ledger in (("dfs", dfs),
                                 ("registry", self.registry)):
            assert ledger.get(None, 0) == 0, (
                f"{ledger[None]} {resource} bytes read outside any "
                f"{resource} slot")
            metered = snap.get(resource, {}).get("bytes", {})
            assert {names[p]: n for p, n in ledger.items() if n} == {
                k: n for k, n in metered.items() if n}, (resource, ledger,
                                                         metered)


class _Handle:
    def __init__(self, f, witness):
        self._f, self._w = f, witness

    def read(self, *args):
        data = self._f.read(*args)
        self._w.count(len(data))
        return data

    def readinto(self, buf):
        n = self._f.readinto(buf)
        self._w.count(int(n or 0))
        return n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()

    def __getattr__(self, name):
        return getattr(self._f, name)


def install(monkeypatch) -> IoWitness:
    w = IoWitness()
    real_slot = IOScheduler.slot
    real_pread = HdfsCluster.pread
    real_open = HdfsCluster.open_group_file
    real_get_block = Registry.get_block
    real_write = HdfsCluster.write

    @contextmanager
    def slot(self, resource, *, priority=CRITICAL, nbytes=0):
        with real_slot(self, resource, priority=priority, nbytes=nbytes):
            stack = w.local.__dict__.setdefault("stack", [])
            stack.append((resource, priority))
            try:
                yield
            finally:
                stack.pop()

    def pread(self, path, offset, length):
        data = real_pread(self, path, offset, length)
        w.count(len(data))
        return data

    def open_group_file(self, group, name, mode="rb"):
        f = real_open(self, group, name, mode)
        return _Handle(f, w) if "r" in mode else f

    def write(self, path, data, attrs=None):
        out = real_write(self, path, data, attrs)
        w.count(len(data), ledger=w.written)
        return out

    def get_block(self, h):
        data = real_get_block(self, h)
        w.count(len(data), "registry")
        return data

    monkeypatch.setattr(IOScheduler, "slot", slot)
    monkeypatch.setattr(HdfsCluster, "pread", pread)
    monkeypatch.setattr(HdfsCluster, "open_group_file", open_group_file)
    monkeypatch.setattr(HdfsCluster, "write", write)
    monkeypatch.setattr(Registry, "get_block", get_block)
    return w
