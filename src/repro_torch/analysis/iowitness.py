"""Runtime I/O witness — the dynamic half of the I/O-discipline lint,
the port of the JAX package's.

:func:`install` wraps the port's DFS layer and ``IOScheduler``
(``repro_torch.dfs.hdfs.HdfsCluster``,
``repro_torch.core.pipeline.IOScheduler``):

* every byte that physically moves through ``HdfsCluster`` — ``pread``,
  ``write``, and raw ``open_group_file`` handles (the striped layouts'
  path) — is counted as *observed*;
* every byte billed through ``account_read`` / ``account_write`` is
  counted as *accounted*, on the witness's own monotonic counters (so a
  test calling ``reset_counters()`` can't hide a gap);
* every ``IOScheduler.slot`` acquisition records (resource, priority,
  enqueue seq, grant seq, wall times), so priority inversions that
  actually happened — a CRITICAL request enqueued before a DEFERRED one
  yet granted after it, having genuinely waited — are detected from the
  grant order.

At session end :func:`reconcile` compares the ledgers: observed bytes
that never reached the accounting counters mean some reader bypasses
``HdfsCluster`` accounting (exactly the bug class the static
``io-accounting-gap`` checker hunts, but proven at runtime), and any
observed inversion means the scheduler's strict priority-then-FIFO
contract broke.  Read sites are joined back to static ``FunctionInfo``
identities from the AST call graph, so a runtime gap names the
function that moved the bytes.

The inversion detector requires the better-priority request to have
waited at least ``MIN_INVERSION_WAIT_S`` on the pool: enqueue/grant
seqs are stamped in the wrapper (just outside the pool's own lock), so
a thread descheduled for a few microseconds between stamp and heappush
could otherwise masquerade as an inversion.  Real inversions hold
tokens across I/O and wait orders of magnitude longer.
"""

from __future__ import annotations

import sys
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

MIN_INVERSION_WAIT_S = 0.005
PREFIX = "src/repro_torch/"

_REAL: dict = {}
RECORDER: Optional["Recorder"] = None

_PRIORITY_NAMES = {0: "critical", 1: "elevated", 2: "deferred"}


def _prio_name(p: int) -> str:
    return _PRIORITY_NAMES.get(p, str(p))


def _caller_site() -> Optional[Tuple[str, int]]:
    """Nearest ``src/repro_torch`` frame that is neither this module nor
    the wrapped DFS module — the function that asked for the bytes."""
    f = sys._getframe(1)
    for _ in range(14):
        if f is None:
            break
        fn = f.f_code.co_filename.replace("\\", "/")
        if PREFIX in fn and not fn.endswith("analysis/iowitness.py") \
                and not fn.endswith("dfs/hdfs.py"):
            idx = fn.rindex(PREFIX)
            return fn[idx:], f.f_lineno
        f = f.f_back
    return None


class Recorder:
    """Byte ledgers + slot grant log, all under one lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.observed_read = 0
        self.observed_write = 0
        self.accounted_read = 0
        self.accounted_write = 0
        # scheduler-metered bytes per priority name (slot nbytes= +
        # post-hoc account()), for the report, in all and by resource
        self.sched_bytes: Dict[str, int] = {}
        self.sched_bytes_by_resource: Dict[str, Dict[str, int]] = {}
        self.grants: List[dict] = []
        self.read_sites: Dict[Tuple[str, int], int] = {}
        self._seq = 0

    # -- events ---------------------------------------------------------

    def next_seq(self) -> int:
        with self.lock:
            self._seq += 1
            return self._seq

    def on_read(self, nbytes: int, site: Optional[Tuple[str, int]]):
        with self.lock:
            self.observed_read += nbytes
            if site is not None and nbytes:
                self.read_sites[site] = \
                    self.read_sites.get(site, 0) + nbytes

    def on_write(self, nbytes: int):
        with self.lock:
            self.observed_write += nbytes

    def on_accounted_read(self, nbytes: int):
        with self.lock:
            self.accounted_read += int(nbytes)

    def on_accounted_write(self, nbytes: int):
        with self.lock:
            self.accounted_write += int(nbytes)

    def on_sched_bytes(self, priority: int, nbytes: int,
                       resource: Optional[str] = None):
        with self.lock:
            name = _prio_name(priority)
            self.sched_bytes[name] = \
                self.sched_bytes.get(name, 0) + int(nbytes)
            if resource is not None:
                res = self.sched_bytes_by_resource.setdefault(resource, {})
                res[name] = res.get(name, 0) + int(nbytes)

    def on_grant(self, resource: str, priority: int, enq_seq: int,
                 enq_t: float, site: Optional[Tuple[str, int]]):
        with self.lock:
            self._seq += 1
            self.grants.append({
                "resource": resource, "priority": priority,
                "enq_seq": enq_seq, "grant_seq": self._seq,
                "enq_t": enq_t, "grant_t": time.monotonic(),
                "site": site})


class _CountingHandle:
    """Wraps a raw group-file handle, counting moved bytes."""

    def __init__(self, f, rec: Recorder, site):
        self._f = f
        self._rec = rec
        self._site = site

    def read(self, *args):
        data = self._f.read(*args)
        self._rec.on_read(len(data), self._site)
        return data

    def readinto(self, buf):
        n = self._f.readinto(buf)
        self._rec.on_read(int(n or 0), self._site)
        return n

    def write(self, data):
        n = self._f.write(data)
        self._rec.on_write(len(data))
        return n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._f.close()

    def __getattr__(self, name):
        return getattr(self._f, name)


def install() -> Recorder:
    """Monkeypatch the DFS layer + IOScheduler.  Idempotent."""
    global RECORDER
    if _REAL:
        return RECORDER
    from repro_torch.core.pipeline import IOScheduler
    from repro_torch.dfs.hdfs import HdfsCluster

    rec = Recorder()
    RECORDER = rec

    _REAL["pread"] = real_pread = HdfsCluster.pread
    _REAL["write"] = real_write = HdfsCluster.write
    _REAL["open_group_file"] = real_ogf = HdfsCluster.open_group_file
    _REAL["account_read"] = real_ar = HdfsCluster.account_read
    _REAL["account_write"] = real_aw = HdfsCluster.account_write
    _REAL["slot"] = real_slot = IOScheduler.slot
    _REAL["account"] = real_account = IOScheduler.account

    def pread(self, path, offset, length):
        data = real_pread(self, path, offset, length)
        rec.on_read(len(data), _caller_site())
        return data

    def write(self, path, data, attrs=None):
        out = real_write(self, path, data, attrs)
        rec.on_write(len(data))
        return out

    def open_group_file(self, group, name, mode="rb"):
        return _CountingHandle(real_ogf(self, group, name, mode),
                               rec, _caller_site())

    def account_read(self, nbytes):
        rec.on_accounted_read(nbytes)
        return real_ar(self, nbytes)

    def account_write(self, nbytes):
        rec.on_accounted_write(nbytes)
        return real_aw(self, nbytes)

    @contextmanager
    def slot(self, resource, *, priority=0, nbytes=0):
        site = _caller_site()
        enq_t = time.monotonic()
        enq_seq = rec.next_seq()
        with real_slot(self, resource, priority=priority, nbytes=nbytes):
            rec.on_grant(resource, priority, enq_seq, enq_t, site)
            rec.on_sched_bytes(priority, nbytes, resource)
            yield

    def account(self, resource, priority, nbytes):
        rec.on_sched_bytes(priority, nbytes, resource)
        return real_account(self, resource, priority, nbytes)

    HdfsCluster.pread = pread
    HdfsCluster.write = write
    HdfsCluster.open_group_file = open_group_file
    HdfsCluster.account_read = account_read
    HdfsCluster.account_write = account_write
    IOScheduler.slot = slot
    IOScheduler.account = account
    return rec


def uninstall():
    if not _REAL:
        return
    from repro_torch.core.pipeline import IOScheduler
    from repro_torch.dfs.hdfs import HdfsCluster
    HdfsCluster.pread = _REAL["pread"]
    HdfsCluster.write = _REAL["write"]
    HdfsCluster.open_group_file = _REAL["open_group_file"]
    HdfsCluster.account_read = _REAL["account_read"]
    HdfsCluster.account_write = _REAL["account_write"]
    IOScheduler.slot = _REAL["slot"]
    IOScheduler.account = _REAL["account"]
    _REAL.clear()


# ---------------------------------------------------------------------------
# reconciliation
# ---------------------------------------------------------------------------


def find_inversions(grants: List[dict],
                    min_wait_s: float = MIN_INVERSION_WAIT_S
                    ) -> List[dict]:
    """Observed priority inversions in a slot grant log.

    An inversion: on one resource, a better-priority request (lower
    int) enqueued BEFORE a worse-priority one was granted AFTER it —
    and genuinely waited (``grant_t - enq_t >= min_wait_s``), ruling
    out stamp-to-heappush scheduling races."""
    out: List[dict] = []
    by_res: Dict[str, List[dict]] = {}
    for g in grants:
        by_res.setdefault(g["resource"], []).append(g)
    for res, evs in sorted(by_res.items()):
        evs = sorted(evs, key=lambda g: g["grant_seq"])
        # priority -> max enqueue seq already granted
        max_enq: Dict[int, int] = {}
        for g in evs:
            waited = g["grant_t"] - g["enq_t"]
            for worse, enq in max_enq.items():
                if worse > g["priority"] and enq > g["enq_seq"] \
                        and waited >= min_wait_s:
                    out.append({
                        "resource": res,
                        "priority": _prio_name(g["priority"]),
                        "behind": _prio_name(worse),
                        "waited_s": round(waited, 4),
                        "site": g.get("site")})
                    break
            if g["enq_seq"] > max_enq.get(g["priority"], -1):
                max_enq[g["priority"]] = g["enq_seq"]
    return out


def site_functions(sites, root: Optional[str] = None
                   ) -> Dict[Tuple[str, int], str]:
    """Join runtime (file, line) sites to static function qualnames via
    the AST package table (innermost enclosing function wins)."""
    from pathlib import Path

    from repro_torch.analysis.callgraph import Package
    if root is None:
        root = str(Path(__file__).resolve().parents[1])   # src/repro_torch
    pkg = Package.load([Path(root)])
    out: Dict[Tuple[str, int], str] = {}
    for site in sites:
        file, line = site
        best, best_start = None, -1
        for qual, info in pkg.functions.items():
            if not file.endswith(info.file) and not info.file.endswith(file):
                continue
            node = info.node
            end = getattr(node, "end_lineno", node.lineno)
            if node.lineno <= line <= end and node.lineno > best_start:
                best, best_start = qual, node.lineno
        if best is not None:
            out[site] = best
    return out


def reconcile(recorder: Optional[Recorder] = None,
              join_static: bool = True) -> dict:
    """Compare the ledgers; returns a report dict.

    ``ok`` is False when bytes moved that accounting never saw, or when
    an inversion was observed."""
    rec = recorder if recorder is not None else RECORDER
    if rec is None:
        return {"ok": True, "enabled": False}
    with rec.lock:
        observed_read = rec.observed_read
        observed_write = rec.observed_write
        accounted_read = rec.accounted_read
        accounted_write = rec.accounted_write
        sched_bytes = dict(rec.sched_bytes)
        by_resource = {r: dict(v)
                       for r, v in rec.sched_bytes_by_resource.items()}
        grants = list(rec.grants)
        read_sites = dict(rec.read_sites)
    unaccounted_read = max(0, observed_read - accounted_read)
    unaccounted_write = max(0, observed_write - accounted_write)
    inversions = find_inversions(grants)
    top_sites = sorted(read_sites.items(), key=lambda kv: -kv[1])[:5]
    site_info = [{"file": s[0], "line": s[1], "bytes": n}
                 for s, n in top_sites]
    if join_static and (unaccounted_read or unaccounted_write
                        or inversions):
        joined = site_functions([(d["file"], d["line"])
                                 for d in site_info])
        for d in site_info:
            d["function"] = joined.get((d["file"], d["line"]), "?")
        for inv in inversions:
            if inv.get("site"):
                j = site_functions([tuple(inv["site"])])
                inv["function"] = j.get(tuple(inv["site"]), "?")
    return {
        "ok": not (unaccounted_read or unaccounted_write or inversions),
        "enabled": True,
        "observed_read": observed_read,
        "observed_write": observed_write,
        "accounted_read": accounted_read,
        "accounted_write": accounted_write,
        "unaccounted_read": unaccounted_read,
        "unaccounted_write": unaccounted_write,
        "sched_bytes": sched_bytes,
        "sched_bytes_by_resource": by_resource,
        "slot_grants": len(grants),
        "inversions": inversions,
        "top_read_sites": site_info,
    }
