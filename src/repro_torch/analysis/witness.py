"""Runtime lock witness, the port of the JAX package's: observe REAL
acquisition orders during tests and witnessed boots.

:func:`install` monkeypatches ``threading.Lock`` / ``RLock`` /
``Condition`` / ``Semaphore`` with recording wrappers — but only for
locks **constructed from the port's source** (the factory inspects the
caller frame; stdlib internals like ``threading.Event`` or
``queue.Queue`` keep real primitives, so nothing outside
``src/repro_torch`` changes behavior). Module-level locks are built at
import, so install it before importing anything of the port.  Each wrapper remembers its construction site ``(file,
line)`` — the same key :class:`repro_torch.analysis.locks.LockDef` records —
so observed edges join back onto static lock identities.

Per-thread held stacks turn every successful acquire into digraph edges
``already-held -> acquired``.  At session end (:func:`cross_check`):

* **observed cycles** are hard failures — two real executions took the
  same locks in opposite orders;
* **observed edges missing statically** mean the static extractor has a
  blind spot (dynamic dispatch the call-graph heuristics can't see);
* **static edges never observed** are *possibly stale* — dead code or a
  path the tier-1 tests don't reach.  Warnings, not failures: coverage,
  not correctness.

Two distinct locks from the SAME construction site (per-key container
locks, per-shard stripes) nesting inside each other are reported
separately as ``same_site_nesting``: at site granularity neither side
can prove an ordering discipline, so it's a warning rather than a
cycle.  Reentrant re-acquire of one object (RLocks) records nothing.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

_REAL = {name: getattr(threading, name)
         for name in ("Lock", "RLock", "Condition", "Semaphore",
                      "BoundedSemaphore")}

Site = Tuple[str, int]          # ("src/repro_torch/fabric/cache.py", 123)

PREFIX = "src/repro_torch/"


def _caller_site(depth: int = 2) -> Optional[Site]:
    f = sys._getframe(depth)
    fname = f.f_code.co_filename.replace(os.sep, "/")
    i = fname.rfind(PREFIX)
    if i < 0:
        return None
    site_file = fname[i:]
    # the analysis package is the instrumentation, not the startup
    # stack under verification (the lint likewise excludes it): the
    # io-witness Recorder's own lock must not show up as an edge
    if site_file.startswith(PREFIX + "analysis/"):
        return None
    return (site_file, f.f_lineno)


class Recorder:
    def __init__(self):
        self._mu = _REAL["Lock"]()
        self._tl = threading.local()
        self.edges: Dict[Tuple[Site, Site], int] = {}
        self.same_site_nesting: Set[Site] = set()
        self.sites_seen: Set[Site] = set()

    def _stack(self) -> List[Tuple[Site, int]]:
        st = getattr(self._tl, "stack", None)
        if st is None:
            st = self._tl.stack = []
        return st

    def on_acquire(self, site: Site, obj_id: int):
        st = self._stack()
        with self._mu:
            self.sites_seen.add(site)
            for held_site, held_id in st:
                if held_id == obj_id:
                    continue        # reentrant re-acquire of one object
                if held_site == site:
                    self.same_site_nesting.add(site)
                    continue
                key = (held_site, site)
                self.edges[key] = self.edges.get(key, 0) + 1
        st.append((site, obj_id))

    def on_release(self, site: Site, obj_id: int):
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i] == (site, obj_id):
                del st[i]
                break


RECORDER: Optional[Recorder] = None


class _Witnessed:
    """Shared acquire/release recording around a real primitive."""

    __slots__ = ("_real", "_site")

    def __init__(self, real, site: Site):
        self._real = real
        self._site = site

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._real.acquire(blocking, timeout)
        if got and RECORDER is not None:
            RECORDER.on_acquire(self._site, id(self))
        return got

    def release(self):
        self._real.release()
        if RECORDER is not None:
            RECORDER.on_release(self._site, id(self))

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._real.locked()


class WitnessLock(_Witnessed):
    pass


class WitnessRLock(_Witnessed):
    pass


class WitnessSemaphore(_Witnessed):
    def acquire(self, blocking: bool = True, timeout: Optional[float] = None):
        got = self._real.acquire(blocking, timeout)
        if got and RECORDER is not None:
            RECORDER.on_acquire(self._site, id(self))
        return got


class WitnessCondition(_Witnessed):
    # wait/notify delegate; the lock stays on the held stack across
    # wait() — the thread is blocked, so it can't record anything
    # misordered meanwhile, and it re-acquires before returning
    def wait(self, timeout: Optional[float] = None):
        return self._real.wait(timeout)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        return self._real.wait_for(predicate, timeout)

    def notify(self, n: int = 1):
        self._real.notify(n)

    def notify_all(self):
        self._real.notify_all()


def _unwrap(lock):
    return lock._real if isinstance(lock, _Witnessed) else lock


def _make_factory(name: str, wrapper):
    real_ctor = _REAL[name]

    def factory(*args, **kwargs):
        site = _caller_site()
        if name == "Condition" and args:
            args = (_unwrap(args[0]),) + args[1:]
        real = real_ctor(*args, **kwargs)
        if site is None:
            return real
        return wrapper(real, site)

    factory.__name__ = name
    return factory


def install():
    """Patch ``threading``'s lock constructors with witnessing ones and
    start a fresh :data:`RECORDER`."""
    global RECORDER
    RECORDER = Recorder()
    threading.Lock = _make_factory("Lock", WitnessLock)
    threading.RLock = _make_factory("RLock", WitnessRLock)
    threading.Condition = _make_factory("Condition", WitnessCondition)
    threading.Semaphore = _make_factory("Semaphore", WitnessSemaphore)
    threading.BoundedSemaphore = _make_factory("BoundedSemaphore",
                                               WitnessSemaphore)


def uninstall():
    for name, real in _REAL.items():
        setattr(threading, name, real)


def cross_check(recorder: Optional[Recorder] = None,
                roots: Optional[list] = None) -> dict:
    """Join observed edges onto static identities and diff the graphs.

    Returns ``{"cycles", "observed_edges", "static_gap", "possibly_stale",
    "same_site_nesting"}`` — cycles non-empty means a real deadlock risk
    was *executed*.
    """
    from repro_torch.analysis.cli import run_analysis
    from repro_torch.analysis.lockorder import scc_cycles

    rec = recorder if recorder is not None else RECORDER
    if rec is None:
        raise RuntimeError("lock witness was never installed")
    rep = run_analysis(roots=roots)
    site_to_ident = {(d.file, d.line): ident
                     for ident, d in rep.table.defs.items()}

    def ident_of(site: Site) -> str:
        return site_to_ident.get(site, f"{site[0]}:{site[1]}")

    observed = {(ident_of(a), ident_of(b)) for a, b in rec.edges}
    static = rep.graph.pairs()
    return {
        "cycles": scc_cycles(observed),
        "observed_edges": sorted(f"{a} -> {b}" for a, b in observed),
        # observed but not predicted: static blind spot worth closing
        "static_gap": sorted(f"{a} -> {b}" for a, b in observed - static),
        # predicted but never seen: untested path or stale analysis
        "possibly_stale": sorted(f"{a} -> {b}" for a, b in static - observed),
        "same_site_nesting": sorted(
            f"{ident_of(s)} ({s[0]}:{s[1]})"
            for s in rec.same_site_nesting),
        "locks_witnessed": len(rec.sites_seen),
    }


def report_lines(locks: dict, io: dict) -> List[str]:
    """What both witnesses saw, one fact a line: the lock witness's
    :func:`cross_check` report and the I/O witness's reconcile."""
    out = [f"locks witnessed {locks['locks_witnessed']}, observed edges "
           f"{len(locks['observed_edges'])}, cycles {len(locks['cycles'])}"]
    out += [f"observed edge {e}" for e in locks["observed_edges"]]
    out += [f"static gap (observed, not predicted): {e}"
            for e in locks["static_gap"]]
    out += [f"possibly stale (predicted, never observed): {e}"
            for e in locks["possibly_stale"]]
    out += [f"same-site nesting: {s}" for s in locks["same_site_nesting"]]
    out += [f"OBSERVED LOCK-ORDER CYCLE: {' -> '.join(c + [c[0]])}"
            for c in locks["cycles"]]
    by_res = io["sched_bytes_by_resource"]
    out.append(f"DFS bytes by priority {by_res.get('dfs', {})}; all "
               f"resources {by_res}; {io['slot_grants']} slot grants")
    out.append(f"observed read {io['observed_read']} B / accounted "
               f"{io['accounted_read']} B, observed write "
               f"{io['observed_write']} B / accounted "
               f"{io['accounted_write']} B: unaccounted read "
               f"{io['unaccounted_read']} B, write {io['unaccounted_write']}"
               f" B; inversions {len(io['inversions'])}")
    if io["unaccounted_read"] or io["unaccounted_write"]:
        out += [f"read site {s['file']}:{s['line']} "
                f"({s.get('function', '?')}) moved {s['bytes']} B"
                for s in io["top_read_sites"]]
    out += [f"OBSERVED PRIORITY INVERSION on {i['resource']}: "
            f"{i['priority']} granted behind {i['behind']} after "
            f"{i['waited_s']}s ({i.get('function', i.get('site'))})"
            for i in io["inversions"]]
    return out


def main(argv: Optional[list] = None) -> int:
    """``python -m repro_torch.analysis.witness MODULE [ARG...]`` runs
    ``MODULE.main([ARG...])`` (a launcher of the port) with both witnesses
    installed before anything of the port is imported, so module-level
    locks are witnessed too; then prints ``witness: ...`` lines and one
    ``witness-report: {json}`` line. Exit 1 on an observed lock-order
    cycle, an unaccounted byte or a priority inversion."""
    import importlib
    import json

    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        print("usage: python -m repro_torch.analysis.witness MODULE "
              "[ARG...]", file=sys.stderr)
        return 2
    install()
    from repro_torch.analysis import iowitness
    io_rec = iowitness.install()
    try:
        importlib.import_module(argv[0]).main(argv[1:])
    finally:
        iowitness.uninstall()
        uninstall()
    locks = cross_check()
    io = iowitness.reconcile(io_rec)
    for line in report_lines(locks, io):
        print(f"witness: {line}", flush=True)
    print("witness-report: " + json.dumps({"locks": locks, "io": io}),
          flush=True)
    return 1 if locks["cycles"] or not io["ok"] else 0


if __name__ == "__main__":
    from repro_torch.analysis import witness
    sys.exit(witness.main())
