"""Concurrency lint for the port's startup stack, the port of the JAX
package's ``analysis/``, with its runtime witnesses.

The startup path is a deeply concurrent system: singleflight admission in
``fabric/cache.py``, priority token pools in ``core/pipeline.py``, a
sharded lock-striped index in ``blockstore/swarm.py``, shared I/O pools in
``dfs/striped.py`` / ``envcache/snapshot.py``. This package makes its
invariants machine-checked. It imports nothing of the JAX package and
only the standard library: the lint parses a tree (``src/repro_torch``
by default, or any other root) and never imports it.

Static side (AST + intra-package call graph, stdlib only — no runtime
imports, so it runs in a bare CI job):

* :mod:`repro_torch.analysis.callgraph` — module/class/function table and a
  best-effort intra-package call graph (``self.m()``, module functions,
  imported names, unique-method-name resolution).
* :mod:`repro_torch.analysis.locks` — lock *definitions* (``self._lock =
  threading.Lock()``, module-level locks, lock **containers** like
  ``self._flights.setdefault(k, Lock())`` and the methods that return
  locks out of them) plus an expression resolver mapping any ``with X:``
  / ``X.acquire()`` site back to a stable lock identity.
* :mod:`repro_torch.analysis.lockorder` — which locks are held when other
  locks are acquired (propagated through the call graph); cycles in the
  resulting digraph are potential deadlocks.
* :mod:`repro_torch.analysis.checks` — blocking-under-lock (DFS reads,
  ``pool.submit(...).result()``, ``time.sleep``, ``IOScheduler.slot``,
  unknown callbacks), acquire/release pairs that can escape on exception
  paths, ``slot()`` outside ``with``, dead locks, and lock containers
  with no removal path.
* :mod:`repro_torch.analysis.baseline` — known-good fingerprints so existing
  *intentional* patterns are suppressed and CI fails only on NEW
  findings.
* :mod:`repro_torch.analysis.cli` — the ``repro-torch-lint`` entry point.

Runtime side:

* :mod:`repro_torch.analysis.witness` — drop-in instrumented
  ``threading.Lock``/``Condition`` wrappers for locks the port's sources
  construct, which record ACTUAL acquisition orders and cross-check them
  against the static lock-order graph: observed cycles are hard
  failures, static edges never observed are reported as possibly stale.
* :mod:`repro_torch.analysis.iowitness` — byte ledgers around the port's
  ``HdfsCluster`` and ``IOScheduler``: bytes moved that accounting never
  saw, and priority inversions that happened, fail its reconcile.
"""

from repro_torch.analysis.baseline import Baseline, Finding, fingerprint
from repro_torch.analysis.callgraph import Package
from repro_torch.analysis.lockorder import LockOrderGraph

__all__ = ["Baseline", "Finding", "fingerprint", "Package",
           "run_analysis", "LockOrderGraph"]


def __getattr__(name):
    # imported on first use, so ``python -m repro_torch.analysis.cli``
    # does not find the CLI module already imported by its package
    if name == "run_analysis":
        from repro_torch.analysis.cli import run_analysis
        return run_analysis
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
