"""The concurrency checkers.

Built on the held-stack facts from :mod:`repro_torch.analysis.lockorder`:

* **lock-order-cycle** — a cycle in the lock-order digraph (two code
  paths can acquire the same locks in opposite orders);
* **reentrant-acquire** — a non-reentrant lock/condition acquired while
  already held (guaranteed self-deadlock on that path);
* **blocking-under-lock** — DFS reads, ``future.result()``,
  ``time.sleep``, ``IOScheduler.slot`` token waits, bare ``.wait()``,
  or calls to unknown callback parameters while holding a mutex or
  condition; semaphore holds are exempt (an N-slot semaphore is a
  throttle, not a critical section), as is ``cond.wait()`` on the
  condition currently held (it releases while waiting).  Blocking
  reached through resolved call chains is reported as *propagated*
  with the chain attached;
* **leak-on-raise** — an acquire-like call (``.acquire()``, shared-set
  ``.add()``, ``heapq.heappush``) whose matching release exists in the
  same function but is NOT protected by ``finally``/``except``, with
  raising calls in between — an exception wedges the resource;
* **slot-outside-with** — an ``IOScheduler.slot(...)`` result not used
  as a context manager;
* **unused-lock** — a lock constructed but never acquired anywhere;
* **unbounded-lock-container** — a per-key lock container with inserts
  but no removal path in its owning class (grows for every key ever
  seen).

Release protocols spanning functions (pin in one method, unpin in
another) are deliberately out of scope for the leak checker — flagging
every cross-function pairing would bury real findings in noise.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.baseline import Finding
from repro_torch.analysis.callgraph import FunctionInfo, Package
from repro_torch.analysis.lockorder import CallEvent, LockOrderGraph
from repro_torch.analysis.locks import MUTEX_KINDS, LockTable

DFS_READ_ATTRS = frozenset({"pread", "pread_many", "read_all"})
MOUNT_ATTRS = frozenset({"open", "read", "write", "exists", "stat",
                         "put", "get", "listdir"})
# categories that make a function "blocking" for propagation purposes
PROPAGATED_CATS = frozenset({"sleep", "future-result", "io-slot", "wait",
                             "dfs-read"})


def run_checks(pkg: Package, table: LockTable,
               graph: LockOrderGraph) -> List[Finding]:
    findings: List[Finding] = []
    findings += check_cycles(graph)
    findings += check_reentrant(graph, table)
    findings += check_blocking(pkg, table, graph)
    findings += check_leaks(pkg)
    findings += check_slot_outside_with(pkg, graph)
    findings += check_unused_locks(table, graph)
    findings += check_unbounded_containers(pkg, table)
    return findings


# ---------------------------------------------------------------- cycles

def check_cycles(graph: LockOrderGraph) -> List[Finding]:
    out = []
    for cyc in graph.cycles():
        ring = cyc + [cyc[0]]
        why = []
        first = None
        for outer, inner in zip(ring, ring[1:]):
            for e in graph.edges_for_pair(outer, inner):
                why.append(f"{e.outer} -> {e.inner} @ {e.file}:{e.line} "
                           f"({e.function}, {e.kind})")
                first = first or e
                break
        out.append(Finding(
            check="lock-order-cycle",
            file=first.file if first else "-",
            function="-",
            line=first.line if first else 0,
            detail="cycle: " + " -> ".join(ring),
            chain=tuple(why)))
    return out


def check_reentrant(graph: LockOrderGraph,
                    table: LockTable) -> List[Finding]:
    out = []
    for ev in graph.reentrant:
        info = graph.pkg.functions[ev.function]
        out.append(Finding(
            check="reentrant-acquire", file=info.file,
            function=ev.function, line=ev.line,
            detail=f"{ev.ident} ({table.kind(ev.ident)}) acquired while "
                   f"already held — self-deadlock on this path"))
    return out


# ---------------------------------------------------- blocking under lock

def _blocking_category(pkg: Package, table: LockTable, info: FunctionInfo,
                       ev: CallEvent) -> Optional[Tuple[str, str]]:
    fn = ev.node.func
    imps = pkg.imports.get(info.module, {})
    if isinstance(fn, ast.Attribute):
        recv = ast.unparse(fn.value)
        if fn.attr == "sleep" and isinstance(fn.value, ast.Name) \
                and imps.get(fn.value.id, fn.value.id) == "time":
            return ("sleep", "time.sleep(...)")
        if fn.attr == "result":
            return ("future-result", f"{recv}.result()")
        if fn.attr == "slot":
            return ("io-slot", f"{recv}.slot(...) token wait")
        if fn.attr == "wait":
            ident = table.resolve(info, fn.value)
            if ident is not None and ident in ev.held \
                    and table.kind(ident) == "condition":
                return None  # cond.wait() releases the held condition
            return ("wait", f"{recv}.wait()")
        if fn.attr in DFS_READ_ATTRS:
            return ("dfs-read", f"{recv}.{fn.attr}(...)")
        if "mount" in recv and fn.attr in MOUNT_ATTRS:
            # chained reads (`mount.open(p).read()`): flag the inner
            # call only, not every link of the chain
            if isinstance(fn.value, ast.Call) \
                    and "mount" in ast.unparse(fn.value.func):
                return None
            return ("dfs-read", f"{recv}.{fn.attr}(...)")
    elif isinstance(fn, ast.Name):
        if imps.get(fn.id) == "time.sleep":
            return ("sleep", "time.sleep(...)")
        if fn.id in info.params:
            return ("callback", f"{fn.id}(...) — opaque callback parameter")
    return None


def _mutex_held(ev: CallEvent, table: LockTable) -> List[str]:
    return [h for h in ev.held if table.kind(h) in MUTEX_KINDS]


def check_blocking(pkg: Package, table: LockTable,
                   graph: LockOrderGraph) -> List[Finding]:
    out: List[Finding] = []
    # per-function direct blocking facts (held or not) seed propagation
    seeds: Dict[str, Set[str]] = {}
    holders: Dict[str, Set[str]] = {}
    for qual, facts in graph.facts.items():
        info = pkg.functions[qual]
        for ev in facts.calls:
            cat = _blocking_category(pkg, table, info, ev)
            if cat is None:
                continue
            if cat[0] in PROPAGATED_CATS:
                seeds.setdefault(qual, set()).add(cat[0])
                holders.setdefault(cat[0], set()).add(qual)
            held = _mutex_held(ev, table)
            if held:
                out.append(Finding(
                    check="blocking-under-lock", file=info.file,
                    function=qual, line=ev.node.lineno,
                    detail=f"{cat[0]}: {cat[1]} while holding "
                           f"{', '.join(held)}"))
    closure = pkg.transitive_closure(seeds)
    for qual, facts in graph.facts.items():
        info = pkg.functions[qual]
        for ev in facts.calls:
            held = _mutex_held(ev, table)
            if not held or ev.callee is None:
                continue
            for cat in sorted(closure.get(ev.callee, ())):
                chain = tuple(pkg.call_chain(ev.callee,
                                             holders.get(cat, set())))
                out.append(Finding(
                    check="blocking-under-lock", file=info.file,
                    function=qual, line=ev.node.lineno,
                    detail=f"propagated {cat} via {ev.callee} while "
                           f"holding {', '.join(held)}",
                    chain=(qual,) + chain))
    return out


# -------------------------------------------------------- leak on raise

@dataclass
class _PairEvent:
    node: ast.Call
    key: str
    attr: str
    rel_attrs: frozenset
    label: str


def _leak_events(pkg: Package, info: FunctionInfo
                 ) -> Tuple[List[_PairEvent], List[Tuple[ast.Call, str, str]]]:
    imps = pkg.imports.get(info.module, {})
    acqs: List[_PairEvent] = []
    rels: List[Tuple[ast.Call, str, str]] = []   # (node, key, attr)
    for node in Package._own_body_walk(info.node):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute):
            recv = ast.unparse(fn.value)
            if fn.attr == "acquire":
                acqs.append(_PairEvent(node, recv, "acquire",
                                       frozenset({"release"}),
                                       f"{recv}.acquire()"))
            elif fn.attr == "add" and recv.startswith("self."):
                acqs.append(_PairEvent(node, recv, "add",
                                       frozenset({"discard", "remove"}),
                                       f"{recv}.add(...)"))
            elif fn.attr in ("release", "discard", "remove", "pop",
                             "clear"):
                rels.append((node, recv, fn.attr))
            heap_name = None
            if isinstance(fn.value, ast.Name) \
                    and imps.get(fn.value.id, fn.value.id) == "heapq":
                heap_name = fn.attr
        elif isinstance(fn, ast.Name):
            heap_name = fn.id if imps.get(fn.id, "").startswith("heapq.") \
                else None
        else:
            heap_name = None
        if heap_name == "heappush" and node.args:
            key = ast.unparse(node.args[0])
            acqs.append(_PairEvent(node, key, "heappush",
                                   frozenset({"heappop", "remove", "pop",
                                              "clear"}),
                                   f"heappush({key}, ...)"))
        elif heap_name == "heappop" and node.args:
            rels.append((node, ast.unparse(node.args[0]), "heappop"))
    return acqs, rels


def _ids(stmts: list) -> Set[int]:
    out: Set[int] = set()
    for st in stmts:
        out |= {id(n) for n in ast.walk(st)}
    return out


def check_leaks(pkg: Package) -> List[Finding]:
    out: List[Finding] = []
    for qual, info in pkg.functions.items():
        acqs, rels = _leak_events(pkg, info)
        if not acqs:
            continue
        trys = [(_ids(t.body + t.orelse),
                 _ids(t.finalbody) | _ids([h for h in t.handlers]))
                for t in Package._own_body_walk(info.node)
                if isinstance(t, ast.Try)]
        all_calls = [n for n in Package._own_body_walk(info.node)
                     if isinstance(n, ast.Call)]
        for acq in acqs:
            matches = [(n, k, a) for (n, k, a) in rels
                       if k == acq.key and a in acq.rel_attrs]
            if not matches:
                continue  # cross-function release protocol — out of scope
            later = [n for (n, _, _) in matches
                     if n.lineno > acq.node.lineno]
            if not later:
                continue
            first_rel = min(n.lineno for n in later)
            rel_ids = {id(n) for (n, _, _) in matches}
            risky = [c for c in all_calls
                     if acq.node.lineno < c.lineno < first_rel
                     and id(c) != id(acq.node) and id(c) not in rel_ids]
            # protected when a try with the matching release in its
            # finally/except covers every call that could raise between
            # the acquire and the release — true both for
            # `acquire(); try: ... finally: release()` and for an
            # acquire inside the try body itself
            risky_ids = {id(c) for c in risky}
            protected = any(
                any(id(n) in rescue for n, _, _ in matches)
                and risky_ids <= (body | rescue)
                for body, rescue in trys)
            if not protected and risky:
                out.append(Finding(
                    check="leak-on-raise", file=info.file, function=qual,
                    line=acq.node.lineno,
                    detail=f"{acq.label} can escape on exception — calls "
                           f"between it and the matching release can "
                           f"raise, and no finally/except restores "
                           f"{acq.key}"))
    return out


# ------------------------------------------------------ slot outside with

def check_slot_outside_with(pkg: Package,
                            graph: LockOrderGraph) -> List[Finding]:
    out: List[Finding] = []
    for qual, facts in graph.facts.items():
        info = pkg.functions[qual]
        # slot() handed to ExitStack.enter_context is fine
        exempt: Set[int] = set()
        for n in Package._own_body_walk(info.node):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "enter_context":
                exempt |= {id(a) for a in n.args}
        for ev in facts.calls:
            fn = ev.node.func
            if isinstance(fn, ast.Attribute) and fn.attr == "slot" \
                    and not ev.is_with_item and id(ev.node) not in exempt:
                out.append(Finding(
                    check="slot-outside-with", file=info.file,
                    function=qual, line=ev.node.lineno,
                    detail=f"{ast.unparse(fn.value)}.slot(...) result not "
                           f"used as a context manager — the I/O token "
                           f"is never released"))
    return out


# -------------------------------------------------------------- hygiene

def check_unused_locks(table: LockTable,
                       graph: LockOrderGraph) -> List[Finding]:
    used: Set[str] = set()
    for facts in graph.facts.values():
        used |= facts.acquires
    out = []
    for ident, d in sorted(table.defs.items()):
        if ident in used:
            continue
        out.append(Finding(
            check="unused-lock", file=d.file, function="-", line=d.line,
            detail=f"{ident} ({d.kind}) is constructed but never "
                   f"acquired anywhere in the package"))
    return out


def check_unbounded_containers(pkg: Package,
                               table: LockTable) -> List[Finding]:
    out = []
    for ident, d in sorted(table.defs.items()):
        if not d.container or d.owner is None:
            continue
        target = f"self.{d.attr}"
        removed = False
        for info in pkg.functions.values():
            if info.cls != d.owner:
                continue
            for node in Package._own_body_walk(info.node):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in ("pop", "popitem", "clear") \
                        and ast.unparse(node.func.value) == target:
                    removed = True
                elif isinstance(node, ast.Delete):
                    for t in node.targets:
                        if isinstance(t, ast.Subscript) \
                                and ast.unparse(t.value) == target:
                            removed = True
            if removed:
                break
        if not removed:
            out.append(Finding(
                check="unbounded-lock-container", file=d.file,
                function="-", line=d.line,
                detail=f"{ident}: per-key entries are inserted but never "
                       f"removed — the container grows for every key "
                       f"ever seen"))
    return out
