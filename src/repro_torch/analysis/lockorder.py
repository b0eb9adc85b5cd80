"""Lock-order graph: which locks are held when others are acquired.

The walker tracks the stack of held lock identities through each
function body (``with`` statements, plus manual ``.acquire()`` /
``.release()`` at statement level), emitting:

* **acquire events** — a lock acquired while others are held adds
  digraph edges ``outer -> inner``;
* **call events** — every call site with the lock stack at that point;
  used both for propagation (calling F under L adds edges ``L -> a`` for
  every lock ``a`` that F transitively acquires) and by the blocking /
  leak checkers in :mod:`repro_torch.analysis.checks`.

Control flow is approximated branch-insensitively: each branch of an
``if``/``try`` is walked with a copy of the held stack, so conditional
acquisitions don't leak past their branch, and a ``finally`` release is
honored for the code after the ``try``.  That over-approximates *holds*
slightly (safe direction for a deadlock detector).

Cycles in the resulting digraph — including propagated edges — are
potential deadlocks; Tarjan's SCC algorithm finds them.  A self-edge on
a non-reentrant lock kind is reported separately (reacquire deadlock).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.callgraph import FunctionInfo, Package
from repro_torch.analysis.locks import LockTable


@dataclass(frozen=True)
class LockEdge:
    outer: str
    inner: str
    kind: str                   # direct | propagated
    function: str               # qualname where the edge originates
    file: str
    line: int
    chain: Tuple[str, ...] = ()  # call chain explaining a propagated edge


@dataclass
class CallEvent:
    node: ast.Call
    held: Tuple[str, ...]       # lock idents held at the call site
    callee: Optional[str]       # resolved qualname, or None (opaque)
    function: str               # caller qualname
    is_with_item: bool = False  # the call IS a with-statement item


@dataclass
class AcquireEvent:
    ident: str
    held: Tuple[str, ...]
    function: str
    line: int
    reentrant: bool = False


@dataclass
class FunctionFacts:
    """Per-function output of the held-stack walk."""

    acquires: Set[str] = field(default_factory=set)
    acquire_lines: Dict[str, int] = field(default_factory=dict)
    calls: List[CallEvent] = field(default_factory=list)
    acquire_events: List[AcquireEvent] = field(default_factory=list)


class _HeldWalker:
    def __init__(self, info: FunctionInfo, table: LockTable, pkg: Package):
        self.info = info
        self.table = table
        self.pkg = pkg
        self.facts = FunctionFacts()

    def run(self) -> FunctionFacts:
        self._block(list(self.info.node.body), [])
        return self.facts

    # -- statements ------------------------------------------------------

    def _block(self, stmts: list, held: List[str]):
        for st in stmts:
            self._stmt(st, held)

    def _stmt(self, node: ast.AST, held: List[str]):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in node.items:
                self._exprs(item.context_expr, held, with_item=True)
                ident = self.table.resolve(self.info, item.context_expr)
                if ident is not None:
                    self._acquire(ident, held, item.context_expr.lineno)
                    held.append(ident)
                    pushed += 1
            self._block(node.body, held)
            del held[len(held) - pushed:]
            return
        if isinstance(node, ast.Try):
            entry = list(held)
            self._block(node.body, held)
            for h in node.handlers:
                self._block(h.body, list(entry))
            self._block(node.orelse, list(held))
            self._block(node.finalbody, held)
            return
        if isinstance(node, ast.If):
            self._exprs(node.test, held)
            self._block(node.body, list(held))
            self._block(node.orelse, list(held))
            return
        if isinstance(node, (ast.While,)):
            self._exprs(node.test, held)
            self._block(node.body, list(held))
            self._block(node.orelse, list(held))
            return
        if isinstance(node, ast.For):
            self._exprs(node.iter, held)
            self._block(node.body, list(held))
            self._block(node.orelse, list(held))
            return
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            call = node.value
            fn = call.func
            if isinstance(fn, ast.Attribute) \
                    and fn.attr in ("acquire", "release"):
                ident = self.table.resolve(self.info, fn.value)
                if ident is not None:
                    self._exprs(call, held)
                    if fn.attr == "acquire":
                        self._acquire(ident, held, call.lineno)
                        held.append(ident)
                    elif ident in held:
                        held.remove(ident)
                    return
        # generic statement: just scan its expressions for calls
        self._exprs(node, held)

    # -- expressions -----------------------------------------------------

    def _exprs(self, node: ast.AST, held: List[str], with_item: bool = False):
        stack: List[ast.AST] = [node]
        top = node
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(n, ast.Call):
                self.facts.calls.append(CallEvent(
                    node=n, held=tuple(held),
                    callee=self.pkg.resolve_call(self.info, n),
                    function=self.info.qualname,
                    is_with_item=with_item and n is top))
                # `X.acquire()` in expression position still orders locks
                if isinstance(n.func, ast.Attribute) \
                        and n.func.attr == "acquire" and not with_item:
                    ident = self.table.resolve(self.info, n.func.value)
                    if ident is not None and not self._stmt_level(n, node):
                        self._acquire(ident, held, n.lineno)
            stack.extend(ast.iter_child_nodes(n))

    @staticmethod
    def _stmt_level(call: ast.Call, root: ast.AST) -> bool:
        return isinstance(root, ast.Expr) and root.value is call

    def _acquire(self, ident: str, held: List[str], line: int):
        ev = AcquireEvent(ident=ident, held=tuple(held),
                          function=self.info.qualname, line=line,
                          reentrant=ident in held)
        self.facts.acquire_events.append(ev)
        self.facts.acquires.add(ident)
        self.facts.acquire_lines.setdefault(ident, line)


class LockOrderGraph:
    """The package-wide lock-order digraph (direct + propagated edges)."""

    def __init__(self, pkg: Package, table: LockTable):
        self.pkg = pkg
        self.table = table
        self.facts: Dict[str, FunctionFacts] = {}
        self.edges: List[LockEdge] = []
        self._edge_keys: Set[Tuple[str, str, str, str]] = set()
        self.reentrant: List[AcquireEvent] = []
        self._build()

    # -- construction ----------------------------------------------------

    def _build(self):
        for qual, info in self.pkg.functions.items():
            self.facts[qual] = _HeldWalker(info, self.table, self.pkg).run()
        # direct edges + reentrant acquires
        for qual, f in self.facts.items():
            info = self.pkg.functions[qual]
            for ev in f.acquire_events:
                if ev.reentrant \
                        and self.table.kind(ev.ident) in ("lock", "condition"):
                    self.reentrant.append(ev)
                for outer in ev.held:
                    if outer != ev.ident:
                        self._add(LockEdge(
                            outer=outer, inner=ev.ident, kind="direct",
                            function=qual, file=info.file, line=ev.line))
        # propagated edges: call F while holding L -> L orders before
        # everything F transitively acquires
        closure = self.pkg.transitive_closure(
            {q: f.acquires for q, f in self.facts.items()})
        holders: Dict[str, Set[str]] = {}
        for q, f in self.facts.items():
            for ident in f.acquires:
                holders.setdefault(ident, set()).add(q)
        for qual, f in self.facts.items():
            info = self.pkg.functions[qual]
            for call in f.calls:
                if call.callee is None or not call.held:
                    continue
                for inner in sorted(closure.get(call.callee, ())):
                    for outer in call.held:
                        if outer == inner:
                            continue
                        chain = tuple(self.pkg.call_chain(
                            call.callee, holders.get(inner, set())))
                        self._add(LockEdge(
                            outer=outer, inner=inner, kind="propagated",
                            function=qual, file=info.file,
                            line=call.node.lineno,
                            chain=(qual,) + chain))

    def _add(self, e: LockEdge):
        key = (e.outer, e.inner, e.kind, e.function)
        if key in self._edge_keys:
            return
        # a direct edge supersedes the same propagated pair from the
        # same function; keep both kinds across functions (explanations)
        self._edge_keys.add(key)
        self.edges.append(e)

    # -- queries ---------------------------------------------------------

    def pairs(self) -> Set[Tuple[str, str]]:
        return {(e.outer, e.inner) for e in self.edges}

    def adjacency(self) -> Dict[str, Set[str]]:
        adj: Dict[str, Set[str]] = {}
        for o, i in self.pairs():
            adj.setdefault(o, set()).add(i)
            adj.setdefault(i, set())
        return adj

    def cycles(self) -> List[List[str]]:
        """Non-trivial SCCs (plus self-loops) — potential deadlocks."""
        return scc_cycles(self.pairs())

    def edges_for_pair(self, outer: str, inner: str) -> List[LockEdge]:
        return [e for e in self.edges
                if e.outer == outer and e.inner == inner]


def scc_cycles(pairs: Iterable[Tuple[str, str]]) -> List[List[str]]:
    """Non-trivial SCCs (plus self-loops) of an edge set — shared by the
    static graph and the runtime witness.  Iterative Tarjan (no
    recursion-limit surprises on pathological graphs)."""
    adj: Dict[str, Set[str]] = {}
    for o, i in pairs:
        adj.setdefault(o, set()).add(i)
        adj.setdefault(i, set())
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    def strongconnect(v: str):
        work = [(v, iter(sorted(adj[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(adj[w]))))
                    advanced = True
                    break
                if w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                if len(scc) > 1 or node in adj.get(node, ()):
                    sccs.append(sorted(scc))

    for v in sorted(adj):
        if v not in index:
            strongconnect(v)
    return sccs


def build_lock_order(pkg: Package, table: LockTable) -> LockOrderGraph:
    return LockOrderGraph(pkg, table)
