"""Static I/O-discipline checkers (stdlib-only, AST-level).

BootSeer's startup wins depend on every byte of image, env, and
checkpoint I/O flowing through the priority-aware ``IOScheduler``
(repro_torch.core.pipeline) and landing in ``HdfsCluster`` byte accounting.
Three separate PRs hand-fixed the same bug class — dropped
``sched``/``priority`` kwargs along call chains, per-call executors,
reads that bypass the scheduler — so these checkers make the
discipline mechanical:

``io-priority-drop``
    A function accepts ``sched`` or ``priority`` but the parameter is
    never referenced in its body, while the function (transitively)
    reaches a byte-moving primitive: the caller's scheduling class is
    silently discarded.  Also flags reader construction
    (``StripedReader`` / ``_PlainReader``) without ``sched=`` while a
    scheduler is plainly in scope.

``unscheduled-io``
    Raw DFS / registry / peer byte movers reachable from a startup
    task body (the nested functions of ``*._node_tasks``) must execute
    under an ``IOScheduler.slot`` token of the matching resource class
    (or the owning function must ``account`` that class — the
    documented accounting-only "peer" design).  Propagation subtracts
    the slot tokens held at each call site, so metering at *any* layer
    of the chain discharges the obligation.

``io-accounting-gap``
    Functions that open raw DataNode handles (``open_group_file``)
    must land their bytes in ``HdfsCluster.read_bytes`` /
    ``write_bytes`` / ``fabric_stats`` — directly, via a callee, or
    via a sibling method of the same class (split open/flush designs).

``executor-hygiene``
    On paths reachable from startup task bodies: constructing a
    ``ThreadPoolExecutor`` per call (thread-spawn cost on the hot
    path; long-lived ``self.x`` / module-global singletons are
    exempt), and gating on ``future.result()`` with no timeout.

Like the lock checkers, everything here is parse-only: the linted tree
is never imported, so the lint runs on a numpy/torch-free interpreter.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.baseline import Finding
from repro_torch.analysis.callgraph import FunctionInfo, Package

# nested task bodies created by BootseerRuntime._node_tasks are the
# startup hot path: everything they can reach runs during a boot; the
# autotune stack (the linted package's own ``<pkg>.tune``, so
# repro_torch.tune for the port) runs inside the boot's deferred tune
# task and meters its own profile I/O, so it is held to the same
# discipline
TASK_MARKER = "_node_tasks.<locals>."


def _is_root(qual: str) -> bool:
    package = qual.split(".", 1)[0]
    return TASK_MARKER in qual or f"{package}.tune." in qual


# reader classes whose constructors take (and should be handed) sched=
READER_CLASSES = frozenset({"StripedReader", "_PlainReader"})

# names that move bytes whenever they appear in a call — used by the
# *broad* priority-drop reachability (a dropped priority matters if any
# byte mover is downstream, metered or not)
BROAD_MOVER_NAMES = frozenset({
    "pread", "pread_many", "read_all", "pread_many_fallback",
    "read_plan", "execute_plan", "ensure_block", "read_file",
})

# attribute names that account bytes into HdfsCluster counters
ACCOUNT_ATTRS = frozenset({
    "account_read", "account_write", "account_fabric", "_account_fabric",
})


def _recv_text(call: ast.Call) -> str:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        try:
            return ast.unparse(fn.value)
        except Exception:               # pragma: no cover - defensive
            return ""
    return ""


def _call_name(call: ast.Call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _raw_mover_class(call: ast.Call) -> Optional[str]:
    """Resource class ("dfs" | "registry" | "peer") of a *raw* byte
    mover — a call that hits storage directly rather than through a
    reader object that meters internally."""
    fn = call.func
    if not isinstance(fn, ast.Attribute):
        return None
    recv = _recv_text(call)
    if fn.attr == "open_group_file":
        return "dfs"
    if fn.attr in ("pread", "pread_many", "read", "write") \
            and "hdfs" in recv:
        return "dfs"
    if fn.attr == "get_block" and "registry" in recv:
        return "registry"
    if fn.attr == "fetch" and "peers" in recv:
        return "peer"
    return None


def _is_broad_mover(call: ast.Call) -> bool:
    if _raw_mover_class(call) is not None:
        return True
    return _call_name(call) in BROAD_MOVER_NAMES


# ---------------------------------------------------------------------------
# slot-aware walker (sibling of lockorder._HeldWalker, but tracking
# IOScheduler.slot resource tokens instead of lock identities)
# ---------------------------------------------------------------------------


@dataclass
class SlotCall:
    node: ast.Call
    held: Tuple[str, ...]        # slot resources held at the call site
    callee: Optional[str]        # resolved qualname, or None (opaque)


@dataclass
class SlotFacts:
    """Per-function output of the slot walk."""

    calls: List[SlotCall] = field(default_factory=list)
    slots: Set[str] = field(default_factory=set)       # via with X.slot()
    accounts: Set[str] = field(default_factory=set)    # via X.account("r")

    @property
    def metered(self) -> Set[str]:
        return self.slots | self.accounts


def _slot_resource(expr: ast.AST) -> Optional[str]:
    """Resource string of a ``X.slot("res", ...)`` call, "*" if the
    resource is not a literal, None if this isn't a slot call."""
    if not (isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr == "slot"):
        return None
    if expr.args and isinstance(expr.args[0], ast.Constant) \
            and isinstance(expr.args[0].value, str):
        return expr.args[0].value
    return "*"


class _SlotWalker:
    """Branch-insensitive walk of one function body tracking which
    ``IOScheduler.slot`` resources are held at each call site."""

    def __init__(self, info: FunctionInfo, pkg: Package):
        self.info = info
        self.pkg = pkg
        self.facts = SlotFacts()

    def run(self) -> SlotFacts:
        self._block(list(self.info.node.body), [])
        return self.facts

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
                self._exprs(item.context_expr, held)
                res = _slot_resource(item.context_expr)
                if res is not None:
                    self.facts.slots.add(res)
                    held.append(res)
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
        if isinstance(node, (ast.If, ast.While)):
            self._exprs(node.test, held)
            self._block(node.body, list(held))
            self._block(node.orelse, list(held))
            return
        if isinstance(node, ast.For):
            self._exprs(node.iter, held)
            self._block(node.body, list(held))
            self._block(node.orelse, list(held))
            return
        self._exprs(node, held)

    def _exprs(self, node: ast.AST, held: List[str]):
        stack: List[ast.AST] = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(n, ast.Call):
                self.facts.calls.append(SlotCall(
                    node=n, held=tuple(held),
                    callee=self.pkg.resolve_call(self.info, n)))
                fn = n.func
                if isinstance(fn, ast.Attribute) and fn.attr == "account" \
                        and n.args and isinstance(n.args[0], ast.Constant) \
                        and isinstance(n.args[0].value, str):
                    self.facts.accounts.add(n.args[0].value)
            stack.extend(ast.iter_child_nodes(n))


def _slot_facts(pkg: Package) -> Dict[str, SlotFacts]:
    return {q: _SlotWalker(info, pkg).run()
            for q, info in pkg.functions.items()}


def _covers(held: Tuple[str, ...], res: str) -> bool:
    return res in held or "*" in held


# ---------------------------------------------------------------------------
# io-priority-drop
# ---------------------------------------------------------------------------


def _own_calls(pkg: Package, info: FunctionInfo) -> List[ast.Call]:
    return [n for n in pkg._own_body_walk(info.node)
            if isinstance(n, ast.Call)]


def _param_used(info: FunctionInfo, param: str) -> bool:
    """True when ``param`` is referenced anywhere in the function body,
    including nested defs (closures forward too).  A keyword *named*
    ``param`` whose value is some other expression — ``f(priority=0)``
    — does not count: that's exactly the drop pattern."""
    for node in ast.walk(info.node):
        if isinstance(node, ast.Name) and node.id == param:
            return True
    return False


def _sched_in_scope(info: FunctionInfo) -> bool:
    """A scheduler is plainly available: a ``sched`` parameter, a local
    ``sched``/``io_sched`` name, or a ``*.sched`` / ``*.io_sched``
    attribute access somewhere in the body."""
    if "sched" in info.params or "io_sched" in info.params:
        return True
    for node in ast.walk(info.node):
        if isinstance(node, ast.Name) and node.id in ("sched", "io_sched"):
            return True
        if isinstance(node, ast.Attribute) \
                and node.attr in ("sched", "io_sched", "_sched"):
            return True
    return False


def check_priority_drop(pkg: Package,
                        mover_closure: Dict[str, Set[str]],
                        mover_holders: Set[str]) -> List[Finding]:
    out: List[Finding] = []
    for qual, info in pkg.functions.items():
        # (a1) sched/priority accepted but never forwarded
        for param in ("sched", "priority"):
            if param not in info.params or _param_used(info, param):
                continue
            if "mover" not in mover_closure.get(qual, ()):
                continue
            chain = pkg.call_chain(qual, mover_holders)
            out.append(Finding(
                check="io-priority-drop", file=info.file, function=qual,
                line=info.node.lineno,
                detail=(f"parameter '{param}' is accepted but never "
                        "forwarded, yet this function reaches a "
                        "byte-moving primitive — callers' scheduling "
                        "class is silently dropped"),
                chain=tuple(chain)))
        # (a2) reader constructed without sched= while one is in scope
        for call in _own_calls(pkg, info):
            name = _call_name(call)
            if name not in READER_CLASSES:
                continue
            if any(kw.arg == "sched" for kw in call.keywords):
                continue
            if any(kw.arg is None for kw in call.keywords):
                continue            # **kwargs may carry sched
            if not _sched_in_scope(info):
                continue
            out.append(Finding(
                check="io-priority-drop", file=info.file, function=qual,
                line=call.lineno,
                detail=(f"{name} constructed without sched= while a "
                        "scheduler is in scope — its preads will bypass "
                        "the IOScheduler")))
    return out


# ---------------------------------------------------------------------------
# unscheduled-io
# ---------------------------------------------------------------------------


def check_unscheduled_io(pkg: Package,
                         facts: Dict[str, SlotFacts]) -> List[Finding]:
    # direct exposure: raw movers not under a matching slot, in
    # functions that neither slot nor account that resource class
    # anywhere (function-granular: a sched-is-None fallback branch in a
    # function that meters when it can is the documented design)
    exposed: Dict[str, Set[str]] = {}
    holders: Dict[str, Set[str]] = {}
    for qual, f in facts.items():
        direct: Set[str] = set()
        for call in f.calls:
            res = _raw_mover_class(call.node)
            if res is None or _covers(call.held, res) \
                    or res in f.metered:
                continue
            direct.add(res)
        exposed[qual] = direct
        for res in direct:
            holders.setdefault(res, set()).add(qual)
    # propagate exposure up the call graph, discharging classes covered
    # by slot tokens held at the call site or metered by the caller
    changed = True
    while changed:
        changed = False
        for qual, f in facts.items():
            for call in f.calls:
                if call.callee is None:
                    continue
                for res in exposed.get(call.callee, set()):
                    if _covers(call.held, res) or res in f.metered:
                        continue
                    if res not in exposed[qual]:
                        exposed[qual].add(res)
                        changed = True
    out: List[Finding] = []
    for qual, info in pkg.functions.items():
        if not _is_root(qual):
            continue
        for res in sorted(exposed.get(qual, ())):
            chain = pkg.call_chain(qual, holders.get(res, set()))
            out.append(Finding(
                check="unscheduled-io", file=info.file, function=qual,
                line=info.node.lineno,
                detail=(f"startup task body reaches a raw '{res}' byte "
                        f"mover with no IOScheduler.slot('{res}') token "
                        "(and no accounting) anywhere on the chain"),
                chain=tuple(chain)))
    return out


# ---------------------------------------------------------------------------
# io-accounting-gap
# ---------------------------------------------------------------------------


def check_accounting_gap(pkg: Package) -> List[Finding]:
    accounts_directly: Set[str] = set()
    for qual, info in pkg.functions.items():
        for call in _own_calls(pkg, info):
            if _call_name(call) in ACCOUNT_ATTRS:
                accounts_directly.add(qual)
                break
    covered = pkg.transitive_closure(
        {q: {"acct"} for q in accounts_directly})
    # split open/flush designs: any sibling method of the same class
    # accounting counts (the handle is opened here, billed there)
    class_accounts: Set[Tuple[str, str]] = {
        (pkg.functions[q].module, pkg.functions[q].cls)
        for q in accounts_directly if pkg.functions[q].cls is not None}
    out: List[Finding] = []
    for qual, info in pkg.functions.items():
        opens = [c for c in _own_calls(pkg, info)
                 if isinstance(c.func, ast.Attribute)
                 and c.func.attr == "open_group_file"]
        if not opens or "acct" in covered.get(qual, ()):
            continue
        if info.cls is not None \
                and (info.module, info.cls) in class_accounts:
            continue
        out.append(Finding(
            check="io-accounting-gap", file=info.file, function=qual,
            line=opens[0].lineno,
            detail=("raw DataNode handle (open_group_file) with no "
                    "HdfsCluster account_read/account_write/"
                    "account_fabric on this function, its callees, or "
                    "its class — moved bytes vanish from the counters")))
    return out


# ---------------------------------------------------------------------------
# executor-hygiene
# ---------------------------------------------------------------------------


def _reachable_from_roots(pkg: Package) -> Set[str]:
    roots = [q for q in pkg.functions if _is_root(q)]
    seen: Set[str] = set(roots)
    frontier = list(roots)
    while frontier:
        qual = frontier.pop()
        info = pkg.functions.get(qual)
        if info is None:
            continue
        for callee in pkg.call_edges(info):
            if callee not in seen:
                seen.add(callee)
                frontier.append(callee)
    return seen


def _is_tpe_call(call: ast.Call) -> bool:
    return _call_name(call) == "ThreadPoolExecutor"


def _exempt_tpe_stmt(stmt: ast.AST, global_names: Set[str]) -> bool:
    """Long-lived executors are fine: assignment to an instance
    attribute (``self._pool = ThreadPoolExecutor(...)``) or to a name
    declared ``global`` (the module-singleton pool pattern)."""
    targets: List[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)) \
            and stmt.target is not None:
        targets = [stmt.target]
    for t in targets:
        if isinstance(t, ast.Attribute):
            return True
        if isinstance(t, ast.Name) and t.id in global_names:
            return True
    return False


def check_executor_hygiene(pkg: Package,
                           reachable: Set[str]) -> List[Finding]:
    out: List[Finding] = []
    for qual in sorted(reachable):
        info = pkg.functions.get(qual)
        if info is None:
            continue
        global_names: Set[str] = set()
        exempt: Set[int] = set()
        # nested defs are separate reachable functions: scan the own
        # body only, or each site would be double-reported
        body_nodes = list(pkg._own_body_walk(info.node))
        for node in body_nodes:
            if isinstance(node, ast.Global):
                global_names.update(node.names)
        for node in body_nodes:
            if isinstance(node, ast.stmt) \
                    and _exempt_tpe_stmt(node, global_names):
                exempt.update(id(c) for c in ast.walk(node)
                              if isinstance(c, ast.Call)
                              and _is_tpe_call(c))
        for node in body_nodes:
            if isinstance(node, ast.Call) and _is_tpe_call(node) \
                    and id(node) not in exempt:
                out.append(Finding(
                    check="executor-hygiene", file=info.file,
                    function=qual, line=node.lineno,
                    detail=("per-call ThreadPoolExecutor on a "
                            "startup-reachable path — thread spawn "
                            "cost is paid on every invocation; use "
                            "a long-lived or shared pool")))
        for call in _own_calls(pkg, info):
            fn = call.func
            if isinstance(fn, ast.Attribute) and fn.attr == "result" \
                    and not call.args \
                    and not any(kw.arg == "timeout"
                                for kw in call.keywords):
                out.append(Finding(
                    check="executor-hygiene", file=info.file,
                    function=qual, line=call.lineno,
                    detail=("untimed future.result() on a "
                            "startup-reachable gating path — a stuck "
                            "worker stalls boot forever; pass a "
                            "timeout")))
    # dedupe: nested statements make ast.walk visit a call through
    # both the compound statement and its children
    seen: Set[Tuple[str, str, int, str]] = set()
    uniq: List[Finding] = []
    for f in out:
        key = (f.check, f.function, f.line, f.detail)
        if key not in seen:
            seen.add(key)
            uniq.append(f)
    return uniq


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def run_io_checks(pkg: Package) -> List[Finding]:
    """All I/O-discipline findings for the parsed package."""
    mover_seed = {
        q: {"mover"} for q, info in pkg.functions.items()
        if any(_is_broad_mover(c) for c in _own_calls(pkg, info))}
    mover_closure = pkg.transitive_closure(mover_seed)
    facts = _slot_facts(pkg)
    findings: List[Finding] = []
    findings += check_priority_drop(pkg, mover_closure,
                                    set(mover_seed))
    findings += check_unscheduled_io(pkg, facts)
    findings += check_accounting_gap(pkg)
    findings += check_executor_hygiene(pkg, _reachable_from_roots(pkg))
    findings.sort(key=lambda f: (f.file, f.line, f.check, f.detail))
    return findings
