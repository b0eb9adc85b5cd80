"""Lock definitions and lock-expression resolution.

A "lock identity" is a stable name for a synchronization object class —
stable across lines moving and across instances:

* ``NodeCache._lock``            — ``self._lock = threading.Lock()``;
* ``repro_torch.dfs.striped._IO_POOL_LOCK`` — module-level lock;
* ``run_node_dags.lock``         — function-local lock (shared with the
  closures defined inside that function);
* ``NodeCache._flights[*]``      — a *container* of locks
  (``self._flights.setdefault(key, threading.Lock())``): every lock that
  ever lives in the container shares one identity, which is exactly the
  granularity lock-ORDER reasoning needs;
* methods that hand a lock out of a container
  (``def _flight_lock(self, key): return self._flights.setdefault(...)``)
  resolve at their call sites (``with self._flight_lock(key):``).

Each definition records its construction site (file, line) — the join
key the runtime witness uses to map real lock objects back onto static
identities.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.callgraph import FunctionInfo, Package

LOCK_CTORS = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "condition",
    "threading.Semaphore": "semaphore",
    "threading.BoundedSemaphore": "semaphore",
}

# kinds whose *hold* makes blocking calls dangerous (a semaphore with
# N slots is a throttle, not a critical section)
MUTEX_KINDS = frozenset({"lock", "rlock", "condition"})


@dataclass(frozen=True)
class LockDef:
    ident: str
    kind: str                  # lock | rlock | condition | semaphore
    module: str
    file: str                  # repo-relative path of the ctor site
    line: int                  # ctor line (witness join key)
    attr: str                  # attribute / variable name
    owner: Optional[str]       # class name, or None
    container: bool = False    # True for "Class.attr[*]" identities


class LockTable:
    """All lock definitions of a package + the expression resolver."""

    def __init__(self, pkg: Package):
        self.pkg = pkg
        self.defs: Dict[str, LockDef] = {}
        # (class name, attr) -> ident, for self.X resolution
        self._by_owner_attr: Dict[Tuple[str, str], str] = {}
        # attr name -> [idents] for unique-attr fallback (pool.cond)
        self._by_attr: Dict[str, List[str]] = {}
        # module -> {var name -> ident} (module-level locks)
        self._module_vars: Dict[str, Dict[str, str]] = {}
        # function qualname -> {local var -> ident}
        self._fn_locals: Dict[str, Dict[str, str]] = {}
        # method qualname -> ident it returns (lock-getter methods)
        self.lock_returning: Dict[str, str] = {}
        self._collect()

    # ----- collection ---------------------------------------------------

    def _ctor_kind(self, module: str, call: ast.Call) -> Optional[str]:
        fn = call.func
        imps = self.pkg.imports.get(module, {})
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
            base = imps.get(fn.value.id, fn.value.id)
            return LOCK_CTORS.get(f"{base}.{fn.attr}")
        if isinstance(fn, ast.Name):
            return LOCK_CTORS.get(imps.get(fn.id, ""))
        return None

    def _add(self, d: LockDef):
        if d.ident in self.defs:
            return
        self.defs[d.ident] = d
        if d.owner is not None:
            self._by_owner_attr[(d.owner, d.attr)] = d.ident
        self._by_attr.setdefault(d.attr, []).append(d.ident)

    def _collect(self):
        for mod, tree in self.pkg.modules.items():
            self._module_vars[mod] = {}
            # module-level lock assignments
            for node in tree.body:
                if isinstance(node, ast.Assign) \
                        and isinstance(node.value, ast.Call):
                    kind = self._ctor_kind(mod, node.value)
                    if kind is None:
                        continue
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            ident = f"{mod}.{t.id}"
                            self._add(LockDef(
                                ident=ident, kind=kind, module=mod,
                                file=self.pkg.files[mod],
                                line=node.value.lineno, attr=t.id,
                                owner=None))
                            self._module_vars[mod][t.id] = ident
        # attribute / local / container defs live inside functions
        for qual, info in self.pkg.functions.items():
            self._collect_in_fn(info)
        # lock-returning methods need the container table complete
        for qual, info in self.pkg.functions.items():
            ident = self._returned_lock(info)
            if ident is not None:
                self.lock_returning[qual] = ident

    def _collect_in_fn(self, info: FunctionInfo):
        mod = info.module
        locals_map = self._fn_locals.setdefault(info.qualname, {})
        for node in Package._own_body_walk(info.node):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                kind = self._ctor_kind(mod, node.value)
                if kind is None:
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self" \
                            and info.cls is not None:
                        ident = f"{info.cls}.{t.attr}"
                        self._add(LockDef(
                            ident=ident, kind=kind, module=mod,
                            file=info.file, line=node.value.lineno,
                            attr=t.attr, owner=info.cls))
                    elif isinstance(t, ast.Name):
                        ident = f"{info.name}.{t.id}"
                        self._add(LockDef(
                            ident=ident, kind=kind, module=mod,
                            file=info.file, line=node.value.lineno,
                            attr=t.id, owner=None))
                        locals_map[t.id] = ident
                    elif isinstance(t, ast.Subscript):
                        cont = self._container_ident(info, t.value)
                        if cont is not None:
                            self._add_container(info, cont, kind,
                                                node.value.lineno)
            elif isinstance(node, ast.Call):
                # self.Y.setdefault(key, threading.Lock())
                fn = node.func
                if isinstance(fn, ast.Attribute) \
                        and fn.attr == "setdefault" and len(node.args) >= 2 \
                        and isinstance(node.args[1], ast.Call):
                    kind = self._ctor_kind(mod, node.args[1])
                    if kind is None:
                        continue
                    cont = self._container_ident(info, fn.value)
                    if cont is not None:
                        self._add_container(info, cont, kind,
                                            node.args[1].lineno)

    def _container_ident(self, info: FunctionInfo,
                         expr: ast.AST) -> Optional[Tuple[str, str]]:
        """(owner, attr) for a container expression (``self.Y`` today)."""
        if isinstance(expr, ast.Attribute) \
                and isinstance(expr.value, ast.Name) \
                and expr.value.id == "self" and info.cls is not None:
            return (info.cls, expr.attr)
        return None

    def _add_container(self, info: FunctionInfo, cont: Tuple[str, str],
                       kind: str, line: int):
        owner, attr = cont
        ident = f"{owner}.{attr}[*]"
        self._add(LockDef(ident=ident, kind=kind, module=info.module,
                          file=info.file, line=line, attr=attr,
                          owner=owner, container=True))

    def _returned_lock(self, info: FunctionInfo) -> Optional[str]:
        for node in Package._own_body_walk(info.node):
            if isinstance(node, ast.Return) and node.value is not None:
                ident = self.resolve(info, node.value)
                if ident is not None:
                    return ident
        return None

    # ----- resolution ---------------------------------------------------

    def container_access(self, info: FunctionInfo,
                         expr: ast.AST) -> Optional[str]:
        """Identity for ``self.Y[k]`` / ``self.Y.get(k)`` /
        ``self.Y.setdefault(k, ...)`` when Y is a known lock container."""
        if isinstance(expr, ast.Subscript):
            base = expr.value
        elif isinstance(expr, ast.Call) \
                and isinstance(expr.func, ast.Attribute) \
                and expr.func.attr in ("get", "setdefault"):
            base = expr.func.value
        else:
            return None
        cont = self._container_ident(info, base)
        if cont is None:
            # x.Y[k] for a non-self receiver: unique container attr
            attr = getattr(base, "attr", None)
            if attr is not None:
                cands = [i for i in self._by_attr.get(attr, ())
                         if self.defs[i].container]
                if len(cands) == 1:
                    return cands[0]
            return None
        ident = f"{cont[0]}.{cont[1]}[*]"
        return ident if ident in self.defs else None

    def resolve(self, info: FunctionInfo, expr: ast.AST) -> Optional[str]:
        """Lock identity of ``expr`` in the context of ``info`` (the
        function whose body contains it), or None."""
        # local alias (incl. enclosing functions, for closures)
        if isinstance(expr, ast.Name):
            scope: Optional[str] = info.qualname
            while scope is not None:
                ident = self._fn_locals.get(scope, {}).get(expr.id)
                if ident is not None:
                    return ident
                scope = self.pkg.functions[scope].parent \
                    if scope in self.pkg.functions else None
            return self._module_vars.get(info.module, {}).get(expr.id)
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and expr.value.id == "self" \
                    and info.cls is not None:
                ident = self._by_owner_attr.get((info.cls, expr.attr))
                if ident is not None:
                    return ident
            # pool.cond / sh.lock: unique class-owned attr name
            # (function-local locks can't be reached as `x.attr`)
            cands = [i for i in self._by_attr.get(expr.attr, ())
                     if not self.defs[i].container
                     and self.defs[i].owner is not None]
            if len(cands) == 1:
                return cands[0]
            return None
        cont = self.container_access(info, expr)
        if cont is not None:
            return cont
        if isinstance(expr, ast.Call):
            target = self.pkg.resolve_call(info, expr)
            if target is not None:
                return self.lock_returning.get(target)
        return None

    def register_aliases(self, info: FunctionInfo):
        """Pre-scan ``info`` for ``x = <lock expr>`` local aliases so that
        later ``with x:`` sites resolve.  Called once per function before
        the hold-tracking walk."""
        locals_map = self._fn_locals.setdefault(info.qualname, {})
        for node in Package._own_body_walk(info.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                ident = self.resolve(info, node.value)
                if ident is not None:
                    locals_map[node.targets[0].id] = ident

    def kind(self, ident: str) -> str:
        return self.defs[ident].kind if ident in self.defs else "lock"


def collect_locks(pkg: Package) -> LockTable:
    table = LockTable(pkg)
    # alias registration is a fixpoint-ish second pass (aliases of
    # aliases are rare; one extra sweep covers chains of length 2)
    for _ in range(2):
        for info in pkg.functions.values():
            table.register_aliases(info)
    return table
