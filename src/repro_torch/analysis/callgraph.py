"""AST module table + best-effort intra-package call graph.

The startup stack's concurrency checks need to answer "when function A
runs under lock L, which locks / blocking operations can it reach?" —
that requires following calls *between* functions, not just looking
inside one body.  Python has no static types here, so resolution is a
stack of deliberate heuristics, each chosen to be precise on this
codebase's idioms:

* ``self.m(...)``          -> method ``m`` of the enclosing class;
* ``name(...)``            -> module-level function / nested sibling
                              function of the same module;
* ``mod.f(...)``           -> function ``f`` of an imported package
                              module (``import repro_torch.x as mod`` or
                              ``from repro_torch import x``);
* ``anything.m(...)``      -> the UNIQUE class in the package defining a
                              method ``m`` — unless ``m`` is a common
                              container/file method name (``get``,
                              ``read``, ``append``...), where uniqueness
                              would mis-bind dict/file calls.

Unresolvable calls are simply absent from the graph: the downstream
checkers treat them as opaque (the baseline mechanism absorbs the few
intentional blind spots, e.g. singleflight producer callbacks).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set

# attribute names too generic to resolve by "unique method name":
# binding `self.stats.get(...)` to some class's `get` would poison the
# whole graph with dict/file/executor calls.
GENERIC_ATTRS = frozenset({
    "get", "setdefault", "pop", "popitem", "items", "keys", "values",
    "append", "add", "discard", "remove", "clear", "update", "copy",
    "extend", "sort", "index", "count", "insert", "reverse",
    "encode", "decode", "split", "rsplit", "strip", "rstrip", "lstrip",
    "format", "startswith", "endswith", "replace", "lower", "upper",
    "read", "write", "close", "open", "seek", "tell", "readinto",
    "flush", "readline", "readlines",
    "submit", "result", "shutdown", "map",
    "acquire", "release", "wait", "notify", "notify_all", "set",
    "is_set", "locked", "join", "start",
    "mkdir", "exists", "unlink", "stat", "iterdir", "rglob", "glob",
    "put", "send", "recv",
})


@dataclass
class FunctionInfo:
    """One function or method (nested functions included)."""

    qualname: str                 # "repro_torch.fabric.cache:NodeCache.put"
    module: str                   # dotted module name
    cls: Optional[str]            # enclosing class name, if a method
    name: str                     # bare name
    node: ast.AST                 # FunctionDef / AsyncFunctionDef
    file: str                     # repo-relative path
    params: Set[str] = field(default_factory=set)
    parent: Optional[str] = None  # qualname of enclosing function


class Package:
    """Parsed view of one source tree (``src/repro_torch`` for the CLI)."""

    def __init__(self):
        self.modules: Dict[str, ast.Module] = {}
        self.files: Dict[str, str] = {}                 # module -> relpath
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, Dict[str, ast.ClassDef]] = {}
        # module -> local name -> dotted target ("threading", "time.sleep",
        # "repro_torch.fabric.cache.NodeCache", ...)
        self.imports: Dict[str, Dict[str, str]] = {}
        # method name -> [qualnames] across every class (for unique-name
        # resolution)
        self._methods_by_name: Dict[str, List[str]] = {}
        # module -> {bare function name -> qualname} (module level only)
        self._mod_functions: Dict[str, Dict[str, str]] = {}

    # ----- loading ------------------------------------------------------

    @classmethod
    def load(cls, roots: Iterable[str | Path],
             package_root: Optional[Path] = None,
             exclude_parts: Iterable[str] = ()) -> "Package":
        """Parse every ``*.py`` under ``roots``.

        ``package_root`` anchors both dotted module names and the
        repo-relative paths reported in findings; defaults to the common
        parent of the first root's ``src`` directory when present, else
        the first root itself.  Files with any path component listed in
        ``exclude_parts`` are skipped (the CLI uses this to avoid
        self-linting the analysis package).
        """
        pkg = cls()
        roots = [Path(r) for r in roots]
        if package_root is None:
            package_root = pkg._guess_root(roots[0])
        pkg.root = Path(package_root)
        skip = set(exclude_parts)
        for root in roots:
            files = [root] if root.is_file() else sorted(root.rglob("*.py"))
            for f in files:
                if skip and skip & set(f.parts):
                    continue
                pkg._load_file(f)
        pkg._index()
        return pkg

    @staticmethod
    def _guess_root(root: Path) -> Path:
        for anc in [root] + list(root.resolve().parents):
            if anc.name == "src":
                return anc
        return root if root.is_dir() else root.parent

    def _module_name(self, path: Path) -> str:
        try:
            rel = path.resolve().relative_to(self.root.resolve())
        except ValueError:
            rel = Path(path.name)
        parts = list(rel.with_suffix("").parts)
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts) or path.stem

    def _load_file(self, path: Path):
        try:
            tree = ast.parse(path.read_text(), filename=str(path))
        except SyntaxError:
            return
        mod = self._module_name(path)
        try:
            rel = str(path.resolve().relative_to(self.root.resolve().parent))
        except ValueError:
            rel = str(path)
        self.modules[mod] = tree
        self.files[mod] = rel
        self.classes[mod] = {}
        self.imports[mod] = imps = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    imps[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    imps[a.asname or a.name] = f"{node.module}.{a.name}"

    def _index(self):
        for mod, tree in self.modules.items():
            self._mod_functions[mod] = {}
            self._walk_scope(mod, tree.body, cls=None, parent=None)

    def _walk_scope(self, mod: str, body: list, cls: Optional[str],
                    parent: Optional[str]):
        for node in body:
            if isinstance(node, ast.ClassDef):
                self.classes[mod][node.name] = node
                self._walk_scope(mod, node.body, cls=node.name,
                                 parent=parent)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = self._register_fn(mod, node, cls, parent)
                # nested defs belong to the function's scope, not the class
                self._walk_scope(mod, node.body, cls=cls, parent=qual)
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                # module-level guards (try/except ImportError etc.)
                inner = list(getattr(node, "body", []))
                inner += list(getattr(node, "orelse", []))
                inner += list(getattr(node, "finalbody", []))
                for h in getattr(node, "handlers", []):
                    inner += h.body
                self._walk_scope(mod, inner, cls=cls, parent=parent)

    def _register_fn(self, mod: str, node, cls: Optional[str],
                     parent: Optional[str]) -> str:
        if parent is not None:
            qual = f"{parent}.<locals>.{node.name}"
        elif cls is not None:
            qual = f"{mod}:{cls}.{node.name}"
        else:
            qual = f"{mod}:{node.name}"
        params = {a.arg for a in node.args.args + node.args.kwonlyargs
                  + node.args.posonlyargs}
        if node.args.vararg:
            params.add(node.args.vararg.arg)
        if node.args.kwarg:
            params.add(node.args.kwarg.arg)
        params.discard("self")
        info = FunctionInfo(qualname=qual, module=mod, cls=cls,
                            name=node.name, node=node,
                            file=self.files[mod], params=params,
                            parent=parent)
        self.functions[qual] = info
        if cls is not None and parent is None:
            self._methods_by_name.setdefault(node.name, []).append(qual)
        elif parent is None:
            self._mod_functions[mod][node.name] = qual
        return info.qualname

    # ----- call resolution ---------------------------------------------

    def resolve_call(self, caller: FunctionInfo,
                     call: ast.Call) -> Optional[str]:
        """Qualname of the called package function, or None (opaque)."""
        fn = call.func
        if isinstance(fn, ast.Name):
            return self._resolve_name(caller, fn.id)
        if isinstance(fn, ast.Attribute):
            # self.m(...)
            if isinstance(fn.value, ast.Name) and fn.value.id == "self" \
                    and caller.cls is not None:
                qual = f"{caller.module}:{caller.cls}.{fn.attr}"
                if qual in self.functions:
                    return qual
            # mod.f(...) via imports
            if isinstance(fn.value, ast.Name):
                target = self.imports.get(caller.module, {}) \
                    .get(fn.value.id)
                if target is not None:
                    qual = f"{target}:{fn.attr}"
                    if qual in self.functions:
                        return qual
            # anything.m(...): unique method name across the package
            if fn.attr not in GENERIC_ATTRS:
                cands = self._methods_by_name.get(fn.attr, [])
                if len(cands) == 1:
                    return cands[0]
        return None

    def _resolve_name(self, caller: FunctionInfo, name: str) -> Optional[str]:
        # nested sibling / own nested function
        scope = caller.qualname
        while scope is not None:
            qual = f"{scope}.<locals>.{name}"
            if qual in self.functions:
                return qual
            scope = self.functions[scope].parent \
                if scope in self.functions else None
        qual = self._mod_functions.get(caller.module, {}).get(name)
        if qual is not None:
            return qual
        target = self.imports.get(caller.module, {}).get(name)
        if target is not None and "." in target:
            tmod, tname = target.rsplit(".", 1)
            qual = self._mod_functions.get(tmod, {}).get(tname)
            if qual is not None:
                return qual
        return None

    def call_edges(self, caller: FunctionInfo) -> Set[str]:
        """Every resolved intra-package callee of ``caller`` (its own
        body only — nested functions are separate graph nodes)."""
        out: Set[str] = set()
        for node in self._own_body_walk(caller.node):
            if isinstance(node, ast.Call):
                target = self.resolve_call(caller, node)
                if target is not None:
                    out.add(target)
        return out

    @staticmethod
    def _own_body_walk(fn_node) -> Iterable[ast.AST]:
        """ast.walk that does NOT descend into nested function/class
        defs (they are separate FunctionInfo entries)."""
        stack = list(ast.iter_child_nodes(fn_node))
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
                continue
            yield node
            stack.extend(ast.iter_child_nodes(node))

    def transitive_closure(self, seed: Dict[str, Set[str]]
                           ) -> Dict[str, Set[str]]:
        """Fixpoint of ``seed`` (per-function facts) propagated backwards
        over call edges: the result for F includes every fact reachable
        through any chain of resolved calls starting at F."""
        edges = {q: self.call_edges(info)
                 for q, info in self.functions.items()}
        out = {q: set(seed.get(q, ())) for q in self.functions}
        changed = True
        while changed:
            changed = False
            for q, callees in edges.items():
                for c in callees:
                    extra = out.get(c, set()) - out[q]
                    if extra:
                        out[q] |= extra
                        changed = True
        return out

    def call_chain(self, src: str, fact_holders: Set[str],
                   limit: int = 6) -> List[str]:
        """A short resolved call chain from ``src`` to any function in
        ``fact_holders`` (BFS) — used to explain propagated findings."""
        if src in fact_holders:
            return [src]
        seen = {src}
        frontier = [[src]]
        for _ in range(limit):
            nxt = []
            for path in frontier:
                info = self.functions.get(path[-1])
                if info is None:
                    continue
                for callee in sorted(self.call_edges(info)):
                    if callee in seen:
                        continue
                    seen.add(callee)
                    p2 = path + [callee]
                    if callee in fact_holders:
                        return p2
                    nxt.append(p2)
            frontier = nxt
        return []
