"""Repo-specific AST rules for the port's round scopes (port of
``repro/analysis/astlint.py``).

Generic linters cannot know which functions of the port run inside an
SSSP round, where an ordinary Python read of a tensor is a hidden
device->host sync: ``.item()``, ``float()``, or an ``if`` on a tensor
waits for the card every round.  The engine's counted reads go through
``engine.SyncCounter`` (``sync.read``), only in the sanctioned host
drivers (``_loop``, ``_frontier_fixpoint``) and in the round bodies'
own ``sync.read`` calls.  This pass parses the round-scope modules,
scopes the rules to the functions that make up a round, and applies a
conservative staticness analysis so config and shape arithmetic
(``cfg.rules``, ``g.e_pad``, ``prims.relax2 is None``, a count
``sync.read`` returned) never false-positives.

Rules (ids are stable; suppress one occurrence with a trailing
``# astlint: ignore[<rule>]`` comment):

  tensor-branch      Python ``if``/``while`` whose test is not provably
                     static inside a round scope (an implicit sync; use
                     ``torch.where`` or read through ``SyncCounter``).
  host-sync          ``.item()`` / ``.tolist()`` / ``.cpu()`` /
                     ``.numpy()``, or ``float()`` / ``int()`` /
                     ``bool()``, of a non-static expression inside a
                     round scope (a host read outside ``SyncCounter``).
  raw-graphdelta     ``GraphDelta(...)`` constructed directly outside
                     ``core/sssp/dynamic.py``: deltas go through
                     ``make_delta`` (weights checked on the host before
                     they reach the device).

The reference's ``numpy-in-traced`` rule (an ``np.`` call constant-folds
a tracer) has no eager meaning and is dropped: numpy on a tensor in an
eager round is a host read, which ``host-sync`` and the op lint catch.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path

#: module (repo-relative) -> function-name patterns whose bodies make up
#: a round.  A bare name matches a top-level def OR any def nested in it
#: (the backends' closures); ``Class.method`` scopes to that method.
ROUND_SCOPES: dict[str, tuple[str, ...]] = {
    "src/repro_torch/core/sssp/engine.py": (
        "_round", "_round_shared", "_select", "_cond", "_init_state*",
        "_compact_*", "_chunked_apply", "_walk_step",
    ),
    "src/repro_torch/core/sssp/backends.py": ("*_prims",),
    "src/repro_torch/kernels/ops.py": ("*",),
}

#: names that are always host values in these scopes: module aliases,
#: configs, backend-primitive bundles, the sync counter, builtins.
STATIC_BASES = frozenset({
    "torch", "np", "math", "functools", "dataclasses", "cfg", "config",
    "prims", "self", "cls", "dtype", "shape", "INF", "_ELL_PAD", "backend",
    "cap", "sync", "range", "len", "min", "max", "abs", "int", "float",
    "bool", "str", "tuple", "list", "dict", "set", "frozenset", "sorted",
    "enumerate", "zip", "isinstance", "getattr", "hasattr",
})

#: attributes that are host ints/containers on the graph, layout, stack
#: and primitives objects whatever the base object is.
STATIC_ATTRS = frozenset({
    "n", "e", "e_pad", "n_pad", "num_segments", "max_out_deg",
    "max_in_deg", "deg_pad", "size", "lanes", "per", "es", "frontier_cap",
    "walk_width", "cap", "shape", "ndim", "dtype", "device", "is_cuda",
})

#: parameters that are host values wherever they appear: configs, the
#: sync counter, and the host ints the drivers pass down (counts a
#: ``sync.read`` returned, chunk starts and sizes, buffer sizes).
KEEP_STATIC = frozenset({
    "cfg", "config", "prims", "self", "cls", "backend", "dtype", "cap",
    "warm", "sync", "max_rounds", "cnt", "f_cnt", "step", "start", "n",
    "B",
})

_IGNORE_RE = re.compile(r"#\s*astlint:\s*ignore\[([a-z\-, ]+)\]")
_HOST_METHODS = ("item", "tolist", "cpu", "numpy")


@dataclasses.dataclass(frozen=True)
class AstFinding:
    rule: str
    path: str
    line: int
    detail: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.detail}"


def _is_sync_read(node: ast.AST) -> bool:
    """``sync.read(...)`` / ``sync.read_numpy(...)``: a counted read,
    whose result is a host value."""
    fn = getattr(node, "func", None)
    return (isinstance(node, ast.Call) and isinstance(fn, ast.Attribute)
            and fn.attr in ("read", "read_numpy")
            and isinstance(fn.value, ast.Name) and fn.value.id == "sync")


class _Static:
    """Conservative staticness analysis over one round scope."""

    def __init__(self, static_names: frozenset[str]):
        self.names = set(static_names)

    def absorb_assignments(self, body: list[ast.stmt],
                           protected: frozenset[str] = frozenset()) -> None:
        """Propagate staticness through local assignments (tuple targets
        and ``for`` loop variables over static iterables included).  A
        name qualifies only if EVERY binding of it in the scope is
        static; two passes handle forward chains."""
        binds: list[tuple[str, ast.expr]] = []

        def bind(target, value):
            if isinstance(target, ast.Name):
                binds.append((target.id, value))
            elif isinstance(target, (ast.Tuple, ast.List)):
                for t in target.elts:
                    bind(t, value)

        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        bind(t, node.value)
                elif (isinstance(node, ast.AnnAssign)
                        and node.value is not None):
                    bind(node.target, node.value)
                elif isinstance(node, ast.For):
                    bind(node.target, node.iter)
        for _ in range(2):
            by_name: dict[str, bool] = {}
            for name, value in binds:
                ok = self.is_static(value)
                by_name[name] = by_name.get(name, True) and ok
            for name, ok in by_name.items():
                if ok:
                    self.names.add(name)
                elif name not in protected:
                    self.names.discard(name)

    def is_static(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Constant):
            return True
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return True
            return self.is_static(node.value)
        if isinstance(node, ast.Subscript):
            return self.is_static(node.value)
        if isinstance(node, ast.Compare):
            # `x is None` / `x is not None` is a structural check
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return True
            return (self.is_static(node.left)
                    and all(self.is_static(c) for c in node.comparators))
        if isinstance(node, ast.BoolOp):
            return all(self.is_static(v) for v in node.values)
        if isinstance(node, ast.UnaryOp):
            return self.is_static(node.operand)
        if isinstance(node, ast.BinOp):
            return self.is_static(node.left) and self.is_static(node.right)
        if isinstance(node, ast.IfExp):
            return (self.is_static(node.test) and self.is_static(node.body)
                    and self.is_static(node.orelse))
        if isinstance(node, ast.Call):
            if _is_sync_read(node):
                return True
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id == "len":
                return True     # a container's length or a tensor's dim 0
            return (self.is_static(fn)
                    and all(self.is_static(a) for a in node.args
                            if not isinstance(a, ast.Starred))
                    and all(self.is_static(k.value)
                            for k in node.keywords))
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return all(self.is_static(e) for e in node.elts)
        return False


class _ScopeChecker(ast.NodeVisitor):
    """Apply the rules inside one round-scope function body."""

    def __init__(self, path: str, src_lines: list[str],
                 static: _Static, findings: list[AstFinding]):
        self.path = path
        self.lines = src_lines
        self.static = static
        self.findings = findings

    def _suppressed(self, line: int, rule: str) -> bool:
        if 1 <= line <= len(self.lines):
            m = _IGNORE_RE.search(self.lines[line - 1])
            if m:
                return rule in {r.strip() for r in m.group(1).split(",")}
        return False

    def _flag(self, node: ast.AST, rule: str, detail: str) -> None:
        line = getattr(node, "lineno", 0)
        if not self._suppressed(line, rule):
            self.findings.append(AstFinding(rule, self.path, line, detail))

    def visit_If(self, node: ast.If) -> None:
        if not self.static.is_static(node.test):
            self._flag(node, "tensor-branch",
                       "python `if` on a possibly-tensor value is a hidden "
                       "host read — use torch.where or SyncCounter "
                       f"(test: {ast.unparse(node.test)!r})")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        if not self.static.is_static(node.test):
            self._flag(node, "tensor-branch",
                       "python `while` on a possibly-tensor value is a "
                       "hidden host read a pass — read it through "
                       f"SyncCounter (test: {ast.unparse(node.test)!r})")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in ("float", "int", "bool"):
            if node.args and not self.static.is_static(node.args[0]):
                self._flag(node, "host-sync",
                           f"`{fn.id}()` of a possibly-tensor value is a "
                           "host read outside SyncCounter "
                           f"({ast.unparse(node.args[0])!r})")
        if isinstance(fn, ast.Attribute) and fn.attr in _HOST_METHODS:
            if not self.static.is_static(fn.value):
                self._flag(node, "host-sync",
                           f"`.{fn.attr}()` of a possibly-tensor value is a "
                           "device->host read outside SyncCounter "
                           f"({ast.unparse(fn.value)!r})")
        self.generic_visit(node)


def _iter_scopes(tree: ast.Module, patterns: tuple[str, ...]):
    """Yield (qualname, FunctionDef) for every round scope in a file."""
    from fnmatch import fnmatch

    def walk(body, prefix, active):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{node.name}"
                hit = active or any(
                    fnmatch(node.name, p) or fnmatch(qual, p)
                    for p in patterns)
                if hit:
                    yield qual, node
                yield from walk(node.body, f"{qual}.", hit)
            elif isinstance(node, ast.ClassDef):
                yield from walk(node.body, f"{node.name}.", active)

    yield from walk(tree.body, "", False)


def _scope_static_names(fn: ast.FunctionDef) -> frozenset[str]:
    """Static names for one scope: the global bases minus any parameter
    that shadows them (a parameter is tensor data unless it is a known
    host value such as ``cfg``/``prims``/``cnt``)."""
    params = {a.arg for a in (fn.args.posonlyargs + fn.args.args
                              + fn.args.kwonlyargs)}
    if fn.args.vararg:
        params.add(fn.args.vararg.arg)
    return frozenset((STATIC_BASES | KEEP_STATIC) - (params - KEEP_STATIC))


def lint_file(path: Path, repo_root: Path,
              patterns: tuple[str, ...]) -> list[AstFinding]:
    rel = str(path.relative_to(repo_root))
    src = path.read_text()
    tree = ast.parse(src, filename=rel)
    lines = src.splitlines()
    # module-level defs, classes and constants are host objects
    module_names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            module_names.add(node.name)
        elif isinstance(node, ast.Assign):
            module_names.update(t.id for t in node.targets
                                if isinstance(t, ast.Name))
    findings: list[AstFinding] = []
    seen_spans: set[tuple[int, int]] = set()
    for _qual, fn in _iter_scopes(tree, patterns):
        span = (fn.lineno, fn.end_lineno or fn.lineno)
        # a nested def already covered by its parent scope: lint only the
        # outermost matching span
        if any(a <= span[0] and span[1] <= b for a, b in seen_spans):
            continue
        seen_spans.add(span)
        protected = _scope_static_names(fn)
        static = _Static(protected | frozenset(module_names))
        static.absorb_assignments(fn.body, protected=protected)
        checker = _ScopeChecker(rel, lines, static, findings)
        for stmt in fn.body:
            checker.visit(stmt)
    return findings


def _lint_graphdelta(repo_root: Path) -> list[AstFinding]:
    """GraphDelta must be built via make_delta (weights checked on the
    host before the device), everywhere but its defining module."""
    findings: list[AstFinding] = []
    allow = {"src/repro_torch/core/sssp/dynamic.py"}
    for path in sorted((repo_root / "src" / "repro_torch").rglob("*.py")):
        rel = str(path.relative_to(repo_root))
        if rel in allow:
            continue
        src = path.read_text()
        if "GraphDelta(" not in src:
            continue
        tree = ast.parse(src, filename=rel)
        lines = src.splitlines()
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "GraphDelta"):
                m = _IGNORE_RE.search(lines[node.lineno - 1])
                if m and "raw-graphdelta" in m.group(1):
                    continue
                findings.append(AstFinding(
                    "raw-graphdelta", rel, node.lineno,
                    "GraphDelta constructed directly — use make_delta "
                    "(checks edge ids and weights on the host first)"))
    return findings


def run(repo_root: str | Path) -> list[AstFinding]:
    """Run every AST rule over the port; returns all findings."""
    root = Path(repo_root)
    findings: list[AstFinding] = []
    for rel, patterns in ROUND_SCOPES.items():
        path = root / rel
        if path.exists():
            findings.extend(lint_file(path, root, patterns))
    findings.extend(_lint_graphdelta(root))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))
