"""AST-based lock-discipline and SPMD-divergence linter (copied from
horovod_tpu/analysis/lint.py:1-439; the rule set is the reference's).

Second pass of the ``hvd-analyze`` subsystem (docs/analysis.md),
runnable as ``python -m horovod_tpu_torch.analysis [--strict] [paths]``.
Three rules, each targeting a bug class this codebase has actually
shipped (see CHANGES.md) or that the reference could only discover as a
60 s stall:

* **guarded-by** — fields annotated ``# guarded_by: <lock>`` (on the
  dataclass field or the ``self.x = ...`` line in ``__init__``) must
  only be touched inside a lexical ``with <lock>:`` block.  Receivers
  are resolved statically: ``self`` inside the defining class, and any
  variable assigned from a function whose return annotation names an
  annotated class (e.g. ``st = global_state()`` →
  ``_GlobalState``), across every linted file.  Methods whose name ends
  in ``_locked`` assert the caller holds the lock and are exempt, as is
  ``__init__`` (no concurrent access during construction).

* **blocking-under-lock** — calls that can block indefinitely
  (``time.sleep``, ``socket.recv``/``accept``, future ``.result()``,
  frame receives, ``synchronize``) inside a lexical ``with <lock>:``
  region.  A blocked holder starves every other thread; the
  coordinator's 5 ms tick turns that into a job-wide stall.

* **rank-conditioned-collective** — collective calls lexically inside a
  branch conditioned on ``rank()`` / ``local_rank()`` /
  ``process_index()``: the classic SPMD divergence bug (only some ranks
  enter the collective, the rest stall for 60 s then die).

A finding line may carry ``# lint: ok(<why>)`` to waive it — the waiver
text is the audit trail.  Waivers are themselves audited: a waiver
comment on a line that no longer triggers ANY rule (of any pass — this
one or thread-role) is reported as a
**stale-waiver** finding by :func:`horovod_tpu_torch.analysis.analyze_sources`
so dead waivers cannot accumulate silently and mask a future
regression on the same line.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

_GUARDED_RE = re.compile(r"#\s*guarded_by:\s*([A-Za-z_][A-Za-z0-9_]*)")
_WAIVER_RE = re.compile(r"#\s*lint:\s*ok\((.*?)\)")

# Terminal attribute/function names that block indefinitely.
BLOCKING_CALLS = {"sleep", "recv", "recv_into", "accept", "result",
                  "_recv_frame", "synchronize"}

# Public collective entry points (every frontend alias funnels into
# these names).
COLLECTIVE_CALLS = {
    "allreduce", "allreduce_async", "allgather", "allgather_async",
    "broadcast", "broadcast_async", "alltoall", "alltoall_async",
    "reducescatter", "reducescatter_async", "barrier",
    "grouped_allreduce", "grouped_allreduce_async",
    "grouped_allgather", "grouped_allgather_async",
    "grouped_reducescatter", "grouped_reducescatter_async",
    "allgather_object", "broadcast_object", "broadcast_parameters",
    "broadcast_variables", "broadcast_optimizer_state",
}

# Rank-valued callables: an `if` whose test calls one of these guards a
# rank-divergent branch.
RANK_CALLS = {"rank", "local_rank", "cross_rank", "process_index",
              "replica_id"}


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class _ClassInfo:
    name: str
    guarded: Dict[str, str] = field(default_factory=dict)  # field -> lock


@dataclass
class _FileInfo:
    path: str
    tree: ast.AST
    comments: Dict[int, str]           # line -> comment text
    own_line: Set[int] = field(default_factory=set)
    classes: Dict[str, _ClassInfo] = field(default_factory=dict)
    producers: Dict[str, str] = field(default_factory=dict)  # fn -> class
    # Module-level singletons: `_state = _GlobalState()` → var -> class.
    module_vars: Dict[str, str] = field(default_factory=dict)
    # Waiver comments: line -> reason, and the subset a rule (of any
    # pass) actually suppressed — the difference is the stale-waiver
    # report.
    waivers: Dict[int, str] = field(default_factory=dict)
    used_waivers: Set[int] = field(default_factory=set)


def waiver_hit(fi: "_FileInfo", line: int) -> bool:
    """True (and marks the waiver used) when ``line`` carries a
    ``# lint: ok(...)`` waiver.  Shared by every static pass so the
    stale-waiver audit sees cross-pass usage."""
    if line in fi.waivers:
        fi.used_waivers.add(line)
        return True
    return False


def _terminal_name(node: ast.AST) -> Optional[str]:
    """`a.b.c` -> 'c'; `c` -> 'c'; anything else -> None."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _collect_comments(source: str) -> Tuple[Dict[int, str], Set[int]]:
    """line -> comment text, plus the lines that are comment-ONLY (a
    trailing comment annotates its own statement; only a comment-only
    line annotates the statement below it)."""
    comments: Dict[int, str] = {}
    own_line: Set[int] = set()
    lines = source.splitlines()
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                line = tok.start[0]
                comments[line] = tok.string
                if line <= len(lines) and \
                        not lines[line - 1][:tok.start[1]].strip():
                    own_line.add(line)
    except tokenize.TokenError:
        pass
    return comments, own_line


def _guard_for(stmt: ast.stmt, comments: Dict[int, str],
               own_line: Set[int]) -> Optional[str]:
    """guarded_by lock named in a comment on any line of ``stmt``, or in
    a comment-ONLY line directly above it (leading-comment convention —
    a trailing comment annotates its own line's statement only)."""
    lines = list(range(stmt.lineno, (stmt.end_lineno or stmt.lineno) + 1))
    if stmt.lineno - 1 in own_line:
        lines.insert(0, stmt.lineno - 1)
    for line in lines:
        text = comments.get(line)
        if text:
            m = _GUARDED_RE.search(text)
            if m:
                return m.group(1)
    return None


def _scan_file(path: str, source: str) -> Optional[_FileInfo]:
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return None
    comments, own_line = _collect_comments(source)
    info = _FileInfo(path=path, tree=tree, comments=comments,
                     own_line=own_line)
    for line, text in comments.items():
        m = _WAIVER_RE.search(text)
        if m:
            info.waivers[line] = m.group(1)
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            ci = _ClassInfo(name=node.name)
            for stmt in node.body:
                tgt = None
                if isinstance(stmt, ast.AnnAssign) and \
                        isinstance(stmt.target, ast.Name):
                    tgt = stmt.target.id
                elif isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name):
                    tgt = stmt.targets[0].id
                if tgt is not None:
                    lock = _guard_for(stmt, info.comments, info.own_line)
                    if lock:
                        ci.guarded[tgt] = lock
                if isinstance(stmt, ast.FunctionDef) and \
                        stmt.name == "__init__":
                    for sub in ast.walk(stmt):
                        if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                            targets = (sub.targets
                                       if isinstance(sub, ast.Assign)
                                       else [sub.target])
                            for t in targets:
                                if isinstance(t, ast.Attribute) and \
                                        isinstance(t.value, ast.Name) and \
                                        t.value.id == "self":
                                    lock = _guard_for(sub, info.comments, info.own_line)
                                    if lock:
                                        ci.guarded[t.attr] = lock
            if ci.guarded:
                info.classes[node.name] = ci
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ret = node.returns
            cls = _terminal_name(ret) if ret is not None else None
            if cls:
                info.producers[node.name] = cls
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name) and \
                isinstance(stmt.value, ast.Call):
            cls = _terminal_name(stmt.value.func)
            if cls:
                info.module_vars[stmt.targets[0].id] = cls
    return info


class _RuleWalker(ast.NodeVisitor):
    """Single traversal applying all three rules to one function body."""

    def __init__(self, fi: _FileInfo, registry: Dict[str, _ClassInfo],
                 producers: Dict[str, str], enclosing_class: Optional[str],
                 func: ast.FunctionDef, findings: List[Finding]) -> None:
        self.fi = fi
        self.registry = registry
        self.producers = producers
        self.enclosing_class = enclosing_class
        self.func = func
        self.findings = findings
        self.lock_stack: List[str] = []
        self.rank_branch_depth = 0
        # var name -> class name: module-level singletons of this file,
        # then producer-typed locals layered on top.
        self.var_types: Dict[str, str] = {
            v: c for v, c in fi.module_vars.items() if c in registry}
        self.in_init = func.name in ("__init__", "__del__")
        self.locked_method = func.name.endswith("_locked")

    # -- helpers -----------------------------------------------------------

    def _waived(self, line: int) -> bool:
        return waiver_hit(self.fi, line)

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        if not self._waived(node.lineno):
            self.findings.append(Finding(self.fi.path, node.lineno, rule,
                                         message))

    def _receiver_class(self, node: ast.expr) -> Optional[str]:
        if isinstance(node, ast.Name):
            if node.id == "self":
                return self.enclosing_class
            return self.var_types.get(node.id)
        if isinstance(node, ast.Call):
            fn = _terminal_name(node.func)
            if fn in self.producers:
                return self.producers[fn]
            if fn in self.registry:  # direct construction
                return fn
        return None

    def _is_rank_test(self, test: ast.expr) -> bool:
        for sub in ast.walk(test):
            if isinstance(sub, ast.Call):
                name = _terminal_name(sub.func)
                if name in RANK_CALLS:
                    return True
            # st.process_index / req.request_rank style comparisons.
            if isinstance(sub, ast.Attribute) and \
                    sub.attr in ("process_index", "request_rank"):
                return True
        return False

    # -- traversal ---------------------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if node is self.func:
            self.generic_visit(node)
        # Nested defs get their own walker from the caller; their bodies
        # execute later, outside this lexical lock region.

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign) -> None:
        if isinstance(node.value, ast.Call):
            cls = self._receiver_class(node.value)
            if cls and cls in self.registry:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.var_types[t.id] = cls
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        names = []
        for item in node.items:
            self.visit(item.context_expr)
            name = _terminal_name(item.context_expr)
            # Conditions wrap their mutex: `with self._cond:` holds it.
            if name and ("lock" in name.lower() or "cond" in name.lower()):
                names.append(name)
        self.lock_stack.extend(names)
        for stmt in node.body:
            self.visit(stmt)
        for _ in names:
            self.lock_stack.pop()

    def visit_If(self, node: ast.If) -> None:
        self.visit(node.test)
        ranky = self._is_rank_test(node.test)
        if ranky:
            self.rank_branch_depth += 1
        for stmt in node.body + node.orelse:
            self.visit(stmt)
        if ranky:
            self.rank_branch_depth -= 1

    def visit_Attribute(self, node: ast.Attribute) -> None:
        cls = self._receiver_class(node.value)
        if cls:
            ci = self.registry.get(cls)
            if ci and node.attr in ci.guarded:
                lock = ci.guarded[node.attr]
                held = lock in self.lock_stack
                exempt = (self.locked_method or
                          (self.in_init and isinstance(node.value, ast.Name)
                           and node.value.id == "self"))
                if not held and not exempt:
                    self._emit(
                        node, "guarded-by",
                        f"{cls}.{node.attr} is guarded_by {lock!r} but "
                        f"accessed outside any `with {lock}:` block "
                        f"(in {self.func.name})")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        name = _terminal_name(node.func)
        if name in BLOCKING_CALLS and self.lock_stack:
            self._emit(
                node, "blocking-under-lock",
                f"potentially-blocking call {name}() inside a "
                f"`with {self.lock_stack[-1]}:` region (in "
                f"{self.func.name}); a blocked holder stalls every "
                f"waiter")
        if name in COLLECTIVE_CALLS and self.rank_branch_depth > 0:
            self._emit(
                node, "rank-conditioned-collective",
                f"collective {name}() inside a rank-conditioned branch "
                f"(in {self.func.name}); only some ranks reach it — the "
                f"classic SPMD divergence stall")
        self.generic_visit(node)


def _walk_functions(fi: _FileInfo, registry: Dict[str, _ClassInfo],
                    producers: Dict[str, str],
                    findings: List[Finding]) -> None:
    def visit_body(body, enclosing_class):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walker = _RuleWalker(fi, registry, producers,
                                     enclosing_class, node, findings)
                walker.generic_visit(node)
                # Nested function defs each get a fresh walker (fresh
                # lock/rank context — they run later, elsewhere).
                inner = [n for n in ast.walk(node)
                         if isinstance(n, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))
                         and n is not node]
                for sub in inner:
                    w = _RuleWalker(fi, registry, producers,
                                    enclosing_class, sub, findings)
                    w.generic_visit(sub)
            elif isinstance(node, ast.ClassDef):
                visit_body(node.body, node.name)

    visit_body(fi.tree.body, None)  # type: ignore[attr-defined]


def scan_sources(sources: Dict[str, str]) -> Dict[str, "_FileInfo"]:
    """Parse a {path: source} mapping into per-file scan info (comments,
    annotations, waivers).  The other static passes (thread-role,
    post-donation-read) and the stale-waiver audit run over the same
    scan so waiver usage aggregates across passes."""
    return {fi.path: fi
            for fi in (_scan_file(p, s) for p, s in sorted(sources.items()))
            if fi is not None}


def lint_infos(infos: Dict[str, "_FileInfo"]) -> List[Finding]:
    """Run the three lint rules over pre-scanned files (marking used
    waivers on each :class:`_FileInfo` as a side effect)."""
    registry: Dict[str, _ClassInfo] = {}
    producers: Dict[str, str] = {}
    for fi in infos.values():
        registry.update(fi.classes)
    for fi in infos.values():
        for fn, cls in fi.producers.items():
            if cls in registry:
                producers[fn] = cls
    findings: List[Finding] = []
    for fi in infos.values():
        _walk_functions(fi, registry, producers, findings)
    findings.sort(key=lambda f: (f.path, f.line))
    return findings


def lint_sources(sources: Dict[str, str]) -> List[Finding]:
    """Lint a {path: source} mapping; annotations and producer functions
    are resolved across the whole set."""
    return lint_infos(scan_sources(sources))


def _iter_py_files(paths: List[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git", "build")]
                out.extend(os.path.join(root, f) for f in files
                           if f.endswith(".py"))
    return sorted(set(out))


def lint_paths(paths: List[str]) -> List[Finding]:
    sources: Dict[str, str] = {}
    for path in _iter_py_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as f:
                sources[path] = f.read()
        except OSError:
            continue
    return lint_sources(sources)
