"""Thread-role contracts: ``# thread: <role>`` annotations, checked
statically and asserted dynamically (copied from
horovod_tpu/analysis/threads.py:1-180).

The runtime's threading contracts have so far lived in prose — the
serving engine's docstring says "the data plane is driven from ONE
thread" and "``abort_all`` is serve-loop-only under multiprocess", the
prefetch stager and checkpoint writer each own their queues by
convention.  This pass makes those contracts machine-checked:

**Annotations.**  A trailing ``# thread: <role>`` comment on a ``def``
line declares "this method runs on the <role> thread".  Canonical
roles match the runtime's thread names: ``serve-loop``, ``drain``,
``rx``, ``stager``, ``writer``, ``ticker``, ``exporter``, ``accept``.
A call FROM a method of role A TO a method declared role B (B ≠ A) is
a **thread-role** finding unless the call line carries a handoff
marker — ``# thread: handoff(<how>)`` documents the mechanism that
moves the work across (a queue put, an event set, an enqueue) — or a
``# lint: ok(...)`` waiver.  Run via
``python -m horovod_tpu_torch.analysis --strict`` alongside the lint rules.

**Dynamic asserts.**  Thread-creation sites stamp their target's role
with :func:`set_role` (first line of the thread's loop); annotated
entry points call :func:`require`.  With ``HVD_TPU_RACE_CHECK=1`` a
stamped thread entering a method of a different role raises
:class:`ThreadRoleError` naming the method, its declared role, and
the calling thread's stamped role + name, and flight-records the
event.  UNSTAMPED threads always pass: the contracts constrain the
runtime's own fleet, while user/main threads remain free to drive the
single-process API (the engine docstring's "single-process callers may
treat it like the rest of the drain family").  Each verification bumps
the ``analysis.thread_role_asserts`` counter.  Zero overhead when
disarmed: :func:`require` is one env-var read.
"""

from __future__ import annotations

import ast
import os
import re
import threading
from typing import Dict, List, Optional, Tuple

from . import lint as _lint
from .lint import Finding

# Roles mirror the fleet's thread names (core/state tick, transport rx,
# input stager, checkpoint writer, serve loop, tree ticker, exporter).
ROLES = ("serve-loop", "drain", "rx", "stager", "writer", "ticker",
         "exporter", "accept")

_THREAD_RE = re.compile(r"#\s*thread:\s*([a-z][a-z0-9-]*)\b")
_HANDOFF_RE = re.compile(r"#\s*thread:\s*handoff\((.*?)\)")

_tls = threading.local()


class ThreadRoleError(RuntimeError):
    """A thread stamped with one role entered a method declared
    ``# thread: <other role>``."""


_n_asserts = 0


def assert_count() -> int:
    """Total dynamic role verifications (telemetry pull side)."""
    return _n_asserts


def enabled() -> bool:
    """Dynamic asserts share the race detector's switch
    (HVD_TPU_RACE_CHECK=1), read per call."""
    return os.environ.get("HVD_TPU_RACE_CHECK") == "1"


def set_role(role: str) -> None:
    """Stamp the current thread's role (call once, first line of the
    thread's loop).  Cheap enough to run unconditionally."""
    _tls.role = role


def current_role() -> Optional[str]:
    return getattr(_tls, "role", None)


def require(role: str, what: str = "") -> None:
    """Assert the current thread is unstamped or stamped ``role``.

    Annotated entry points call this; disarmed it is one env read.
    Unstamped (user/main) threads pass — the runtime's own fleet is
    what the contracts constrain.
    """
    if not enabled():
        return
    have = getattr(_tls, "role", None)
    # Plain-int count (GIL-tolerant): require() may run under arbitrary
    # runtime locks, so it must not take the telemetry registry's —
    # telemetry pulls this via its `analysis` collector.
    global _n_asserts
    _n_asserts += 1
    if have is None or have == role:
        return
    me = threading.current_thread().name
    msg = (f"thread-role violation: {what or 'method'} is declared "
           f"`# thread: {role}` but was entered on thread {me!r} "
           f"stamped role {have!r}; hand the work off (queue/event) "
           f"instead of calling across roles")
    try:
        from ..telemetry import flight as _flight

        _flight.record("thread_role", what or "?", role, have, me)
        _flight.dump("thread-role", extra={
            "what": what, "declared_role": role, "thread_role": have,
            "thread": me})
    except Exception:  # noqa: BLE001 — forensics only
        pass
    raise ThreadRoleError(msg)


# ---------------------------------------------------------------------------
# Static pass


def _decl_role(fi, node: ast.AST) -> Optional[str]:
    """Role declared by a trailing ``# thread: <role>`` on the def
    line (handoff markers are not declarations)."""
    text = fi.comments.get(node.lineno, "")
    if _HANDOFF_RE.search(text):
        return None
    m = _THREAD_RE.search(text)
    if m and m.group(1) != "handoff":
        return m.group(1)
    return None


def check_infos(infos: Dict[str, "_lint._FileInfo"]) -> List[Finding]:
    """thread-role rule over pre-scanned files: a role-A method calling
    a role-B method (terminal-name match across the whole linted set)
    without a handoff marker on the call line."""
    # method name -> (role, path, line).  Terminal-name keyed, like the
    # lint pass's producer resolution; only annotated methods partake,
    # so the namespace stays small enough for that to be sound.
    declared: Dict[str, Tuple[str, str, int]] = {}
    annotated: List[Tuple["_lint._FileInfo", ast.FunctionDef, str]] = []
    for fi in infos.values():
        for node in ast.walk(fi.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                role = _decl_role(fi, node)
                if role:
                    declared[node.name] = (role, fi.path, node.lineno)
                    annotated.append((fi, node, role))
    findings: List[Finding] = []
    for fi, func, role in annotated:
        for node in ast.walk(func):
            if not isinstance(node, ast.Call):
                continue
            name = _lint._terminal_name(node.func)
            if name is None or name == func.name:
                continue
            decl = declared.get(name)
            if decl is None or decl[0] == role:
                continue
            line_text = fi.comments.get(node.lineno, "")
            if _HANDOFF_RE.search(line_text):
                continue
            if _lint.waiver_hit(fi, node.lineno):
                continue
            findings.append(Finding(
                fi.path, node.lineno, "thread-role",
                f"{func.name}() runs on the {role!r} thread but calls "
                f"{name}() which is declared `# thread: {decl[0]}` "
                f"({decl[1]}:{decl[2]}); cross-role work needs a "
                f"handoff — mark the line `# thread: handoff(<how>)` "
                f"once it goes through a queue/event"))
    findings.sort(key=lambda f: (f.path, f.line))
    return findings


def check_sources(sources: Dict[str, str]) -> List[Finding]:
    return check_infos(_lint.scan_sources(sources))
