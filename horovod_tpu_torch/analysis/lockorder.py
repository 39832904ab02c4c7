"""Runtime lock-order (inversion) detector (copied from
horovod_tpu/analysis/lockorder.py:1-193).

Third pass of the ``hvd-analyze`` subsystem (docs/analysis.md): a
drop-in instrumented ``threading.Lock``/``RLock`` that records the
global lock-acquisition graph and raises the moment any acquisition
would close a cycle — i.e. thread 1 acquired A→B somewhere while
thread 2 now tries B→A.  Classic potential-deadlock detection (the
"lockdep" idea from the Linux kernel, applied TLA+-style: verify the
*ordering discipline*, not one lucky interleaving), so a single-threaded
test run still proves the discipline that a production race would need
to violate.

The runtime creates every internal lock through :func:`make_lock` /
:func:`make_rlock`; with ``HVD_TPU_LOCK_CHECK=1`` in the environment at
creation time those return checked wrappers, otherwise the plain
``threading`` primitives with zero overhead.  The whole tier-1 suite
runs with the checker on (tests/conftest.py arms it).

The graph is name-keyed, not object-keyed: every ``PyCoordinator._lock``
is one node, so an inversion between *classes* of locks is caught even
when the two interleavings involve different instances.  Pass a unique
name when instances genuinely have independent ordering.

One change from the reference: a thread that re-enters the recorder
while it holds the graph's own lock -- a ``weakref.finalize`` callback
the garbage collector runs inside the recording (the memory ledger's
frees are such callbacks) taking a checked lock -- records the hold and
skips the graph, where the reference's non-reentrant graph lock would
deadlock the thread against itself.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set


class LockOrderError(RuntimeError):
    """An acquisition would create a cycle in the lock-order graph."""


# name -> set of names it was ever held BEFORE (edge a->b: a held while
# acquiring b).  Guarded by _graph_lock; the checker's own lock is
# deliberately a plain threading.Lock (it can't check itself).
_graph: Dict[str, Set[str]] = {}
_graph_edges_sites: Dict[tuple, str] = {}
_graph_lock = threading.Lock()
_tls = threading.local()


def _held_stack() -> List[str]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS path src -> dst in the edge graph (callers hold _graph_lock)."""
    seen = {src}
    todo = [(src, [src])]
    while todo:
        node, path = todo.pop()
        for nxt in _graph.get(node, ()):
            if nxt == dst:
                return path + [nxt]
            if nxt not in seen:
                seen.add(nxt)
                todo.append((nxt, path + [nxt]))
    return None


def _record_acquire(name: str) -> None:
    """Add edges held→name; raise LockOrderError on a would-be cycle."""
    stack = _held_stack()
    if name in stack or getattr(_tls, "in_graph", False):
        # Reentrant acquisition (RLock) — no new ordering information;
        # or a finalizer run inside this thread's own graph update.
        stack.append(name)
        return
    with _graph_section():
        for held in set(stack):
            if held == name:
                continue
            # Would name -> ... -> held close a cycle with held -> name?
            path = _find_path(name, held)
            if path is not None:
                fwd = " -> ".join(path)
                site = _graph_edges_sites.get((path[0], path[1]), "?")
                raise LockOrderError(
                    f"lock-order inversion: acquiring {name!r} while "
                    f"holding {held!r}, but the reverse order "
                    f"{fwd} was already established (first at {site}). "
                    f"Two threads taking these locks in opposite orders "
                    f"can deadlock.")
            edge = (held, name)
            if name not in _graph.get(held, set()):
                _graph.setdefault(held, set()).add(name)
                import traceback

                frame = traceback.extract_stack(limit=8)
                # Innermost frame outside this module names the call site.
                site = next((f"{f.filename}:{f.lineno}"
                             for f in reversed(frame)
                             if "lockorder" not in f.filename), "?")
                _graph_edges_sites[edge] = site
                # New-edge breadcrumb for the hvd-telemetry flight ring
                # (telemetry/flight.py is stdlib-only, so this lazy
                # import cannot cycle back through make_lock).  New
                # edges appear a handful of times per process lifetime.
                try:
                    from ..telemetry import flight as _flight

                    _flight.record("lock_edge", held, name, site)
                except Exception:  # noqa: BLE001 — observability only
                    pass
    stack.append(name)


class _graph_section:
    """``_graph_lock`` held, with this thread marked as inside it (see
    the module docstring: a finalizer that re-enters must not block)."""

    def __enter__(self):
        _graph_lock.acquire()
        _tls.in_graph = True

    def __exit__(self, *exc) -> None:
        _tls.in_graph = False
        _graph_lock.release()


def _record_release(name: str) -> None:
    stack = _held_stack()
    # Release the most recent matching acquisition (locks are almost
    # always released LIFO; out-of-order release is tolerated).
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] == name:
            del stack[i]
            return


class _CheckedBase:
    """Shared acquire/release bookkeeping over a real threading lock."""

    def __init__(self, name: str, inner) -> None:
        self._name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # Record BEFORE blocking: the ordering violation exists whether
        # or not this particular acquisition would have blocked.
        _record_acquire(self._name)
        got = self._inner.acquire(blocking, timeout)
        if not got:
            _record_release(self._name)
        return got

    def release(self) -> None:
        self._inner.release()
        _record_release(self._name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # aids debugging lock dumps
        return f"<{type(self).__name__} {self._name!r} {self._inner!r}>"


class CheckedLock(_CheckedBase):
    def __init__(self, name: str) -> None:
        super().__init__(name, threading.Lock())


class CheckedRLock(_CheckedBase):
    def __init__(self, name: str) -> None:
        super().__init__(name, threading.RLock())


def enabled() -> bool:
    """True when HVD_TPU_LOCK_CHECK=1 (read per call so tests can flip
    it before constructing the locks under test)."""
    return os.environ.get("HVD_TPU_LOCK_CHECK") == "1"


def make_lock(name: str):
    """A ``threading.Lock`` — checked when HVD_TPU_LOCK_CHECK=1."""
    return CheckedLock(name) if enabled() else threading.Lock()


def make_rlock(name: str):
    """A ``threading.RLock`` — checked when HVD_TPU_LOCK_CHECK=1."""
    return CheckedRLock(name) if enabled() else threading.RLock()


def reset() -> None:
    """Drop the recorded acquisition graph (test isolation)."""
    with _graph_section():
        _graph.clear()
        _graph_edges_sites.clear()


def graph_snapshot() -> Dict[str, Set[str]]:
    """Copy of the current lock-order graph (observability/debugging)."""
    with _graph_section():
        return {k: set(v) for k, v in _graph.items()}
