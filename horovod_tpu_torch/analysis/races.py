"""Lockset (Eraser-style) data-race detector for the runtime's shared
objects (copied from horovod_tpu/analysis/races.py:1-318).

Fourth pass of the ``hvd-analyze`` subsystem (docs/analysis.md).  The
lint pass already checks ``# guarded_by:`` annotations *lexically* —
accesses it can type statically, inside a literal ``with lock:`` block.
This module enforces the same annotations *dynamically*: with
``HVD_TPU_RACE_CHECK=1`` in the environment at import time, the
:func:`race_checked` class decorator (applied to the runtime's shared
classes — coordinator, transports, tree overlay, response cache,
serving scheduler/KV cache, telemetry registry, memory ledger, trace
clock) replaces every annotated field with a tracking descriptor and
runs the classic Eraser state machine per (instance, field):

* **first-touch exemption** — while only the creating thread has ever
  touched a field, no locks are required (``__init__`` and
  single-threaded phases are silent);
* **read-share state** — a second thread *reading* moves the field to
  the shared state and initializes its **candidate lockset** to the
  locks that thread holds; every later access intersects the lockset
  with the accessor's held locks;
* **shared-modified** — a write from any thread other than the first
  makes the field shared-modified; if the candidate lockset is (or
  becomes) empty there, the access is a data race: no single lock
  protected every access.

A race raises :class:`DataRaceError` in the accessing thread, naming
the class.field, the annotated lock, BOTH threads and both stack
tails, and flight-records the event (``telemetry/flight.py``) with the
standard metrics tail so post-mortem dumps are self-contained.

Held-lock identity comes from the lock-order detector's thread-local
acquisition stack (``analysis/lockorder.py``) — the two checkers share
one switchboard: arming ``HVD_TPU_RACE_CHECK=1`` only observes locks
created as checked locks, so the race-check legs run with
``HVD_TPU_LOCK_CHECK=1`` as well (tests/conftest.py arms both).  Like
the lock-order graph, locksets are lock-NAME keyed: two instances'
``_lock`` of the same class are one name, so the checker proves the
locking *discipline*, not one instance's interleaving.

Zero overhead when disarmed: :func:`race_checked` returns the class
untouched unless the env was set when the class was defined.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Dict, Optional, Set

from . import lockorder as _lockorder

_RACE_ENV = "HVD_TPU_RACE_CHECK"

# Eraser states (per instance x field).
_EXCLUSIVE = 0       # only the first-touch thread has ever accessed
_SHARED = 1          # >= 2 threads, reads only since the transition
_SHARED_MOD = 2      # >= 2 threads with at least one non-owner write
_REPORTED = 3        # race already raised once; stay quiet after

_STATE_SLOT = "_hvd_race_states"

# Serializes state-machine transitions.  Deliberately a plain lock
# (the checker cannot check itself) and a leaf: nothing is acquired
# while holding it.
_machine_lock = threading.Lock()


class DataRaceError(RuntimeError):
    """Two threads accessed a ``# guarded_by:`` field with no common
    lock held (candidate-lockset intersection became empty on a
    write-shared field)."""


def enabled() -> bool:
    """True when HVD_TPU_RACE_CHECK=1 (read per call so tests can flip
    it before defining the classes under test)."""
    return os.environ.get(_RACE_ENV) == "1"


# Slow-path verification count.  A plain int bumped under
# ``_machine_lock`` — NOT a telemetry Counter: the registry's own
# fields are race-checked, so the checker calling ``counter().inc()``
# would re-enter ``MetricsRegistry._metric`` while a registry method
# already holds ``MetricsRegistry._lock`` (self-deadlock).  Telemetry
# PULLS this via its ``analysis`` collector instead
# (``analysis.race_checks`` gauge, telemetry/__init__.py).
_n_checks = 0


def check_count() -> int:
    """Total slow-path lockset verifications (telemetry pull side)."""
    return _n_checks


def _tail(limit: int = 5) -> str:
    """Short innermost-stack tail outside this module (race reports
    name where each thread touched the field, not the descriptor)."""
    frames = [f for f in traceback.extract_stack(limit=limit + 4)
              if "analysis/races" not in f.filename.replace("\\", "/")]
    return " <- ".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                       f"({f.name})" for f in reversed(frames[-limit:]))


def _held_names() -> Set[str]:
    return set(_lockorder._held_stack())


class _FieldState:
    __slots__ = ("state", "owner", "lockset", "peer_thread", "peer_tail",
                 "peer_write")

    def __init__(self, owner: int) -> None:
        self.state = _EXCLUSIVE
        self.owner = owner
        self.lockset: Optional[Set[str]] = None
        # The most recent access from a DIFFERENT thread than the
        # current accessor — the "other side" a race report names.
        self.peer_thread = ""
        self.peer_tail = ""
        self.peer_write = False


def _raise_race(cls_name: str, fld: str, lock: str, write: bool,
                peer_thread: str, peer_tail: str,
                peer_write: bool) -> None:
    """Flight-record + raise.  Runs OUTSIDE the state-machine lock (the
    flight dump walks the metrics registry, whose fields are themselves
    race-checked — calling out while holding ``_machine_lock`` would
    order it against every registry lock)."""
    me = threading.current_thread().name
    kind = "write" if write else "read"
    peer_kind = "write" if peer_write else "read"
    msg = (f"data race on {cls_name}.{fld} (guarded_by {lock!r}): "
           f"{kind} by thread {me!r} at [{_tail()}] with no lock in "
           f"common with the {peer_kind} by thread "
           f"{peer_thread!r} at [{peer_tail}] — the candidate "
           f"lockset is empty, so no single lock ordered these "
           f"accesses")
    try:
        from ..telemetry import flight as _flight

        _flight.record("data_race", f"{cls_name}.{fld}", lock, me,
                       peer_thread)
        _flight.dump("data-race", extra={
            "field": f"{cls_name}.{fld}", "guarded_by": lock,
            "thread": me, "peer_thread": peer_thread,
            "tail": _tail(), "peer_tail": peer_tail})
    except Exception:  # noqa: BLE001 — forensics only
        pass
    raise DataRaceError(msg)


# Reentrancy guard: the checker's own slow path calls out to telemetry
# and the flight recorder, whose classes are race-checked too — those
# nested accesses must observe, not re-enter, the state machine.
_tls = threading.local()


def _check(obj, fld: str, lock: str, cls_name: str, write: bool) -> None:
    tid = threading.get_ident()
    states: Dict[str, _FieldState] = obj.__dict__.get(_STATE_SLOT)  # type: ignore[assignment]
    if states is None:
        states = obj.__dict__.setdefault(_STATE_SLOT, {})
    s = states.get(fld)
    if s is None:
        with _machine_lock:
            s = states.setdefault(fld, _FieldState(tid))
        if s.owner == tid:
            return
    # Fast path: first-touch thread while still exclusive.
    if s.state == _EXCLUSIVE and s.owner == tid:
        return
    if s.state == _REPORTED:
        return
    if getattr(_tls, "in_check", False):
        return
    global _n_checks
    _tls.in_check = True
    try:
        held = _held_names()
        race = None  # (peer_thread, peer_tail, peer_write)
        with _machine_lock:
            _n_checks += 1
            if s.state == _REPORTED:
                return
            me = threading.current_thread().name
            if s.state == _EXCLUSIVE:
                if s.owner == tid:
                    return
                # Second thread: leave first-touch, seed the candidate
                # lockset from THIS access's held locks.
                s.lockset = set(held)
                s.state = _SHARED_MOD if write else _SHARED
                if write and not s.lockset:
                    # Unlocked write racing the first-touch thread: the
                    # peer side is the (unknown-stack) owner.
                    s.state = _REPORTED
                    race = (f"<first-touch thread {s.owner}>", "?", True)
                else:
                    s.peer_thread = me
                    s.peer_tail = _tail()
                    s.peer_write = write
            else:
                assert s.lockset is not None
                s.lockset &= held
                if write and s.state == _SHARED:
                    s.state = _SHARED_MOD
                if s.state == _SHARED_MOD and not s.lockset:
                    s.state = _REPORTED
                    race = (s.peer_thread, s.peer_tail, s.peer_write)
                elif me != s.peer_thread:
                    s.peer_thread = me
                    s.peer_tail = _tail()
                    s.peer_write = write
        if race is not None:
            _raise_race(cls_name, fld, lock, write, *race)
    finally:
        _tls.in_check = False


class _TrackedField:
    """Data descriptor standing in for one ``# guarded_by:`` field; the
    value itself lives in the instance ``__dict__`` under the same
    name (data descriptors take precedence on both get and set)."""

    __slots__ = ("fld", "lock", "cls_name", "default", "has_default")

    def __init__(self, fld: str, lock: str, cls_name: str,
                 default=None, has_default: bool = False) -> None:
        self.fld = fld
        self.lock = lock
        self.cls_name = cls_name
        self.default = default
        self.has_default = has_default

    def __get__(self, obj, objtype=None):
        if obj is None:
            # Class-level read (dataclass machinery, introspection).
            if self.has_default:
                return self.default
            return self
        _check(obj, self.fld, self.lock, self.cls_name, write=False)
        try:
            return obj.__dict__[self.fld]
        except KeyError:
            if self.has_default:
                return self.default
            raise AttributeError(
                f"{self.cls_name!r} object has no attribute "
                f"{self.fld!r}") from None

    def __set__(self, obj, value) -> None:
        _check(obj, self.fld, self.lock, self.cls_name, write=True)
        obj.__dict__[self.fld] = value

    def __delete__(self, obj) -> None:
        _check(obj, self.fld, self.lock, self.cls_name, write=True)
        try:
            del obj.__dict__[self.fld]
        except KeyError:
            raise AttributeError(self.fld) from None


def _annotated_fields(cls) -> Dict[str, str]:
    """``field -> lock`` from the class's ``# guarded_by:`` comments,
    resolved through the lint pass's scanner over the defining module's
    source (one parse per module, cached)."""
    import inspect
    import sys

    mod = sys.modules.get(cls.__module__)
    if mod is None:
        return {}
    cache = getattr(mod, "_hvd_race_scan_cache", None)
    if cache is None:
        from . import lint as _lint

        try:
            source = inspect.getsource(mod)
        except (OSError, TypeError):
            cache = {}
        else:
            fi = _lint._scan_file(getattr(mod, "__file__", "<mod>"),
                                  source)
            cache = {name: dict(ci.guarded)
                     for name, ci in (fi.classes if fi else {}).items()}
        try:
            mod._hvd_race_scan_cache = cache
        except Exception:  # noqa: BLE001 — frozen/odd modules
            pass
    return dict(cache.get(cls.__name__, {}))


def race_checked(cls):
    """Class decorator arming the lockset checker on every
    ``# guarded_by:`` field of ``cls``.  A no-op (returns ``cls``
    unchanged, zero overhead) unless ``HVD_TPU_RACE_CHECK=1`` was set
    when the class was defined — the same creation-time convention as
    :func:`analysis.lockorder.make_lock`.  Apply ABOVE ``@dataclass``
    so the descriptors install after the dataclass machinery ran."""
    if not enabled():
        return cls
    for fld, lock in _annotated_fields(cls).items():
        default = cls.__dict__.get(fld)
        has_default = (fld in cls.__dict__
                       and not hasattr(default, "__get__"))
        setattr(cls, fld, _TrackedField(
            fld, lock, cls.__name__, default=default,
            has_default=has_default))
    return cls


def states_of(obj) -> Dict[str, int]:
    """The per-field Eraser states of one instance (tests)."""
    return {k: v.state
            for k, v in (obj.__dict__.get(_STATE_SLOT) or {}).items()}
