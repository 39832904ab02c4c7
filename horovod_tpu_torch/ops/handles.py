"""Integer handles for negotiated collectives (port of
horovod_tpu/ops/handles.py; ≙ horovod/torch/handle_manager.cc).

A handle is "pending" from enqueue until the background thread has
executed its response; then it carries a result or a
:class:`HorovodError`, and on a GPU the CUDA event recorded on the
executor's stream after the collective's last kernel.  Until then it keeps
the tensors the collective reads and writes alive (≙ the reference's
``_handle_map``, torch/mpi_ops.py:27-30).

The ids come from the native handle manager (``native/handle_manager.cc``,
reference ops/handles.py:61-134), or from a Python counter that counts the
same way when ``HVD_TPU_DISABLE_NATIVE`` is set; the ``Handle`` objects,
their events and keep-alives stay here.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from typing import Any, Dict, Optional

from ..native import lib as _native
from ..analysis import lockorder as _lockorder
from ..analysis import races as _races


class HorovodError(RuntimeError):
    """A collective failed on every rank: cross-rank validation (≙ the
    reference's FailedPreconditionError from ERROR responses,
    operations.cc:1060-1067), a withdrawal, a shutdown or a failed
    collective call."""


class Handle:
    """One negotiated collective."""

    __slots__ = ("id", "name", "home", "done", "result", "error", "event",
                 "keep", "cache_hit")

    def __init__(self, hid: int, name: str, home=None,
                 keep: Any = None) -> None:
        self.id = hid
        self.name = name
        self.home = home  # the device the result returns to
        self.done = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.event = None  # torch.cuda.Event, or None on the CPU
        self.keep = keep
        # Its request was served from the response cache (a hit sent in
        # place of the request, ops/cache.py).
        self.cache_hit = False

    def finish(self, result: Any = None, event=None,
               error: Optional[BaseException] = None) -> None:
        """Store the outcome; the inputs are released."""
        self.result, self.event, self.error = result, event, error
        self.keep = None
        self.done.set()

    def completed(self) -> bool:
        """Executed, and (on a GPU) its kernels have run."""
        if not self.done.is_set():
            return False
        return self.error is not None or self.event is None \
            or self.event.query()


@_races.race_checked
class HandleManager:
    """Allocates handles and retires them on ``release``.  Ids count from
    0, natively or in Python."""

    def __init__(self) -> None:
        self._lock = _lockorder.make_lock("HandleManager._lock")
        self._handles: Dict[int, Handle] = {}  # guarded_by: _lock
        self._lib = _native.active()
        if self._lib is None:
            self._ids = itertools.count(0)
        else:
            self._hm = self._lib.hvd_handle_manager_create()
            weakref.finalize(self, self._lib.hvd_handle_manager_destroy,
                             self._hm)

    def allocate(self, name: str, home=None, keep: Any = None) -> Handle:
        with self._lock:
            hid = next(self._ids) if self._lib is None \
                else self._lib.hvd_handle_manager_allocate(self._hm)
            h = Handle(hid, name, home, keep)
            self._handles[h.id] = h
        return h

    def get(self, handle: int) -> Handle:
        with self._lock:
            h = self._handles.get(handle)
        if h is None:
            raise ValueError(f"Handle {handle} was not created or has "
                             f"already been cleared.")
        return h

    def release(self, handle: int) -> None:
        with self._lock:
            self._handles.pop(handle, None)
            if self._lib is not None:
                self._lib.hvd_handle_manager_mark_done(self._hm, handle)
                self._lib.hvd_handle_manager_release(self._hm, handle)

    def live_count(self) -> int:
        with self._lock:
            return len(self._handles)
