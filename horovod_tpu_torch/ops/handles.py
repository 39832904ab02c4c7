"""Integer handles for negotiated collectives (port of
horovod_tpu/ops/handles.py; ≙ horovod/torch/handle_manager.cc).

A handle is "pending" from enqueue until the background thread has
executed its response; then it carries a result or a
:class:`HorovodError`, and on a GPU the CUDA event recorded on the
executor's stream after the collective's last kernel.  Until then it keeps
the tensors the collective reads and writes alive (≙ the reference's
``_handle_map``, torch/mpi_ops.py:27-30).
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, Optional


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


class HandleManager:
    """Allocates handles and retires them on ``release``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._handles: Dict[int, Handle] = {}  # guarded by _lock

    def allocate(self, name: str, home=None, keep: Any = None) -> Handle:
        with self._lock:
            h = Handle(next(self._ids), name, home, keep)
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

    def live_count(self) -> int:
        with self._lock:
            return len(self._handles)
