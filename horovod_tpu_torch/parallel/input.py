"""Device prefetch (port of horovod_tpu/parallel/input.py).

:func:`prefetch_to_device` wraps a host batch iterator in a background
stager: while step N computes, the stager pulls batch N+1 from the
loader, takes this rank's rows and copies them to the device, parking the
device batch in a bounded queue.  On a CUDA device the copy is
asynchronous and off the compute stream:

* the rows go to pinned host memory, then ``.to(device,
  non_blocking=True)`` on a dedicated CUDA stream;
* an event recorded after the copies is what the consumer's stream waits
  on before it reads the batch, so the host never blocks on the copy;
* each staged tensor is ``record_stream``-ed on the consumer's stream, so
  the caching allocator does not hand its memory to the stager's next
  copy while the step still reads it.

On the CPU the copy is a plain synchronous ``.to``, still on the stager
thread.  The contract is the reference's:

* **Ordering**: batches come out in the loader's order.
* **Bounded**: at most ``depth`` staged batches exist at once (plus the
  one the stager is producing).
* **Exceptions**: a loader exception is re-raised at the consuming
  ``next()`` with its original traceback, and recorded by
  ``telemetry.prefetch_error_event``.
* **Clean shutdown**: ``close()`` (also via the context manager, loop
  exhaustion or garbage collection) stops the stager, closes a generator
  loader and joins the thread, even mid-epoch with a full queue.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterable, Optional

import torch

from .. import telemetry as _telemetry
from .. import trace as _trace
from ..analysis import threads as _analysis_threads
from ..core import state as _state
from ..memory import ledger as _mem
from ..utils.tree import tree_leaves, tree_map

_END = object()  # queue sentinel (identity-compared)


class _Staged:
    """One staged device batch and the event its copies recorded.  A
    class, not a tuple: user batches may themselves be tuples."""

    __slots__ = ("batch", "event", "nbytes")

    def __init__(self, batch, event) -> None:
        self.batch = batch
        self.event = event
        self.nbytes = 0  # charged to the ledger's input.prefetch


def _local_rows(x):
    """This rank's rows of a global batch leaf (a tensor or an array)."""
    x = torch.as_tensor(x)
    n = _state.size()
    if x.ndim == 0 or x.shape[0] % n:
        raise ValueError(f"a global batch leaf of shape {tuple(x.shape)} "
                         f"does not split over {n} ranks along dim 0")
    per = x.shape[0] // n
    return x[_state.rank() * per:(_state.rank() + 1) * per]


def device_put_batch(batch: Any, device=None) -> Any:
    """This rank's rows of a global host batch (a tree of tensors or
    arrays, leading axis divisible by the rank count), copied to
    ``device`` (default: the device ``init`` bound), synchronously."""
    dev = torch.device(device) if device is not None else _state.device()
    return tree_map(lambda x: _local_rows(x).to(dev), batch)


class PrefetchIterator:
    """Iterator returned by :func:`prefetch_to_device`: device batches in
    loader order.  Use it as a context manager, or break and ``close()``,
    for a deterministic mid-epoch shutdown."""

    def __init__(self, iterable: Iterable, device: torch.device,
                 depth: int) -> None:
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._device = device
        self._source = iterable
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._stage_loop, name="hvd-prefetch", daemon=True)
        self._thread.start()

    # -- stager thread -----------------------------------------------------
    def _stage(self, host_batch, stream):
        rows = tree_map(_local_rows, host_batch)
        if stream is None:
            return _Staged(tree_map(lambda x: x.to(self._device), rows), None)
        with torch.cuda.stream(stream):
            staged = tree_map(
                lambda x: x.to(self._device) if x.is_cuda else
                x.pin_memory().to(self._device, non_blocking=True), rows)
            event = torch.cuda.Event()
            event.record(stream)
        return _Staged(staged, event)

    def _stage_loop(self) -> None:  # thread: stager
        _analysis_threads.set_role("stager")
        it = iter(self._source)
        try:
            stream = None
            if self._device.type == "cuda":
                # A new thread starts on device 0: bind it to ours before
                # its first stream, pin or copy.
                torch.cuda.set_device(self._device)
                stream = torch.cuda.Stream(self._device)
            while not self._stop.is_set():
                try:
                    host_batch = next(it)
                except StopIteration:
                    self._put(_END)
                    return
                staged = self._stage(host_batch, stream)
                # hvd-mem: a staged batch is framework-held device memory
                # until the consumer takes it (reference :155-163).
                if _mem.enabled():
                    staged.nbytes = _mem.tree_nbytes(staged.batch)
                    _mem.ledger.alloc("input.prefetch", staged.nbytes)
                if not self._put(staged):
                    _mem.ledger.free("input.prefetch", staged.nbytes)
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised by the consumer
            _telemetry.prefetch_error_event(f"{type(e).__name__}: {e}")
            self._put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    def _put(self, item) -> bool:
        """Bounded put that stays responsive to close(); False when the
        iterator shut down before the item was accepted."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer side -----------------------------------------------------
    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        try:
            item = self._q.get_nowait()
        except queue.Empty:
            # The stall the prefetch could not hide; the hvd-trace host
            # span is the analyzer's "input-bound" signal (reference
            # :206-220).
            mt0 = time.monotonic() if _trace.enabled() else 0.0
            while True:
                if self._stop.is_set():
                    raise StopIteration
                try:
                    # Timed gets, so that a close() from another thread
                    # (which enqueues nothing) wakes a consumer here.
                    item = self._q.get(timeout=0.05)
                    break
                except queue.Empty:
                    continue
            if _trace.enabled():
                _trace.span("prefetch.wait", "host", mt0, time.monotonic())
        if item is _END:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item  # the exception object carries the loader's frames
        _mem.ledger.free("input.prefetch", item.nbytes)
        if item.event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(item.event)
            for leaf in tree_leaves(item.batch):
                leaf.record_stream(consumer)
        return item.batch

    def close(self) -> None:
        """Stop the stager and join it.  Safe mid-epoch with a full queue
        (the stager's bounded put polls the stop flag), safe twice, safe
        from ``__del__``."""
        self._stop.set()
        self._drain()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        # A stager parked in put() can land one last batch between the
        # drain and its stop-flag check; release it too.
        self._drain()

    def _drain(self) -> None:
        try:
            while True:
                item = self._q.get_nowait()
                if isinstance(item, _Staged):
                    # Deferred: __del__ reaches here from the garbage
                    # collector, perhaps inside the ledger's own lock.
                    _mem.ledger.free_deferred("input.prefetch", item.nbytes)
        except queue.Empty:
            pass

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # pragma: no cover - gc timing
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def prefetch_to_device(iterable: Iterable, depth: int = 2,
                       device: Optional[torch.device] = None
                       ) -> PrefetchIterator:
    """Stage host batches on the device ahead of consumption.

    Args:
      iterable: the host batch source, yielding one GLOBAL batch per item
        (a tree of tensors or arrays, leading axis divisible by the rank
        count); each rank stages its own rows.
      depth: bound on staged batches (2: batch N+1 copies while step N
        computes).
      device: default the device ``init`` bound.

    Loader exceptions re-raise at the consuming ``next()`` with their
    original traceback.
    """
    dev = torch.device(device) if device is not None else _state.device()
    return PrefetchIterator(iterable, dev, depth)
