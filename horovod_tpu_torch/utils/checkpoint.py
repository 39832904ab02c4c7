"""Checkpoint and resume with the reference's rank-0 + broadcast conventions,
the write overlapped with training (port of horovod_tpu/utils/checkpoint.py).

Horovod fixes two conventions: save on rank 0 only, and on resume load
on rank 0 and broadcast, the scalar ``resume_from_epoch`` included.  The
file is flax's msgpack state dict (:mod:`.serialization` writes the same
bytes as ``flax.serialization.to_bytes``), so a checkpoint written by
horovod_tpu restores here and one written here restores there; the
sharded layout and its ``SHARDED_FORMAT`` are the reference's too.

Background writes: ``save_checkpoint`` returns after a synchronous copy
of every tensor to host memory (:func:`_host_snapshot`); one FIFO writer
thread, started at the first save, encodes and publishes the file (tmp +
``os.replace``: a reader never sees a torn file).  The returned
:class:`CheckpointWrite` is truthy on the saving rank and ``wait()`` is
the durability point.  ``restore_checkpoint``, ``resume_epoch`` and the
sharded restore fence pending writes first.

The PyTorch idiom (the reference's trees are immutable jax arrays):

* a restore fills the target's tensors in place (``copy_`` under
  ``no_grad``, on the target's device) and returns them in the target's
  tree, so an optimizer built over them stays valid; a shape or dtype
  mismatch raises :class:`CheckpointError` naming the leaf's path;
* an object with ``state_dict()`` and ``load_state_dict()`` in the tree
  (``torch.optim.Optimizer``, ``DistributedOptimizer``, ZeRO's
  ``ShardState``, an ``nn.Module``) is saved as its state dict and
  restored through ``load_state_dict``: the stand-in for the optax state
  pytrees the reference saves.  torch creates optimizer state lazily, so
  the stored sub-tree is read without a target and takes its containers'
  kinds from the live object's ``state_dict()`` (lists, tuples), its
  other digit keys turned back into ints (the ``state`` dict's parameter
  indices);
* state sharded over ranks is saved whole.  An object that also has
  ``full_state_dict()`` and ``load_full_state_dict()`` (ZeRO's and
  FSDP's ``ShardState``) is saved as its full state, gathered over its
  ranks (so every rank calls ``save_checkpoint``, as the reference's
  convention has it), and each rank restores its own slice of it;
* a placed pipeline step at more than one rank
  (``make_pipeline_train_step(..., stage_meshes=)``) holds each stage on
  its own ranks, and rank 0's copy of another rank's stage is stale.
  Its parameter leaves and stage optimizers carry their stage's
  placement (``parallel/pipeline.py`` :func:`placement`): every rank
  calls ``save_checkpoint`` with the same tree, each stage's parameters
  and optimizer state come from the lowest rank that holds the stage,
  and rank 0 writes the tree a one-rank, unplaced step of the same
  stages would write (a ``None`` slot of a stage the rank does not hold
  filled with the owner's state).  A restore gives every rank all the
  parameters and each optimizer it holds its own stage's state; a
  ``None`` slot stays ``None``.

The reference's telemetry metrics live in :func:`stats` under the same
names: ``checkpoint.write_seconds`` (count, sum, last),
``checkpoint.pending``, ``checkpoint.errors``, ``checkpoint.retries``,
``checkpoint.shards_written``, ``checkpoint.manifest_commits``,
``checkpoint.broadcast_skipped``.  A retried write is flight-recorded
(``ckpt_retry``) and a failed one is a ``checkpoint_error_event``
(reference :165, :238).  The writer's locks are the lock-order
checker's named locks, its thread is stamped ``writer``, each write is a
``checkpoint.write`` trace span and each queued host snapshot is charged
to the memory ledger's ``checkpoint.snapshots`` until it is written
(reference :185-251).  The hvd-chaos site ``ckpt.oserror`` fires in
the tmp-file write (:func:`_write_bytes_once`).  The serving
checkpoints (:func:`save_serving_checkpoint`) write the reference's two
files byte for byte; the elastic ``commit()`` (``elastic.py``) publishes
through :func:`write_tree_async`.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import queue
import sys
import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

from .. import chaos as _chaos
from .. import telemetry as _telemetry
from .. import trace as _trace
from ..analysis import lockorder as _lockorder
from ..analysis import threads as _athreads
from ..memory import ledger as _mem
from ..core import state as _state
from ..telemetry import flight as _flight
from . import serialization
from .retry import BackoffPolicy, retry_call

_stats_lock = threading.Lock()


def _zero_stats() -> dict:
    return {"checkpoint.write_seconds": {"count": 0, "sum": 0.0,
                                         "last": 0.0},
            "checkpoint.pending": 0, "checkpoint.errors": 0,
            "checkpoint.retries": 0, "checkpoint.shards_written": 0,
            "checkpoint.manifest_commits": 0,
            "checkpoint.broadcast_skipped": 0}


_stats = _zero_stats()


def stats() -> dict:
    """The reference's checkpoint metrics (see the module docstring)."""
    with _stats_lock:
        out = dict(_stats)
        out["checkpoint.write_seconds"] = dict(
            _stats["checkpoint.write_seconds"])
    return out


def _inc(name: str, by: int = 1) -> None:
    with _stats_lock:
        _stats[name] += by


def _write_retries() -> int:
    """Attempts per checkpoint publish (1 = no retry).  A transient
    OSError — flaky NFS, a momentary ENOSPC — should not permanently fail
    a write that a retry 50 ms later would land."""
    return max(1, int(os.environ.get("HVD_TPU_CKPT_RETRIES", "3")))


class CheckpointError(RuntimeError):
    """A checkpoint write failed (surfaced at ``wait()``), or a file does
    not fit the restore's target."""


class CheckpointWrite:
    """Handle for one (possibly still in-flight) checkpoint write.

    Truthy iff THIS process performs the save (rank 0), whether or not
    the bytes hit disk yet.  ``wait()`` is the durability point."""

    def __init__(self, path: Optional[str], performed: bool) -> None:
        self.path = path
        self._performed = performed
        self._done = threading.Event()
        self.error: Optional[BaseException] = None
        if not performed:
            self._done.set()  # nothing to wait for on non-saving ranks

    def __bool__(self) -> bool:
        return self._performed

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the write is durably published (atomic rename
        complete).  Returns False on timeout; raises
        :class:`CheckpointError` if the write failed."""
        if not self._done.wait(timeout):
            return False
        if self.error is not None:
            raise CheckpointError(
                f"background checkpoint write to {self.path!r} failed: "
                f"{type(self.error).__name__}: {self.error}"
            ) from self.error
        return True


def _pieces(data) -> tuple:
    """``data`` (bytes, or a list of buffers to write in order) as a
    sequence of buffers."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return (data,)
    return tuple(data)


def _write_bytes_once(path: str, data) -> None:
    """One atomic publish attempt: full write to a private tmp, then
    rename.  A crash at any point leaves either the previous file or the
    new one, never a torn read.  The hvd-chaos ``ckpt.oserror`` site
    injects its transient OSError here, inside the retried region and
    before the rename, so an injected fault never publishes partial bytes
    either (reference :127-150)."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            fault = _chaos.fire("ckpt.oserror") if _chaos.active() \
                else None
            if fault is not None:
                raise OSError(28, "hvd-chaos: ckpt.oserror (injected "
                              "transient ENOSPC)", tmp)
            f.writelines(_pieces(data))
        os.replace(tmp, path)
    except BaseException:
        # A failed attempt must not strand its tmp: at most one orphaned
        # tmp, never a torn published file.
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _write_bytes(path: str, data) -> None:
    """Atomic publish with transient-fault retries: up to
    ``HVD_TPU_CKPT_RETRIES`` attempts with the shared jittered
    exponential backoff (utils/retry.py); each retried failure is counted
    (``checkpoint.retries``) and logged.  Only OSError retries; the final
    failure re-raises unchanged (CheckpointError at ``wait()``)."""

    def on_retry(attempt: int, exc: BaseException, delay: float) -> None:
        _inc("checkpoint.retries")
        _flight.record("ckpt_retry", path, attempt,
                       f"{type(exc).__name__}: {exc}")
        print(f"WARNING: checkpoint write to {path!r} failed "
              f"(attempt {attempt + 1}/{_write_retries()}: "
              f"{type(exc).__name__}: {exc}); retrying in "
              f"{delay * 1e3:.0f}ms", file=sys.stderr)

    retry_call(lambda: _write_bytes_once(path, data),
               attempts=_write_retries(),
               policy=BackoffPolicy(base=0.02, cap=0.5),
               retry_on=(OSError,), on_retry=on_retry)


class _Writer:
    """The rank-0 background checkpoint writer: one FIFO thread, so
    writes to the same path apply in submission order."""

    def __init__(self) -> None:
        self._q: queue.Queue = queue.Queue()
        self._pending = 0
        self._lock = _lockorder.make_lock("checkpoint._Writer._lock")
        self._thread = threading.Thread(
            target=self._run, name="hvd-ckpt-writer", daemon=True)
        self._thread.start()

    def submit(self, handle: CheckpointWrite, host_tree: Any,
               step: Optional[int]) -> None:
        # hvd-mem: the host snapshot is framework-held memory until the
        # background write publishes it -- charged per handle, released in
        # the writer's finally (reference :191-199).
        if _mem.enabled():
            handle._mem_bytes = _mem.tree_nbytes(host_tree)
            if handle._mem_bytes:
                _mem.ledger.alloc("checkpoint.snapshots",
                                  handle._mem_bytes)

        def publish() -> None:
            _write_bytes(handle.path, serialization.to_pieces(host_tree))
            if step is not None:
                _write_bytes(f"{handle.path}.step", str(step).encode())

        self.submit_task(handle, publish)

    def submit_task(self, handle: CheckpointWrite, publish) -> None:
        """Queue a publish thunk on the FIFO writer thread (the sharded
        path submits its shard writes and manifest commit here)."""
        with self._lock:
            self._pending += 1
            _set_pending(self._pending)
        self._q.put((handle, publish))

    def pending(self) -> int:
        with self._lock:
            return self._pending

    def _run(self) -> None:  # thread: writer
        _athreads.set_role("writer")
        while True:
            handle, publish = self._q.get()
            t0 = time.perf_counter()
            mt0 = time.monotonic() if _trace.enabled() else 0.0
            try:
                publish()
            except BaseException as e:  # noqa: BLE001 — carried to wait()
                handle.error = e
                _inc("checkpoint.errors")
                _telemetry.checkpoint_error_event(
                    handle.path, f"{type(e).__name__}: {e}")
            finally:
                seconds = time.perf_counter() - t0
                with _stats_lock:
                    hist = _stats["checkpoint.write_seconds"]
                    hist["count"] += 1
                    hist["sum"] += seconds
                    hist["last"] = seconds
                if _trace.enabled():
                    # hvd-trace: a write that stole the cycle shows up in
                    # the fleet trace as a checkpoint-leg span.
                    _trace.span("checkpoint.write", "checkpoint", mt0,
                                time.monotonic(),
                                args={"path": os.path.basename(
                                    handle.path)})
                nb = getattr(handle, "_mem_bytes", 0)
                if nb:
                    _mem.ledger.free("checkpoint.snapshots", nb)
                with self._lock:
                    self._pending -= 1
                    _set_pending(self._pending)
                handle._done.set()

    def wait_all(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted write has finished (the atexit
        flush; returns False on timeout)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.pending() > 0:
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(0.005)
        return True


def _set_pending(n: int) -> None:
    with _stats_lock:
        _stats["checkpoint.pending"] = n


_writer: Optional[_Writer] = None
_writer_lock = _lockorder.make_lock("checkpoint._writer_lock")


def _get_writer() -> _Writer:
    """The writer, started at first use (an import starts no thread)."""
    global _writer
    with _writer_lock:
        if _writer is None or not _writer._thread.is_alive():
            _writer = _Writer()
            # The thread is a daemon: flush pending writes at a normal
            # interpreter exit, or a short job could lose its last save.
            atexit.register(_writer.wait_all, 30.0)
        return _writer


def pending_writes() -> int:
    """Number of checkpoint writes queued or in flight on this process."""
    with _writer_lock:
        w = _writer
    return w.pending() if w is not None else 0


def wait_for_writes(timeout: Optional[float] = None) -> bool:
    """Flush every pending background write (all paths)."""
    with _writer_lock:
        w = _writer
    return w.wait_all(timeout) if w is not None else True


def _is_saving_process() -> bool:
    return not _state.is_initialized() or _state.rank() == 0


# ---------------------------------------------------------------------------
# Trees: containers kept in insertion order (the file's map order);
# objects with state_dict()/load_state_dict() are leaves
# ---------------------------------------------------------------------------

def _is_stateful(x) -> bool:
    return (not isinstance(x, (dict, list, tuple, torch.Tensor,
                               np.ndarray))
            and callable(getattr(x, "state_dict", None))
            and callable(getattr(x, "load_state_dict", None)))


def _is_sharded(x) -> bool:
    return (_is_stateful(x)
            and callable(getattr(x, "full_state_dict", None))
            and callable(getattr(x, "load_full_state_dict", None)))


def _whole(tree) -> Any:
    """``tree`` as one process would hold it whole (a collective: every
    rank calls this): a placed pipeline's stages from their owners
    (:func:`_placed_from_owners`), then each sharded object replaced by
    its full state dict."""
    tree = _placed_from_owners(tree)
    return _map(lambda x: x.full_state_dict() if _is_sharded(x) else x,
                tree)


def _placement(x):
    from ..parallel.pipeline import placement

    return placement(x)


def _is_placed(tree) -> bool:
    """Whether ``tree`` holds a placed pipeline step's parameter leaves or
    stage optimizers (at more than one rank)."""
    if not (_state.is_initialized() and _state.size() > 1):
        return False
    leaves: List[Any] = []
    _map(leaves.append, tree)
    return any(_placement(x) is not None for x in leaves)


def _map_paths(fn, tree, path=()):
    """``tree`` with each leaf ``x`` replaced by ``fn(path, x)``, dicts in
    their insertion order; ``path`` is the tuple of keys and indices (as
    strings) that reach the leaf."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if serialization._is_namedtuple(tree):
        return type(tree)(*(_map_paths(fn, v, path + (str(i),))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _placed_from_owners(tree) -> Any:
    """A placed pipeline's ``tree`` with each of its stage leaves (a
    parameter tensor, a stage optimizer, or the ``None`` slot of a stage
    this rank does not hold) replaced by the host snapshot of its
    stage's owner, the lowest rank that holds the stage; other leaves as
    they are.  One object allgather: every rank passes a tree of the same
    structure, and every rank gets the whole."""
    if not _is_placed(tree):
        return tree
    from ..ops.objects import allgather_object

    me = _state.rank()
    owned = {}

    def collect(path, x):
        where = _placement(x)
        if where is not None and where.owner == me:
            owned[path] = _host_snapshot(x)
        return x

    _map_paths(collect, tree)
    whole = {}
    for part in allgather_object(owned, name="checkpoint.placed.stages"):
        whole.update(part)
    return _map_paths(lambda path, x: whole.get(path, x), tree)


def _map(fn, tree):
    """``tree`` with each leaf ``x`` replaced by ``fn(x)``, dicts in
    their insertion order."""
    return _map_paths(lambda _path, x: fn(x), tree)


def _host_snapshot(tree: Any) -> Any:
    """A host copy of ``tree`` the writer thread can encode later.

    Each tensor is copied to host memory synchronously
    (``detach().to("cpu", copy=True)``): torch updates parameters and
    optimizer moments in place, so a view, or a ``non_blocking`` copy
    nothing fences, would write a later step's values.  numpy leaves are
    copied too; an object with ``state_dict()`` becomes a snapshot of its
    state dict."""
    def snap(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        if isinstance(x, np.ndarray):
            return np.array(x)
        if _is_stateful(x):
            return _map(snap, x.state_dict())
        return x

    return _map(snap, tree)


def _checked_leaf(target, value, path):
    """``target`` filled with the stored ``value`` (a tensor in place,
    a numpy array as a new array); other leaves take the stored value."""
    where = serialization._where(path)
    if isinstance(target, torch.Tensor):
        if not isinstance(value, (torch.Tensor, np.ndarray)):
            raise CheckpointError(
                f"{where}: the target holds a tensor, the checkpoint a "
                f"{type(value).__name__}")
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        if tuple(value.shape) != tuple(target.shape) or \
                value.dtype != target.dtype:
            raise CheckpointError(
                f"{where}: checkpoint holds {tuple(value.shape)} "
                f"{value.dtype}, the target {tuple(target.shape)} "
                f"{target.dtype}")
        with torch.no_grad():
            target.copy_(value)
        return target
    if isinstance(target, np.ndarray):
        if isinstance(value, torch.Tensor):
            name = serialization.DTYPE_NAMES[value.dtype]
            if tuple(value.shape) != target.shape or \
                    name != target.dtype.name:
                raise CheckpointError(
                    f"{where}: checkpoint holds {tuple(value.shape)} "
                    f"{name}, the target {target.shape} "
                    f"{target.dtype.name}")
            # The bytes, viewed as the target's dtype (bfloat16 included).
            raw = value.reshape(-1).view(torch.uint8).numpy()
            return raw.view(target.dtype).reshape(target.shape)
        return np.asarray(value)
    if _is_stateful(target):
        _load_state(target, value)
        return target
    return value


def _load_state(target, value) -> None:
    """An object with ``state_dict()`` filled from its stored state dict:
    a sharded one (:func:`_is_sharded`) takes its rank's slice."""
    state = _like(target.state_dict(), value)
    if _is_sharded(target):
        target.load_full_state_dict(state)
    else:
        target.load_state_dict(state)


def _absent_ok(x) -> bool:
    """A value a stored tree may lack: ``None`` and empty containers,
    which the sharded format's leaves do not carry."""
    return x is None or (isinstance(x, (dict, list, tuple)) and not x)


def _like(template, value):
    """A state dict read without a target, given the live object's
    containers: maps whose template is a list or tuple become one (of
    the stored length), keys the template has keep its key type, other
    digit keys become ints; a key the template holds as ``None`` or an
    empty container may be absent."""
    if isinstance(value, dict):
        if isinstance(template, (list, tuple)):
            items = [_like(template[i] if i < len(template) else None,
                           value[str(i)]) for i in range(len(value))]
            return tuple(items) if isinstance(template, tuple) else items
        keys = ({str(k): k for k in template}
                if isinstance(template, dict) else {})
        out = {}
        for k, v in value.items():
            key = keys.get(k, int(k) if k.isdecimal() else k)
            out[key] = _like(template.get(key) if keys else None, v)
        for key in keys.values():
            if key not in out and _absent_ok(template[key]):
                out[key] = type(template[key])() \
                    if template[key] is not None else None
        return out
    return value


def _sent_as_stored(t, placed: bool) -> bool:
    """Whether a target leaf restores from a stored state dict that the
    broadcast sends on: an object with ``state_dict()``, or, in a placed
    pipeline's tree, the ``None`` slot of a stage optimizer this rank
    does not hold (which stays ``None``)."""
    return _is_stateful(t) or (placed and t is None)


def _restore_into(target, state, stored: Optional[list] = None):
    """``target`` restored from the read state dict ``state``.
    ``stored``, when given, collects the stored state dict of each leaf
    :func:`_sent_as_stored` names, in the tree's leaf order (the
    broadcast sends them on)."""
    placed = _is_placed(target)

    def leaf(t, value, path):
        if stored is not None and _sent_as_stored(t, placed):
            stored.append(value)
        if placed and t is None:
            return None
        return _checked_leaf(t, value, path)

    return serialization.from_state_dict(target, state, leaf=leaf)


def _read_into(path: str, target, stored: Optional[list] = None):
    with open(path, "rb") as f:
        blob = f.read()
    return _restore_into(target, serialization.msgpack_restore(blob),
                         stored)


# ---------------------------------------------------------------------------
# Single-file checkpoints
# ---------------------------------------------------------------------------

def write_tree_async(path: str, host_tree: Any,
                     step: Optional[int] = None) -> CheckpointWrite:
    """Queue one host-resident tree for the background writer (the
    low-level half of :func:`save_checkpoint`).  The caller must not
    mutate ``host_tree`` afterwards — :func:`_host_snapshot` makes such a
    tree."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    handle = CheckpointWrite(path, performed=True)
    _get_writer().submit(handle, host_tree, step)
    return handle


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None,
                    block: bool = False) -> CheckpointWrite:
    """Save ``tree`` at ``path`` from rank 0 only (≙ the rank-0 guard in
    every reference example).

    Returns after the host snapshot; encoding and the atomic publish run
    on the writer thread, overlapped with training.  The
    :class:`CheckpointWrite` is truthy iff this process saves
    (``if save_checkpoint(...)``); ``block=True`` waits for the write.
    ``step`` is written beside the file for :func:`resume_epoch`.  A
    tree holding sharded state (a ``ShardState``) or a placed pipeline
    step's stages is gathered whole first, so every rank must call it
    then, with the same tree."""
    tree = _whole(tree)
    if not _is_saving_process():
        return CheckpointWrite(path, performed=False)
    handle = write_tree_async(path, _host_snapshot(tree), step=step)
    if block:
        handle.wait()
    return handle


def restore_checkpoint(path: str, target: Any, broadcast: bool = True) -> Any:
    """Load ``path`` into ``target`` and, by default, broadcast from rank
    0 so that every rank resumes identically.

    Only rank 0 reads the file; the others keep ``target`` and receive
    rank 0's values through the broadcast, so a checkpoint on rank 0's
    disk alone restores everywhere.  Pending background writes are fenced
    first.  Broadcast elision: when every rank can read ``path``, an
    allgather of the files' sha256 digests shows whether the reads are
    identical, and then each rank reads its own and no parameter byte is
    broadcast (``checkpoint.broadcast_skipped``); any rank missing the
    file, or a differing one, falls back to the broadcast.  One rank has
    nothing to broadcast to.  A sharded object of the target
    (``ShardState``) takes each rank's slice of the stored full state; a
    placed pipeline step's optimizers each take their stage's state, and
    its ``None`` slots stay ``None``."""
    multi = _state.is_initialized() and _state.size() > 1
    if broadcast and multi:
        wait_for_writes()
        digest = _file_digest(path) if os.path.exists(path) else None
        if _broadcast_skippable(digest):
            _inc("checkpoint.broadcast_skipped")
            return _read_into(path, target)
    stored: list = []
    if _is_saving_process():
        wait_for_writes()
        tree = _read_into(path, target, stored)
    else:
        tree = target
    if broadcast and multi:
        tree = _broadcast_tree(tree, stored)
    return tree


def _file_digest(path: str) -> str:
    """Chunked sha256: the digest pass must not hold a multi-GB file
    resident just to decide whether the broadcast can be skipped."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 26), b""):
            h.update(chunk)
    return h.hexdigest()


def _broadcast_skippable(digest: Optional[str]) -> bool:
    """True when every rank holds identical local checkpoint bytes: an
    allgather of 64-byte digests instead of every parameter through rank
    0.  The gathered list is the same everywhere, so every rank takes the
    same branch."""
    from ..ops.objects import allgather_object

    digests = allgather_object(digest, name="checkpoint.restore.digest")
    return bool(digests) and all(
        d is not None and d == digests[0] for d in digests)


def _broadcast_tree(tree, stored: list):
    """Rank 0's restored values on every rank: tensors (and numpy arrays)
    by :func:`..parallel.data.broadcast_parameters`, in place; the other
    leaves, and the stored state dicts of objects with ``state_dict()``
    (rank 0's ``stored``, in leaf order), in one object broadcast.  The
    stored state, not rank 0's live one: a sharded object holds only its
    rank's slice."""
    from ..ops.objects import broadcast_object
    from ..parallel.data import broadcast_parameters

    leaves: List[Any] = []
    _map(leaves.append, tree)
    placed = _is_placed(tree)
    arrays = {i: torch.from_numpy(np.array(x)) for i, x in enumerate(leaves)
              if isinstance(x, np.ndarray)}
    broadcast_parameters([arrays.get(i, x) for i, x in enumerate(leaves)
                          if i in arrays or isinstance(x, torch.Tensor)],
                         root_rank=0)
    for i, t in arrays.items():
        leaves[i] = t.numpy()
    others = [i for i, x in enumerate(leaves)
              if not isinstance(x, (torch.Tensor, np.ndarray))]
    if others:
        root = _state.rank() == 0
        states = iter(stored)
        sent = broadcast_object(
            [next(states) if _sent_as_stored(leaves[i], placed)
             else leaves[i] for i in others] if root else None,
            root_rank=0, name="checkpoint.restore.objects")
        for i, value in zip(others, sent):
            if _is_stateful(leaves[i]):
                if not root:
                    _load_state(leaves[i], value)
            elif not (placed and leaves[i] is None):
                leaves[i] = value
    it = iter(leaves)
    return _map(lambda _: next(it), tree)


# ---------------------------------------------------------------------------
# Sharded checkpoints
# ---------------------------------------------------------------------------
#
# ``save_checkpoint`` funnels every parameter byte through rank 0.  The
# sharded format splits the leaves across the fleet: each rank encodes
# and publishes ONLY its assigned shards through the background writer,
# and rank 0 commits a manifest LAST, after every shard's digest sidecar
# proves it durable.  The ``MANIFEST`` pointer moves only at commit, so a
# torn fleet leaves the previous complete checkpoint loadable.  Restore
# reads the shards straight from shared storage, at any world size.
#
# Layout under ``directory`` (the reference's):
#   MANIFEST                      -> "manifest-<tag>.json" (atomic ptr)
#   manifest-<tag>.json           committed by rank 0, LAST
#   save-<tag>/shard-NNNNN-of-WWWWW.msgpack   (+ .ok digest sidecars)
#
# Leaves are numbered in jax's order (dict keys sorted, None no leaf).
# The port adds each leaf's ``path`` to its manifest entry (the reference
# reads past it): with paths a restore rebuilds the stored tree, so
# objects with state_dict() restore too; a manifest without paths (the
# reference's) restores by leaf order into a target of plain leaves.

MANIFEST_POINTER = "MANIFEST"
SHARDED_FORMAT = "hvd-sharded-checkpoint-v1"

_save_seq: dict = {}
_save_seq_lock = _lockorder.make_lock("checkpoint._save_seq_lock")


def _manifest_timeout() -> float:
    """How long rank 0 waits for the fleet's shard sidecars before
    failing the manifest commit (the torn-fleet bound)."""
    return float(os.environ.get("HVD_TPU_CKPT_MANIFEST_TIMEOUT", "120"))


def shard_assignment(nbytes: list, world: int) -> list:
    """Deterministic leaf -> writer-rank map: greedy largest-first onto
    the least-loaded writer, ties by rank then leaf index, so every rank
    derives the identical assignment with no agreement round."""
    order = sorted(range(len(nbytes)), key=lambda i: (-nbytes[i], i))
    load = [0] * max(1, world)
    assign = [0] * len(nbytes)
    for i in order:
        w = min(range(len(load)), key=lambda r: (load[r], r))
        assign[i] = w
        load[w] += nbytes[i]
    return assign


def _shard_name(rank: int, world: int) -> str:
    return f"shard-{rank:05d}-of-{world:05d}.msgpack"


def _flatten_paths(tree, path=()) -> list:
    """``(path, leaf)`` in jax's leaf order: dict keys sorted, None no
    leaf, objects with ``state_dict()`` one leaf."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten_paths(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [item for i, x in enumerate(tree)
                for item in _flatten_paths(x, path + (str(i),))]
    return [] if tree is None else [(path, tree)]


def _leaf_spec(path, leaf) -> dict:
    if isinstance(leaf, torch.Tensor):
        spec = {"kind": "array",
                "dtype": serialization.DTYPE_NAMES[leaf.dtype],
                "shape": list(leaf.shape),
                "nbytes": leaf.numel() * leaf.element_size()}
    elif isinstance(leaf, np.ndarray):
        spec = {"kind": "array", "dtype": str(leaf.dtype),
                "shape": list(leaf.shape), "nbytes": int(leaf.nbytes)}
    else:
        # Python scalars and strings ride the manifest inline.
        value = leaf.item() if isinstance(leaf, np.generic) else leaf
        spec = {"kind": "inline", "value": json.loads(json.dumps(value)),
                "nbytes": 0}
    spec["path"] = list(path)
    return spec


def _digest(pieces) -> str:
    h = hashlib.sha256()
    for piece in pieces:
        h.update(piece)
    return h.hexdigest()


def save_checkpoint_sharded(directory: str, tree: Any,
                            step: Optional[int] = None,
                            block: bool = False,
                            rank: Optional[int] = None,
                            world: Optional[int] = None,
                            virtual: Optional[bool] = None
                            ) -> CheckpointWrite:
    """Sharded save: THIS process publishes the shards the deterministic
    assignment gives its rank; rank 0 also commits the manifest once
    every shard is durable.

    ``rank``/``world`` default to the live job.  A ``world`` other than
    the live rank count is the virtual mode: this one process writes
    EVERY shard of the declared layout.  ``virtual=False`` forces the
    strict one-rank's-shards behaviour even then (the torn-fleet tests
    drive each simulated rank through it).  Multi-rank jobs must pass
    ``step``: the save tag has to be agreed across ranks.

    Returns a :class:`CheckpointWrite`; on rank 0 ``wait()`` is the
    manifest commit, the save's durability point."""
    live_world = _state.size() if _state.is_initialized() else 1
    if rank is None:
        rank = _state.rank() if _state.is_initialized() else 0
    if world is None:
        world = live_world
    if virtual is None:
        virtual = world != live_world
    flat = _flatten_paths(_host_snapshot(_whole(tree)))
    leaves = [x for _, x in flat]
    specs = [_leaf_spec(p, x) for p, x in flat]
    assign = shard_assignment([s["nbytes"] for s in specs], world)
    for i, s in enumerate(specs):
        if s["kind"] == "array":
            s["shard"] = assign[i]
    if step is not None:
        tag = f"s{step}"
    else:
        # The tag must be identical on every rank; a per-process counter
        # diverges the moment one worker restarts.
        if not virtual and world > 1:
            raise ValueError(
                "save_checkpoint_sharded requires step= in "
                "multi-process mode: the save tag must be agreed "
                "across ranks, and a process-local counter diverges "
                "across elastic restarts")
        with _save_seq_lock:
            _save_seq[directory] = _save_seq.get(directory, 0) + 1
            tag = f"c{_save_seq[directory]}"
    save_dir = os.path.join(directory, f"save-{tag}")
    manifest_path = os.path.join(directory, f"manifest-{tag}.json")
    # Torn-retry detection (committing rank): a save-<tag>/ with no
    # committed manifest means a previous attempt tore.  Its sidecars
    # older than the staleness margin must CHANGE before this commit
    # accepts them (a same-attempt fast rank's sidecar is seconds old and
    # counts as it is).
    prior_ok: dict = {}
    if rank == 0 and os.path.isdir(save_dir) \
            and not os.path.exists(manifest_path):
        margin = float(os.environ.get(
            "HVD_TPU_CKPT_STALE_OK_SECONDS", "60"))
        cutoff = time.time() - margin
        for w in range(world):
            ok = os.path.join(save_dir, _shard_name(w, world) + ".ok")
            try:
                st_ = os.stat(ok)
                if st_.st_mtime >= cutoff:
                    continue  # fresh: a same-attempt early completer
                with open(ok) as f:
                    prior_ok[w] = (f.read().strip(), st_.st_mtime)
            except OSError:
                pass
    os.makedirs(save_dir, exist_ok=True)
    writer_ranks = list(range(world)) if virtual else [rank]
    writer = _get_writer()
    handle = CheckpointWrite(manifest_path, performed=True)

    def shard_task(wr: int):
        mine = {str(i): leaves[i] for i in range(len(leaves))
                if specs[i]["kind"] == "array" and assign[i] == wr}
        path = os.path.join(save_dir, _shard_name(wr, world))

        def publish() -> None:
            # Invalidate a previous attempt's sidecar first, so that the
            # commit never pairs it with a shard still being written.
            try:
                os.unlink(path + ".ok")
            except OSError:
                pass
            pieces = serialization.to_pieces(mine)
            _write_bytes(path, pieces)
            _write_bytes(path + ".ok", _digest(pieces).encode())
            _inc("checkpoint.shards_written")

        return publish

    for wr in writer_ranks:
        writer.submit_task(CheckpointWrite(
            os.path.join(save_dir, _shard_name(wr, world)),
            performed=True), shard_task(wr))

    def commit_manifest() -> None:
        deadline = time.monotonic() + _manifest_timeout()
        digests: dict = {}
        while True:
            missing = [w for w in range(world) if str(w) not in digests]
            for w in missing:
                ok = os.path.join(save_dir, _shard_name(w, world) + ".ok")
                try:
                    st_ = os.stat(ok)
                    with open(ok) as f:
                        got = f.read().strip()
                except OSError:
                    continue
                if w in prior_ok and (got, st_.st_mtime) == prior_ok[w]:
                    continue  # the torn attempt's sidecar, unchanged
                digests[str(w)] = got
            if len(digests) == world:
                break
            if time.monotonic() > deadline:
                raise CheckpointError(
                    f"sharded save {tag!r}: shards from writer rank(s) "
                    f"{[w for w in range(world) if str(w) not in digests]} "
                    f"never became durable within "
                    f"{_manifest_timeout():.0f}s; the previous complete "
                    f"checkpoint (MANIFEST pointer) is untouched")
            time.sleep(0.05)
        manifest = {
            "format": SHARDED_FORMAT, "tag": tag, "step": step,
            "world": world, "save_dir": f"save-{tag}",
            "leaves": specs, "shard_digests": digests,
        }
        _write_bytes(handle.path, json.dumps(manifest, indent=1).encode())
        # The durability point: only a COMPLETE save moves the pointer.
        _write_bytes(os.path.join(directory, MANIFEST_POINTER),
                     f"manifest-{tag}.json".encode())
        _inc("checkpoint.manifest_commits")

    if rank == 0:
        writer.submit_task(handle, commit_manifest)
    else:
        # A non-committing rank's durability point is its own shard: a
        # sentinel task makes wait() fence the FIFO.
        writer.submit_task(handle, lambda: None)
    if block:
        handle.wait()
    return handle


def load_sharded_manifest(directory: str) -> dict:
    """The manifest the ``MANIFEST`` pointer names: always the latest
    COMPLETE save."""
    with open(os.path.join(directory, MANIFEST_POINTER)) as f:
        name = f.read().strip()
    with open(os.path.join(directory, name)) as f:
        return json.load(f)


def restore_checkpoint_sharded(directory: str, target: Any) -> Any:
    """Restore the latest complete sharded save into ``target`` (filled
    in place, as :func:`restore_checkpoint`) at ANY world size.  Every
    process reads the shards it needs straight from shared storage,
    each checked against the manifest's digest; nothing is broadcast."""
    wait_for_writes()
    manifest = load_sharded_manifest(directory)
    if manifest.get("format") != SHARDED_FORMAT:
        raise CheckpointError(
            f"{directory!r} is not a sharded checkpoint "
            f"(format {manifest.get('format')!r})")
    specs = manifest["leaves"]
    if all("path" in s for s in specs):
        paths = [tuple(s["path"]) for s in specs]
    else:
        flat = _flatten_paths(target)
        if any(_is_stateful(x) for _, x in flat):
            raise CheckpointError(
                f"{directory!r} has no leaf paths (a horovod_tpu save): "
                "it restores into plain tensors, arrays and scalars only")
        if len(flat) != len(specs):
            raise CheckpointError(
                f"target structure has {len(flat)} leaves but the "
                f"checkpoint holds {len(specs)} — the model changed since "
                f"the save")
        paths = [p for p, _ in flat]
    values: list = [s.get("value") for s in specs]
    world = int(manifest["world"])
    save_dir = os.path.join(directory, manifest["save_dir"])
    by_shard: dict = {}
    for i, s in enumerate(specs):
        if s["kind"] != "inline":
            by_shard.setdefault(int(s["shard"]), []).append(i)
    for wr, idxs in sorted(by_shard.items()):
        path = os.path.join(save_dir, _shard_name(wr, world))
        with open(path, "rb") as f:
            blob = f.read()
        want = manifest["shard_digests"].get(str(wr))
        got = hashlib.sha256(blob).hexdigest()
        if want != got:
            raise CheckpointError(
                f"shard {os.path.basename(path)} digest mismatch "
                f"({got[:12]} != manifest {str(want)[:12]}) — torn or "
                f"foreign file")
        data = serialization.msgpack_restore(blob)
        for i in idxs:
            values[i] = data[str(i)]
    state: dict = {}
    for path, value in zip(paths, values):
        node = state
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return _restore_into(target, _fill_absent(target, state))


def _fill_absent(target, state):
    """``state`` with the target's ``None`` leaves and empty containers,
    which the sharded format does not store (jax's leaves have none)."""
    if not isinstance(state, dict):
        return state
    if isinstance(target, dict):
        items = [(str(k), v) for k, v in target.items()]
    elif isinstance(target, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(target)]
    else:
        return state
    out = dict(state)
    for k, v in items:
        if k in state:
            out[k] = _fill_absent(v, state[k])
        elif _absent_ok(v):
            out[k] = None if v is None else {}
    return out


# ---------------------------------------------------------------------------
# Serving checkpoints (reference :744-801)
# ---------------------------------------------------------------------------

SERVING_PARAMS_FILE = "params.msgpack"
SERVING_META_FILE = "serving.json"
SERVING_FORMAT = "hvd-serving-checkpoint-v1"


def save_serving_checkpoint(directory: str, params: Any, cfg: Any,
                            tokenizer: str = "byte",
                            extra: Optional[dict] = None,
                            block: bool = False) -> CheckpointWrite:
    """Export a serving-ready checkpoint: the parameter tree
    (``params.msgpack``, through the background writer) and a
    ``serving.json`` with the model config and tokenizer metadata, so
    :func:`load_serving_checkpoint` (and ``examples/serve_lm.py``) can
    build an :class:`~..serving.engine.InferenceEngine` with no knowledge
    of the training script.  Rank 0 only, like every save.  Both files
    are byte for byte the reference's for the same parameters: the
    snapshot takes the reference's sorted key order (its ``tree_map``),
    and the JSON is the same ``indent=1`` dump."""
    from .tree import tree_map

    if not _is_saving_process():
        return CheckpointWrite(None, performed=False)
    os.makedirs(directory, exist_ok=True)
    snapshot = tree_map(lambda x: x.detach().to("cpu", copy=True), params)
    handle = write_tree_async(
        os.path.join(directory, SERVING_PARAMS_FILE), snapshot)
    meta = {
        "format": SERVING_FORMAT,
        "model": {
            "vocab_size": cfg.vocab_size, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_layers": cfg.n_layers,
            "d_ff": cfg.d_ff, "max_seq_len": cfg.max_seq_len,
            "num_experts": cfg.num_experts,
            "dtype": serialization.DTYPE_NAMES[cfg.dtype],
        },
        "tokenizer": {"kind": tokenizer},
        "extra": extra or {},
    }
    _write_bytes(os.path.join(directory, SERVING_META_FILE),
                 json.dumps(meta, indent=1).encode())
    if block:
        handle.wait()
    return handle


def load_serving_checkpoint(directory: str):
    """Load a :func:`save_serving_checkpoint` export (of either package).
    Returns ``(params, cfg, meta)``: CPU tensors in the shapes and dtypes
    ``cfg`` gives (a mismatch raises :class:`CheckpointError` naming the
    leaf), ``cfg`` a reconstructed
    :class:`~..models.transformer.TransformerConfig`, ``meta`` the raw
    ``serving.json``.  Pending background writes are fenced first."""
    from ..models.transformer import TransformerConfig, init_transformer
    from .tree import tree_map

    wait_for_writes()
    with open(os.path.join(directory, SERVING_META_FILE)) as f:
        meta = json.load(f)
    m = meta["model"]
    cfg = TransformerConfig(
        vocab_size=int(m["vocab_size"]), d_model=int(m["d_model"]),
        n_heads=int(m["n_heads"]), n_layers=int(m["n_layers"]),
        d_ff=int(m["d_ff"]), max_seq_len=int(m["max_seq_len"]),
        num_experts=int(m.get("num_experts", 0)),
        dtype=serialization.TORCH_DTYPES[m.get("dtype", "float32")])
    template = tree_map(lambda x: x.detach(), init_transformer(
        torch.Generator().manual_seed(0), cfg))
    params = _read_into(os.path.join(directory, SERVING_PARAMS_FILE),
                        template)
    return params, cfg, meta


def resume_epoch(path: str) -> int:
    """The epoch to resume from, agreed across ranks: rank 0's
    ``<path>.step`` (0 without one) broadcast as ``resume_from_epoch``."""
    epoch = 0
    if _is_saving_process():
        wait_for_writes()
    step_file = f"{path}.step"
    if os.path.exists(step_file):
        with open(step_file) as f:
            epoch = int(f.read().strip())
    if _state.is_initialized():
        from ..ops import collective as C

        epoch = int(C.broadcast(
            torch.tensor(epoch, dtype=torch.int32, device=_state.device()),
            root_rank=0, name="resume_from_epoch"))
    return epoch
