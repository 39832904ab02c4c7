"""Elastic, fault-tolerant training and serving (port of
horovod_tpu/elastic.py).

The contract is the reference's, split across the process boundary:

* :class:`State`: named values (tensor trees, Python scalars) with
  ``commit()`` (every rank keeps a host snapshot; rank 0 also publishes
  it to ``HVD_TPU_ELASTIC_DIR/elastic_state.msgpack`` through the
  background checkpoint writer), ``restore()`` (roll back to the last
  commit) and ``sync()`` (converge every rank on the committed state: a
  previous incarnation's disk commit if there is one, else rank 0's
  values, broadcast);
* :func:`run`: wraps the training function.  A ``HorovodError`` (a dead
  peer poisoning the pending ops with its diagnosis) rolls back and
  retries in-process while the job is whole; when a member is lost, the
  process exits ``EX_TEMPFAIL`` (75) so that the elastic launcher
  (``python -m horovod_tpu_torch.run --elastic``) relaunches the job from
  the last commit;
* :class:`TrainerState` binds the contract to a
  :class:`~.frontends.loop.Trainer` in every storage mode (plain,
  ``zero=``, ``fsdp=``); :class:`ServingState` to an
  :class:`~.serving.engine.InferenceEngine` (drain, commit, relaunch,
  resubmit).

The PyTorch idiom:

* a snapshot is a fresh host copy, ``t.detach().to("cpu", copy=True)``:
  torch updates parameters and optimizer moments in place, so a view
  would carry the next step's values into the rollback point.  Python
  ``int``, ``float`` and ``bool`` stay Python types.  ``restore`` gives
  each tensor back as a fresh copy with the dtype and device of the
  value it replaces;
* the commit file is :mod:`.utils.serialization`'s msgpack, byte for
  byte the file the reference writes for the same values (dict keys
  sorted, as ``jax.tree_util`` rebuilds them), so each package's
  ``sync`` resumes the other's commit;
* the cross-rank ``sync`` is the reference's ``broadcast_parameters``
  (its ``parallel/data.py:445-461``): one negotiated ``broadcast_async``
  a leaf, named ``broadcast.param.{i}``, so a leaf whose shape differs
  from rank to rank (a ``ServingState`` blob) fails with the
  coordinator's named mismatch.  Python scalars travel as 0-d tensors
  and are cast back.

Usage::

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic

    hvd.init()
    state = elastic.State(params=params, step=0)

    @elastic.run
    def train(state):
        while state.step < steps:
            train_step(state.params, batch(state.step))
            state.step += 1
            if state.step % 10 == 0:
                state.commit()

    train(state)
"""

from __future__ import annotations

import functools
import json
import os
import sys
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from .utils.tree import tree_flatten, tree_map, tree_unflatten

# The launcher reads this exit code as "relaunch me from the last
# commit" (BSD sysexits EX_TEMPFAIL: temporary failure, retry later).
EX_TEMPFAIL = 75

_STATE_FILE = "elastic_state.msgpack"


def _elastic_dir() -> Optional[str]:
    return os.environ.get("HVD_TPU_ELASTIC_DIR") or None


def _host_leaf(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, np.ndarray):
        return np.array(x)
    return x


def _host_copy(tree: Any) -> Any:
    """A fresh host copy of ``tree``; scalars keep their Python types."""
    return tree_map(_host_leaf, tree)


def _item(x: Any) -> Any:
    return x.item() if isinstance(x, torch.Tensor) else np.asarray(x).item()


def _cast_like(orig: Any, new: Any) -> Any:
    """``new`` with the Python scalar type ``orig`` had, so loop counters
    survive the round trip through a broadcast or the file (``for
    state.batch in range(state.batch, n)`` keeps working)."""
    if isinstance(orig, bool):
        return bool(_item(new))
    if isinstance(orig, int):
        return int(_item(new))
    if isinstance(orig, float):
        return float(_item(new))
    return new


def _like_leaf(orig: Any, new: Any) -> Any:
    """One committed or received leaf made like the value it replaces:
    a Python scalar cast back, a tensor a fresh copy on ``orig``'s device
    in ``orig``'s dtype, a numpy array a fresh array."""
    if isinstance(orig, (bool, int, float)):
        return _cast_like(orig, new)
    if isinstance(orig, torch.Tensor):
        t = new if isinstance(new, torch.Tensor) else torch.as_tensor(
            np.array(new))
        return t.to(device=orig.device, dtype=orig.dtype, copy=True)
    if isinstance(orig, np.ndarray):
        if isinstance(new, torch.Tensor):
            return _to_numpy(new, orig.dtype)
        return np.array(new)
    if isinstance(new, torch.Tensor):
        return new.clone()
    if isinstance(new, np.ndarray):
        return np.array(new)
    return new


def _to_numpy(t: torch.Tensor, dtype: np.dtype) -> np.ndarray:
    """A host tensor's bytes as a numpy array of ``dtype`` (bfloat16's
    ml_dtypes type included, which torch cannot name)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        raw = t.reshape(-1).view(torch.uint8).numpy().copy()
        return raw.view(dtype).reshape(tuple(t.shape))
    return t.numpy().astype(dtype, copy=True)


def _same_structure(a: Any, b: Any) -> bool:
    return tree_flatten(a)[1] == tree_flatten(b)[1]


class State:
    """Committable, broadcastable training state (≙
    ``horovod.elastic.State``): named values, such as parameter trees and
    loop counters, that are committed, rolled back and synchronized
    across ranks as one.

    Values are attributes: ``state.params``, ``state.epoch = 3``.  A value
    added after construction joins the next commit.
    """

    def __init__(self, **values: Any) -> None:
        object.__setattr__(self, "_values", dict(values))
        object.__setattr__(self, "_snapshot", None)
        object.__setattr__(self, "_reset_callbacks", [])
        object.__setattr__(self, "_commit_serial", 0)
        object.__setattr__(self, "_commit_write", None)
        # A snapshot at construction, so that restore() before any
        # commit() returns to the constructed state.
        self._snapshot_now()

    # -- attribute plumbing ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return object.__getattribute__(self, "_values")[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self._values[name] = value

    # -- snapshots ---------------------------------------------------------
    def _snapshot_now(self) -> None:
        object.__setattr__(self, "_snapshot", _host_copy(dict(self._values)))

    def register_reset_callbacks(self, callbacks: List[Callable]) -> None:
        """Callbacks run after a rollback, before the retry (to rebuild
        learning-rate schedules and the like)."""
        self._reset_callbacks.extend(callbacks)

    # -- the contract ------------------------------------------------------
    def commit(self) -> None:
        """Publish the current values as the rollback point.

        Every rank keeps a host snapshot.  With ``HVD_TPU_ELASTIC_DIR``
        set (the elastic launcher exports it) rank 0 also publishes the
        snapshot to disk through the background checkpoint writer: this
        returns after the host copy, and the writer publishes with the
        atomic tmp + rename, in commit order.  :meth:`wait_committed` is
        the durability point; :meth:`sync` and a normal interpreter exit
        fence pending writes."""
        self._snapshot_now()
        object.__setattr__(self, "_commit_serial", self._commit_serial + 1)
        d = _elastic_dir()
        if d is None:
            return
        from .core import state as _state

        if _state.is_initialized() and _state.rank() != 0:
            return
        from .utils import checkpoint as _checkpoint

        # The snapshot is a fresh host copy that restore() and sync()
        # only copy out of: the writer thread may encode it as it is.
        object.__setattr__(self, "_commit_write",
                           _checkpoint.write_tree_async(
                               os.path.join(d, _STATE_FILE),
                               self._snapshot))

    def wait_committed(self, timeout: Optional[float] = None) -> bool:
        """Block until the last :meth:`commit`'s disk publish is durable
        (True at once when commits are host-only).  A writer failure
        raises :class:`..utils.checkpoint.CheckpointError`."""
        w = self._commit_write
        return True if w is None else w.wait(timeout)

    def restore(self) -> None:
        """Roll back to the last :meth:`commit` (or the constructed
        state).  Local only: :meth:`sync` converges the ranks."""
        snap = self._snapshot
        vals = self._values
        for k, committed in snap.items():
            cur = vals.get(k, committed)
            if _same_structure(cur, committed):
                cur_leaves, spec = tree_flatten(cur)
                vals[k] = tree_unflatten(spec, [
                    _like_leaf(c, s) for c, s in
                    zip(cur_leaves, tree_flatten(committed)[0])])
            else:
                vals[k] = _host_copy(committed)
        # Values added after the snapshot are uncommitted: drop them.
        for k in [k for k in vals if k not in snap]:
            del vals[k]

    def _read_value(self, key: str, current: Any, stored: Any) -> Any:
        """One value of a disk commit, read into ``current``'s structure
        (flax's ``from_state_dict``: the target's keys drive)."""
        from .utils import serialization

        return serialization.from_state_dict(
            current, stored, leaf=lambda t, v, _path: _like_leaf(t, v),
            path=(".", key))

    def sync(self) -> None:
        """Converge every rank on the committed state.

        The truth is a previous incarnation's disk commit when there is
        one (the elastic relaunch), else rank 0's current values; either
        way the result is broadcast from rank 0 and becomes every rank's
        rollback point."""
        from .core import state as _state

        d = _elastic_dir()
        path = os.path.join(d, _STATE_FILE) if d else None
        reader = not _state.is_initialized() or _state.rank() == 0
        if path and reader:
            # Fence this process's own commit publish: sync converges on
            # the newest commit, it does not race it.
            from .utils import checkpoint as _checkpoint

            _checkpoint.wait_for_writes()
        if path and reader and os.path.exists(path):
            from .utils import serialization

            with open(path, "rb") as f:
                loaded = serialization.msgpack_restore(f.read())
            missing = {str(k) for k in self._values} - set(loaded)
            if missing:
                raise ValueError(
                    "The target dict keys and state dict keys do not "
                    f"match, target dict contains keys {missing} which "
                    "are not present in state dict at path .")
            for k in list(self._values):
                self._values[k] = self._read_value(k, self._values[k],
                                                   loaded[str(k)])
        if _state.is_initialized() and _state.size() > 1:
            self._agree_structure()
            self._values.update(_broadcast_values(dict(self._values)))
        self._snapshot_now()

    def _agree_structure(self) -> None:
        """Before the broadcast: nothing here; a value whose structure
        differs from rank to rank fails in the broadcast with the
        coordinator's named mismatch, as in the reference."""


def _broadcast_values(values: dict) -> dict:
    """Rank 0's values on every rank, by the reference's
    ``broadcast_parameters``: one negotiated ``broadcast_async`` a leaf
    (``broadcast.param.{i}``, in the tree's leaf order), all queued, then
    synchronized.  Each leaf travels as a tensor on the runtime's device
    and comes back like the value it replaces."""
    from .core import state as _state
    from .ops import collective as C

    dev = _state.device()
    leaves, spec = tree_flatten(values)
    handles = {}
    for i, leaf in enumerate(x for x in leaves if x is not None):
        t = (leaf.detach() if isinstance(leaf, torch.Tensor)
             else torch.as_tensor(np.array(leaf) if isinstance(
                 leaf, np.ndarray) else leaf))
        handles[i] = C.broadcast_async(t.to(dev), 0,
                                       name=f"broadcast.param.{i}")
    out, i = [], 0
    for leaf in leaves:
        if leaf is None:
            out.append(None)
            continue
        out.append(_like_leaf(leaf, C.synchronize(handles[i])))
        i += 1
    return tree_unflatten(spec, out)


def _cluster_reformable() -> bool:
    """Can this process retry in-process, or is a relaunch the job's only
    way on?  A runtime of more than one rank that a failed control
    exchange or a shutdown stopped (``peer_shutdown``, the stopped
    background loop) cannot be re-formed: a rank is lost, and the job's
    torch.distributed group with it."""
    from .core import state as _state

    st = _state._state
    rt = st.runtime
    if st.initialized and st.size > 1 and rt is not None and (
            rt.peer_shutdown or rt._stopped.is_set()):
        return False
    return True


class _Skeleton:
    """One leaf of a state dict's skeleton: a tensor's shape and dtype,
    or the value itself."""

    def __init__(self, x: Any) -> None:
        tensor = isinstance(x, torch.Tensor)
        self.shape = tuple(x.shape) if tensor else None
        self.dtype = x.dtype if tensor else None
        self.value = None if tensor else x

    def build(self) -> Any:
        if self.shape is None:
            return self.value
        return torch.zeros(self.shape, dtype=self.dtype)


def _optimizer_state(trainer: Any) -> dict:
    """The trainer's optimizer state dict; a sharded one's whole state
    (a gather over its ranks: every rank commits)."""
    opt = getattr(trainer, "opt_state", None)
    if opt is not None and callable(getattr(opt, "full_state_dict", None)):
        return opt.full_state_dict()
    return trainer.optimizer.state_dict()


class TrainerState(State):
    """Elastic state bound to a :class:`~.frontends.loop.Trainer` (≙ the
    reference's ``TrainerState``): its parameters, its optimizer's state
    (``opt_state``: the torch optimizer's state dict, the whole one under
    ``zero=``/``fsdp=``) and its model state, with loop counters beside
    them.  :meth:`restore` and :meth:`sync` write them back into the
    trainer: the parameters in place (the optimizer holds those tensors;
    under ``fsdp=True`` the ``params`` setter re-shards), the optimizer
    through ``load_state_dict`` (``load_full_state_dict`` for a sharded
    one), so ``@elastic.run`` functions drive ``trainer.fit`` directly::

        trainer = Trainer(loss_fn, params, ...)
        state = elastic.TrainerState(trainer, epoch=0)

        @elastic.run
        def train(state):
            trainer.fit(batches, epochs, steps, initial_epoch=state.epoch)
            state.epoch = epochs
            state.commit()
    """

    def __init__(self, trainer: Any, **extra: Any) -> None:
        object.__setattr__(self, "_trainer", trainer)
        values = dict(params=trainer.params,
                      opt_state=_optimizer_state(trainer), **extra)
        if trainer.model_state is not None:
            values["model_state"] = trainer.model_state
        super().__init__(**values)

    def _capture(self) -> None:
        t = self._trainer
        self._values["params"] = t.params
        self._values["opt_state"] = _optimizer_state(t)
        if t.model_state is not None:
            self._values["model_state"] = t.model_state

    def _install(self) -> None:
        t = self._trainer
        params = self._values["params"]
        if getattr(t, "_fsdp", False):
            t.params = params
        else:
            live, _ = tree_flatten(t.params)
            with torch.no_grad():
                for dst, src in zip(live, tree_flatten(params)[0]):
                    if dst is not src:
                        dst.copy_(src)
            self._values["params"] = t.params
        opt = getattr(t, "opt_state", None)
        if opt is not None and callable(
                getattr(opt, "load_full_state_dict", None)):
            opt.load_full_state_dict(self._values["opt_state"])
        else:
            t.optimizer.load_state_dict(self._values["opt_state"])
        if "model_state" in self._values:
            t.model_state = self._values["model_state"]

    def _agree_structure(self) -> None:
        """torch creates optimizer state at the first step, so a fresh
        incarnation's ranks hold none while rank 0 read a commit that
        has it.  Rank 0's state-dict skeleton (each tensor's shape and
        dtype) goes first by an object broadcast; a rank whose structure
        differs takes zeros of it, which the per-leaf broadcast then
        fills with rank 0's values."""
        from .ops.objects import broadcast_object

        mine = self._values["opt_state"]
        theirs = broadcast_object(tree_map(_Skeleton, mine), root_rank=0,
                                  name="elastic.opt_state.skeleton")
        leaves, spec = tree_flatten(theirs)
        if spec != tree_flatten(mine)[1]:
            self._values["opt_state"] = tree_unflatten(
                spec, [leaf.build() for leaf in leaves])

    def _read_value(self, key: str, current: Any, stored: Any) -> Any:
        if key != "opt_state":
            return super()._read_value(key, current, stored)
        # torch creates optimizer state lazily: a fresh incarnation's
        # optimizer has none yet, so the stored state is read without a
        # target, its containers shaped by the live state dict's.
        from .utils.checkpoint import _like

        return _like(current, stored)

    def commit(self) -> None:
        self._capture()
        super().commit()

    def restore(self) -> None:
        super().restore()
        self._install()

    def sync(self) -> None:
        self._capture()
        super().sync()
        self._install()


def serving_export_payload(engine: Any,
                           exported: Optional[List[dict]] = None) -> dict:
    """The serving migration payload: the requests (queued, and in flight
    as continuations) and the shared-prefix index as maximal token
    chains.  ``exported`` is the export of a drain the caller already
    made (a second ``export_requests`` after it would be empty).  Shared
    by :class:`ServingState`'s commit blob and the server's ``POST
    /drain``."""
    if exported is None:
        exported = engine.export_requests()
    export = getattr(engine, "export_prefix_index", None)
    return {"requests": exported,
            "prefixes": export() if export is not None else []}


def serving_install_payload(engine: Any, payload: Any) -> List[dict]:
    """Install a :func:`serving_export_payload` dict into an engine:
    drain what it holds (the committed set replaces it wholesale),
    ghost-seed the shared-prefix chains, then resubmit.  A bare request
    list (the format before the prefix index) is accepted.  Returns the
    requests installed."""
    if isinstance(payload, list):
        payload = {"requests": payload, "prefixes": []}
    engine.drain()
    seed = getattr(engine, "seed_prefixes", None)
    if seed is not None and payload.get("prefixes"):
        seed(payload["prefixes"])
    requests = payload.get("requests", [])
    engine.import_requests(requests)
    return requests


class ServingState(State):
    """Elastic state of a serving fleet (an
    :class:`~.serving.engine.InferenceEngine`): ``drain_commit()``
    captures every queued and in-flight request (in-flight ones as
    continuations carrying what they generated), commits it like
    training state and stops admission; after the relaunch, ``sync()`` on
    a fresh engine resubmits the committed work.  Greedy continuations
    reproduce the uninterrupted rollout exactly (the serving bitwise
    contract), so a resize does not show in the completions.

    The payload rides the commit as a JSON blob in a uint8 tensor (its
    length changes from commit to commit) and carries the prefix index,
    so the relaunched fleet rebuilds the shared pages on ``sync()``.

    Usage::

        state = elastic.ServingState(engine)
        ...
        state.drain_commit(); state.wait_committed()
        # the relaunched incarnation:
        state = elastic.ServingState(fresh_engine)
        state.sync()          # resubmits the committed requests
    """

    def __init__(self, engine: Any, **extra: Any) -> None:
        object.__setattr__(self, "_engine", engine)
        super().__init__(requests_blob=self._blob(), **extra)

    def _blob(self, exported: Optional[List[dict]] = None) -> torch.Tensor:
        payload = serving_export_payload(self._engine, exported)
        return torch.frombuffer(bytearray(json.dumps(payload).encode()),
                                dtype=torch.uint8)

    def _capture(self) -> None:
        self._values["requests_blob"] = self._blob()

    def _install(self) -> None:
        blob = self._values["requests_blob"]
        text = bytes(blob.cpu().numpy()).decode() if isinstance(
            blob, torch.Tensor) else bytes(np.asarray(blob)).decode()
        serving_install_payload(self._engine, json.loads(text or "[]"))

    def commit(self) -> None:
        self._capture()
        super().commit()

    def drain_commit(self) -> List[dict]:
        """Resize, step 1: drain the engine (admission stops, in-flight
        sequences become continuations) and commit them with the prefix
        index, exported after the drain so that the pages the evictions
        just released are in it.  Returns the export."""
        exported = self._engine.drain()
        self._values["requests_blob"] = self._blob(exported)
        super().commit()
        return exported

    def restore(self) -> None:
        super().restore()
        self._install()

    def sync(self) -> None:
        super().sync()
        self._install()


def run(func: Callable) -> Callable:
    """Make a training function elastic (≙ ``@hvd.elastic.run``).

    ``func(state, ...)`` runs after a first ``state.sync()``, which
    resumes a relaunched job from its previous incarnation's commit.  On
    a ``HorovodError``:

    * the job still whole: ``state.restore()``, the reset callbacks,
      ``state.sync()``, and a retry (``HVD_TPU_ELASTIC_MAX_RETRIES``
      consecutive failures of one incident, default 3; committed
      progress starts a new incident);
    * a member lost: under the elastic launcher (``HVD_TPU_ELASTIC=1``)
      exit ``EX_TEMPFAIL`` so the job is relaunched from the last commit;
      otherwise re-raise.

    Only ``HorovodError`` is caught, as in the reference: a dead peer
    inside a direct ``torch.distributed`` call (the monolithic and
    sharded steps' own collectives) raises torch's error and ends the
    process (ROADMAP.md §C.3)."""

    @functools.wraps(func)
    def wrapper(state: State, *args: Any, **kwargs: Any) -> Any:
        from .ops.collective import HorovodError

        state.sync()
        retries = int(os.environ.get("HVD_TPU_ELASTIC_MAX_RETRIES", "3"))
        attempt = 0
        last_serial = -1
        while True:
            try:
                return func(state, *args, **kwargs)
            except HorovodError as e:
                if not _cluster_reformable():
                    if os.environ.get("HVD_TPU_ELASTIC"):
                        print(
                            "horovod_tpu_torch.elastic: collective failure "
                            f"with an unrecoverable cluster ({e}); exiting "
                            f"EX_TEMPFAIL({EX_TEMPFAIL}) for the elastic "
                            "launcher to relaunch from the last commit.",
                            file=sys.stderr, flush=True)
                        sys.exit(EX_TEMPFAIL)
                    raise
                if state._commit_serial > last_serial and last_serial >= 0:
                    # Committed progress since the previous incident: the
                    # budget bounds the failures of one incident, not the
                    # job's lifetime.
                    attempt = 0
                last_serial = state._commit_serial
                attempt += 1
                if attempt > retries:
                    raise
                print(
                    f"horovod_tpu_torch.elastic: retrying after {e} "
                    f"(attempt {attempt}/{retries}); rolling back to the "
                    "last commit.", file=sys.stderr, flush=True)
                state.restore()
                for cb in state._reset_callbacks:
                    cb()
                state.sync()

    return wrapper
