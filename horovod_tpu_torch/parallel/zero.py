"""ZeRO-1 data parallelism: the optimizer state sharded across ranks (port
of horovod_tpu/parallel/zero.py).

An allreduce is a reduce-scatter followed by an all-gather, so instead of

    allreduce(grads) -> the full optimizer update on every rank   (plain DP)

each rank reduces only its contiguous 1/N slice of the flattened
gradient, steps the optimizer on that slice (holding 1/N of the
optimizer state: for Adam 2/N of the model instead of 2x), and the
updated slices are all-gathered back into the full parameters:

    g_shard = psum_scatter(flat_grads)        # the bytes of the allreduce
    p_shard = optimizer step on (p_shard, g_shard)
    params  = unravel(all_gather(p_shard))

**The flat layout** (:class:`FlatLayout`, :func:`_pad_flat`) is the
counterpart of ``jax.flatten_util.ravel_pytree``: the leaves in
:mod:`..utils.tree`'s sorted-key order, concatenated in the promoted
dtype of all leaves, zero-padded to a multiple of N.  Rank ``i`` holds
``[i * chunk, (i + 1) * chunk)``.  It is defined here once; the ZeRO and
the FSDP (:mod:`.fsdp`) builders both use it.

**The optimizer** is a factory, ``optimizer_fn(list_of_tensors) ->
torch.optim.Optimizer`` (``lambda ps: torch.optim.AdamW(ps, lr=3e-4)``):
an optax transformation applies to any vector, a torch optimizer is
built over its tensors.  A :class:`.data.DistributedOptimizer` is also
taken: its averaging flag and compression are honoured and its inner
optimizer is rebuilt over the shard from its class and its one param
group's hyperparameters.  The optimizer steps one persistent flat shard
that it owns (torch keys its state by tensor), into which each step
copies the rank's slice of the current parameters.

**The elementwise precondition** (inherent to ZeRO-1): the optimizer
must treat each element on its own (SGD, momentum, Adam, AdamW,
RMSprop...).  One that aggregates across the tree (a clip by the global
norm) would see only the local shard and silently train wrong.  The
builder probes the optimizer (:func:`_check_elementwise`): one update of
a 16-value vector must equal updates of its two halves with independent
states, else it raises naming the alternatives (clip per element; clip
by the global norm outside the optimizer; ``validate_elementwise=False``
to accept shard-local semantics).

Usage::

    zstep = make_zero_train_step(loss_fn,
                                 lambda ps: torch.optim.AdamW(ps, lr=3e-4))
    opt_state = zstep.init(params)              # this rank's shard
    params, opt_state, loss = zstep.step(params, opt_state, batch)

``params`` are the same leaf tensors, updated in place.  The reference's
buffer donation has no counterpart (PyTorch updates in place).
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, List, NamedTuple, Sequence

import numpy as np
import torch

from ..core import state as _state
from ..core.topology import MeshAxis
from ..utils.tree import tree_flatten, tree_unflatten
from . import axis_ops
from .data import DistributedOptimizer

REPLICA_AXIS = "hvd"  # the reference's replica axis (core/state.py)


class ZeroTrainStep(NamedTuple):
    """``init(params) -> opt_state`` (this rank's shard and its
    optimizer) and ``step(params, opt_state, batch) -> (params,
    opt_state, loss)``, or, from :func:`make_zero_train_step_with_state`,
    ``step(params, model_state, opt_state, batch) -> (params,
    model_state, opt_state, loss)``."""

    init: Callable[[Any], Any]
    step: Callable[..., Any]


class ShardState:
    """One rank's slice of the flat parameter vector (``shard``, a leaf
    tensor of ``chunk`` elements) and the optimizer that owns it: the
    opaque optimizer state of the ZeRO and FSDP steps, sharded over
    ``axis`` (``None``: one rank).

    ``state_dict()``/``load_state_dict()`` are this rank's slice, as a
    torch optimizer's.  A checkpoint holds the whole flat vector's state,
    as the reference's one global array does: ``full_state_dict()``
    all-gathers each per-element state tensor over ``axis`` (a
    collective), ``load_full_state_dict()`` takes this rank's slice of
    such a state."""

    def __init__(self, shard: torch.Tensor,
                 optimizer: torch.optim.Optimizer, axis=None):
        self.shard = shard
        self.optimizer = optimizer
        self.axis = axis

    def state_dict(self) -> dict:
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict: dict) -> None:
        """Restore the shard's optimizer from this rank's ``state_dict()``.
        The shard's values need no restore: the ZeRO step copies the
        parameters' slice into it, and the FSDP step its ``p_shard``."""
        self.optimizer.load_state_dict(state_dict)

    def _per_element(self, state_dict: dict, fn) -> dict:
        """``state_dict`` with ``fn`` applied to each state tensor of
        ndim >= 1 (the per-element slices; a step count stays)."""
        out = dict(state_dict)
        out["state"] = {
            k: {name: fn(v) if isinstance(v, torch.Tensor) and v.dim() >= 1
                else v for name, v in st.items()}
            for k, st in state_dict["state"].items()}
        return out

    def full_state_dict(self) -> dict:
        """The optimizer's state over the whole padded flat vector, on
        every rank of ``axis``: every rank of the axis must call it."""
        state = self.state_dict()
        if self.axis is None or self.axis.size == 1:
            return state
        return self._per_element(
            state, lambda v: axis_ops._all_gather(v, self.axis, 0))

    def load_full_state_dict(self, state_dict: dict) -> None:
        """Restore the shard's optimizer from a ``full_state_dict()``:
        each per-element tensor's slice ``[index * chunk, (index + 1) *
        chunk)``."""
        n, i = ((1, 0) if self.axis is None
                else (self.axis.size, self.axis.index))
        c = self.shard.numel()

        def mine(v):
            if v.shape[0] != n * c:
                raise ValueError(
                    f"the saved optimizer state holds {v.shape[0]} "
                    f"elements, the flat vector {n} x {c} = {n * c} at "
                    f"this world: restore at the world of the save")
            return v[i * c:(i + 1) * c].clone()

        self.load_state_dict(self._per_element(state_dict, mine))


def _result_type(dtypes: Sequence[torch.dtype]) -> torch.dtype:
    """The promoted dtype of all leaves (``jnp.result_type``)."""
    out = dtypes[0]
    for dt in dtypes[1:]:
        out = torch.promote_types(out, dt)
    return out


class FlatLayout:
    """How a parameter tree lies in one flat vector over ``n`` ranks: its
    leaves in tree order, in the promoted ``dtype``, zero-padded to
    ``n * chunk`` elements, ``true_size`` of them real."""

    def __init__(self, tree, n: int):
        leaves, self.spec = tree_flatten(tree)
        self.shapes = [tuple(leaf.shape) for leaf in leaves]
        self.dtypes = [leaf.dtype for leaf in leaves]
        self.sizes = [leaf.numel() for leaf in leaves]
        self.dtype = _result_type(self.dtypes)
        self.true_size = sum(self.sizes)
        self.chunk = -(-self.true_size // n)
        self.n = n
        self.signature = (self.spec, tuple(zip(self.shapes, self.dtypes)))

    def flatten(self, leaves: List[torch.Tensor]) -> torch.Tensor:
        """The padded flat vector of ``leaves`` (detached)."""
        parts = [leaf.detach().reshape(-1).to(self.dtype) for leaf in leaves]
        pad = self.n * self.chunk - self.true_size
        if pad:
            parts.append(parts[0].new_zeros(pad))
        return torch.cat(parts)

    def shard(self, leaves: List[torch.Tensor], index: int) -> torch.Tensor:
        """Rank ``index``'s contiguous slice ``[index * chunk, (index + 1)
        * chunk)`` of the padded flat vector, a new tensor (reference
        ``_flat_shard`` :93)."""
        c = self.chunk
        return self.flatten(leaves)[index * c:(index + 1) * c].clone()

    def unravel_leaves(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Each leaf as a view of ``flat`` (a cast where its dtype is not
        the flat's), so a backward through them writes one flat
        gradient."""
        parts = flat[:self.true_size].split(self.sizes)
        return [p.view(shape).to(dt) for p, shape, dt
                in zip(parts, self.shapes, self.dtypes)]

    def unravel(self, flat: torch.Tensor):
        return tree_unflatten(self.spec, self.unravel_leaves(flat))


def _pad_flat(tree, n: int):
    """Flatten a tree to one vector zero-padded to a multiple of n
    (reference :80).  Returns ``(flat, unravel, true_size)``."""
    layout = FlatLayout(tree, n)
    return (layout.flatten(tree_flatten(tree)[0]), layout.unravel,
            layout.true_size)


def replica_axis(mesh=None) -> MeshAxis:
    """The axis the sharded steps reduce over: the mesh's ``data`` axis,
    or, with no mesh, one spanning every rank of the job (the reference's
    replica axis ``"hvd"``, on the job's group)."""
    if mesh is not None:
        return mesh.axis("data")
    n = _state.size()
    return MeshAxis(name=REPLICA_AXIS, size=n, index=_state.rank(),
                    ranks=tuple(range(n)))


def _optimizer_factory(optimizer, average, compression):
    """``(factory, average, compression)``: a
    :class:`.data.DistributedOptimizer` is unwrapped (its averaging flag
    and compression win, reference :235-239) and its inner optimizer
    rebuilt from its class and its param group's hyperparameters."""
    if not isinstance(optimizer, DistributedOptimizer):
        if isinstance(optimizer, torch.optim.Optimizer) or not callable(
                optimizer):
            raise TypeError(
                "the sharded steps take an optimizer factory, "
                "optimizer_fn(list_of_tensors) -> torch.optim.Optimizer "
                "(e.g. lambda ps: torch.optim.AdamW(ps, lr=3e-4)), or a "
                f"DistributedOptimizer; got {type(optimizer).__name__}")
        return optimizer, average, compression
    inner = optimizer._inner
    if len(inner.param_groups) != 1:
        raise ValueError(
            f"the sharded steps update one flat shard, which is one param "
            f"group; the DistributedOptimizer's {type(inner).__name__} has "
            f"{len(inner.param_groups)}")
    group = inner.param_groups[0]
    hyper = {k: group[k] for k in inner.defaults if k in group}
    if optimizer._compression is not None:
        compression = optimizer._compression
    return ((lambda ps: type(inner)(ps, **hyper)), optimizer._average,
            compression)


def _one_update(optimizer_fn, values: torch.Tensor) -> np.ndarray:
    """The update (new - old) of one optimizer step over a parameter
    equal to ``values``, with ``values`` as its gradient."""
    p = values.clone().requires_grad_(True)
    opt = optimizer_fn([p])
    p.grad = values.clone()
    opt.step()
    return (p.detach() - values).numpy()


def _check_elementwise(optimizer_fn, feature: str = "ZeRO-1",
                       api_name: str = "make_zero_train_step") -> None:
    """Build-time probe of the elementwise-optimizer precondition
    (reference :146): an optimizer built over the 16-value probe and
    stepped once with it as the gradient must equal two, built over each
    half and stepped the same way.  The probe values are large (~1e4),
    so a norm-dependent optimizer with any realistic threshold takes its
    data-dependent branch.  The probe runs in float64 on the CPU, so the
    update, the new parameter less the old, keeps every digit the
    comparison needs.  An optimizer whose ``step()`` needs arguments (a
    ``closure``, as ``LBFGS``'s) cannot be probed: warn and skip."""
    probe = torch.from_numpy(np.linspace(1.0e4, -3.0e4, 16,
                                         dtype=np.float64))
    try:
        full = _one_update(optimizer_fn, probe)
        parts = np.concatenate([_one_update(optimizer_fn, part)
                                for part in (probe[:8], probe[8:])])
    except TypeError as e:
        warnings.warn(
            f"{api_name} could not probe the optimizer for the "
            f"elementwise precondition ({e}); proceeding unchecked — "
            "ensure no transform aggregates across parameters "
            "(see horovod_tpu_torch/parallel/zero.py docstring)")
        return
    if not np.allclose(full, parts, rtol=1e-5, atol=1e-5):
        raise ValueError(
            f"{feature} requires an ELEMENTWISE optimizer: updating a "
            "vector must equal updating its parts independently, because "
            "each replica will only ever see its 1/N shard of the "
            "gradients and optimizer state.  The given optimizer "
            "failed that probe — it aggregates across parameters (e.g. "
            "a clip by the GLOBAL gradient norm, but under "
            f"{feature} each replica would clip by its "
            "shard's norm, silently training wrong).  Alternatives: "
            "clip per element (clamp each gradient element); clip by "
            "global norm OUTSIDE the optimizer on the full gradient "
            f"before {feature} sees it; or pass validate_elementwise="
            "False to accept shard-local semantics.")


def _state_or_raise(optimizer_fn, chunk: int, dtype,
                    feature: str = "ZeRO-1",
                    api_name: str = "make_zero_train_step") -> None:
    """Refuse an optimizer whose state has a tensor of ndim >= 1 that is
    not one per-parameter slice (reference :114).  torch creates the
    state at the first ``step()``, so a throwaway optimizer of the same
    kind steps once over a small CPU vector of ``k = min(chunk, 61)``
    elements, and every state tensor of ndim >= 1 must be ``(k,)``."""
    k = min(chunk, 61)
    p = torch.zeros(k, dtype=dtype, requires_grad=True)
    opt = optimizer_fn([p])
    p.grad = torch.ones_like(p)
    try:
        opt.step()
    except TypeError:
        return  # its step() needs a closure: it cannot be checked
    bad = [tuple(v.shape) for st in opt.state.values() for v in st.values()
           if isinstance(v, torch.Tensor) and v.dim() >= 1
           and tuple(v.shape) != (k,)]
    if bad:
        raise ValueError(
            f"{feature} shards every non-scalar optimizer-state "
            "leaf over the replica axis, so each such leaf must "
            f"be one ({chunk},)-shaped per-parameter slice; the "
            f"given optimizer's state has leaves of shape {bad}. "
            "This usually means a non-elementwise optimizer or "
            "a tensor-valued hyperparameter — keep those outside "
            f"{api_name} (see parallel/zero.py docstring).")


def _reduce_shard(flat_g, axis, compression, average):
    """This rank's slice of the flat gradient summed over ``axis``
    (compressed on the wire if asked: the int8/int4 compressors raise in
    ``compress``, as the reference's do), divided by the rank count when
    averaging."""
    if compression is not None:
        flat_g, ctx = compression.compress(flat_g)
    g_shard = axis_ops._psum_scatter(flat_g, axis, 0)
    if compression is not None:
        g_shard = compression.decompress(g_shard, ctx)
    return g_shard / axis.size if average else g_shard


def _pmean(tree, axis):
    """Each leaf averaged over ``axis`` (all reductions started, then
    waited for), as a new tree."""
    leaves, spec = tree_flatten(tree)
    works: list = []
    sums = [axis_ops._psum(leaf.detach(), axis, works) for leaf in leaves]
    for work in works:
        work.wait()
    return tree_unflatten(spec, [s / axis.size for s in sums])


def _grad(p):
    """``p``'s gradient, zeros where it has none (as
    ``DistributedOptimizer.synchronize``)."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


def make_zero_train_step(
    loss_fn,
    optimizer,
    mesh=None,
    average: bool = True,
    compression=None,
    has_state: bool = False,
    validate_elementwise: bool = True,
) -> ZeroTrainStep:
    """Build a ZeRO-1 data-parallel train step (reference :197).

    Args:
      loss_fn: ``loss_fn(params, batch) -> scalar`` on this rank's batch,
        or, with ``has_state=True``, ``loss_fn(params, model_state,
        batch) -> (scalar, new_model_state)`` (BatchNorm-style models;
        the new state is averaged over ranks as
        :func:`~.training.make_train_step_with_state` does).
      optimizer: an elementwise optimizer factory,
        ``optimizer_fn(list_of_tensors) -> torch.optim.Optimizer``, or a
        :class:`.data.DistributedOptimizer` (its averaging flag and
        compression are honoured; its ``fusion_threshold`` does not
        apply: the flattened gradient is one maximal fusion bucket).
      mesh: a :class:`~..core.topology.Mesh` whose ``data`` axis the
        gradient is reduced over; default every rank of the job.
      average: average (True) or sum (False) gradients across ranks.
      compression: ``Compression.{bf16,fp16}`` casts the gradient down
        for the reduce-scatter (the parameter all-gather stays
        uncompressed: it carries the master weights).

    Returns:
      :class:`ZeroTrainStep`.  ``init(params)`` returns a
      :class:`ShardState`: this rank's ``(chunk,)`` shard and the
      optimizer over it.
    """
    optimizer_fn, average, compression = _optimizer_factory(
        optimizer, average, compression)
    if validate_elementwise:
        _check_elementwise(optimizer_fn)
    axis = replica_axis(mesh)
    n = axis.size

    def init(params) -> ShardState:
        layout = FlatLayout(params, n)
        _state_or_raise(optimizer_fn, layout.chunk, layout.dtype)
        shard = layout.shard(tree_flatten(params)[0], axis.index)
        shard.requires_grad_(True)
        return ShardState(shard, optimizer_fn([shard]), axis)

    def _step(params, model_state, opt_state, batch):
        leaves = tree_flatten(params)[0]
        layout = FlatLayout(params, n)
        for p in leaves:
            p.grad = None
        if has_state:
            loss, model_state = loss_fn(params, model_state, batch)
        else:
            loss = loss_fn(params, batch)
        loss.backward()
        flat_g = layout.flatten([_grad(p) for p in leaves])
        for p in leaves:
            p.grad = None
        g_shard = _reduce_shard(flat_g, axis, compression, average)
        del flat_g
        shard = opt_state.shard
        with torch.no_grad():
            # The slice of the current parameters, so that a broadcast or
            # restore between steps is seen (reference :273).
            shard.copy_(layout.shard(leaves, axis.index))
        shard.grad = g_shard.to(shard.dtype)
        opt_state.optimizer.step()
        shard.grad = None
        flat_p = axis_ops._all_gather(shard.detach(), axis, 0)
        with torch.no_grad():
            for leaf, new in zip(leaves, layout.unravel_leaves(flat_p)):
                leaf.copy_(new)
        loss = _pmean(loss, axis)
        if has_state:
            return params, _pmean(model_state, axis), opt_state, loss
        return params, opt_state, loss

    if has_state:
        step = _step
    else:
        def step(params, opt_state, batch):
            return _step(params, None, opt_state, batch)

    return ZeroTrainStep(init=init, step=step)


def make_zero_train_step_with_state(loss_fn, optimizer, mesh=None,
                                    average: bool = True,
                                    compression=None,
                                    validate_elementwise: bool = True,
                                    ) -> ZeroTrainStep:
    """Stateful-model spelling (BatchNorm etc.) of
    :func:`make_zero_train_step` (reference :345): ``loss_fn(params,
    state, batch) -> (loss, state)``; ``step(params, model_state,
    opt_state, batch) -> (params, model_state, opt_state, loss)``."""
    return make_zero_train_step(loss_fn, optimizer, mesh=mesh,
                                average=average, compression=compression,
                                has_state=True,
                                validate_elementwise=validate_elementwise)
