"""Backward/communication overlap: the bucketed-backward train step (port
of horovod_tpu/parallel/overlap.py).

The monolithic step (:mod:`.training`, ``HVD_TPU_OVERLAP=off``) runs the
whole backward, then reduces every gradient bucket.  This step streams
the buckets out of the backward instead, on the negotiated collectives
of :mod:`..ops.collective`:

* **Bucket plan** -- gradient leaves partition into buckets by wire
  dtype and size with the rule of the monolithic path
  (:func:`.data.partition_fusion_buckets`), bounded by the fusion
  threshold, so each bucket is one fused response: one reduction of the
  executor (:func:`..ops.megakernel.launch`), one group the response
  cache replays without negotiation from the second step on, and under
  an int8/int4 policy one quantized group with its own error-feedback
  residual (the residual is keyed by the bucket's names).
* **Segmented backward** -- when the loss is a :class:`ChainedLoss`, the
  forward keeps each stage's boundary activation as a detached tensor
  that requires grad (:func:`stage_boundary`), and the backward runs
  stage by stage in reverse, ``torch.autograd.backward(stage_out,
  grad_tensors=ct)`` (the reference's per-stage VJP).  Each stage's
  buckets are enqueued, and a cycle run, as soon as its backward has
  been enqueued: on the GPU the executor's stream waits for the event
  recorded on the compute stream and reduces the bucket while the
  earlier stages' backward runs.  A plain callable loss keeps one
  backward and streams its buckets after it; so does a loss with aux
  (``make_train_step(..., has_aux=True)``) or with model state
  (``make_train_step_with_state``), whose aux or new BatchNorm
  statistics are averaged after the update by the monolithic step's own
  call (``training._average_extra``), as the reference's unsegmented
  path does (reference :632-674).
* **Atomic buckets** -- one bucket is one ``grouped_allreduce_async``,
  and ``Runtime.enqueue`` holds the queue's lock across all of its
  requests; the cycle takes its snapshot under that lock (the
  reference's ``_drain_lock``).  Each rank's batch therefore carries a
  bucket whole, every tensor of it becomes ready in one cycle, and the
  coordinator fuses it into one response.

**Bitwise contract**: with full-precision wire formats the overlapped
step's losses and parameters equal the monolithic step's, bitwise, on 1
and 2 ranks: the stage-by-stage backward runs the same kernels on the
same values, the buckets are reduced with Sum and divided after the
decompress in the leaf's dtype as the monolithic path does, and a sum of
two ranks' values does not depend on where the value sits in the buffer
(with more ranks gloo's ring sums an element in an order that does).
Under a quantized policy the monolithic path does not quantize at all,
so the comparator is ``serial``: the same buckets dispatched after the
whole backward, with the same blocks, ticks and residuals.

Env contract (validated at ``init``, and part of the env fingerprint
``init`` compares across ranks):

  HVD_TPU_OVERLAP=auto|on|off|serial  (1/0 alias on/off)
      auto (default): on for a ChainedLoss of two or more stages with
      CUDA and more than one rank, off otherwise (one rank reduces
      nothing; the CPU has no second engine to hide the reduction under;
      a plain loss has one backward and nothing to hide its buckets
      under, so it keeps the monolithic step's direct reduction).
      on: the streaming schedule.  serial: the same buckets, dispatched
      after the whole backward has run (a host fence).  off: the
      monolithic step.

Tensor names: every bucket is negotiated under its wire name
``overlap.p<step>.g<bucket>.<i>``, and the compression policy looks a
format up by that name, as the reference's overlapped step does.  A
per-name rule written for the parameters' names (``set_compression(
rules=...)``) does not match a bucket; the default, a set override or a
rule on the wire names applies to the whole bucket.

Named fallbacks to the monolithic step of the same kind (each warns once
on stderr and counts ``overlap.fallbacks``): ``adasum`` (combines the
whole gradient), ``sparse`` (a sparse gradient's payload is negotiated
per step), ``grad-tree`` (the optimizer's parameters are not the
parameter tree's leaves in order, so a bucket's gradients cannot be
placed) and ``nonstatic-compression`` (a compressor whose context is a
tensor).  The reference's ``mp-local-replicas`` and ``mp-mesh-order``
have no counterpart (the port runs one process per device), nor has its
``sub-mesh`` (the port's monolithic step reduces over the whole job).
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Callable, List, Optional, Sequence

import torch

from .. import telemetry as _telemetry
from ..core import state as _state
from ..ops import collective as C
from ..ops.compression import NoneCompressor
from ..ops.wire import ReduceOp
from ..utils.tree import tree_leaves, tree_map
from .data import _resolve_grad_op, partition_fusion_buckets

OVERLAP_ENV = "HVD_TPU_OVERLAP"
_VALID_MODES = ("auto", "on", "off", "serial")


def _normalize(v: str) -> str:
    v = v.strip().lower()
    return {"1": "on", "0": "off"}.get(v, v) or "auto"


def overlap_mode() -> str:
    """Normalized ``HVD_TPU_OVERLAP`` (``1``/``0`` alias on/off)."""
    return _normalize(os.environ.get(OVERLAP_ENV, "auto"))


def validate_env() -> None:
    """Fail ``init``, not the first step, on a malformed knob."""
    v = os.environ.get(OVERLAP_ENV)
    if v and overlap_mode() not in _VALID_MODES:
        raise ValueError(
            f"{OVERLAP_ENV}={v!r}: expected one of "
            f"{'|'.join(_VALID_MODES)} (1/0 alias on/off)")


def resolve_mode(override: Optional[str], device, size: int,
                 loss_fn=None) -> str:
    """The step's schedule, ``"stream"``, ``"serial"`` or ``"off"``, from
    ``override`` or the knob.  ``auto`` streams only a segmented loss
    (:func:`segmented`) on CUDA with more than one rank."""
    mode = _normalize(override or overlap_mode())
    if mode not in _VALID_MODES:
        raise ValueError(
            f"overlap={mode!r}: expected one of {'|'.join(_VALID_MODES)}")
    if mode == "auto":
        return "stream" if torch.device(device).type == "cuda" \
            and size > 1 and segmented(loss_fn) else "off"
    return "stream" if mode == "on" else mode


def segmented(loss_fn) -> bool:
    """Whether the step runs ``loss_fn``'s backward stage by stage: a
    :class:`ChainedLoss` of two or more stages."""
    return isinstance(loss_fn, ChainedLoss) and len(loss_fn.stages) >= 2


def stage_boundary(carry):
    """The carry handed to the next stage: each tensor detached from the
    graph that made it, and (floating point) requiring grad, so that the
    next stage's backward stops there and leaves the cotangent in its
    ``.grad``."""
    return tree_map(lambda x: x.detach().requires_grad_(x.is_floating_point())
                    if isinstance(x, torch.Tensor) else x, carry)


class ChainedLoss:
    """A loss in sequential stages, the form the overlapped step streams
    buckets out of.

    ``stages`` are ``stage(stage_params, carry, batch)`` functions: stage
    0 gets ``carry=None`` and builds the first activation from ``batch``;
    each later stage maps its predecessor's carry (a tensor or a tree of
    them) to its own; the last returns the scalar loss.  The parameters
    passed to the step are a sequence with one tree per stage.  Calling
    the object evaluates the chain in one graph, which is what the
    monolithic step differentiates."""

    def __init__(self, stages: Sequence[Callable]):
        self.stages = list(stages)
        if not self.stages:
            raise ValueError("ChainedLoss needs at least one stage")

    def _check_params(self, params) -> list:
        seq = isinstance(params, (list, tuple))
        if not seq or len(params) != len(self.stages):
            raise ValueError(
                f"ChainedLoss expects params as a sequence with one entry "
                f"per stage ({len(self.stages)}); got "
                f"{type(params).__name__} of length "
                f"{len(params) if seq else 'n/a'}")
        return list(params)

    def __call__(self, params, batch):
        carry = None
        for f, p in zip(self.stages, self._check_params(params)):
            carry = f(p, carry, batch)
        return carry


# ---------------------------------------------------------------------------
# Bucket plan
# ---------------------------------------------------------------------------

@dataclass
class _Bucket:
    gi: int                 # global bucket index (stable wire names)
    local_pos: List[int]    # positions within the segment's leaves
    global_idx: List[int]   # positions within all leaves
    nbytes: int


@dataclass
class _Segment:
    buckets: List[_Bucket] = field(default_factory=list)


@dataclass
class _Plan:
    threshold: int
    segments: List[_Segment]
    n_leaves: int

    @property
    def n_buckets(self) -> int:
        return sum(len(s.buckets) for s in self.segments)


def _build_plan(seg_specs: List[List[Any]], threshold: int) -> _Plan:
    """Partition each segment's leaves (``shape`` and wire ``dtype``) into
    buckets with the fusion rule.  Buckets never span segments: a bucket
    is dispatched as soon as its segment's gradients exist."""
    segments: List[_Segment] = []
    gi = offset = 0
    for specs in seg_specs:
        seg = _Segment()
        for local in partition_fusion_buckets(specs, threshold):
            nbytes = 0
            for p in local:
                n = specs[p].dtype.itemsize
                for d in specs[p].shape:
                    n *= int(d)
                nbytes += n
            seg.buckets.append(_Bucket(gi=gi, local_pos=list(local),
                                       global_idx=[offset + p for p in local],
                                       nbytes=nbytes))
            gi += 1
        segments.append(seg)
        offset += len(specs)
    return _Plan(threshold=threshold, segments=segments, n_leaves=offset)


# ---------------------------------------------------------------------------
# In-flight window
# ---------------------------------------------------------------------------

def _max_inflight() -> int:
    """Buckets a CPU step may have dispatched and not yet executed:
    ``HVD_TPU_MAX_INFLIGHT`` (default 2; reference :345-349)."""
    try:
        return max(1, int(os.environ.get("HVD_TPU_MAX_INFLIGHT", "2")))
    except ValueError:
        return 2


class _InflightWindow:
    """At most ``depth`` dispatched buckets whose response has not been
    executed (reference :352).  The CPU runs the step and the gloo
    collectives on the same cores, so the window keeps the queue of
    pending buckets short; the GPU never builds one.  It registers with
    hvd-tune's actuation, whose ``max_inflight`` knob resizes it live."""

    def __init__(self, depth: int, stats: dict):
        self._depth = depth
        self._q: collections.deque = collections.deque()
        self._stats = stats
        from ..tuning import actuation as _actuation

        _actuation.register_inflight_window(self)

    def resize(self, depth: int) -> None:
        """hvd-tune's live retune: a shrink waits down to the new depth at
        the next ``admit``, never here (the cycle that applies the marker
        must not wait on a bucket)."""
        self._depth = max(1, int(depth))

    def admit(self, handles: List[int]) -> None:
        self._q.append(handles)
        rt = C._runtime()
        while len(self._q) > self._depth:
            oldest = self._q.popleft()
            t0 = time.perf_counter()
            for hid in oldest:
                h = rt.handles.get(hid)
                if not h.done.is_set():
                    rt.wait(h)
            self._stats["overlap.host_stall_seconds"] += \
                time.perf_counter() - t0


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def dispatch_bucket_segment(prefix: str, seg: _Segment, seg_leaves: List,
                            handles: List[Optional[int]], tl, stats: dict,
                            window: Optional[_InflightWindow] = None,
                            alone: bool = False) -> None:
    """Hand one segment's buckets to the negotiated path: each bucket is
    one atomic enqueue (see the module docstring) named
    ``<prefix>.g<bucket>.<i>``, followed by a cycle run here, so its
    reduction is launched before the next (earlier) stage's backward is
    enqueued.  ``alone``: cycles run until the bucket's response is out
    before the next bucket is enqueued, so no two buckets fuse (the
    pipeline step's bitwise contract across schedules).  Rank 0's
    timeline gets a BUCKET_DISPATCH instant."""
    rt = C._runtime()
    for b in seg.buckets:
        base = f"{prefix}.g{b.gi}"
        hs = C.grouped_allreduce_async(
            [seg_leaves[p] for p in b.local_pos], op=ReduceOp.SUM,
            name=base)
        rt.run_cycle()
        while alone and rt.pending(hs):
            rt.run_cycle()
        for idx, h in zip(b.global_idx, hs):
            handles[idx] = h
        stats["overlap.buckets_dispatched"] += 1
        if tl is not None:
            tl.instant(base, "BUCKET_DISPATCH",
                       args={"bucket": b.gi, "tensors": len(hs),
                             "bytes": b.nbytes})
        if window is not None:
            window.admit(hs)


_prefix_lock = threading.Lock()
_prefix_counter = 0


def _next_prefix() -> str:
    """Wire-name prefix of one step builder: the same every step (the
    response cache's key), unique among builders.  Every rank builds its
    steps in the same order, so the names agree."""
    global _prefix_counter
    with _prefix_lock:
        _prefix_counter += 1
        return f"overlap.p{_prefix_counter}"


class _Unbucketable(Exception):
    """The gradients cannot take the bucketed path; ``reason`` names the
    fallback."""

    def __init__(self, reason: str, detail: str):
        super().__init__(detail)
        self.reason = reason


# ---------------------------------------------------------------------------
# The overlapped step
# ---------------------------------------------------------------------------

class _OverlapStep:
    """The monolithic step's signature: ``step(params, batch) -> loss``,
    ``-> (loss, aux)`` with ``has_aux``, or ``step(params, model_state,
    batch) -> (new_state, loss)`` with ``has_state``.  The plan is built
    on the first call and rebuilt when the fusion threshold changes; an
    unbucketable case falls back to the monolithic step for good."""

    def __init__(self, loss_fn, optimizer, stream: bool,
                 fallback_builder: Callable[[], Callable],
                 finish: Callable, has_aux: bool = False,
                 has_state: bool = False):
        self._loss_fn = loss_fn
        self._finish = finish  # the monolithic step's own averaging
        self._has_extra = has_aux or has_state
        self._dopt = optimizer  # the monolithic DistributedOptimizer
        self._inner = optimizer._inner
        self._red_op = _resolve_grad_op(optimizer._average, optimizer._op)
        self._fusion_threshold = optimizer._fusion_threshold
        self._compression = optimizer._compression or NoneCompressor
        self._stream = stream
        self._fallback_builder = fallback_builder
        self._prefix = _next_prefix()
        self._fallback_step: Optional[Callable] = None
        self._fallback_reason: Optional[str] = None
        self._plan: Optional[_Plan] = None
        self._segmented = False
        self._probed = False  # sparse gradients are checked once
        self._ctxs: List[Any] = []
        self._stats = {"overlap.buckets_dispatched": 0,
                       "overlap.fallbacks": 0,
                       "overlap.exposed_comm_seconds": {"count": 0,
                                                        "sum": 0.0,
                                                        "last": 0.0},
                       "overlap.host_stall_seconds": 0.0}

    # -- introspection ------------------------------------------------------
    @property
    def overlap_active(self) -> bool:
        return self._fallback_step is None

    @property
    def schedule(self) -> str:
        return "stream" if self._stream else "serial"

    @property
    def bucket_count(self) -> Optional[int]:
        return None if self._plan is None else self._plan.n_buckets

    @property
    def segment_count(self) -> Optional[int]:
        return None if self._plan is None else len(self._plan.segments)

    def stats(self) -> dict:
        """``overlap.buckets_dispatched`` (buckets handed to the
        negotiated path), ``overlap.fallbacks`` (0 or 1),
        ``overlap.exposed_comm_seconds`` (host seconds a step spends
        completing the reductions after its whole backward was enqueued:
        count, sum, last) and ``overlap.host_stall_seconds`` (the CPU
        window's waits)."""
        out = dict(self._stats)
        out["overlap.exposed_comm_seconds"] = dict(
            self._stats["overlap.exposed_comm_seconds"])
        return out

    # -- fallback -----------------------------------------------------------
    def _fall_back(self, reason: str, detail: str) -> Callable:
        print(f"[hvd-overlap] falling back to the monolithic step "
              f"[{reason}]: {detail}", file=sys.stderr)
        self._stats["overlap.fallbacks"] += 1
        _telemetry.overlap_fallback_event(reason, detail)
        self._fallback_reason = reason
        self._fallback_step = self._fallback_builder()
        return self._fallback_step

    # -- plan ---------------------------------------------------------------
    def _effective_threshold(self) -> int:
        """The step's threshold clamped by the job's (every rank holds the
        same value, so every rank plans the same buckets; rank 0's
        coordinators fuse with it, so a bucket never splits)."""
        job = _state.fusion_threshold_bytes()
        return job if self._fusion_threshold is None \
            else min(int(self._fusion_threshold), job)

    def _wire_spec(self, leaf: torch.Tensor) -> SimpleNamespace:
        """(shape, wire dtype) of one gradient leaf; records its
        decompress context."""
        wire, ctx = self._compression.compress(
            torch.zeros((1,), dtype=leaf.dtype))
        if isinstance(ctx, torch.Tensor):
            raise _Unbucketable(
                "nonstatic-compression",
                "the compressor's context is a tensor, which depends on "
                "the gradient's values; the bucketed path decompresses "
                "with a context fixed when the plan is built")
        self._ctxs.append(ctx)
        return SimpleNamespace(shape=tuple(leaf.shape), dtype=wire.dtype)

    def _segment_params(self, params) -> List[list]:
        if self._segmented:
            return [tree_leaves(p)
                    for p in self._loss_fn._check_params(params)]
        return [tree_leaves(params)]

    def _build(self, params) -> None:
        if self._red_op == ReduceOp.ADASUM:
            raise _Unbucketable(
                "adasum", "op=Adasum combines the whole gradient vector; "
                "no per-bucket decomposition exists")
        opt_params = [p for g in self._inner.param_groups
                      for p in g["params"]]
        leaves = tree_leaves(params)
        if len(opt_params) != len(leaves) or any(
                a is not b for a, b in zip(opt_params, leaves)):
            raise _Unbucketable(
                "grad-tree", "the optimizer's parameters are not the "
                "parameter tree's leaves in order; bucket gradients could "
                "not be placed")
        # A loss with aux or state keeps one backward (reference :632-636).
        self._segmented = segmented(self._loss_fn) and not self._has_extra
        self._ctxs = []
        self._seg_specs = [[self._wire_spec(x) for x in seg]
                           for seg in self._segment_params(params)]
        self._plan = _build_plan(self._seg_specs,
                                 self._effective_threshold())

    # -- execution ----------------------------------------------------------
    def __call__(self, *args):
        if self._fallback_step is not None:
            return self._fallback_step(*args)
        params = args[0]
        if self._plan is None:
            try:
                self._build(params)
            except _Unbucketable as e:
                return self._fall_back(e.reason, str(e))(*args)
        thr = self._effective_threshold()
        if thr != self._plan.threshold:
            # The fusion threshold changed (set_fusion_threshold): re-cut
            # the buckets.  The re-used names carry new shapes, which the
            # response cache takes as a program change (one flush, one
            # negotiation).
            self._plan = _build_plan(self._seg_specs, thr)
        return self._run(args)

    def _grads(self, leaves: List[torch.Tensor]) -> List[torch.Tensor]:
        """One segment's gradients, zeros for a leaf without one (as the
        monolithic path sends)."""
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in leaves]

    def _backward(self, args, dispatch):
        """Forward and backward; ``dispatch(k, grads)`` is called with each
        segment's gradients once its backward is enqueued, the last
        segment first.  Returns the loss, detached, and the aux or new
        state (``None`` without)."""
        params, batch = args[0], args[-1]
        seg_params = self._segment_params(params)
        if not self._segmented:
            out = self._loss_fn(*args)
            loss, extra = out if self._has_extra else (out, None)
            loss.backward()
            dispatch(0, self._grads(seg_params[0]))
            return loss.detach(), extra
        stages = self._loss_fn.stages
        chain = self._loss_fn._check_params(params)
        outs, ins = [], [None]
        carry = None
        for k, (f, p) in enumerate(zip(stages, chain)):
            if k:
                carry = stage_boundary(carry)
                ins.append(carry)
            carry = f(p, carry, batch)
            outs.append(carry)
        loss = outs[-1].detach()
        ct = None
        for k in range(len(stages) - 1, -1, -1):
            outs_k = [x for x in tree_leaves(outs[k])
                      if isinstance(x, torch.Tensor) and x.requires_grad]
            torch.autograd.backward(outs_k, grad_tensors=ct)
            outs[k] = None  # this stage's graph is freed
            if k:
                ct = [x.grad for x in tree_leaves(ins[k])
                      if isinstance(x, torch.Tensor) and x.requires_grad]
                ins[k] = None
            dispatch(k, self._grads(seg_params[k]))
        return loss, None

    def _run(self, args):
        params = args[0]
        rt = C._runtime()
        tl = rt.timeline
        plan = self._plan
        cuda = _state.device().type == "cuda"
        self._inner.zero_grad(set_to_none=True)
        handles: List[Optional[int]] = [None] * plan.n_leaves
        window = None if cuda else _InflightWindow(_max_inflight(),
                                                   self._stats)
        comp = self._compression

        def send(k, grads):
            dispatch_bucket_segment(
                self._prefix, plan.segments[k],
                [comp.compress(g)[0] for g in grads], handles, tl,
                self._stats, window)

        # The first call runs the whole backward before it dispatches
        # anything, and checks for sparse gradients (whose payload the
        # plan cannot size); later streaming calls send each segment as
        # soon as its backward is enqueued.
        staged = []
        stream_now = self._stream and self._probed
        loss, extra = self._backward(
            args, send if stream_now else lambda k, g: staged.append((k, g)))
        if not self._probed:
            self._probed = True
            if any(g.is_sparse for _, grads in staged for g in grads):
                # The gradients are in .grad: finish this step as the
                # monolithic step does, and keep to it.
                self._fall_back(
                    "sparse", "sparse gradient leaves ship a "
                    "negotiated-size payload the bucket planner cannot "
                    "size")
                self._dopt.step()
                return self._finish(loss, extra)
        if staged:
            if not self._stream and cuda:
                # Reduction after backward: fence the whole backward.
                torch.cuda.current_stream().synchronize()
            for k, grads in staged:
                send(k, grads)
        t0 = time.perf_counter()
        reduced = [C.synchronize(h) for h in handles]
        if not self._stream and cuda:
            torch.cuda.current_stream().synchronize()
        exposed = time.perf_counter() - t0
        ex = self._stats["overlap.exposed_comm_seconds"]
        ex["count"] += 1
        ex["sum"] += exposed
        ex["last"] = exposed
        n = _state.size()
        average = self._red_op == ReduceOp.AVERAGE
        for p, r, ctx in zip(tree_leaves(params), reduced, self._ctxs):
            g = comp.decompress(r, ctx)
            p.grad = g / n if average else g
        self._inner.step()
        return self._finish(loss, extra)


def make_overlapped_step(loss_fn, optimizer, stream: bool,
                         fallback_builder: Callable[[], Callable],
                         finish: Callable, has_aux: bool = False,
                         has_state: bool = False):
    """The bucketed-backward step (``parallel/training.make_train_step``
    and ``make_train_step_with_state`` build it when the schedule
    resolves to ``stream`` or ``serial``).  ``optimizer`` is the
    monolithic :class:`.data.DistributedOptimizer`;
    ``fallback_builder`` builds the monolithic step of the same kind for
    the unbucketable cases; ``finish(loss, extra)`` is that step's own
    averaging of the loss and the aux or new state (``has_aux``,
    ``has_state``), and makes the step's return value."""
    return _OverlapStep(loss_fn, optimizer, stream, fallback_builder,
                        finish, has_aux, has_state)
