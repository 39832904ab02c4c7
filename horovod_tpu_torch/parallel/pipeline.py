"""Pipeline parallelism: the 1F1B/GPipe/interleaved schedule, the per-stage
pipeline train step, and GPipe ticks over a pipe axis (port of
horovod_tpu/parallel/pipeline.py).

Two forms of the same axis:

* :func:`make_pipeline_train_step` -- a :class:`~.overlap.ChainedLoss`
  trained stage by stage.  A batch is cut into microbatches; the host
  runs each stage's forward and backward of each microbatch in the
  order of a :class:`PipelinePlan` (:func:`schedule_plan`: GPipe, 1F1B,
  or 1F1B over interleaved virtual stages).  A forward runs under
  ``torch.no_grad()`` and keeps only the boundary carry; the backward
  recomputes the stage's forward from ``(params, carry)`` and takes
  ``torch.autograd.grad`` against the cotangent (``ones_like`` the loss
  at the last stage, the next stage's carry gradient elsewhere): the
  reference's ``jax.vjp`` with rematerialization inside the segment.
  No (stage, microbatch) graph outlives its own call, so the live
  activations are the plan's boundary carries
  (``PipelinePlan.peak_activations``).  Each stage's gradients are the
  raw per-microbatch gradients summed in microbatch order, in the
  leaf's dtype; backwards run in microbatch order at every stage under
  every schedule, so 1F1B, GPipe and interleaved runs are bitwise equal.
* :func:`gpipe` -- ``n`` stages over a :class:`~..core.topology.MeshAxis`:
  ``m + n - 1`` ticks, the carries moved by :func:`.axis_ops.ppermute`,
  one :func:`.axis_ops.psum` at the end; differentiable by autograd
  (what ``ParallelAxes.pipe`` runs in ``models/transformer.py``).
  :func:`play_gpipe` plays the ``n`` stages' ticks in one process.

**The unplaced step** (``stage_meshes=None``): every rank runs every
stage on its own rows of the batch -- the reference's single-controller
replica mesh with one process a device, so N ranks here are what the
reference runs as N devices.  Each stage's gradient buckets (the
overlapped step's plan, :func:`.overlap._build_plan`, bounded by
``fusion_threshold``) go through :func:`.overlap.dispatch_bucket_segment`
to the negotiated collectives: under 1F1B as soon as the stage's last
backward has been enqueued (the reduction runs in the remaining ticks),
under GPipe after every gradient is done (a stream synchronize on the
GPU) -- the comparator.  Each bucket is negotiated alone (the host runs
cycles until its response is out) so that no two buckets fuse: with more
than two gloo ranks the position of an element in a fused buffer decides
the order of its sum, and the schedules dispatch the buckets at
different times.  The reference's refusal of a multi-process job
(``st.multiprocess``, :599-605) has no counterpart: one process a rank
is the port's only form.

**Placed mode** (``stage_meshes=``, e.g. :func:`stage_submeshes`): stage
*k* runs on its own block of ranks, a :class:`~..core.topology.Mesh`
with a ``data`` axis (the reference's replica axis) and, with
``model > 1``, a ``model`` axis on which a stage body may run
``parallel/tensor.py``'s closers.  Each rank runs the plan's actions of
its own stages, in tick order.  Replica ``j`` of stage *k* sends its
carry to replica ``j`` of stage *k+1* and the cotangent back, with
``isend``/``recv`` on the world group; sends do not block and receives
do, and since an action at tick *t* only waits for messages sent at
earlier ticks, every rank's actions complete in tick order: the schedule
cannot deadlock, with or without interleave.  Each stage has one
reduce-and-apply: the sum of its gradients over the stage mesh, the
divide, the optimizer; under 1F1B after the stage's last backward, under
GPipe after the flush.  The loss reaches every rank from the last stage.
A rank holds, updates and returns only its own stages' parameters; the
other entries of the returned list are the tensors passed in, untouched.
With a ``model`` axis the gradient convention of :mod:`.axis_ops`
holds: the cotangent entering a stage counts ``1/model`` on each of its
model ranks, the carry's cotangent is summed over them before it goes
back, and the gradients are summed over the whole stage mesh.

**The optimizer** is taken as :mod:`.zero` takes it: an elementwise
factory ``optimizer_fn(list_of_tensors)`` or a
:class:`.data.DistributedOptimizer` (its averaging flag and compression
are honoured).  Departures from the reference's
``step(params, opt_state, batch)`` signature: ``step.init(params)``
returns the per-stage optimizer state (one optimizer over each stage's
leaves, ``None`` for a stage this rank does not hold), in both modes;
``params`` are updated in place and returned; ``batch`` is the global
batch, the same on every rank (as ``make_parallel_train_step`` takes
it), of which a rank takes its replica's rows.  A per-stage optimizer
equals one over the whole tree only for an elementwise optimizer, as in
the reference's placed mode.  A placed step at more than one rank
registers each stage's parameter leaves and optimizer with the stage's
placement (:data:`PLACED`, :func:`placement`), so that
:mod:`..utils.checkpoint` takes each stage's state from the lowest rank
that holds it: every rank calls ``save_checkpoint``, rank 0 writes the
tree a one-rank, unplaced step of the same stages would write, and a
restore gives every rank all the parameters and each optimizer it holds
its own stage's state.

No counterpart: ``_AotProgram`` (:432; XLA's ahead-of-time compile, its
OOM guard and donation sanitizer), ``_to_mesh``'s ``device_put``
(placed carries move by send and receive), and ``donate`` (accepted,
without effect: PyTorch updates in place).  The reference's four
``pipeline.*`` series (:130-145) are in the telemetry registry, and
``step.stats()`` keeps the step's own values of the same names.  Memory
(reference :458-472, :626-669, :910-931, :1053): every stage-boundary
carry a rank holds is charged to the ledger's ``pipeline.activations``
while it lives, each stage program (forward, and backward's recompute
and gradient) runs inside :func:`..memory.oom.guard`, each step closes
the ledger's step window, and the first step pre-flights the schedule's
peak carries against the advertised capacity.  The reference sizes a
carry by ``jax.eval_shape`` before any dispatch; PyTorch has no
shape-only evaluation of the stage functions (the flash kernels launch
by ``ctypes``), so the port sizes it by the first carry the first step
makes, and warns before the schedule reaches its peak.

Env contract (validated at ``init``, and part of the env fingerprint
``init`` compares across ranks: the schedule decides the order in which
a rank dispatches its buckets):

  HVD_TPU_PIPELINE_SCHEDULE=1f1b|gpipe    default 1f1b
  HVD_TPU_PIPELINE_INTERLEAVE=<v>         default 1; virtual stages per
                                          executor, must divide the
                                          stage count
"""

from __future__ import annotations

import collections
import os
import pickle
import time
import weakref
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import telemetry as _telemetry
from ..core import state as _state
from ..memory import ledger as _mem
from ..memory import oom as _oom
from ..core import topology as T
from ..ops import collective as C
from ..ops.compression import NoneCompressor
from ..utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from . import axis_ops
from . import overlap as _overlap
from .zero import _optimizer_factory

SCHEDULE_ENV = "HVD_TPU_PIPELINE_SCHEDULE"
INTERLEAVE_ENV = "HVD_TPU_PIPELINE_INTERLEAVE"
_VALID_SCHEDULES = ("1f1b", "gpipe")

# The reference's pipeline series (parallel/pipeline.py:130-145).
_M_MICROBATCHES = _telemetry.counter(
    "pipeline.microbatches",
    "microbatches executed through the pipeline schedule")
_M_BUBBLE = _telemetry.histogram(
    "pipeline.bubble_seconds", "seconds",
    "host seconds waiting on gradient reductions after the last "
    "schedule tick was dispatched")
_M_INFLIGHT = _telemetry.gauge(
    "pipeline.inflight_activations",
    "peak stage-boundary activations held live by the last schedule")
_M_INFLIGHT_BYTES = _telemetry.gauge(
    "pipeline.inflight_activation_bytes",
    "peak stage-boundary activation bytes held live by the last schedule")


@dataclass(frozen=True)
class StagePlacement:
    """Where a placed step's stage lives: ``stage`` and ``owner``, the
    lowest rank that holds it (whose copy of the stage is current)."""
    stage: int
    owner: int


class _Placements:
    """Stage placements keyed by object identity and held weakly (a
    ``WeakKeyDictionary`` compares keys with ``==``, which is elementwise
    for tensors)."""

    def __init__(self):
        self._d: dict = {}

    def __setitem__(self, obj, where: StagePlacement) -> None:
        key = id(obj)

        def drop(ref, key=key):
            entry = self._d.get(key)
            if entry is not None and entry[0] is ref:
                del self._d[key]

        self._d[key] = (weakref.ref(obj, drop), where)

    def get(self, obj) -> Optional[StagePlacement]:
        entry = self._d.get(id(obj))
        return entry[1] if entry is not None and entry[0]() is obj else None


# The parameter leaves (every stage's, held or not) and the stage
# optimizers of placed steps whose rank does not hold every stage, each
# with its stage's placement: rank 0's copy of another rank's stage is
# stale, so utils/checkpoint.py takes each stage's state from its owner.
PLACED = _Placements()


def placement(x) -> Optional[StagePlacement]:
    """``x``'s stage placement when it is a parameter leaf or a stage
    optimizer of a placed step at more than one rank, else ``None``."""
    return PLACED.get(x)


# The schedule plan below (_nearest_divisors through schedule_plan) is a
# copy of the reference's jax-free code, horovod_tpu/parallel/
# pipeline.py:148-354, with its messages word for word.


def _nearest_divisors(n: int, m: int) -> Tuple[int, int]:
    """The divisors of ``n`` nearest to ``m`` from below and above --
    the suggestion surface for schedule-shape errors."""
    lo = next((k for k in range(min(m, n), 0, -1) if n % k == 0), 1)
    hi = next((k for k in range(max(m, 1), n + 1) if n % k == 0), n)
    return lo, hi


def _indivisible_message(what: str, axis: int, m: int) -> str:
    lo, hi = _nearest_divisors(axis, m)
    suggest = f"{lo}" if lo == hi else f"{lo} or {hi}"
    return (f"{what} axis of size {axis} is not divisible by "
            f"num_microbatches={m}; nearest valid counts: {suggest}")


def schedule_env() -> str:
    return (os.environ.get(SCHEDULE_ENV, "1f1b").strip().lower()
            or "1f1b")


def interleave_env() -> int:
    v = os.environ.get(INTERLEAVE_ENV, "1").strip() or "1"
    try:
        return int(v)
    except ValueError:
        raise ValueError(
            f"{INTERLEAVE_ENV}={v!r}: expected a positive integer "
            f"(virtual stages per pipeline executor)") from None


def validate_env() -> None:
    """Fail ``init``, not the first pipeline step, on a malformed
    schedule knob."""
    v = os.environ.get(SCHEDULE_ENV)
    if v and schedule_env() not in _VALID_SCHEDULES:
        raise ValueError(
            f"{SCHEDULE_ENV}={v!r}: expected one of "
            f"{'|'.join(_VALID_SCHEDULES)}")
    iv = os.environ.get(INTERLEAVE_ENV)
    if iv:
        try:
            ok = int(iv) >= 1
        except ValueError:
            ok = False
        if not ok:
            raise ValueError(
                f"{INTERLEAVE_ENV}={iv!r}: expected a positive integer "
                f"(virtual stages per pipeline executor)")


class Action(NamedTuple):
    """One schedule slot: ``phase`` (``"F"``/``"B"``) of microbatch
    ``mb`` at pipeline stage ``stage``."""

    phase: str
    stage: int
    mb: int


@dataclass
class PipelinePlan:
    """A fully resolved dispatch schedule.

    ``ticks`` is the deterministic dispatch order: data dependencies
    always point to earlier ticks.  ``bubble_ticks``/``bubble_fraction``
    count executor-idle slots (an executor with remaining work but no
    ready action), and ``peak_activations`` the most stage-boundary
    carries live at once -- the memory bound 1F1B holds at the stage
    depth while GPipe grows it with the microbatch count.
    """

    n_stages: int
    num_microbatches: int
    schedule: str
    interleave: int
    ticks: List[List[Action]] = field(default_factory=list)
    bubble_ticks: int = 0
    peak_activations: int = 0

    @property
    def n_executors(self) -> int:
        return self.n_stages // self.interleave

    @property
    def total_ticks(self) -> int:
        return len(self.ticks)

    @property
    def bubble_fraction(self) -> float:
        slots = self.n_executors * max(self.total_ticks, 1)
        return self.bubble_ticks / slots


def _resolve_schedule(schedule: Optional[str], interleave: Optional[int],
                      n_stages: int) -> Tuple[str, int]:
    sched = (schedule or schedule_env()).strip().lower()
    if sched not in _VALID_SCHEDULES:
        raise ValueError(
            f"pipeline schedule {sched!r}: expected one of "
            f"{'|'.join(_VALID_SCHEDULES)} ({SCHEDULE_ENV})")
    v = interleave if interleave is not None else interleave_env()
    v = int(v)
    if v < 1:
        raise ValueError(f"interleave={v}: must be >= 1")
    if n_stages % v != 0:
        lo, hi = _nearest_divisors(n_stages, v)
        suggest = f"{lo}" if lo == hi else f"{lo} or {hi}"
        raise ValueError(
            f"interleave={v} does not divide n_stages={n_stages}; "
            f"nearest valid interleave depths: {suggest}")
    return sched, v


def _stage_action_list(schedule: str, S: int, m: int, s: int) -> list:
    """Stage ``s``'s action order.  GPipe: all forwards, then all
    backwards.  1F1B: ``min(m, S-1-s)`` warmup forwards, a steady
    one-forward-one-backward phase, then the backward cooldown.
    Backwards run in microbatch order under both schedules -- the
    bitwise gradient-accumulation contract."""
    if schedule == "gpipe":
        return ([Action("F", s, i) for i in range(m)]
                + [Action("B", s, i) for i in range(m)])
    w = min(m, S - 1 - s)
    acts = [Action("F", s, i) for i in range(w)]
    for k in range(m - w):
        acts.append(Action("F", s, w + k))
        acts.append(Action("B", s, k))
    acts += [Action("B", s, i) for i in range(m - w, m)]
    return acts


def schedule_plan(n_stages: int, num_microbatches: int,
                  schedule: Optional[str] = None,
                  interleave: Optional[int] = None) -> PipelinePlan:
    """The dispatch schedule of ``n_stages`` x ``num_microbatches``, by a
    deterministic event simulation: each of the ``n_stages/interleave``
    executors owns its round-robin virtual stages and, every tick, fires
    the first owned stage whose next queued action has its dependencies
    done at earlier ticks.  A forward of ``(s, i)`` needs the forward
    ``(s-1, i)``; a backward needs the stage's own forward and the
    backward ``(s+1, i)``."""
    S, m = int(n_stages), int(num_microbatches)
    if S < 1 or m < 1:
        raise ValueError(f"n_stages={S} and num_microbatches={m} must "
                         f"be >= 1")
    sched, v = _resolve_schedule(schedule, interleave, S)
    D = S // v
    owners = {d: [d + j * D for j in range(v)] for d in range(D)}
    queues = {s: collections.deque(_stage_action_list(sched, S, m, s))
              for s in range(S)}
    fwd_done, bwd_done = set(), set()
    plan = PipelinePlan(n_stages=S, num_microbatches=m, schedule=sched,
                        interleave=v)

    def ready(a: Action) -> bool:
        if a.phase == "F":
            return a.stage == 0 or (a.stage - 1, a.mb) in fwd_done
        return ((a.stage, a.mb) in fwd_done
                and (a.stage == S - 1
                     or (a.stage + 1, a.mb) in bwd_done))

    live = 0
    while any(queues.values()):
        fired: List[Action] = []
        for d in range(D):
            for s in owners[d]:
                q = queues[s]
                if q and ready(q[0]):
                    fired.append(q.popleft())
                    break
            else:
                if any(queues[s] for s in owners[d]):
                    plan.bubble_ticks += 1
        if not fired:
            raise RuntimeError(
                f"pipeline schedule wedged: no ready action with "
                f"{sum(map(len, queues.values()))} pending "
                f"(schedule={sched}, S={S}, m={m}, v={v})")
        for a in fired:
            if a.phase == "F":
                fwd_done.add((a.stage, a.mb))
                if a.stage < S - 1:
                    live += 1  # carry born (consumed by B of stage+1)
            else:
                bwd_done.add((a.stage, a.mb))
                if a.stage > 0:
                    live -= 1  # carry (stage-1, mb) consumed
            plan.peak_activations = max(plan.peak_activations, live)
        plan.ticks.append(fired)
    return plan


# ---------------------------------------------------------------------------
# Placement on stage rank groups
# ---------------------------------------------------------------------------

def _mesh_ranks(mesh) -> List[int]:
    return [int(r) for r in np.asarray(mesh.ranks).reshape(-1)]


def stage_submeshes(n_stages: int, *, mesh=None, model: int = 1
                    ) -> Tuple[T.Mesh, ...]:
    """Split the job's ranks (or ``mesh``'s) into ``n_stages`` contiguous
    blocks, one :class:`~..core.topology.Mesh` each, for
    ``make_pipeline_train_step(..., stage_meshes=...)`` (reference :361).

    Each block is shaped ``(data, model)``: the ``data`` axis and, when
    ``model > 1``, a ``model`` axis, so a stage body can run
    tensor-parallel closers on its own ranks.  Collective: every rank
    calls it with the same arguments, and creates every block's groups,
    in one order, including the blocks it is not in."""
    ranks = (list(range(dist.get_world_size())) if mesh is None
             else _mesh_ranks(mesh))
    S, v = int(n_stages), int(model)
    if S < 1 or v < 1:
        raise ValueError(f"n_stages={S} and model={v} must be >= 1")
    if len(ranks) % S != 0:
        raise ValueError(
            f"{len(ranks)} devices do not split into {S} equal stage "
            f"sub-meshes")
    per = len(ranks) // S
    if per % v != 0:
        raise ValueError(
            f"stage sub-mesh of {per} devices is not divisible by "
            f"model={v}")
    out = []
    for s in range(S):
        block = np.asarray(ranks[s * per:(s + 1) * per])
        if v == 1:
            names, grid = (T.DATA_AXIS,), block
        else:
            names, grid = (T.DATA_AXIS, T.MODEL_AXIS), block.reshape(
                per // v, v)
        out.append(T._mesh_from_grid(names, grid, outside_ok=True))
    return tuple(out)


def _validate_stage_meshes(stage_meshes, n_stages: int) -> tuple:
    meshes = tuple(stage_meshes)
    if len(meshes) != n_stages:
        raise ValueError(
            f"stage_meshes has {len(meshes)} meshes for {n_stages} "
            f"stages — one sub-mesh per stage")
    sizes = set()
    for k, mk in enumerate(meshes):
        if T.DATA_AXIS not in mk.axis_names:
            raise ValueError(
                f"stage_meshes[{k}] has axes {mk.axis_names!r}; every "
                f"stage sub-mesh needs the {T.DATA_AXIS!r} replica "
                f"axis (extra axes like {T.MODEL_AXIS!r} are fine)")
        sizes.add(_axis_size(mk, T.DATA_AXIS))
    if len(sizes) > 1:
        raise ValueError(
            f"stage sub-meshes disagree on replica count "
            f"({sorted(sizes)}): boundary carries are sharded over the "
            f"replica axis, so every stage needs the same count")
    if len({mk.size for mk in meshes}) > 1:
        raise ValueError(
            f"stage sub-meshes disagree on size "
            f"({sorted({mk.size for mk in meshes})}): the rank at "
            f"position i of one stage sends its carry to the rank at "
            f"position i of the next")
    return meshes


def _axis_size(mesh, name: str) -> int:
    return int(mesh.shape[mesh.axis_names.index(name)]) \
        if name in mesh.axis_names else 1


# ---------------------------------------------------------------------------
# Point to point between stage rank groups
# ---------------------------------------------------------------------------

_CARRY, _COTANGENT, _META = 0, 1, 2
_MAX_LEAVES = 64  # carry leaves a message tag has room for


def _tag(kind: int, stage: int, mb: int, leaf: int, S: int, m: int) -> int:
    """A tag of its own for every message of a step (gloo matches a
    receive by source and tag)."""
    return (((kind * S) + stage) * m + mb) * _MAX_LEAVES + leaf


class _Sends:
    """Sends in flight and the tensors they read, kept alive until they
    complete."""

    def __init__(self):
        self._q: list = []

    def add(self, tensor: torch.Tensor, dst: int, tag: int) -> None:
        self._q = [(w, t) for w, t in self._q if not w.is_completed()]
        self._q.append((dist.isend(tensor, dst, tag=tag), tensor))

    def wait(self) -> None:
        for work, _ in self._q:
            work.wait()
        self._q = []


# ---------------------------------------------------------------------------
# The pipeline train step
# ---------------------------------------------------------------------------

def _float_leaves(tree) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree)
            if isinstance(x, torch.Tensor) and x.requires_grad]


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


class _PipelineStep:
    """``step(params, opt_state, batch) -> (params, opt_state, loss)`` and
    ``step.init(params) -> opt_state`` (see the module docstring)."""

    def __init__(self, chain, optimizer, mesh, num_microbatches: int,
                 schedule: Optional[str], interleave: Optional[int],
                 average: bool, fusion_threshold: Optional[int],
                 donate: bool, stage_meshes=None):
        del donate  # PyTorch updates in place: nothing to donate
        if not isinstance(chain, _overlap.ChainedLoss):
            chain = _overlap.ChainedLoss(list(chain))
        if len(chain.stages) < 2:
            raise ValueError(
                "make_pipeline_train_step needs at least 2 stages; a "
                "single-stage loss trains faster through "
                "make_train_step")
        self._chain = chain
        self._S = len(chain.stages)
        self._m = int(num_microbatches)
        self._optimizer_fn, self._average, comp = _optimizer_factory(
            optimizer, average, None)
        self._compression = comp or NoneCompressor
        self._fusion_threshold = fusion_threshold
        self._stage_meshes = None if stage_meshes is None else \
            _validate_stage_meshes(stage_meshes, self._S)
        me = dist.get_rank() if dist.is_initialized() else 0
        if self._stage_meshes is None:
            self._replicas = _state.size()
            if mesh is not None and _axis_size(mesh, T.DATA_AXIS) \
                    != self._replicas:
                raise ValueError(
                    f"the unplaced pipeline step reduces over every rank "
                    f"of the job ({self._replicas}); mesh's "
                    f"{T.DATA_AXIS!r} axis has "
                    f"{_axis_size(mesh, T.DATA_AXIS)}.  Place stages on "
                    f"rank groups with stage_meshes= instead")
            self._mine = list(range(self._S))
            self._replica = {k: _state.rank() for k in self._mine}
        else:
            meshes = self._stage_meshes
            self._replicas = _axis_size(meshes[0], T.DATA_AXIS)
            self._mine = [k for k, mk in enumerate(meshes)
                          if me in _mesh_ranks(mk)]
            self._replica = {k: meshes[k].axis(T.DATA_AXIS).index
                             for k in self._mine}
            self._pos = {k: _mesh_ranks(meshes[k]).index(me)
                         for k in self._mine}
        self._plan = schedule_plan(self._S, self._m, schedule, interleave)
        self._prefix = _overlap._next_prefix()
        self._bucket_plan = None
        self._ctxs: list = []
        self._carry_meta: dict = {}  # placed: stage -> (spec, shapes)
        self._preflighted = False
        self._stats = {"pipeline.microbatches": 0,
                       "pipeline.bubble_seconds": {"count": 0, "sum": 0.0,
                                                   "last": 0.0},
                       "pipeline.inflight_activations": 0,
                       "pipeline.inflight_activation_bytes": 0}
        # dispatch_bucket_segment's own counters.
        self._dispatch_stats = {"overlap.buckets_dispatched": 0,
                                "overlap.host_stall_seconds": 0.0}

    # -- introspection ------------------------------------------------------
    @property
    def plan(self) -> PipelinePlan:
        return self._plan

    @property
    def schedule(self) -> str:
        return self._plan.schedule

    @property
    def bucket_count(self) -> Optional[int]:
        return None if self._bucket_plan is None \
            else self._bucket_plan.n_buckets

    @property
    def stage_meshes(self) -> Optional[tuple]:
        """The per-stage placement, or ``None`` when every rank runs
        every stage."""
        return self._stage_meshes

    @property
    def placed(self) -> bool:
        return self._stage_meshes is not None

    def stats(self) -> dict:
        """This step's values of the reference's four pipeline metrics
        (the registry's series sum them over every step of the process):
        ``pipeline.microbatches`` (microbatches run, all
        steps), ``pipeline.bubble_seconds`` (host seconds from the last
        tick to the reduced gradients: count, sum, last),
        ``pipeline.inflight_activations`` and
        ``pipeline.inflight_activation_bytes`` (the most boundary carries
        this rank held at once in the last step, and their bytes)."""
        out = dict(self._stats)
        out["pipeline.bubble_seconds"] = dict(
            self._stats["pipeline.bubble_seconds"])
        return out

    # -- state --------------------------------------------------------------
    def init(self, params) -> list:
        """One optimizer over each stage's leaves; ``None`` for a stage
        this rank does not hold."""
        params = self._chain._check_params(params)
        opts = [self._optimizer_fn(tree_leaves(params[k]))
                if k in self._replica else None for k in range(self._S)]
        if len(self._mine) < self._S:
            for k in range(self._S):
                where = StagePlacement(
                    k, min(_mesh_ranks(self._stage_meshes[k])))
                objs = [x for x in tree_leaves(params[k])
                        if isinstance(x, torch.Tensor)]
                for x in objs + ([opts[k]] if opts[k] is not None else []):
                    PLACED[x] = where
        return opts

    def _check_opt_state(self, params, opt_state) -> list:
        if (not isinstance(opt_state, (list, tuple))
                or len(opt_state) != self._S):
            raise ValueError(
                "make_pipeline_train_step needs a PER-STAGE opt_state "
                "sequence (step.init(params)); got "
                f"{type(opt_state).__name__} for {self._S} stages")
        for k in self._mine:
            opt = opt_state[k]
            held = [] if opt is None else [
                p for g in opt.param_groups for p in g["params"]]
            leaves = tree_leaves(params[k])
            if len(held) != len(leaves) or any(
                    a is not b for a, b in zip(held, leaves)):
                raise ValueError(
                    f"opt_state[{k}] does not step stage {k}'s parameter "
                    f"leaves; build the state with step.init(params)")
        return list(opt_state)

    def _check_batch(self, batch) -> None:
        n = self._replicas
        for leaf in tree_leaves(batch):
            axis = int(leaf.shape[0])
            if axis % self._m != 0:
                raise ValueError(_indivisible_message("batch", axis,
                                                      self._m))
            if axis % n != 0:
                raise ValueError(
                    f"batch axis of size {axis} is not divisible by "
                    f"the replica count {n} (the data-parallel shard)")
            if (axis // n) % self._m != 0:
                raise ValueError(
                    f"batch axis {axis} shards to {axis // n} rows per "
                    f"replica; " + _indivisible_message(
                        "per-replica batch", axis // n, self._m))

    def _build(self, params) -> None:
        """The unplaced step's bucket plan: each stage's leaves by shape
        and wire dtype, bounded by the step's threshold clamped by the
        job's (as the overlapped step's)."""
        comp = self._compression
        job = _state.fusion_threshold_bytes()
        thr = job if self._fusion_threshold is None \
            else min(int(self._fusion_threshold), job)
        specs = []
        for p in params:
            seg = []
            for leaf in tree_leaves(p):
                wire, ctx = comp.compress(torch.zeros((1,),
                                                      dtype=leaf.dtype))
                if isinstance(ctx, torch.Tensor):
                    raise ValueError(
                        "make_pipeline_train_step needs a compressor "
                        "whose context is not a tensor (its buckets are "
                        "planned once)")
                self._ctxs.append(ctx)
                seg.append(SimpleNamespace(shape=tuple(leaf.shape),
                                           dtype=wire.dtype))
            specs.append(seg)
        self._bucket_plan = _overlap._build_plan(specs, thr)

    def _preflight(self, params, carry_bytes: int) -> None:
        """hvd-mem pre-flight (reference :626-669): the schedule's peak
        carries times one carry, plus this rank's stage parameters and
        their gradient accumulators, against the advertised capacity.
        Once, at the first carry of the first step; best-effort."""
        self._preflighted = True
        if _oom.advertised_capacity() is None:
            return
        try:
            pbytes = sum(_mem.tree_nbytes(params[k]) for k in self._mine)
            predicted = self._plan.peak_activations * carry_bytes \
                + 2 * pbytes
            _oom.preflight_warn(
                predicted, "make_pipeline_train_step",
                f"{self._plan.peak_activations} peak carries x "
                f"{carry_bytes} B + stage params + accumulators "
                f"({self._plan.schedule}, m={self._m})")
        except Exception:  # noqa: BLE001 — pre-flight must never break
            pass           # a step

    # -- execution ----------------------------------------------------------
    def __call__(self, params, opt_state, batch):
        params = self._chain._check_params(params)
        opt_state = self._check_opt_state(params, opt_state)
        self._check_batch(batch)
        if self._stage_meshes is None and self._bucket_plan is None:
            self._build(params)
        return self._run(params, opt_state, batch)

    def _microbatches(self, batch) -> dict:
        """Replica index -> its rows of the global batch, on the device,
        cut into ``m`` microbatches."""
        dev = _state.device()
        n, m = self._replicas, self._m
        out = {}
        for j in sorted(set(self._replica.values())):
            def rows(x, j=j):
                x = torch.as_tensor(x)
                r = x.shape[0] // n
                return x[j * r:(j + 1) * r].to(dev)

            local = tree_map(rows, batch)
            out[j] = [tree_map(lambda x, i=i: x[i * (x.shape[0] // m):
                                                (i + 1) * (x.shape[0] // m)],
                               local) for i in range(m)]
        return out

    def _peer(self, stage: int, other: int) -> int:
        """The rank of stage ``other`` at this rank's position in
        ``stage``."""
        return _mesh_ranks(self._stage_meshes[other])[self._pos[stage]]

    def _model_axis(self, stage: int):
        mk = self._stage_meshes[stage] if self.placed else None
        if mk is None or _axis_size(mk, T.MODEL_AXIS) == 1:
            return None
        return mk.axis(T.MODEL_AXIS)

    def _run(self, params, opt_state, batch):
        S, m, plan = self._S, self._m, self._plan
        stream = plan.schedule == "1f1b"
        placed = self.placed
        cuda = _state.device().type == "cuda"
        mine = set(self._mine)
        mbs_of = self._microbatches(batch)
        stages = self._chain.stages
        stage_leaves = {k: tree_leaves(params[k]) for k in self._mine}
        carries: dict = {}   # (s, i) -> stage s's output, for stage s + 1
        carry_nb: dict = {}
        cts: dict = {}       # (s, i) -> cotangent of stage s's output
        accs: List[Optional[list]] = [None] * S
        losses: List[Optional[torch.Tensor]] = [None] * m
        sends = _Sends()
        handles: List[Optional[int]] = [] if placed else \
            [None] * self._bucket_plan.n_leaves
        live = {"n": 0, "peak": 0, "b": 0, "peak_b": 0}
        mem_on = _mem.enabled()

        def hold(key, carry):
            carries[key] = carry
            carry_nb[key] = nb = _nbytes(carry)
            live["n"] += 1
            live["b"] += nb
            live["peak"] = max(live["peak"], live["n"])
            live["peak_b"] = max(live["peak_b"], live["b"])
            if mem_on:
                _mem.ledger.alloc("pipeline.activations", nb)
            if not self._preflighted:
                self._preflight(params, nb)

        def release(key):
            live["n"] -= 1
            nb = carry_nb.pop(key)
            live["b"] -= nb
            if mem_on:
                _mem.ledger.free("pipeline.activations", nb)
            return carries.pop(key)

        def carry_in(s, i):
            key = (s - 1, i)
            if key not in carries:  # placed: from the previous stage
                hold(key, self._recv_carry(s, i))
            return carries[key]

        def give_carry(s, i, out):
            if not placed or s + 1 in mine:
                hold((s, i), out)
            else:
                self._send_carry(s, i, out, sends)

        def give_ct(s, i, ct):
            if not placed or s - 1 in mine:
                cts[(s - 1, i)] = ct
            else:
                peer = self._peer(s, s - 1)
                for j, g in enumerate(ct):
                    sends.add(g.contiguous(), peer,
                              _tag(_COTANGENT, s - 1, i, j, S, m))

        def forward(s, i):
            mb = mbs_of[self._replica[s]][i]
            carry = carry_in(s, i) if s else None
            with torch.no_grad(), _oom.guard(f"pipeline/stage{s}/forward"):
                out = stages[s](params[s], carry, mb)
            if s == S - 1:
                losses[i] = out
            else:
                give_carry(s, i, out)

        def backward(s, i):
            with _oom.guard(f"pipeline/stage{s}/backward"):
                stage_backward(s, i)

        def stage_backward(s, i):
            mb = mbs_of[self._replica[s]][i]
            model = self._model_axis(s)
            with torch.enable_grad():
                c = _overlap.stage_boundary(release((s - 1, i))) if s \
                    else None
                out = stages[s](params[s], c, mb)
            outs = _float_leaves(out)
            if s == S - 1:
                grad_out = [torch.ones_like(out)]
            elif not placed or s + 1 in mine:
                grad_out = cts.pop((s, i))
            else:
                grad_out = self._recv_cotangent(s, i, outs)
            if model is not None:
                # Each model rank's copy of the output counts 1/model
                # (the gradient convention of axis_ops).
                grad_out = [g / model.size for g in grad_out]
            leaves = stage_leaves[s]
            train = [p for p in leaves if p.requires_grad]
            c_leaves = _float_leaves(c) if s else []
            grads = torch.autograd.grad(outs, train + c_leaves,
                                        grad_outputs=grad_out,
                                        allow_unused=True)
            del out, outs, grad_out
            it = iter(grads)
            pg = [next(it) if p.requires_grad else None for p in leaves]
            # Zeros for a leaf without a gradient, as the overlapped step
            # sends.
            pg = [torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, pg)]
            if accs[s] is None:
                accs[s] = pg
            else:
                torch._foreach_add_(accs[s], pg)
            if s:
                ct = [torch.zeros_like(x) if g is None else g
                      for x, g in zip(c_leaves, it)]
                if model is not None:
                    axis_ops.sum_in_place(ct, model.group)
                give_ct(s, i, ct)

        for tick in plan.ticks:
            for a in tick:
                if a.stage not in mine:
                    continue
                if a.phase == "F":
                    forward(a.stage, a.mb)
                    continue
                backward(a.stage, a.mb)
                if stream and a.mb == m - 1:
                    # The stage's last backward: its reduction starts now
                    # and runs in the remaining ticks.
                    if placed:
                        self._apply_placed(a.stage, params, opt_state,
                                           accs)
                    else:
                        self._dispatch(a.stage, accs[a.stage], handles)
        # The exposed bubble: from the last tick to the reduced gradients.
        t0 = time.perf_counter()
        if not stream:
            # GPipe: every accumulated gradient done, then the same
            # reductions.
            if cuda:
                torch.cuda.current_stream().synchronize()
            for s in self._mine:
                if placed:
                    self._apply_placed(s, params, opt_state, accs)
                else:
                    self._dispatch(s, accs[s], handles)
        if not placed:
            reduced = [C.synchronize(h) for h in handles]
        if cuda:
            torch.cuda.current_stream().synchronize()
        bubble = time.perf_counter() - t0
        sends.wait()
        b = self._stats["pipeline.bubble_seconds"]
        b["count"] += 1
        b["sum"] += bubble
        b["last"] = bubble
        self._stats["pipeline.microbatches"] += m
        self._stats["pipeline.inflight_activations"] = live["peak"]
        self._stats["pipeline.inflight_activation_bytes"] = live["peak_b"]
        _M_BUBBLE.observe(bubble)
        _M_MICROBATCHES.inc(m)
        _M_INFLIGHT.set(live["peak"])
        _M_INFLIGHT_BYTES.set(live["peak_b"])
        if mem_on:
            _mem.ledger.note_step()
        if placed:
            return params, opt_state, self._placed_loss(losses)
        self._apply_unplaced(params, opt_state, reduced)
        per_mb = C.allreduce(torch.stack(losses), average=True,
                             name=f"{self._prefix}.loss")
        return params, opt_state, per_mb.mean()

    # -- reduction and apply --------------------------------------------------
    def _dispatch(self, s, acc, handles) -> None:
        comp = self._compression
        _overlap.dispatch_bucket_segment(
            self._prefix, self._bucket_plan.segments[s],
            [comp.compress(g)[0] for g in acc], handles,
            C._runtime().timeline, self._dispatch_stats, alone=True)

    def _denominator(self) -> int:
        """The mean-loss gradient's divisor: microbatches x replicas (only
        microbatches when ``average=False``)."""
        return self._m * self._replicas if self._average else self._m

    def _step_stage(self, opt, leaves, grads) -> None:
        denom = self._denominator()
        for p, g in zip(leaves, grads):
            p.grad = (g / denom).to(p.dtype)
        opt.step()
        for p in leaves:
            p.grad = None

    def _apply_unplaced(self, params, opt_state, reduced) -> None:
        comp = self._compression
        off = 0
        for k in range(self._S):
            leaves = tree_leaves(params[k])
            grads = [comp.decompress(r, ctx) for r, ctx in zip(
                reduced[off:off + len(leaves)],
                self._ctxs[off:off + len(leaves)])]
            off += len(leaves)
            self._step_stage(opt_state[k], leaves, grads)

    def _apply_placed(self, s, params, opt_state, accs) -> None:
        """Stage ``s``'s reduce-and-apply: its gradients summed over the
        stage mesh, divided, the optimizer."""
        mk = self._stage_meshes[s]
        comp = self._compression
        leaves = tree_leaves(params[s])
        wires, ctxs = zip(*(comp.compress(g) for g in accs[s]))
        if mk.size > 1:
            axis_ops.sum_in_place(wires, mk.group)
        self._step_stage(opt_state[s], leaves,
                         [comp.decompress(w, c) for w, c in zip(wires, ctxs)])
        accs[s] = None

    def _placed_loss(self, losses) -> torch.Tensor:
        """The last stage's per-microbatch losses averaged over its
        replicas, sent to every rank, then their mean."""
        last = self._stage_meshes[-1]
        dev = _state.device()
        if self._S - 1 in self._replica:
            vec = torch.stack(losses).float()
            if self._replicas > 1:
                data = last.axis(T.DATA_AXIS)
                dist.all_reduce(vec, group=data.group)
                vec = vec / data.size
        else:
            vec = torch.empty(self._m, dtype=torch.float32, device=dev)
        dist.broadcast(vec, src=_mesh_ranks(last)[0])
        return vec.mean()

    # -- placed carries -------------------------------------------------------
    def _send_carry(self, s, i, out, sends: _Sends) -> None:
        leaves, spec = tree_flatten(out)
        if len(leaves) > _MAX_LEAVES:
            raise ValueError(f"a placed carry holds at most {_MAX_LEAVES} "
                             f"tensors; stage {s}'s has {len(leaves)}")
        S, m = self._S, self._m
        peer = self._peer(s, s + 1)
        if s not in self._carry_meta:
            # The first carry across this boundary: its tree and shapes,
            # so that the receiver can allocate.
            meta = (spec, [(tuple(x.shape), x.dtype) for x in leaves])
            self._carry_meta[s] = meta
            blob = torch.frombuffer(bytearray(pickle.dumps(meta)),
                                    dtype=torch.uint8)
            sends.add(torch.tensor([blob.numel()], dtype=torch.int64),
                      peer, _tag(_META, s, 0, 0, S, m))
            sends.add(blob, peer, _tag(_META, s, 0, 1, S, m))
        for j, x in enumerate(leaves):
            sends.add(x.contiguous(), peer, _tag(_CARRY, s, i, j, S, m))

    def _recv_carry(self, s, i):
        """Stage ``s - 1``'s carry of microbatch ``i``, from its rank at
        this rank's position."""
        S, m = self._S, self._m
        peer = self._peer(s, s - 1)
        meta = self._carry_meta.get(s - 1)
        if meta is None:
            size = torch.empty(1, dtype=torch.int64)
            dist.recv(size, peer, tag=_tag(_META, s - 1, 0, 0, S, m))
            blob = torch.empty(int(size), dtype=torch.uint8)
            dist.recv(blob, peer, tag=_tag(_META, s - 1, 0, 1, S, m))
            meta = self._carry_meta[s - 1] = pickle.loads(
                blob.numpy().tobytes())
        spec, shapes = meta
        dev = _state.device()
        bufs = []
        for j, (shape, dtype) in enumerate(shapes):
            buf = torch.empty(shape, dtype=dtype, device=dev)
            dist.recv(buf, peer, tag=_tag(_CARRY, s - 1, i, j, S, m))
            bufs.append(buf)
        return tree_unflatten(spec, bufs)

    def _recv_cotangent(self, s, i, like) -> List[torch.Tensor]:
        """The cotangent of stage ``s``'s output for microbatch ``i``,
        from stage ``s + 1``'s rank at this rank's position."""
        S, m = self._S, self._m
        peer = self._peer(s, s + 1)
        out = []
        for j, x in enumerate(like):
            buf = torch.empty_like(x, memory_format=torch.contiguous_format)
            dist.recv(buf, peer, tag=_tag(_COTANGENT, s, i, j, S, m))
            out.append(buf)
        return out


def make_pipeline_train_step(
    stages,
    optimizer,
    *,
    num_microbatches: int,
    schedule: Optional[str] = None,
    interleave: Optional[int] = None,
    mesh=None,
    average: bool = True,
    fusion_threshold: Optional[int] = None,
    donate: bool = False,
    stage_meshes: Optional[Sequence] = None,
) -> _PipelineStep:
    """Build the pipeline train step (reference :1062; see the module
    docstring).

    Args:
      stages: a :class:`~.overlap.ChainedLoss`, or a sequence of
        ``stage(stage_params, carry, microbatch)`` callables (stage 0
        gets ``carry=None``, the last returns the scalar microbatch
        loss).
      optimizer: an elementwise factory ``optimizer_fn(list_of_tensors)
        -> torch.optim.Optimizer``, or a
        :class:`~.data.DistributedOptimizer`.
      num_microbatches: every batch leaf's leading axis must divide by
        it, and each replica's rows too; violations raise naming the
        axis size and the nearest valid counts.
      schedule: ``1f1b`` (default; ``HVD_TPU_PIPELINE_SCHEDULE``) or
        ``gpipe``, the all-forwards-then-all-backwards order with the
        reduction after the flush (the comparator; bitwise-identical
        results).
      interleave: virtual stages per executor
        (``HVD_TPU_PIPELINE_INTERLEAVE``, default 1); must divide the
        stage count.
      mesh: unplaced, a mesh whose ``data`` axis spans the job (the
        default: every rank).
      average: divide the summed gradients by ``num_microbatches x
        replicas`` (the mean-loss gradient); ``False`` divides by
        ``num_microbatches`` only.
      fusion_threshold: per-stage bucket bytes (default the job's).
      donate: accepted; no effect.
      stage_meshes: one :class:`~..core.topology.Mesh` a stage (e.g.
        :func:`stage_submeshes`): placed mode.

    Returns:
      the step: ``step(params, opt_state, batch) -> (params, opt_state,
      loss)`` with ``params`` one tree a stage, ``opt_state`` from
      ``step.init(params)`` and ``batch`` the global batch; ``loss`` is
      the mean over microbatches of each microbatch's loss averaged over
      the replicas.  ``step.plan`` is the resolved
      :class:`PipelinePlan`; ``step.stats()`` the pipeline metrics.
    """
    return _PipelineStep(stages, optimizer, mesh, num_microbatches,
                         schedule, interleave, average, fusion_threshold,
                         donate, stage_meshes)


# ---------------------------------------------------------------------------
# GPipe ticks over a pipe axis
# ---------------------------------------------------------------------------

def _gpipe_split(x, m: int):
    if x.shape[0] % m != 0:
        raise ValueError(_indivisible_message("batch", x.shape[0], m))
    return x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))


def gpipe(stage_fn: Callable, stage_params, x, *, num_microbatches: int,
          axis):
    """``x`` through the ``axis.size`` stages of a pipe axis (reference
    :1129): ``stage_fn(stage_params, x_mb) -> y_mb`` (shape-preserving)
    runs on every rank with its own stage's parameters, ``x`` is the
    pipeline's whole batch (the same on every rank of the axis) and
    divides by ``num_microbatches``.

    ``m + n - 1`` ticks: at tick ``t`` stage 0 takes microbatch ``t`` of
    ``x``, every other stage what arrived from its left neighbour
    (:func:`.axis_ops.ppermute`); the last stage finishes microbatch
    ``t - (n - 1)``.  Its outputs reach every rank of the axis by one
    :func:`.axis_ops.psum` (the other stages contribute zeros).  Every
    rank runs ``stage_fn`` every tick and selects with ``torch.where``,
    as the reference's scan does, so every rank's backward runs the same
    collectives.  The backward follows :mod:`.axis_ops`'s convention: a
    loss on the output averaged over the axis by ``pmean_loss``, and
    each stage's gradients summed over the axis, give the sequential
    gradient (the psum's backward is a psum of the ranks' cotangents)."""
    n, idx, m = axis.size, axis.index, int(num_microbatches)
    xs = _gpipe_split(x, m)
    first = torch.tensor(idx == 0, device=x.device)
    recv = torch.zeros_like(xs[0])
    ticks = m + n - 1
    ys = []
    for t in range(ticks):
        y = stage_fn(stage_params, torch.where(first, xs[min(t, m - 1)],
                                               recv))
        if t >= n - 1:
            ys.append(y)
        if t < ticks - 1:  # the last tick's send would reach no one
            recv = axis_ops.ppermute(y, axis, shift=1)
    outs = torch.stack(ys)
    outs = torch.where(torch.tensor(idx == n - 1, device=x.device), outs,
                       torch.zeros_like(outs))
    return axis_ops.psum(outs, axis).reshape(x.shape)


def play_gpipe(stage_fn: Callable, params_per_stage, x, *, n: int,
               num_microbatches: int):
    """The ticks of :func:`gpipe` over ``n`` stages played in one process
    (as :func:`.sequence.play_ring` plays the ring): virtual stage ``k``
    runs ``stage_fn(params_per_stage[k], ...)`` on what virtual stage
    ``k - 1`` produced the tick before, each tick the same calls, in the
    same order, that rank ``k`` of a real axis runs.  Returns the last
    stage's outputs, ``x``'s shape; differentiable.  With the output's
    cotangent entering at the last stage, the outputs and every stage's
    gradients are a real axis's bits."""
    m = int(num_microbatches)
    if len(params_per_stage) != n:
        raise ValueError(f"play_gpipe: {len(params_per_stage)} stage "
                         f"parameter trees for n={n} stages")
    xs = _gpipe_split(x, m)
    firsts = [torch.tensor(k == 0, device=x.device) for k in range(n)]
    recv = [torch.zeros_like(xs[0])] * n
    ticks = m + n - 1
    ys = []
    for t in range(ticks):
        y = [stage_fn(params_per_stage[k],
                      torch.where(firsts[k], xs[min(t, m - 1)], recv[k]))
             for k in range(n)]
        if t >= n - 1:
            ys.append(y[n - 1])
        if t < ticks - 1:
            recv = [y[(k - 1) % n] for k in range(n)]  # the ring's shift
    return torch.stack(ys).reshape(x.shape)


def stage_index(axis) -> int:
    """This rank's pipeline stage along the pipe ``axis``."""
    return axis.index


def select_stage_params(params_per_stage, *, axis):
    """This rank's stage of a stacked ``[n_stages, ...]``-leading tree."""
    return tree_map(lambda leaf: leaf[axis.index], params_per_stage)
