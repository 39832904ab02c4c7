"""Chunked computation-collective closers (port of
horovod_tpu/ops/fused.py:88-252).

A producer GEMM is split along a reduction-free axis (rows, or the MoE
capacity axis) and each chunk's collective starts while the next chunk
computes.  The reference emits the chunks into one XLA program and lets
the compiler overlap them; in eager PyTorch chunk *i*'s collective is
issued asynchronously (``async_op=True``, :mod:`..parallel.axis_ops`)
before chunk *i+1*'s product is launched, and every handle is waited on
before the concatenation.

**Bitwise contract** (reference :17-38): rows are free of reductions
and the collectives are elementwise in them, so every output element is
computed by one chunk with the unfused program's contraction, and the
fused result is the unfused result's bytes, provided the matrix product
sums each element in the same order at every row count.  XLA's does;
whether cuBLAS does on a given card is what ``chip_smoke.py``'s parallel
phase reports.  Chunks of fewer than :data:`MIN_CHUNK_ROWS` rows are
never made (a one-row product may take a matrix-vector kernel that sums
in another order); one chunk is the unfused program, and
``HVD_TPU_FUSE=off`` pins it.

Env contract (validated at ``init``; both knobs are in the env
fingerprint, since a rank with another chunk plan issues other
collectives):

  HVD_TPU_FUSE=auto|on|off     auto (default) = on; 1/0 alias on/off
  HVD_TPU_FUSE_CHUNKS=<n>      default 4: chunks per fused group, clamped
                               so every chunk keeps MIN_CHUNK_ROWS rows

The reference's ``FusedProgram`` (AOT compiles, the compile manifest)
serves XLA executables and has no counterpart, nor has its
``fused.groups_compiled`` (nothing is compiled).  Its memory charge
does (reference :330-361): a chunked group runs inside
:func:`..memory.oom.guard` and charges the ledger's ``fused.launch``
with :func:`..memory.planner.fused_group_bytes` (the output and one
chunk's partial) while its chunks are joined.  Telemetry (reference
:97-107, :363-395): ``fused.launches`` counts chunked groups run, and
:func:`measure_exposed_comm` feeds ``fused.exposed_comm_seconds``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional, Tuple

import torch

from .. import telemetry as _telemetry

FUSE_ENV = "HVD_TPU_FUSE"
CHUNKS_ENV = "HVD_TPU_FUSE_CHUNKS"
_VALID_MODES = ("auto", "on", "off")
DEFAULT_CHUNKS = 4
MIN_CHUNK_ROWS = 2

_M_LAUNCHES = _telemetry.counter(
    "fused.launches", "chunked computation-collective groups run")
_M_EXPOSED = _telemetry.histogram(
    "fused.exposed_comm_seconds", "seconds",
    "communication seconds not hidden under producer compute in one "
    "fused group: max(0, fused_total - compute_only)")


def fuse_mode() -> str:
    """The fusion knob, normalized (1/0 alias on/off)."""
    v = (os.environ.get(FUSE_ENV, "auto").strip().lower() or "auto")
    return {"1": "on", "0": "off"}.get(v, v)


def fuse_chunks() -> int:
    """Requested chunks per fused group (``HVD_TPU_FUSE_CHUNKS``)."""
    v = os.environ.get(CHUNKS_ENV, "").strip()
    if not v:
        return DEFAULT_CHUNKS
    try:
        n = int(v)
    except ValueError:
        n = 0
    if n < 1:
        raise ValueError(
            f"{CHUNKS_ENV}={v!r}: expected a positive integer "
            f"(chunks per fused computation-collective group)")
    return n


def validate_env() -> None:
    """Fail ``init()``, not the first fused call, on a malformed knob."""
    v = os.environ.get(FUSE_ENV)
    if v and fuse_mode() not in _VALID_MODES:
        raise ValueError(
            f"{FUSE_ENV}={v!r}: expected one of "
            f"{'|'.join(_VALID_MODES)} (1/0 alias on/off)")
    fuse_chunks()


def enabled(override: Optional[bool] = None) -> bool:
    """Whether chunked bodies are emitted; ``auto`` means on."""
    if override is not None:
        return bool(override)
    return fuse_mode() != "off"


def plan_chunks(n_rows: int, chunks: Optional[int] = None
                ) -> Tuple[Tuple[int, int], ...]:
    """``(start, size)`` chunks of ``n_rows`` rows: the requested count
    (default :func:`fuse_chunks`) clamped so each keeps
    :data:`MIN_CHUNK_ROWS` rows, the remainder spread one row at a time
    over the leading chunks (reference :162)."""
    want = fuse_chunks() if chunks is None else int(chunks)
    if want < 1:
        raise ValueError(f"chunks must be >= 1, got {want}")
    c = max(1, min(want, n_rows // MIN_CHUNK_ROWS))
    base, extra = divmod(n_rows, c)
    plan, start = [], 0
    for i in range(c):
        size = base + (1 if i < extra else 0)
        plan.append((start, size))
        start += size
    return tuple(plan)


def chunked_map(fn: Callable, x: torch.Tensor, *, axis: int = 0,
                chunks: Optional[int] = None,
                fuse: Optional[bool] = None) -> torch.Tensor:
    """``fn`` over chunks of ``x`` along the reduction-free ``axis``,
    concatenated.  ``fn`` issues its collectives asynchronously and
    returns a :class:`~..parallel.axis_ops.Pending` (or a tensor), so
    chunk *i*'s collective is in flight while chunk *i+1* computes;
    every one is waited on before the concatenation.  Disabled or
    degenerate plans call ``fn`` once on the whole of ``x``."""
    from ..parallel.axis_ops import wait

    if not enabled(fuse):
        return wait(fn(x))
    plan = plan_chunks(int(x.shape[axis]), chunks)
    if len(plan) == 1:
        return wait(fn(x))
    # One split (its backward is one concatenation of the chunks'
    # gradients), not a slice a chunk (each slice's backward would zero a
    # whole-sized gradient and add it in).
    from ..memory import ledger as _mem
    from ..memory import oom as _oom
    from ..memory import planner as _mem_planner

    parts = torch.split(x, [size for _, size in plan], dim=axis)
    with _oom.guard("fused/chunked_map"):
        pending = [fn(part) for part in parts]
        _M_LAUNCHES.inc()
        outs = [wait(p) for p in pending]
        nbytes = 0
        if _mem.enabled():
            shape = list(outs[0].shape)
            shape[axis] = sum(int(o.shape[axis]) for o in outs)
            nbytes = _mem_planner.fused_group_bytes(
                tuple(shape), len(outs), outs[0].dtype, chunk_axis=axis)
            _mem.ledger.alloc("fused.launch", nbytes)
        try:
            return torch.cat(outs, dim=axis)
        finally:
            if nbytes:
                _mem.ledger.free("fused.launch", nbytes)


def observe_exposed(seconds: float) -> None:
    """Record one fused group's exposed-communication window
    (``fused.exposed_comm_seconds``)."""
    if _telemetry.enabled():
        _M_EXPOSED.observe(max(0.0, float(seconds)))


def measure_exposed_comm(program: Callable, compute_only: Callable,
                         args: tuple, *, cycles: int = 5) -> float:
    """Median exposed-communication seconds of ``program`` over
    ``compute_only`` (the same producer computation with the collective
    legs left out): ``max(0, total - compute)``, observed into
    ``fused.exposed_comm_seconds`` and returned.  Each leg is warmed once,
    then timed ``cycles`` times with its dispatch and a full fence inside
    the window: ``torch.cuda.synchronize`` when a result lives on the
    card, nothing more on the CPU (the call returns when the work is
    done)."""
    def fence(out):
        leaves = out if isinstance(out, (tuple, list)) else (out,)
        if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
            torch.cuda.synchronize()

    def timed(fn):
        fence(fn(*args))
        lats = []
        for _ in range(cycles):
            t0 = time.perf_counter()
            fence(fn(*args))
            lats.append(time.perf_counter() - t0)
        lats.sort()
        return lats[len(lats) // 2]

    exposed = max(0.0, timed(program) - timed(compute_only))
    observe_exposed(exposed)
    return exposed


def matmul_psum(x, w, *, axis, chunks: Optional[int] = None,
                fuse: Optional[bool] = None) -> torch.Tensor:
    """``psum(x @ w)`` over ``axis`` (a :class:`~..core.topology.MeshAxis`),
    chunked along ``x``'s rows: the row-parallel closer.  The product is
    f32 (the reference's ``preferred_element_type``)."""
    from ..parallel import axis_ops

    def leg(xc):
        return axis_ops.psum(_f32_matmul(xc, w), axis, async_op=True)

    return chunked_map(leg, x, axis=0, chunks=chunks, fuse=fuse)


def matmul_reduce_scatter(x, w, *, axis, scatter_axis: int = -1,
                          chunks: Optional[int] = None,
                          fuse: Optional[bool] = None) -> torch.Tensor:
    """``psum_scatter(x @ w)`` over ``axis``, chunked along ``x``'s rows:
    each rank keeps its ``scatter_axis`` shard of the sum."""
    from ..parallel import axis_ops

    def leg(xc):
        part = _f32_matmul(xc, w)
        return axis_ops.psum_scatter(
            part, axis, scatter_dimension=scatter_axis, async_op=True)

    return chunked_map(leg, x, axis=0, chunks=chunks, fuse=fuse)


def all_gather_matmul(x, w, *, axis, gather_axis: int = -1,
                      chunks: Optional[int] = None,
                      fuse: Optional[bool] = None) -> torch.Tensor:
    """``all_gather(x) @ w`` over ``axis``, chunked along ``x``'s rows:
    ``gather_axis`` is ``x``'s sharded feature (contraction) axis."""
    from ..parallel import axis_ops

    def leg(xc):
        xg = axis_ops.all_gather(xc, axis, dim=gather_axis)
        return _f32_matmul(xg, w)

    return chunked_map(leg, x, axis=0, chunks=chunks, fuse=fuse)


def _f32_matmul(x, w):
    """``dot(x, w, preferred_element_type=f32)``: bf16 products are exact
    in f32 and the accumulation is f32, so upcasting first is the same
    function."""
    return torch.matmul(x.float(), w.float())
