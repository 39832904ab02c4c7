"""The executor's reductions of one fused bucket: flat or hierarchical,
full precision, cast or quantized, with the quantization state (port of
horovod_tpu/ops/megakernel.py).

:mod:`.collective` splits each fused ALLREDUCE response into buckets by
per-tensor wire format (the compression policy) and hands each bucket's
flat buffer to :func:`launch`, which reduces it over the process set's
group:

* flat, full precision: one ``all_reduce``;
* flat, cast (bf16/fp16): the reduction in the wire dtype, cast back;
* flat, quantized (int8/int4, the reference's ``mp`` variant,
  compression.py:620 ``quantized_reduce_collective``): ``quant_pack`` of
  the n chunks, ``all_to_all_single`` of the uint8 frames,
  ``unpack_dequantize`` summing them in rank order, ``quant_pack`` of
  the reduced chunk, ``all_gather_into_tensor``, ``unpack_dequantize``;
  with error feedback the residual (what this rank meant to send less
  what its peers decoded, phase 2's error fed back into the chunk it
  owns) is kept here, one flat buffer per bucket, and added to the next
  step's contribution;
* hierarchical (the global set's SUM/AVERAGE on a job of several equal
  nodes, :mod:`..core.topology`; reference :513-563 and
  ``_hier_quant_reduce`` :605): ``reduce_scatter`` inside the node (or
  ``quantized_scatter_sum`` with ``HVD_TPU_ICI_COMPRESS``), the
  cross-node sum (``all_reduce``, a bf16/fp16 cast, or
  ``quantized_gather_sum``), and ``all_gather`` inside the node (or
  ``quantized_all_gather``).  It carries no residuals.

Average's divide comes after the decompress.  The stochastic rounding is
keyed by (``HVD_TPU_QUANT_SEED``, the bucket's tick), each bucket
counting its own launches (:func:`next_tick`); tick keys and residual
keys are flat tuples, saved and restored as JSON by
:func:`compression_state` and :func:`load_compression_state` in the
reference's format, so a state saved by one package loads into the
other.  The collectives run on the executor's stream and the kernels
(:mod:`.quant`) launch on it.

Env contract:
  HVD_TPU_DCN_COMPRESS=none|bf16|fp16|int8|int4  the cross-node leg's
        wire format; unset inherits the bucket's quantized format, an
        explicit ``none`` keeps it full precision
  HVD_TPU_ICI_COMPRESS=none|int8|int4  the intra-node legs' format
        (default none)
  HVD_TPU_HIERARCHICAL / HVD_TPU_VIRTUAL_SLICES  see core/topology.py
  HVD_TPU_COMPRESSION / HVD_TPU_QUANT_*  see ops/compression.py

What the reference has here and torch eager has no counterpart for: the
XLA executable cache and its plan digests (``plan_digest``, the
compile-time record of a fused group: eager kernels need no compile);
buffer donation and its probes (the caching allocator reuses memory
without it); ``warm_start`` and the compile manifest (:871-1061, AOT
rebuilds of executables); ``HVD_TPU_MEGAKERNEL=0`` (it chooses between
two XLA dispatch strategies, and the port has one executor).
"""

from __future__ import annotations

import functools
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import trace as _trace
from ..analysis import lockorder as _lockorder
from ..core import topology as _topology
from ..memory import ledger as _mem
from ..memory import oom as _oom
from ..memory import planner as _mem_planner
from . import compression as _c
from . import quant as _quant

# The reference's variant for one process a device, the port's only
# one; it heads every tick key.
VARIANT = "mp"
DCN_COMPRESS_ENV = "HVD_TPU_DCN_COMPRESS"
ICI_COMPRESS_ENV = "HVD_TPU_ICI_COMPRESS"

_DIST_OPS = {"psum": dist.ReduceOp.SUM, "pmin": dist.ReduceOp.MIN,
             "pmax": dist.ReduceOp.MAX, "pprod": dist.ReduceOp.PRODUCT}

# torch 2.13 renamed these; older releases have only the old names.
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


@dataclass(frozen=True)
class Hierarchy:
    """A bucket's hierarchical plan: the node x network layout and each
    leg's wire format (``wire_dtype`` the cross-node cast, ``dcn_quant``
    and ``ici_quant`` the quantized legs; None = full precision)."""

    topo: _topology.ReplicaHierarchy
    wire_dtype: Optional[str]
    dcn_quant: Optional[_c.WireFormat] = None
    ici_quant: Optional[_c.WireFormat] = None


@dataclass(frozen=True)
class GroupSpec:
    """One bucket: everything that changes what :func:`launch` computes.
    The reference keys it by its mesh's devices; the port by the process
    set and its size."""

    process_set_id: int
    size: int
    op: str               # "psum" | "pmin" | "pmax" | "pprod"
    average: bool
    denom: int
    dtype: str
    shapes: Tuple[Tuple[int, ...], ...]
    hier: Optional[Hierarchy] = None
    quant: Optional[_c.WireFormat] = None


@dataclass
class MegakernelStats:
    """launches: buckets reduced; hier_launches / quant_launches: those
    hierarchical / with a quantized leg; logical_bytes / wire_bytes: the
    payload traversals uncompressed and in the launched wire formats
    (:func:`wire_accounting`); flushes: :func:`flush` calls."""

    launches: int = 0
    hier_launches: int = 0
    quant_launches: int = 0
    logical_bytes: int = 0
    wire_bytes: int = 0
    flushes: int = 0


@dataclass
class Comm:
    """The groups one response runs on: the set's ``group`` of ``size``
    ranks, this rank's position ``pos`` in it, the node and cross-node
    groups of a hierarchy; ``calls`` counts the collective calls made."""

    group: Any
    size: int
    pos: int
    node_group: Any = None
    cross_group: Any = None
    calls: int = 0


stats = MegakernelStats()

_lock = _lockorder.make_lock("megakernel._lock")
# Error-feedback residuals, one flat buffer per bucket, keyed
# ("g", process_set_id, name_1, ..., name_k); flushed with the plan.
_residuals: Dict[Tuple, Any] = {}  # guarded_by: _lock
# Per-bucket launch counters: the stochastic rounding's tick.
_ticks: Dict[Tuple, int] = {}  # guarded_by: _lock


def reset_stats() -> None:
    with _lock:
        stats.__dict__.update(MegakernelStats().__dict__)


def dcn_compress_name() -> str:
    """The cross-node leg's compressor; "" when unset (inherit the
    bucket's quantized format), an explicit ``none`` opts out."""
    return os.environ.get(DCN_COMPRESS_ENV, "")


def ici_compress_name() -> str:
    return os.environ.get(ICI_COMPRESS_ENV, "none")


def flush(reason: str) -> None:
    """Drop the quantization state (residuals and ticks): a fusion
    threshold or policy change re-partitions the buckets."""
    with _lock:
        nr = len(_residuals)
        _residuals.clear()
        _ticks.clear()
        stats.flushes += 1
    _sync_residual_ledger()
    if nr:
        print(f"[hvd-megakernel] state flushed ({reason}): {nr} residual "
              f"tensors dropped", file=sys.stderr)


# ---------------------------------------------------------------------------
# Quantization state (reference :298-417)
# ---------------------------------------------------------------------------

def next_tick(group_key: Tuple) -> int:
    """This launch's tick for one bucket: 0, 1, 2, ... per key."""
    with _lock:
        t = _ticks.get(group_key, 0)
        _ticks[group_key] = t + 1
        return t


def _restored(r, dtype: torch.dtype, device) -> Optional[torch.Tensor]:
    """A residual restored by :func:`load_compression_state` (numpy) as
    a tensor of ``dtype`` on ``device``, or None if its dtype differs.
    numpy has no bfloat16: the port saves bf16 residuals as float32, and
    the reference's bf16 arrays come as ml_dtypes'; both are exact."""
    name = str(r.dtype)
    want = str(dtype).replace("torch.", "")
    if name != want and not (want == "bfloat16" and name == "float32"):
        return None
    return torch.from_numpy(np.asarray(r, np.float32) if name == "bfloat16"
                            else np.array(r)).to(device=device, dtype=dtype)


def take_residual(key: Tuple, dtype: torch.dtype, shape: Tuple[int, ...],
                  device) -> Optional[torch.Tensor]:
    """Remove and return the residual stored under ``key``, or None when
    absent or stale (first use, after a flush, another shape or dtype)."""
    with _lock:
        r = _residuals.pop(key, None)
    if r is None or tuple(r.shape) != tuple(shape):
        return None
    if isinstance(r, np.ndarray):
        return _restored(r, dtype, device)
    if r.dtype != dtype:
        return None
    return r.to(device)


def store_residuals(keys: Sequence[Tuple], arrays: Sequence) -> None:
    with _lock:
        for key, arr in zip(keys, arrays):
            _residuals[key] = arr
    _sync_residual_ledger()


def drop_residuals(keys: Sequence[Tuple]) -> None:
    with _lock:
        for key in keys:
            _residuals.pop(key, None)
    _sync_residual_ledger()


def _sync_residual_ledger() -> None:
    """hvd-mem (reference :344-369): mirror the EF residual store's byte
    total into the ledger's ``megakernel.residuals`` (an absolute size,
    not deltas).  Not gated on telemetry: a flush while telemetry is off
    must still clear the figure."""
    with _lock:
        arrays = list(_residuals.values())
    total = 0
    for v in arrays:
        nb = getattr(v, "nbytes", None)
        if nb:
            total += int(nb)
    _mem.ledger.set("megakernel.residuals", total)


def residual_count() -> int:
    with _lock:
        return len(_residuals)


def compression_state() -> Dict[str, Dict[str, Any]]:
    """Checkpoint snapshot of the quantization state: this rank's
    residuals (numpy, bf16 as float32) and the ticks, JSON-keyed as the
    reference's (exported as ``hvd.compression_state``)."""
    with _lock:
        items = list(_residuals.items())
        ticks = {json.dumps(list(k)): int(v) for k, v in _ticks.items()}
    res = {}
    for k, v in items:
        if isinstance(v, torch.Tensor):
            v = v.detach()
            v = (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
        res[json.dumps(list(k))] = np.asarray(v)
    return {"residuals": res, "ticks": ticks}


def load_compression_state(state: Dict[str, Dict[str, Any]]) -> None:
    """Restore a :func:`compression_state` snapshot (exported as
    ``hvd.load_compression_state``)."""
    res = {tuple(json.loads(k)): np.asarray(v)
           for k, v in (state.get("residuals") or {}).items()}
    ticks = {tuple(json.loads(k)): int(v)
             for k, v in (state.get("ticks") or {}).items()}
    with _lock:
        _residuals.clear()
        _residuals.update(res)
        _ticks.clear()
        _ticks.update(ticks)


# ---------------------------------------------------------------------------
# Plans (reference :451-506, :1064-1113)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _hierarchy_cached(topo: _topology.ReplicaHierarchy, dtype: str,
                      dcn: str, ici: str, group_name: str) -> Hierarchy:
    def quant_fmt(name):
        # The whole bucket rides a leg: the min-elems floor is moot.
        fmt = _c.wire_format_for(name, dtype, 1 << 30)
        return fmt if fmt is not None and fmt.kind == "quant" else None

    wire = _c.wire_dtype_for(dcn or "none", dtype)
    dcn_q = quant_fmt(dcn) if dcn else None
    if dcn == "" and dcn_q is None and wire is None and group_name:
        # Unset: a bucket the policy quantizes keeps its format on the
        # cross-node leg; the node legs stay full precision unless
        # HVD_TPU_ICI_COMPRESS opts them in.
        dcn_q = quant_fmt(group_name)
    return Hierarchy(
        topo=topo,
        wire_dtype=(str(wire).replace("torch.", "")
                    if wire is not None else None),
        dcn_quant=dcn_q, ici_quant=quant_fmt(ici))


def hierarchy_for(topo: Optional[_topology.ReplicaHierarchy], op: str,
                  dtype, group_fmt=None) -> Optional[Hierarchy]:
    """The hierarchical plan of one bucket, or None for flat.  Only
    SUM/AVERAGE decompose; ``group_fmt`` (the bucket's policy format)
    feeds the cross-node leg's default."""
    if op != "psum" or topo is None:
        return None
    return _hierarchy_cached(
        topo, str(_c.torch_dtype(dtype)).replace("torch.", ""),
        dcn_compress_name(), ici_compress_name(),
        group_fmt.name if (group_fmt is not None
                           and group_fmt.kind == "quant") else "")


def needs_quant(spec: GroupSpec) -> bool:
    """True when a leg of ``spec`` is quantized (the reference's
    ``_needs_quant_build``)."""
    if spec.quant is not None and spec.quant.kind == "quant":
        return True
    h = spec.hier
    return h is not None and (h.dcn_quant is not None
                              or h.ici_quant is not None)


def _quant_unit(spec: GroupSpec) -> int:
    """Alignment of the flat buffer so every exchange chunk is a whole
    number of blocks: n * block flat, node_size * block hierarchical."""
    blocks = [f.block for f in (
        spec.quant, spec.hier.dcn_quant if spec.hier else None,
        spec.hier.ici_quant if spec.hier else None)
        if f is not None and f.kind == "quant"]
    block = max(blocks) if blocks else 2
    n = spec.hier.topo.ici_size if spec.hier is not None else spec.size
    return n * block


def wire_accounting_legs(spec: GroupSpec) -> Tuple[int, int, int]:
    """``(logical_bytes, wire_bytes, dcn_bytes)`` of one launch: payload
    traversals per leg (two flat; two in the node plus the 1/node_size
    fragment across nodes hierarchical), each in its leg's format."""
    T = sum(math.prod(s) for s in spec.shapes)
    item = _c.torch_dtype(spec.dtype).itemsize

    def fmt_bytes(count: int, fmt) -> int:
        if fmt is None:
            return count * item
        if fmt.kind == "cast":
            return count * (fmt.bits // 8)
        return (count * fmt.bits + 7) // 8 + (-(-count // fmt.block)) * 2

    if spec.hier is None:
        return 2 * T * item, 2 * fmt_bytes(T, spec.quant), 0
    h = spec.hier
    F = -(-T // h.topo.ici_size)
    cast = spec.quant if (spec.quant is not None
                          and spec.quant.kind == "cast") else None
    ici_f = h.ici_quant or cast
    if h.dcn_quant is not None:
        dcn_f = h.dcn_quant
    elif h.wire_dtype is not None:
        dcn_f = _c.WireFormat(
            kind="cast", name=h.wire_dtype, wire_dtype=h.wire_dtype,
            bits=8 * _c.torch_dtype(h.wire_dtype).itemsize,
            stochastic=False, error_feedback=False)
    else:
        dcn_f = cast
    logical = (2 * T + F) * item
    dcn_b = fmt_bytes(F, dcn_f)
    return logical, 2 * fmt_bytes(T, ici_f) + dcn_b, dcn_b


def wire_accounting(spec: GroupSpec) -> Tuple[int, int]:
    """``(logical_bytes, wire_bytes)``; see :func:`wire_accounting_legs`."""
    logical, wire_b, _ = wire_accounting_legs(spec)
    return logical, wire_b


def quant_group_key(variant: str, psid: int, names: Sequence[str],
                    fmt) -> tuple:
    """The tick key of a bucket (reference collective.py:847): a flat
    tuple, so it survives the JSON of :func:`compression_state`."""
    return (variant, psid, fmt.name if fmt is not None else "") \
        + tuple(names)


# ---------------------------------------------------------------------------
# The quantized legs (reference compression.py:620-691)
# ---------------------------------------------------------------------------

def _all_to_all(x: torch.Tensor, comm: Comm, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    comm.calls += 1
    return out


def _gather(x: torch.Tensor, n: int, comm: Comm, group) -> torch.Tensor:
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather(out, x.contiguous(), group=group)
    comm.calls += 1
    return out


def quantized_reduce(vin: torch.Tensor, fmt: _c.WireFormat, key, comm: Comm,
                     error_feedback: bool):
    """The two-phase quantized allreduce of ``vin`` [Tp] (Tp a multiple of
    n * block) over ``comm.group``: ``(reduced [Tp] f32, new residual [Tp]
    in vin's dtype or None)``."""
    n, pos = comm.size, comm.pos
    C = vin.shape[0] // n
    r_new = torch.empty_like(vin) if error_feedback else None
    w1 = _quant.quant_pack(vin.view(n, C), fmt, _c._noise_key(key, 1, pos),
                           None if r_new is None else r_new.view(n, C))
    red = _quant.unpack_dequantize(_all_to_all(w1, comm, comm.group), C, fmt,
                                   sum_rows=True)
    e2 = (torch.empty((1, C), dtype=torch.float32, device=vin.device)
          if error_feedback else None)
    w2 = _quant.quant_pack(red[None], fmt, _c._noise_key(key, 2, pos), e2)
    out = _quant.unpack_dequantize(_gather(w2, n, comm, comm.group), C, fmt,
                                   sum_rows=False).reshape(-1)
    if error_feedback:
        # The chunk's owner knows phase 2's error too: it re-enters the
        # sum through the owner's residual next step.
        r_new[pos * C:(pos + 1) * C] += e2[0].to(vin.dtype)
    return out, r_new


def quantized_scatter_sum(v: torch.Tensor, fmt: _c.WireFormat, key, n: int,
                          pos: int, comm: Comm, group) -> torch.Tensor:
    """Phase 1 alone: this rank's reduced chunk [C] f32 (the node leg of
    a quantized hierarchy)."""
    C = v.shape[0] // n
    w = _quant.quant_pack(v.view(n, C), fmt, _c._noise_key(key, 1, pos))
    return _quant.unpack_dequantize(_all_to_all(w, comm, group), C, fmt,
                                    sum_rows=True)


def quantized_gather_sum(frag: torch.Tensor, fmt: _c.WireFormat, key,
                         n: int, pos: int, comm: Comm, group) -> torch.Tensor:
    """One-shot quantized sum across a small group: all_gather the wire
    frames, dequantize and sum in order (the cross-node leg)."""
    w = _quant.quant_pack(frag[None], fmt, _c._noise_key(key, 3, pos))
    return _quant.unpack_dequantize(_gather(w, n, comm, group),
                                    frag.shape[0], fmt, sum_rows=True)


def quantized_all_gather(frag: torch.Tensor, fmt: _c.WireFormat, key,
                         n: int, pos: int, comm: Comm, group) -> torch.Tensor:
    """All_gather in wire format (the last node leg)."""
    w = _quant.quant_pack(frag[None], fmt, _c._noise_key(key, 4, pos))
    return _quant.unpack_dequantize(_gather(w, n, comm, group),
                                    frag.shape[0], fmt,
                                    sum_rows=False).reshape(-1)


# ---------------------------------------------------------------------------
# The reductions
# ---------------------------------------------------------------------------

def _pad(v: torch.Tensor, unit: int) -> torch.Tensor:
    pad = (-v.shape[0]) % unit
    return torch.cat([v, v.new_zeros(pad)]) if pad else v


def _hier_flat(v: torch.Tensor, spec: GroupSpec, comm: Comm) -> torch.Tensor:
    """Full-precision hierarchy (reference :538-560): reduce-scatter in
    the node, sum across nodes (optionally cast), all_gather in the
    node."""
    h = spec.hier
    ici = h.topo.ici_size
    L = v.shape[0]
    x = _pad(v, ici)
    s = torch.empty(x.shape[0] // ici, dtype=x.dtype, device=x.device)
    _reduce_scatter(s, x, op=dist.ReduceOp.SUM, group=comm.node_group)
    comm.calls += 1
    if h.wire_dtype is not None:
        w = s.to(_c.torch_dtype(h.wire_dtype))
        dist.all_reduce(w, group=comm.cross_group)
        s = w.to(s.dtype)
    else:
        dist.all_reduce(s, group=comm.cross_group)
    comm.calls += 1
    return _gather(s, ici, comm, comm.node_group)[:L]


def _hier_quant(vin: torch.Tensor, spec: GroupSpec, key,
                comm: Comm) -> torch.Tensor:
    """Hierarchy with per-leg wire formats (reference ``_hier_quant_
    reduce`` :605): the reduced [Tp] f32."""
    h = spec.hier
    topo = h.topo
    ici, pos = topo.ici_size, comm.pos
    if h.ici_quant is not None:
        frag = quantized_scatter_sum(vin, h.ici_quant, key, ici, pos, comm,
                                     comm.node_group)
    else:
        frag = torch.empty(vin.shape[0] // ici, dtype=vin.dtype,
                           device=vin.device)
        _reduce_scatter(frag, vin, op=dist.ReduceOp.SUM,
                        group=comm.node_group)
        comm.calls += 1
        frag = frag.float()
    if h.dcn_quant is not None:
        frag = quantized_gather_sum(frag, h.dcn_quant, key, topo.n_slices,
                                    topo.slice_of_positions()[pos], comm,
                                    comm.cross_group)
    elif h.wire_dtype is not None:
        w = frag.to(_c.torch_dtype(h.wire_dtype))
        dist.all_reduce(w, group=comm.cross_group)
        comm.calls += 1
        frag = w.float()
    else:
        dist.all_reduce(frag, group=comm.cross_group)
        comm.calls += 1
    if h.ici_quant is not None:
        return quantized_all_gather(frag, h.ici_quant, key, ici, pos, comm,
                                    comm.node_group)
    return _gather(frag, ici, comm, comm.node_group)


def divide(x: torch.Tensor, denom: int) -> torch.Tensor:
    """Average's division, in place; floor for integer dtypes."""
    if x.dtype.is_floating_point or x.dtype.is_complex:
        return x.div_(denom)
    return x.floor_divide_(denom)


def launch(spec: GroupSpec, v: torch.Tensor, comm: Comm,
           names: Sequence[str]) -> torch.Tensor:
    """Reduce one bucket's flat buffer ``v`` [T] (the concatenation of
    ``names``' tensors, owned by the executor) over ``comm``; returns the
    [T] result in ``v``'s dtype, divided for Average."""
    # hvd-mem (reference :1135-1216): the launch's footprint (inputs +
    # outputs, the planner's byte model) is charged to the ledger for the
    # dispatch's lifetime; the simulated capacity is checked first, and
    # an out-of-memory dumps the flight ring naming this launch.
    mem_on = _mem.enabled()
    trace_on = _trace.enabled()
    cap = _oom.simulated_capacity()
    fusion_b = (_mem_planner.fusion_group_bytes(
        spec.shapes, spec.dtype, spec.size, VARIANT)
        if (mem_on or trace_on or cap is not None) else 0)
    if cap is not None:
        _oom.check_simulated(
            lambda: _launch_name(spec),
            _mem_planner.fusion_group_device_bytes(spec.shapes,
                                                   spec.dtype))
    trace_t0 = time.monotonic() if trace_on else 0.0
    if mem_on:
        _mem.ledger.alloc("megakernel.fusion", fusion_b)
    try:
        red = _launch(spec, v, comm, names)
    except Exception as e:  # noqa: BLE001 — re-raised: forensics only
        if _oom.is_resource_exhausted(e):
            _oom.oom_event(_launch_name(spec), e, fusion_b or None)
        raise
    finally:
        if mem_on:
            _mem.ledger.free("megakernel.fusion", fusion_b)
    if trace_on:
        # hvd-trace launch span: the collective itself, with the wire
        # bytes that split a hierarchical launch into its legs.
        logical_b, wire_b = wire_accounting(spec)
        _trace.span(f"megakernel/{spec.op}", "collective", trace_t0,
                    time.monotonic(),
                    args={"groups": len(spec.shapes),
                          "hier": spec.hier is not None,
                          "wire_bytes": wire_b, "mem_bytes": fusion_b})
    return red


def _launch_name(spec: GroupSpec) -> str:
    """Executable name for OOM forensics (reference :1116-1119)."""
    return f"megakernel/{spec.op}/{VARIANT}x{len(spec.shapes)}"


def _launch(spec: GroupSpec, v: torch.Tensor, comm: Comm,
            names: Sequence[str]) -> torch.Tensor:
    dtype = v.dtype
    T = v.shape[0]
    fmt = spec.quant
    cast = fmt if fmt is not None and fmt.kind == "cast" else None
    if needs_quant(spec):
        quant = fmt if fmt is not None and fmt.kind == "quant" else None
        use_ef = quant is not None and quant.error_feedback \
            and spec.hier is None
        res_key = ("g", spec.process_set_id) + tuple(names)
        vin = v
        if use_ef:
            # A missing residual is zeros, added like a stored one (as
            # the reference does: v + 0 turns -0.0 into +0.0).
            stored = take_residual(res_key, dtype, (T,), v.device)
            vin = v + (stored if stored is not None else torch.zeros_like(v))
        if cast is not None:
            vin = vin.to(_c.torch_dtype(cast.wire_dtype))
        vin = _pad(vin, _quant_unit(spec))
        tick = next_tick(quant_group_key(VARIANT, spec.process_set_id,
                                         names, fmt))
        key = _c.step_key(_c.quant_seed(), tick)
        if spec.hier is None:
            red, r_new = quantized_reduce(vin, quant, key, comm, use_ef)
            if r_new is not None:
                store_residuals([res_key], [r_new[:T]])
        else:
            red = _hier_quant(vin, spec, key, comm)
        red = red[:T].to(dtype)
    else:
        x = v if cast is None else v.to(_c.torch_dtype(cast.wire_dtype))
        if spec.hier is not None:
            x = _hier_flat(x, spec, comm)
        else:
            dist.all_reduce(x, op=_DIST_OPS[spec.op], group=comm.group)
            comm.calls += 1
        red = x if cast is None else x.to(dtype)
    if spec.average:
        divide(red, spec.denom)
    logical_b, wire_b = wire_accounting(spec)
    with _lock:
        stats.launches += 1
        stats.logical_bytes += logical_b
        stats.wire_bytes += wire_b
        if spec.hier is not None:
            stats.hier_launches += 1
        if needs_quant(spec):
            stats.quant_launches += 1
    return red
