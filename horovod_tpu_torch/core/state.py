"""Process state: ``init``/``shutdown`` and the rank queries, over
``torch.distributed``.

Port of :mod:`horovod_tpu.core.state` (:160-620).  One process is one rank,
as in the original Horovod.  ``init()`` joins a process group:

* with a launcher's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``, as ``torchrun`` sets them), the job's group;
* without one, a one-rank group on an in-process ``HashStore``: the
  counterpart of the reference's size-1 fixture, needing no port;
* if the caller already initialised ``torch.distributed``, that group.

The backend follows the device: NCCL for ``cuda``, gloo for ``cpu``.
Local rank and size come from the ranks sharing a host name, exchanged
once at init (the reference's node split).

Beside that group ``init`` creates what the negotiated collectives
(:mod:`..ops.collective`) run on: a gloo control group (more than one
rank), an eager data group of the device's backend, so that negotiated
collectives never share a communicator with the monolithic step's, rank
0's coordinator, the background thread (cycle ``HOROVOD_CYCLE_TIME`` ms,
default 5) and the process-set table.  Before any collective it
validates the compression, topology, fusion, overlap and pipeline
knobs; the host exchange carries each rank's
:func:`..ops.compression.env_fingerprint`, and rank 0 warns about a
rank that differs.  When the job is
hierarchical (:mod:`.topology`) every rank creates the node and
cross-node groups, in one order.  It installs the telemetry's runtime
collector and, when ``HVD_TPU_METRICS_PORT`` is set, starts the metrics
exporter (rank 0 only unless ``HVD_TPU_METRICS_ALL_RANKS=1``; host
``HVD_TPU_METRICS_HOST``, default 0.0.0.0; a bad port warns).
``shutdown`` agrees on a SHUTDOWN response with every rank, stops the
thread, fails pending handles, closes the exporter and flushes the
quantization state.
"""

from __future__ import annotations

import os
import socket
import sys
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..analysis import lockorder as _lockorder
from ..analysis import races as _races
from ..memory import oom as _mem_oom
from ..ops import compression as _compression
from ..ops import megakernel as _megakernel
from ..ops.transport import check_env_fingerprint
from . import topology as _topology

DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024  # bytes, parallel/data.py:76-80
DEFAULT_CYCLE_TIME_MS = 5.0  # the reference's core/state.py:241


class NotInitializedError(RuntimeError):
    """Raised when the library is used before ``init()``."""

    def __init__(self) -> None:
        super().__init__("horovod_tpu_torch has not been initialized; use "
                         "horovod_tpu_torch.init().")


@_races.race_checked
@dataclass
class _State:
    initialized: bool = False
    owns_group: bool = False
    device: Optional[torch.device] = None
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    cross_rank: int = 0
    cross_size: int = 1
    hosts: tuple = ()  # each rank's host, in rank order (its node)
    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD
    tick_seconds: float = DEFAULT_CYCLE_TIME_MS / 1000.0
    control_group: Any = None  # gloo, more than one rank
    data_group: Any = None  # the negotiated collectives' data
    # Registered and removed by callers' threads, read by the cycle's
    # thread (reference core/state.py:108-114).
    # guarded_by: lock
    process_sets: dict = field(default_factory=dict)
    # guarded_by: lock
    next_process_set_id: int = 1
    runtime: Any = None  # ops.collective.Runtime
    # The node x network hierarchy (core/topology.py) and its groups,
    # created at init by every rank in one order; None when flat.
    hierarchy: Any = None
    node_group: Any = None
    cross_group: Any = None
    metrics_exporter: Any = None  # telemetry.exporter.MetricsExporter
    lock: Any = field(
        default_factory=lambda: _lockorder.make_rlock("GlobalState.lock"))


_state = _State()


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch.init(): no CUDA device is available.  The "
                "port runs on the GPU; pass device='cpu' to run on the CPU "
                "(gloo) on purpose.")
        local = int(os.environ.get("LOCAL_RANK",
                                   int(os.environ.get("RANK", 0))
                                   % torch.cuda.device_count()))
        return torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("horovod_tpu_torch.init(): device='cuda' "
                               "asked for, but no CUDA device is available")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
    elif device.type != "cpu":
        raise ValueError(f"init(device=...) takes 'cuda' or 'cpu', got "
                         f"{device}")
    return device


def init(device=None) -> None:
    """Initialize horovod_tpu_torch.  Safe to call again; a call naming
    another device re-initializes.

    Args:
      device: ``"cuda"`` (default; raises if there is no CUDA device),
        ``"cuda:N"`` or ``"cpu"``.
    """
    if _state.initialized:
        if device is None or torch.device(device) == _state.device or (
                torch.device(device).type == _state.device.type
                and torch.device(device).index is None):
            return
        shutdown()
    dev = _resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    _compression.validate_env()
    _topology.validate_env()
    from ..ops import fused as _fused
    from ..parallel import overlap as _overlap
    from ..parallel import pipeline as _pipeline

    _fused.validate_env()
    _overlap.validate_env()
    _pipeline.validate_env()
    # hvd-mem: a mistyped HVD_TPU_MEM_CAPACITY fails init too.
    _mem_oom.validate_env()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    owns = False
    if not dist.is_initialized():
        owns = True
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    rank, size = dist.get_rank(), dist.get_world_size()
    fingerprint = _compression.env_fingerprint()
    hello = [(socket.gethostname(), fingerprint)]
    if size > 1:
        hello = [None] * size
        dist.all_gather_object(hello, (socket.gethostname(), fingerprint))
    hosts = [h for h, _ in hello]
    if rank == 0:
        for r, (_, theirs) in enumerate(hello):
            check_env_fingerprint(r, theirs)
    mine = hosts[rank]
    unique = list(dict.fromkeys(hosts))
    _state.__dict__.update(
        initialized=True, owns_group=owns, device=dev, rank=rank, size=size,
        local_rank=[i for i, h in enumerate(hosts) if h == mine].index(rank),
        local_size=hosts.count(mine), cross_rank=unique.index(mine),
        cross_size=len(unique), hosts=tuple(hosts),
        fusion_threshold_bytes=int(os.environ.get(
            "HOROVOD_FUSION_THRESHOLD", DEFAULT_FUSION_THRESHOLD)),
        tick_seconds=float(os.environ.get(
            "HOROVOD_CYCLE_TIME", DEFAULT_CYCLE_TIME_MS)) / 1000.0,
        control_group=dist.new_group(backend="gloo") if size > 1 else None,
        data_group=dist.new_group(backend=backend))
    topo = _topology.replica_hierarchy(hosts)
    if topo is not None:
        # Collective: every rank creates every group, in one order.
        node = [dist.new_group(list(g), backend=backend)
                for g in topo.ici_groups]
        cross = [dist.new_group(list(g), backend=backend)
                 for g in topo.dcn_groups]
        slot = topo.slice_of_positions()[rank]
        _state.__dict__.update(
            hierarchy=topo, node_group=node[slot],
            cross_group=cross[topo.ici_groups[slot].index(rank)])
    from ..ops import collective
    from .. import trace as _trace

    # hvd-trace: a fresh span buffer and (step, cycle, trace_id) context
    # for this incarnation; rank 0 mints the trace id, the workers adopt
    # it from the first broadcast (reference core/state.py:336-341).
    _trace.reset_run(rank=rank)
    _state.runtime = collective.Runtime(_state)
    # Timeline: rank 0 only, the reference's env contract
    # (operations.cc:1201-1204).
    timeline_path = os.environ.get("HOROVOD_TIMELINE")
    if timeline_path and rank == 0:
        from ..utils.timeline import Timeline

        _state.runtime.set_timeline(Timeline(timeline_path))
    _state.runtime.start()
    _start_telemetry(rank)


def _start_telemetry(rank: int) -> None:
    """Reference core/state.py:343-369, 396-420: the runtime and memory
    collectors, the exporter on ``HVD_TPU_METRICS_PORT``, and hvd-mem's
    pre-flight."""
    from .. import telemetry as _telemetry
    from ..memory import ledger as _mem_ledger

    _telemetry.install_runtime_collector()
    # hvd-mem: ledger categories, watermarks and the device allocator's
    # figures ride every cluster_metrics pull.
    _mem_ledger.install_collector()
    _preflight_init()
    port = os.environ.get("HVD_TPU_METRICS_PORT")
    if port and _state.metrics_exporter is None and (
            rank == 0 or os.environ.get("HVD_TPU_METRICS_ALL_RANKS") == "1"):
        from ..telemetry import exporter as _exporter

        try:
            # ValueError too: a mistyped port must not stop the job.
            _state.metrics_exporter = _exporter.start_exporter(
                _telemetry.registry(), int(port.strip()),
                host=os.environ.get("HVD_TPU_METRICS_HOST", "0.0.0.0"))
        except (OSError, ValueError) as e:
            print(f"WARNING: hvd-telemetry exporter could not serve on "
                  f"HVD_TPU_METRICS_PORT={port!r}: {e}", file=sys.stderr)


def _preflight_init() -> None:
    """hvd-mem's init-time pre-flight (reference core/state.py:396-420).
    The reference sizes the largest recorded executable; the port records
    none (``memory/planner.py``), so the figure is what the ledger already
    holds (a serving engine built before ``init``)."""
    try:
        from ..memory import ledger as _mem_ledger

        held = _mem_ledger.ledger.total()
        if held and _mem_oom.advertised_capacity() is not None:
            _mem_oom.preflight_warn(
                held, "hvd.init",
                "framework-owned bytes the ledger holds (per-device)")
    except Exception:  # noqa: BLE001 — pre-flight must not break init
        pass


def shutdown() -> None:
    """Agree on shutdown with every rank, stop the background thread
    (pending handles fail with the shut-down error), leave the groups
    ``init`` created, and reset."""
    if _state.runtime is not None:
        _state.runtime.shutdown()
    if _state.metrics_exporter is not None:
        _state.metrics_exporter.close()
        _state.metrics_exporter = None
    _megakernel.flush("shutdown")
    with _state.lock:
        sets = list(_state.process_sets.values())
    if dist.is_initialized():
        for ps in sets:
            ps.close()
        if _state.owns_group:
            dist.destroy_process_group()
        else:
            for group in [ps.group for ps in sets] \
                    + [_state.control_group, _state.data_group,
                       _state.node_group, _state.cross_group]:
                if group is not None:
                    dist.destroy_process_group(group)
    _state.__dict__.update(_State().__dict__)


def start_timeline(file_path: str) -> None:
    """Begin (or switch to a new file) the Chrome-trace timeline at run
    time (≙ the post-v0.13 ``hvd.start_timeline``).  Rank 0 only, like
    ``HOROVOD_TIMELINE``; other ranks return.  A cycle in flight finishes
    before the old file closes."""
    _check_initialized()
    if _state.rank != 0:
        return
    from ..utils.timeline import Timeline

    _state.runtime.set_timeline(Timeline(file_path))


def stop_timeline() -> None:
    """Stop the timeline and finish its file (≙ ``hvd.stop_timeline``)."""
    _check_initialized()
    _state.runtime.set_timeline(None)


def mpi_threads_supported() -> bool:
    """API parity (≙ horovod_mpi_threads_supported, operations.cc:
    1531-1539): there is no MPI, and any thread may call the
    collectives, so True."""
    _check_initialized()
    return True


def _check_initialized() -> None:
    if not _state.initialized:
        raise NotInitializedError()


def is_initialized() -> bool:
    return _state.initialized


def device() -> torch.device:
    """The device ``init`` bound this process to."""
    _check_initialized()
    return _state.device


def size() -> int:
    _check_initialized()
    return _state.size


def rank() -> int:
    _check_initialized()
    return _state.rank


def local_rank() -> int:
    _check_initialized()
    return _state.local_rank


def local_size() -> int:
    _check_initialized()
    return _state.local_size


def cross_rank() -> int:
    _check_initialized()
    return _state.cross_rank


def cross_size() -> int:
    _check_initialized()
    return _state.cross_size


def fusion_threshold_bytes() -> int:
    """``HOROVOD_FUSION_THRESHOLD`` as read at ``init`` (default 64 MB), or
    from the environment before ``init``."""
    if _state.initialized:
        return _state.fusion_threshold_bytes
    return int(os.environ.get("HOROVOD_FUSION_THRESHOLD",
                              DEFAULT_FUSION_THRESHOLD))


def process_sets() -> dict:
    """The registered process sets by id (the global set is not in it); a
    copy, so the cycle's thread never iterates a dict a caller mutates."""
    with _state.lock:
        return dict(_state.process_sets)
