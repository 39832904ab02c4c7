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

With more than one rank ``init`` opens the TCP control channel the
negotiated collectives (:mod:`..ops.collective`) agree over
(:mod:`..ops.transport`, the reference's :270-315): rank 0 listens on
``HVD_TPU_CONTROLLER_PORT`` when it is set (else a free port; the host is
``MASTER_ADDR`` when set, else loopback on one host and rank 0's host name
across hosts) and every other rank connects,
as a :class:`~..ops.transport.WorkerTransport`, or as a
:class:`~..ops.tree.TreeWorkerTransport` when the tree overlay is armed
(:func:`..ops.tree.tree_active`).  Every rank's host name, then the address
and each interior's relay listener, travel over the job's group.  The HELLO carries each rank's
:func:`..ops.compression.env_fingerprint` (rank 0 warns about a rank
that differs); rank 0's TOPO answers with the local and cross rank and
size (the reference's node split) and whether it runs the response
cache.

Beside that ``init`` creates an eager data group of the device's
backend, so that negotiated collectives never share a communicator with
the monolithic step's, rank 0's coordinator, the background thread
(cycle ``HOROVOD_CYCLE_TIME`` ms, default 5) and the process-set table.
Before any collective it validates the compression, topology, fusion,
overlap, pipeline, tree, memory, fault-injection (``HVD_TPU_FAULTS``) and
tuning (``HVD_TPU_TUNE*``) knobs, and once the runtime exists it installs
hvd-tune (:func:`..tuning.install`: every rank's collector, rank 0's
controller when it is enabled).  When the job is
hierarchical (:mod:`.topology`) every rank creates the node and
cross-node groups, in one order.  It installs the telemetry's runtime
collector and, when ``HVD_TPU_METRICS_PORT`` is set, starts the metrics
exporter (rank 0 only unless ``HVD_TPU_METRICS_ALL_RANKS=1``; host
``HVD_TPU_METRICS_HOST``, default 0.0.0.0; a bad port warns).
``shutdown`` agrees on a SHUTDOWN response with every rank, stops the
thread, fails pending handles, runs the channel's exit handshake and
closes its sockets and threads, closes the exporter and flushes the
quantization state.
"""

from __future__ import annotations

import os
import socket
import sys
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from ..analysis import lockorder as _lockorder
from ..analysis import races as _races
from ..memory import oom as _mem_oom
from ..ops import compression as _compression
from ..ops import megakernel as _megakernel
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
    # ops.transport.ControllerTransport / WorkerTransport, or
    # ops.tree.TreeWorkerTransport; None with one rank.
    channel: Any = None
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
    # Rank 0's hvd-tune controller (tuning.Tuner) when HVD_TPU_TUNE=1 or
    # HOROVOD_AUTOTUNE=1: ``tuner`` is the marker source ``_negotiate``
    # drains, ``autotuner`` the same object as the cycle's
    # record_bytes/maybe_step feed (the reference's two names).
    tuner: Any = None
    autotuner: Any = None
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
    from ..ops import tree as _tree
    from ..parallel import overlap as _overlap
    from ..parallel import pipeline as _pipeline

    _fused.validate_env()
    _overlap.validate_env()
    _pipeline.validate_env()
    _tree.validate_env()
    # hvd-mem: a mistyped HVD_TPU_MEM_CAPACITY fails init too.
    _mem_oom.validate_env()
    # hvd-chaos: so does a mistyped HVD_TPU_FAULTS, with the valid sites.
    from .. import chaos as _chaos

    _chaos.validate_env()
    # hvd-tune: a mistyped HVD_TPU_TUNE/_WINDOW/_PIN fails init, not the
    # first decision window.
    from .. import tuning as _tuning

    _tuning.validate_env()
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
    if size > 1:
        hosts, channel = _open_channel(rank, size)
        topo = channel.topology[0] if rank == 0 else channel.topology
        place = dict(local_rank=topo.local_rank, local_size=topo.local_size,
                     cross_rank=topo.cross_rank,
                     cross_size=topo.cross_size)
    else:
        hosts, channel, place = [socket.gethostname()], None, {}
    _state.__dict__.update(
        initialized=True, owns_group=owns, device=dev, rank=rank, size=size,
        hosts=tuple(hosts), channel=channel,
        fusion_threshold_bytes=int(os.environ.get(
            "HOROVOD_FUSION_THRESHOLD", DEFAULT_FUSION_THRESHOLD)),
        tick_seconds=float(os.environ.get(
            "HOROVOD_CYCLE_TIME", DEFAULT_CYCLE_TIME_MS)) / 1000.0,
        data_group=dist.new_group(backend=backend), **place)
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
    # hvd-tune: every rank's collector; rank 0's controller when enabled,
    # in place before the first cycle.
    _tuning.install(_state)
    # Timeline: rank 0 only, the reference's env contract
    # (operations.cc:1201-1204).
    timeline_path = os.environ.get("HOROVOD_TIMELINE")
    if timeline_path and rank == 0:
        from ..utils.timeline import Timeline

        _state.runtime.set_timeline(Timeline(timeline_path))
    _state.runtime.start()
    _start_telemetry(rank)


def _control_address(hosts) -> Tuple[str, str]:
    """(bind address, advertised host) of rank 0's listener.  The host is
    ``MASTER_ADDR`` when set; else loopback when every rank's host name
    (``hosts``) is one, and else this host's name on every interface, as
    the tree's interior relays do, so that a job set up with its own
    ``init_method`` across hosts still reaches rank 0."""
    host = os.environ.get("MASTER_ADDR")
    if not host:
        if len(set(hosts)) == 1:
            return "127.0.0.1", "127.0.0.1"
        return "0.0.0.0", socket.gethostname()
    return ("127.0.0.1" if host in ("127.0.0.1", "localhost")
            else "0.0.0.0"), host


def _open_channel(rank: int, size: int):
    """The control channel (reference core/state.py:270-315): one
    exchange over the job's group carries every rank's host name; rank 0
    listens (on ``HVD_TPU_CONTROLLER_PORT`` when set, else a free port)
    and each interior of the tree opens its relay listener; a second
    exchange carries those addresses, then the ranks connect.  Returns
    the hosts in rank order and this rank's transport."""
    from ..ops import transport as _tp
    from ..ops import tree as _tree

    layout = _tree.build_layout(size) if _tree.tree_active(size) else None
    hosts = [None] * size
    dist.all_gather_object(hosts, socket.gethostname())
    bind, host = _control_address(hosts)
    ctrl = relay = None
    addr = None
    try:
        if rank == 0:
            port = os.environ.get("HVD_TPU_CONTROLLER_PORT")
            ctrl = _tp.ControllerTransport(size, int(port) if port else 0,
                                           bind_host=bind, tree=layout)
            addr = (host, ctrl.port)
        elif layout is not None and layout.is_interior(rank):
            relay = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            relay.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            relay.bind((bind, 0))
            relay.listen(len(layout.children(rank)))
            addr = (host if bind == "127.0.0.1" else socket.gethostname(),
                    relay.getsockname()[1])
        info = [None] * size
        dist.all_gather_object(info, addr)
        if rank == 0:
            ctrl.accept(hostname=hosts[0])
            return hosts, ctrl
        root = info[0]
        if layout is None:
            return hosts, _tp.WorkerTransport(root[0], root[1], rank,
                                              hostname=hosts[rank])
        parent = layout.parent(rank)
        return hosts, _tree.TreeWorkerTransport(
            root[0], root[1], rank, layout, hostname=hosts[rank],
            parent_addr=root if parent == 0 else info[parent],
            listen_sock=relay)
    except BaseException:
        if ctrl is not None:
            ctrl.close()
        if relay is not None:
            relay.close()
        raise


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
    (pending handles fail with the shut-down error), close the control
    channel, leave the groups ``init`` created, and reset."""
    if _state.runtime is not None:
        _state.runtime.shutdown()
    if _state.autotuner is not None:
        _state.autotuner.close()
    _state.tuner = _state.autotuner = None
    if _state.channel is not None:
        _state.channel.close()
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
                    + [_state.data_group, _state.node_group,
                       _state.cross_group]:
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
