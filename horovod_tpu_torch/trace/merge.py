"""Fleet-trace merge: one clock-aligned Perfetto file for the job (port
of horovod_tpu/trace/merge.py:1-110).

``hvd.dump_fleet_trace(path)`` on rank 0 pulls every rank's span buffer
through the control exchange -- the reference's ``FRAME_TRACE`` pull
becomes a ``PAYLOAD_PULL_TRACE`` flag on rank 0's broadcast, answered
by each worker's background thread with a ``KIND_TRACE`` message in its
next batch (the ``cluster_metrics`` pattern, ops/transport.py) -- shifts
each worker's timestamps by its estimated clock offset (trace/clock.py;
a probe burst refreshes the estimates right before the pull), and writes
ONE ``chrome://tracing`` / Perfetto-loadable JSON object: each rank is a
trace "process" (pid = rank), each span category a named thread row,
and every event keeps its ``(step, cycle)`` args -- the keys the
analyzer (``python -m horovod_tpu_torch.trace``) groups by.
"""

from __future__ import annotations

import json
from typing import Dict, List

# Stable category -> thread-row order (unknown categories append after).
CATEGORIES = ("negotiate", "dispatch", "collective", "host",
              "checkpoint", "serving")


def merge_events(per_rank: Dict[int, List[dict]],
                 offsets: Dict[int, float]) -> List[dict]:
    """Pure merge: assign pids, apply clock offsets, emit metadata rows.

    ``offsets[rank]`` is that rank's clock minus rank 0's
    (trace/clock.py), so correction SUBTRACTS it.  A rank with no
    estimate (single-process, or no pong yet) merges uncorrected —
    better a skewed row than a dropped rank."""
    out: List[dict] = []
    tids: Dict[str, int] = {c: i + 1 for i, c in enumerate(CATEGORIES)}
    for rank in sorted(per_rank):
        shift_us = float(offsets.get(rank, 0.0)) * 1e6
        out.append({"name": "process_name", "ph": "M", "pid": rank,
                    "args": {"name": f"rank {rank}"}})
        out.append({"name": "process_sort_index", "ph": "M",
                    "pid": rank, "args": {"sort_index": rank}})
        named: Dict[int, str] = {}
        for ev in per_rank[rank]:
            cat = str(ev.get("cat", "misc"))
            tid = tids.setdefault(cat, len(tids) + 1)
            if tid not in named:
                named[tid] = cat
                out.append({"name": "thread_name", "ph": "M",
                            "pid": rank, "tid": tid,
                            "args": {"name": cat}})
            merged = dict(ev)
            merged["pid"] = rank
            merged["tid"] = tid
            merged["ts"] = float(ev.get("ts", 0.0)) - shift_us
            out.append(merged)
    out.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0.0),
                            e.get("pid", 0), e.get("name", "")))
    return out


def dump_fleet_trace(path: str, timeout: float = 10.0) -> str:
    """Merge every rank's span buffer into ``path`` (rank 0 only with
    more than one rank, like ``cluster_metrics``); returns the path.

    One rank writes its local buffer.  More: a probe burst refreshes the
    clock offsets, then the pull collects each worker's buffer -- a rank
    that has not answered within ``timeout`` is simply absent (coverage
    is recorded in the metadata; observability must not fail the job)."""
    from ..core import state as _state
    from . import current_ctx, export_events

    _state._check_initialized()
    local = export_events()
    offsets: Dict[int, float] = {}
    bounds: Dict[int, float] = {}
    if _state.size() == 1:
        per_rank = {0: local}
    else:
        if _state.rank() != 0:
            raise RuntimeError(
                "dump_fleet_trace() merges on the rank-0 controller; "
                "workers answer the controller's trace pull "
                "automatically — use horovod_tpu_torch.trace."
                "export_events() for this rank's local buffer.")
        rt = _state._state.runtime
        rt.measure_clock_offsets(timeout=min(2.0, timeout))
        per_rank = rt.collect_traces(local, timeout=timeout)
        offsets = rt.clock.offsets()
        bounds = rt.clock.error_bounds()
    events = merge_events(per_rank, offsets)
    step, cycle, trace_id = current_ctx()
    payload = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "format": "hvd-fleet-trace-v1",
            "trace_id": trace_id,
            "ranks": sorted(per_rank),
            "clock_offsets_seconds": {str(r): v
                                      for r, v in sorted(offsets.items())},
            "clock_error_bounds_seconds": {
                str(r): v for r, v in sorted(bounds.items())},
            "last_step": step,
            "last_cycle": cycle,
        },
    }
    with open(path, "w") as f:
        json.dump(payload, f)
    return path
