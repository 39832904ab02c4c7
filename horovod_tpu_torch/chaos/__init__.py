"""hvd-chaos: deterministic fault injection at the runtime's failure
boundaries (port of horovod_tpu/chaos/__init__.py, which imports no JAX).

``HVD_TPU_FAULTS="<spec>@seed"`` arms a seeded
:class:`~.spec.FaultSchedule`; every hardened layer asks :func:`fire` at
its failure boundary and the schedule answers deterministically (same
spec + seed, the identical fault sequence: the replay contract).  The
port hosts the sites that need no TCP channel:

* ``ckpt.oserror``: the checkpoint writer's tmp-file write
  (``utils/checkpoint.py`` ``_write_bytes_once``);
* ``input.stall``: the prefetch stager (``parallel/input.py``);
* ``serving.disconnect``: the ``/generate`` client probe
  (``telemetry/exporter.py`` ``ClientProbe``);
* ``coord.tick_delay``: the background loop before a cycle
  (``ops/collective.py`` ``Runtime._loop``);
* ``coord.reorder``: rank 0's freshly negotiated responses of a cycle
  (``Runtime._negotiate``), never across the cache marker or the
  replays.

The ``transport.*`` and ``tree.relay_reset`` sites belong to the
reference's TCP control channel and its tree overlay, and the
``router.*`` sites to ``routing/``: the port has neither yet (ROADMAP.md
§A.5 item 4 and 6), so the grammar accepts them and nothing fires them.

The no-hang contract (``python -m horovod_tpu_torch.chaos --matrix``):
under every schedule of the matrix the run either fully recovers (its
results bitwise the fault-free run's) or fails within a bounded time
with a diagnostic naming the injected fault.

Cost when unarmed: one module-global ``None`` check per site (the
schedule loads lazily from the environment at first use; :func:`reload`
re-reads it).
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

from .. import telemetry as _telemetry
from ..telemetry import flight as _flight
from .spec import Fault, FaultSchedule, VALID_SITES, parse  # noqa: F401

_M_INJECTED = _telemetry.counter(
    "chaos.injected", "faults fired by the hvd-chaos schedule")

# None = unarmed (the common case); loaded lazily.
_schedule: Optional[FaultSchedule] = None
_loaded = False
_rank: Optional[int] = None


def validate_env() -> None:
    """Fail-at-init validation of ``HVD_TPU_FAULTS`` (``core/state.init``):
    a mistyped site or key aborts with the valid list instead of a silent
    no-op chaos run."""
    spec = os.environ.get("HVD_TPU_FAULTS")
    if spec:
        parse(spec)


def reload() -> Optional[FaultSchedule]:
    """(Re-)load the schedule from the environment."""
    global _schedule, _loaded, _rank
    spec = os.environ.get("HVD_TPU_FAULTS")
    _schedule = parse(spec) if spec else None
    _loaded = True
    _rank = None
    if _schedule is not None and _schedule.sites():
        print(f"[hvd-chaos] armed: {_schedule.describe()}",
              file=sys.stderr)
    return _schedule


def schedule() -> Optional[FaultSchedule]:
    if not _loaded:
        reload()
    return _schedule


def active() -> bool:
    return schedule() is not None


def _rank_of() -> int:
    """Rank for rank-filtered clauses (cached; the flight recorder's
    lazy resolution)."""
    global _rank
    if _rank is None:
        _rank = _flight._rank_of()
    return _rank


def fire(site: str) -> Optional[Fault]:
    """Account one opportunity at ``site``; returns the :class:`Fault`
    when this opportunity fires.  Every firing is logged with its clause
    and opportunity index (the line a replay needs), flight-recorded
    ``("chaos", site, n, clause)`` and counted (``chaos.injected``)."""
    sched = _schedule if _loaded else schedule()
    if sched is None:
        return None
    f = sched.fire(site, rank=_rank_of())
    if f is not None:
        _M_INJECTED.inc()
        _flight.record("chaos", f.site, f.n, f.clause)
        print(f"[hvd-chaos] rank {_rank_of()}: fired {f.site}#{f.n} "
              f"(clause {f.clause!r}, seed {sched.seed})",
              file=sys.stderr)
    return f


def sleep_site(site: str) -> bool:
    """The pure-delay sites (``coord.tick_delay``, ``input.stall``): sleep
    the clause's delay when the opportunity fires.  Returns whether it
    fired."""
    f = fire(site)
    if f is None:
        return False
    time.sleep(f.delay)
    return True


def maybe_reorder(site: str, items: List) -> List:
    """``coord.reorder``: reverse ``items`` when the opportunity fires.
    The caller scopes this to a span where order is free (one cycle's
    freshly negotiated responses, never across the cache's flush
    marker)."""
    if len(items) > 1 and fire(site) is not None:
        return list(reversed(items))
    return items
