"""OOM forensics: out-of-memory capture at the dispatch sites (hvd-mem
piece 3; port of horovod_tpu/memory/oom.py:1-211).

A device out-of-memory is a bare ``torch.cuda.OutOfMemoryError`` with no
record of WHAT was holding the card.  This module turns it into a
forensic flight dump:

* the framework's dispatch sites -- the megakernel launch
  (ops/megakernel.py), serving prefill, decode, draft and verify
  (serving/engine.py), the pipeline's stage programs
  (parallel/pipeline.py) -- run inside :func:`guard`, which catches
  ``torch.cuda.OutOfMemoryError`` (and the reference's
  RESOURCE_EXHAUSTED text) and emits a flight-recorder dump whose tail
  names the **failing executable**, the **top ledger categories**, the
  **predicted** bytes, the allocator's figures
  (:func:`.ledger.device_memory_stats`) and a live-tensor sweep -- then
  re-raises the same exception object (forensics must not change
  failure semantics);
* ``HVD_TPU_MEM_CAPACITY=<bytes>`` simulates a small device: a dispatch
  whose predicted footprint would push the ledger past the advertised
  capacity raises a deterministic :class:`ResourceExhaustedError`
  through the SAME path;
* :func:`preflight_warn` is the launch-time half: ``hvd.init()``, the
  train-step builders, the pipeline and serving warm start compare a
  static plan against the advertised capacity and WARN before the first
  step, pointing at ``python -m horovod_tpu_torch.memory --plan``.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Dict, Optional

from .. import telemetry as _telemetry
from ..telemetry import flight as _flight
from . import ledger as _ledger

CAPACITY_ENV = "HVD_TPU_MEM_CAPACITY"

_M_OOMS = _telemetry.counter(
    "memory.oom_events",
    "RESOURCE_EXHAUSTED dispatches captured (real or simulated)")
_M_PREFLIGHT = _telemetry.counter(
    "memory.preflight_warnings",
    "static plans that exceeded the advertised HBM capacity at init/"
    "build time")


class ResourceExhaustedError(RuntimeError):
    """Simulated-capacity OOM (``HVD_TPU_MEM_CAPACITY``).  The message
    leads with RESOURCE_EXHAUSTED so every detector — including
    operators grepping logs — treats it exactly like XLA's own."""


def validate_env() -> None:
    """Fail ``hvd.init()`` on a malformed capacity knob (the standard
    named-knob contract)."""
    v = os.environ.get(CAPACITY_ENV)
    if v:
        try:
            ok = int(v) > 0
        except ValueError:
            ok = False
        if not ok:
            raise ValueError(
                f"{CAPACITY_ENV}={v!r}: expected a positive integer "
                f"byte count (the simulated/advertised per-rank HBM "
                f"capacity)")


def advertised_capacity() -> Optional[int]:
    """Per-DEVICE memory capacity in bytes: the ``HVD_TPU_MEM_CAPACITY``
    override (simulation / operator pin) wins, else the card's total
    (:func:`.ledger.device_memory_stats` ``bytes_limit``), else None (an
    unknown capacity -- the CPU -- disables the pre-flight and
    simulation paths; never guessed)."""
    v = os.environ.get(CAPACITY_ENV)
    if v:
        try:
            return int(v)
        except ValueError:
            return None
    stats = _ledger.device_memory_stats()
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"])
    return None


def is_resource_exhausted(exc: BaseException) -> bool:
    """True for ``torch.cuda.OutOfMemoryError``, for this module's
    simulated variant, and for the reference's RESOURCE_EXHAUSTED text
    contract."""
    if isinstance(exc, ResourceExhaustedError):
        return True
    import torch

    oom = getattr(torch.cuda, "OutOfMemoryError", None)
    if oom is not None and isinstance(exc, oom):
        return True
    text = str(exc)
    return "RESOURCE_EXHAUSTED" in text or "Out of memory" in text


def oom_event(executable: str, exc: BaseException,
              predicted_bytes: Optional[int] = None) -> Optional[str]:
    """Count + flight-record + dump one OOM.  The dump's ``extra``
    carries everything the post-mortem needs: the failing executable,
    the top-3 ledger categories at failure time, predicted vs observed
    bytes, the allocator's figures and the live-tensor sweep.  Returns
    the dump path (None when dumping is off)."""
    _M_OOMS.inc()
    top = _ledger.ledger.top(3)
    _flight.record("oom", executable,
                   f"{type(exc).__name__}", _ledger.ledger.total())
    extra: Dict[str, object] = {
        "executable": executable,
        "error": f"{type(exc).__name__}: {exc}"[:2000],
        "ledger_total_bytes": _ledger.ledger.total(),
        "ledger_watermark_bytes": _ledger.ledger.watermark(),
        "top_categories": [{"category": c, "bytes": b}
                           for c, b in top],
        "predicted_bytes": predicted_bytes,
        "advertised_capacity_bytes": advertised_capacity(),
        "device_memory_stats": _ledger.device_memory_stats(),
        "live_arrays": _ledger.live_array_report(),
    }
    path = _flight.dump("oom", extra=extra)
    print(f"ERROR: hvd-mem: RESOURCE_EXHAUSTED dispatching "
          f"{executable!r}"
          + (f" (predicted {predicted_bytes} bytes)"
             if predicted_bytes else "")
          + f"; top ledger categories: "
          + (", ".join(f"{c}={b}" for c, b in top) or "none")
          + (f"; flight dump: {path}" if path else "")
          + " — see docs/memory.md 'Out of device memory'",
          file=sys.stderr)
    return path


def check_simulated(executable, predicted_bytes: Optional[int] = None
                    ) -> None:
    """The simulated-capacity pre-check, shared by :func:`guard` and
    the megakernel launch path (which avoids the contextmanager frame
    on its hot path): raise a deterministic RESOURCE_EXHAUSTED when
    the ledger total plus the predicted footprint exceeds
    ``HVD_TPU_MEM_CAPACITY``.  Callers pass PER-DEVICE predictions;
    the ledger-total baseline is the process-level accounting (equal
    on the single-device simulation meshes this knob targets, a
    conservative over-estimate on multi-device processes).
    ``executable`` may be a callable so the steady state never builds
    the name string."""
    cap = simulated_capacity()
    if cap is None:
        return
    total = _ledger.ledger.total()
    projected = total + (predicted_bytes or 0)
    if projected <= cap:
        return
    name = executable() if callable(executable) else executable
    exc = ResourceExhaustedError(
        f"RESOURCE_EXHAUSTED: simulated HBM capacity {cap} bytes "
        f"exceeded dispatching {name!r} (ledger {total} + predicted "
        f"{predicted_bytes or 0} = {projected} bytes; {CAPACITY_ENV})")
    oom_event(name, exc, predicted_bytes)
    raise exc


@contextlib.contextmanager
def guard(executable: str, predicted_bytes: Optional[int] = None):
    """Wrap one dispatch: simulated-capacity pre-check, then
    RESOURCE_EXHAUSTED capture.  Anything else passes through
    untouched, and the OOM re-raises after the dump — the guard
    observes failures, it never swallows them."""
    check_simulated(executable, predicted_bytes)
    try:
        yield
    except BaseException as e:  # noqa: BLE001 — re-raised below
        if is_resource_exhausted(e):
            oom_event(executable, e, predicted_bytes)
        raise


def simulated_capacity() -> Optional[int]:
    """The env-pinned capacity only (real backends enforce their own
    limit — double-enforcing it at dispatch would fail healthy
    launches whose transient footprint the allocator handles)."""
    v = os.environ.get(CAPACITY_ENV)
    if not v:
        return None
    try:
        return int(v)
    except ValueError:
        return None


def preflight_warn(plan_bytes: int, where: str,
                   detail: str = "") -> bool:
    """Compare a static prediction against the advertised capacity and
    warn — at init/build time, BEFORE any device allocation — when it
    does not fit.  Returns True when a warning fired (tests gate on
    it).  A warning, not an error: the plan is an upper bound and the
    operator may know better; the message names the dryrun tool."""
    cap = advertised_capacity()
    if cap is None or plan_bytes <= cap:
        return False
    _M_PREFLIGHT.inc()
    _flight.record("mem_preflight", where, plan_bytes, cap)
    print(f"WARNING: hvd-mem pre-flight ({where}): predicted "
          f"{plan_bytes} bytes exceeds the advertised per-rank HBM "
          f"capacity {cap} bytes"
          + (f" ({detail})" if detail else "")
          + "; run python -m horovod_tpu_torch.memory --plan for the "
          f"what-if breakdown (docs/memory.md)", file=sys.stderr)
    return True
