"""Live straggler detection (hvd-trace piece 3, the online half; port
of horovod_tpu/trace/watch.py:1-169).

Rank 0 sees every rank's negotiation traffic per cycle (a worker's
batch carries its trace context and the stamp of its first post): the
spread of those arrival stamps IS the fleet's skew for that cycle, on
one clock.  :class:`SkewTracker` accumulates it; :class:`StragglerWatch`
is the training callback that warns -- live, while the job runs --
when ONE rank's skew exceeds a threshold for N consecutive steps,
naming the rank (the offline analyzer, trace/analyze.py, then explains
*why* from the merged trace).
"""

from __future__ import annotations

import collections
import sys
from typing import Dict, List, Optional

from .. import telemetry as _telemetry
from ..analysis import lockorder as _lockorder
from ..analysis import races as _races
from ..telemetry import flight as _flight

_M_WARNINGS = _telemetry.counter(
    "trace.straggler_warnings",
    "StragglerWatch firings (one rank's skew over threshold for N "
    "consecutive steps)")

# Cycles of arrival data retained for skew queries.
HISTORY = 256


@_races.race_checked
class SkewTracker:
    """Per-cycle request-arrival skew, fed by
    ``trace.note_batch_arrival``: workers' batches stamp their first
    post (mapped to rank 0's clock), and rank 0 stamps its own first
    local submit of the cycle (ops/collective.py ``Runtime``), so even
    the minimal two-rank fleet produces two entries per cycle.
    Skew for a rank = its arrival minus the cycle's first arrival."""

    def __init__(self, history: int = HISTORY) -> None:
        self._lock = _lockorder.make_lock("trace.SkewTracker._lock")
        # (step, cycle) -> {rank: arrival monotonic}, insertion-ordered
        # and bounded.  guarded_by: _lock
        self._cycles: "collections.OrderedDict" = collections.OrderedDict()
        self._history = history

    def note(self, rank: int, step: int, cycle: int, t: float) -> bool:
        """Record one arrival stamp; returns False when this
        (rank, step, cycle) already has one (the dedup the per-tensor
        rank-0 feed relies on)."""
        with self._lock:
            key = (int(step), int(cycle))
            entry = self._cycles.get(key)
            if entry is None:
                entry = self._cycles[key] = {}
                while len(self._cycles) > self._history:
                    self._cycles.popitem(last=False)
            if int(rank) in entry:
                return False
            entry[int(rank)] = float(t)
            return True

    def skew_by_rank(self, last_n: int = 32) -> Dict[int, float]:
        """rank -> median skew seconds over the last ``last_n`` cycles
        (arrival minus the cycle's earliest arrival; cycles with one
        rank contribute nothing)."""
        with self._lock:
            cycles = list(self._cycles.values())[-last_n:]
        per_rank: Dict[int, List[float]] = {}
        for entry in cycles:
            if len(entry) < 2:
                continue
            first = min(entry.values())
            for rank, t in entry.items():
                per_rank.setdefault(rank, []).append(t - first)
        out = {}
        for rank, skews in per_rank.items():
            skews.sort()
            out[rank] = skews[len(skews) // 2]
        return out

    def clear(self) -> None:
        with self._lock:
            self._cycles.clear()


# Process-global tracker the controller transport feeds.
tracker = SkewTracker()


class StragglerWatch:
    """Training callback: warn live when one rank's negotiation skew
    exceeds ``threshold`` seconds for ``patience`` consecutive steps.

    Drop it into the callback list of any training loop (it implements
    the same duck-typed ``on_batch_end``/``on_epoch_end`` surface as
    horovod_tpu_torch.callbacks.Callback); effective on the rank-0 controller
    — workers see no arrival stream and no-op.  Each firing prints the
    rank, its median skew and the threshold, bumps
    ``trace.straggler_warnings`` and flight-records the event, so a
    slow host is named within ``patience`` steps instead of discovered
    in a post-mortem.
    """

    def __init__(self, threshold: float = 0.05, patience: int = 5,
                 tracker_: Optional[SkewTracker] = None) -> None:
        if threshold <= 0 or patience < 1:
            raise ValueError(
                f"StragglerWatch needs threshold > 0 and patience >= 1 "
                f"(got {threshold}, {patience})")
        self.threshold = float(threshold)
        self.patience = int(patience)
        self._tracker = tracker_ if tracker_ is not None else tracker
        self._streaks: Dict[int, int] = {}
        self.warnings: List[dict] = []

    def set_trainer(self, trainer) -> None:  # Callback surface
        pass

    # -- the check, callable from any loop cadence -------------------------
    def check(self, skews: Optional[Dict[int, float]] = None
              ) -> Optional[List[dict]]:
        """One step's evaluation; returns the list of warning dicts
        when any rank fired this step — EVERY rank past its patience is
        named (two simultaneously slow hosts produce two warnings, not
        one), else None.  Tests drive this directly with synthetic
        skews."""
        if skews is None:
            skews = self._tracker.skew_by_rank()
        fired: List[dict] = []
        for rank in sorted(skews):
            skew = skews[rank]
            if skew > self.threshold:
                self._streaks[rank] = self._streaks.get(rank, 0) + 1
            else:
                self._streaks.pop(rank, None)
            if self._streaks.get(rank, 0) >= self.patience:
                fired.append({"rank": rank, "skew": skew,
                              "threshold": self.threshold,
                              "steps": self._streaks[rank]})
                self._streaks[rank] = 0
        for rank in list(self._streaks):
            if rank not in skews:
                del self._streaks[rank]
        for w in fired:
            self.warnings.append(w)
            _M_WARNINGS.inc()
            _flight.record("straggler", w["rank"],
                           round(w["skew"], 6))
            print(f"WARNING: hvd-trace StragglerWatch: rank "
                  f"{w['rank']} has lagged the fleet by "
                  f"{w['skew'] * 1e3:.1f} ms (threshold "
                  f"{self.threshold * 1e3:.1f} ms) for "
                  f"{self.patience} consecutive steps — run "
                  f"python -m horovod_tpu_torch.trace on a fleet trace to "
                  f"attribute the stall (docs/tracing.md)",
                  file=sys.stderr)
        return fired or None

    # -- Callback surface --------------------------------------------------
    def on_batch_end(self, batch: int, logs=None) -> None:
        self.check()

    def on_epoch_end(self, epoch: int, logs=None) -> None:
        self.check()
