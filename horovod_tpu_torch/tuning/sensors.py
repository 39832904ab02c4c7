"""hvd-tune sensors: the windowed, file-free diagnosis feed (port of
horovod_tpu/tuning/sensors.py).

One :class:`WindowAggregator` lives on rank 0's controller
(tuning/controller.py) and is sampled once a decision window from rank 0's
cycle.  Each sample folds the port's own observability into one
deterministic :class:`~.policy.WindowSnapshot`: the in-memory span buffer
(``trace.export_events``, decomposed by ``trace.analyze.window_legs``), the
fleet skew tracker (``trace.watch.tracker``), the live speculative engines'
acceptance rate, the device allocator's headroom
(``memory.ledger.device_memory_stats``; without a card, the advertised
capacity ``memory.oom.advertised_capacity`` against the ledger's total) and
the registry's ``serving.*`` counters and gauges.

Leg attribution is windowed by differencing: the span buffer is a bounded
deque, so each sample decomposes the whole buffer and subtracts the previous
sample's totals; when any leg's total went DOWN (old spans rolled off the
deque faster than new ones arrived) the absolute totals are used for that
window -- monotone-safe, never negative.  The prefix counters difference
the same way.
"""

from __future__ import annotations

from typing import Dict, Optional

from .policy import WindowSnapshot


class WindowAggregator:
    def __init__(self, st, straggler_skew_s: float = 0.001):
        self._st = st
        self._straggler_skew_s = float(straggler_skew_s)
        self._prev_legs: Optional[Dict[str, float]] = None
        self._prev_prefix: Optional[Dict[str, float]] = None
        self._index = 0

    def _window_legs(self) -> Dict[str, float]:
        from .. import trace as _trace
        from ..trace import analyze as _analyze

        totals = _analyze.window_legs(_trace.export_events())
        prev = self._prev_legs
        self._prev_legs = dict(totals)
        if prev is None or any(totals.get(k, 0.0) < prev.get(k, 0.0)
                               for k in totals):
            return totals
        return {k: totals[k] - prev.get(k, 0.0) for k in totals}

    def _straggler(self) -> int:
        from ..trace import watch as _watch

        skews = _watch.tracker.skew_by_rank()
        if not skews:
            return -1
        worst = max(skews.values())
        if worst < self._straggler_skew_s:
            return -1
        return min(r for r, s in skews.items() if s == worst)

    def _spec_acceptance(self) -> float:
        from . import actuation as _actuation

        for engine in _actuation.spec_engines():
            try:
                rate = engine.spec_acceptance_rate  # property on the
                if callable(rate):                  # serving engine
                    rate = rate()
            except Exception:  # noqa: BLE001 — a draining engine must
                continue       # not break the sensor pass
            if rate is not None:
                return float(rate)
        return -1.0

    def _headroom(self):
        """(fraction_free, bytes_free) from the backend's memory_stats
        when present, else the advertised capacity against the ledger's
        accounted total; (-1.0, -1) when neither is known."""
        from ..memory import ledger as _ledger
        from ..memory import oom as _oom

        stats = _ledger.device_memory_stats()
        if stats:
            limit = stats.get("bytes_limit") or 0
            used = stats.get("bytes_in_use") or 0
            if limit > 0:
                free = max(0, int(limit) - int(used))
                return free / float(limit), free
        capacity = _oom.advertised_capacity()
        if capacity:
            used = _ledger.ledger.total()
            free = max(0, int(capacity) - int(used))
            return free / float(capacity), free
        return -1.0, -1

    def _prefix(self):
        """(hit_rate, kv_free_frac) for the prefix-reserve rule, from
        the live metrics registry: windowed differencing of the
        serving.prefix_hits (+ draft) and serving.prefills counters
        (monotone-safe like the legs), plus the current
        kv_free_pages/kv_total_pages gauges; (-1.0, -1.0) when no
        serving engine publishes them."""
        from .. import telemetry as _telemetry

        snap = _telemetry.registry().snapshot()

        def _val(name: str):
            m = snap.get(name)
            return None if m is None else float(m.get("value", 0))

        prefills = _val("serving.prefills")
        if prefills is None:
            self._prev_prefix = None
            return -1.0, -1.0
        hits = ((_val("serving.prefix_hits") or 0.0)
                + (_val("serving.prefix_hits_draft") or 0.0))
        totals = {"hits": hits, "prefills": prefills}
        prev = self._prev_prefix
        self._prev_prefix = dict(totals)
        if prev is not None and all(totals[k] >= prev.get(k, 0.0)
                                    for k in totals):
            hits = totals["hits"] - prev.get("hits", 0.0)
            prefills = totals["prefills"] - prev.get("prefills", 0.0)
        rate = hits / prefills if prefills > 0 else -1.0
        total_pages = _val("serving.kv_total_pages") or 0.0
        free_pages = _val("serving.kv_free_pages")
        kv_free = (free_pages / total_pages
                   if free_pages is not None and total_pages > 0
                   else -1.0)
        return rate, kv_free

    def sample(self) -> WindowSnapshot:
        from . import actuation as _actuation

        frac, free = self._headroom()
        hit_rate, kv_free = self._prefix()
        snap = WindowSnapshot(
            index=self._index,
            legs=self._window_legs(),
            knobs=_actuation.current_knobs(self._st),
            straggler_rank=self._straggler(),
            spec_acceptance=self._spec_acceptance(),
            headroom_frac=frac,
            headroom_bytes=free,
            prefix_hit_rate=hit_rate,
            kv_free_frac=kv_free,
        )
        self._index += 1
        return snap
