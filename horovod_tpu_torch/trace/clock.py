"""Clock alignment for the fleet trace (hvd-trace piece 2; port of
horovod_tpu/trace/clock.py:1-130, the estimator untouched).

Every rank times its spans on its own ``time.monotonic()``; two
processes' monotonic clocks share no epoch, so merging timelines needs
the per-peer offset.  The estimator is the classic NTP exchange.  The
reference probes with ``FRAME_PING``/``FRAME_PONG`` frames; the port's
probes ride the lockstep control exchange (ops/collective.py
``Runtime``):

* rank 0 puts its send stamp ``t0`` into a cycle's broadcast;
* each worker stamps the broadcast's arrival ``t1`` and, in its next
  batch, answers with ``t0``, ``t1`` and its own send stamp ``t1s``;
* rank 0 stamps the batch's arrival ``t2`` and feeds
  ``(t0, t1, t2 - (t1s - t1))`` -- the worker's hold time between
  receipt and its next send taken out, so::

      rtt    = t2 - t0 - (t1s - t1)
      offset = t1 - (t0 + t2 - (t1s - t1)) / 2   # NTP's four-stamp form

The symmetric-path assumption errs by at most ``rtt / 2``, so the
estimator keeps a bounded window of samples and reports the offset of
the **minimum-RTT** sample: a rank that reached the exchange late
inflates that probe's RTT and is filtered out rather than averaged in.

Per-peer offsets are exported as ``trace.clock_offset_seconds.rank<N>``
gauges and consumed by the fleet-trace merge (trace/merge.py).
"""

from __future__ import annotations

import collections
from typing import Dict, Optional

from .. import telemetry as _telemetry
from ..analysis import lockorder as _lockorder
from ..analysis import races as _races

# Samples retained per peer.  Small: the minimum over ~32 probes is
# already within a few microseconds on a healthy fabric, and a bounded
# window lets a real clock drift (or a migrated peer) age out.
WINDOW = 64


class OffsetEstimator:
    """Min-RTT-filtered offset estimate for ONE peer clock."""

    def __init__(self, window: int = WINDOW) -> None:
        self._samples: collections.deque = collections.deque(
            maxlen=window)
        self.count = 0  # samples ever accepted (re-convergence probe)

    def add(self, t0: float, t1: float, t2: float) -> Optional[float]:
        """Fold one ping/pong exchange in; returns the new best offset
        (None when the sample is unusable — a reordered/replayed pong
        whose stamps are not causally ordered)."""
        rtt = t2 - t0
        if rtt < 0:
            return None
        self._samples.append((rtt, t1 - (t0 + t2) / 2.0))
        self.count += 1
        return self.offset()

    def offset(self) -> Optional[float]:
        """Peer clock minus local clock, from the min-RTT sample in the
        window; None before the first sample."""
        if not self._samples:
            return None
        return min(self._samples)[1]

    def error_bound(self) -> Optional[float]:
        """Worst-case estimate error: half the best RTT seen."""
        if not self._samples:
            return None
        return min(self._samples)[0] / 2.0

    def reset(self) -> None:
        self._samples.clear()


@_races.race_checked
class ClockSync:
    """Controller-side per-peer estimator set.

    ``on_pong`` runs on the per-worker receive threads while
    ``offsets``/``reset`` run on drain/user threads — the dict is
    guarded; the estimators themselves are only ever touched under it.
    The lock is a leaf on the hvd-analyze lock-order graph."""

    def __init__(self) -> None:
        self._lock = _lockorder.make_lock("trace.ClockSync._lock")
        self._peers: Dict[int, OffsetEstimator] = {}  # guarded_by: _lock

    def on_pong(self, rank: int, t0: float, t1: float,
                t2: float) -> None:
        with self._lock:
            est = self._peers.get(rank)
            if est is None:
                est = self._peers[rank] = OffsetEstimator()
            off = est.add(t0, t1, t2)
        if off is not None:
            _telemetry.gauge(
                f"trace.clock_offset_seconds.rank{rank}",
                "estimated peer-clock offset vs rank 0 (min-RTT "
                "filtered)").set(round(off, 9))

    def reset(self, rank: int) -> None:
        """Session resume: the peer's path changed — re-measure."""
        with self._lock:
            est = self._peers.get(rank)
            if est is not None:
                est.reset()

    def offsets(self) -> Dict[int, float]:
        """rank -> offset seconds for every peer with an estimate."""
        with self._lock:
            return {r: est.offset() for r, est in self._peers.items()
                    if est.offset() is not None}

    def error_bounds(self) -> Dict[int, float]:
        with self._lock:
            return {r: est.error_bound()
                    for r, est in self._peers.items()
                    if est.error_bound() is not None}

    def sample_counts(self) -> Dict[int, int]:
        with self._lock:
            return {r: est.count for r, est in self._peers.items()}
