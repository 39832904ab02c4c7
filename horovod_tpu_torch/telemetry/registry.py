"""Always-on metrics registry: counters, gauges, bounded histograms (a
copy of horovod_tpu/telemetry/registry.py, which imports no JAX).

Counters and histograms accumulate into striped per-thread cells (each
written by one thread, so increments are exact without a lock on the hot
path); histograms use fixed log2 bucket edges per kind (seconds, bytes,
count); ``HVD_TPU_METRICS=0`` (or ``set_enabled(False)``) makes every
``inc``/``observe``/``set`` one flag check.  Collectors registered with
:meth:`MetricsRegistry.register_collector` run at snapshot time.
:func:`aggregate` merges per-rank snapshots (``telemetry.
cluster_metrics``).

The locks are the lock-order checker's named locks and the registry's
guarded fields carry the race checker (reference :103, :228-244).
"""

from __future__ import annotations

import math
import os
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ..analysis import lockorder as _lockorder
from ..analysis import races as _races



def metrics_enabled() -> bool:
    """Default enablement (the registry is always-on unless opted out)."""
    return os.environ.get("HVD_TPU_METRICS", "1") != "0"


# Fixed log2 bucket-edge families: [2**lo, 2**hi) plus one overflow
# bucket.  Chosen once, shared by every histogram of the kind, so
# cluster aggregation can merge buckets without re-binning.
_KIND_EXPONENTS: Dict[str, Tuple[int, int]] = {
    # 2^-20 s ≈ 1 µs .. 2^5 = 32 s: spans a cache-hit negotiation to a
    # stall threshold.
    "seconds": (-20, 6),
    # 16 B .. 16 GiB: a scalar metric to a full fusion buffer.
    "bytes": (4, 35),
    # 1 .. 4096: fusion-group widths, frame batch sizes.
    "count": (0, 13),
}


def bucket_edges(kind: str) -> List[float]:
    lo, hi = _KIND_EXPONENTS[kind]
    return [float(2.0 ** e) for e in range(lo, hi)]


def _bucket_index(v: float, lo: int, nbuckets: int) -> int:
    """Index of the smallest power-of-two edge >= v (overflow =
    ``nbuckets``).  One C-level frexp, no search: v = m * 2**e with
    0.5 <= m < 1, so the covering edge is 2**e (or 2**(e-1) when v is
    itself a power of two)."""
    if v <= 0.0:
        return 0
    m, e = math.frexp(v)
    idx = (e if m > 0.5 else e - 1) - lo
    if idx < 0:
        return 0
    if idx > nbuckets:
        return nbuckets
    return idx


class _Striped:
    """Per-thread accumulation cells shared by Counter and Histogram.

    ``_cells`` is append-only under ``_cells_lock`` (a leaf: nothing
    else is ever acquired while holding it); each cell is written by
    exactly one thread, so the hot path is lock-free AND exact."""

    __slots__ = ("_tl", "_cells", "_cells_lock")

    def __init__(self) -> None:
        self._tl = threading.local()
        self._cells_lock = _lockorder.make_lock("telemetry._cells_lock")
        self._cells: List[list] = []  # guarded_by: _cells_lock

    def _cell(self, template: list) -> list:
        cell = getattr(self._tl, "cell", None)
        if cell is None:
            cell = list(template)
            with self._cells_lock:
                self._cells.append(cell)
            self._tl.cell = cell
        return cell

    def _cells_snapshot(self) -> List[list]:
        with self._cells_lock:
            return list(self._cells)


class Counter(_Striped):
    """Monotonic counter.  ``inc`` is exact under concurrent writers
    (striped cells) and lock-free after the first touch per thread."""

    __slots__ = ("name", "help", "_enabled_ref")

    def __init__(self, name: str, help: str, enabled_ref: list) -> None:
        super().__init__()
        self.name = name
        self.help = help
        self._enabled_ref = enabled_ref

    def inc(self, n: int = 1) -> None:
        if not self._enabled_ref[0]:
            return
        cell = getattr(self._tl, "cell", None)
        if cell is None:
            cell = self._cell([0])
        cell[0] += n

    @property
    def value(self):
        return sum(c[0] for c in self._cells_snapshot())

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self.value}


class Gauge:
    """Point-in-time value; ``set`` is a single atomic attribute store
    (collectors are the usual writer, at snapshot time)."""

    __slots__ = ("name", "help", "_enabled_ref", "_value")

    def __init__(self, name: str, help: str, enabled_ref: list) -> None:
        self.name = name
        self.help = help
        self._enabled_ref = enabled_ref
        self._value = 0

    def set(self, v) -> None:
        if self._enabled_ref[0]:
            self._value = v

    @property
    def value(self):
        return self._value

    def snapshot(self) -> dict:
        v = self._value
        return {"type": "gauge",
                "value": float(v) if isinstance(v, float) else v}


class Histogram(_Striped):
    """Bounded histogram over fixed log2 edges (see ``_KIND_EXPONENTS``).

    Per-thread cell layout: ``[sum, count, b_0 .. b_n, overflow]`` —
    one frexp + three in-cell adds per observe, exact under concurrent
    writers, no lock on the hot path."""

    __slots__ = ("name", "help", "kind", "_lo", "_n", "edges",
                 "_enabled_ref", "_template")

    def __init__(self, name: str, help: str, kind: str,
                 enabled_ref: list) -> None:
        super().__init__()
        if kind not in _KIND_EXPONENTS:
            raise ValueError(
                f"unknown histogram kind {kind!r}; expected one of "
                f"{sorted(_KIND_EXPONENTS)}")
        self.name = name
        self.help = help
        self.kind = kind
        lo, hi = _KIND_EXPONENTS[kind]
        self._lo = lo
        self._n = hi - lo
        self.edges = bucket_edges(kind)
        self._enabled_ref = enabled_ref
        self._template = [0.0, 0] + [0] * (self._n + 1)

    def observe(self, v) -> None:
        if not self._enabled_ref[0]:
            return
        cell = getattr(self._tl, "cell", None)
        if cell is None:
            cell = self._cell(self._template)
        v = float(v)
        cell[0] += v
        cell[1] += 1
        cell[2 + _bucket_index(v, self._lo, self._n)] += 1

    def snapshot(self) -> dict:
        total = list(self._template)
        for c in self._cells_snapshot():
            for i, v in enumerate(c):
                total[i] += v
        return {
            "type": "histogram",
            "kind": self.kind,
            "sum": total[0],
            "count": total[1],
            "buckets": [[edge, total[2 + i]]
                        for i, edge in enumerate(self.edges)],
            "overflow": total[2 + self._n],
        }


@_races.race_checked
class MetricsRegistry:
    """Name-keyed metric table + snapshot-time collectors.

    ``_lock`` guards only metric creation and the collector table; it
    is a leaf in the lock-order graph and is never held while user code
    (collectors) runs."""

    def __init__(self, enabled: Optional[bool] = None) -> None:
        # Shared mutable flag cell: every metric holds a reference, so
        # set_enabled flips the whole registry with one store and the
        # hot path pays a single list-index check.
        self._enabled_ref = [metrics_enabled() if enabled is None
                             else bool(enabled)]
        self._lock = _lockorder.make_lock("MetricsRegistry._lock")
        self._metrics: Dict[str, object] = {}  # guarded_by: _lock
        self._collectors: Dict[str, Callable] = {}  # guarded_by: _lock

    @property
    def enabled(self) -> bool:
        return self._enabled_ref[0]

    def set_enabled(self, v: bool) -> None:
        self._enabled_ref[0] = bool(v)

    def _get_or_create(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args, self._enabled_ref)
                self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(name, Gauge, help)

    def histogram(self, name: str, kind: str = "seconds",
                  help: str = "") -> Histogram:
        m = self._get_or_create(name, Histogram, help, kind)
        if m.kind != kind:
            raise TypeError(
                f"metric {name!r} already registered as a "
                f"{m.kind!r} histogram, not {kind!r}")
        return m

    def register_collector(self, key: str, fn: Callable) -> None:
        """Register (or replace) a pull-side collector: ``fn(registry)``
        runs at snapshot time and typically sets gauges from existing
        cheap stats structs.  Keyed so a re-init replaces rather than
        stacks the runtime collector."""
        with self._lock:
            self._collectors[key] = fn

    def unregister_collector(self, key: str) -> None:
        with self._lock:
            self._collectors.pop(key, None)

    def snapshot(self, run_collectors: bool = True) -> Dict[str, dict]:
        """Consistent-enough point-in-time view: collectors run first
        (outside any lock), then every metric renders its current value.
        A failing collector is skipped — observability must never take
        the runtime down."""
        if run_collectors and self.enabled:
            with self._lock:
                collectors = list(self._collectors.values())
            for fn in collectors:
                try:
                    fn(self)
                except Exception:  # noqa: BLE001 — never break snapshot
                    pass
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in items}


# ---------------------------------------------------------------------------
# Cluster aggregation (consumed by hvd.cluster_metrics)
# ---------------------------------------------------------------------------

def quantile_from_buckets(buckets: List[List[float]], overflow: int,
                          count: int, q: float) -> Optional[float]:
    """Upper-edge quantile estimate from log2 buckets (the standard
    Prometheus-histogram convention: report the edge of the bucket the
    q-th observation falls in)."""
    if count <= 0:
        return None
    target = q * count
    cum = 0
    for edge, n in buckets:
        cum += n
        if cum >= target:
            return edge
    return float("inf") if overflow else (buckets[-1][0] if buckets
                                          else None)


def aggregate(snapshots: Dict[int, Dict[str, dict]]) -> Dict[str, dict]:
    """Fleet-level view over per-rank snapshots: min/max/mean/sum for
    scalars, merged buckets + p50/p90/p99 for histograms.  A metric
    missing on some ranks aggregates over the ranks that have it
    (``ranks`` records how many)."""
    names: Dict[str, List[Tuple[int, dict]]] = {}
    for rank in sorted(snapshots):
        for name, m in snapshots[rank].items():
            names.setdefault(name, []).append((rank, m))
    out: Dict[str, dict] = {}
    for name, entries in sorted(names.items()):
        kind = entries[0][1].get("type")
        if kind == "histogram":
            merged: Dict[float, int] = {}
            total_sum = 0.0
            total_count = 0
            overflow = 0
            for _rank, m in entries:
                total_sum += m.get("sum", 0.0)
                total_count += m.get("count", 0)
                overflow += m.get("overflow", 0)
                for edge, n in m.get("buckets", []):
                    merged[edge] = merged.get(edge, 0) + n
            buckets = sorted(merged.items())
            agg = {
                "type": "histogram",
                "ranks": len(entries),
                "count": total_count,
                "sum": total_sum,
                "mean": (total_sum / total_count) if total_count else None,
                "overflow": overflow,
            }
            for q, key in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
                agg[key] = quantile_from_buckets(
                    [list(b) for b in buckets], overflow, total_count, q)
            out[name] = agg
        else:
            values = [float(m.get("value", 0)) for _rank, m in entries]
            per_rank = {rank: m.get("value", 0) for rank, m in entries}
            out[name] = {
                "type": kind,
                "ranks": len(values),
                "min": min(values),
                "max": max(values),
                "mean": sum(values) / len(values),
                "sum": sum(values),
                "per_rank": per_rank,
            }
    return out
