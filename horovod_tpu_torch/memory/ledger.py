"""Live device-memory ledger: byte accounting for every framework-owned
device allocation (hvd-mem piece 1; port of
horovod_tpu/memory/ledger.py:1-456).

A per-process table ``category -> current bytes`` fed by ``alloc``/
``free``/``set`` calls at the allocation sites themselves:

==========================  =============================================
category                    fed by
==========================  =============================================
``megakernel.fusion``       ops/megakernel.py ``launch`` (pack + unpack
                            payload bytes live for the dispatch)
``megakernel.residuals``    ops/megakernel.py error-feedback store
``fused.launch``            ops/fused.py chunked closers
``serving.kv_pages``        serving/kv_cache.py page arrays
``serving.prefix_pages``    serving/kv_cache.py prefix reserve
``serving.params``          serving/engine.py the engine's weights
``input.prefetch``          parallel/input.py staged device batches
``pipeline.activations``    parallel/pipeline.py stage-boundary carries
``checkpoint.snapshots``    utils/checkpoint.py host snapshots queued on
                            the background writer
==========================  =============================================

Surfaces: telemetry gauges (``memory.bytes.<category>``,
``memory.ledger_bytes``, the watermarks and the ``memory.device_*``
family), set by a snapshot-time collector so they ride the
``cluster_metrics`` pull; a flight-recorder tail provider, so every
dump carries the ledger; and :class:`MemoryWatch`, the leak watch.

Accounting is exact bookkeeping of what the framework *asked for*
(tensor ``nbytes``), not an allocator shadow.  The backend's truth comes
from :func:`device_memory_stats` -- the reference's
``device.memory_stats()`` keys mapped from ``torch.cuda.memory_stats``
and ``torch.cuda.mem_get_info`` -- and the dump-time
:func:`live_array_report`, a sweep of the live tensors (the reference's
``jax.live_arrays()``) that counts each storage once.  On the CPU both
answer as the reference does there: no stats (None), and the CPU
tensors' bytes.
"""

from __future__ import annotations

import collections
import gc
import sys
from typing import Dict, List, Optional, Tuple

from .. import telemetry as _telemetry
from ..analysis import lockorder as _lockorder
from ..analysis import races as _races
from ..telemetry import flight as _flight

_M_LEAKS = _telemetry.counter(
    "memory.leak_warnings",
    "MemoryWatch firings (one category grew monotonically for N "
    "consecutive steps)")

# The categories the subsystem documents (docs/memory.md); the ledger
# accepts any name — a new allocation site does not need a registry
# change — but the planner predicts exactly these.
CATEGORIES = (
    "megakernel.fusion",
    "megakernel.residuals",
    "fused.launch",
    "serving.kv_pages",
    "serving.prefix_pages",
    "serving.draft_kv",
    "serving.draft_params",
    "serving.params",
    "input.prefetch",
    "pipeline.activations",
    "checkpoint.snapshots",
)


@_races.race_checked
class MemoryLedger:
    """Byte ledger with per-category current/peak and per-step total
    watermarks.  The lock is a leaf on the hvd-analyze lock-order graph
    (allocation sites may call in while holding runtime locks; nothing
    is ever acquired under it)."""

    def __init__(self) -> None:
        self._lock = _lockorder.make_lock("memory.MemoryLedger._lock")
        self._bytes: Dict[str, int] = {}        # guarded_by: _lock
        self._keyed: Dict[Tuple[str, object], int] = {}
        # guarded_by: _lock
        self._peak: Dict[str, int] = {}         # guarded_by: _lock
        self._total_peak = 0                    # guarded_by: _lock
        self._step_peak = 0                     # guarded_by: _lock
        self._last_step_peak = 0                # guarded_by: _lock
        self._steps = 0                         # guarded_by: _lock
        # Keyed frees queued by finalizers (free_deferred), applied by the
        # next call that takes the lock; a deque append takes no lock.
        self._deferred: collections.deque = collections.deque()

    # -- bookkeeping (all O(#categories), category count is ~6) ------------
    def _note_locked(self) -> None:
        total = sum(self._bytes.values())
        if total > self._total_peak:
            self._total_peak = total
        if total > self._step_peak:
            self._step_peak = total

    def alloc(self, category: str, nbytes: int, key=None) -> None:
        """Account ``nbytes`` against ``category``.  With ``key`` the
        entry is idempotent per (category, key): a re-alloc REPLACES the
        previous size (stores whose objects resize in place) and the
        matching ``free(key=...)`` releases exactly what is held."""
        n = int(nbytes)
        if n < 0:
            return
        with self._lock:
            self._drain_locked()
            if key is not None:
                prev = self._keyed.pop((category, key), 0)
                self._keyed[(category, key)] = n
                self._bytes[category] = max(
                    0, self._bytes.get(category, 0) - prev) + n
            else:
                self._bytes[category] = self._bytes.get(category, 0) + n
            if self._bytes[category] > self._peak.get(category, 0):
                self._peak[category] = self._bytes[category]
            self._note_locked()

    def free(self, category: str, nbytes: Optional[int] = None,
             key=None) -> None:
        """Release bytes.  Clamped at zero — a free racing an enablement
        toggle (or a double free on a shutdown path) must never drive a
        category negative and poison every later reading."""
        with self._lock:
            self._drain_locked()
            if key is not None:
                n = self._keyed.pop((category, key), 0)
            else:
                n = int(nbytes or 0)
            self._bytes[category] = max(
                0, self._bytes.get(category, 0) - n)

    def set(self, category: str, nbytes: int) -> None:
        """Absolute update — stores that already know their total
        (the residual table) set it instead of tracking deltas."""
        with self._lock:
            self._drain_locked()
            self._bytes[category] = max(0, int(nbytes))
            if self._bytes[category] > self._peak.get(category, 0):
                self._peak[category] = self._bytes[category]
            self._note_locked()

    def free_deferred(self, category: str, nbytes: Optional[int] = None,
                      key=None) -> None:
        """``free`` for a finalizer (``weakref.finalize``, ``__del__``):
        the garbage collector may run one inside any code, this ledger's
        own locked section included, where taking the (non-reentrant)
        lock would deadlock the thread; so it only queues the free, and
        the next call applies it.  (A port addition: the reference's
        finalizers call ``free``.)"""
        self._deferred.append((category, nbytes, key))

    def _drain_locked(self) -> None:
        while self._deferred:
            category, nbytes, key = self._deferred.popleft()
            n = (self._keyed.pop((category, key), 0) if key is not None
                 else int(nbytes or 0))
            self._bytes[category] = max(0, self._bytes.get(category, 0) - n)

    # -- readers -----------------------------------------------------------
    def bytes_by_category(self) -> Dict[str, int]:
        with self._lock:
            self._drain_locked()
            return dict(self._bytes)

    def total(self) -> int:
        with self._lock:
            self._drain_locked()
            return sum(self._bytes.values())

    def peak_by_category(self) -> Dict[str, int]:
        with self._lock:
            self._drain_locked()
            return dict(self._peak)

    def watermark(self) -> int:
        """All-time peak of the total (the figure the planner's
        framework-owned prediction is gated against)."""
        with self._lock:
            self._drain_locked()
            return self._total_peak

    def step_watermark(self) -> int:
        """Peak total over the most recently completed step window."""
        with self._lock:
            self._drain_locked()
            return self._last_step_peak

    def steps(self) -> int:
        with self._lock:
            self._drain_locked()
            return self._steps

    def top(self, n: int = 3) -> List[Tuple[str, int]]:
        """The ``n`` largest categories by current bytes — the OOM
        dump's "who was holding what" tail (memory/oom.py)."""
        with self._lock:
            self._drain_locked()
            items = sorted(self._bytes.items(),
                           key=lambda kv: (-kv[1], kv[0]))
        return [(c, b) for c, b in items[:n] if b > 0]

    def note_step(self) -> int:
        """Close one step window: record its peak total as the per-step
        high-watermark and start the next window at the CURRENT total
        (long-lived stores carry over; transients reset).  Called once
        per training step (parallel/training.py, parallel/pipeline.py);
        returns the closed window's watermark."""
        with self._lock:
            self._drain_locked()
            self._steps += 1
            self._last_step_peak = self._step_peak
            self._step_peak = sum(self._bytes.values())
            return self._last_step_peak

    def reset(self) -> None:
        """Forget everything (tests and bench A/B legs)."""
        with self._lock:
            self._deferred.clear()
            self._bytes.clear()
            self._keyed.clear()
            self._peak.clear()
            self._total_peak = 0
            self._step_peak = 0
            self._last_step_peak = 0
            self._steps = 0

    def snapshot(self) -> Dict[str, int]:
        """Flat ``metric name -> value`` view (the flight-dump tail and
        the gauge collector share it)."""
        with self._lock:
            self._drain_locked()
            out = {f"memory.bytes.{c}": b
                   for c, b in sorted(self._bytes.items())}
            out["memory.ledger_bytes"] = sum(self._bytes.values())
            out["memory.high_watermark_bytes"] = self._total_peak
            out["memory.step_watermark_bytes"] = self._last_step_peak
        return out


# Process-global ledger every allocation site feeds.
ledger = MemoryLedger()


def enabled() -> bool:
    """Accounting gate: the allocation sites check this (one flag read)
    so the bench's telemetry-on/off A/B — the ≤5 % ledger-overhead
    contract — measures the accounting too."""
    return _telemetry.enabled()


# -- backend-provided truth -------------------------------------------------

def _default_device():
    """The device the sweeps read when none is given: the initialized
    runtime's, else the current CUDA device when there is one, else the
    CPU."""
    import torch

    try:
        from ..core import state as _state

        if _state.is_initialized():
            return _state.device()
    except Exception:  # noqa: BLE001 — observability must never raise
        pass
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The device allocator's figures under the reference's
    ``device.memory_stats()`` keys: ``bytes_in_use`` is
    ``allocated_bytes.all.current``, ``peak_bytes_in_use``
    ``allocated_bytes.all.peak``, ``bytes_limit`` the total of
    ``torch.cuda.mem_get_info``; ``bytes_reserved`` (the caching
    allocator's segments), ``bytes_free`` (the card's free bytes) and
    ``num_allocs`` ride along.  None on the CPU, as the reference's CPU
    backend answers.  Never raises -- this feeds gauges and dumps."""
    try:
        import torch

        dev = torch.device(device) if device is not None \
            else _default_device()
        if dev.type != "cuda":
            return None
        stats = torch.cuda.memory_stats(dev)
        free, total = torch.cuda.mem_get_info(dev)
        return {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                          0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(total),
            "bytes_reserved": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "bytes_free": int(free),
            "num_allocs": int(stats.get("allocation.all.current", 0)),
        }
    except Exception:  # noqa: BLE001 — observability must never raise
        return None


def live_array_report(top_n: int = 10, device=None) -> Dict[str, object]:
    """Dump-time attribution sweep over the live tensors on ``device``
    (default: the runtime's device; the reference sweeps
    ``jax.live_arrays()``): total live bytes plus the ``top_n``
    (shape, dtype) groups by bytes.  Views and ``.grad``s share storage,
    so each storage counts once, keyed by its data pointer, at its full
    size and under the first tensor seen on it.  ``live_bytes - ledger
    total`` bounds what the framework does NOT own (user params,
    optimizer state, batches), so "framework leak" and "model simply too
    big" are decidable from the dump alone.  Tensors held only by C++
    (autograd's saved tensors) have no Python object and are not seen:
    the sweep is a lower bound of the allocator's ``bytes_in_use``."""
    try:
        import torch

        dev = torch.device(device) if device is not None \
            else _default_device()
        objs = gc.get_objects()
    except Exception:  # noqa: BLE001 — sweep is best-effort
        return {"live_bytes": None, "arrays": None, "top": []}
    total = 0
    count = 0
    seen = set()
    groups: Dict[Tuple[str, str], List[int]] = {}
    for a in objs:
        try:
            # type(), not isinstance: a module proxy's __class__ may warn.
            if not issubclass(type(a), torch.Tensor) or \
                    a.device.type != dev.type:
                continue
            if dev.index is not None and a.device.index not in (
                    None, dev.index):
                continue
            st = a.untyped_storage()
            key = (st.data_ptr(), a.device.index)
            if key in seen:
                continue
            seen.add(key)
            nb = int(st.nbytes())
        except Exception:  # noqa: BLE001 — meta/exotic tensors
            continue
        total += nb
        count += 1
        gkey = (str(tuple(a.shape)), str(a.dtype).replace("torch.", ""))
        g = groups.setdefault(gkey, [0, 0])
        g[0] += nb
        g[1] += 1
    top = sorted(groups.items(), key=lambda kv: -kv[1][0])[:top_n]
    return {
        "live_bytes": total,
        "arrays": count,
        "top": [{"shape": shape, "dtype": dtype, "bytes": nb,
                 "count": cnt}
                for (shape, dtype), (nb, cnt) in top],
    }


# -- telemetry wiring -------------------------------------------------------

def install_collector() -> None:
    """Register the snapshot-time gauge collector (idempotent, keyed
    like the runtime collector): ledger categories/watermarks plus the
    backend's own ``memory_stats`` where available.  Because these are
    plain registry gauges they ride FRAME_METRICS / FRAME_METRICS_TREE
    and ``hvd.cluster_metrics()`` aggregates per-rank HBM for free."""

    def collect(reg) -> None:
        for name, value in ledger.snapshot().items():
            reg.gauge(name).set(value)
        stats = device_memory_stats()
        if stats:
            for key, gauge_name in (
                    ("bytes_in_use", "memory.device_bytes_in_use"),
                    ("peak_bytes_in_use", "memory.device_peak_bytes"),
                    ("bytes_limit", "memory.device_bytes_limit")):
                if key in stats:
                    reg.gauge(gauge_name).set(stats[key])

    _telemetry.registry().register_collector("memory", collect)


def _flight_tail() -> Dict[str, int]:
    return ledger.snapshot()


# The flight tail reads the ledger directly (not the registry) so every
# stall/dead-peer/OOM dump carries CURRENT bytes even though dumps skip
# collectors; the ledger lock is a leaf, safe from under runtime locks.
_telemetry.register_flight_tail("memory", _flight_tail)
install_collector()


# -- the leak watch ---------------------------------------------------------

class MemoryWatch:
    """Training callback (StragglerWatch-style): warn live when one
    ledger category grows MONOTONICALLY for ``patience`` consecutive
    checks by at least ``min_growth`` bytes total, naming the category.

    Drop it into any training loop's callback list (duck-typed
    ``on_batch_end``/``on_epoch_end``) or drive :meth:`check` directly.
    A paged KV store that never releases, a prefetcher whose consumer
    died, a residual table growing under a name churn — each is named
    within ``patience`` steps instead of discovered as an OOM
    post-mortem (memory/oom.py then owns the post-mortem too)."""

    def __init__(self, patience: int = 8, min_growth: int = 1 << 20,
                 ledger_: Optional[MemoryLedger] = None) -> None:
        if patience < 2 or min_growth < 0:
            raise ValueError(
                f"MemoryWatch needs patience >= 2 and min_growth >= 0 "
                f"(got {patience}, {min_growth})")
        self.patience = int(patience)
        self.min_growth = int(min_growth)
        self._ledger = ledger_ if ledger_ is not None else ledger
        self._last: Dict[str, int] = {}
        self._streaks: Dict[str, int] = {}
        self._base: Dict[str, int] = {}
        self.warnings: List[dict] = []

    def set_trainer(self, trainer) -> None:  # Callback surface
        pass

    def check(self, sizes: Optional[Dict[str, int]] = None
              ) -> Optional[List[dict]]:
        """One step's evaluation; returns the warning dicts when any
        category fired (every leaking category is named — two leaks
        produce two warnings), else None.  Tests drive this directly
        with synthetic sizes."""
        if sizes is None:
            sizes = self._ledger.bytes_by_category()
        fired: List[dict] = []
        for cat in sorted(sizes):
            cur = sizes[cat]
            prev = self._last.get(cat)
            if prev is not None and cur > prev:
                if cat not in self._streaks:
                    self._base[cat] = prev
                self._streaks[cat] = self._streaks.get(cat, 0) + 1
            else:
                self._streaks.pop(cat, None)
                self._base.pop(cat, None)
            self._last[cat] = cur
            streak = self._streaks.get(cat, 0)
            growth = cur - self._base.get(cat, cur)
            if streak >= self.patience and growth >= self.min_growth:
                fired.append({"category": cat, "bytes": cur,
                              "growth": growth, "steps": streak})
                self._streaks[cat] = 0
                self._base[cat] = cur
        for cat in list(self._last):
            if cat not in sizes:
                del self._last[cat]
                self._streaks.pop(cat, None)
                self._base.pop(cat, None)
        for w in fired:
            self.warnings.append(w)
            _M_LEAKS.inc()
            _flight.record("memory_leak", w["category"], w["bytes"],
                           w["growth"])
            print(f"WARNING: hvd-mem MemoryWatch: ledger category "
                  f"{w['category']!r} grew monotonically for "
                  f"{self.patience} consecutive steps "
                  f"(+{w['growth']} bytes to {w['bytes']}) — likely "
                  f"leak; run python -m horovod_tpu_torch.memory --plan to "
                  f"compare against the expected footprint "
                  f"(docs/memory.md)", file=sys.stderr)
        return fired or None

    # -- Callback surface --------------------------------------------------
    def on_batch_end(self, batch: int, logs=None) -> None:
        self.check()

    def on_epoch_end(self, epoch: int, logs=None) -> None:
        self.check()


def tree_nbytes(tree) -> int:
    """Total ``nbytes`` over a tree's tensor and array leaves (scalars
    and other leaves count zero) -- the shared sizing helper of the
    prefetch, checkpoint and pipeline accounting sites."""
    from ..utils.tree import tree_leaves

    total = 0
    for leaf in tree_leaves(tree):
        nb = getattr(leaf, "nbytes", None)
        if nb is not None:
            try:
                total += int(nb)
            except (TypeError, ValueError):
                pass
    return total


def device_nbytes(x) -> int:
    """Bytes ONE device holds of ``x``.  A torch tensor lives on one
    device, so this is its ``nbytes`` (the reference reads the first
    addressable shard of a sharded array)."""
    nb = getattr(x, "nbytes", None)
    try:
        return int(nb) if nb is not None else 0
    except (TypeError, ValueError):
        return 0


def resident_nbytes(x) -> int:
    """Bytes of ``x`` resident on THIS process's devices.  A torch tensor
    is one process's (a model-sharded KV store holds its shard), so this
    is its ``nbytes``."""
    return device_nbytes(x)
