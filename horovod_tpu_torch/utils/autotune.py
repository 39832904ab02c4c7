"""Autotuning of the eager-path runtime parameters (a copy of
horovod_tpu/utils/autotune.py, which imports no JAX).

≙ the post-v0.13 Horovod autotuner (``HOROVOD_AUTOTUNE=1``): Horovod
runs Bayesian optimization over ``HOROVOD_FUSION_THRESHOLD`` and
``HOROVOD_CYCLE_TIME`` while training, scoring each sample by observed
throughput.  The v0.13 reference has only the static env vars
(operations.cc:140, :1207-1210).

TPU redesign: on TPU only the *dynamic* (eager) path has tunable host
machinery — the static pjit path is scheduled entirely by XLA — and its
two knobs span a small, well-understood space.  So instead of a
Gaussian-process loop (hard to reproduce, impossible to unit-test
deterministically), this tuner runs **explore-then-commit over a fixed
grid**: each (fusion_threshold, cycle_time) candidate is measured for a
sample window, scored by reduced bytes/second, and after one sweep the
best candidate is committed for the rest of the job.  Deterministic,
auditable (``HOROVOD_AUTOTUNE_LOG`` writes the same CSV contract as
Horovod's), and still captures the real trade-off: bigger buckets
amortize per-collective overhead until latency-to-first-byte dominates;
shorter cycles cut queueing delay until tick overhead dominates.

Env contract (names follow Horovod):
  HOROVOD_AUTOTUNE=1            enable (coordinator-side only)
  HOROVOD_AUTOTUNE_LOG=<path>   CSV of samples: score,threshold,cycle
  HOROVOD_AUTOTUNE_WARMUP_SAMPLES (default 3) discarded lead-in windows
  HOROVOD_AUTOTUNE_SAMPLE_SECONDS (default 2.0) seconds per candidate
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Callable, List, Optional, Tuple

_MB = 1024 * 1024

# The explored grid.  Thresholds bracket the reference default (64 MB,
# operations.cc:140); cycles bracket the reference tick (5 ms,
# operations.cc:1221).
DEFAULT_THRESHOLDS = [1 * _MB, 4 * _MB, 16 * _MB, 64 * _MB, 128 * _MB]
DEFAULT_CYCLES = [0.002, 0.005, 0.010]


class Autotuner:
    """Explore-then-commit tuner for (fusion_threshold, cycle_time).

    ``record_bytes`` is fed from the drain loop with the payload bytes of
    every completed eager collective; ``maybe_step`` closes a sample
    window when its time is up, scores it, and advances the sweep.  The
    winning configuration is applied through ``apply`` and the tuner
    goes dormant.
    """

    def __init__(self, apply: Callable[[int, float], None],
                 thresholds: Optional[List[int]] = None,
                 cycles: Optional[List[float]] = None,
                 warmup_samples: Optional[int] = None,
                 sample_seconds: Optional[float] = None,
                 log_path: Optional[str] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._apply = apply
        self._clock = clock
        self._configs: List[Tuple[int, float]] = list(itertools.product(
            thresholds or DEFAULT_THRESHOLDS, cycles or DEFAULT_CYCLES))
        self._warmup = int(warmup_samples if warmup_samples is not None
                           else os.environ.get(
                               "HOROVOD_AUTOTUNE_WARMUP_SAMPLES", 3))
        self._sample_s = float(sample_seconds if sample_seconds is not None
                               else os.environ.get(
                                   "HOROVOD_AUTOTUNE_SAMPLE_SECONDS", 2.0))
        self._log_path = log_path or os.environ.get("HOROVOD_AUTOTUNE_LOG")
        self._log_file = None
        if self._log_path:
            self._log_file = open(self._log_path, "w")
            self._log_file.write("score_bytes_per_sec,fusion_threshold,"
                                 "cycle_time_s\n")
        self._idx = -self._warmup  # negative = warmup windows, discarded
        self._bytes = 0
        self._window_start = self._clock()
        self._scores: List[Tuple[float, Tuple[int, float]]] = []
        self.committed: Optional[Tuple[int, float]] = None
        self._set_current()

    # -- wiring ------------------------------------------------------------
    def _current(self) -> Optional[Tuple[int, float]]:
        if 0 <= self._idx < len(self._configs):
            return self._configs[self._idx]
        return None

    def _set_current(self) -> None:
        cfg = self._current()
        if cfg is not None:
            self._apply(*cfg)

    def record_bytes(self, n: int) -> None:
        self._bytes += n

    @property
    def done(self) -> bool:
        return self.committed is not None

    def maybe_step(self) -> None:
        """Close the sample window if its time is up; advance the sweep.
        Cheap when called every drain tick (one clock read)."""
        if self.done:
            return
        now = self._clock()
        if now - self._window_start < self._sample_s:
            return
        elapsed = now - self._window_start
        score = self._bytes / elapsed if elapsed > 0 else 0.0
        cfg = self._current()
        if cfg is not None:  # warmup windows are measured but discarded
            self._scores.append((score, cfg))
            if self._log_file:
                self._log_file.write(f"{score:.1f},{cfg[0]},{cfg[1]}\n")
                self._log_file.flush()
        self._idx += 1
        self._bytes = 0
        self._window_start = now
        nxt = self._current()
        if nxt is not None:
            self._apply(*nxt)
        elif self._idx >= len(self._configs):
            # Sweep complete: commit the best-scoring configuration.
            best = max(self._scores, key=lambda s: s[0])
            self.committed = best[1]
            self._apply(*self.committed)
            if self._log_file:
                self._log_file.write(
                    f"# committed,{self.committed[0]},"
                    f"{self.committed[1]}\n")
                self._log_file.flush()

    def close(self) -> None:
        if self._log_file:
            self._log_file.close()
            self._log_file = None
