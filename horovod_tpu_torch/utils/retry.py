"""Shared exponential-backoff-with-jitter policy: a copy of
horovod_tpu/utils/retry.py (which imports no JAX), so the port depends on
nothing of the JAX package.

The port's background checkpoint writer (utils/checkpoint.py) retries
its transient OSErrors through it, and the control channel's connect and
reconnect loops (ops/transport.py) pace their attempts with it.

Full jitter (the AWS architecture-blog scheme): attempt ``k`` sleeps
``uniform(0, min(cap, base * 2**k))``.  Jitter decorrelates a fleet of
workers retrying against one shared resource after a common fault —
without it every rank retries in lockstep.
"""

from __future__ import annotations

import random
import time
from typing import Iterator, Optional


class BackoffPolicy:
    """Capped exponential backoff with full jitter.

    ``delays()`` yields the per-attempt sleep seconds until
    ``deadline`` (monotonic) would be crossed; the caller owns the
    actual attempt.  ``rng`` is injectable so tests pin the jitter."""

    def __init__(self, base: float = 0.05, cap: float = 2.0,
                 factor: float = 2.0,
                 rng: Optional[random.Random] = None) -> None:
        if base <= 0 or cap < base or factor < 1.0:
            raise ValueError(
                f"bad backoff policy: base={base} cap={cap} "
                f"factor={factor}")
        self.base = base
        self.cap = cap
        self.factor = factor
        self._rng = rng or random.Random()

    def delay(self, attempt: int) -> float:
        """Jittered sleep for 0-indexed ``attempt``: uniform in
        ``[0, min(cap, base * factor**attempt)]``."""
        ceiling = min(self.cap, self.base * self.factor ** attempt)
        return self._rng.uniform(0.0, ceiling)

    def delays(self, deadline: Optional[float] = None) -> Iterator[float]:
        """Yield jittered delays (one per attempt) while monotonic time
        stays ahead of ``deadline`` (None = forever).  The generator
        does NOT sleep — callers sleep so they can interleave logging
        (the connect loop logs each attempt with the remaining
        deadline)."""
        attempt = 0
        while deadline is None or time.monotonic() < deadline:
            yield self.delay(attempt)
            attempt += 1


def retry_call(fn, *, attempts: int, policy: Optional[BackoffPolicy]
               = None, retry_on=(OSError,), on_retry=None):
    """Call ``fn()`` up to ``attempts`` times, sleeping the policy's
    jittered backoff between failures.  ``on_retry(attempt, exc,
    delay)`` observes each retried failure (telemetry/flight hooks).
    The final failure re-raises unchanged — callers keep their
    exception contract (the checkpoint writer's CheckpointError
    wrapping happens at wait(), exactly as before)."""
    policy = policy or BackoffPolicy()
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 — retry loop by design
            last = e
            if attempt == attempts - 1:
                raise
            delay = policy.delay(attempt)
            if on_retry is not None:
                on_retry(attempt, e, delay)
            time.sleep(delay)
    raise last  # pragma: no cover — unreachable (attempts >= 1 raises)
