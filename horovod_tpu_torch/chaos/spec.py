"""Fault-spec grammar + the deterministic seeded schedule (hvd-chaos).

A copy of horovod_tpu/chaos/spec.py, which imports no JAX: the same spec and
seed fire the same fault sequence in both packages.

One env var drives every injection point in the runtime::

    HVD_TPU_FAULTS = "<clause>(;<clause>)*[@<seed>]"
    clause         = <site>(:<key>=<value>)*

Sites are the runtime's REAL failure boundaries (docs/chaos.md):

  transport.drop      frame silently not sent          (lost packet)
  transport.dup       frame sent twice                 (retransmit ghost)
  transport.delay     sleep before the frame goes out  (congestion)
  transport.trunc     partial frame, then connection
                      close                            (reset mid-frame)
  transport.reset     connection closed before the
                      frame                            (peer reset)
  transport.stall     header sent, long pause, then
                      the body                         (slow peer)
  tree.relay_reset    an interior tree node's child
                      link is hard-closed before a
                      downward relay (ops/tree.py)     (interior death)
  coord.tick_delay    sleep before a drain tick        (starved thread)
  coord.reorder       permute a tick's freshly
                      negotiated responses             (jittery fusion)
  ckpt.oserror        transient OSError inside the
                      checkpoint tmp-file write        (flaky disk/ENOSPC)
  input.stall         sleep in the prefetch stager
                      before staging a batch           (slow loader)
  serving.disconnect  report the /generate client as
                      gone mid-generation              (dropped client)

Keys (all optional):

  p=<float>       fire probability per opportunity (default: fire
                  deterministically on the first ``count`` opportunities
                  after ``after``)
  count=<int>     max firings for this clause (default 1 without ``p``,
                  unlimited with it)
  after=<int>     opportunities skipped before the clause arms
                  (default 0)
  delay=<float>   seconds, for the delaying sites (default 0.05)
  rank=<int>      only fire on this global rank (default: every rank)

Determinism (the replay contract, docs/chaos.md): each site keeps an
opportunity counter; the decision for opportunity ``n`` is a pure
function of ``(seed, site, n)`` — probabilistic clauses draw their
uniform from ``sha256(f"{seed}:{site}:{n}")``, never from wall clock or
a shared PRNG stream.  Opportunities at one site occur in a
deterministic order (frames on a socket are sequential, ticks are
sequential, checkpoint writes are FIFO), so the same spec + seed yields
the same fault sequence bit-for-bit — any chaos failure reproduces from
the spec line the firing logged.
"""

from __future__ import annotations

import hashlib
import struct
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

VALID_SITES = (
    "transport.drop",
    "transport.dup",
    "transport.delay",
    "transport.trunc",
    "transport.reset",
    "transport.stall",
    "tree.relay_reset",
    "coord.tick_delay",
    "coord.reorder",
    "ckpt.oserror",
    "input.stall",
    "serving.disconnect",
    "router.replica_kill",
    "router.kill",
)

_DEFAULT_DELAY = 0.05


@dataclass
class Clause:
    """One parsed fault clause."""

    site: str
    p: Optional[float] = None
    count: Optional[int] = None
    after: int = 0
    delay: float = _DEFAULT_DELAY
    rank: Optional[int] = None
    fired: int = 0  # guarded by the schedule's per-site lock

    def describe(self) -> str:
        parts = [self.site]
        if self.p is not None:
            parts.append(f"p={self.p:g}")
        if self.count is not None:
            parts.append(f"count={self.count}")
        if self.after:
            parts.append(f"after={self.after}")
        if self.delay != _DEFAULT_DELAY:
            parts.append(f"delay={self.delay:g}")
        if self.rank is not None:
            parts.append(f"rank={self.rank}")
        return ":".join(parts)


@dataclass
class Fault:
    """One firing decision handed back to an injection point."""

    site: str
    n: int                # the site opportunity index that fired
    delay: float = _DEFAULT_DELAY
    clause: str = ""      # the clause's spec line, for the firing log


def _uniform(seed: int, site: str, n: int) -> float:
    """The pure decision draw: uniform in [0, 1) from
    ``sha256(seed:site:n)`` — no shared stream, no wall clock, so
    concurrent sites can never perturb each other's sequences."""
    h = hashlib.sha256(f"{seed}:{site}:{n}".encode()).digest()
    (v,) = struct.unpack_from("<Q", h)
    return v / 2.0 ** 64


def parse(spec: str) -> "FaultSchedule":
    """Parse ``HVD_TPU_FAULTS``.  Raises ``ValueError`` naming the
    offending clause and the valid sites/keys — same fail-at-init
    policy as every other SPMD env knob (core/state.init)."""
    text = spec.strip()
    seed = 0
    if "@" in text:
        text, _, seed_s = text.rpartition("@")
        try:
            seed = int(seed_s)
        except ValueError:
            raise ValueError(
                f"HVD_TPU_FAULTS: seed {seed_s!r} is not an integer "
                f"(grammar: '<clause>(;<clause>)*[@<seed>]')") from None
    clauses: List[Clause] = []
    for raw in text.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        parts = raw.split(":")
        site = parts[0].strip()
        if site not in VALID_SITES:
            raise ValueError(
                f"HVD_TPU_FAULTS: unknown fault site {site!r}; valid "
                f"sites: {', '.join(VALID_SITES)}")
        c = Clause(site=site)
        for kv in parts[1:]:
            if "=" not in kv:
                raise ValueError(
                    f"HVD_TPU_FAULTS: malformed key {kv!r} in clause "
                    f"{raw!r} (expected key=value)")
            k, _, v = kv.partition("=")
            k = k.strip()
            try:
                if k == "p":
                    c.p = float(v)
                    if not 0.0 <= c.p <= 1.0:
                        raise ValueError
                elif k == "count":
                    c.count = int(v)
                elif k == "after":
                    c.after = int(v)
                elif k == "delay":
                    c.delay = float(v)
                elif k == "rank":
                    c.rank = int(v)
                else:
                    raise ValueError(
                        f"HVD_TPU_FAULTS: unknown key {k!r} in clause "
                        f"{raw!r}; valid keys: p, count, after, delay, "
                        f"rank")
            except ValueError as e:
                if str(e).startswith("HVD_TPU_FAULTS"):
                    raise
                raise ValueError(
                    f"HVD_TPU_FAULTS: bad value {v!r} for key {k!r} in "
                    f"clause {raw!r}") from None
        if c.p is None and c.count is None:
            c.count = 1  # a bare clause fires exactly once
        clauses.append(c)
    return FaultSchedule(clauses, seed, spec.strip())


class FaultSchedule:
    """The armed fault schedule: per-site opportunity counters + the
    pure decision function.  ``fire(site)`` is called by every
    injection point; it returns a :class:`Fault` when this opportunity
    fires, else None."""

    def __init__(self, clauses: List[Clause], seed: int,
                 text: str = "") -> None:
        self.seed = seed
        self.text = text
        self._by_site: Dict[str, List[Clause]] = {}
        for c in clauses:
            self._by_site.setdefault(c.site, []).append(c)
        # One lock + counter per site: opportunities at one site are
        # sequential (socket frames, drain ticks, FIFO writes), and a
        # per-site lock keeps unrelated sites from contending.
        self._counts: Dict[str, int] = {s: 0 for s in self._by_site}
        self._locks: Dict[str, threading.Lock] = {
            s: threading.Lock() for s in self._by_site}

    def sites(self) -> List[str]:
        return sorted(self._by_site)

    def describe(self) -> str:
        cs = ";".join(c.describe() for cl in self._by_site.values()
                      for c in cl)
        return f"{cs}@{self.seed}"

    def fire(self, site: str, rank: Optional[int] = None
             ) -> Optional[Fault]:
        """Account one opportunity at ``site``; return the firing
        decision.  Pure in ``(seed, site, opportunity index)`` — see
        the module docstring's determinism contract."""
        clauses = self._by_site.get(site)
        if not clauses:
            return None
        with self._locks[site]:
            n = self._counts[site]
            self._counts[site] = n + 1
            for c in clauses:
                if c.rank is not None and rank is not None \
                        and c.rank != rank:
                    continue
                if n < c.after:
                    continue
                if c.count is not None and c.fired >= c.count:
                    continue
                if c.p is None:
                    fired = True
                else:
                    fired = _uniform(self.seed, site, n) < c.p
                if fired:
                    c.fired += 1
                    return Fault(site=site, n=n, delay=c.delay,
                                 clause=c.describe())
        return None

    def opportunities(self, site: str) -> int:
        lock = self._locks.get(site)
        if lock is None:
            return 0
        with lock:
            return self._counts[site]
