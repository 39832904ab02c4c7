"""hvd-route: least-loaded + prefix-affinity dispatch over N replicas (a
copy of horovod_tpu/routing/router.py, which imports no JAX; its
telemetry, checkers and retry policy are the port's).

Pure Python (no jax — like the scheduler, this tier runs on any
front-end box).  The router keeps one :class:`_Replica` record per
serving replica, refreshed from the ``/healthz`` contract the serving
tier already exports (``serving/engine.py health()``): readiness,
``queue_depth``, the ``kv_free_pages`` admission headroom, and the
shared-prefix index as chain-hash hex digests.  Dispatch then scores
every READY replica:

    score = (queue_depth + router_inflight) * queue_weight
            - affinity_pages * affinity_weight
            + headroom_penalty

where ``affinity_pages`` is the longest page-aligned header run of the
prompt already present in that replica's prefix index (the SAME chain
hashes the replica's ``PagedKVCache`` keys — affinity.py), and the
penalty applies when the replica lacks KV headroom for the prompt's
unshared pages.  Lowest score wins; ties break on replica name, so a
given fleet snapshot always routes a prompt the same way
(deterministic — the trace-replay gate of ``bench.py --mode routing``
relies on it).

Failover is drain-aware (docs/routing.md): a replica that answers 503
mid-generation was elastically drained — its partial tokens are a
CONTINUATION (the serving bitwise contract makes prompt+partial
reproduce the uninterrupted rollout), so the router extends the prompt
with them, debits ``max_tokens``, and resubmits elsewhere; the merged
completion is digest-identical to an uninterrupted run (chaos-gated:
``router_replica_death``).  A replica that is UNREACHABLE (connection
refused/reset — :class:`~horovod_tpu_torch.routing.replica.
ReplicaUnreachable`) is marked dead and re-probed on the shared
jittered-backoff policy (utils/retry.py), the same machinery the
control-plane reconnect path rides.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .. import telemetry as _telemetry
from ..analysis import lockorder as _lockorder
from ..analysis import races as _races
from ..telemetry import flight as _flight
from ..utils.retry import BackoffPolicy
from .affinity import prompt_header_hashes, published_page_hashes
from .replica import ReplicaUnreachable

# Replica dispositions.  Only READY replicas are dispatch candidates;
# DRAINING and DEAD differ in how they got there (an explicit
# drain/503 vs a transport failure) and in re-probe backoff (dead
# replicas are probed on the jittered schedule, draining ones on every
# poll — a resumed replica should take traffic again promptly).
READY = "ready"
NOT_READY = "not_ready"
DRAINING = "draining"
DEAD = "dead"

_M_REQS = _telemetry.counter(
    "routing.requests", "requests dispatched through the router")
_M_AFF_HITS = _telemetry.counter(
    "routing.affinity_hits", "requests routed to a replica already "
    "holding at least one page of their prompt header")
_M_AFF_PAGES = _telemetry.counter(
    "routing.affinity_pages", "prompt-header pages routed onto a "
    "replica that already cached them (fleet-wide prefix reuse)")
_M_FAILOVERS = _telemetry.counter(
    "routing.failovers", "dispatch attempts moved to another replica "
    "(503-draining or unreachable)")
_M_CONTINUATIONS = _telemetry.counter(
    "routing.continuations", "drained replicas' partial completions "
    "resubmitted as continuations")
_M_DEATHS = _telemetry.counter(
    "routing.replica_deaths", "replicas marked dead after a "
    "transport-level failure")
_M_NO_REPLICA = _telemetry.counter(
    "routing.no_replica_errors", "requests failed because no replica "
    "was ready within the retry budget")
_M_READY = _telemetry.gauge(
    "routing.ready_replicas", "replicas currently dispatchable")


@dataclass(frozen=True)
class RouterConfig:
    queue_weight: float = 1.0      # score per queued/in-flight request
    affinity_weight: float = 1.0   # score credit per warm header page
    headroom_penalty: float = 1e6  # replica cannot hold the prompt
    max_attempts: int = 4          # dispatch tries across the fleet
    index_cap: int = 4096          # per-replica affinity-index bound
    probe_base: float = 0.05       # dead-replica re-probe backoff
    probe_cap: float = 2.0


class _Replica:
    """One replica's routing state.  Every field is guarded by the
    owning :class:`Router`'s ``_lock`` (the record never leaves it);
    the client object itself is only CALLED outside the lock."""

    def __init__(self, name: str, client) -> None:
        self.name = name
        self.client = client
        self.status = NOT_READY
        self.queue_depth = 0
        self.kv_free_pages = 0
        self.kv_total_pages = 0
        self.inflight = 0            # router-side dispatched, unanswered
        self.prefix: set = set()     # chain-hash hex digests
        self.fingerprint = b""
        self.page_size = 0
        self.pages_per_slot = 0
        self.failures = 0            # consecutive transport failures
        self.next_probe = 0.0        # monotonic; dead-replica backoff
        self.backoff = BackoffPolicy(rng=random.Random(
            hash(name) & 0xFFFF))


@_races.race_checked
class Router:
    """The fleet dispatcher.  Thread-safe: ``dispatch`` runs
    concurrently on the front door's per-request handler threads, and
    ``poll`` on the router server's poll thread — all shared state
    lives behind ``_lock``, and every replica CALL (health, generate,
    drain) happens outside it, so one slow replica never wedges
    routing to the others."""

    def __init__(self, cfg: Optional[RouterConfig] = None,
                 clock=time.monotonic, sleep=time.sleep) -> None:
        self.cfg = cfg or RouterConfig()
        self._clock = clock
        self._sleep = sleep
        self._lock = _lockorder.make_lock("routing.Router._lock")
        self._replicas: Dict[str, _Replica] = {}  # guarded_by: _lock
        # Fleet affinity config, adopted from the first replica whose
        # health exports a fingerprint; a replica advertising a
        # DIFFERENT fingerprint serves another model — it still takes
        # least-loaded traffic but never earns affinity credit.
        self._fingerprint = b""    # guarded_by: _lock
        self._page_size = 0        # guarded_by: _lock
        self._pages_per_slot = 0   # guarded_by: _lock

    # -- fleet membership --------------------------------------------------
    def add_replica(self, name: str, client) -> None:
        """Register a replica (NOT_READY until its first health poll;
        re-registration replaces the record — the relaunch path)."""
        with self._lock:
            self._replicas[name] = _Replica(name, client)

    def remove_replica(self, name: str) -> None:
        with self._lock:
            self._replicas.pop(name, None)

    def replica_names(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    def replica_status(self) -> Dict[str, dict]:
        """Snapshot for /healthz and tests: per-replica disposition,
        load and affinity-index size."""
        with self._lock:
            return {r.name: {
                "status": r.status,
                "queue_depth": r.queue_depth,
                "inflight": r.inflight,
                "kv_free_pages": r.kv_free_pages,
                "prefix_index_pages": len(r.prefix),
            } for r in self._replicas.values()}

    def ready_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._replicas.values()
                       if r.status == READY)

    # -- health polling ----------------------------------------------------
    def poll(self, name: Optional[str] = None) -> None:
        """Refresh routing state from ``/healthz``.  Dead replicas are
        only re-probed once their jittered backoff expires (the
        thundering-herd discipline of utils/retry.py); everything else
        is probed every call."""
        now = self._clock()
        with self._lock:
            due = [r for r in self._replicas.values()
                   if (name is None or r.name == name)
                   and (r.status != DEAD or now >= r.next_probe)]
            targets = [(r.name, r.client) for r in due]
        for rep_name, client in targets:
            try:
                status, payload = client.health()
            except ReplicaUnreachable:
                self._mark_dead(rep_name)
                continue
            except Exception as e:  # noqa: BLE001 — a broken client
                # must degrade to "dead", never kill the poll thread
                _flight.record("route_poll_error", rep_name,
                               f"{type(e).__name__}: {e}")
                self._mark_dead(rep_name)
                continue
            self._apply_health(rep_name, status, payload)
        with self._lock:
            _M_READY.set(sum(1 for r in self._replicas.values()
                             if r.status == READY))

    def _apply_health(self, name: str, status: int,
                      payload: dict) -> None:
        # The exporter nests the engine's contribution under the
        # "serving" health key; simulated/faked replicas may hand the
        # detail dict back directly.
        det = payload.get("serving")
        if not isinstance(det, dict):
            det = payload
        fp = str(det.get("fingerprint") or "").encode()
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                return
            rep.failures = 0
            rep.status = READY if (status == 200
                                   and det.get("ready")) else NOT_READY
            rep.queue_depth = int(det.get("queue_depth", 0) or 0)
            rep.kv_free_pages = int(det.get("kv_free_pages", 0) or 0)
            rep.kv_total_pages = int(det.get("kv_total_pages", 0) or 0)
            rep.page_size = int(det.get("page_size", 0) or 0)
            rep.pages_per_slot = int(det.get("pages_per_slot", 0) or 0)
            rep.fingerprint = fp
            index = det.get("prefix_index")
            if isinstance(index, (list, tuple)):
                rep.prefix = set(str(h) for h in index)
            if fp and not self._fingerprint:
                self._fingerprint = fp
                self._page_size = rep.page_size
                self._pages_per_slot = rep.pages_per_slot

    def _mark_dead(self, name: str) -> None:
        now = self._clock()
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None:
                return
            if rep.status != DEAD:
                _M_DEATHS.inc()
                _flight.record("route_replica_dead", name,
                               f"failures={rep.failures + 1}")
            rep.status = DEAD
            rep.failures += 1
            rep.next_probe = now + rep.backoff.delay(rep.failures - 1)

    def _mark_draining(self, name: str) -> None:
        with self._lock:
            rep = self._replicas.get(name)
            if rep is not None and rep.status != DEAD:
                rep.status = DRAINING

    # -- selection ---------------------------------------------------------
    def _header_hashes(self, tokens: List[int]) -> List[str]:
        with self._lock:
            fp, ps, pps = (self._fingerprint, self._page_size,
                           self._pages_per_slot)
        if not fp or ps <= 0 or pps <= 0:
            return []
        return prompt_header_hashes(fp, tokens, ps, pps)

    def select(self, tokens: List[int]) -> Optional[Tuple[str, int]]:
        """(replica_name, affinity_pages) for the best READY replica,
        or None when the fleet has none.  Pure in the fleet snapshot:
        no state moves here (``dispatch`` owns the inflight
        accounting), so benches and tests can call it freely."""
        header = self._header_hashes(tokens)
        cfg = self.cfg
        with self._lock:
            fleet_fp = self._fingerprint
            best: Optional[Tuple[float, str, int]] = None
            for name in sorted(self._replicas):
                rep = self._replicas[name]
                if rep.status != READY:
                    continue
                affinity = 0
                if header and rep.fingerprint == fleet_fp:
                    for h in header:
                        if h not in rep.prefix:
                            break
                        affinity += 1
                score = ((rep.queue_depth + rep.inflight)
                         * cfg.queue_weight
                         - affinity * cfg.affinity_weight)
                if rep.page_size > 0:
                    needed = (-(-len(tokens) // rep.page_size)
                              - affinity)
                    if needed > rep.kv_free_pages:
                        score += cfg.headroom_penalty
                if best is None or score < best[0]:
                    best = (score, name, affinity)
        if best is None:
            return None
        return best[1], best[2]

    # -- dispatch accounting ----------------------------------------------
    def _acquire(self, name: str) -> None:
        with self._lock:
            rep = self._replicas.get(name)
            if rep is not None:
                rep.inflight += 1

    def _release(self, name: str) -> None:
        with self._lock:
            rep = self._replicas.get(name)
            if rep is not None and rep.inflight > 0:
                rep.inflight -= 1

    def _client(self, name: str):
        with self._lock:
            rep = self._replicas.get(name)
            return None if rep is None else rep.client

    def _note_published(self, name: str, prompt: List[int]) -> None:
        """Optimistic index update after a 200: the replica published
        this prompt's full pages (``publish_prefix``), so credit them
        before the next health poll arrives — back-to-back shared
        headers route warm immediately."""
        with self._lock:
            rep = self._replicas.get(name)
            if rep is None or len(rep.prefix) >= self.cfg.index_cap:
                return
            fp, ps, pps = (self._fingerprint, self._page_size,
                           self._pages_per_slot)
            if not fp or rep.fingerprint != fp or ps <= 0:
                return
        for h in published_page_hashes(fp, prompt, ps, pps):
            with self._lock:
                rep = self._replicas.get(name)
                if rep is None:
                    return
                rep.prefix.add(h)

    # -- the failover dispatch loop ---------------------------------------
    def dispatch(self, payload: dict,
                 timeout: Optional[float] = None) -> Tuple[int, dict]:
        """Route one /generate request, surviving drains and deaths.

        Returns ``(status, response)``.  200 responses carry the FULL
        token list (continuation partials merged back in) plus a
        ``router`` stamp naming the serving replica, the affinity page
        count of the first routing, and how many failovers/continuation
        resubmits it took.  400/500/504 from a live replica pass
        through (they are not retryable: malformed input, a poisoned
        engine's partials, the client's own deadline).  503 is
        returned only when the retry budget exhausts with no ready
        replica."""
        tokens = payload.get("tokens")
        if not tokens:
            return 400, {"error": "router dispatch needs token ids "
                                  "(text encoding is replica-side)"}
        prompt = [int(t) for t in tokens]
        remaining = int(payload.get("max_tokens", 32))
        collected: List[int] = []
        failovers = 0
        resubmits = 0
        first_affinity: Optional[int] = None
        _M_REQS.inc()
        for attempt in range(self.cfg.max_attempts):
            pick = self.select(prompt)
            if pick is None:
                # Force a refresh (a drained replica may have resumed,
                # a dead one's backoff may have expired) and give the
                # fleet one jittered beat before burning the attempt.
                self.poll()
                pick = self.select(prompt)
            if pick is None:
                if attempt + 1 < self.cfg.max_attempts:
                    self._sleep(self.cfg.probe_base * (attempt + 1))
                continue
            name, affinity = pick
            if first_affinity is None:
                first_affinity = affinity
                if affinity > 0:
                    _M_AFF_HITS.inc()
                    _M_AFF_PAGES.inc(affinity)
            client = self._client(name)
            if client is None:
                continue
            body = dict(payload)
            body["tokens"] = prompt
            body["max_tokens"] = remaining
            self._acquire(name)
            try:
                status, resp = client.generate(body, timeout=timeout)
            except ReplicaUnreachable:
                self._mark_dead(name)
                failovers += 1
                _M_FAILOVERS.inc()
                _flight.record("route_failover", name, "unreachable")
                continue
            finally:
                self._release(name)
            if status == 200:
                self._note_published(name, prompt)
                out = dict(resp)
                out["tokens"] = collected + list(resp.get("tokens")
                                                 or [])
                if collected:
                    # The replica's text/latency fields describe only
                    # the final leg — drop what no longer matches the
                    # merged completion.
                    out.pop("text", None)
                out["router"] = {"replica": name,
                                 "affinity_pages": first_affinity or 0,
                                 "failovers": failovers,
                                 "resubmits": resubmits}
                return 200, out
            if status == 503:
                # Drained mid-flight (or refusing admission while
                # draining): partial tokens become a continuation —
                # the bitwise contract reproduces the rest anywhere.
                partial = [int(t) for t in resp.get("tokens") or []]
                if partial:
                    collected += partial
                    prompt = prompt + partial
                    remaining -= len(partial)
                    resubmits += 1
                    _M_CONTINUATIONS.inc()
                self._mark_draining(name)
                failovers += 1
                _M_FAILOVERS.inc()
                _flight.record("route_failover", name,
                               f"draining partial={len(partial)}")
                if remaining <= 0:
                    return 200, {"tokens": collected,
                                 "finish_reason": "length",
                                 "router": {
                                     "replica": name,
                                     "affinity_pages":
                                         first_affinity or 0,
                                     "failovers": failovers,
                                     "resubmits": resubmits}}
                continue
            out = dict(resp)
            out["router"] = {"replica": name,
                             "affinity_pages": first_affinity or 0,
                             "failovers": failovers,
                             "resubmits": resubmits}
            return status, out
        _M_NO_REPLICA.inc()
        return 503, {"error": "no ready replica within the retry "
                              "budget", "failovers": failovers,
                     "partial_tokens": collected}

    # -- fleet scale-down --------------------------------------------------
    def drain_replica(self, name: str) -> Optional[dict]:
        """Drain one replica for scale-down: ``POST /drain`` exports
        its queued/in-flight work as continuations plus its prefix
        index, and the replica stops taking traffic (NOT_READY).
        Returns the export payload (``{"requests": [...], "prefixes":
        [...]}``), or None when the replica was already gone."""
        client = self._client(name)
        if client is None:
            return None
        self._mark_draining(name)
        try:
            status, payload = client.drain()
        except ReplicaUnreachable:
            self._mark_dead(name)
            return None
        if status != 200:
            _flight.record("route_drain_failed", name, f"http={status}")
            return None
        return payload
