"""hvd-route autoscaling: grow/shrink the replica fleet from load (a copy
of horovod_tpu/routing/autoscale.py, which imports no JAX).

The autoscaler is a policy loop over the router's fleet snapshot, in
the same shape as hvd-tune's PolicyEngine: windowed observation →
hysteresis (``sustain`` consecutive ticks over threshold) → cooldown
after every action → a PLANNER VETO before anything irreversible.  It
never touches a replica directly — scale-up goes through an injected
``launch`` hook (subprocess, k8s pod, sim replica — the autoscaler
does not care) and the elastic seed path, scale-down through the
router's drain path:

* **up**: ``launch`` boots the replica, then its KV cache is warmed by
  ghost-seeding a donor replica's live prefix index (``GET /prefixes``
  → ``POST /resume``), so the newcomer starts with the fleet's hottest
  headers already cached instead of a cold TTFT cliff.  Before boot,
  the hvd-mem planner prices the replica's footprint against host
  headroom — a fleet that would OOM is a veto, not a crash.
* **down**: the router drains the victim (``POST /drain``); its
  in-flight HTTP requests come back 503-with-partials and the router's
  dispatch loop resubmits them as continuations (request continuity is
  NOT the autoscaler's job — see docs/routing.md), while the exported
  prefix index is donated to the least-loaded survivor so the fleet
  keeps the warm pages.

Deliberately clock-free: ``observe()`` is a pure tick, driven by the
router server's poll thread in production and called directly by
bench/tests — hysteresis and cooldown count ticks, not seconds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from .. import telemetry as _telemetry
from ..analysis import lockorder as _lockorder
from ..analysis import races as _races
from ..telemetry import flight as _flight
from .replica import ReplicaUnreachable

_M_UPS = _telemetry.counter(
    "routing.scale_ups", "replicas booted by the autoscaler")
_M_DOWNS = _telemetry.counter(
    "routing.scale_downs", "replicas drained away by the autoscaler")
_M_VETOES = _telemetry.counter(
    "routing.scale_vetoes", "scale-ups refused by the planner price "
    "check (insufficient host headroom)")
_M_FLEET = _telemetry.gauge(
    "routing.fleet_size", "replicas currently registered")


@dataclass(frozen=True)
class AutoscaleConfig:
    min_replicas: int = 1
    max_replicas: int = 8
    # Mean (queue_depth + router inflight) per READY replica.  Above
    # ``up_load`` the fleet is saturating (requests wait); below
    # ``down_load`` it idles.  The dead band between them is the
    # hysteresis that stops flapping on noisy traffic.
    up_load: float = 8.0
    down_load: float = 1.0
    sustain: int = 3       # consecutive ticks over threshold to act
    cooldown: int = 10     # ticks of enforced quiet after any action
    seed_prefix_limit: int = 256  # chains donated to a booting replica


@_races.race_checked
class FleetAutoscaler:
    """Tick-driven fleet sizing over a :class:`~horovod_tpu_torch.routing.
    router.Router`.

    ``launch(name) -> client`` boots a replica and returns its client;
    ``retire(name)`` reclaims one the autoscaler booted.  ``price() ->
    bytes`` and ``headroom() -> bytes`` are the planner hooks: price
    is the hvd-mem plan's footprint for one replica (weights + KV pool
    + prefix reserve), headroom what the host still has — price >
    headroom vetoes the boot."""

    def __init__(self, router, launch: Callable[[str], object],
                 retire: Callable[[str], None],
                 cfg: Optional[AutoscaleConfig] = None,
                 price: Optional[Callable[[], int]] = None,
                 headroom: Optional[Callable[[], int]] = None) -> None:
        self.router = router
        self.cfg = cfg or AutoscaleConfig()
        self._launch = launch
        self._retire = retire
        self._price = price
        self._headroom = headroom
        self._lock = _lockorder.make_lock(
            "routing.FleetAutoscaler._lock")
        self._sustain_up = 0    # guarded_by: _lock
        self._sustain_down = 0  # guarded_by: _lock
        self._cooldown = 0      # guarded_by: _lock
        self._seq = 0           # guarded_by: _lock
        self._launched: List[str] = []  # guarded_by: _lock

    # -- observation -------------------------------------------------------
    def _fleet_load(self):
        status = self.router.replica_status()
        ready = [s for s in status.values() if s["status"] == "ready"]
        if not ready:
            return len(status), 0, 0.0
        load = sum(s["queue_depth"] + s["inflight"] for s in ready)
        return len(status), len(ready), load / len(ready)

    def observe(self) -> Optional[str]:
        """One autoscaling tick.  Returns what happened — ``"up:NAME"``,
        ``"down:NAME"``, ``"veto:up"`` or None — so benches and tests
        can assert the decision, not just its side effects."""
        total, ready, mean_load = self._fleet_load()
        _M_FLEET.set(total)
        cfg = self.cfg
        with self._lock:
            if self._cooldown > 0:
                self._cooldown -= 1
                self._sustain_up = 0
                self._sustain_down = 0
                return None
            want_up = (mean_load > cfg.up_load
                       and total < cfg.max_replicas)
            # Scale-down needs every registered replica healthy AND
            # idle — a dead replica mid-failover is not "overcapacity".
            want_down = (ready == total and total > cfg.min_replicas
                         and mean_load < cfg.down_load)
            self._sustain_up = self._sustain_up + 1 if want_up else 0
            self._sustain_down = (self._sustain_down + 1
                                  if want_down else 0)
            fire_up = self._sustain_up >= cfg.sustain
            fire_down = self._sustain_down >= cfg.sustain
            if fire_up or fire_down:
                self._sustain_up = 0
                self._sustain_down = 0
                self._cooldown = cfg.cooldown
        if fire_up:
            return self._scale_up(mean_load)
        if fire_down:
            return self._scale_down(mean_load)
        return None

    # -- actions -----------------------------------------------------------
    def _scale_up(self, mean_load: float) -> Optional[str]:
        if self._price is not None and self._headroom is not None:
            need, have = int(self._price()), int(self._headroom())
            if need > have:
                _M_VETOES.inc()
                _flight.record(
                    "route_scale_veto", "up",
                    f"price={need} headroom={have} load={mean_load:.1f}")
                return "veto:up"
        with self._lock:
            self._seq += 1
            name = f"auto{self._seq}"
        client = self._launch(name)
        self._seed_prefixes(client)
        self.router.add_replica(name, client)
        self.router.poll(name)
        with self._lock:
            self._launched.append(name)
        _M_UPS.inc()
        _flight.record("route_scale_up", name,
                       f"load={mean_load:.1f}")
        return f"up:{name}"

    def _seed_prefixes(self, client) -> None:
        """Warm a booting replica from the busiest survivor's live
        index — ghost-seeded via the elastic /resume path, so the
        newcomer's first affinity-routed requests hit instead of
        recomputing the fleet's hottest headers."""
        donor = self._donor_name()
        if donor is None:
            return
        donor_client = self.router._client(donor)
        if donor_client is None:
            return
        try:
            status, payload = donor_client.prefixes()
            if status != 200:
                return
            chains = list(payload.get("prefixes") or [])
            if not chains:
                return
            client.resume({"requests": [],
                           "prefixes":
                               chains[:self.cfg.seed_prefix_limit]})
        except ReplicaUnreachable:
            return

    def _donor_name(self) -> Optional[str]:
        status = self.router.replica_status()
        best = None
        for name, s in sorted(status.items()):
            if s["status"] != "ready":
                continue
            if best is None or (s["prefix_index_pages"]
                                > status[best]["prefix_index_pages"]):
                best = name
        return best

    def _scale_down(self, mean_load: float) -> Optional[str]:
        victim = self._victim_name()
        if victim is None:
            return None
        exported = self.router.drain_replica(victim)
        if exported is not None:
            self._donate_prefixes(victim, exported)
        self.router.remove_replica(victim)
        with self._lock:
            if victim in self._launched:
                self._launched.remove(victim)
        self._retire(victim)
        _M_DOWNS.inc()
        _flight.record("route_scale_down", victim,
                       f"load={mean_load:.1f}")
        return f"down:{victim}"

    def _victim_name(self) -> Optional[str]:
        """Least-loaded ready replica, preferring ones this autoscaler
        booted (the hand-provisioned core fleet is retired last)."""
        status = self.router.replica_status()
        with self._lock:
            launched = set(self._launched)
        best = None
        best_key = None
        for name, s in sorted(status.items()):
            if s["status"] != "ready":
                continue
            key = (0 if name in launched else 1,
                   s["queue_depth"] + s["inflight"])
            if best_key is None or key < best_key:
                best, best_key = name, key
        return best

    def _donate_prefixes(self, victim: str, exported: dict) -> None:
        chains = list(exported.get("prefixes") or [])
        if not chains:
            return
        status = self.router.replica_status()
        for name, s in sorted(status.items(),
                              key=lambda kv: (
                                  kv[1]["queue_depth"]
                                  + kv[1]["inflight"], kv[0])):
            if name == victim or s["status"] != "ready":
                continue
            client = self.router._client(name)
            if client is None:
                continue
            try:
                client.resume({
                    "requests": [],
                    "prefixes": chains[:self.cfg.seed_prefix_limit]})
            except ReplicaUnreachable:
                continue
            return
