"""hvd-tune policy engine: diagnosis -> knob delta, pure in its inputs
(a copy of horovod_tpu/tuning/policy.py, which imports no JAX).

The rule table maps one :class:`WindowSnapshot` (the sensors' per-window
diagnosis, sensors.py) to at most ONE :class:`Decision` per window.  The
engine is deliberately free of wall clock and PRNG: feeding it the same
snapshot sequence always yields the same decision sequence — the
determinism gate ``bench.py --mode tuning`` replays.

Stability machinery (docs/tuning.md "Why the tuner won't thrash"):

* **Hysteresis** — a rule's condition must hold for ``sustain``
  consecutive windows before it fires; a boundary-flapping input
  (condition alternating true/false) never accumulates the streak.
* **Cooldown** — after a rule touches a knob (or is vetoed on it), that
  knob is untouchable for ``cooldown`` further windows, so the effect of
  one retune is measured before the next.
* **Engagement floor** — leg-dominance rules need the dominant leg to
  carry at least ``engage_share`` of the window's busy time; an
  undiagnosable (flat) profile produces no decision at all.
* **Planner veto** — every candidate is priced by the hvd-mem planner's
  shared byte formulas (memory/planner.py) through the ``price`` hook
  BEFORE it becomes a decision; a candidate whose predicted device-byte
  delta exceeds the window's headroom is counted (``vetoes``) and the
  knob left untouched — a retune can never land on an OOM.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

# The compression escalation ladder the dcn rule climbs (one rung per
# decision): each rung narrows the DCN wire format further
# (ops/compression.py; int4 is the EQuARX-style block-quantized floor).
COMPRESSION_LADDER = ("none", "bf16", "int8", "int4")

# Knob names (the wire vocabulary carried by RETUNE markers —
# tuning/actuation.py owns the apply side of each).
KNOB_DCN_COMPRESS = "dcn_compress"
KNOB_MAX_INFLIGHT = "max_inflight"
KNOB_FUSION_THRESHOLD = "fusion_threshold"
KNOB_CYCLE_TIME = "cycle_time"
KNOB_SPEC_TOKENS = "spec_tokens"
KNOB_PREFIX_PAGES = "prefix_pages"

KNOB_NAMES = (KNOB_DCN_COMPRESS, KNOB_MAX_INFLIGHT, KNOB_FUSION_THRESHOLD,
              KNOB_CYCLE_TIME, KNOB_SPEC_TOKENS, KNOB_PREFIX_PAGES)


@dataclass(frozen=True)
class WindowSnapshot:
    """One decision window's diagnosis — everything the policy may read.

    ``legs`` is busy µs per critical-path leg (trace/analyze.py LEGS
    vocabulary); ``straggler_rank`` is the window's late rank (-1 none);
    ``spec_acceptance`` is the serving engine's acceptance rate (-1 when
    no speculative engine is live); ``headroom_frac`` is free/capacity
    HBM (-1 unknown); ``headroom_bytes`` the absolute free bytes (-1
    unknown) the planner veto prices against; ``knobs`` the CURRENT
    knob values the deltas start from.  ``prefix_hit_rate`` is the
    window's shared-prefix hit fraction (target + draft hits over
    prefills, -1 when no serving engine is live) and ``kv_free_frac``
    the KV admission-headroom fraction (free/total pages, -1 unknown)
    — the prefix-reserve retune rule's inputs."""

    index: int
    legs: Mapping[str, float]
    knobs: Mapping[str, object]
    straggler_rank: int = -1
    spec_acceptance: float = -1.0
    headroom_frac: float = -1.0
    headroom_bytes: int = -1
    prefix_hit_rate: float = -1.0
    kv_free_frac: float = -1.0


@dataclass(frozen=True)
class Decision:
    seq: int
    window: int
    knob: str
    value: object
    reason: str

    def wire(self) -> str:
        """The ``knob=value`` token a RETUNE marker carries."""
        return f"{self.knob}={self.value}"


@dataclass(frozen=True)
class PolicyConfig:
    sustain: int = 2            # consecutive windows before a rule fires
    cooldown: int = 2           # knob-untouchable windows after a fire
    engage_share: float = 0.10  # leg rules: minimum dominant-leg share
    dcn_share: float = 0.35     # dcn-dominated threshold
    gap_share: float = 0.35     # dispatch-gap-dominated threshold
    low_acceptance: float = 0.5  # spec_tokens shrink threshold
    headroom_floor: float = 0.10  # free/capacity triggering byte-saving
    straggler_skew_us: float = 1000.0  # sensors' persistence threshold
    max_inflight_cap: int = 8
    fusion_floor_bytes: int = 1 << 20
    # Prefix-reserve retuning (hvd-route tail): a hot index starving
    # for KV headroom earns a bigger dedicated reserve; a cold index
    # gives its reserve back.
    prefix_hit_high: float = 0.5   # hit rate worth growing for
    prefix_hit_low: float = 0.05   # hit rate the reserve shrinks under
    prefix_kv_floor: float = 0.25  # kv_free_frac that signals pressure
    prefix_pages_cap: int = 256
    pinned: frozenset = field(default_factory=frozenset)


def _share(legs: Mapping[str, float], leg: str) -> float:
    total = sum(max(0.0, float(v)) for v in legs.values())
    if total <= 0.0:
        return 0.0
    return max(0.0, float(legs.get(leg, 0.0))) / total


class PolicyEngine:
    """The deterministic rule table.  ``price`` is the planner-veto hook:
    ``price(knob, old, new, snapshot) -> predicted device-byte DELTA``
    (positive = the candidate costs memory); a delta above the
    snapshot's known headroom vetoes the candidate."""

    def __init__(self, cfg: Optional[PolicyConfig] = None,
                 price: Optional[Callable[..., int]] = None):
        self.cfg = cfg or PolicyConfig()
        self._price = price
        self._seq = 0
        self._sustain: Dict[str, int] = {}
        self._cooldown: Dict[str, int] = {}
        self._straggler: Tuple[int, int] = (-1, 0)  # (rank, streak)
        self.decisions: List[Decision] = []
        self.vetoes = 0
        self.veto_log: List[Tuple[int, str, object, str]] = []

    # -- rule proposals ----------------------------------------------------
    def _propose_dcn(self, snap: WindowSnapshot):
        cur = str(snap.knobs.get(KNOB_DCN_COMPRESS, "none"))
        try:
            idx = COMPRESSION_LADDER.index(cur)
        except ValueError:
            idx = 0  # fp16 etc.: restart the ladder conservatively
        if idx + 1 >= len(COMPRESSION_LADDER):
            return None
        nxt = COMPRESSION_LADDER[idx + 1]
        return (KNOB_DCN_COMPRESS, nxt,
                f"dcn leg at {_share(snap.legs, 'dcn'):.0%} of the "
                f"critical path: escalate DCN compression {cur} -> {nxt}")

    def _propose_gap(self, snap: WindowSnapshot):
        cur = int(snap.knobs.get(KNOB_MAX_INFLIGHT, 2))
        if cur >= self.cfg.max_inflight_cap:
            return None
        nxt = min(self.cfg.max_inflight_cap, cur * 2)
        return (KNOB_MAX_INFLIGHT, nxt,
                f"dispatch-gap leg at {_share(snap.legs, 'dispatch-gap'):.0%}"
                f": widen in-flight window {cur} -> {nxt}")

    def _propose_rebucket(self, snap: WindowSnapshot):
        cur = int(snap.knobs.get(KNOB_FUSION_THRESHOLD, 64 << 20))
        if cur <= self.cfg.fusion_floor_bytes:
            return None
        nxt = max(self.cfg.fusion_floor_bytes, cur // 2)
        return (KNOB_FUSION_THRESHOLD, nxt,
                f"persistent straggler rank {snap.straggler_rank}: "
                f"re-bucket via fusion threshold {cur} -> {nxt}")

    def _propose_spec(self, snap: WindowSnapshot):
        cur = int(snap.knobs.get(KNOB_SPEC_TOKENS, 3))
        if cur <= 1:
            return None
        return (KNOB_SPEC_TOKENS, cur - 1,
                f"spec acceptance {snap.spec_acceptance:.0%} below "
                f"{self.cfg.low_acceptance:.0%}: shrink spec_tokens "
                f"{cur} -> {cur - 1}")

    def _propose_headroom(self, snap: WindowSnapshot):
        # Trade speed for bytes: smaller fusion buffers first, then
        # narrower wire formats (both shrink the live device footprint).
        cur = int(snap.knobs.get(KNOB_FUSION_THRESHOLD, 64 << 20))
        if cur > self.cfg.fusion_floor_bytes:
            nxt = max(self.cfg.fusion_floor_bytes, cur // 2)
            return (KNOB_FUSION_THRESHOLD, nxt,
                    f"HBM headroom {snap.headroom_frac:.0%} below "
                    f"{self.cfg.headroom_floor:.0%}: shrink fusion "
                    f"buffers {cur} -> {nxt}")
        return self._propose_dcn(snap)

    def _propose_prefix_grow(self, snap: WindowSnapshot):
        cur = int(snap.knobs.get(KNOB_PREFIX_PAGES, 0) or 0)
        if cur >= self.cfg.prefix_pages_cap:
            return None
        nxt = min(self.cfg.prefix_pages_cap, max(cur * 2, 8))
        return (KNOB_PREFIX_PAGES, nxt,
                f"prefix hit rate {snap.prefix_hit_rate:.0%} with KV "
                f"headroom at {snap.kv_free_frac:.0%}: grow the prefix "
                f"reserve {cur} -> {nxt} pages")

    def _propose_prefix_shrink(self, snap: WindowSnapshot):
        cur = int(snap.knobs.get(KNOB_PREFIX_PAGES, 0) or 0)
        if cur <= 0:
            return None
        return (KNOB_PREFIX_PAGES, cur // 2,
                f"prefix hit rate {snap.prefix_hit_rate:.0%} below "
                f"{self.cfg.prefix_hit_low:.0%}: shrink the prefix "
                f"reserve {cur} -> {cur // 2} pages")

    # -- the window step ---------------------------------------------------
    def _conditions(self, snap: WindowSnapshot) -> List[Tuple[str, float]]:
        """(rule, urgency) for every rule whose condition holds this
        window, most urgent first — a deterministic total order (urgency
        desc, then rule name asc)."""
        cfg = self.cfg
        held: List[Tuple[str, float]] = []
        if 0.0 <= snap.headroom_frac < cfg.headroom_floor:
            held.append(("headroom", 2.0))  # safety outranks speed
        dcn = _share(snap.legs, "dcn")
        if dcn >= max(cfg.dcn_share, cfg.engage_share):
            held.append(("dcn", dcn))
        gap = _share(snap.legs, "dispatch-gap")
        if gap >= max(cfg.gap_share, cfg.engage_share):
            held.append(("gap", gap))
        if self._straggler[0] >= 0 \
                and self._straggler[1] >= cfg.sustain:
            held.append(("straggler", 0.5))
        if 0.0 <= snap.spec_acceptance < cfg.low_acceptance:
            held.append(("spec", 0.4))
        # Prefix-reserve balance: a HOT index under KV-headroom
        # pressure earns dedicated pages (the shared pool is thrashing
        # cached prefixes against live slots); a COLD index with a
        # reserve gives it back.  Mutually exclusive by construction
        # (hit rate cannot be both >= high and < low).
        if (0.0 <= snap.kv_free_frac < cfg.prefix_kv_floor
                and snap.prefix_hit_rate >= cfg.prefix_hit_high):
            held.append(("prefix_grow", 0.3))
        if (0.0 <= snap.prefix_hit_rate < cfg.prefix_hit_low
                and int(snap.knobs.get(KNOB_PREFIX_PAGES, 0) or 0) > 0):
            held.append(("prefix_shrink", 0.2))
        held.sort(key=lambda e: (-e[1], e[0]))
        return held

    _PROPOSERS = {
        "dcn": _propose_dcn,
        "gap": _propose_gap,
        "straggler": _propose_rebucket,
        "spec": _propose_spec,
        "headroom": _propose_headroom,
        "prefix_grow": _propose_prefix_grow,
        "prefix_shrink": _propose_prefix_shrink,
    }

    def step(self, snap: WindowSnapshot) -> Optional[Decision]:
        """Consume one window; return at most one decision."""
        cfg = self.cfg
        # Knob cooldowns age by one window.
        for knob in list(self._cooldown):
            self._cooldown[knob] -= 1
            if self._cooldown[knob] <= 0:
                del self._cooldown[knob]
        # Straggler persistence: consecutive windows blaming one rank.
        rank, streak = self._straggler
        if snap.straggler_rank >= 0 and snap.straggler_rank == rank:
            self._straggler = (rank, streak + 1)
        elif snap.straggler_rank >= 0:
            self._straggler = (snap.straggler_rank, 1)
        else:
            self._straggler = (-1, 0)
        # Hysteresis: streaks reset the window a condition lapses.
        held = self._conditions(snap)
        held_names = {name for name, _ in held}
        for name in list(self._sustain):
            if name not in held_names:
                del self._sustain[name]
        for name in held_names:
            self._sustain[name] = self._sustain.get(name, 0) + 1
        # Fire the most urgent sustained rule whose knob is free.  The
        # straggler rule's persistence is its same-rank streak (already
        # >= sustain to be held at all) — the generic streak would
        # double the hysteresis.
        for name, _urgency in held:
            need = 1 if name == "straggler" else cfg.sustain
            if self._sustain.get(name, 0) < need:
                continue
            proposal = self._PROPOSERS[name](self, snap)
            if proposal is None:
                continue
            knob, value, reason = proposal
            if knob in cfg.pinned or knob in self._cooldown:
                continue
            if self._price is not None:
                delta = int(self._price(knob, snap.knobs.get(knob),
                                        value, snap))
                if snap.headroom_bytes >= 0 and delta > snap.headroom_bytes:
                    # Veto: counted, knob untouched, and cooled down so
                    # the same doomed candidate is not re-priced every
                    # window while the pressure lasts.
                    self.vetoes += 1
                    self.veto_log.append((snap.index, knob, value, reason))
                    self._cooldown[knob] = cfg.cooldown
                    self._sustain[name] = 0
                    return None
            decision = Decision(self._seq, snap.index, knob, value, reason)
            self._seq += 1
            self._sustain[name] = 0
            self._cooldown[knob] = cfg.cooldown
            self.decisions.append(decision)
            return decision
        return None
