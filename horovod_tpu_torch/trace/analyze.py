"""Step critical-path / straggler analyzer (hvd-trace piece 3; copied
from horovod_tpu/trace/analyze.py:1-304).

``python -m horovod_tpu_torch.trace <fleet-trace.json>`` answers "where did
the cycle go": for every negotiation cycle it names the straggler rank
(from the controller's per-rank request-arrival instants — the same
signal StragglerWatch uses live) with a blame category, decomposes
each rank's spans into the classic legs —

  host          input/prefetch stalls (the loader was the bound)
  pack          dispatch time before the fused launch (fusion-buffer
                memcpy-in)
  collective    the compiled reduction's ICI share
  dcn           its cross-slice DCN share (hierarchical launches,
                split by the wire-byte accounting the launch records)
  unpack        dispatch time after the launch (memcpy-out + divide)
  dispatch      execute spans with no launch inside (eager path)
  dispatch-gap  wall time inside the straggler's cycle covered by no
                span at all
  negotiate     coordinator wait (and the default blame for a rank
                that was simply late with no local span explaining it)

— and aggregates the straggler-chain legs per step: the **critical
path** attribution.  Blame for a straggler is the category where its
busy time most EXCEEDS the fleet median for the step, so "rank 5 was
host-bound" emerges even when every rank also paid the same collective
cost.  Output is a human report plus JSON (``--json``; ``bench.py``'s
``trace`` section consumes it) — both are
pure functions of the input file, so two replays of one trace are
byte-identical.

A dispatch span finds the launch spans inside it through the launches
sorted by start (the reference scans every launch for every dispatch,
quadratic in a window's spans: the online tuner decomposes its whole span
buffer each window); the sums add in the reference's order, so the legs
are the same floats.
"""

from __future__ import annotations

import bisect
import json
from typing import Dict, List, Optional, Tuple

LEGS = ("host", "pack", "collective", "dcn", "unpack", "dispatch",
        "dispatch-gap", "negotiate", "checkpoint", "serving")

# Span category -> leg for the directly-mapped categories.
_DIRECT = {"host": "host", "negotiate": "negotiate",
           "checkpoint": "checkpoint", "serving": "serving"}


def load_trace(path: str) -> List[dict]:
    """Events from a fleet trace (``{"traceEvents": [...]}``) or a bare
    Chrome timeline array."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        return list(data.get("traceEvents", []))
    if isinstance(data, list):
        return data
    raise ValueError(f"{path}: not a Chrome trace (object or array)")


def _key(ev: dict) -> Optional[Tuple[int, int]]:
    args = ev.get("args") or {}
    if "step" not in args or "cycle" not in args:
        return None
    try:
        return int(args["step"]), int(args["cycle"])
    except (TypeError, ValueError):
        return None


def _collective_legs(legs: Dict[str, float], ev: dict) -> None:
    """Split one launch span into ICI vs DCN by the wire-byte
    accounting it carries (ops/megakernel.launch)."""
    dur = float(ev.get("dur", 0.0))
    args = ev.get("args") or {}
    wire = args.get("wire_bytes") or 0
    dcn = args.get("dcn_bytes") or 0
    if wire and dcn:
        frac = min(1.0, float(dcn) / float(wire))
        legs["dcn"] += dur * frac
        legs["collective"] += dur * (1.0 - frac)
    else:
        legs["collective"] += dur


def _decompose(spans: List[dict]) -> Dict[str, float]:
    """One rank's spans (any grouping window) -> busy µs per leg."""
    legs: Dict[str, float] = {}
    for leg in LEGS:
        legs[leg] = 0.0
    coll = [s for s in spans if s.get("cat") == "collective"]
    # A launch inside [d0 - 1, d1 + 1] starts in that range unless its
    # duration is negative: those few are checked against every dispatch.
    by_start = sorted((float(c.get("ts", 0.0)), i) for i, c in
                      enumerate(coll) if float(c.get("dur", 0.0)) >= 0.0)
    starts = [t for t, _ in by_start]
    backwards = [i for i, c in enumerate(coll)
                 if float(c.get("dur", 0.0)) < 0.0]
    used = set()
    for d in (s for s in spans if s.get("cat") == "dispatch"):
        d0 = float(d.get("ts", 0.0))
        d1 = d0 + float(d.get("dur", 0.0))
        near = [i for _, i in by_start[bisect.bisect_left(starts, d0 - 1.0):
                                       bisect.bisect_right(starts, d1 + 1.0)]]
        inner = [coll[i] for i in sorted(near + backwards)
                 if d0 - 1.0 <= float(coll[i].get("ts", 0.0))
                 and float(coll[i].get("ts", 0.0))
                 + float(coll[i].get("dur", 0.0)) <= d1 + 1.0]
        if inner:
            first = min(float(c["ts"]) for c in inner)
            last = max(float(c["ts"]) + float(c.get("dur", 0.0))
                       for c in inner)
            legs["pack"] += max(0.0, first - d0)
            legs["unpack"] += max(0.0, d1 - last)
            for c in inner:
                used.add(id(c))
                _collective_legs(legs, c)
        else:
            legs["dispatch"] += float(d.get("dur", 0.0))
    for c in coll:
        if id(c) not in used:
            _collective_legs(legs, c)
    for s in spans:
        leg = _DIRECT.get(str(s.get("cat")))
        if leg is not None:
            legs[leg] += float(s.get("dur", 0.0))
    return legs


def _median(vals: List[float]) -> float:
    vals = sorted(vals)
    return vals[len(vals) // 2] if vals else 0.0


def window_legs(events: List[dict]) -> Dict[str, float]:
    """hvd-tune sensor surface: a raw in-memory span buffer
    (``trace.export_events()``) -> busy µs per critical-path leg,
    including the per-(step, cycle) wall-minus-busy residual booked as
    ``dispatch-gap``.  Same leg model as :func:`analyze`, but windowed
    and file-free — the online tuner calls this every decision window
    instead of round-tripping ``dump_fleet_trace``."""
    spans = [e for e in events if e.get("ph") == "X"]
    legs = _decompose(spans)
    groups: Dict[Tuple[int, int], List[dict]] = {}
    for s in spans:
        key = _key(s)
        if key is not None:
            groups.setdefault(key, []).append(s)
    for ss in groups.values():
        wall = (max(float(s["ts"]) + float(s.get("dur", 0.0)) for s in ss)
                - min(float(s["ts"]) for s in ss))
        busy = sum(_decompose(ss).values())
        legs["dispatch-gap"] += max(0.0, wall - busy)
    return legs


def analyze(events: List[dict]) -> dict:
    """The full report over one merged trace (see module docstring for
    the model).  Deterministic: every aggregate is ordered and floats
    are rounded once at the edge."""
    spans: Dict[Tuple[int, int], Dict[int, List[dict]]] = {}
    by_step_rank: Dict[Tuple[int, int], List[dict]] = {}
    arrivals: Dict[Tuple[int, int], Dict[int, float]] = {}
    nspans = 0
    for ev in events:
        key = _key(ev)
        if key is None:
            continue
        if ev.get("ph") == "i" and ev.get("name") == "BATCH_ARRIVAL":
            rank = int((ev.get("args") or {}).get("rank", -1))
            arrivals.setdefault(key, {}).setdefault(
                rank, float(ev.get("ts", 0.0)))
            continue
        if ev.get("ph") != "X":
            continue
        nspans += 1
        rank = int(ev.get("pid", 0))
        spans.setdefault(key, {}).setdefault(rank, []).append(ev)
        by_step_rank.setdefault((key[0], rank), []).append(ev)
    ranks = sorted({r for per in spans.values() for r in per}
                   | {r for per in arrivals.values() for r in per
                      if r >= 0})
    step_rank_legs = {k: _decompose(v) for k, v in by_step_rank.items()}

    cycles_out: List[dict] = []
    straggler_counts: Dict[int, int] = {}
    step_crit: Dict[int, Dict[str, float]] = {}
    step_cycles: Dict[int, int] = {}
    step_stragglers: Dict[int, Dict[int, int]] = {}
    for key in sorted(set(spans) | set(arrivals)):
        step, cycle = key
        step_cycles[step] = step_cycles.get(step, 0) + 1
        per_rank = spans.get(key, {})
        arr = {r: t for r, t in arrivals.get(key, {}).items() if r >= 0}
        straggler: Optional[int] = None
        skew_us = 0.0
        if len(arr) >= 1:
            # Arrival-based: rank 0 submits locally (implicit t=first),
            # so ANY wire arrival spread names the late worker; with
            # several, the latest wins (ties -> lowest rank).
            latest = max(arr.values())
            skew_us = latest - min(arr.values())
            straggler = min(r for r, t in arr.items() if t == latest)
        elif per_rank:
            ends = {r: max(float(s["ts"]) + float(s.get("dur", 0.0))
                           for s in ss) for r, ss in per_rank.items()}
            latest = max(ends.values())
            skew_us = latest - min(ends.values())
            straggler = min(r for r, e in ends.items() if e == latest)
        if straggler is None:
            continue
        # Blame: the leg where the straggler's step-window busy most
        # exceeds the fleet median (a cost every rank pays equally —
        # the collective itself — can never be the blame).
        mine = step_rank_legs.get((step, straggler))
        blame = "negotiate"
        if mine is not None:
            best_excess = 0.0
            for leg in LEGS:
                others = [step_rank_legs[(step, r)][leg]
                          for r in ranks if r != straggler
                          and (step, r) in step_rank_legs]
                excess = mine[leg] - _median(others)
                if excess > best_excess:
                    best_excess, blame = excess, leg
        crit = step_crit.setdefault(step, {leg: 0.0 for leg in LEGS})
        cyc_legs = _decompose(per_rank.get(straggler, []))
        busy = 0.0
        for leg in LEGS:
            crit[leg] += cyc_legs[leg]
            busy += cyc_legs[leg]
        if per_rank.get(straggler):
            ss = per_rank[straggler]
            wall = (max(float(s["ts"]) + float(s.get("dur", 0.0))
                        for s in ss)
                    - min(float(s["ts"]) for s in ss))
            crit["dispatch-gap"] += max(0.0, wall - busy)
        else:
            # No local span explains the lateness: the skew itself is
            # the critical-path cost, booked under the blame leg.
            crit[blame] += skew_us
        straggler_counts[straggler] = \
            straggler_counts.get(straggler, 0) + 1
        per_step = step_stragglers.setdefault(step, {})
        per_step[straggler] = per_step.get(straggler, 0) + 1
        cycles_out.append({"step": step, "cycle": cycle,
                           "straggler": straggler, "blame": blame,
                           "skew_us": round(skew_us, 1)})

    steps_out = []
    total = {leg: 0.0 for leg in LEGS}
    for step in sorted(step_crit):
        crit = step_crit[step]
        for leg in LEGS:
            total[leg] += crit[leg]
        steps_out.append({
            "step": step,
            "cycles": step_cycles.get(step, 0),
            "critical_path_us": {leg: round(crit[leg], 1)
                                 for leg in LEGS},
            "straggler_counts": {str(r): n for r, n in
                                 sorted(step_stragglers
                                        .get(step, {}).items())},
        })
    return {
        "format": "hvd-trace-analysis-v1",
        "ranks": ranks,
        "total_spans": nspans,
        "steps": steps_out,
        "cycles": cycles_out,
        "stragglers": {str(r): n
                       for r, n in sorted(straggler_counts.items())},
        "attribution_us": {leg: round(total[leg], 1) for leg in LEGS},
    }


def render(report: dict) -> str:
    """The human report."""
    lines = ["hvd-trace analysis",
             "==================",
             f"ranks: {report['ranks'] or '[none]'}   spans: "
             f"{report['total_spans']}   cycles: "
             f"{len(report['cycles'])}", ""]
    attr = report["attribution_us"]
    total = sum(attr.values()) or 1.0
    lines.append("critical-path attribution (straggler chain):")
    for leg in LEGS:
        us = attr.get(leg, 0.0)
        if us <= 0:
            continue
        lines.append(f"  {leg:<13} {us / 1e3:10.3f} ms  "
                     f"({100.0 * us / total:5.1f}%)")
    if not any(attr.get(leg, 0) > 0 for leg in LEGS):
        lines.append("  [no attributable spans — was HVD_TPU_TRACE=0, "
                     "or is this a bare rank-0 timeline?]")
    lines.append("")
    if report["stragglers"]:
        lines.append("stragglers (cycles led by each rank):")
        worst = max(report["stragglers"].items(),
                    key=lambda kv: (kv[1], -int(kv[0])))
        for rank, n in report["stragglers"].items():
            lines.append(f"  rank {rank:>3}: {n} cycle(s)")
        blames = [c["blame"] for c in report["cycles"]
                  if str(c["straggler"]) == worst[0]]
        if blames:
            top = max(sorted(set(blames)), key=blames.count)
            lines.append(f"  => rank {worst[0]} led {worst[1]} "
                         f"cycle(s); dominant blame: {top}")
        lines.append("")
    for s in report["steps"]:
        crit = s["critical_path_us"]
        busy = {k: v for k, v in crit.items() if v > 0}
        head = max(sorted(busy), key=lambda k: busy[k]) if busy else "-"
        lines.append(f"step {s['step']:>4}: {s['cycles']} cycle(s), "
                     f"dominant leg: {head}, stragglers: "
                     f"{s['straggler_counts'] or '{}'}")
    return "\n".join(lines) + "\n"
