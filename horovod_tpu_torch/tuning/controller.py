"""hvd-tune controller: rank 0's closed loop (port of
horovod_tpu/tuning/controller.py).

One :class:`Tuner` lives on the process that negotiates -- rank 0, the only
process of a one-rank job -- and is fed from rank 0's cycle
(``ops/collective.py``): ``record_bytes`` for each executed response, then
one ``maybe_step``.  Every ``HVD_TPU_TUNE_WINDOW`` cycles it samples the
sensors (tuning/sensors.py), runs the pure policy engine (tuning/policy.py)
and turns at most one decision into a RETUNE stream marker the next cycle
broadcasts (tuning/actuation.py): the controller never sets a knob itself,
it asks the stream to, and its own rank applies at the same stream position
as every other.

The autotune fold-in: with ``HOROVOD_AUTOTUNE=1`` (a deprecated alias of
the subsystem) the explore-then-commit sweep (utils/autotune.py) runs as one
rule inside this controller, its apply hook redirected onto the marker path,
and the sweep's two knobs (fusion_threshold, cycle_time) are pinned away
from the rule table, so two tuners never fight over a knob.  ``done`` turns
true only once the commit marker has been APPLIED on this rank: a caller
that loops on ``autotuner.done`` sees the committed values when it exits.

Fleet verification, split across windows (the port's difference): after an
applied retune in a multi-rank job, one window sets the metrics pull (the
next cycle's broadcast asks, ``Runtime.request_metrics``) and a later window
reads the replies the workers' batches carried
(``Runtime.metrics_replies``).  The reference pulls ``cluster_metrics()``
within one window; the port's pull waits for replies only later cycles can
carry, so a wait inside rank 0's cycle would sit out its timeout and see no
worker.  Every rank's ``tuning.env_digest`` gauge must agree; a divergence
(a rank that somehow missed the marker) counts in ``tuning.rollbacks`` and
enqueues a rollback marker restoring the previous values fleet-wide.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from .. import telemetry as _telemetry
from ..analysis import lockorder as _lockorder
from ..analysis import races as _races
from ..ops.wire import Response
from . import actuation as _actuation
from . import policy as _policy

_M_DECISIONS = _telemetry.counter(
    "tuning.decisions", "policy decisions enqueued as RETUNE markers")
_M_VETOES = _telemetry.counter(
    "tuning.vetoes", "candidates vetoed by the planner's byte pricing")
_M_ROLLBACKS = _telemetry.counter(
    "tuning.rollbacks", "retunes rolled back after a fleet-coherence "
                        "divergence")

DEFAULT_WINDOW_TICKS = 64

_SWEEP_KNOBS = (_policy.KNOB_FUSION_THRESHOLD, _policy.KNOB_CYCLE_TIME)


def _pinned_from_env() -> frozenset:
    raw = os.environ.get("HVD_TPU_TUNE_PIN", "")
    return frozenset(p.strip() for p in raw.replace(";", ",").split(",")
                     if p.strip())


@_races.race_checked
class Tuner:
    def __init__(self, st, sweep: bool = False, closed_loop: bool = False,
                 window_ticks: Optional[int] = None,
                 policy_config: Optional[_policy.PolicyConfig] = None,
                 verify_timeout: float = 2.0):
        self._st = st
        self._lock = _lockorder.make_lock("tuning.Tuner._lock")
        self._pending: List[Response] = []  # guarded_by: _lock
        self._next_seq = 0                  # guarded_by: _lock
        self._applied_seq = -1
        self._commit_seq: Optional[int] = None
        self._verify_timeout = float(verify_timeout)
        self._verify_due = False
        # The metrics pull in flight: the monotonic time it was asked.
        self._verify_asked: Optional[float] = None
        # seq -> [(knob, previous value)] for rollback on divergence.
        self._undo: Dict[int, List[Tuple[str, object]]] = {}
        self._ticks = 0
        self._window_ticks = int(
            window_ticks if window_ticks is not None
            else os.environ.get("HVD_TPU_TUNE_WINDOW",
                                DEFAULT_WINDOW_TICKS))
        self._sweep = None
        self.policy: Optional[_policy.PolicyEngine] = None
        self._sensors = None
        self._vetoes_seen = 0
        if closed_loop:
            from ..memory.planner import retune_delta_bytes
            from .sensors import WindowAggregator

            cfg = policy_config
            if cfg is None:
                pinned = _pinned_from_env()
                if sweep:
                    # The fold-in's no-fighting rule: while the sweep
                    # owns its two knobs the rule table cannot touch them.
                    pinned = pinned | frozenset(_SWEEP_KNOBS)
                cfg = _policy.PolicyConfig(pinned=pinned)
            self.policy = _policy.PolicyEngine(
                cfg, price=lambda knob, old, new, snap:
                retune_delta_bytes(knob, old, new, snap.knobs))
            self._sensors = WindowAggregator(
                st, straggler_skew_s=cfg.straggler_skew_us / 1e6)
        if sweep:
            from ..utils.autotune import Autotuner

            self._sweep = Autotuner(self._enqueue_sweep)

    # -- the autotune cycle contract ----------------------------------------
    def record_bytes(self, n: int) -> None:
        if self._sweep is not None:
            self._sweep.record_bytes(n)

    @property
    def committed(self):
        return self._sweep.committed if self._sweep is not None else None

    @property
    def done(self) -> bool:
        """The sweep is finished AND its commit has been applied on this
        rank: loops waiting on ``done`` see the committed values."""
        if self._sweep is None or self._sweep.committed is None:
            return False
        return self._commit_seq is not None \
            and self._applied_seq >= self._commit_seq

    def close(self) -> None:
        if self._sweep is not None:
            self._sweep.close()

    # -- marker plumbing ----------------------------------------------------
    def _enqueue(self, tokens: List[str],
                 undo: Optional[List[Tuple[str, object]]] = None) -> int:
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            self._pending.append(_actuation.make_marker(tokens, seq))
            if undo:
                self._undo[seq] = list(undo)
        return seq

    def _enqueue_sweep(self, threshold: int, cycle: float) -> None:
        """The Autotuner's apply hook, redirected onto the marker path."""
        seq = self._enqueue([
            f"{_policy.KNOB_FUSION_THRESHOLD}={int(threshold)}",
            f"{_policy.KNOB_CYCLE_TIME}={float(cycle)}"])
        if self._sweep is not None and self._sweep.committed is not None \
                and self._commit_seq is None:
            self._commit_seq = seq

    def take_markers(self) -> List[Response]:
        """Drain the pending markers: rank 0's ``_negotiate`` puts them
        into the cycle's broadcast response stream."""
        with self._lock:
            pending, self._pending = self._pending, []
        return pending

    def note_applied(self, seq: int, applied) -> None:
        """Actuation's callback once THIS rank applied a marker."""
        if seq > self._applied_seq:
            self._applied_seq = seq
        if applied and self._st.size > 1:
            self._verify_due = True

    # -- the closed loop ----------------------------------------------------
    def maybe_step(self) -> None:
        if self._sweep is not None:
            self._sweep.maybe_step()
        if self.policy is None:
            return
        self._ticks += 1
        if self._ticks % self._window_ticks:
            return
        self._verify_fleet()
        snap = self._sensors.sample()
        decision = self.policy.step(snap)
        if self.policy.vetoes > self._vetoes_seen:
            _M_VETOES.inc(self.policy.vetoes - self._vetoes_seen)
            self._vetoes_seen = self.policy.vetoes
        if decision is None:
            return
        old = snap.knobs.get(decision.knob)
        seq = self._enqueue([decision.wire()],
                            undo=[(decision.knob, old)])
        _M_DECISIONS.inc()
        print(f"[hvd-tune] decision seq={seq} window={snap.index} "
              f"{decision.wire()}: {decision.reason}", file=sys.stderr)

    def _verify_fleet(self) -> None:
        """The post-retune coherence check, one window at a time: a window
        after an applied retune asks for the ranks' metrics; a later
        window, once every worker answered (or ``verify_timeout`` seconds
        passed: a rank that has not answered is left out, as the
        reference's pull does), compares their env digests.  Divergence
        -> a rollback marker, fleet-wide."""
        runtime = self._st.runtime
        if self._verify_asked is None:
            if self._verify_due:
                self._verify_due = False
                self._verify_asked = time.monotonic()
                runtime.request_metrics()
            return
        replies = runtime.metrics_replies()
        if len(replies) < self._st.size - 1 and \
                time.monotonic() - self._verify_asked < self._verify_timeout:
            return
        self._verify_asked = None
        if not replies:
            self._verify_due = True  # nobody answered: ask again
            return
        agg = _telemetry.aggregate({0: _telemetry.metrics(), **replies})
        per_rank = (agg.get("tuning.env_digest") or {}).get("per_rank")
        if not per_rank or len(set(per_rank.values())) <= 1:
            return
        _M_ROLLBACKS.inc()
        undo: List[Tuple[str, object]] = []
        with self._lock:
            for seq in sorted(self._undo, reverse=True):
                undo.extend(self._undo.pop(seq))
        ranks = sorted(per_rank)
        print(f"[hvd-tune] env-digest divergence across ranks {ranks} "
              f"after retune: rolling back {len(undo)} knob(s) "
              f"fleet-wide", file=sys.stderr)
        if undo:
            self._enqueue([f"{k}={v}" for k, v in undo])
