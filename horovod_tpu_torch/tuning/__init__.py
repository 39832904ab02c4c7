"""hvd-tune: closed-loop online self-tuning (port of horovod_tpu/tuning).

The fleet retunes its own performance knobs from live trace and memory
telemetry: **sensors** (sensors.py) fold the span buffer, the fleet skew
tracker, the serving acceptance rate and prefix counters and the device's
headroom into a per-window diagnosis; the pure **policy** rule table
(policy.py) maps a diagnosis to at most one knob delta a window, with
hysteresis, per-knob cooldown and the memory planner's byte pricing as an
OOM veto; **actuation** (actuation.py) rides every decision down the cycle's
broadcast response stream as a RETUNE marker, so every rank applies it at
the same cycle boundary, verified by the env-fingerprint digest every rank
publishes over telemetry.

Env contract:
  HVD_TPU_TUNE=1             enable the closed loop (rank 0)
  HVD_TPU_TUNE_WINDOW=<n>    decision window in cycles (default 64)
  HVD_TPU_TUNE_PIN=a,b       knobs the policy may never touch
  HOROVOD_AUTOTUNE=1         DEPRECATED alias: the explore-then-commit
                             sweep over (fusion_threshold, cycle_time),
                             folded in as one rule on the same actuation
                             path (its HOROVOD_AUTOTUNE_LOG/
                             _WARMUP_SAMPLES/_SAMPLE_SECONDS contract is
                             unchanged)
"""

from __future__ import annotations

import os
import sys

from .controller import Tuner
from .policy import (COMPRESSION_LADDER, KNOB_NAMES, Decision, PolicyConfig,
                     PolicyEngine, WindowSnapshot)

__all__ = ["Tuner", "Decision", "PolicyConfig", "PolicyEngine",
           "WindowSnapshot", "COMPRESSION_LADDER", "KNOB_NAMES",
           "validate_env", "install"]


def validate_env() -> None:
    """Fail init — not the first decision window — on a malformed
    hvd-tune knob, naming the valid vocabulary."""
    tune = os.environ.get("HVD_TPU_TUNE", "")
    if tune not in ("", "0", "1"):
        raise ValueError(f"HVD_TPU_TUNE={tune!r}: expected 0 or 1")
    window = os.environ.get("HVD_TPU_TUNE_WINDOW")
    if window:
        try:
            if int(window) < 1:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"HVD_TPU_TUNE_WINDOW={window!r}: expected a positive "
                f"integer (decision window in drain ticks)") from None
    raw = os.environ.get("HVD_TPU_TUNE_PIN", "")
    for pin in raw.replace(";", ",").split(","):
        pin = pin.strip()
        if pin and pin not in KNOB_NAMES:
            raise ValueError(
                f"HVD_TPU_TUNE_PIN names unknown knob {pin!r}: expected "
                f"a comma-separated subset of {', '.join(KNOB_NAMES)}")


def install(st) -> None:
    """Wire hvd-tune into a freshly initialized runtime (core/state.init).

    Every rank registers the telemetry collector (the env digest and the
    per-knob gauges ride metrics pulls); rank 0, which negotiates, also
    gets the controller when it is enabled, published both as
    ``st.tuner`` (the marker source ``_negotiate`` drains) and as
    ``st.autotuner`` (the ``record_bytes``/``maybe_step`` feed after a
    cycle's responses ran)."""
    from . import actuation as _actuation

    _actuation.install_collector()
    st.tuner = None
    st.autotuner = None
    closed_loop = os.environ.get("HVD_TPU_TUNE") == "1"
    sweep = os.environ.get("HOROVOD_AUTOTUNE") == "1"
    if st.rank != 0 or not (closed_loop or sweep):
        return
    if sweep and not closed_loop:
        print("[hvd-tune] HOROVOD_AUTOTUNE=1 is a deprecated alias: the "
              "explore-then-commit sweep now runs inside the hvd-tune "
              "controller (set HVD_TPU_TUNE=1 for the full closed loop)",
              file=sys.stderr)
    st.tuner = st.autotuner = Tuner(st, sweep=sweep,
                                    closed_loop=closed_loop)
