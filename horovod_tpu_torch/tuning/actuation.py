"""hvd-tune actuation: fleet-coherent knob application (port of
horovod_tpu/tuning/actuation.py).

Decisions become :class:`~..ops.wire.Response` markers of type ``RETUNE``
that ride the cycle's broadcast response stream: rank 0's
``Runtime._negotiate`` puts pending markers after the cache's flush marker
and before the replayed responses (``ops/collective.py``), and every rank's
``Runtime._execute`` applies them HERE at the same stream position, so env
knobs, the megakernels' state and cache replicas flip at one cycle boundary
on every rank.  The marker's ``tensor_names`` carry ``knob=value`` tokens and
``tensor_sizes`` the decision sequence number.

The port's appliers run inside ``Runtime._cycle``, which holds
``cycle_lock``: the fusion threshold goes through
``ops/collective.apply_fusion_threshold``, which takes no lock (the public
``set_fusion_threshold`` takes ``cycle_lock`` and calls it).  ``cycle_time``
sets ``tick_seconds``, which the background loop reads on every pass.  The
serving knobs (``spec_tokens``, ``prefix_pages``) are latched by the
registered engines, which adopt them at the start of their next ``step``
(``serving/engine.py``): a marker lands on the cycle's thread while the
engine's thread may be inside an iteration.

Verification rides telemetry: every rank publishes a digest of the SPMD env
fingerprint (the ``tuning.env_digest`` gauge, fed by a collector, so
``cluster_metrics`` pulls carry it); after an applied retune rank 0's
controller compares the ranks' digests and rolls the knob back fleet-wide
on divergence (tuning/controller.py).
"""

from __future__ import annotations

import hashlib
import os
import sys
import weakref
from typing import Dict, List, Tuple

from .. import telemetry as _telemetry
from ..ops.wire import Response, ResponseType
from . import policy as _policy

_M_APPLIED = _telemetry.counter(
    "tuning.applied", "retune markers applied on this rank")

# Live objects retuned in place (weak, so actuation never extends their
# lifetime): in-flight windows expose ``resize``; speculative serving
# engines ``set_spec_tokens``; every serving engine ``set_prefix_target``.
_inflight_windows: "weakref.WeakSet" = weakref.WeakSet()
_spec_engines: "weakref.WeakSet" = weakref.WeakSet()
_serving_engines: "weakref.WeakSet" = weakref.WeakSet()


def register_inflight_window(window) -> None:
    _inflight_windows.add(window)


def register_spec_engine(engine) -> None:
    _spec_engines.add(engine)


def spec_engines() -> List[object]:
    return list(_spec_engines)


def register_serving_engine(engine) -> None:
    _serving_engines.add(engine)


def serving_engines() -> List[object]:
    return list(_serving_engines)


# ---------------------------------------------------------------------------
# Knob table: parse/format + current value + per-rank apply
# ---------------------------------------------------------------------------

def _parse_value(knob: str, raw: str):
    if knob == _policy.KNOB_DCN_COMPRESS:
        from ..ops import compression as _compression

        _compression.resolve(raw)  # a mistyped name -> ValueError, not a
        return raw                 # half-applied fleet
    if knob == _policy.KNOB_CYCLE_TIME:
        v = float(raw)
        if v <= 0:
            raise ValueError(f"cycle_time must be > 0, got {v}")
        return v
    if knob == _policy.KNOB_PREFIX_PAGES:
        v = int(float(raw))
        if v < 0:  # 0 is legal: the shrink rule may retire the reserve
            raise ValueError(f"prefix_pages must be >= 0, got {v}")
        return v
    v = int(float(raw))  # autotune sweeps may format ints as floats
    if v < 1:
        raise ValueError(f"{knob} must be >= 1, got {v}")
    return v


def current_knobs(st) -> Dict[str, object]:
    """The CURRENT knob values on this rank: the policy's deltas start
    here, and the per-knob gauges publish them."""
    from ..ops import compression as _compression

    dcn = (os.environ.get("HVD_TPU_DCN_COMPRESS")
           or os.environ.get(_compression.DEFAULT_ENV) or "none")
    try:
        inflight = max(1, int(os.environ.get("HVD_TPU_MAX_INFLIGHT", "2")))
    except ValueError:
        inflight = 2
    try:
        spec = int(os.environ.get("HVD_TPU_SPEC_TOKENS", "3"))
    except ValueError:
        spec = 3
    try:
        prefix = max(0, int(os.environ.get("HVD_TPU_PREFIX_PAGES", "0")))
    except ValueError:
        prefix = 0
    knobs: Dict[str, object] = {
        _policy.KNOB_DCN_COMPRESS: dcn,
        _policy.KNOB_MAX_INFLIGHT: inflight,
        _policy.KNOB_FUSION_THRESHOLD: int(st.fusion_threshold_bytes),
        _policy.KNOB_CYCLE_TIME: float(st.tick_seconds),
        _policy.KNOB_SPEC_TOKENS: spec,
        _policy.KNOB_PREFIX_PAGES: prefix,
    }
    # A live serving engine advertises its per-page KV bytes, so the
    # planner can price prefix_pages moves (memory/planner.py).
    for engine in serving_engines():
        cache = getattr(engine, "cache", None)
        per_page = getattr(cache, "page_global_bytes", None)
        if per_page is not None:
            try:
                knobs["prefix_page_bytes"] = int(per_page)
            except (TypeError, ValueError):
                pass
            break
    # A live speculative engine advertises its per-token verify cost, so
    # the planner can price spec_tokens moves.
    for engine in spec_engines():
        per_tok = getattr(engine, "spec_token_bytes", None)
        if callable(per_tok):
            try:
                knobs["spec_token_bytes"] = int(per_tok())
            except Exception:  # noqa: BLE001 — pricing is best-effort
                pass
            break
    return knobs


def _apply_dcn_compress(st, value: str) -> None:
    os.environ["HVD_TPU_DCN_COMPRESS"] = value
    # The quantized state (residuals, dither ticks) is per wire format:
    # dropped on every rank at this same stream position.
    from ..ops import megakernel as _megakernel

    _megakernel.flush(f"hvd-tune: dcn compression -> {value}")


def _apply_max_inflight(st, value: int) -> None:
    os.environ["HVD_TPU_MAX_INFLIGHT"] = str(value)
    for window in list(_inflight_windows):
        try:
            window.resize(value)
        except Exception:  # noqa: BLE001 — a dying step must not wedge
            pass           # the cycle


def _apply_fusion_threshold(st, value: int) -> None:
    if st.runtime is None:  # a state with no runtime (tests)
        st.fusion_threshold_bytes = int(value)
        return
    from ..ops import collective as _collective

    # Inside the cycle, which holds cycle_lock: the lock-free helper.
    _collective.apply_fusion_threshold(
        st.runtime, int(value), f"hvd-tune: fusion threshold -> {value}")


def _apply_cycle_time(st, value: float) -> None:
    st.tick_seconds = float(value)


def _apply_spec_tokens(st, value: int) -> None:
    os.environ["HVD_TPU_SPEC_TOKENS"] = str(value)
    for engine in list(_spec_engines):
        try:
            engine.set_spec_tokens(int(value))
        except Exception:  # noqa: BLE001 — a draining engine must not
            pass           # wedge the cycle


def _apply_prefix_pages(st, value: int) -> None:
    # The env feeds the NEXT engine build (the dedicated reserve is fixed
    # at construction); live engines latch the index cap and adopt it at
    # their next iteration: a shrink trims the reclaimable LRU, a grow
    # lifts the cap so later prompts publish into it.
    os.environ["HVD_TPU_PREFIX_PAGES"] = str(value)
    for engine in list(_serving_engines):
        try:
            engine.set_prefix_target(int(value))
        except Exception:  # noqa: BLE001 — a draining engine must not
            pass           # wedge the cycle


_APPLIERS = {
    _policy.KNOB_DCN_COMPRESS: _apply_dcn_compress,
    _policy.KNOB_MAX_INFLIGHT: _apply_max_inflight,
    _policy.KNOB_FUSION_THRESHOLD: _apply_fusion_threshold,
    _policy.KNOB_CYCLE_TIME: _apply_cycle_time,
    _policy.KNOB_SPEC_TOKENS: _apply_spec_tokens,
    _policy.KNOB_PREFIX_PAGES: _apply_prefix_pages,
}


# ---------------------------------------------------------------------------
# Marker construction + apply (the response-stream surface)
# ---------------------------------------------------------------------------

def make_marker(tokens: List[str], seq: int) -> Response:
    """A RETUNE stream marker: ``knob=value`` tokens and the decision
    sequence number every rank logs on apply."""
    return Response(ResponseType.RETUNE, tensor_names=list(tokens),
                    tensor_sizes=[int(seq)])


def apply_marker(resp: Response, st) -> None:
    """Apply one RETUNE marker on THIS rank, at the marker's stream
    position (``Runtime._execute``, every rank).  Malformed tokens are
    skipped with a diagnostic (the cycle must survive anything the wire
    carries); applied tokens count in ``tuning.applied`` and print the
    apply line the multi-rank tests parse."""
    seq = int(resp.tensor_sizes[0]) if resp.tensor_sizes else -1
    applied: List[Tuple[str, object]] = []
    for token in resp.tensor_names:
        knob, _, raw = token.partition("=")
        applier = _APPLIERS.get(knob)
        if applier is None:
            print(f"[hvd-tune] rank {st.rank} skipping unknown retune knob "
                  f"{token!r} (seq={seq})", file=sys.stderr)
            continue
        try:
            value = _parse_value(knob, raw)
            applier(st, value)
        except (TypeError, ValueError) as e:
            print(f"[hvd-tune] rank {st.rank} skipping malformed retune "
                  f"{token!r} (seq={seq}): {e}", file=sys.stderr)
            continue
        applied.append((knob, value))
    if applied:
        _M_APPLIED.inc(len(applied))
        pairs = " ".join(f"{k}={v}" for k, v in applied)
        print(f"[hvd-tune] rank {st.rank} applied seq={seq} {pairs}",
              file=sys.stderr)
    tuner = st.tuner
    if tuner is not None:
        tuner.note_applied(seq, applied)


# ---------------------------------------------------------------------------
# Fleet-coherence telemetry: the env-fingerprint digest gauge
# ---------------------------------------------------------------------------

def env_digest() -> int:
    """Stable 53-bit integer digest of the SPMD env fingerprint
    (``ops/compression.env_fingerprint``): an integer crosses the JSON
    metrics wire exactly."""
    from ..ops import compression as _compression

    h = hashlib.sha256(_compression.env_fingerprint().encode()).digest()
    return int.from_bytes(h[:7], "big") >> 3


def _collect_tuning(reg) -> None:
    """Every rank publishes its fingerprint digest and current knob
    values; the digest rides ``cluster_metrics`` pulls so rank 0's
    controller can verify a retune landed fleet-wide."""
    reg.gauge("tuning.env_digest",
              "53-bit digest of the SPMD env fingerprint").set(env_digest())
    from ..core import state as _state

    st = _state._state
    if not st.initialized:
        return
    knobs = current_knobs(st)
    reg.gauge("tuning.knob.dcn_compress",
              "DCN compression ladder rung (none/bf16/int8/int4)").set(
        _policy.COMPRESSION_LADDER.index(knobs[_policy.KNOB_DCN_COMPRESS])
        if knobs[_policy.KNOB_DCN_COMPRESS] in _policy.COMPRESSION_LADDER
        else -1)
    reg.gauge("tuning.knob.max_inflight",
              "in-flight dispatch window depth").set(
        knobs[_policy.KNOB_MAX_INFLIGHT])
    reg.gauge("tuning.knob.fusion_threshold",
              "tensor-fusion threshold bytes").set(
        knobs[_policy.KNOB_FUSION_THRESHOLD])
    reg.gauge("tuning.knob.cycle_time",
              "background tick period seconds").set(
        knobs[_policy.KNOB_CYCLE_TIME])
    reg.gauge("tuning.knob.spec_tokens",
              "speculative decode depth").set(
        knobs[_policy.KNOB_SPEC_TOKENS])
    reg.gauge("tuning.knob.prefix_pages",
              "dedicated shared-prefix page reserve").set(
        knobs[_policy.KNOB_PREFIX_PAGES])


def install_collector() -> None:
    """Idempotent (keyed) registration: every rank, every init."""
    _telemetry.registry().register_collector("tuning", _collect_tuning)
