"""hvd-tune in horovod_tpu_torch (tuning/, the RETUNE markers on the TCP
cycle, live ``spec_tokens`` and ``prefix_pages``) against horovod_tpu's.

The policy: tests/test_tuning.py's scenarios run on both packages' engines
(that module's globals repointed) and must decide alike, and 200 seeded
random snapshot sequences go through both engines, unpriced and priced by
each package's ``retune_delta_bytes``.  The closed loop of bench.py's
``_tuning_bench`` model must converge alike.  Markers: the wire bytes, the
apply diagnostics, ``env_digest``, ``current_knobs``, ``validate_env`` and
the sensors' differencing are held to the reference's.  The runtime: a
marker applied at a cycle boundary of ``init(device="cpu")``, the threshold
reaching every coordinator from inside the cycle, ``install`` inert without
opt-in, the in-flight window resized live.  Then spawned gloo ranks on the
TCP channel: at np 2 and under the tree at np 3 every rank applies the same
markers at the same stream positions and no cycle that carries one goes
out compact; at np 2 a worker whose env diverged is rolled back
fleet-wide, and a served trace with ``spec_tokens`` and ``prefix_pages``
retunes mid-trace stays bitwise between the follower and rank 0 after
every iteration, its tokens equal to the untuned engine's.  Last, the
cache's ``set_prefix_target`` against the reference's cache on one
sequence of operations.
"""

import gc
import json
import os
import random
import re
import sys
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import test_tuning as R
from horovod_tpu import tuning as ref_tuning
from horovod_tpu.memory.planner import retune_delta_bytes as ref_price
from horovod_tpu.ops import wire as ref_wire
from horovod_tpu.tuning import actuation as ref_act
from horovod_tpu.tuning import policy as ref_policy
from horovod_tpu.tuning import sensors as ref_sensors

from horovod_tpu_torch import tuning as port_tuning
from horovod_tpu_torch.memory.planner import retune_delta_bytes as port_price
from horovod_tpu_torch.ops import wire as port_wire
from horovod_tpu_torch.tuning import actuation as port_act
from horovod_tpu_torch.tuning import policy as port_policy
from horovod_tpu_torch.tuning import sensors as port_sensors

PKGS = {"reference": (ref_policy, ref_price),
        "port": (port_policy, port_price)}


# ---------------------------------------------------------------------------
# Policy: the reference's scenarios and seeded sequences on both engines
# ---------------------------------------------------------------------------

SCENARIOS = [
    "test_dcn_rule_fires_exactly_once_per_sustained_diagnosis",
    "test_dcn_ladder_climbs_one_rung_per_decision",
    "test_hysteresis_boundary_flapping_never_fires",
    "test_planner_veto_counts_and_leaves_knob_untouched",
    "test_cheap_candidate_passes_the_priced_veto",
    "test_straggler_rule_rebuckets_after_persistence",
    "test_straggler_rank_change_resets_persistence",
    "test_low_acceptance_shrinks_spec_tokens_to_floor",
    "test_prefix_reserve_grows_under_kv_pressure_with_hot_index",
    "test_prefix_reserve_shrinks_when_index_goes_cold",
    "test_prefix_rules_idle_in_dead_band_and_without_signal",
    "test_prefix_grow_is_planner_priced",
    "test_headroom_pressure_outranks_speed_rules",
    "test_pinned_knob_is_never_touched",
    "test_decision_sequence_is_deterministic",
]


def _summary(eng):
    return ([(d.seq, d.window, d.knob, d.value, d.reason)
             for d in eng.decisions], eng.vetoes, list(eng.veto_log))


def _run_scenario(monkeypatch, name, policy):
    """One scenario of tests/test_tuning.py with its globals pointed at
    ``policy``'s classes; returns every engine it built, summarised."""
    built = []

    class Recorded(policy.PolicyEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

    for attr in ("PolicyConfig", "WindowSnapshot", "COMPRESSION_LADDER",
                 "KNOB_DCN_COMPRESS", "KNOB_FUSION_THRESHOLD",
                 "KNOB_MAX_INFLIGHT", "KNOB_PREFIX_PAGES",
                 "KNOB_SPEC_TOKENS"):
        monkeypatch.setattr(R, attr, getattr(policy, attr))
    monkeypatch.setattr(R, "PolicyEngine", Recorded)
    monkeypatch.setattr(R, "tuning_policy", policy)
    getattr(R, name)()
    return [_summary(e) for e in built]


@pytest.mark.parametrize("name", SCENARIOS)
def test_reference_scenarios_pass_on_the_port_and_decide_alike(
        monkeypatch, name):
    port = _run_scenario(monkeypatch, name, port_policy)
    ref = _run_scenario(monkeypatch, name, ref_policy)
    assert port and port == ref


def _random_snapshot(rng, policy, index, knobs):
    profiles = (R.FLAT_LEGS, R.DCN_LEGS, R.GAP_LEGS, {})
    legs = {k: v * rng.uniform(0.5, 1.5)
            for k, v in rng.choice(profiles).items()}
    return policy.WindowSnapshot(
        index=index, legs=legs, knobs=dict(knobs),
        straggler_rank=rng.choice((-1, -1, 1, 2)),
        spec_acceptance=rng.choice((-1.0, rng.uniform(0.0, 1.0))),
        headroom_frac=rng.choice((-1.0, rng.uniform(0.0, 0.3),
                                  rng.uniform(0.3, 1.0))),
        headroom_bytes=rng.choice((-1, rng.randrange(1 << 12, 1 << 24),
                                   rng.randrange(1 << 24, 1 << 34))),
        prefix_hit_rate=rng.choice((-1.0, rng.uniform(0.0, 0.1),
                                    rng.uniform(0.4, 1.0))),
        kv_free_frac=rng.choice((-1.0, rng.uniform(0.0, 0.3),
                                 rng.uniform(0.3, 1.0))))


def _random_run(seed, pkg, priced):
    """One seeded sequence of 40 windows through ``pkg``'s engine; the
    decisions are applied to the knobs, as the fleet would."""
    policy, price = PKGS[pkg]
    rng = random.Random(seed)
    cfg = policy.PolicyConfig(
        sustain=rng.randint(1, 3), cooldown=rng.randint(0, 3),
        pinned=frozenset(rng.sample(policy.KNOB_NAMES, rng.randint(0, 2))))
    eng = policy.PolicyEngine(
        cfg, price=(lambda knob, old, new, s: price(knob, old, new, s.knobs))
        if priced else None)
    knobs = {"dcn_compress": rng.choice(policy.COMPRESSION_LADDER),
             "max_inflight": rng.choice((1, 2, 4, 8)),
             "fusion_threshold": rng.choice((1 << 20, 8 << 20, 64 << 20)),
             "cycle_time": 0.005, "spec_tokens": rng.randint(1, 6),
             "prefix_pages": rng.choice((0, 8, 64)),
             "spec_token_bytes": rng.choice((0, 4096)),
             "prefix_page_bytes": rng.choice((0, 1 << 20))}
    for i in range(40):
        d = eng.step(_random_snapshot(rng, policy, i, knobs))
        if d is not None:
            knobs[d.knob] = d.value
    return _summary(eng), knobs


@pytest.mark.parametrize("priced", [False, True])
def test_random_snapshot_sequences_decide_alike(priced):
    fired = vetoed = 0
    for seed in range(200):
        port = _random_run(seed, "port", priced)
        assert port == _random_run(seed, "reference", priced), seed
        fired += len(port[0][0])
        vetoed += port[0][1]
    assert fired > 100  # the sequences exercise the rules
    assert vetoed > 0 if priced else vetoed == 0


@pytest.mark.parametrize("knob", ["fusion_threshold", "max_inflight",
                                  "spec_tokens", "prefix_pages",
                                  "dcn_compress", "cycle_time"])
def test_retune_delta_bytes_is_the_references(knob):
    knobs = {"fusion_threshold": 4 << 20, "spec_token_bytes": 1024,
             "prefix_page_bytes": 3 << 10}
    for old, new in ((1, 2), (8, 4), (0, 16), ("none", "int8"),
                     (None, 3), (0.004, 0.002)):
        assert port_price(knob, old, new, knobs) == \
            ref_price(knob, old, new, knobs), (old, new)


# bench.py:2140 _tuning_bench's fleet model, its constants copied.
COMPUTE_MS = 10.0
DCN_MS = {"none": 60.0, "bf16": 30.0, "int8": 14.0, "int4": 11.0}
GAP_MS = {1: 40.0, 2: 24.0, 4: 14.0, 8: 2.0}
ACCEPTANCE = 0.3
SPEC_MS_PER_MISS = 0.9
MIS_TUNED = {"dcn_compress": "none", "max_inflight": 1,
             "fusion_threshold": 64 << 20, "cycle_time": 0.005,
             "spec_tokens": 6}


def _closed_loop(pkg, windows=80):
    policy, price = PKGS[pkg]

    def step_ms(k):
        return (COMPUTE_MS + DCN_MS[k["dcn_compress"]]
                + GAP_MS[k["max_inflight"]]
                + SPEC_MS_PER_MISS * k["spec_tokens"] * (1.0 - ACCEPTANCE))

    def legs_of(k):
        return {"dispatch": COMPUTE_MS * 1e3,
                "dcn": DCN_MS[k["dcn_compress"]] * 1e3,
                "dispatch-gap": GAP_MS[k["max_inflight"]] * 1e3,
                "host": 1e3}

    knobs = dict(MIS_TUNED)
    eng = policy.PolicyEngine(price=lambda knob, old, new, s:
                              price(knob, old, new, s.knobs))
    decisions = []
    for w in range(windows):
        d = eng.step(policy.WindowSnapshot(
            index=w, legs=legs_of(knobs), knobs=dict(knobs),
            spec_acceptance=ACCEPTANCE, headroom_frac=0.5,
            headroom_bytes=8 << 30))
        if d is not None:
            knobs[d.knob] = d.value
            decisions.append((d.seq, d.window, d.knob, str(d.value)))
    return knobs, decisions, step_ms(knobs), step_ms(MIS_TUNED)


def test_closed_loop_bench_model_converges_as_the_reference():
    port = _closed_loop("port")
    assert port == _closed_loop("reference")
    knobs, decisions, tuned_ms, mis_ms = port
    assert (knobs["dcn_compress"], knobs["max_inflight"],
            knobs["spec_tokens"]) == ("int4", 8, 1)
    assert mis_ms / tuned_ms >= 1.5 and len(decisions) >= 3


# ---------------------------------------------------------------------------
# validate_env, markers, knobs, sensors
# ---------------------------------------------------------------------------

ENVS = [  # (environment, valid)
    ({}, True),
    ({"HVD_TPU_TUNE": "1", "HVD_TPU_TUNE_WINDOW": "8",
      "HVD_TPU_TUNE_PIN": "dcn_compress; spec_tokens"}, True),
    ({"HVD_TPU_TUNE": "yes"}, False),
    ({"HVD_TPU_TUNE_WINDOW": "soon"}, False),
    ({"HVD_TPU_TUNE_WINDOW": "0"}, False),
    ({"HVD_TPU_TUNE_PIN": "dcn_compress,flux_capacitor"}, False),
]


@pytest.mark.parametrize("env,valid", ENVS, ids=range(len(ENVS)))
def test_validate_env_says_what_the_reference_says(monkeypatch, env, valid):
    for k in ("HVD_TPU_TUNE", "HVD_TPU_TUNE_WINDOW", "HVD_TPU_TUNE_PIN"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    said = []
    for mod in (port_tuning, ref_tuning):
        try:
            mod.validate_env()
            said.append(None)
        except ValueError as e:
            said.append(str(e))
    assert said[0] == said[1]
    assert (said[0] is None) == valid


@pytest.mark.parametrize("tokens,seq", [
    (["dcn_compress=int8", "max_inflight=4"], 0),
    (["fusion_threshold=2097152", "cycle_time=0.004"], 7),
    (["spec_tokens=2"], 41), (["prefix_pages=0"], 1 << 20)])
def test_a_retune_marker_is_the_references_on_the_wire(tokens, seq):
    port = port_wire.pack_response_list([port_act.make_marker(tokens, seq)])
    assert port == ref_wire.pack_response_list(
        [ref_act.make_marker(tokens, seq)])
    (back,) = port_wire.unpack_response_list(port)
    assert back.response_type == port_wire.ResponseType.RETUNE
    assert (list(back.tensor_names), list(back.tensor_sizes)) == \
        (tokens, [seq])


def _fake_state(rank=0):
    return SimpleNamespace(rank=rank, process_index=rank, tuner=None,
                           multiprocess=False, transport=None, runtime=None,
                           coordinator=None, response_cache=None,
                           fusion_threshold_bytes=64 << 20,
                           tick_seconds=0.005)


def test_apply_marker_skips_malformed_tokens_as_the_reference(
        monkeypatch, capfd):
    monkeypatch.setenv("HVD_TPU_DCN_COMPRESS", "none")
    marker = ["dcn_compress=bogus", "flux=1", "max_inflight=0",
              "cycle_time=0.004", "prefix_pages=-2"]
    lines, states = [], []
    for act in (port_act, ref_act):
        st = _fake_state()
        act.apply_marker(act.make_marker(marker, 5), st)
        states.append((st.tick_seconds, os.environ["HVD_TPU_DCN_COMPRESS"]))
        lines.append(capfd.readouterr().err.splitlines())
    assert states[0] == states[1] == (0.004, "none")
    # The compression name's own error text is each package's.
    strip = [[re.sub(r"'dcn_compress=bogus' \(seq=5\): .*",
                     "'dcn_compress=bogus' (seq=5)", ln) for ln in ls]
             for ls in lines]
    assert strip[0] == strip[1]
    assert "[hvd-tune] rank 0 applied seq=5 cycle_time=0.004" in lines[0]
    assert "[hvd-tune] rank 0 skipping unknown retune knob 'flux=1' " \
        "(seq=5)" in lines[0]


@pytest.mark.parametrize("env", [
    {}, {"HVD_TPU_DCN_COMPRESS": "int8", "HVD_TPU_MAX_INFLIGHT": "4",
         "HVD_TPU_SPEC_TOKENS": "2", "HVD_TPU_PREFIX_PAGES": "16"},
    {"HVD_TPU_COMPRESSION": "bf16", "HVD_TPU_MAX_INFLIGHT": "x",
     "HVD_TPU_QUANT_BLOCK": "128", "HVD_TPU_OVERLAP": "on"}],
    ids=["unset", "knobs", "fingerprint"])
def test_env_digest_and_current_knobs_are_the_references(monkeypatch, env):
    for k in ("HVD_TPU_DCN_COMPRESS", "HVD_TPU_COMPRESSION",
              "HVD_TPU_MAX_INFLIGHT", "HVD_TPU_SPEC_TOKENS",
              "HVD_TPU_PREFIX_PAGES"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert port_act.env_digest() == ref_act.env_digest()
    gc.collect()  # engines of other tests must not advertise page bytes
    st = _fake_state()
    port = port_act.current_knobs(st)
    ref = ref_act.current_knobs(st)
    assert {k: port[k] for k in port_policy.KNOB_NAMES} == \
        {k: ref[k] for k in ref_policy.KNOB_NAMES}


def _span(cat, ts, dur, step, cycle, name="x"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": 0, "args": {"step": step, "cycle": cycle}}


SPAN_WINDOWS = [
    [_span("host", 0, 100, 0, 0), _span("negotiate", 100, 50, 0, 0)],
    [_span("host", 0, 100, 0, 0), _span("negotiate", 100, 50, 0, 0),
     _span("host", 400, 80, 1, 1), _span("serving", 500, 30, 1, 1)],
    # The bounded buffer dropped the oldest spans: totals went down.
    [_span("serving", 500, 30, 1, 1), _span("host", 900, 10, 2, 2)],
    [_span("serving", 500, 30, 1, 1), _span("host", 900, 10, 2, 2),
     _span("negotiate", 950, 5, 2, 2)],
]


def test_sensor_differencing_is_the_references(monkeypatch):
    from horovod_tpu import trace as ref_trace
    from horovod_tpu_torch import trace as port_trace

    got = []
    for trace, sensors in ((port_trace, port_sensors),
                           (ref_trace, ref_sensors)):
        feed = iter(SPAN_WINDOWS)
        monkeypatch.setattr(trace, "export_events", lambda: next(feed))
        agg = sensors.WindowAggregator(_fake_state())
        got.append([agg._window_legs() for _ in SPAN_WINDOWS])
    assert got[0] == got[1]
    legs = got[0]
    assert legs[1]["host"] == 80.0 and legs[1]["negotiate"] == 0.0
    assert legs[2]["host"] == 10.0  # absolute: a total went down
    assert legs[3]["negotiate"] == 5.0
    assert all(v >= 0 for w in legs for v in w.values())


@pytest.mark.parametrize("chunk", range(4))
def test_window_legs_are_the_references_on_random_spans(chunk):
    """The port finds a dispatch's launches through the launches sorted by
    start (the sensors decompose the whole span buffer every window); the
    legs and the whole analysis stay the reference's floats, nested,
    overlapping, zero-length and backwards spans included."""
    from horovod_tpu.trace import analyze as ref_analyze
    from horovod_tpu_torch.trace import analyze as port_analyze

    for seed in range(chunk * 50, chunk * 50 + 50):
        rng = random.Random(seed)
        events = []
        for _ in range(rng.randint(0, 120)):
            cat = rng.choice(("collective", "collective", "dispatch",
                              "negotiate", "host", "pack", "serving"))
            ev = _span(cat, rng.choice((rng.uniform(0, 1000),
                                        10.0 * rng.randint(0, 50))),
                       rng.choice((rng.uniform(0, 200), 0.0,
                                   10.0 * rng.randint(0, 10),
                                   -rng.uniform(0, 5))),
                       rng.randint(0, 3), rng.randint(0, 5))
            if cat == "collective" and rng.random() < 0.3:
                ev["args"].update(wire_bytes=rng.randint(1, 100),
                                  dcn_bytes=rng.randint(0, 100))
            events.append(ev)
        assert port_analyze.window_legs(events) == \
            ref_analyze.window_legs(events), seed
        assert port_analyze.analyze(events) == ref_analyze.analyze(events)


def test_prefix_sensor_differencing_is_the_references(monkeypatch):
    from horovod_tpu import telemetry as ref_tel
    from horovod_tpu_torch import telemetry as port_tel

    def snap(prefills, hits, draft, free, total=100):
        return {"serving.prefills": {"value": prefills},
                "serving.prefix_hits": {"value": hits},
                "serving.prefix_hits_draft": {"value": draft},
                "serving.kv_free_pages": {"value": free},
                "serving.kv_total_pages": {"value": total}}

    feed = [snap(4, 2, 1, 50), snap(10, 8, 2, 20), snap(10, 8, 2, 20),
            snap(3, 1, 0, 90), None]
    got = []
    for tel, sensors in ((port_tel, port_sensors), (ref_tel, ref_sensors)):
        it = iter(feed)
        reg = SimpleNamespace(snapshot=lambda: next(it) or {})
        monkeypatch.setattr(tel, "registry", lambda: reg)
        agg = sensors.WindowAggregator(_fake_state())
        got.append([agg._prefix() for _ in feed])
    assert got[0] == got[1]
    assert got[0][1] == (7 / 6, 0.2) and got[0][2] == (-1.0, 0.2)
    assert got[0][3] == (1 / 3, 0.9) and got[0][4] == (-1.0, -1.0)


# ---------------------------------------------------------------------------
# The runtime, one rank on the CPU
# ---------------------------------------------------------------------------

def _drive_until_applied(hvd, st, seq, deadline_s=20.0):
    deadline = time.monotonic() + deadline_s
    i = 0
    while st.tuner._applied_seq < seq and time.monotonic() < deadline:
        hvd.allreduce(torch.ones(4), name=f"tune.drive.{i}", op=hvd.Sum)
        i += 1
    assert st.tuner._applied_seq >= seq, "marker was never applied"


@pytest.fixture()
def tuned(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import state as _state

    monkeypatch.setenv("HVD_TPU_TUNE", "1")
    monkeypatch.setenv("HVD_TPU_DCN_COMPRESS", "none")
    monkeypatch.setenv("HVD_TPU_MAX_INFLIGHT", "2")
    hvd.init(device="cpu")
    try:
        yield hvd, _state._state
    finally:
        hvd.shutdown()


def test_retune_marker_applies_at_a_cycle_boundary(tuned, capfd):
    hvd, st = tuned
    from horovod_tpu_torch import telemetry

    assert st.tuner is not None and st.tuner is st.autotuner
    seq = st.tuner._enqueue(["dcn_compress=int8", "max_inflight=4"])
    _drive_until_applied(hvd, st, seq)
    assert os.environ["HVD_TPU_DCN_COMPRESS"] == "int8"
    assert os.environ["HVD_TPU_MAX_INFLIGHT"] == "4"
    assert telemetry.metrics()["tuning.applied"]["value"] >= 2
    assert f"[hvd-tune] rank 0 applied seq={seq} dcn_compress=int8 " \
           f"max_inflight=4" in capfd.readouterr().err.splitlines()


def test_threshold_marker_reaches_every_coordinator(tuned):
    """The applier runs inside the cycle, which holds cycle_lock: the
    threshold must reach the global set's coordinator and a process
    set's with no second take of the lock (a deadlock would leave the
    driving thread alive)."""
    from horovod_tpu_torch.ops import collective as TC

    hvd, st = tuned
    ps = hvd.add_process_set([0])
    seq = st.tuner._enqueue(["fusion_threshold=3145728",
                             "cycle_time=0.004"])
    done = []
    t = threading.Thread(target=lambda: done.append(
        _drive_until_applied(hvd, st, seq)), daemon=True)
    t.start()
    t.join(30)
    assert done, "the cycle deadlocked applying the threshold"
    coords = st.runtime._coordinators()
    assert len(coords) == 2
    assert [c.fusion_threshold for c in coords] == [3145728] * 2
    assert st.fusion_threshold_bytes == 3145728
    assert st.tick_seconds == pytest.approx(0.004)
    TC.set_fusion_threshold(1 << 20)  # the public path still works
    assert [c.fusion_threshold for c in coords] == [1 << 20] * 2
    hvd.remove_process_set(ps)


def test_install_is_inert_without_opt_in(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import telemetry
    from horovod_tpu_torch.core import state as _state

    monkeypatch.delenv("HVD_TPU_TUNE", raising=False)
    monkeypatch.delenv("HOROVOD_AUTOTUNE", raising=False)
    hvd.init(device="cpu")
    try:
        assert _state._state.tuner is None
        assert _state._state.autotuner is None
        # Every rank publishes its digest all the same.
        assert telemetry.metrics()["tuning.env_digest"]["value"] == \
            port_act.env_digest()
    finally:
        hvd.shutdown()


def test_init_fails_on_a_mistyped_tuning_knob(monkeypatch):
    import horovod_tpu_torch as hvd

    monkeypatch.setenv("HVD_TPU_TUNE_PIN", "flux_capacitor")
    with pytest.raises(ValueError, match="flux_capacitor"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def test_inflight_window_resize_takes_effect_live(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import state as _state
    from horovod_tpu_torch.parallel import overlap

    monkeypatch.delenv("HVD_TPU_MAX_INFLIGHT", raising=False)
    assert overlap._max_inflight() == 2
    monkeypatch.setenv("HVD_TPU_MAX_INFLIGHT", "5")
    assert overlap._max_inflight() == 5
    hvd.init(device="cpu")
    try:
        stats = {"overlap.host_stall_seconds": 0.0}
        w = overlap._InflightWindow(4, stats)
        assert w in list(port_act._inflight_windows)
        rt = _state._state.runtime
        for i in range(3):
            w.admit([hvd.allreduce_async(torch.ones(2), name=f"w.{i}",
                                         op=hvd.Sum)])
        assert len(w._q) == 3
        port_act._apply_max_inflight(None, 1)
        assert w._depth == 1
        assert os.environ["HVD_TPU_MAX_INFLIGHT"] == "1"
        w.admit([hvd.allreduce_async(torch.ones(2), name="w.3",
                                     op=hvd.Sum)])
        assert len(w._q) == 1  # the shrink waited down to the new depth
        for hs in w._q:
            for h in hs:
                assert rt.handles.get(h).name == "w.3"
                hvd.synchronize(h)
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# Spawned ranks on the TCP channel
# ---------------------------------------------------------------------------

WORKER = r"""
import hashlib
import json
import os

from horovod_tpu_torch.core import state as S
from horovod_tpu_torch.models.transformer import TransformerConfig
from horovod_tpu_torch.serving import InferenceEngine
from horovod_tpu_torch.ops.wire import ResponseType
from horovod_tpu_torch.tuning import Tuner, actuation, policy
from serving_pressure import pool_state

st = S._state
rt = st.runtime
out = {}

# Every response this rank executes, in stream order.
stream = []
execute = rt._execute


def recording(resp, tl=None):
    kind = resp.response_type.name
    seq = int(resp.tensor_sizes[0]) if kind == "RETUNE" else -1
    stream.append((len(stream), kind, seq, list(resp.tensor_names)))
    return execute(resp, tl)


rt._execute = recording
cycles = []  # rank 0: (cycle carries a marker, went as the compact payload)
if RANK == 0:
    negotiate = rt._negotiate

    def negotiating(batches):
        got = negotiate(batches)
        responses, groups, epoch, compact, n_other, _ = got
        if responses:
            cycles.append((any(r.response_type == ResponseType.RETUNE
                               for r in responses),
                           bool(compact and groups and n_other == 0)))
        return got

    rt._negotiate = negotiating
    st.tuner = st.autotuner = Tuner(st)
elif N == 2:
    # Part 2's diverging worker, in place before any marker can reach it:
    # a bf16 retune lands here as int4.
    real = actuation._APPLIERS["dcn_compress"]

    def diverging(s, value):
        real(s, "int4" if value == "bf16" else value)

    actuation._APPLIERS["dcn_compress"] = diverging

# Part 1: markers among named allreduces the cache replays.
MARKERS = {5: ["dcn_compress=int8", "max_inflight=4"],
           12: ["cycle_time=0.004"], 20: ["fusion_threshold=1048576"]}
for step in range(30):
    if RANK == 0 and step in MARKERS:
        st.tuner._enqueue(MARKERS[step])
    hs = hvd.grouped_allreduce_async(
        [torch.full((4,), float(RANK + step)), torch.ones(3, dtype=torch.int32)],
        op=hvd.Sum, name="tune.step")
    for h in hs:
        hvd.synchronize(h)
out["stream"] = np.frombuffer(json.dumps(stream).encode(), np.uint8)
out["knobs"] = np.frombuffer(json.dumps(
    [os.environ["HVD_TPU_DCN_COMPRESS"], os.environ["HVD_TPU_MAX_INFLIGHT"],
     st.tick_seconds, st.fusion_threshold_bytes]).encode(), np.uint8)
# Every rank has taken its snapshot before rank 0 goes on (to a marker of
# the next part, or to the shutdown, whose responses would land in a
# slower rank's stream first).
hvd.allreduce(torch.ones(1), op=hvd.Sum, name="tune.snapshot")
if RANK == 0:
    out["cycles"] = np.asarray(cycles, np.int64)


def drive_until(done_on_rank0, seconds=60.0):
    '''Steps until rank 0 says stop, or its time is up (the flag rides
    the allreduce).'''
    t_end = time.monotonic() + seconds
    while True:
        flag = float(RANK == 0 and (done_on_rank0()
                                    or time.monotonic() > t_end))
        total = hvd.allreduce(torch.tensor([flag]), op=hvd.Sum,
                              name="tune.flag")
        if float(total[0]) > 0:
            return


if N == 2:
    # Part 2: a worker whose env diverges is rolled back fleet-wide.
    if RANK == 0:
        tuner = Tuner(st, closed_loop=True, window_ticks=2,
                      policy_config=policy.PolicyConfig(
                          pinned=frozenset(policy.KNOB_NAMES)))
        st.tuner = st.autotuner = tuner
        seq = tuner._enqueue(["dcn_compress=bf16"],
                             undo=[("dcn_compress", "int8")])
    from horovod_tpu_torch import telemetry

    def rolled_back():
        return (telemetry.metrics()["tuning.rollbacks"]["value"] >= 1
                and tuner._applied_seq > seq)

    drive_until(rolled_back)
    # More windows: the fleet agrees again, no second rollback.
    drive_until(lambda: False, seconds=0.5)
    out["rollbacks"] = np.asarray(
        telemetry.metrics().get("tuning.rollbacks", {}).get("value", 0))
    out["dcn_after"] = np.frombuffer(
        os.environ["HVD_TPU_DCN_COMPRESS"].encode(), np.uint8)
    if RANK == 1:
        actuation._APPLIERS["dcn_compress"] = real

    # Part 3: a served trace, spec_tokens and prefix_pages retuned
    # mid-trace; the ranks' pools agree after every iteration.
    cfg = TransformerConfig(**json.loads(sys.argv[6]))
    dcfg = TransformerConfig(**json.loads(sys.argv[7]))
    eng = InferenceEngine(tree("target", False), cfg, device="cpu",
                          max_slots=3, page_size=8, capacity=32,
                          draft=(tree("draft", False), dcfg), spec_tokens=3)
    eng.warm_start()
    depths = []  # (iteration, depth after it, depth its programs used)
    dispatch = eng._spec_dispatch
    it = [0, 0]

    def spec_dispatch(slots):
        it[1] = eng.spec_tokens
        return dispatch(slots)

    eng._spec_dispatch = spec_dispatch

    def digest():
        h = hashlib.sha256()
        for c in (eng.cache, eng.draft_cache):
            h.update(c.k_pages.numpy().tobytes())
            h.update(c.v_pages.numpy().tobytes())
            h.update(repr(pool_state(c)).encode())
        live = eng.cache._lengths >= 0
        h.update(np.where(live, eng._last_token, -1).tobytes())
        h.update(repr(eng.cache._prefix_target).encode())
        return h.hexdigest()

    def agree():
        both = [None] * N
        dist.all_gather_object(both, digest())
        return both[0] == both[1]

    RETUNES = {2: ["spec_tokens=2"], 4: ["prefix_pages=1"],
               7: ["spec_tokens=1", "prefix_pages=8"]}
    iters = agreed = 0
    if RANK == 0:
        header = list(range(10, 26))
        prompts = [header + [1, 2], [3, 4, 5], header + [7],
                   [8, 9, 10, 11], header + [30, 31], [12, 13]]
        reqs = [eng.submit(p, max_new_tokens=n)
                for p, n in zip(prompts, (8, 5, 6, 1, 7, 4))]
        while not eng.scheduler.idle():
            if iters in RETUNES:
                st.tuner._enqueue(RETUNES[iters])
            it[1] = None
            eng.step()
            depths.append((iters, eng.spec_tokens, it[1]))
            iters += 1
            agreed += agree()
        out["tokens"] = np.asarray([t for r in reqs for t in r.result(0)])
        eng.stop_followers()
    else:
        while True:
            it[1] = None
            if not eng.follow():
                break
            depths.append((iters, eng.spec_tokens, it[1]))
            iters += 1
            agreed += agree()
    out["iters"] = np.asarray(iters)
    out["agreed"] = np.asarray(agreed)
    out["depths"] = np.frombuffer(json.dumps(depths).encode(), np.uint8)
    out["final"] = np.frombuffer(json.dumps(
        [eng.spec_tokens, eng.cache._prefix_target,
         eng.cache.prefix_stats()["cached_pages"]]).encode(), np.uint8)
finish(out)
"""


def _spawn(tmp, n, env, data):
    import subprocess

    from gloo_job import PRELUDE, REPO, GlooJob
    from torch_serving_cases import DRAFT_SMALL, SMALL

    job = GlooJob.__new__(GlooJob)
    job.tmp, job.n, job.timeout = tmp, n, 300
    np.savez(tmp / "data.npz", **data)
    script = tmp / "worker.py"
    script.write_text(PRELUDE + "import time\n" + WORKER)
    full = {**os.environ, **env, "PYTHONPATH": os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep))}
    for k in ("RANK", "WORLD_SIZE", "HVD_TPU_METRICS_PORT", "HVD_TPU_TUNE",
              "HOROVOD_AUTOTUNE", "HVD_TPU_DCN_COMPRESS",
              "HVD_TPU_MAX_INFLIGHT", "HOROVOD_FUSION_THRESHOLD"):
        full.pop(k, None)
    full.update(env)
    job.procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp / "store"),
         str(tmp / "data.npz"), str(tmp / f"out{r}.npz"), str(n),
         json.dumps(SMALL), json.dumps(DRAFT_SMALL)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=full) for r in range(n)]
    return job


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """np 2 flat and np 3 under the tree (fanout 1: a chain), started
    together."""
    from gloo_job import flat
    from torch_serving_cases import DRAFT_R, PARAMS_R

    data = {**flat(jax.tree_util.tree_map(np.asarray, PARAMS_R), "target"),
            **flat(jax.tree_util.tree_map(np.asarray, DRAFT_R), "draft")}
    started = {
        2: _spawn(tmp_path_factory.mktemp("tune2"), 2,
                  {"HVD_TPU_TREE": "off"}, data),
        3: _spawn(tmp_path_factory.mktemp("tune3"), 3,
                  {"HVD_TPU_TREE": "on", "HVD_TPU_TREE_FANOUT": "1"}, data)}
    try:
        return {n: job.results() for n, job in started.items()}
    finally:
        for job in started.values():
            job.kill()


def _text(arr):
    return json.loads(bytes(arr).decode())


@pytest.mark.parametrize("n", [2, 3])
def test_every_rank_applies_the_markers_at_the_same_stream_position(
        jobs, n):
    outs = jobs[n]
    streams = [_text(o["stream"]) for o in outs]
    for s in streams[1:]:
        assert s == streams[0]
    marks = [(pos, seq, names) for pos, kind, seq, names in streams[0]
             if kind == "RETUNE"]
    assert [(seq, names) for _, seq, names in marks] == [
        (0, ["dcn_compress=int8", "max_inflight=4"]),
        (1, ["cycle_time=0.004"]), (2, ["fusion_threshold=1048576"])]
    knobs = [_text(o["knobs"]) for o in outs]
    assert all(k == ["int8", "4", 0.004, 1048576] for k in knobs), knobs
    cycles = outs[0]["cycles"]
    # No cycle that carries a marker went as the compact payload, and
    # the replayed steps did go compact.
    assert not any(m and c for m, c in cycles)
    assert sum(m for m, _ in cycles) == 3
    assert sum(c for _, c in cycles) >= 10


def test_a_diverged_worker_is_rolled_back_fleet_wide(jobs):
    outs = jobs[2]
    assert int(outs[0]["rollbacks"]) == 1
    assert [bytes(o["dcn_after"]).decode() for o in outs] == ["int8"] * 2
    # The rollback marker is in both ranks' streams, after the retune.
    streams = [_text(o["stream"]) for o in outs]
    assert streams[0] == streams[1]


def test_a_served_trace_retuned_mid_trace_stays_bitwise(jobs):
    from torch_serving_cases import DRAFT, DRAFT_CFG, make_engine

    outs = jobs[2]
    iters = int(outs[0]["iters"])
    assert iters > 8
    assert int(outs[1]["iters"]) == iters
    assert int(outs[0]["agreed"]) == int(outs[1]["agreed"]) == iters
    for o in outs:
        depths = _text(o["depths"])
        # The programs of an iteration ran at the depth it ended with: a
        # marker applied mid-iteration waited for the next one.
        assert all(used in (None, after) for _, after, used in depths)
    d0 = _text(outs[0]["depths"])
    assert d0 == _text(outs[1]["depths"])
    # Enqueued before iteration 2, applied inside it, adopted by 3.
    assert [a for _, a, _ in d0][:4] == [3, 3, 3, 2] and d0[-1][1] == 1
    assert _text(outs[0]["final"]) == _text(outs[1]["final"])
    assert _text(outs[0]["final"])[:2] == [1, 8]
    # Tokens equal the untuned single-process engine's.
    eng = make_engine(draft=(DRAFT, DRAFT_CFG), spec_tokens=3)
    header = list(range(10, 26))
    prompts = [header + [1, 2], [3, 4, 5], header + [7], [8, 9, 10, 11],
               header + [30, 31], [12, 13]]
    reqs = [eng.submit(p, max_new_tokens=n)
            for p, n in zip(prompts, (8, 5, 6, 1, 7, 4))]
    eng.run_until_idle()
    assert outs[0]["tokens"].tolist() == [t for r in reqs
                                          for t in r.result(0)]


# ---------------------------------------------------------------------------
# The cache's live prefix target against the reference's cache
# ---------------------------------------------------------------------------

def test_set_prefix_target_leaves_the_references_pool():
    from horovod_tpu.serving.kv_cache import PagedKVCache as RefCache
    from horovod_tpu_torch.serving.kv_cache import PagedKVCache as PortCache

    kw = dict(n_layers=1, n_heads=2, head_dim=4, max_slots=3,
              pages_per_slot=4, page_size=4, prefix_cache=True,
              prefix_pages=2, fingerprint="fp")
    caches = [PortCache(device="cpu", gauges=False, **kw), RefCache(**kw)]
    a, b = list(range(1, 15)), list(range(1, 9)) + [40, 41, 42, 43, 44]
    ops = [("begin", 0, a), ("publish", 0, a), ("begin", 1, b),
           ("publish", 1, b), ("free", 0), ("target", 2), ("free", 1),
           ("target", 1), ("begin", 2, a), ("publish", 2, a),
           ("target", 6), ("publish", 2, a), ("free", 2), ("target", 0),
           ("begin", 0, b), ("publish", 0, b), ("target", None),
           ("publish", 0, b), ("free", 0)]

    def pool(c):
        return (list(c._free), list(c._lru), list(c._index.items()),
                sorted(c._refcount.items()), c._table.tolist(),
                c._lengths.tolist())

    for op in ops:
        got = []
        for c in caches:
            if op[0] == "begin":
                c.begin_slot(op[1], len(op[2]),
                             prefix_pages=c.lookup_prefix(op[2]))
                got.append(None)
            elif op[0] == "publish":
                got.append(c.publish_prefix(op[1], op[2]))
            elif op[0] == "free":
                got.append(c.free_slot(op[1]))
            else:
                got.append(c.set_prefix_target(op[1]))
        assert got[0] == got[1], op
        assert pool(caches[0]) == pool(caches[1]), op
    assert caches[0]._prefix_target is None
