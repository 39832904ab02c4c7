"""hvd-chaos in the port (``horovod_tpu_torch/chaos/``) held against the
reference's (``horovod_tpu/chaos/``): every case of tests/test_chaos.py
whose site the port hosts (the grammar and its errors, determinism, the
filters, ``maybe_reorder``, the checkpoint writer's retries and their
exhaustion, the input stall, the client probe, the matrix's shape and
digest), the same spec and seed firing the same sequence in both
packages at every site, the coordinator sites in a live runtime, and the
matrix's coverage: every site is hosted by a port scenario or named as
waiting with the step that brings it.
"""

import glob
import json
import random
import socket
import time

import numpy as np
import pytest
import torch

import horovod_tpu.chaos as ref_chaos
import horovod_tpu_torch as thvd
import horovod_tpu_torch.chaos as chaos
from horovod_tpu.chaos import spec as ref_spec
from horovod_tpu_torch.chaos import matrix
from horovod_tpu_torch.chaos import spec as chaos_spec
from horovod_tpu_torch.telemetry import flight as port_flight
from horovod_tpu_torch.utils import checkpoint as ck


@pytest.fixture()
def chaos_env(monkeypatch):
    """Arm HVD_TPU_FAULTS for a test and always restore the unarmed
    state of both packages afterwards."""

    def arm(spec_text):
        monkeypatch.setenv("HVD_TPU_FAULTS", spec_text)
        return chaos.reload()

    yield arm
    monkeypatch.delenv("HVD_TPU_FAULTS", raising=False)
    chaos.reload()
    ref_chaos.reload()


@pytest.fixture(params=["port", "reference"])
def spec_mod(request):
    return chaos_spec if request.param == "port" else ref_spec


# ---------------------------------------------------------------------------
# Grammar and determinism (the replay contract), on both packages
# ---------------------------------------------------------------------------

def test_the_spec_module_is_the_references():
    assert chaos_spec.VALID_SITES == ref_spec.VALID_SITES
    assert chaos_spec._DEFAULT_DELAY == ref_spec._DEFAULT_DELAY


def test_parse_grammar_clauses_keys_and_seed(spec_mod):
    s = spec_mod.parse("transport.reset:count=2:after=5:rank=1;"
                       "ckpt.oserror:p=0.5;input.stall:delay=0.25@99")
    assert s.seed == 99
    assert s.sites() == ["ckpt.oserror", "input.stall", "transport.reset"]
    assert "transport.reset:count=2:after=5:rank=1" in s.describe()
    assert s.describe().endswith("@99")


def test_parse_defaults_bare_clause_fires_once(spec_mod):
    s = spec_mod.parse("ckpt.oserror")
    assert s.fire("ckpt.oserror") is not None
    assert s.fire("ckpt.oserror") is None


@pytest.mark.parametrize("bad,fragment", [
    ("transport.explode", "valid sites"),
    ("ckpt.oserror:zap=1", "valid keys"),
    ("ckpt.oserror:count=x", "bad value"),
    ("ckpt.oserror@notanint", "seed"),
    ("ckpt.oserror:p=1.5", "bad value"),
])
def test_parse_errors_name_the_problem(spec_mod, bad, fragment):
    with pytest.raises(ValueError, match=fragment):
        spec_mod.parse(bad)


def test_validate_env_rejects_typos(monkeypatch):
    monkeypatch.setenv("HVD_TPU_FAULTS", "transprot.reset@1")
    with pytest.raises(ValueError, match="valid sites"):
        chaos.validate_env()


def test_init_fails_on_a_mistyped_fault_spec(monkeypatch):
    monkeypatch.setenv("HVD_TPU_FAULTS", "ckpt.oserrr:count=1@2")
    with pytest.raises(ValueError, match="valid sites: .*ckpt.oserror"):
        thvd.init(device="cpu")
    assert not thvd.is_initialized()


def test_same_spec_and_seed_identical_fault_sequence(spec_mod):
    text = "ckpt.oserror:p=0.3:count=50@1234"
    a, b = spec_mod.parse(text), spec_mod.parse(text)
    seq_a = [a.fire("ckpt.oserror") is not None for _ in range(400)]
    seq_b = [b.fire("ckpt.oserror") is not None for _ in range(400)]
    assert seq_a == seq_b and any(seq_a)
    c = spec_mod.parse("ckpt.oserror:p=0.3:count=50@77")
    assert seq_a != [c.fire("ckpt.oserror") is not None for _ in range(400)]


def test_count_after_and_rank_filters(spec_mod):
    s = spec_mod.parse("coord.reorder:count=2:after=3:rank=1@0")
    assert all(s.fire("coord.reorder", rank=0) is None for _ in range(10))
    assert s.opportunities("coord.reorder") == 10
    s = spec_mod.parse("coord.reorder:count=2:after=3:rank=1@0")
    fired = [s.fire("coord.reorder", rank=1) is not None for _ in range(10)]
    assert fired == [False] * 3 + [True, True] + [False] * 5


@pytest.mark.parametrize("site", chaos_spec.VALID_SITES)
def test_both_packages_fire_the_same_sequence_at_every_site(site):
    """1,000 opportunities of one seeded spec at each site: the same
    decision, opportunity index, delay and clause in both packages."""
    text = (f"{site}:p=0.37:count=300:after=11:delay=0.125;"
            f"{site}:rank=2:count=4@{len(site)}")
    a, b = chaos_spec.parse(text), ref_spec.parse(text)
    for i in range(1000):
        rank = i % 3
        fa, fb = a.fire(site, rank=rank), b.fire(site, rank=rank)
        assert (fa is None) == (fb is None), i
        if fa is not None:
            assert (fa.site, fa.n, fa.delay, fa.clause) == \
                (fb.site, fb.n, fb.delay, fb.clause), i
    assert a.opportunities(site) == b.opportunities(site) == 1000


def test_maybe_reorder_is_deterministic(chaos_env):
    chaos_env("coord.reorder:count=1@5")
    assert chaos.maybe_reorder("coord.reorder", [1, 2, 3]) == [3, 2, 1]
    assert chaos.maybe_reorder("coord.reorder", [1, 2, 3]) == [1, 2, 3]
    assert chaos.maybe_reorder("coord.reorder", [7]) == [7]


def test_unarmed_fire_is_none(chaos_env):
    chaos.reload()
    assert chaos.fire("ckpt.oserror") is None
    assert not chaos.active()


def test_a_firing_is_counted_logged_and_flight_recorded(chaos_env, capfd):
    before = thvd.metrics().get("chaos.injected", {}).get("value", 0)
    chaos_env("input.stall:count=1:delay=0.01@8")
    assert chaos.sleep_site("input.stall")
    assert not chaos.sleep_site("input.stall")
    assert thvd.metrics()["chaos.injected"]["value"] == before + 1
    assert "fired input.stall#0" in capfd.readouterr().err
    assert ("chaos", ("input.stall", 0, "input.stall:count=1:delay=0.01")) \
        in [(e[1], e[2]) for e in port_flight.snapshot()]


# ---------------------------------------------------------------------------
# Shared backoff policy (utils/retry.py, the reference's copy)
# ---------------------------------------------------------------------------

@pytest.fixture(params=["port", "reference"])
def retry_mod(request):
    if request.param == "port":
        from horovod_tpu_torch.utils import retry
    else:
        from horovod_tpu.utils import retry
    return retry


def test_backoff_policy_jitter_bounds_and_cap(retry_mod):
    p = retry_mod.BackoffPolicy(base=0.1, cap=1.0, rng=random.Random(7))
    for k in range(12):
        assert 0.0 <= p.delay(k) <= min(1.0, 0.1 * 2 ** k)


def test_retry_call_retries_then_succeeds_and_reports(retry_mod):
    calls, seen = {"n": 0}, []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError(28, "flaky")
        return "ok"

    out = retry_mod.retry_call(
        flaky, attempts=4,
        policy=retry_mod.BackoffPolicy(base=0.001, cap=0.002),
        on_retry=lambda a, e, d: seen.append(a))
    assert out == "ok" and calls["n"] == 3 and seen == [0, 1]


# ---------------------------------------------------------------------------
# ckpt.oserror: the checkpoint writer (utils/checkpoint.py)
# ---------------------------------------------------------------------------

def test_checkpoint_transient_oserror_retries_then_lands(chaos_env,
                                                         tmp_path, capfd):
    chaos_env("ckpt.oserror:count=2@3")
    before = ck.stats()["checkpoint.retries"]
    tree = {"w": torch.arange(16, dtype=torch.float32)}
    handle = ck.write_tree_async(str(tmp_path / "m.msgpack"),
                                 ck._host_snapshot(tree), step=4)
    assert handle.wait(timeout=30.0)
    assert (tmp_path / "m.msgpack.step").read_text() == "4"
    assert ck.stats()["checkpoint.retries"] - before >= 2
    err = capfd.readouterr().err
    assert "retrying" in err and "hvd-chaos: ckpt.oserror" in err
    assert not glob.glob(str(tmp_path / "*.tmp.*"))
    # The bytes that landed are the fault-free write's.
    clean = tmp_path / "clean.msgpack"
    chaos_env("input.stall:count=0@3")
    ck.write_tree_async(str(clean), ck._host_snapshot(tree)).wait(30.0)
    assert clean.read_bytes() == (tmp_path / "m.msgpack").read_bytes()


def test_checkpoint_retry_exhaustion_dump_names_fault(chaos_env, tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("HVD_TPU_CKPT_RETRIES", "2")
    monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    port_flight.recorder._last_dump.pop("checkpoint-error", None)
    chaos_env("ckpt.oserror:count=9@4")
    handle = ck.write_tree_async(str(tmp_path / "m.msgpack"),
                                 {"w": np.arange(8, dtype=np.float32)})
    with pytest.raises(ck.CheckpointError, match="ckpt.oserror"):
        handle.wait(timeout=30.0)
    dumps = sorted(glob.glob(str(tmp_path / "flight" /
                                 "*checkpoint-error*")))
    assert dumps
    tail = json.loads(open(dumps[-1]).read())["events"][-10:]
    assert any(e["kind"] == "ckpt_retry" for e in tail), tail
    assert any(e["kind"] == "chaos" for e in tail), tail
    assert any(e["kind"] == "checkpoint_error"
               and any("ckpt.oserror" in str(a) for a in e["args"])
               for e in tail), tail


# ---------------------------------------------------------------------------
# input.stall: the prefetch stager (parallel/input.py)
# ---------------------------------------------------------------------------

def test_input_stall_injection_preserves_order_and_values(chaos_env):
    thvd.init(device="cpu")
    try:
        chaos_env("input.stall:count=2:delay=0.1@6")
        batches = [np.full((8, 2), float(i), np.float32) for i in range(6)]
        t0 = time.monotonic()
        out = [float(b[0, 0]) for b in
               thvd.prefetch_to_device(iter(batches))]
        assert out == [float(i) for i in range(6)]
        assert time.monotonic() - t0 >= 0.2
        assert chaos.schedule().opportunities("input.stall") >= 6
    finally:
        thvd.shutdown()


# ---------------------------------------------------------------------------
# serving.disconnect: the client probe (telemetry/exporter.py)
# ---------------------------------------------------------------------------

def test_client_probe_detects_closed_socket():
    from horovod_tpu_torch.telemetry.exporter import ClientProbe

    a, b = socket.socketpair()
    probe = ClientProbe(a)
    assert not probe.disconnected()
    b.close()
    deadline = time.monotonic() + 2.0
    while time.monotonic() < deadline and not probe.disconnected():
        time.sleep(0.01)
    assert probe.disconnected()
    a.close()


def test_serving_disconnect_site_answers_in_the_probe(chaos_env):
    from horovod_tpu_torch.telemetry.exporter import ClientProbe

    a, b = socket.socketpair()
    chaos_env("serving.disconnect:count=1:after=1@9")
    probe = ClientProbe(a)
    assert [probe.disconnected() for _ in range(3)] == [False, True, False]
    a.close()
    b.close()


def test_scheduler_cancel_queued_finishes_immediately():
    from horovod_tpu_torch.serving.scheduler import (
        ContinuousBatchingScheduler, FinishReason, Request)

    s = ContinuousBatchingScheduler(max_slots=1, capacity=32)
    r1 = s.submit(Request(prompt=[1, 2], max_new_tokens=4))
    r2 = s.submit(Request(prompt=[3, 4], max_new_tokens=4))
    s.admit()
    assert s.cancel(r2, FinishReason.CLIENT_DISCONNECT) == "queued"
    assert r2.done.is_set()
    assert r2.finish_reason == FinishReason.CLIENT_DISCONNECT
    assert s.queue_depth() == 0
    assert s.cancel(r1, FinishReason.CLIENT_DISCONNECT) == "active"
    assert not r1.done.is_set()
    assert s.evict_cancelled() == [0]
    assert r1.done.is_set() and s.occupancy() == 0
    assert s.cancel(r1, FinishReason.CLIENT_DISCONNECT) == "gone"


def test_route_registry_pass_client_flag():
    from horovod_tpu_torch.telemetry.exporter import RouteRegistry

    reg = RouteRegistry()
    reg.register("/a", lambda q, b: (200, b"", "t"))
    reg.register("/b", lambda q, b, c: (200, b"", "t"),
                 methods=("POST",), pass_client=True)
    assert reg.lookup("GET", "/a")[1] is False
    assert reg.lookup("POST", "/b")[1] is True


# ---------------------------------------------------------------------------
# coord.tick_delay and coord.reorder in a live runtime (ops/collective.py)
# ---------------------------------------------------------------------------

def test_coordinator_sites_fire_in_a_live_runtime(chaos_env):
    """One rank: the background loop takes a tick_delay opportunity
    before each cycle; rank 0's negotiation permutes a cycle's fresh
    responses (one a dtype, so they are several); the results stay
    exact."""
    chaos_env("coord.tick_delay:p=0.5:count=5:delay=0.01;"
              "coord.reorder:count=3@11")
    thvd.init(device="cpu")
    try:
        dts = (torch.float32, torch.float64, torch.int32, torch.int64)
        for step in range(4):
            hs = thvd.grouped_allreduce_async(
                [torch.full((4,), step + k, dtype=dt)
                 for k, dt in enumerate(dts)], op=thvd.Sum,
                name=f"g{step}")
            for k, h in enumerate(hs):
                assert torch.equal(thvd.synchronize(h),
                                   torch.full((4,), step + k,
                                              dtype=dts[k]))
        sched = chaos.schedule()
        assert sched.opportunities("coord.reorder") >= 1
        assert sched._by_site["coord.reorder"][0].fired >= 1
    finally:
        thvd.shutdown()


# ---------------------------------------------------------------------------
# The matrix
# ---------------------------------------------------------------------------

def test_every_site_is_a_port_scenario_or_waits_with_its_step():
    hosted = set()
    for s in matrix.SCENARIOS:
        assert s.expect in ("recover", "diagnostic", "complete"), s
        assert s.cap > 0
        if s.spec:
            chaos_spec.parse(s.spec)
        for clause in filter(None, s.spec.rpartition("@")[0].split(";")):
            hosted.add(clause.split(":")[0])
        if s.name == "serving_storm":
            hosted.add("serving.disconnect")  # the fault is the load
    assert hosted == {"coord.tick_delay", "coord.reorder", "ckpt.oserror",
                      "input.stall", "serving.disconnect"}
    from horovod_tpu.chaos import matrix as ref_matrix

    ref = {s.name: s for s in ref_matrix.SCENARIOS}
    names = {s.name for s in matrix.SCENARIOS}
    # Every reference scenario is in the port's matrix or waits, with the
    # reference's spec, needle, expectation and cap.
    assert names | set(matrix.WAITING) == set(ref), \
        set(ref) ^ (names | set(matrix.WAITING))
    assert not names & set(matrix.WAITING)
    for s in matrix.SCENARIOS:
        r = ref[s.name]
        assert (s.kind, s.expect, s.spec, s.needle, s.np, s.cap, s.env) == \
            (r.kind, r.expect, r.spec, r.needle, r.np, r.cap, r.env), s.name
    for site in chaos_spec.VALID_SITES:
        if site in hosted:
            continue
        waiting = [n for n, r in ref.items() if n in matrix.WAITING
                   and site in r.spec]
        assert waiting or site.startswith("transport."), site
        for n in waiting:
            assert "§A.5 item" in matrix.WAITING[n], n


def test_list_names_the_waiting_scenarios_with_their_steps(capsys):
    from horovod_tpu_torch.chaos.__main__ import main

    assert main(["--list"]) == 0
    out = capsys.readouterr().out
    for name, step in matrix.WAITING.items():
        assert f"{name:26s} waits for {step}" in out
    for s in matrix.SCENARIOS:
        assert s.name in out
    with pytest.raises(SystemExit, match="waits for"):
        matrix.find("grace_expiry")


def test_matrix_digest_and_result_parsing():
    d1 = matrix._digest([(1, "a"), (0, "b")])
    assert d1 == matrix._digest([(0, "b"), (1, "a")])
    assert d1 != matrix._digest([(0, "b")])
    dg = matrix._digest([(0, "b")])
    out = f"noise\nCHAOS_RESULT rank=1 n=3 digest={dg}\nmore"
    assert matrix._parse_results(out) == {1: f"n=3 digest={dg}"}
    out = (f"CHAOS_RESULT rank=0 n=3 digest={dg}[hvd-x] adopting\n"
           f"[hvd-chaos] x CHAOS_RESULT rank=1 n=3 digest={dg}")
    assert matrix._parse_results(out) == {0: f"n=3 digest={dg}",
                                          1: f"n=3 digest={dg}"}
    from horovod_tpu.chaos import matrix as ref_matrix

    recs = [(3, "t.1", "ALLREDUCE"), (0, "t.0", "ALLREDUCE")]
    assert matrix._digest(recs) == ref_matrix._digest(recs)


def test_a_cp_fleet_without_cards_runs_on_the_cpu():
    s = matrix.find("coord_reorder")
    assert matrix.fleet_device(s, "cpu") == "cpu"
    want = "cuda" if torch.cuda.device_count() >= 2 else "cpu"
    assert matrix.fleet_device(s, "cuda") == want
    assert matrix.fleet_device(matrix.find("ckpt_flaky"), "cuda") == "cuda"


def test_matrix_smoke_one_cp_scenario(monkeypatch):
    """The runner on a real np=2 fleet of the port's runtime on gloo:
    both passes' digests equal, and the fault fired."""
    monkeypatch.setenv("HVD_TPU_CHAOS_CP_STEPS", "6")
    report = matrix.run_scenario(matrix.find("coord_tick_delay"),
                                 device="cpu")
    assert report["status"] == "PASS", report
    assert report["fired"] >= 1, report


def test_matrix_smoke_one_local_scenario():
    report = matrix.run_scenario(matrix.find("ckpt_exhaustion"),
                                 device="cpu")
    assert report["status"] == "PASS", report
    assert report["fired"] == 3, report
