"""horovod_tpu_torch's trace package (trace/) against horovod_tpu's.

* Spans, the span buffer's bound and gate, the 16-byte context (the same
  bytes as the reference's trailer), the clock estimator and
  ``ClockSync`` on seeded probes, ``merge_events``, ``analyze``,
  ``window_legs`` and ``render`` on seeded fleets, ``SkewTracker`` and
  ``StragglerWatch`` on seeded skews: each on both packages, equal
  exactly (the analyzer's JSON byte for byte).
* The port's transport carries the trace traffic as batch messages and
  broadcast prefixes (round trips), the timeline mirrors the context,
  the trace CLI reads a fleet trace, and a one-rank ``dump_fleet_trace``
  holds the runtime's negotiate, dispatch and collective spans.
* ONE 3-rank gloo job (FileStore in ``tmp_path``; children killed after
  ``communicate(timeout=...)``): ``verify_program`` on an agreeing and
  a diverged program (the port's message equals the reference's
  ``cross_validate`` of the same signatures), the trace context in the
  batches and the clock offsets of ranks 1-2, the live skew of a seeded
  slow rank, and ``dump_fleet_trace`` merging the 3 ranks.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import horovod_tpu.trace as ref_trace
from horovod_tpu.analysis import program as ref_prog
from horovod_tpu.trace import analyze as ref_analyze
from horovod_tpu.trace import clock as ref_clock
from horovod_tpu.trace import merge as ref_merge
from horovod_tpu.trace import watch as ref_watch

import horovod_tpu_torch as thvd
import horovod_tpu_torch.trace as port_trace
from horovod_tpu_torch.ops import transport
from horovod_tpu_torch.trace import analyze as port_analyze
from horovod_tpu_torch.trace import clock as port_clock
from horovod_tpu_torch.trace import merge as port_merge
from horovod_tpu_torch.trace import watch as port_watch
from horovod_tpu_torch.utils import timeline as port_timeline

from gloo_job import REPO, GlooJob

PKGS = {"reference": (ref_trace, ref_clock, ref_merge, ref_analyze,
                      ref_watch),
        "port": (port_trace, port_clock, port_merge, port_analyze,
                 port_watch)}


@pytest.fixture(params=["reference", "port"])
def pkg(request):
    return PKGS[request.param]


# ---------------------------------------------------------------------------
# The span buffer and the context
# ---------------------------------------------------------------------------

def test_span_buffer_records_context_and_counts(pkg):
    trace = pkg[0]
    trace.reset_run(rank=0)
    trace.set_step(3)
    t0 = time.monotonic()
    trace.span("unit.work", "host", t0, t0 + 0.001, args={"k": 1})
    ev = trace.export_events()[-1]
    assert (ev["name"], ev["cat"], ev["ph"]) == ("unit.work", "host", "X")
    assert ev["args"] == {"step": 3, "cycle": 0, "k": 1}
    assert ev["dur"] == pytest.approx(1000.0, rel=0.2)
    trace.reset_run(rank=0)


def test_span_buffer_is_bounded_and_gated(pkg):
    trace = pkg[0]
    trace.reset_run(rank=0)
    cap = trace._state._events.maxlen
    assert cap == 20000  # HVD_TPU_TRACE_EVENTS' default
    for i in range(cap + 50):
        trace.instant(f"e{i}", "host")
    assert len(trace.export_events()) == cap
    trace.set_enabled(False)
    try:
        trace.instant("off", "host")
        assert trace.export_events()[-1]["name"] == f"e{cap + 49}"
    finally:
        trace.set_enabled(True)
        trace.reset_run(rank=0)


@pytest.mark.parametrize("seed", range(5))
def test_ctx_bytes_equal_the_references(seed):
    rng = np.random.RandomState(seed)
    step, cycle = (int(x) for x in rng.randint(0, 2 ** 31, size=2))
    tid = int(rng.randint(1, 2 ** 62))
    packed = []
    for trace in (ref_trace, port_trace):
        trace.reset_run(rank=0, trace_id=tid)
        trace.set_step(step)
        trace.observe_ctx(step, cycle, tid)
        packed.append(trace.pack_ctx())
        assert trace.unpack_ctx(b"xx" + packed[-1], 2) == (step, cycle, tid)
        assert trace.unpack_ctx(packed[-1][:8], 0) is None
        assert trace.current_args() == {"step": step, "cycle": cycle}
        assert trace.next_cycle() == (step, cycle + 1, tid)
        trace.reset_run(rank=0)
    assert packed[0] == packed[1] and len(packed[1]) == 16


def test_reset_run_mints_a_trace_id_on_rank_zero_only(pkg):
    trace = pkg[0]
    trace.reset_run(rank=0)
    assert trace.current_ctx()[2] != 0
    trace.reset_run(rank=1, trace_id=0)
    trace.reset_run(rank=1)
    assert trace.current_ctx() == (0, 0, 0)
    trace.reset_run(rank=0)


# ---------------------------------------------------------------------------
# Clock alignment on seeded probes
# ---------------------------------------------------------------------------

def _probes(seed, n=200):
    """(t0, t1, t2) exchanges against a peer clock offset by ``true``:
    symmetric 50-150 us paths plus seeded queueing on one leg, and a few
    causally impossible (replayed) samples."""
    rng = np.random.RandomState(seed)
    true = float(rng.uniform(-2.0, 2.0))
    out = []
    t = 100.0
    for i in range(n):
        t += float(rng.uniform(0.001, 0.01))
        up = float(rng.uniform(50e-6, 150e-6))
        down = float(rng.uniform(50e-6, 150e-6))
        if rng.rand() < 0.3:  # queueing on one leg
            q = float(rng.exponential(0.01))
            if rng.rand() < 0.5:
                up += q
            else:
                down += q
        t1 = t + up + true
        t2 = t + up + down
        if rng.rand() < 0.03:
            t2 = t - 0.001  # a replayed, causally impossible pong
        out.append((t, t1, t2))
    return true, out


@pytest.mark.parametrize("seed", range(6))
def test_offset_estimator_on_seeded_probes(seed):
    true, probes = _probes(seed)
    got = []
    for clock in (ref_clock, port_clock):
        est = clock.OffsetEstimator()
        seen = [est.add(*p) for p in probes]
        got.append((seen, est.offset(), est.error_bound(), est.count))
    assert got[1] == got[0]
    offset, bound = got[1][1], got[1][2]
    assert abs(offset - true) <= bound + 1e-12


@pytest.mark.parametrize("seed", range(3))
def test_clock_sync_on_seeded_probes(seed):
    results = []
    for clock in (ref_clock, port_clock):
        sync = clock.ClockSync()
        for rank in (1, 2, 3):
            _, probes = _probes(seed * 10 + rank, n=40)
            for p in probes:
                sync.on_pong(rank, *p)
        sync.reset(2)
        results.append((sync.offsets(), sync.error_bounds(),
                        sync.sample_counts()))
    assert results[1] == results[0]
    assert set(results[1][0]) == {1, 3}  # rank 2 was reset


# ---------------------------------------------------------------------------
# Merge and analysis on seeded fleets
# ---------------------------------------------------------------------------

def _span(rank, name, cat, t0_us, dur_us, step, cycle, **extra):
    return {"name": name, "cat": cat, "ph": "X", "ts": float(t0_us),
            "dur": float(dur_us), "pid": rank,
            "args": {"step": step, "cycle": cycle, **extra}}


def _arrival(rank, t_us, step, cycle):
    return {"name": "BATCH_ARRIVAL", "cat": "negotiate", "ph": "i",
            "s": "t", "ts": float(t_us), "pid": 0,
            "args": {"step": step, "cycle": cycle, "rank": rank}}


def _fleet(seed):
    """A seeded fleet: ranks x steps x cycles of arrivals, host stalls,
    negotiate waits, dispatch spans with collective launches inside, a
    checkpoint and a serving span, per rank buffer and merged."""
    rng = np.random.RandomState(seed)
    ranks = int(rng.randint(1, 5))
    slow = int(rng.randint(ranks))
    per_rank = {r: [] for r in range(ranks)}
    merged = []
    for step in range(1, int(rng.randint(2, 5))):
        for cycle in range(1, int(rng.randint(2, 5))):
            base = (step * 10 + cycle) * 100_000.0
            for r in range(ranks):
                late = 30_000.0 if r == slow else float(rng.randint(0, 900))
                evs = []
                if r == slow:
                    evs.append(_span(r, "prefetch.wait", "host", base,
                                     late - 1_000.0, step, cycle))
                merged.append(_arrival(r, base + late, step, cycle))
                evs.append(_span(r, "negotiate.wait", "negotiate",
                                 base + late, 40_000.0 - late, step, cycle))
                d0 = base + 40_000.0 + float(rng.randint(0, 500))
                dur = float(rng.randint(2_000, 9_000))
                evs.append(_span(r, "execute/allreduce", "dispatch", d0,
                                 dur, step, cycle))
                if rng.rand() < 0.8:
                    wire = int(rng.randint(1, 10_000))
                    evs.append(_span(
                        r, "megakernel/psum", "collective", d0 + 500.0,
                        dur - 1_000.0, step, cycle, wire_bytes=wire,
                        dcn_bytes=int(rng.randint(0, wire))))
                if rng.rand() < 0.2:
                    evs.append(_span(r, "checkpoint.write", "checkpoint",
                                     d0 + dur, 5_000.0, step, cycle))
                if rng.rand() < 0.2:
                    evs.append(_span(r, "serving.iteration", "serving",
                                     d0 + dur, 3_000.0, step, cycle))
                per_rank[r] += evs
                merged += evs
    return per_rank, merged


@pytest.mark.parametrize("seed", range(8))
def test_merge_and_analysis_equal_the_references(seed, tmp_path):
    per_rank, merged = _fleet(seed)
    offsets = {r: 0.001 * r for r in per_rank if r}
    strip = [{k: v for k, v in e.items() if k != "pid"}
             for e in merged if e["name"] != "BATCH_ARRIVAL"]
    out = {}
    for name, (trace, _, merge, analyze, _) in PKGS.items():
        buffers = {r: [{k: v for k, v in e.items() if k != "pid"}
                       for e in evs] for r, evs in per_rank.items()}
        m = merge.merge_events(buffers, offsets)
        report = analyze.analyze(merged)
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps({"traceEvents": merged}))
        out[name] = (json.dumps(m, sort_keys=True),
                     json.dumps(report, sort_keys=True),
                     analyze.render(report),
                     json.dumps(analyze.window_legs(strip), sort_keys=True),
                     analyze.load_trace(str(path)) == merged)
    assert out["port"] == out["reference"]
    assert out["port"][4]


def test_trace_cli_matches_the_references(tmp_path):
    _, merged = _fleet(3)
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps({"traceEvents": merged}))
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    runs = [subprocess.run([sys.executable, "-m", mod, str(path),
                            "--json", "-"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
            for mod in ("horovod_tpu.trace", "horovod_tpu_torch.trace")]
    assert runs[0].returncode == runs[1].returncode == 0, runs[1].stderr
    assert runs[1].stdout == runs[0].stdout
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    r = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.trace",
                        str(bad)], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 2


# ---------------------------------------------------------------------------
# Skew tracking and the straggler watch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_skew_tracker_and_straggler_watch_equal_the_references(seed,
                                                              capsys):
    rng = np.random.RandomState(seed)
    stamps = []
    for cycle in range(300):
        for rank in range(int(rng.randint(1, 5))):
            stamps.append((rank, cycle // 7, cycle,
                           cycle * 0.01 + float(rng.exponential(0.02))))
    skews = [{r: float(rng.exponential(0.04)) for r in
              range(int(rng.randint(1, 5)))} for _ in range(40)]
    got = []
    for _, _, _, _, watch in PKGS.values():
        tracker = watch.SkewTracker(history=64)
        dedup = [tracker.note(*s) for s in stamps + stamps[:20]]
        w = watch.StragglerWatch(threshold=0.03, patience=3,
                                 tracker_=tracker)
        fired = [w.check(s) for s in skews]
        live = watch.StragglerWatch(threshold=0.001, patience=1,
                                    tracker_=tracker).check()
        got.append((dedup, tracker.skew_by_rank(), fired, w.warnings, live))
    capsys.readouterr()
    assert got[1] == got[0]
    with pytest.raises(ValueError, match="threshold > 0"):
        port_watch.StragglerWatch(threshold=0)


# ---------------------------------------------------------------------------
# The port's transport, timeline and runtime
# ---------------------------------------------------------------------------

def test_trace_messages_and_prefixes_round_trip():
    ctx = port_trace.CTX_STRUCT.pack(7, 9, 123)
    batch = (transport.encode_trace_ctx(ctx, 12.5)
             + transport.encode_pong(1.0, 2.0, 2.5)
             + transport.encode_trace([{"name": "a"}])
             + transport.encode_signature(b'{"rank": 1}'))
    assert transport.decode_batch(batch) == [
        (transport.KIND_TRACE_CTX, (7, 9, 123, 12.5)),
        (transport.KIND_PONG, (1.0, 2.0, 2.5)),
        (transport.KIND_TRACE, [{"name": "a"}]),
        (transport.KIND_SIGNATURE, b'{"rank": 1}')]
    body = transport.encode_responses([])
    payload = transport.encode_prefixes(
        pull_metrics=True, signature=(True, "diverged"), pull_trace=True,
        ping=3.25, ctx=ctx) + body
    found, rest = transport.strip_prefixes(payload)
    assert found == {transport.PAYLOAD_PULL_METRICS: True,
                     transport.PAYLOAD_SIGNATURE: (True, "diverged"),
                     transport.PAYLOAD_PULL_TRACE: True,
                     transport.PAYLOAD_PING: 3.25,
                     transport.PAYLOAD_CTX: (7, 9, 123)}
    assert rest == body
    assert transport.strip_prefixes(body) == ({}, body)


def test_timeline_events_carry_trace_context(tmp_path):
    port_trace.reset_run(rank=0)
    port_trace.set_step(4)
    port_trace.observe_ctx(4, 11, 1)
    path = tmp_path / "tl.json"
    tl = port_timeline.Timeline(str(path))
    tl.negotiate_start("t0", "allreduce")
    tl.instant("t0", "MARK", args={"cycle": 99})
    tl.negotiate_end("t0")
    tl.close()
    events = json.loads(path.read_text())
    begin = [e for e in events if e.get("ph") == "B"][0]
    assert begin["args"] == {"step": 4, "cycle": 11, "phase": "NEGOTIATE"}
    mark = [e for e in events if e.get("name") == "MARK"][0]
    assert mark["args"]["cycle"] == 99  # explicit args win
    port_trace.set_enabled(False)
    try:
        assert port_trace.current_args() == {}
    finally:
        port_trace.set_enabled(True)
        port_trace.reset_run(rank=0)


def test_single_process_fleet_trace_end_to_end(tmp_path):
    thvd.init(device="cpu")
    try:
        for step in range(3):
            port_trace.set_step(step + 1)
            thvd.allreduce(torch.ones(8), name=f"fleet.{step}")
        path = thvd.dump_fleet_trace(str(tmp_path / "fleet.json"))
    finally:
        thvd.shutdown()
    data = json.loads(open(path).read())
    assert data["metadata"]["format"] == "hvd-fleet-trace-v1"
    assert data["metadata"]["ranks"] == [0]
    names = {e["name"] for e in data["traceEvents"] if e.get("ph") == "X"}
    assert {"negotiate.tick", "negotiate.wait", "execute/allreduce",
            "megakernel/psum"} <= names
    report = port_analyze.analyze(data["traceEvents"])
    assert [s["step"] for s in report["steps"]] == [1, 2, 3]
    assert report["attribution_us"]["collective"] > 0


def test_hook_step_advances_the_trace_step():
    from horovod_tpu_torch.parallel.training import make_train_step

    thvd.init(device="cpu")
    try:
        w = torch.nn.Parameter(torch.ones(3))
        step = make_train_step(lambda p, b: (p["w"] * b).sum(),
                               torch.optim.SGD([w], lr=0.1))
        port_trace.set_step(0)
        for _ in range(2):
            step({"w": w}, torch.ones(3))
        assert port_trace.current_step() == 2
    finally:
        thvd.shutdown()


# ---------------------------------------------------------------------------
# ONE 3-rank gloo job: verify_program, trace context, clocks, fleet trace
# ---------------------------------------------------------------------------

JOB = """
import json
import pathlib
import time

from horovod_tpu_torch import trace
from horovod_tpu_torch.analysis import program
from horovod_tpu_torch.core import state as _st
from horovod_tpu_torch.ops.handles import HorovodError

out = {}
rt = _st._state.runtime


def blob(x):
    return np.frombuffer(json.dumps(x).encode(), np.uint8)


# 1. verify_program: an agreeing program, then rank 2 diverged.
program.recorder().clear()
for i in range(3):
    hvd.allreduce(torch.ones(4) * RANK, name=f"vp.a{i}")
rep = hvd.verify_program()
out["agree"] = np.asarray([rep.ranks, rep.entries])
hvd.allreduce(torch.ones(4), name="vp.b0")
program.record_collective("allreduce", "vp.b1", "float32",
                          (5,) if RANK == 2 else (4,), reduce_op="sum")
entries, total = program.recorder().snapshot()
out["packed"] = np.frombuffer(program.pack_program(RANK, entries, total),
                              np.uint8)
try:
    hvd.verify_program()
    out["diverged"] = blob(None)
except HorovodError as e:
    out["diverged"] = blob(str(e))

# 2. The trace context and the clocks; rank 2 is a seeded slow loader.
for step in range(6):
    trace.set_step(step + 1)
    if RANK == 2:
        time.sleep(0.05)
    hvd.allreduce(torch.ones(8), name=f"tr.{step}")
out["ctx"] = np.asarray(trace.current_ctx()[1:], np.uint64)
if RANK == 0:
    offs = rt.measure_clock_offsets(timeout=10.0)
    out["offsets"] = blob({str(k): v for k, v in offs.items()})
    out["bounds"] = blob({str(k): v
                          for k, v in rt.clock.error_bounds().items()})
    out["skew"] = blob({str(k): v for k, v in
                        trace.watch.tracker.skew_by_rank().items()})
    # 3. The fleet trace.
    path = str(pathlib.Path(OUT).parent / "fleet.json")
    hvd.dump_fleet_trace(path, timeout=60)
else:
    try:
        hvd.dump_fleet_trace("never.json")
        out["worker_raised"] = np.asarray(0)
    except RuntimeError as e:
        out["worker_raised"] = np.asarray(int("controller" in str(e)))
hvd.allreduce(torch.ones(1), name="tr.done")
finish(out)
"""


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    job = GlooJob(tmp, JOB, 3, {"x": np.zeros(1)}, timeout=200)
    return job.results(), tmp


def _blob(a):
    return json.loads(a.tobytes())


def test_fleet_verify_program_agrees_then_names_the_divergence(fleet):
    out, _ = fleet
    assert [o["agree"].tolist() for o in out] == [[3, 3]] * 3
    packed = {r: o["packed"].tobytes() for r, o in enumerate(out)}
    want = ref_prog.cross_validate(packed)
    assert want is not None and "entry #1" in want
    assert [_blob(o["diverged"]) for o in out] == [want] * 3


def test_fleet_context_rides_the_batches(fleet):
    out, _ = fleet
    cycles = {int(o["ctx"][0]) for o in out}
    tids = {int(o["ctx"][1]) for o in out}
    assert len(tids) == 1 and tids != {0}  # rank 0's trace id, adopted
    assert len(cycles) == 1 and cycles != {0}


def test_fleet_clock_offsets_of_ranks_one_and_two(fleet):
    out, _ = fleet
    offs = {int(k): v for k, v in _blob(out[0]["offsets"]).items()}
    bounds = {int(k): v for k, v in _blob(out[0]["bounds"]).items()}
    assert set(offs) == set(bounds) == {1, 2}
    for r in (1, 2):
        # One host: the monotonic clocks share their epoch, so the true
        # offset is 0 and the estimate lies within its error bound.
        assert abs(offs[r]) <= bounds[r] + 1e-6, (r, offs, bounds)
        assert bounds[r] < 0.05


def test_fleet_live_skew_names_the_slow_rank(fleet):
    out, _ = fleet
    skew = {int(k): v for k, v in _blob(out[0]["skew"]).items()}
    assert set(skew) == {0, 1, 2}
    # Rank 2 sleeps 50 ms before each step's allreduce: it is the rank
    # the live skew names, by more than half its sleep.
    assert max(skew, key=skew.get) == 2 and skew[2] > 0.025


def test_fleet_trace_merges_three_ranks(fleet):
    out, tmp = fleet
    assert [int(o["worker_raised"]) for o in out[1:]] == [1, 1]
    data = json.loads((tmp / "fleet.json").read_text())
    meta = data["metadata"]
    assert meta["ranks"] == [0, 1, 2]
    assert set(meta["clock_offsets_seconds"]) == {"1", "2"}
    pids = {e["pid"] for e in data["traceEvents"] if e.get("ph") == "X"}
    assert pids == {0, 1, 2}
    report = port_analyze.analyze(data["traceEvents"])
    assert report["ranks"] == [0, 1, 2]
    assert report["attribution_us"]["negotiate"] > 0
    assert report == ref_analyze.analyze(data["traceEvents"])
