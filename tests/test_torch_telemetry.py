"""horovod_tpu_torch's telemetry (telemetry/flight.py, telemetry/__init__.py,
the exporter started by ``init``, ``cluster_metrics``, the hooks at the
ported sites, callbacks.py ``MetricsLogger``, ops/fused.py
``measure_exposed_comm``, the ``pipeline.*`` series) against
horovod_tpu's.

The cases of tests/test_telemetry.py:121-375 that this slice covers run
on both packages: the flight ring's bound, the dump format and rate
limit, ``set_enabled`` silencing the ring, dumps on a seeded stall and on
a seeded cross-rank mismatch, the exporter started by ``init`` on
``HVD_TPU_METRICS_PORT``, ``cluster_metrics`` on one rank.  Then
``cluster_metrics`` on a job of 3 gloo ranks (the pull rides the
coordinator's cycle) with a real stall seeded in it, ``MetricsLogger``
as tests/test_callbacks.py:150-168 has it, and ``measure_exposed_comm``
as tests/test_fused.py:306.
"""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import horovod_tpu.telemetry as ref_telemetry
import horovod_tpu_torch.telemetry as port_telemetry
from horovod_tpu.telemetry import flight as ref_flight
from horovod_tpu_torch.telemetry import flight as port_flight
from gloo_job import GlooJob

PACKAGES = {"reference": (ref_telemetry, ref_flight),
            "port": (port_telemetry, port_flight)}


@pytest.fixture(params=["reference", "port"])
def pkg(request):
    return PACKAGES[request.param]


@pytest.fixture()
def thvd():
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


# ---------------------------------------------------------------------------
# The flight recorder (tests/test_telemetry.py:212-250), on both packages
# ---------------------------------------------------------------------------

def test_flight_ring_is_bounded(pkg):
    _, fl = pkg
    rec = fl.FlightRecorder(capacity=100, enabled=True)
    for i in range(250):
        rec.record("tick", i)
    events = rec.snapshot()
    assert len(events) == 100
    assert events[0][2] == (150,) and events[-1][2] == (249,)


def test_flight_dump_format_and_rate_limit(pkg, tmp_path):
    _, fl = pkg
    rec = fl.FlightRecorder(capacity=10, enabled=True)
    rec.record("submit", "grad.0", 0)
    rec.record("stall", "Tensor grad.0 pending")
    path = rec.dump("unit-test", extra={"k": "v"}, directory=str(tmp_path))
    assert path is not None
    payload = json.loads(open(path).read())
    assert payload["format"] == "hvd-flight-v1"
    assert payload["reason"] == "unit-test"
    assert payload["extra"] == {"k": "v"}
    assert payload["events"][-1]["kind"] == "stall"
    assert [e["kind"] for e in payload["events"]] == ["submit", "stall"]
    assert rec.dump("unit-test", directory=str(tmp_path)) is None
    assert rec.dump("other", directory=str(tmp_path)) is not None
    assert rec.dump("unit-test") is None or fl.flight_dir()


def test_flight_dumps_of_both_packages_have_the_same_keys(tmp_path):
    keys = []
    for name, (_, fl) in PACKAGES.items():
        rec = fl.FlightRecorder(capacity=4, enabled=True)
        rec.record("cache_flush", "join", 3, 2)
        path = rec.dump("same", directory=str(tmp_path / name))
        payload = json.loads(open(path).read())
        keys.append((sorted(payload), payload["events"][0]["args"],
                     os.path.basename(path)))
    assert keys[0] == keys[1]


def test_flight_env_contract(pkg, monkeypatch):
    _, fl = pkg
    monkeypatch.setenv("HVD_TPU_FLIGHT", "0")
    assert fl.FlightRecorder().enabled is False
    monkeypatch.setenv("HVD_TPU_FLIGHT", "1")
    monkeypatch.setenv("HVD_TPU_FLIGHT_EVENTS", "7")
    assert fl.FlightRecorder().capacity == 7
    monkeypatch.delenv("HVD_TPU_FLIGHT_DIR", raising=False)
    assert fl.flight_dir() is None


def test_set_enabled_master_switch_silences_flight(pkg):
    tel, fl = pkg
    was = tel.enabled()
    try:
        tel.set_enabled(False)
        n0 = len(fl.snapshot())
        fl.record("should_not_appear")
        assert len(fl.snapshot()) == n0
        tel.set_enabled(True)
        fl.record("appears")
        assert fl.snapshot()[-1][1] == "appears"
    finally:
        tel.set_enabled(was)


@pytest.mark.parametrize("event,args,reason", [
    ("dead_peer_event", ("rank(s) [1] died",), "dead-peer"),
    ("transport_fault_event", ("grace", "peer 1 gone"), "grace"),
    ("prefetch_error_event", ("ValueError: bad batch",), "prefetch-error"),
    ("checkpoint_error_event", ("/x/ckpt", "OSError: full"),
     "checkpoint-error"),
    ("exception_event", ("drain", "Traceback ..."), "exception-drain"),
])
def test_typed_events_record_and_dump(pkg, event, args, reason, tmp_path,
                                      monkeypatch):
    tel, fl = pkg
    monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(tmp_path))
    fl.recorder._last_dump.pop(reason, None)
    getattr(tel, event)(*args)
    files = sorted(tmp_path.glob(f"hvd_flight_*{reason}*.json"))
    assert files, list(tmp_path.iterdir())
    payload = json.loads(files[-1].read_text())
    assert payload["reason"] == reason
    assert payload["events"][-1]["args"][-1] == args[-1]
    assert "metrics" in payload


def test_overlap_fallback_event_records_without_dump(pkg, tmp_path,
                                                     monkeypatch):
    tel, fl = pkg
    monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(tmp_path))
    tel.overlap_fallback_event("adasum", "whole-gradient combine")
    assert fl.snapshot()[-1][1:] == ("overlap_fallback",
                                     ("adasum", "whole-gradient combine"))
    assert not list(tmp_path.iterdir())


def test_flight_tail_providers(pkg, tmp_path):
    tel, fl = pkg
    tel.register_flight_tail("unit", lambda: {"unit.value": 7})
    try:
        rec = fl.FlightRecorder(capacity=2, enabled=True)
        payload = json.loads(open(rec.dump(
            "tail", directory=str(tmp_path))).read())
        assert payload["metrics"]["unit.value"] == 7
    finally:
        tel.unregister_flight_tail("unit")


# ---------------------------------------------------------------------------
# Dumps through the real paths (tests/test_telemetry.py:253-320)
# ---------------------------------------------------------------------------

def _stall_payload(tmp_path):
    files = sorted(tmp_path.glob("hvd_flight_*stall*.json"))
    assert files, list(tmp_path.iterdir())
    return json.loads(files[-1].read_text())


def test_flight_dump_on_seeded_stall_reference(monkeypatch, tmp_path):
    from horovod_tpu.ops import coordinator as coord_mod
    from horovod_tpu.ops import wire

    monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setattr(coord_mod, "STALL_WARNING_SECONDS", -1.0)
    ref_flight.recorder._last_dump.pop("stall", None)
    coord = coord_mod.Coordinator(size=2, fusion_threshold=1 << 20)
    coord.submit(wire.Request(
        request_rank=0, request_type=wire.RequestType.ALLREDUCE,
        tensor_type=wire.DataType.FLOAT32, tensor_name="stalled.op",
        tensor_shape=(4,)))
    assert coord.poll_responses({}) == []
    coord.close()
    payload = _stall_payload(tmp_path)
    tail = [e for e in payload["events"] if e["kind"] == "stall"][-1]
    assert "stalled.op" in tail["args"][0]
    assert "waiting on replicas: [1]" in tail["args"][0]


@pytest.mark.parametrize("native", ["native", "python"])
def test_flight_dump_on_seeded_stall_port(monkeypatch, tmp_path, native):
    """The port's cycle passes each coordinator's stall warnings to
    ``stall_event``: the Python and the native coordinator alike."""
    from horovod_tpu_torch.ops import coordinator as coord_mod
    from horovod_tpu_torch.ops import wire

    if native == "python":
        monkeypatch.setenv("HVD_TPU_DISABLE_NATIVE", "1")
    monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(tmp_path))
    port_flight.recorder._last_dump.pop("stall", None)
    stalls0 = port_telemetry.registry().snapshot(
        run_collectors=False)["events.stall_warnings"]["value"]
    coord = coord_mod.Coordinator(size=2, fusion_threshold=1 << 20)
    coord.submit(wire.Request(
        request_rank=0, request_type=wire.RequestType.ALLREDUCE,
        tensor_type=wire.DataType.FLOAT32, tensor_name="stalled.op",
        tensor_shape=(4,)))
    assert coord.poll_responses({}) == []
    port_telemetry.stall_event(coord.check_stalled(threshold=-1.0))
    coord.close()
    snap = port_telemetry.registry().snapshot(run_collectors=False)
    assert snap["events.stall_warnings"]["value"] > stalls0
    payload = _stall_payload(tmp_path)
    tail = [e for e in payload["events"] if e["kind"] == "stall"][-1]
    assert "stalled.op" in tail["args"][0]
    assert "waiting on replicas: [1]" in tail["args"][0]
    assert any(e["kind"] == "submit" and "stalled.op" in e["args"]
               for e in payload["events"])
    assert payload["extra"]["warnings"]


def test_flight_dump_on_seeded_mismatch_reference(hvd, monkeypatch,
                                                  tmp_path):
    from horovod_tpu.ops import collective as C
    from horovod_tpu.ops import wire
    from horovod_tpu.ops.coordinator import PyCoordinator

    monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(tmp_path))
    ref_flight.recorder._last_dump.pop("error", None)
    coord = PyCoordinator(size=2, fusion_threshold=1 << 20)
    for rank, shape in ((0, (2,)), (1, (3,))):
        coord.submit(wire.Request(
            request_rank=rank, request_type=wire.RequestType.ALLREDUCE,
            tensor_type=wire.DataType.FLOAT32, tensor_name="bad.shape",
            tensor_shape=shape))
    errs = [r for r in coord.poll_responses({})
            if r.response_type == wire.ResponseType.ERROR]
    C._execute_response(errs[0], [])
    files = sorted(tmp_path.glob("hvd_flight_*error*.json"))
    assert "Mismatched allreduce tensor shapes" in json.loads(
        files[-1].read_text())["extra"]["message"]


def test_flight_dump_on_seeded_mismatch_port(thvd, monkeypatch, tmp_path):
    """The mismatch's ERROR response through the runtime's executor."""
    from horovod_tpu_torch.core import state
    from horovod_tpu_torch.ops import wire
    from horovod_tpu_torch.ops.coordinator import PyCoordinator

    monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(tmp_path))
    port_flight.recorder._last_dump.pop("error", None)
    coord = PyCoordinator(size=2, fusion_threshold=1 << 20)
    for rank, shape in ((0, (2,)), (1, (3,))):
        coord.submit(wire.Request(
            request_rank=rank, request_type=wire.RequestType.ALLREDUCE,
            tensor_type=wire.DataType.FLOAT32, tensor_name="bad.shape",
            tensor_shape=shape))
    errs = [r for r in coord.poll_responses({})
            if r.response_type == wire.ResponseType.ERROR]
    assert errs and "Mismatched allreduce tensor shapes" in \
        errs[0].error_message
    before = thvd.metrics()["collective.errors"]["value"]
    state._state.runtime._execute(errs[0])
    files = sorted(tmp_path.glob("hvd_flight_*error*.json"))
    assert files, list(tmp_path.iterdir())
    payload = json.loads(files[-1].read_text())
    assert "Mismatched allreduce tensor shapes" in \
        payload["extra"]["message"]
    assert thvd.metrics()["collective.errors"]["value"] == before + 1


# ---------------------------------------------------------------------------
# Exporter from init, local metrics, cluster_metrics at one rank
# ---------------------------------------------------------------------------

def test_exporter_started_by_init_on_env_port_reference(monkeypatch):
    import jax

    import horovod_tpu as hvd
    from horovod_tpu.core import state as state_mod

    monkeypatch.setenv("HVD_TPU_METRICS_PORT", "0")
    hvd.init(devices=jax.devices())
    try:
        exp = state_mod.global_state().metrics_exporter
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{exp.port}/healthz", timeout=5).read())
        assert health["initialized"] is True and health["rank"] == 0
    finally:
        hvd.shutdown()
    assert state_mod.global_state().metrics_exporter is None


def test_exporter_started_by_init_on_env_port_port(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import state as state_mod

    monkeypatch.setenv("HVD_TPU_METRICS_PORT", "0")
    monkeypatch.setenv("HVD_TPU_METRICS_HOST", "127.0.0.1")
    hvd.init(device="cpu")
    try:
        exp = state_mod._state.metrics_exporter
        assert exp is not None
        base = f"http://127.0.0.1:{exp.port}"
        health = json.loads(urllib.request.urlopen(
            f"{base}/healthz", timeout=5).read())
        assert health["initialized"] is True and health["rank"] == 0
        text = urllib.request.urlopen(f"{base}/metrics",
                                      timeout=5).read().decode()
        assert "hvd_events_errors" in text
    finally:
        hvd.shutdown()
    assert state_mod._state.metrics_exporter is None
    with pytest.raises(OSError):
        urllib.request.urlopen(f"{base}/healthz", timeout=2)


def test_exporter_bad_port_only_warns(monkeypatch, capsys):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core import state as state_mod

    monkeypatch.setenv("HVD_TPU_METRICS_PORT", "not-a-port")
    hvd.init(device="cpu")
    try:
        assert state_mod._state.metrics_exporter is None
        assert "could not serve" in capsys.readouterr().err
    finally:
        hvd.shutdown()


def test_metrics_snapshot_after_collectives(thvd):
    base = thvd.metrics()
    out = thvd.allreduce(torch.ones(8), average=False, name="tel.e2e")
    assert float(out[0]) == thvd.size()
    snap = thvd.metrics()
    assert snap["collective.submitted"]["value"] > \
        base["collective.submitted"]["value"]
    assert snap["collective.completed"]["value"] > \
        base["collective.completed"]["value"]
    assert snap["collective.negotiate_seconds"]["count"] >= 1
    assert "handles.live" in snap and "cache.hits" in snap
    assert "megakernel.launches" in snap
    assert "kernels.flash_fwd.launches" in snap


@pytest.mark.parametrize("which", ["reference", "port"])
def test_cluster_metrics_single_process(which, thvd):
    if which == "reference":
        import jax

        import horovod_tpu as rhvd

        rhvd.init(devices=jax.devices())
        try:
            rhvd.allreduce(np.ones((4,), np.float32), average=False,
                           name="tel.agg")
            agg = rhvd.cluster_metrics()
        finally:
            rhvd.shutdown()
    else:
        thvd.allreduce(torch.ones(4), average=False, name="tel.agg")
        agg = thvd.cluster_metrics()
    m = agg["collective.submitted"]
    assert m["ranks"] == 1 and m["sum"] >= 1
    h = agg["collective.negotiate_seconds"]
    assert h["count"] >= 1 and h["p50"] is not None


# ---------------------------------------------------------------------------
# cluster_metrics on 3 gloo ranks, with a real stall seeded
# ---------------------------------------------------------------------------

CLUSTER = """
import json
import os
import time

import horovod_tpu_torch.telemetry as telemetry
from horovod_tpu_torch.ops import collective as C

out = {}
# A stall: rank 0 submits late.op, the others only after rank 0 has
# dumped (HOROVOD_STALL_WARNING_SECONDS=1 in the env).
if RANK == 0:
    h = C.allreduce_async(torch.ones(3), name="late.op")
    deadline = time.monotonic() + 60
    while not any(f.startswith("hvd_flight_rank0") and "stall" in f
                  for f in os.listdir(os.environ["HVD_TPU_FLIGHT_DIR"])):
        assert time.monotonic() < deadline, "no stall dump"
        time.sleep(0.1)
    box = [1]
else:
    box = [None]
dist.broadcast_object_list(box, src=0)
if RANK != 0:
    h = C.allreduce_async(torch.ones(3), name="late.op")
C.synchronize(h)
# Counted before the last collective: a worker's background thread may
# answer rank 0's pull before the worker's main thread runs on past it.
telemetry.counter("cm.rank_counter").inc(10 * (RANK + 1))
for i in range(2):
    hvd.allreduce(torch.ones(4) * RANK, name=f"cm.{i}", average=False)
if RANK == 0:
    agg = hvd.cluster_metrics(timeout=60)
    out["agg"] = np.frombuffer(json.dumps(agg).encode(), np.uint8)
else:
    try:
        hvd.cluster_metrics()
        out["worker_raised"] = np.asarray(0)
    except RuntimeError as e:
        out["worker_raised"] = np.asarray(int("controller" in str(e)))
hvd.allreduce(torch.ones(1), name="cm.done")
finish(out)
"""


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cluster")
    flight_dir = tmp / "flight"
    flight_dir.mkdir()
    old = {k: os.environ.get(k) for k in ("HVD_TPU_FLIGHT_DIR",
                                          "HOROVOD_STALL_WARNING_SECONDS")}
    os.environ["HVD_TPU_FLIGHT_DIR"] = str(flight_dir)
    os.environ["HOROVOD_STALL_WARNING_SECONDS"] = "1"
    try:
        job = GlooJob(tmp, CLUSTER, 3, {"x": np.zeros(1)}, timeout=200)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = job.results()
    return out, flight_dir


def test_cluster_metrics_at_three_ranks(cluster):
    out, _ = cluster
    agg = json.loads(out[0]["agg"].tobytes())
    c = agg["cm.rank_counter"]
    assert c["ranks"] == 3 and c["min"] == 10 and c["max"] == 30
    assert c["sum"] == 60
    assert {int(k): v for k, v in c["per_rank"].items()} == \
        {0: 10, 1: 20, 2: 30}
    s = agg["collective.submitted"]
    assert s["ranks"] == 3 and s["min"] >= 3
    assert agg["collective.negotiate_seconds"]["count"] >= 9


def test_cluster_metrics_refused_on_workers(cluster):
    out, _ = cluster
    assert [int(o["worker_raised"]) for o in out[1:]] == [1, 1]


def test_stall_dump_in_a_real_job_names_the_tensor(cluster):
    _, flight_dir = cluster
    files = sorted(flight_dir.glob("hvd_flight_rank0_*stall*.json"))
    assert files, list(flight_dir.iterdir())
    payload = json.loads(files[0].read_text())
    tail = [e for e in payload["events"] if e["kind"] == "stall"][-1]
    assert "late.op" in tail["args"][0]
    assert "waiting on replicas: [1, 2]" in tail["args"][0]
    assert payload["rank"] == 0
    assert payload["metrics"]["events.stall_warnings"] >= 1


# ---------------------------------------------------------------------------
# MetricsLogger (tests/test_callbacks.py:150-168) and fused
# ---------------------------------------------------------------------------

def test_metrics_logger_callback(thvd):
    from horovod_tpu_torch.callbacks import MetricsLogger

    thvd.allreduce(torch.ones(2), average=False, name="mlog.op")
    logs = {}
    MetricsLogger().on_epoch_end(0, logs)
    assert logs["hvd/collective.submitted"] >= 1, logs
    assert logs["hvd/collective.completed"] >= 1, logs
    logs_all = {}
    MetricsLogger(metrics=["collective.negotiate_seconds"],
                  prefix="t/").on_epoch_end(0, logs_all)
    assert logs_all["t/collective.negotiate_seconds"] >= 1, logs_all


def test_metrics_logger_one_name_all_and_verbose(thvd, capsys):
    from horovod_tpu_torch.callbacks import MetricsLogger

    thvd.allreduce(torch.ones(2), average=False, name="mlog.one")
    logs = {}
    MetricsLogger(metrics="collective.completed").on_epoch_end(0, logs)
    assert list(logs) == ["hvd/collective.completed"]
    logs = {}
    MetricsLogger(metrics="all", verbose=1).on_epoch_end(3, logs)
    assert "hvd/collective.submitted" in logs and len(logs) > 8
    assert "[hvd-telemetry] epoch 3:" in capsys.readouterr().out
    MetricsLogger(metrics="no.such.metric").on_epoch_end(0, None)


@pytest.mark.parametrize("which", ["reference", "port"])
def test_measure_exposed_comm_nonnegative_and_observed(which):
    if which == "reference":
        import jax
        import jax.numpy as jnp

        from horovod_tpu.ops import fused as F

        tel = ref_telemetry
        x = jnp.ones((64, 64), jnp.float32)
        f = jax.jit(lambda x: x @ x)
    else:
        from horovod_tpu_torch.ops import fused as F

        tel = port_telemetry
        x = torch.ones(64, 64)

        def f(x):
            return x @ x
    hist = tel.registry().histogram("fused.exposed_comm_seconds")
    before = hist.snapshot()["count"]
    exposed = F.measure_exposed_comm(f, f, (x,), cycles=3)
    assert exposed >= 0.0
    if tel.enabled():
        assert hist.snapshot()["count"] == before + 1


def test_fused_launches_counted():
    from horovod_tpu_torch.ops import fused as F

    c = port_telemetry.registry().counter("fused.launches")
    before = c.value
    out = F.chunked_map(lambda x: x * 2, torch.arange(8.0), fuse=True,
                        chunks=4)
    assert torch.equal(out, torch.arange(8.0) * 2)
    assert c.value == before + 1


# ---------------------------------------------------------------------------
# The hooks at the ported sites
# ---------------------------------------------------------------------------

def test_cache_flush_and_downgrade_are_flight_recorded():
    from horovod_tpu_torch.ops.cache import ResponseCache

    cache = ResponseCache(rank=0, capacity=8)
    cache.flush("unit flush")
    kinds = [e[1] for e in port_flight.snapshot()[-3:]]
    assert "cache_flush" in kinds
    assert port_flight.snapshot()[-1][2][0] == "unit flush"


def test_withdraw_and_timeline_are_flight_recorded(tmp_path):
    from horovod_tpu_torch.ops.coordinator import Coordinator
    from horovod_tpu_torch.utils.timeline import Timeline

    coord = Coordinator(size=2, fusion_threshold=1 << 20)
    try:
        coord.withdraw("w.op", 1)
    except Exception:  # noqa: BLE001 — nothing pending to withdraw
        pass
    assert ("withdraw", ("w.op", 1)) in [e[1:] for e in
                                         port_flight.snapshot()]
    tl = Timeline(str(tmp_path / "t.json"))
    tl.close()
    kinds = [e[1] for e in port_flight.snapshot()[-4:]]
    assert "timeline_open" in kinds and "timeline_close" in kinds


def test_prefetch_error_is_an_event(thvd, tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(tmp_path))
    port_flight.recorder._last_dump.pop("prefetch-error", None)

    def loader():
        yield torch.ones(2)
        raise ValueError("loader broke")

    it = thvd.prefetch_to_device(loader(), depth=1)
    next(it)
    with pytest.raises(ValueError):
        next(it)
    it.close()
    assert any(e[1] == "prefetch_error" and "loader broke" in e[2][0]
               for e in port_flight.snapshot())
    assert list(tmp_path.glob("*prefetch-error*.json"))


def test_checkpoint_retry_and_error_are_recorded(tmp_path, monkeypatch):
    """A write that fails twice (HVD_TPU_CKPT_RETRIES=2): one
    ``ckpt_retry`` record, then a ``checkpoint_error_event`` and its
    dump."""
    from horovod_tpu_torch.utils import checkpoint as ck

    monkeypatch.setenv("HVD_TPU_CKPT_RETRIES", "2")
    monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(tmp_path / "flight"))
    port_flight.recorder._last_dump.pop("checkpoint-error", None)

    def failing_open(path, *args, **kwargs):
        if ".tmp." in str(path):
            raise OSError(28, "injected write failure", path)
        return open(path, *args, **kwargs)

    monkeypatch.setattr(ck, "open", failing_open, raising=False)
    handle = ck.write_tree_async(str(tmp_path / "m.msgpack"),
                                 {"w": np.arange(4, dtype=np.float32)})
    with pytest.raises(ck.CheckpointError):
        handle.wait(timeout=30.0)
    events = port_flight.snapshot()
    assert any(e[1] == "ckpt_retry" and e[2][0].endswith("m.msgpack")
               for e in events)
    assert any(e[1] == "checkpoint_error" for e in events)
    assert list((tmp_path / "flight").glob("*checkpoint-error*.json"))
