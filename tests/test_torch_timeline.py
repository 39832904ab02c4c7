"""horovod_tpu_torch's timeline (utils/timeline.py) and feature queries
(core/features.py).

* One seeded sequence of timeline calls (negotiation, rank marks, cache
  events and counters, top-level spans, activities, instants, ends) goes
  to the reference's Python ``Timeline`` and to the port's; the files
  hold the same events -- names, phases, pids and args, timestamps left
  out -- once the reference's XLA_* activity names are mapped to the
  port's.
* ``start_timeline``/``stop_timeline`` while another thread keeps cycles
  running: every file is valid JSON and the runtime goes on.
* Each feature query answers what the installed torch reports.
"""

import json
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

import horovod_tpu_torch as thvd
import horovod_tpu_torch.frontends.torch as fhvd
from horovod_tpu_torch.core import features
from horovod_tpu_torch.utils import timeline as ttl

# The reference's activity names and the port's (utils/timeline.py).
ACTIVITY_MAP = {"XLA_ALLREDUCE": "NCCL_ALLREDUCE",
                "XLA_ALLGATHER": "NCCL_ALLGATHER", "XLA_BCAST": "NCCL_BCAST",
                "XLA_ALLTOALL": "NCCL_ALLTOALL",
                "XLA_REDUCESCATTER": "NCCL_REDUCESCATTER"}
SHARED = ["QUEUE", "MEMCPY_IN_FUSION_BUFFER", "MEMCPY_OUT_FUSION_BUFFER",
          "WAIT_FOR_DATA"]


def _calls(seed):
    """A seeded sequence of timeline calls, each as (method, args) with
    the reference's activity name; the port's call maps it."""
    rng = np.random.RandomState(seed)
    ops = ["ALLREDUCE", "ALLGATHER", "BROADCAST", "ALLTOALL"]
    calls = []
    for t in range(6):
        name = f"grad.{t}"
        op = ops[rng.randint(len(ops))]
        calls.append(("negotiate_start", (name, op)))
        for r in rng.permutation(3):
            calls.append(("negotiate_rank_ready", (name, int(r))))
        hit = bool(rng.rand() < 0.5)
        calls.append(("cache_event", (name, hit)))
        calls.append(("cache_counter", (t + int(hit), t)))
        calls.append(("negotiate_end", (name,)))
        calls.append(("start", (name, op, {"phase": "EXECUTE",
                                           "cache": "hit" if hit
                                           else "miss"})))
        acts = [SHARED[0], SHARED[1], list(ACTIVITY_MAP)[rng.randint(5)],
                SHARED[2]]
        for a in acts:
            calls.append(("activity_start", (name, a)))
            if rng.rand() < 0.3:
                calls.append(("instant", (name, "MARK", {"i": t})))
            calls.append(("activity_end", (name,)))
        calls.append(("end", (name, "float32")))
    return calls


def _strip(events):
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


@pytest.mark.parametrize("seed", range(3))
def test_timeline_events_match_the_reference(tmp_path, monkeypatch, seed):
    from horovod_tpu.utils import timeline as jtl

    # The reference's Python writer (not its C++ one) is what the port
    # copies; the port's C++ writer is held to it in test_torch_native.py.
    monkeypatch.setattr(jtl._native, "NATIVE", False)
    monkeypatch.setenv("HVD_TPU_DISABLE_NATIVE", "1")
    # Both packages' trace-context mirrors are off: each would stamp its
    # own trace's (step, cycle) into the args.
    monkeypatch.setattr(jtl, "_context_provider", None)
    monkeypatch.setattr(ttl, "_context_provider", None)
    ref = jtl.Timeline(str(tmp_path / "ref.json"))
    port = ttl.Timeline(str(tmp_path / "port.json"))
    for method, args in _calls(seed):
        getattr(ref, method)(*args)
        if method == "activity_start":
            args = (args[0], ACTIVITY_MAP.get(args[1], args[1]))
        getattr(port, method)(*args)
    ref.close()
    port.close()
    port.close()  # idempotent
    want = _strip(json.loads((tmp_path / "ref.json").read_text()))
    got = _strip(json.loads((tmp_path / "port.json").read_text()))
    for e in want:
        if e.get("name") in ACTIVITY_MAP:
            e["name"] = ACTIVITY_MAP[e["name"]]
    assert got == want
    assert len(got) > 50


def test_start_stop_timeline_while_cycles_run(tmp_path):
    thvd.init(device="cpu")
    stop = threading.Event()
    done = []

    def worker():
        i = 0
        while not stop.is_set():
            fhvd.allreduce(torch.ones(3), name=f"bg.{i % 4}")
            i += 1
        done.append(i)

    t = threading.Thread(target=worker)
    t.start()
    try:
        paths = []
        for k in range(4):
            path = tmp_path / f"tl{k}.json"
            fhvd.start_timeline(str(path))  # also switches files
            paths.append(path)
            for _ in range(3):
                fhvd.allreduce(torch.ones(1), name=f"fg.{k}")
        fhvd.stop_timeline()
        fhvd.stop_timeline()  # no timeline: a no-op
    finally:
        stop.set()
        t.join(timeout=60)
        thvd.shutdown()
    assert done and done[0] > 0
    for k, path in enumerate(paths):
        events = json.loads(path.read_text())  # valid JSON
        names = {e.get("args", {}).get("name") for e in events
                 if e.get("name") == "process_name"}
        assert f"fg.{k}" in names
        assert events[-1]["name"] == "shutdown"


def test_timeline_env_at_init(tmp_path, monkeypatch):
    path = tmp_path / "env.json"
    monkeypatch.setenv("HOROVOD_TIMELINE", str(path))
    thvd.init(device="cpu")
    try:
        thvd.allreduce(torch.ones(2), name="env.op")
    finally:
        thvd.shutdown()
    names = [e.get("name") for e in json.loads(path.read_text())]
    for want in ("NEGOTIATE_ALLREDUCE", "0", "ALLREDUCE", "QUEUE",
                 "MEMCPY_IN_FUSION_BUFFER", "GLOO_ALLREDUCE",
                 "MEMCPY_OUT_FUSION_BUFFER", "shutdown"):
        assert want in names, want


def test_feature_queries_answer_what_torch_reports(monkeypatch):
    # native_built: g++ builds the native runtime here; the env knob
    # selects the Python twins.
    monkeypatch.delenv("HVD_TPU_DISABLE_NATIVE", raising=False)
    want = {"mpi_built": dist.is_mpi_available(), "mpi_enabled": False,
            "nccl_built": dist.is_nccl_available(),
            "gloo_built": dist.is_gloo_available(),
            "gloo_enabled": dist.is_gloo_available(),
            "cuda_built": torch.backends.cuda.is_built(),
            "rocm_built": torch.version.hip is not None,
            "ccl_built": False, "ddl_built": False, "xla_built": False,
            "native_built": True}
    for name, value in want.items():
        assert getattr(features, name)() is value, name
        assert getattr(thvd, name)() is value, name
    monkeypatch.setenv("HVD_TPU_DISABLE_NATIVE", "1")
    assert features.native_built() is False
    monkeypatch.delenv("HVD_TPU_DISABLE_NATIVE")
    for name in ("cuda_built", "gloo_built", "mpi_built", "mpi_enabled",
                 "nccl_built", "rocm_built", "mpi_threads_supported",
                 "start_timeline", "stop_timeline"):
        assert callable(getattr(fhvd, name)), name
    thvd.init(device="cpu")
    try:
        assert fhvd.mpi_threads_supported() is True
    finally:
        thvd.shutdown()
    with pytest.raises(thvd.NotInitializedError):
        thvd.mpi_threads_supported()
