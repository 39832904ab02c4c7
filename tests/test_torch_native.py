"""horovod_tpu_torch's native runtime (native/: the C++ coordinator, wire
format, handle manager and timeline writer, built by g++ at first use).

* The coordinator cases run over both implementations of the port,
  ``py`` and ``native`` (as the reference's tests/test_coordinator.py
  does); the 200 seeded request sequences of
  tests/test_torch_coordinator.py give byte-identical responses from the
  port's native coordinator, the port's ``PyCoordinator`` and the
  reference's ``PyCoordinator``.
* The JOIN-then-late-request sequence gives one response natively too.
* Requests round-trip through ``wire.cc`` byte for byte.
* The handle manager's ids; the native timeline's JSON holds the Python
  writer's events.
* The build: an edited source gets a new hash, a failed build raises,
  ``HVD_TPU_DISABLE_NATIVE=1`` selects the Python twins.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from horovod_tpu.ops import coordinator as jcoord
from horovod_tpu.ops import wire as jwire
from horovod_tpu_torch.native import lib as native
from horovod_tpu_torch.ops import coordinator as tcoord
from horovod_tpu_torch.ops import handles as thandles
from horovod_tpu_torch.ops import wire as twire
from horovod_tpu_torch.utils import timeline as ttl

import test_torch_coordinator as seqs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPLS = ["py", "native"]


def _make(impl, size, threshold):
    if impl == "py":
        return tcoord.PyCoordinator(size, threshold)
    return tcoord.NativeCoordinator(size, threshold)


def _req(rank, name="t", shape=(2,), op="ALLREDUCE", dtype="FLOAT32",
         reduce_op="SUM"):
    return twire.Request(rank, twire.RequestType[op], twire.DataType[dtype],
                         name, tensor_shape=shape,
                         reduce_op=twire.ReduceOp[reduce_op])


def _join(rank):
    return twire.Request(rank, twire.RequestType.JOIN, twire.DataType.UINT8,
                         "hvd.join")


# -- the seeded sequences, three implementations -----------------------------

@pytest.mark.parametrize("block", range(5))
def test_native_py_and_reference_give_the_same_bytes(block):
    """40 sequences a case: every submit's outcome and every poll's packed
    response list agree between the reference's PyCoordinator, the port's
    PyCoordinator and the port's NativeCoordinator."""
    for seed in range(block * 40, block * 40 + 40):
        size, threshold, events = seqs._sequence(seed)
        ref = jcoord.PyCoordinator(size, threshold)
        ports = [_make(i, size, threshold) for i in IMPLS]
        for ev in events:
            if ev[0] in ("submit", "join"):
                f = ev[1] if ev[0] == "submit" else dict(
                    request_rank=ev[1], request_type="JOIN",
                    tensor_type="UINT8", tensor_name="hvd.join",
                    reduce_op="AVERAGE")
                jreq, treq = seqs._requests(f)
                outcome = []
                for coord, req in [(ref, jreq)] + [(p, treq) for p in ports]:
                    try:
                        outcome.append(coord.submit(req, now=ev[2]))
                    except ValueError as exc:
                        outcome.append(str(exc))
                assert outcome[0] == outcome[1] == outcome[2], (seed, ev)
            elif ev[0] == "withdraw":
                for coord in [ref] + ports:
                    coord.withdraw(ev[1], ev[2])
            else:
                want = jwire.pack_response_list(ref.poll_responses({}))
                for p in ports:
                    assert twire.pack_response_list(
                        p.poll_responses({})) == want, seed
        for p in ports:
            p.close()


@pytest.mark.parametrize("impl", IMPLS)
def test_fusion_uses_the_queue_sizes_first(impl):
    coord = _make(impl, 1, 100)
    for i in range(4):
        coord.submit(_req(0, f"g{i}", (4,)), now=0.0)
    sizes = {"g0": 60, "g1": 30, "g2": 20, "g3": 90}
    assert [r.tensor_names for r in coord.poll_responses(sizes)] == \
        [["g0", "g1"], ["g2"], ["g3"]]
    coord.set_fusion_threshold(200)
    for i in range(4):
        coord.submit(_req(0, f"h{i}", (4,)), now=0.0)
    assert [r.tensor_names for r in coord.poll_responses(sizes)] == \
        [["h0", "h1", "h2", "h3"]]
    assert coord.fusion_threshold == 200


@pytest.mark.parametrize("impl", IMPLS)
def test_join_then_late_request_gives_one_response(impl):
    """The JOIN re-ready repair, in both implementations: a rank's request
    for a tensor its JOIN already made ready lists it once."""
    coord = _make(impl, 2, 1 << 20)
    assert coord.submit(_req(0), now=0.0) is False
    assert coord.submit(_join(1), now=0.0) is False
    assert coord.submit(_req(1), now=0.0) is True
    got = coord.poll_responses({})
    assert [(r.response_type, r.tensor_names) for r in got] == \
        [(twire.ResponseType.ALLREDUCE, ["t"])]
    assert coord.poll_responses({}) == []


@pytest.mark.parametrize("impl", IMPLS)
def test_join_completes_pending_tensors_in_submit_order(impl):
    """A JOIN that completes several tensors lists them in the order they
    were first submitted (the Python dict's order; the copied C++ walked
    its map in name order)."""
    coord = _make(impl, 2, 1 << 20)
    for name in ("zeta", "alpha", "mid"):
        coord.submit(_req(0, name), now=0.0)
    coord.submit(_join(1), now=0.0)
    (resp,) = coord.poll_responses({})
    assert resp.tensor_names == ["zeta", "alpha", "mid"]


@pytest.mark.parametrize("impl", IMPLS)
def test_duplicate_withdraw_and_mismatch(impl):
    coord = _make(impl, 2, 1 << 20)
    coord.submit(_req(0, "d"), now=0.0)
    with pytest.raises(ValueError, match="Duplicate request for tensor d "
                       "from replica 0"):
        coord.submit(_req(0, "d"), now=0.0)
    coord.submit(_req(0, "w"), now=0.0)
    coord.withdraw("w", 1)
    coord.submit(_req(0, "m", (3,)), now=0.0)
    coord.submit(_req(1, "m", (4,)), now=0.0)
    got = coord.poll_responses({})
    assert [(r.response_type, r.tensor_names, r.error_message)
            for r in got] == [
        (twire.ResponseType.ERROR, ["w"], tcoord._withdraw_message("w", 1)),
        (twire.ResponseType.ERROR, ["m"],
         "Mismatched allreduce tensor shapes: One rank sent a tensor of "
         "shape [3], but another rank sent a tensor of shape [4].")]


@pytest.mark.parametrize("impl", IMPLS)
def test_stall_warning_names_the_missing_ranks(impl):
    """Python takes ``now``; the native watch runs on its own clock, so a
    threshold of 0 s reports at once."""
    coord = _make(impl, 3, 1 << 20)
    coord.submit(_req(2, "late"), now=time.monotonic() - 5)
    coord.submit(_req(0, "late"), now=time.monotonic() - 5)
    (w,) = coord.check_stalled(time.monotonic(), 0.0)
    assert w.startswith("Tensor late has been pending for ")
    assert "ready replicas: [0, 2]; waiting on replicas: [1]" in w


def test_large_response_lists_grow_the_buffer():
    coord = tcoord.NativeCoordinator(1, 0)
    for i in range(6000):  # ~1.4 MB of packed responses
        coord.submit(_req(0, f"{'x' * 200}.{i:05d}"), now=0.0)
    got = coord.poll_responses({})
    assert len(got) == 6000 and len(coord._out) > 1 << 20


# -- wire.cc ----------------------------------------------------------------

def test_requests_round_trip_through_wire_cc():
    """The native coordinator parses the port's packed request and its
    response carries the request's fields back: name, shape, dtype,
    device, reduce op, process set, splits."""
    lib = native.load()
    rng = np.random.RandomState(7)
    for _ in range(60):
        f = seqs._random_fields(rng, 1)
        f.update(request_rank=0, tensor_name=f"näme.{rng.randint(1000)}",
                 process_set_id=int(rng.randint(3)), root_rank=0)
        _, treq = seqs._requests(f)
        coord = tcoord.NativeCoordinator(1, 1 << 20, lib)
        assert coord.submit(treq) is True
        (resp,) = coord.poll_responses({})
        assert resp.tensor_names == [treq.tensor_name]
        assert resp.process_set_id == treq.process_set_id
        if resp.response_type != twire.ResponseType.ERROR:
            assert resp.tensor_type == treq.tensor_type
            assert [tuple(s) for s in resp.tensor_shapes] == \
                [tuple(treq.tensor_shape)]
            assert resp.devices == [treq.device]
        if treq.request_type == twire.RequestType.ALLTOALL and \
                resp.response_type == twire.ResponseType.ALLTOALL:
            assert resp.tensor_sizes == list(treq.splits or
                                             [treq.tensor_shape[0]])
        if treq.request_type == twire.RequestType.ALLREDUCE:
            assert resp.reduce_op == treq.reduce_op
    coord = tcoord.NativeCoordinator(1, 1 << 20, lib)
    assert lib.hvd_coord_submit(coord._ptr, b"\x00\x06", 2) == -2


# -- handle manager -----------------------------------------------------------

def test_handle_manager_ids():
    lib = native.load()
    hm = lib.hvd_handle_manager_create()
    try:
        ids = [lib.hvd_handle_manager_allocate(hm) for _ in range(5)]
        assert ids == [0, 1, 2, 3, 4]
        assert lib.hvd_handle_manager_poll(hm, 2) == 0
        lib.hvd_handle_manager_mark_done(hm, 2)
        assert lib.hvd_handle_manager_poll(hm, 2) == 1
        lib.hvd_handle_manager_release(hm, 2)
        assert lib.hvd_handle_manager_poll(hm, 2) == 0
        assert lib.hvd_handle_manager_allocate(hm) == 5
    finally:
        lib.hvd_handle_manager_destroy(hm)


@pytest.mark.parametrize("impl", IMPLS)
def test_handle_ids_count_from_zero_either_way(impl, monkeypatch):
    if impl == "py":
        monkeypatch.setenv(native.DISABLE_ENV, "1")
    else:
        monkeypatch.delenv(native.DISABLE_ENV, raising=False)
    hm = thandles.HandleManager()
    assert (hm._lib is None) == (impl == "py")
    hs = [hm.allocate(f"n{i}") for i in range(3)]
    assert [h.id for h in hs] == [0, 1, 2]
    hm.release(1)
    with pytest.raises(ValueError, match="Handle 1 was not created"):
        hm.get(1)
    assert hm.get(2) is hs[2] and hm.live_count() == 2


# -- timeline.cc -------------------------------------------------------------

def _rows(events):
    """Events as (row name, ph, name, args), metadata and timestamps left
    out; counters as their own list."""
    rows = {e["pid"]: e["args"]["name"] for e in events
            if e.get("name") == "process_name"}
    plain, counters = [], []
    for e in events:
        if e.get("ph") == "M":
            continue
        if e.get("name") == "response_cache":
            counters.append(e["args"])
            continue
        plain.append((rows.get(e["pid"], e["pid"]), e["ph"], e.get("name"),
                      e.get("args")))
    return plain, counters


@pytest.mark.parametrize("seed", range(2))
def test_native_timeline_holds_the_python_writers_events(tmp_path,
                                                         monkeypatch, seed):
    import test_torch_timeline as tls

    files = {}
    for impl in IMPLS:
        if impl == "py":
            monkeypatch.setenv(native.DISABLE_ENV, "1")
        else:
            monkeypatch.delenv(native.DISABLE_ENV, raising=False)
        path = tmp_path / f"{impl}.json"
        tl = ttl.Timeline(str(path))
        assert (tl._native is None) == (impl == "py")
        for method, args in tls._calls(seed):
            if method == "activity_start":
                args = (args[0], tls.ACTIVITY_MAP.get(args[1], args[1]))
            getattr(tl, method)(*args)
        tl.close()
        tl.close()  # idempotent
        tl.instant("after", "close")  # a no-op
        files[impl] = json.loads(path.read_text())
    py, nat = _rows(files["py"]), _rows(files["native"])
    assert nat == py
    assert len(py[0]) > 50 and len(py[1]) == 6
    assert files["native"][-1]["name"] == "shutdown"
    # The counter track: a "C" event in Python, an instant on its own row
    # natively (timeline.cc has no counter phase), same args.
    assert {e["ph"] for e in files["py"] if e.get("name") ==
            "response_cache"} == {"C"}
    assert {e["ph"] for e in files["native"] if e.get("name") ==
            "response_cache"} == {"i"}


# -- the build ---------------------------------------------------------------

def test_an_edited_source_gets_a_new_build_hash(tmp_path):
    src = tmp_path / "src"
    shutil.copytree(native.SRC_DIR, src,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    assert native.source_hash(src) == native.source_hash()
    with open(src / "timeline.cc", "a") as f:
        f.write("\n// edited\n")
    assert native.source_hash(src) != native.source_hash()
    built = native.build(src, tmp_path / "out")
    assert built.parent.name == native.source_hash(src)
    assert native.build(src, tmp_path / "out") == built  # built once
    lib = ctypes.CDLL(str(built))
    assert lib.hvd_handle_manager_create() != 0


def test_a_failed_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "src"
    shutil.copytree(native.SRC_DIR, src,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    with open(src / "coordinator.cc", "a") as f:
        f.write("\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="building the native runtime "
                       "failed") as ei:
        native.build(src, tmp_path / "out")
    assert "coordinator.cc" in str(ei.value)
    assert not list((tmp_path / "out").rglob("*.so"))


def test_disable_native_selects_the_python_twins_in_a_subprocess():
    code = (
        "import horovod_tpu_torch as hvd\n"
        "from horovod_tpu_torch.native import lib\n"
        "from horovod_tpu_torch.ops import collective as C, coordinator\n"
        "hvd.init(device='cpu')\n"
        "rt = C._runtime()\n"
        "print(type(rt.coordinator._impl).__name__, rt.handles._lib is None,"
        " hvd.native_built(), lib._lib is not None)\n"
        "hvd.shutdown()\n")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    out = {}
    for flag in ("1", None):
        e = dict(env)
        if flag:
            e[native.DISABLE_ENV] = flag
        else:
            e.pop(native.DISABLE_ENV, None)
        proc = subprocess.run([sys.executable, "-c", code], env=e,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        out[flag] = proc.stdout.split()
    assert out["1"] == ["PyCoordinator", "True", "False", "False"]
    assert out[None] == ["NativeCoordinator", "False", "True", "True"]
