"""The port's TCP control channel (``horovod_tpu_torch/ops/transport.py``)
held against the reference's (``horovod_tpu/ops/transport.py``).

* The wire: the frame header and type names, ``_FrameRing``
  (tests/test_chaos.py::test_frame_ring_since_and_overflow), the
  HELLO, TOPO, RECONNECT and RESUME frames byte for byte as each
  package's own code puts them on a socket, ``_assign_topology`` over
  seeded host maps, the knob readers and the deadline message.
* A controller and a worker of the port in one process, on threads
  (tests/test_chaos.py:187-522's ``cp_pair``): a reset resumes with the
  ring's replay; an epoch mismatch resumes cache-less; a frame deadline
  and a truncated frame are named; an exhausted reconnect and an expired
  grace window end in named diagnostics; the connect backoff logs; a
  duplicated batch is taken once; a dropped batch ends in "was
  abandoned"; a resume resets the peer's clock samples.
"""

import glob
import json
import random
import socket
import struct
import threading
import time

import pytest

from horovod_tpu.ops import transport as RT
from horovod_tpu_torch import chaos
from horovod_tpu_torch import telemetry as tel
from horovod_tpu_torch.ops import cache as port_cache
from horovod_tpu_torch.ops import transport as T
from horovod_tpu_torch.ops import wire
from horovod_tpu_torch.ops.coordinator import Coordinator
from horovod_tpu_torch.telemetry import flight


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _read_frame(sock):
    hdr = b""
    while len(hdr) < 5:
        hdr += sock.recv(5 - len(hdr))
    length, ftype = struct.unpack("<IB", hdr)
    body = b""
    while len(body) < length:
        body += sock.recv(length - len(body))
    return ftype, hdr + body


class _Stub:
    """Just the attributes the transports' handshake and resume methods
    read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


# ---------------------------------------------------------------------------
# The wire, against the reference
# ---------------------------------------------------------------------------

def test_header_and_frame_names_are_the_references():
    assert T._HDR.format == RT._HDR.format
    for ftype in range(-1, 26):
        assert T.frame_name(ftype) == RT.frame_name(ftype), ftype
    for name in dir(RT):
        if name.startswith("FRAME_"):
            assert getattr(T, name) == getattr(RT, name), name


@pytest.mark.parametrize("ring_cls", [T._FrameRing, RT._FrameRing])
def test_frame_ring_since_and_overflow(ring_cls):
    r = ring_cls(limit=4)
    for i in range(6):
        r.append(8, bytes([i]))
    assert r.count == 6
    assert [p for _, p in r.since(3)] == [b"\x03", b"\x04", b"\x05"]
    assert r.since(6) == []
    assert r.since(1) is None
    assert r.since(7) is None


def _handshake_hello(mod, monkeypatch):
    """The HELLO a package's worker handshake puts on the wire (rank 5,
    host "hostA"), with a TOPO already waiting for it."""
    a, b = socket.socketpair()
    try:
        b.sendall(struct.pack("<IB", 20, 3)
                  + struct.pack("<iiiii", 1, 2, 0, 1, 1))
        stub = _Stub(_sock=a, rank=5)
        mod.WorkerTransport._handshake(stub, "hostA")
        ftype, raw = _read_frame(b)
        return ftype, raw, stub
    finally:
        a.close()
        b.close()


def test_hello_is_the_references_byte_for_byte(monkeypatch):
    monkeypatch.setenv("HVD_TPU_COMPRESSION", "int8")
    monkeypatch.setenv("HVD_TPU_TREE", "off")
    f_ref, raw_ref, stub_ref = _handshake_hello(RT, monkeypatch)
    f_port, raw_port, stub_port = _handshake_hello(T, monkeypatch)
    assert f_ref == f_port == T.FRAME_HELLO
    assert raw_port == raw_ref
    assert T.parse_hello(raw_port[5:])[:2] == (5, "hostA")
    assert "HVD_TPU_COMPRESSION=int8" in T.parse_hello(raw_port[5:])[2]
    # Both read the same TOPO the same way.
    assert tuple(stub_port.topology.__dict__.values()) == \
        tuple(stub_ref.topology.__dict__.values()) == (1, 2, 0, 1)
    assert stub_port.controller_cache is stub_ref.controller_cache is True


def _controller_topo(make, hello_frame, n_expected_children=1):
    """Run a package's controller handshake for a 2-rank job and return
    the TOPO frame the connecting worker gets."""
    port = _free_port()
    holder = {}

    def run():
        holder["ctrl"] = make(port)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    deadline = time.monotonic() + 10.0
    while True:
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=5.0)
            break
        except OSError:
            assert time.monotonic() < deadline
            time.sleep(0.02)
    try:
        s.sendall(hello_frame)
        _ftype, raw = _read_frame(s)
    finally:
        th.join(timeout=10.0)
        holder["ctrl"].close()
        s.close()
    return raw


def _port_controller(world, tree=None):
    def make(port):
        c = T.ControllerTransport(world, port, tree=tree)
        c.accept(hostname="hostA")
        return c
    return make


def _ref_controller(world, tree=None):
    def make(port):
        return RT.ControllerTransport(object(), world, port,
                                      hostname="hostA", tree=tree)
    return make


@pytest.mark.parametrize("cache_env", ["1", "0"])
def test_topo_is_the_references_byte_for_byte(monkeypatch, cache_env):
    monkeypatch.setenv("HVD_TPU_RESPONSE_CACHE", cache_env)
    hello = T.pack_hello(1, "hostB", "K=v")
    frame = struct.pack("<IB", len(hello), T.FRAME_HELLO) + hello
    raw_port = _controller_topo(_port_controller(2), frame)
    raw_ref = _controller_topo(_ref_controller(2), frame)
    assert raw_port == raw_ref
    assert raw_port[4] == T.FRAME_TOPO


def test_topo_tree_is_the_references_byte_for_byte(monkeypatch):
    from horovod_tpu.ops import tree as rtree
    from horovod_tpu_torch.ops import tree as ptree

    entries = [(1, "hostB", "K=v"), (2, "hostA", "K=v")]
    hello = ptree.pack_hello_tree(entries)
    assert hello == rtree.pack_hello_tree(entries)
    frame = struct.pack("<IB", len(hello), T.FRAME_HELLO_TREE) + hello
    raw_port = _controller_topo(
        _port_controller(3, ptree.build_layout(3, 1)), frame)
    raw_ref = _controller_topo(
        _ref_controller(3, rtree.build_layout(3, 1)), frame)
    assert raw_port == raw_ref
    assert raw_port[4] == T.FRAME_TOPO_TREE


def _reconnect_frames(mod, resume_payload, cache):
    """One ``_try_resume`` of a package's worker against a fake
    controller answering ``resume_payload``: the RECONNECT it sent, its
    return value and the frames it replayed."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    got = {}

    def serve():
        conn, _ = srv.accept()
        got["reconnect"] = _read_frame(conn)[1]
        conn.sendall(struct.pack("<IB", len(resume_payload), 12)
                     + resume_payload)
        conn.settimeout(1.0)
        replay = b""
        try:
            while True:
                chunk = conn.recv(4096)
                if not chunk:
                    break
                replay += chunk
        except OSError:
            pass
        got["replay"] = replay
        conn.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    ring = mod._FrameRing(8)
    for i in range(4):
        ring.append(8, bytes([i]) * 3)
    dropped = []
    stub = _Stub(_host="127.0.0.1", _port=port, rank=2, _rx_count=17,
                 cache=cache, _ring=ring, _send_lock=threading.Lock(),
                 _sock=socket.socket(), _broken=True,
                 _drop_cache_replica=lambda: dropped.append(1))
    out = mod.WorkerTransport._try_resume(stub, 5.0)
    if out is None:
        stub._sock.close()
    th.join(timeout=10.0)
    srv.close()
    return got["reconnect"], out, got.get("replay", b""), dropped


@pytest.mark.parametrize("verdict", [0, 1, 2])
def test_reconnect_and_resume_are_the_references(verdict):
    cache = port_cache.ResponseCache(rank=2)
    cache.flush("epoch 1")
    reason = {0: "declared dead", 1: "", 2: "cache epoch 1 != 0"}[verdict]
    resume = T.pack_resume(2, verdict, reason)
    assert resume == struct.pack("<IBH", 2, verdict, len(reason)) \
        + reason.encode()
    r_port = _reconnect_frames(T, resume, cache)
    r_ref = _reconnect_frames(RT, resume, cache)
    # RECONNECT byte for byte: rank, frames received, epoch, has cache.
    assert r_port[0] == r_ref[0]
    assert struct.unpack_from("<iIiB", r_port[0], 5) == (2, 17, 1, 1)
    # Both read the verdict alike and replay the same suffix.
    assert (r_port[1] is None) == (r_ref[1] is None) == (verdict != 0)
    assert r_port[2] == r_ref[2]
    if verdict:
        assert r_port[2] == b"".join(
            struct.pack("<IB", 3, 8) + bytes([i]) * 3 for i in (2, 3))
    assert len(r_port[3]) == len(r_ref[3]) == (verdict == 2)


def test_reject_is_the_references_byte_for_byte(capfd):
    outs = []
    for mod in (T, RT):
        a, b = socket.socketpair()
        mod.ControllerTransport._reject_reconnect(_Stub(), a, 3,
                                                  "declared dead")
        outs.append(_read_frame(b)[1])
        b.close()
    assert outs[0] == outs[1]
    assert "rejecting reconnect from rank 3" in capfd.readouterr().err


def test_withdraw_frame_is_the_references():
    payload = T.pack_withdraw(3, "grad.w", 4)
    assert payload == (struct.pack("<i", 3) + struct.pack("<H", 6)
                       + b"grad.w" + struct.pack("<H", 4))
    assert T.parse_withdraw(payload) == (3, "grad.w", 4)


@pytest.mark.parametrize("seed", range(6))
def test_assign_topology_is_the_references(seed):
    rng = random.Random(seed)
    world = rng.randint(1, 24)
    hosts = {r: f"h{rng.randint(0, 4)}" for r in range(world)}
    got = T._assign_topology(hosts)
    want = RT._assign_topology(hosts)
    assert {r: tuple(t.__dict__.values()) for r, t in got.items()} == \
        {r: tuple(t.__dict__.values()) for r, t in want.items()}


@pytest.mark.parametrize("env", [
    {}, {"HVD_TPU_RECONNECT": "0", "HVD_TPU_RECONNECT_GRACE": "1.5",
         "HVD_TPU_RECONNECT_DEADLINE": "2", "HVD_TPU_RECONNECT_RING": "7",
         "HVD_TPU_FRAME_TIMEOUT": "0"},
    {"HVD_TPU_FRAME_TIMEOUT": "0.25"}])
def test_knob_readers_are_the_references(monkeypatch, env):
    for k in ("HVD_TPU_RECONNECT", "HVD_TPU_RECONNECT_GRACE",
              "HVD_TPU_RECONNECT_DEADLINE", "HVD_TPU_RECONNECT_RING",
              "HVD_TPU_FRAME_TIMEOUT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for fn in ("_reconnect_enabled", "_grace_seconds",
               "_reconnect_deadline_seconds", "_ring_limit",
               "_frame_timeout"):
        assert getattr(T, fn)() == getattr(RT, fn)(), fn
    if not env:
        assert (T._reconnect_enabled(), T._grace_seconds(),
                T._reconnect_deadline_seconds(), T._ring_limit(),
                T._frame_timeout()) == (True, 10.0, 10.0, 1024, 30.0)


def test_deadline_message_is_the_references(monkeypatch, capfd):
    monkeypatch.setenv("HVD_TPU_FRAME_TIMEOUT", "0.5")
    e_port = T._frame_deadline("rank 1", "REQUEST_BATCH", 2, 100)
    e_ref = RT._frame_deadline("rank 1", "REQUEST_BATCH", 2, 100)
    assert str(e_port) == str(e_ref) == (
        "control-plane frame deadline exceeded: peer rank 1 stalled "
        "mid-frame (REQUEST_BATCH, 2/100 bytes within 0.5s)")
    assert isinstance(e_port, OSError)
    err = capfd.readouterr().err
    assert err.count("WARNING: control-plane frame deadline") == 2


# ---------------------------------------------------------------------------
# A controller and a worker of the port, in one process
# ---------------------------------------------------------------------------

@pytest.fixture()
def cp_pair():
    """Rank 0's and rank 1's ends over loopback, each with a response
    cache replica."""
    ctrl = T.ControllerTransport(2, 0)
    th = threading.Thread(target=ctrl.accept, daemon=True)
    th.start()
    worker = T.WorkerTransport("127.0.0.1", ctrl.port, 1)
    th.join(timeout=10.0)
    ctrl.cache = port_cache.ResponseCache(rank=0)
    worker.cache = port_cache.ResponseCache(rank=1)
    yield ctrl, worker
    worker.close()
    ctrl.close()


def _cycle(ctrl, worker, batch=b"", payload=b"", timeout=10.0):
    """One lockstep cycle: rank 1 sends ``batch`` and takes a payload on
    a thread while rank 0 gathers and broadcasts ``payload``.  Returns
    (rank 0's gathered batches, the payload rank 1 took)."""
    got = {}

    def work():
        worker.gather(batch)
        got["payload"] = worker.broadcast()

    th = threading.Thread(target=work, daemon=True)
    th.start()
    batches = ctrl.gather(b"")
    ctrl.broadcast(payload)
    th.join(timeout=timeout)
    assert not th.is_alive(), "the worker never took the payload"
    return batches, got["payload"]


def _metric(name):
    return tel.metrics().get(name, {}).get("value", 0)


def _stderr_until(capfd, *needles, seconds=5.0):
    """The captured stderr, read until every needle is in it (a line
    printed by another thread may land a moment later)."""
    err = ""
    deadline = time.monotonic() + seconds
    while True:
        err += capfd.readouterr().err
        if all(n in err for n in needles) or time.monotonic() > deadline:
            return err
        time.sleep(0.05)


def _crash(ctrl):
    """Rank 0's process gone: connections reset, listener closed, no
    exit handshake."""
    ctrl._closing = True
    with ctrl._lock:
        conns = [s.conn for s in ctrl._sess.values() if s.conn is not None]
    for conn in conns:
        T._hard_close(conn)
    T._wake_close(ctrl._srv)


def test_reset_resumes_the_session_with_ring_replay(cp_pair, tmp_path,
                                                   monkeypatch, capfd):
    monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(tmp_path))
    ctrl, worker = cp_pair
    assert _cycle(ctrl, worker, b"a", b"A") == ([b"", b"a"], b"A")
    assert _cycle(ctrl, worker, b"b", b"B") == ([b"", b"b"], b"B")
    before = _metric("transport.reconnects")
    T._hard_close(worker._sock)  # the fault
    # The batch sent into the broken connection waits in the ring and
    # reaches rank 0 with the resume's replay.
    assert _cycle(ctrl, worker, b"c", b"C") == ([b"", b"c"], b"C")
    assert _metric("transport.reconnects") == before + 1
    assert worker.cache is not None  # resumed with the replica
    assert _cycle(ctrl, worker, b"d", b"D") == ([b"", b"d"], b"D")
    err = _stderr_until(capfd, "session resumed", "rank 1 resumed")
    assert "session resumed" in err and "rank 1 resumed" in err
    dumps = sorted(glob.glob(str(tmp_path / "*reconnect*.json")))
    assert dumps, sorted(glob.glob(str(tmp_path / "*")))
    tail = json.loads(open(dumps[-1]).read())["events"][-10:]
    assert any(e["kind"] == "reconnected" for e in tail), tail
    kinds = [e[1] for e in flight.snapshot()]
    assert "peer_disconnect" in kinds and "reconnect_accepted" in kinds


def test_epoch_mismatch_resumes_cache_less(cp_pair, capfd):
    ctrl, worker = cp_pair
    dropped = []
    worker.on_cache_dropped = lambda: dropped.append(1)
    _cycle(ctrl, worker, b"a", b"A")
    # A flush rank 0 never broadcast: the verdict must catch it.
    worker.cache.flush("test-induced desync")
    before = ctrl.cache.epoch
    T._hard_close(worker._sock)
    assert _cycle(ctrl, worker, b"b", b"B") == ([b"", b"b"], b"B")
    assert worker.cache is None and dropped == [1]
    assert ctrl.cache.epoch == before + 1  # rank 0 flushed its own
    assert ctrl.take_orphans() == []
    err = _stderr_until(capfd, "resuming cache-less", "cache epoch")
    assert "resuming cache-less" in err
    assert "cache epoch" in err


def test_frame_deadline_names_peer_and_frame_type(monkeypatch, capfd):
    monkeypatch.setenv("HVD_TPU_FRAME_TIMEOUT", "0.4")
    ctrl = T.ControllerTransport(2, 0)
    th = threading.Thread(target=ctrl.accept, daemon=True)
    th.start()
    worker = T.WorkerTransport("127.0.0.1", ctrl.port, 1)
    th.join(timeout=10.0)
    try:
        # A REQUEST_BATCH header promising 100 bytes, then silence.
        worker._sock.sendall(struct.pack("<IB", 100, 8) + b"xx")
        deadline = time.monotonic() + 5.0
        event = None
        while time.monotonic() < deadline and event is None:
            event = next((e for e in flight.snapshot()
                          if e[1] == "frame_timeout"), None)
            time.sleep(0.05)
        assert event is not None, "frame deadline never fired"
        assert "rank 1" in str(event) and "REQUEST_BATCH" in str(event)
        err = ""
        deadline = time.monotonic() + 3.0
        while time.monotonic() < deadline \
                and "REQUEST_BATCH, 2/100 bytes" not in err:
            err += capfd.readouterr().err
            time.sleep(0.05)
        assert "REQUEST_BATCH, 2/100 bytes" in err
    finally:
        worker.close()
        ctrl.close()


def test_truncated_frame_is_named(cp_pair, capfd):
    ctrl, worker = cp_pair
    _cycle(ctrl, worker)

    def truncated():
        return any(e[1] == "truncated_frame" for e in flight.snapshot())

    # The worker reconnects only once the controller has read the cut
    # frame: a resume that came first would supersede the old connection
    # before its receive thread ran (seen under load).
    reconnect = worker._reconnect

    def gated():
        deadline = time.monotonic() + 5.0
        while not truncated() and time.monotonic() < deadline:
            time.sleep(0.01)
        return reconnect()

    worker._reconnect = gated
    worker._sock.sendall(struct.pack("<IB", 64, 8) + b"abc")
    T._hard_close(worker._sock)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if truncated():
            break
        time.sleep(0.05)
    else:
        raise AssertionError("truncation never recorded")
    err = capfd.readouterr().err
    assert "truncated control frame" in err
    assert "REQUEST_BATCH" in err


def test_reconnect_exhaustion_poisons_with_a_named_diagnostic(
        cp_pair, monkeypatch):
    monkeypatch.setenv("HVD_TPU_RECONNECT_DEADLINE", "1.0")
    ctrl, worker = cp_pair
    _cycle(ctrl, worker)
    _crash(ctrl)
    payload = worker.broadcast()  # the cycle's wait ends with the poison
    kind, resps = T.decode_payload(T.strip_prefixes(payload)[1])
    assert kind == T.PAYLOAD_RESPONSES
    (resp,) = resps
    assert resp.response_type == wire.ResponseType.SHUTDOWN
    assert "no reconnect within" in resp.error_message
    assert wire.DEAD_PEER_MARKER in resp.error_message


def test_grace_expiry_declares_the_rank_lost_with_its_reason(
        cp_pair, monkeypatch):
    monkeypatch.setenv("HVD_TPU_RECONNECT_GRACE", "0.3")
    ctrl, worker = cp_pair
    _cycle(ctrl, worker)
    worker._closing = True  # no exit handshake, no reconnect ever
    T._hard_close(worker._sock)
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and not ctrl.lost_ranks:
        ctrl.expire_grace()
        time.sleep(0.05)
    assert ctrl.lost_ranks == {1}
    assert "no reconnect within 0.3s grace" in ctrl.lost_reasons[1]
    # The gather that waits for it fails with the dead-peer diagnosis.
    with pytest.raises(T.PeerLostError) as info:
        ctrl.gather(b"")
    assert info.value.ranks == [1]
    assert wire.DEAD_PEER_MARKER in str(info.value)
    assert "no reconnect within" in str(info.value)


def test_connect_backoff_logs_attempts_with_remaining_deadline(capfd):
    port = _free_port()  # nothing listens here
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="could not reach"):
        T.WorkerTransport("127.0.0.1", port, 3, connect_timeout=0.7)
    assert time.monotonic() - t0 < 10.0
    err = capfd.readouterr().err
    assert "[hvd-connect] rank 3" in err
    assert "before deadline" in err


@pytest.fixture()
def armed(monkeypatch):
    """``armed(spec)`` arms HVD_TPU_FAULTS, ``armed(None)`` disarms."""
    def arm(spec):
        if spec is None:
            monkeypatch.delenv("HVD_TPU_FAULTS", raising=False)
        else:
            monkeypatch.setenv("HVD_TPU_FAULTS", spec)
            monkeypatch.setenv("HVD_TPU_RANK", "1")
        chaos.reload()
    yield arm
    arm(None)


def test_a_duplicated_batch_is_taken_once(cp_pair, armed, capfd):
    ctrl, worker = cp_pair
    _cycle(ctrl, worker, b"a", b"A")
    armed("transport.dup:count=1@1")
    sent = worker._ring.count
    got = {}

    def work():
        worker.gather(b"b")  # chaos sends it twice
        got["p"] = worker.broadcast()

    th = threading.Thread(target=work, daemon=True)
    th.start()
    assert ctrl.gather(b"") == [b"", b"b"]
    armed(None)  # before rank 0 sends
    ctrl.broadcast(b"B")
    th.join(timeout=10.0)
    assert got["p"] == b"B"
    assert worker._ring.count == sent + 2  # both copies are in the ring
    assert "fired transport.dup" in capfd.readouterr().err
    # The copy never stands in for the next cycle's batch.
    assert _cycle(ctrl, worker, b"c", b"C") == ([b"", b"c"], b"C")


def test_a_dropped_batch_ends_in_was_abandoned(cp_pair, armed):
    """The batch with rank 1's request is lost on the wire (no reset, no
    replay).  Rank 1's timed-out wait withdraws at once; rank 0 takes the
    withdrawal in place of the batch, and the op fails by name."""
    ctrl, worker = cp_pair
    coord = Coordinator(2, 1 << 20)
    req0 = wire.Request(0, wire.RequestType.ALLREDUCE,
                        wire.DataType.FLOAT32, "t.0", -1, -1, (4,),
                        wire.ReduceOp.SUM, 0, ())
    req1 = wire.Request(1, wire.RequestType.ALLREDUCE,
                        wire.DataType.FLOAT32, "t.0", -1, -1, (4,),
                        wire.ReduceOp.SUM, 0, ())
    coord.submit(req0)
    deadline = time.monotonic() + 0.5
    withdrawn = []

    def on_wait():
        # The runtime's withdraw timer (Runtime._withdraw_due).
        if time.monotonic() > deadline and not withdrawn:
            withdrawn.append(1)
            worker.withdraw("t.0", 0)

    worker.on_wait = on_wait
    armed("transport.drop:count=1@2")
    got = {}

    def work():
        worker.gather(T.encode_request(req1))  # dropped
        got["p"] = worker.broadcast()

    th = threading.Thread(target=work, daemon=True)
    th.start()
    batches = ctrl.gather(b"")
    armed(None)
    assert batches[1] == T.encode_withdraw("t.0", 0)
    for kind, (psid, name) in T.decode_batch(batches[1]):
        coord.withdraw(name, 1)
    (err,) = coord.poll_responses({})
    ctrl.broadcast(T.encode_responses([err]))
    th.join(timeout=10.0)
    (resp,) = T.decode_payload(got["p"])[1]
    assert resp.response_type == wire.ResponseType.ERROR
    assert "Collective t.0 was abandoned: rank 1" in resp.error_message


def test_a_resume_resets_the_peers_clock_samples(cp_pair):
    """Reference :1041: the clock estimate restarts on a resume; a probe
    replayed after it answers with a huge round trip, which the min-RTT
    filter throws away as soon as a fresh probe lands."""
    ctrl, worker = cp_pair
    _cycle(ctrl, worker)
    ctrl.clock.on_pong(1, 10.0, 10.5, 10.002)
    assert 1 in ctrl.clock.offsets()
    T._hard_close(worker._sock)
    _cycle(ctrl, worker)
    deadline = time.monotonic() + 5.0
    while 1 in ctrl.clock.offsets() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert 1 not in ctrl.clock.offsets()
    ctrl.clock.on_pong(1, 1.0, 25.0, 20.0)  # replayed: RTT 19 s
    ctrl.clock.on_pong(1, 30.0, 30.7, 30.001)  # fresh: RTT 1 ms
    assert abs(ctrl.clock.offsets()[1] - (30.7 - 30.0005)) < 1e-9


def test_env_fingerprint_names_the_references_knobs_in_order(monkeypatch):
    """The HELLO's fingerprint: the same knobs, in the same order, as the
    reference's (the tree's three among them)."""
    from horovod_tpu.ops import compression as ref_compression
    from horovod_tpu_torch.ops import compression as port_compression

    monkeypatch.setenv("HVD_TPU_TREE", "on")
    monkeypatch.setenv("HVD_TPU_TREE_FANOUT", "4")
    port = port_compression.env_fingerprint()
    ref = ref_compression.env_fingerprint()
    assert [kv.split("=")[0] for kv in port.split(";")] == \
        [kv.split("=")[0] for kv in ref.split(";")]
    assert port == ref
    for knob in ("HVD_TPU_TREE", "HVD_TPU_TREE_FANOUT",
                 "HVD_TPU_TREE_THRESHOLD"):
        assert knob + "=" in port


@pytest.mark.parametrize("hosts,master,want", [
    (["hostA", "hostA"], None, ("127.0.0.1", "127.0.0.1")),
    (["hostA", "hostB"], None, ("0.0.0.0", "<self>")),
    (["hostA", "hostB"], "10.1.2.3", ("0.0.0.0", "10.1.2.3")),
    (["hostA", "hostA"], "localhost", ("127.0.0.1", "localhost")),
])
def test_control_address_follows_the_ranks_hosts(monkeypatch, hosts, master,
                                                 want):
    """Rank 0's listener: loopback on one host; across hosts with no
    ``MASTER_ADDR`` (a group set up by its own ``init_method``), every
    interface and this host's name, so remote workers reach it."""
    from horovod_tpu_torch.core import state

    if master is None:
        monkeypatch.delenv("MASTER_ADDR", raising=False)
    else:
        monkeypatch.setenv("MASTER_ADDR", master)
    bind, host = state._control_address(hosts)
    assert (bind, host if want[1] != "<self>" else "<self>") == want
    if want[1] == "<self>":
        assert host == socket.gethostname()


_TWO_HOSTS = """
import socket, sys
import torch, torch.distributed as dist
import horovod_tpu_torch as hvd

rank, store = int(sys.argv[1]), sys.argv[2]
if rank == 1:
    socket.gethostname = lambda: "fakehost-1"
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
hvd.init(device="cpu")
from horovod_tpu_torch.core import state
ch = state._state.channel
bound = ch._srv.getsockname()[0] if rank == 0 else ch._host
out = hvd.allreduce(torch.tensor([rank + 1.0]), name="x", op=hvd.Sum)
print("RESULT", rank, hvd.cross_size(), hvd.local_size(), bound,
      float(out[0]), flush=True)
hvd.shutdown()
"""


def test_a_job_across_two_host_names_reaches_rank_0(tmp_path):
    """Two ranks whose host names differ and no ``MASTER_ADDR``: rank 0
    listens on every interface and sends its host name, the worker
    connects to it, and the topology splits by host."""
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "HVD_TPU_CONTROLLER_PORT")}
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TWO_HOSTS, str(r), store], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    res = [next(l.split() for l in out.splitlines()
                if l.startswith("RESULT")) for out in outs]
    assert res[0][1:] == ["0", "2", "1", "0.0.0.0", "3.0"]
    assert res[1][1:] == ["1", "2", "1", socket.gethostname(), "3.0"]
