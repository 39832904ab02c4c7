"""horovod_tpu_torch's HTTP front door (serving/server.py on
telemetry/exporter.py's route registry), case for case with
tests/test_serving.py:694-1010: the route registry and its health
contributors, ``LMServer`` over HTTP on port 0 (readiness, /generate with
tokens and text, error statuses, /metrics and /prefixes on the same
listener), concurrent requests equal to ``engine.generate``, a client
that disconnects freeing its slot, and the serve loop's recovery through
``abort_all``.  Also the telemetry copies against the reference's.
"""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

import horovod_tpu_torch.telemetry as telemetry
from horovod_tpu.models import transformer as RT
from horovod_tpu.telemetry import exporter as ref_exporter
from horovod_tpu.telemetry.registry import MetricsRegistry as RefRegistry
from horovod_tpu.telemetry.registry import aggregate as ref_aggregate
from horovod_tpu_torch.models.transformer import TransformerConfig
from horovod_tpu_torch.serving import LMServer
from horovod_tpu_torch.serving.server import decode_tokens, encode_text
from horovod_tpu_torch.telemetry import exporter
from horovod_tpu_torch.telemetry.registry import MetricsRegistry
from horovod_tpu_torch.utils.convert import params_from_jax
from torch_serving_cases import make_engine

# tests/test_serving.py's byte-tokenizer model (vocab 256), seed 5.
BYTE_CFG = TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                             n_layers=2, d_ff=128, max_seq_len=64)
BYTE_PARAMS = params_from_jax(jax.tree_util.tree_map(
    np.asarray, RT.init_transformer(jax.random.PRNGKey(5), RT.TransformerConfig(
        vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
        max_seq_len=64))), requires_grad=False)


def byte_engine(**kw):
    kw.setdefault("max_slots", 2)
    return make_engine(BYTE_PARAMS, BYTE_CFG, **kw)


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _post(url, payload, timeout=60):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _http_error(fn, *args):
    with pytest.raises(urllib.error.HTTPError) as info:
        fn(*args)
    return info.value.code, json.loads(info.value.read())


def _server(engine):
    return LMServer(engine, port=0, routes=exporter.RouteRegistry())


# ---------------------------------------------------------------------------
# Telemetry: the registry and exporter copies
# ---------------------------------------------------------------------------

def test_registry_snapshot_and_prometheus_text_equal_the_references():
    regs = [MetricsRegistry(enabled=True),
            RefRegistry(enabled=True)]
    for reg in regs:
        reg.counter("serving.tokens", "t").inc(3)
        reg.gauge("serving.depth", "d").set(2)
        h = reg.histogram("serving.lat", "seconds", "l")
        for v in (1e-4, 0.003, 0.5, 40.0):
            h.observe(v)
    port, ref = (r.snapshot() for r in regs)
    assert port == ref
    assert exporter.prometheus_text(port) == ref_exporter.prometheus_text(ref)
    assert telemetry.aggregate({0: port, 1: port}) == \
        ref_aggregate({0: ref, 1: ref})


def test_registry_disabled_and_type_conflicts():
    reg = MetricsRegistry(enabled=False)
    reg.counter("a").inc()
    assert reg.snapshot()["a"]["value"] == 0
    reg.set_enabled(True)
    reg.counter("a").inc(2)
    assert reg.snapshot()["a"]["value"] == 2
    with pytest.raises(TypeError):
        reg.gauge("a")
    reg.histogram("h", "bytes")
    with pytest.raises(TypeError):
        reg.histogram("h", "seconds")


def test_counter_is_exact_under_concurrent_writers():
    reg = MetricsRegistry(enabled=True)
    c = reg.counter("n")

    def work():
        for _ in range(5000):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert c.value == 40000


def test_error_and_exception_events_are_kept():
    before = telemetry.metrics()["events.errors"]["value"]
    telemetry.error_event("unit error")
    telemetry.exception_event("unit", "RuntimeError: boom")
    events = telemetry.recent_events()[-2:]
    assert [(e["kind"], e["where"], e["text"]) for e in events] == [
        ("error", "", "unit error"), ("exception", "unit",
                                      "RuntimeError: boom")]
    assert telemetry.metrics()["events.errors"]["value"] == before + 2


def test_route_registry_dispatch_and_health_contributors():
    routes = exporter.routes()
    calls = []

    def handler(query, body):
        calls.append((query, body))
        return 200, b'{"pong": true}', "application/json"

    routes.register("/ping", handler, methods=("GET", "POST"))
    routes.register_health("unit", lambda: (False, {"why": "testing"}))
    exp = exporter.start_exporter(MetricsRegistry(), 0, host="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{exp.port}"
        status, body = _get(base + "/ping?x=1")
        assert status == 200 and body["pong"] is True
        assert calls[0][0] == "x=1"
        code, payload = _http_error(_get, base + "/healthz")
        assert code == 503 and payload["status"] == "NOT_READY"
        assert payload["unit"] == {"why": "testing"}
        assert payload["initialized"] is False and payload["rank"] is None
        routes.register_health("unit", lambda: (True, {"ok": 1}))
        status, payload = _get(base + "/healthz")
        assert status == 200 and payload["status"] == "ok"
        with pytest.raises(urllib.error.HTTPError) as missing:
            _get(base + "/nothing")
        assert missing.value.code == 404
    finally:
        exp.close()
        routes.unregister("/ping")
        routes.unregister_health("unit")


def test_client_probe_sees_a_closed_peer():
    a, b = socket.socketpair()
    try:
        probe = exporter.ClientProbe(a)
        assert probe.disconnected() is False
        b.sendall(b"x")  # pending data is not a disconnect
        assert probe.disconnected() is False
        a.recv(1)
        b.close()
        assert probe.disconnected() is True
    finally:
        a.close()
    assert exporter.ClientProbe(None).disconnected() is False


def test_byte_tokenizer_roundtrip():
    assert encode_text("hi", 256) == [104, 105]
    assert decode_tokens([104, 105], 256) == "hi"
    assert decode_tokens([300], 512) is None
    with pytest.raises(ValueError, match="vocab_size >= 256"):
        encode_text("hi", 97)


# ---------------------------------------------------------------------------
# LMServer
# ---------------------------------------------------------------------------

def test_lmserver_generate_http_and_readiness():
    """/healthz NOT_READY before warm start, READY after; /generate
    answers with the engine's exact completion; error statuses; /metrics
    and /prefixes on the same listener."""
    prompt = list(b"hi")
    ref = byte_engine()
    ref.warm_start()
    want = ref.generate(prompt, max_new_tokens=6)

    engine = byte_engine()
    routes = exporter.RouteRegistry()
    routes.register_health("serving", engine.health)
    exp = exporter.start_exporter(telemetry.registry(), 0,
                                  host="127.0.0.1", routes=routes)
    base = f"http://127.0.0.1:{exp.port}"
    try:
        code, payload = _http_error(_get, base + "/healthz")
        assert code == 503 and payload["serving"]["ready"] is False
        with LMServer(engine, routes=routes, port=0) as srv:
            srv.start()
            status, health = _get(base + "/healthz")
            assert status == 200 and health["serving"]["ready"] is True
            assert health["serving"]["device"] == "cpu"
            status, resp = _post(base + "/generate",
                                 {"text": "hi", "max_tokens": 6})
            assert status == 200 and resp["tokens"] == want
            assert resp["finish_reason"] == "max_new_tokens"
            assert resp["ttft_ms"] is not None and resp["total_ms"] > 0
            assert isinstance(resp.get("text"), str)
            status, resp2 = _post(base + "/generate",
                                  {"tokens": prompt, "max_tokens": 6})
            assert resp2["tokens"] == want
            for payload in ({}, {"tokens": [999999]}):
                assert _http_error(_post, base + "/generate",
                                   payload)[0] == 400
            engine.scheduler.drain()
            assert _http_error(_post, base + "/generate",
                               {"tokens": prompt})[0] == 503
            engine.scheduler.resume()
            status, resp3 = _post(base + "/generate",
                                  {"tokens": prompt, "max_tokens": 6})
            assert resp3["tokens"] == want
            status, snap = _get(base + "/metrics?format=json")
            assert status == 200 and "serving.tokens_generated" in snap
            status, pre = _get(base + "/prefixes")
            assert status == 200 and pre == {
                "prefixes": engine.export_prefix_index()}
            # The server's own listener answers the same routes.
            status, _ = _get(f"http://127.0.0.1:{srv.port}/healthz")
            assert status == 200
    finally:
        exp.close()


def test_lmserver_timeout_is_a_504():
    engine = byte_engine()
    with _server(engine) as srv:
        srv.start()
        orig = engine._decode_iteration

        def slow(active):
            time.sleep(0.3)
            return orig(active)

        engine._decode_iteration = slow
        code, resp = _http_error(
            _post, f"http://127.0.0.1:{srv.port}/generate",
            {"tokens": [1, 2, 3], "max_tokens": 20, "timeout": 0.5})
        assert code == 504 and "timed out" in resp["error"]


def test_lmserver_survives_engine_exception_and_keeps_serving():
    engine = make_engine()
    with _server(engine) as srv:
        srv.start()
        base = f"http://127.0.0.1:{srv.port}"
        boom = {"armed": True}
        orig = engine._decode_iteration

        def poisoned(active):
            if boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("injected decode failure")
            return orig(active)

        engine._decode_iteration = poisoned
        code, resp = _http_error(_post, base + "/generate",
                                 {"tokens": [1, 2, 3], "max_tokens": 6,
                                  "timeout": 30})
        assert code == 500 and resp["finish_reason"] == "error"
        assert telemetry.recent_events()[-1]["where"] == "serve-loop"
        status, resp2 = _post(base + "/generate",
                              {"tokens": [1, 2, 3], "max_tokens": 6})
        assert status == 200 and resp2["finish_reason"] == "max_new_tokens"
        ref = make_engine()
        ref.warm_start()
        assert resp2["tokens"] == ref.generate([1, 2, 3], max_new_tokens=6)


def test_lmserver_reopens_admission_before_failing_the_requests():
    """The recovery's drain closes admission while it frees the slots; a
    failed request's handler answers only once admission is open again,
    so a client that retries at once is served, however slow the
    recovery (here a freeing that takes 0.3 s)."""
    engine = make_engine()
    with _server(engine) as srv:
        srv.start()
        base = f"http://127.0.0.1:{srv.port}"
        boom = {"armed": True}
        orig, free = engine._decode_iteration, engine._free_all_slots

        def poisoned(active):
            if boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("injected decode failure")
            return orig(active)

        def slow_free():
            time.sleep(0.3)
            free()

        engine._decode_iteration = poisoned
        engine._free_all_slots = slow_free
        code, resp = _http_error(_post, base + "/generate",
                                 {"tokens": [1, 2, 3], "max_tokens": 6,
                                  "timeout": 30})
        assert code == 500 and resp["finish_reason"] == "error"
        status, resp2 = _post(base + "/generate",
                              {"tokens": [1, 2, 3], "max_tokens": 6})
        assert status == 200 and resp2["finish_reason"] == "max_new_tokens"


def test_lmserver_midflight_drain_returns_retryable_503():
    engine = make_engine()
    with _server(engine) as srv:
        srv.start()
        base = f"http://127.0.0.1:{srv.port}"
        orig = engine._decode_iteration

        def draining(active):
            engine._decode_iteration = orig
            engine.drain()

        engine._decode_iteration = draining
        code, resp = _http_error(_post, base + "/generate",
                                 {"tokens": [1, 2, 3], "max_tokens": 6,
                                  "timeout": 30})
        assert code == 503 and resp["finish_reason"] == "drained"
        engine.import_requests([])
        status, resp2 = _post(base + "/generate",
                              {"tokens": [1, 2, 3], "max_tokens": 6})
        assert status == 200 and resp2["finish_reason"] == "max_new_tokens"


def test_lmserver_client_disconnect_releases_slot():
    """A client that closes its connection mid-generation: the handler's
    ClientProbe sees it, the request is aborted through the engine (its
    one slot freed at the next iteration boundary), and the same slot
    serves the next request."""
    engine = make_engine(max_slots=1, capacity=64)
    with _server(engine) as srv:
        srv.start()
        orig = engine._decode_iteration

        def slow(active):
            time.sleep(0.05)
            return orig(active)

        engine._decode_iteration = slow
        before = telemetry.metrics().get("serving.client_disconnects",
                                         {}).get("value", 0)
        body = json.dumps({"tokens": [1, 2, 3], "max_tokens": 60,
                           "timeout": 30}).encode()
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
        sock.sendall(b"POST /generate HTTP/1.1\r\nHost: x\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: " + str(len(body)).encode()
                     + b"\r\n\r\n" + body)
        deadline = time.monotonic() + 10
        while engine.scheduler.occupancy() == 0:
            assert time.monotonic() < deadline, "never admitted"
            time.sleep(0.01)
        sock.close()
        deadline = time.monotonic() + 10
        while telemetry.metrics().get("serving.client_disconnects",
                                      {}).get("value", 0) == before:
            assert time.monotonic() < deadline, "disconnect not seen"
            time.sleep(0.02)
        while engine.scheduler.occupancy():
            assert time.monotonic() < deadline, "slot not released"
            time.sleep(0.02)
        engine._decode_iteration = orig
        status, resp = _post(f"http://127.0.0.1:{srv.port}/generate",
                             {"tokens": [1, 2, 3], "max_tokens": 6})
        assert status == 200 and resp["finish_reason"] == "max_new_tokens"


def test_lmserver_concurrent_http_requests():
    engine = byte_engine()
    with _server(engine) as srv:
        srv.start()
        base = f"http://127.0.0.1:{srv.port}"
        results = {}

        def hit(i):
            results[i] = _post(base + "/generate",
                               {"tokens": [i + 1, 2, 3],
                                "max_tokens": 5})[1]["tokens"]

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    ref = byte_engine()
    ref.warm_start()
    for i in range(4):
        assert results[i] == ref.generate([i + 1, 2, 3], max_new_tokens=5), i


def test_lmserver_close_unregisters_and_stops_the_loop():
    routes = exporter.RouteRegistry()
    srv = LMServer(make_engine(), port=0, routes=routes).start()
    assert set(routes.paths()) == {"/generate", "/drain", "/resume",
                                   "/prefixes"}
    thread = srv._thread
    srv.close()
    assert not thread.is_alive() and routes.paths() == ()
    with pytest.raises(ValueError, match="pass port"):
        LMServer(make_engine(), routes=routes)


def test_serve_lm_example_answers_one_prompt(tmp_path, monkeypatch, capsys):
    """examples/serve_lm.py on a serving checkpoint: the tokens
    engine.generate gives, as its JSON line."""
    from horovod_tpu_torch.examples import serve_lm
    from horovod_tpu_torch.utils.checkpoint import save_serving_checkpoint

    save_serving_checkpoint(str(tmp_path), BYTE_PARAMS, BYTE_CFG,
                            block=True)
    monkeypatch.setattr("sys.argv", [
        "serve_lm", str(tmp_path), "--device", "cpu", "--prompt", "hi",
        "-n", "5", "--slots", "2"])
    serve_lm.main()
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "serve_lm: OK"
    got = json.loads(out[-2])
    want = make_engine(BYTE_PARAMS, BYTE_CFG, max_slots=2, capacity=64)
    assert got["prompt"] == [104, 105]
    assert got["tokens"] == want.generate([104, 105], max_new_tokens=5)
