"""hvd-route in horovod_tpu_torch (routing/: the replica client, Router,
FleetAutoscaler and RouterServer) against horovod_tpu's.

The router tier is host code copied from the reference, so every check
here is exact: picks, statuses, stamps, tokens, counters and hashes are
compared with ``==``, no tolerance anywhere.

* tests/test_routing.py's cases run on the port with that module's globals
  repointed (its live-cache case against the port's ``PagedKVCache`` on
  the CPU), and on the reference; the routers each case builds must end in
  the same fleet snapshots.
* 200 seeded sequences of fake-replica health snapshots, dispatches,
  selections, drains, deaths, re-registrations and clock steps go through
  both packages' ``Router`` with an injected clock and sleep: the same
  picks, statuses, ``router`` stamps, merged tokens, sleeps, replica calls
  and ``routing.*`` counter deltas after every operation.  200 more drive
  ``FleetAutoscaler.observe`` over both: the same decisions, fleets,
  seeded and donated chains and counters.
* ``published_page_hashes`` byte for byte the reference's and the keys the
  port's ``PagedKVCache.publish_prefix`` writes.
* Over HTTP on the CPU: two port ``LMServer`` replicas (a toy model)
  behind ``RouterServer``: every completion equal to one engine's, affinity
  hits, the byte tokenizer, a drain mid-generation turned into a
  continuation on the survivor and merged bitwise.
* The chaos matrix's ``router_replica_death`` and ``router_restart`` on
  the CPU through ``matrix.run_scenario``.
"""

import functools
import json
import random
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest

import horovod_tpu.telemetry as ref_telemetry
import horovod_tpu_torch.telemetry as port_telemetry
import test_routing as R
from horovod_tpu import routing as ref_routing
from horovod_tpu.routing import affinity as ref_affinity
from horovod_tpu.routing import autoscale as ref_autoscale
from horovod_tpu.routing import replica as ref_replica
from horovod_tpu.routing import router as ref_router

from horovod_tpu_torch import routing as port_routing
from horovod_tpu_torch.chaos import matrix
from horovod_tpu_torch.routing import affinity as port_affinity
from horovod_tpu_torch.routing import autoscale as port_autoscale
from horovod_tpu_torch.routing import replica as port_replica
from horovod_tpu_torch.routing import router as port_router

PKGS = {
    "reference": SimpleNamespace(
        affinity=ref_affinity, autoscale=ref_autoscale, replica=ref_replica,
        router=ref_router, telemetry=ref_telemetry),
    "port": SimpleNamespace(
        affinity=port_affinity, autoscale=port_autoscale,
        replica=port_replica, router=port_router, telemetry=port_telemetry),
}
PAGE, PPS, FP = R.PAGE, R.PPS, R.FP
COUNTERS = ("routing.requests", "routing.affinity_hits",
            "routing.affinity_pages", "routing.failovers",
            "routing.continuations", "routing.replica_deaths",
            "routing.no_replica_errors", "routing.scale_ups",
            "routing.scale_downs", "routing.scale_vetoes")
GAUGES = ("routing.ready_replicas", "routing.fleet_size")


def test_the_package_exports_the_reference_names():
    assert port_routing.__all__ == ref_routing.__all__
    assert len(port_routing.__all__) == 10
    for name in port_routing.__all__:
        assert getattr(port_routing, name) is not None


# ---------------------------------------------------------------------------
# tests/test_routing.py's cases on both packages
# ---------------------------------------------------------------------------

CASES = [
    "test_prompt_header_hashes_byte_identical_to_live_kv_cache",
    "test_prompt_header_hashes_edge_cases",
    "test_select_least_loaded",
    "test_select_affinity_outweighs_queue",
    "test_select_no_affinity_credit_for_foreign_fingerprint",
    "test_select_headroom_penalty_avoids_full_replica",
    "test_select_deterministic_tie_break",
    "test_dispatch_stamps_and_counts",
    "test_dispatch_drain_continuation_digest_identical",
    "test_dispatch_unreachable_marks_dead_then_backoff_revives",
    "test_dispatch_no_ready_replica_is_503",
    "test_dispatch_rejects_tokenless_payload",
    "test_dispatch_optimistically_publishes_affinity",
    "test_drain_replica_exports_and_stops_traffic",
    "test_autoscaler_scale_up_seeds_from_donor",
    "test_autoscaler_planner_veto",
    "test_autoscaler_scale_down_drains_victim_and_donates",
    "test_autoscaler_never_below_min_or_with_dead_replica",
]


def test_cases_cover_the_reference_file():
    assert set(CASES) == {n for n in dir(R) if n.startswith("test_")}


def _run_case(monkeypatch, name, pkg):
    """One case of tests/test_routing.py with its globals pointed at
    ``pkg``'s routing modules; returns the fleet snapshot of every router
    it built."""
    p = PKGS[pkg]
    built = []

    class Recorded(p.router.Router):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

    monkeypatch.setattr(R, "affinity", p.affinity)
    monkeypatch.setattr(R, "AutoscaleConfig", p.autoscale.AutoscaleConfig)
    monkeypatch.setattr(R, "FleetAutoscaler", p.autoscale.FleetAutoscaler)
    monkeypatch.setattr(R, "ReplicaUnreachable",
                        p.replica.ReplicaUnreachable)
    monkeypatch.setattr(R, "Router", Recorded)
    monkeypatch.setattr(R, "RouterConfig", p.router.RouterConfig)
    if pkg == "port":
        # The live-cache case imports the reference's cache inside its
        # body: it gets the port's, on the CPU.
        import horovod_tpu.serving.kv_cache as ref_kv
        from horovod_tpu_torch.serving.kv_cache import PagedKVCache

        monkeypatch.setattr(ref_kv, "PagedKVCache",
                            functools.partial(PagedKVCache, device="cpu"))
    getattr(R, name)()
    return [(r.replica_names(), r.replica_status(), r.ready_count())
            for r in built]


@pytest.mark.parametrize("name", CASES)
def test_reference_cases_pass_on_the_port_and_route_alike(monkeypatch,
                                                          name):
    port = _run_case(monkeypatch, name, "port")
    ref = _run_case(monkeypatch, name, "reference")
    assert port == ref
    if "hashes" not in name:
        assert port


# ---------------------------------------------------------------------------
# Seeded sequences through both routers
# ---------------------------------------------------------------------------

class SeqReplica:
    """A fake replica for the seeded sequences: the client surface of
    tests/test_routing.py's FakeReplica, plus HTTP error statuses, a flat
    or nested health payload and a client that raises something else."""

    def __init__(self, exc, name, flat):
        self.exc = exc
        self.name = name
        self.flat = flat
        self.ready = True
        self.status = 200
        self.queue_depth = 0
        self.kv_free = 64
        self.fingerprint = FP
        self.prefix_index = []
        self.chains = []
        self.drain_after = None
        self.unreachable = False
        self.broken = False
        self.gen_status = 200
        self.drain_status = 200
        self.calls = []
        self.resumed = []

    def _reach(self, call):
        self.calls.append(call)
        if self.unreachable:
            raise self.exc(self.name)

    def health(self):
        self._reach("health")
        if self.broken:
            raise RuntimeError("a broken client")
        det = {"ready": self.ready, "queue_depth": self.queue_depth,
               "kv_free_pages": self.kv_free, "kv_total_pages": 64,
               "page_size": PAGE, "pages_per_slot": PPS,
               "fingerprint": self.fingerprint,
               "prefix_index": list(self.prefix_index)}
        return self.status, (det if self.flat else {"serving": det})

    def generate(self, payload, timeout=None):
        prompt = [int(t) for t in payload["tokens"]]
        m = int(payload["max_tokens"])
        self._reach(("generate", tuple(prompt), m))
        if self.drain_after is not None:
            k = min(self.drain_after, m)
            self.drain_after = None
            self.ready = False
            return 503, {"tokens": R._complete(prompt, k),
                         "finish_reason": "drained"}
        if self.gen_status != 200:
            return self.gen_status, {"error": "refused",
                                     "tokens": R._complete(prompt, 1)}
        return 200, {"tokens": R._complete(prompt, m),
                     "finish_reason": "length", "text": "leg"}

    def drain(self):
        self._reach("drain")
        self.ready = False
        return self.drain_status, {
            "requests": [], "prefixes": [list(c) for c in self.chains]}

    def prefixes(self):
        self._reach("prefixes")
        return 200, {"prefixes": [list(c) for c in self.chains]}

    def resume(self, payload):
        self._reach("resume")
        self.resumed.append(payload)
        return 200, {"installed": 0}


def _metrics(p):
    out = {n: p.telemetry.counter(n).value for n in COUNTERS}
    out.update({n: p.telemetry.gauge(n).value for n in GAUGES})
    return out


def _delta(before, after):
    return {n: after[n] - before[n] for n in COUNTERS if after[n] != before[n]}


def _pool(rng):
    """Prompts from a few header families (0-3 full pages) with short
    suffixes, plus an empty one."""
    headers = [[rng.randrange(256) for _ in range(PAGE * rng.randint(0, 3))]
               for _ in range(4)]
    return [h + [rng.randrange(256) for _ in range(rng.randint(1, 6))]
            for h in (rng.choice(headers) for _ in range(10))] + [[]]


def _value(rng, attr, pool):
    if attr == "prefix_index":
        prompt = rng.choice(pool)
        return ref_affinity.published_page_hashes(
            FP.encode(), prompt, PAGE, PPS)[:rng.randint(0, PPS)]
    if attr == "chains":
        return [rng.choice(pool) for _ in range(rng.randint(0, 3))]
    return {"queue_depth": lambda: rng.randint(0, 6),
            "kv_free": lambda: rng.choice((0, 1, 3, 64)),
            "ready": lambda: rng.random() < 0.7,
            "status": lambda: rng.choice((200, 200, 503)),
            "fingerprint": lambda: rng.choice((FP, FP, "other", "")),
            "drain_after": lambda: rng.choice((None, 0, 2, 5)),
            "unreachable": lambda: rng.random() < 0.3,
            "broken": lambda: rng.random() < 0.15,
            "gen_status": lambda: rng.choice((200, 200, 200, 400, 500)),
            "drain_status": lambda: rng.choice((200, 500))}[attr]()


ATTRS = ("queue_depth", "kv_free", "ready", "status", "fingerprint",
         "prefix_index", "chains", "drain_after", "unreachable", "broken",
         "gen_status", "drain_status")


def _router_sequence(seed):
    """The data of one sequence: the router's config, the fleet and 30
    operations, all from ``seed``."""
    rng = random.Random(seed)
    pool = _pool(rng)
    cfg = {"queue_weight": rng.choice((0.5, 1.0, 2.0)),
           "affinity_weight": rng.choice((0.5, 1.0, 3.0)),
           "headroom_penalty": rng.choice((1e6, 3.0)),
           "max_attempts": rng.randint(1, 4),
           "index_cap": rng.choice((2, 8, 4096)),
           "probe_base": rng.choice((0.01, 0.05)),
           "probe_cap": rng.choice((0.05, 2.0))}
    names = [f"r{i}" for i in range(rng.randint(1, 4))]
    flat = {n: rng.random() < 0.3 for n in names + ["late"]}
    ops = []
    for _ in range(30):
        kind = rng.choices(
            ("set", "poll", "select", "dispatch", "drain", "tick", "add",
             "remove"), weights=(8, 3, 3, 7, 1, 2, 1, 1))[0]
        if kind == "set":
            attr = rng.choice(ATTRS)
            ops.append(("set", rng.choice(names), attr,
                        _value(rng, attr, pool)))
        elif kind == "poll":
            ops.append(("poll", rng.choice((None, None, rng.choice(names)))))
        elif kind in ("select", "dispatch"):
            ops.append((kind, rng.choice(pool), rng.randint(1, 12)))
        elif kind == "tick":
            ops.append(("tick", rng.choice((0.01, 0.3, 5.0))))
        else:
            ops.append((kind, rng.choice(names + ["late", "ghost"])))
    return cfg, names, flat, ops


def _replay_router(pkg, seed):
    p = PKGS[pkg]
    cfg, names, flat, ops = _router_sequence(seed)
    now = [1000.0]
    sleeps = []
    router = p.router.Router(p.router.RouterConfig(**cfg),
                             clock=lambda: now[0], sleep=sleeps.append)
    fakes = {}

    def fake(n):
        if n not in fakes:
            fakes[n] = SeqReplica(p.replica.ReplicaUnreachable, n,
                                  flat.get(n, False))
        return fakes[n]

    for n in names:
        router.add_replica(n, fake(n))
    router.poll()
    trace = []
    for op in ops:
        before = _metrics(p)
        out = None
        if op[0] == "set":
            setattr(fake(op[1]), op[2], op[3])
        elif op[0] == "poll":
            router.poll(op[1])
        elif op[0] == "select":
            out = router.select(op[1])
        elif op[0] == "dispatch":
            payload = {"max_tokens": op[2], "temperature": 0.0}
            if op[1]:
                payload["tokens"] = op[1]
            out = router.dispatch(payload)
        elif op[0] == "drain":
            out = router.drain_replica(op[1])
        elif op[0] == "tick":
            now[0] += op[1]
        elif op[0] == "add":
            router.add_replica(op[1], fake(op[1]))
        elif op[0] == "remove":
            router.remove_replica(op[1])
        after = _metrics(p)
        trace.append((op[0], out, router.replica_status(),
                      router.ready_count(), router.replica_names(),
                      list(sleeps), _delta(before, after),
                      after["routing.ready_replicas"]))
    return trace, {n: f.calls for n, f in fakes.items()}


def test_seeded_router_sequences_match_the_reference():
    seen = dict.fromkeys(COUNTERS[:7], 0)
    statuses = set()
    for seed in range(200):
        port = _replay_router("port", seed)
        ref = _replay_router("reference", seed)
        assert port == ref, seed
        for step in port[0]:
            for k, v in step[6].items():
                seen[k] += v
            statuses.update(s["status"] for s in step[2].values())
            if step[0] == "dispatch":
                statuses.add(f"http {step[1][0]}")
    # The sequences reach every path the comparison is meant to cover.
    assert all(seen.values()), seen
    assert {"ready", "not_ready", "draining", "dead", "http 200",
            "http 400", "http 500", "http 503"} <= statuses, statuses


def _scaler_sequence(seed):
    rng = random.Random(10_000 + seed)
    pool = [[rng.randrange(256) for _ in range(PAGE * rng.randint(1, 3))]
            for _ in range(6)]
    cfg = {"min_replicas": rng.randint(1, 2),
           "max_replicas": rng.randint(2, 4),
           "up_load": rng.choice((2.0, 4.0)),
           "down_load": rng.choice((0.5, 1.0)),
           "sustain": rng.randint(1, 3), "cooldown": rng.randint(0, 3),
           "seed_prefix_limit": rng.choice((1, 256))}
    names = [f"r{i}" for i in range(rng.randint(1, 3))]
    priced = rng.random() < 0.5
    every = names + ["auto1", "auto2", "auto3"]
    ops = []
    for _ in range(30):
        kind = rng.choices(("load", "chains", "kill", "observe"),
                           weights=(4, 2, 1, 6))[0]
        if kind == "load":
            ops.append(("load", rng.choice(every), rng.randint(0, 12)))
        elif kind == "chains":
            ops.append(("chains", rng.choice(every),
                        [rng.choice(pool)
                         for _ in range(rng.randint(0, 3))]))
        elif kind == "kill":
            ops.append(("kill", rng.choice(every), rng.random() < 0.5))
        else:
            ops.append(("observe", rng.randint(1, 4), rng.randint(1, 4)))
    return cfg, names, priced, ops


def _replay_scaler(pkg, seed):
    p = PKGS[pkg]
    cfg, names, priced, ops = _scaler_sequence(seed)
    router = p.router.Router(p.router.RouterConfig(probe_base=0.01),
                             clock=lambda: 0.0, sleep=lambda s: None)
    fakes = {}
    retired = []
    price = {"need": 0, "have": 0}

    def launch(name):
        fakes[name] = SeqReplica(p.replica.ReplicaUnreachable, name, False)
        return fakes[name]

    for n in names:
        launch(n)
        router.add_replica(n, fakes[n])
    router.poll()
    scaler = p.autoscale.FleetAutoscaler(
        router, launch, retired.append,
        cfg=p.autoscale.AutoscaleConfig(**cfg),
        price=(lambda: price["need"]) if priced else None,
        headroom=(lambda: price["have"]) if priced else None)
    trace = []
    for op in ops:
        before = _metrics(p)
        out = None
        rep = fakes.get(op[1]) if op[0] != "observe" else None
        if op[0] == "load" and rep is not None:
            rep.queue_depth = op[2]
        elif op[0] == "chains" and rep is not None:
            rep.chains = op[2]
            rep.prefix_index = [
                h for c in op[2] for h in ref_affinity.published_page_hashes(
                    FP.encode(), c, PAGE, PPS)]
        elif op[0] == "kill" and rep is not None:
            rep.unreachable = op[2]
        elif op[0] == "observe":
            price["need"], price["have"] = op[1], op[2]
            router.poll()
            out = scaler.observe()
        after = _metrics(p)
        trace.append((op[0], out, router.replica_names(),
                      router.replica_status(), list(retired),
                      {n: list(f.resumed) for n, f in fakes.items()},
                      _delta(before, after), after["routing.fleet_size"]))
    return trace


def test_seeded_autoscaler_sequences_decide_alike():
    decisions = set()
    for seed in range(200):
        port = _replay_scaler("port", seed)
        ref = _replay_scaler("reference", seed)
        assert port == ref, seed
        decisions.update(str(step[1]).split(":")[0] for step in port
                         if step[0] == "observe")
    assert decisions == {"None", "up", "down", "veto"}, decisions


# ---------------------------------------------------------------------------
# The chain hashes
# ---------------------------------------------------------------------------

def test_published_page_hashes_byte_identical_to_reference_and_cache():
    from horovod_tpu_torch.serving.kv_cache import PagedKVCache

    rng = random.Random(3)
    for trial in range(60):
        page, pps = rng.choice((1, 2, 4, 8, 16)), rng.randint(1, 5)
        fp = f"fp-{trial}".encode()
        n = rng.randint(0, page * pps + 3)
        tokens = [rng.randrange(1 << 31) for _ in range(n)]
        got = port_affinity.published_page_hashes(fp, tokens, page, pps)
        assert got == ref_affinity.published_page_hashes(fp, tokens, page,
                                                         pps)
        assert port_affinity.prompt_header_hashes(fp, tokens, page, pps) \
            == ref_affinity.prompt_header_hashes(fp, tokens, page, pps)
        assert len(got) == min(n // page, pps)
        if not 1 <= n <= page * pps:
            continue
        cache = PagedKVCache(n_layers=1, n_heads=1, head_dim=2,
                             max_slots=1, pages_per_slot=pps,
                             page_size=page, prefix_cache=True,
                             fingerprint=fp.decode(), device="cpu",
                             gauges=False)
        cache.begin_slot(0, n)
        assert cache.publish_prefix(0, tokens) == len(got)
        assert set(cache.export_prefix_hashes()) == set(got)
        assert set(cache._index) == {bytes.fromhex(h) for h in got}


# ---------------------------------------------------------------------------
# Over HTTP: two port replicas behind RouterServer
# ---------------------------------------------------------------------------

def _post(port, payload, timeout=120.0):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _await_generated(servers, n, deadline_s=60.0):
    """The name of the server whose engine holds a request with at least
    ``n`` generated tokens."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        for name, srv in servers.items():
            if any(len(r.generated) >= n
                   for _, r in srv.engine.scheduler.active()):
                return name
        time.sleep(0.001)
    raise AssertionError("no replica generated the long request")


def test_router_server_over_two_port_replicas_on_the_cpu():
    from horovod_tpu_torch.routing import (HttpReplicaClient, Router,
                                           RouterConfig, RouterServer)
    from horovod_tpu_torch.serving import LMServer
    from horovod_tpu_torch.telemetry import exporter

    single = matrix._restart_engine("cpu")
    rng = random.Random(21)
    headers = [[rng.randrange(256) for _ in range(16)] for _ in range(2)]
    prompts = [headers[i % 2] + [rng.randrange(256)
                                 for _ in range(rng.randint(3, 5))]
               for i in range(8)]
    long_prompt = [11, 12, 13, 14, 15]
    want = [single.generate(p, max_new_tokens=6) for p in prompts]
    want_text = single.generate(list(b"hello"), max_new_tokens=5)
    want_long = single.generate(long_prompt, max_new_tokens=120)
    servers = {n: LMServer(matrix._restart_engine("cpu", prefix_cache=True),
                           port=0, routes=exporter.RouteRegistry()).start()
               for n in ("a", "b")}
    router = Router(RouterConfig(probe_base=0.01))
    for n, srv in servers.items():
        router.add_replica(n, HttpReplicaClient("127.0.0.1", srv.port))
    before = _metrics(PKGS["port"])
    front = RouterServer(router, port=0, poll_interval=0.05).start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{front.port}/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert r.status == 200
        assert health["routing"]["ready_replicas"] == 2
        # Sequential: each family's later prompts route warm.
        got = [_post(front.port, {"tokens": p, "max_tokens": 6})
               for p in prompts[:4]]
        assert [s for s, _ in got] == [200] * 4
        assert [r["tokens"] for _, r in got] == want[:4]
        assert [r["router"]["affinity_pages"] for _, r in got] == \
            [0, 0, 2, 2]
        assert got[2][1]["router"]["replica"] == \
            got[0][1]["router"]["replica"]
        # Concurrent: the same answers whatever the interleaving.
        with ThreadPoolExecutor(4) as pool:
            rest = list(pool.map(
                lambda p: _post(front.port, {"tokens": p,
                                             "max_tokens": 6}),
                prompts[4:]))
        assert [r["tokens"] for _, r in rest] == want[4:]
        status, text = _post(front.port, {"text": "hello",
                                          "max_tokens": 5})
        assert status == 200 and text["tokens"] == want_text
        # A drain mid-generation: the 503 partial becomes a continuation
        # on the survivor, merged bitwise.
        result = {}
        th = threading.Thread(target=lambda: result.update(
            out=_post(front.port, {"tokens": long_prompt,
                                   "max_tokens": 120})))
        th.start()
        victim = _await_generated(servers, 3)
        export = router.drain_replica(victim)
        th.join(timeout=120)
        status, merged = result["out"]
        assert status == 200
        assert merged["tokens"] == want_long
        assert merged["router"]["resubmits"] == 1
        assert merged["router"]["replica"] != victim
        assert isinstance(export["prefixes"], list)
        assert router.replica_status()[victim]["status"] in (
            "draining", "not_ready")
        # POST /resume of an empty export reopens the drained replica's
        # admission (it answers again, the same tokens).
        direct = HttpReplicaClient("127.0.0.1", servers[victim].port)
        assert direct.generate({"tokens": prompts[0],
                                "max_tokens": 6})[0] == 503
        assert direct.resume({"requests": [], "prefixes": []})[0] == 200
        status, again = direct.generate({"tokens": prompts[0],
                                         "max_tokens": 6})
        assert status == 200 and again["tokens"] == want[0]
        router.poll()
        assert router.ready_count() == 2
        delta = _delta(before, _metrics(PKGS["port"]))
        assert delta["routing.requests"] == 10
        assert delta["routing.affinity_hits"] >= 2
        assert delta["routing.continuations"] == 1
    finally:
        front.close()
        for srv in servers.values():
            srv.close()


# ---------------------------------------------------------------------------
# The chaos matrix's router scenarios on the CPU
# ---------------------------------------------------------------------------

ROUTER_SCENARIOS = ("router_replica_death", "router_restart")


@pytest.fixture(scope="module")
def router_reports():
    """Both scenarios at once (each its fault-free and faulted pass as
    subprocesses)."""
    with ThreadPoolExecutor(len(ROUTER_SCENARIOS)) as pool:
        futures = {n: pool.submit(matrix.run_scenario, matrix.find(n),
                                  device="cpu")
                   for n in ROUTER_SCENARIOS}
        yield {n: f.result() for n, f in futures.items()}


@pytest.mark.parametrize("name", ROUTER_SCENARIOS)
def test_router_scenarios_recover_on_the_cpu(router_reports, name):
    report = router_reports[name]
    assert report["status"] == "PASS", report
    assert report["fired"] == 1
    assert report["unreported"] == []
    assert report["device"] == "cpu"
