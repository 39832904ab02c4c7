"""Multi-process serving in horovod_tpu_torch (serving/engine.py ``follow``,
``stop_followers``, ``abort_all``'s marker; serving/server.py ``close``)
against horovod_tpu's.

The reference's scripted ``_bcast`` cases (tests/test_serving.py:827-847,
1111-1128) run on both packages.  Then one job of 2 gloo ranks serves the
small model of tests/torch_serving_cases.py: rank 0 steps a trace with
queueing, a prefix-cache hit, a request that finishes at its prefill, a
client abort and an ``abort_all``; rank 1 follows.  After every
iteration both ranks publish a digest of their page pool, page table,
lengths, free list, prefix LRU and prefix index and last tokens over the
job's group, and they must be equal; the final pools are compared bit
for bit in the parent.  The same with a speculative engine (draft of
tests/test_speculative.py) and with tests/serving_pressure.py's trace (a
client abort and an admission done at its prefill in one iteration, on a
full pool), then rank 0's ``LMServer`` answers a request and its
``close()`` must end the follower's loop.  The pressure trace also runs
with the follower in the same process, plain and speculative.
"""

import jax
import numpy as np
import pytest
import torch

from horovod_tpu.serving import InferenceEngine as RefEngine
from horovod_tpu_torch.serving.scheduler import FinishReason
from gloo_job import GlooJob, flat
from serving_pressure import PRESSURE, pool_state, pressure_trace
from torch_serving_cases import (CFG_R, DRAFT, DRAFT_CFG, DRAFT_R,
                                 DRAFT_SMALL, PARAMS_R, SMALL, make_engine,
                                 rollout)


def _make(which, **kw):
    if which == "port":
        return make_engine(**kw)
    kw.setdefault("max_slots", 3)
    kw.setdefault("page_size", 8)
    kw.setdefault("capacity", 32)
    return RefEngine(PARAMS_R, CFG_R, **kw)


@pytest.mark.parametrize("which", ["reference", "port"])
def test_follow_applies_abort_marker_and_abort_all_broadcasts_it(which):
    eng = _make(which)
    msgs = [{"stop": False, "admit": [(0, [1, 2, 3])]}, {"abort": True}]
    eng._bcast = lambda obj: msgs.pop(0)
    assert eng.follow() is True
    assert msgs == [] and eng.cache.length(0) < 0
    assert eng.cache.free_pages() == eng.cache.n_pages - 1
    eng2 = _make(which)
    sent = []
    eng2._multiprocess = lambda: True
    eng2._bcast = lambda obj: sent.append(obj)
    eng2.submit([1, 2, 3], max_new_tokens=4)
    eng2.abort_all()
    assert {"abort": True} in sent


@pytest.mark.parametrize("which", ["reference", "port"])
def test_engine_abort_all_survives_dead_control_plane(which):
    eng = _make(which)
    eng.warm_start()
    eng._multiprocess = lambda: True

    def dead_bcast(obj):
        raise ConnectionError("control plane down")

    eng._bcast = dead_bcast
    req = eng.submit([1, 2, 3], max_new_tokens=4)
    failed = eng.abort_all()
    assert req in failed and req.finish_reason == FinishReason.ERROR
    eng._multiprocess = lambda: False
    assert eng.generate([1, 2], max_new_tokens=2)


@pytest.mark.parametrize("which", ["reference", "port"])
def test_follow_mirrors_a_scripted_step_and_stops(which):
    """A scripted rank-0 iteration: admission, sync, decode tokens; the
    follower's lengths and last tokens follow, and ``stop`` ends it."""
    eng = _make(which)
    msgs = [{"stop": False, "admit": [(1, [4, 5, 6])]},
            {"last": {1: 7}, "decode": [1], "spec": False, "evict": []},
            {"tokens": {1: 9}, "evict": []},
            {"stop": True}]
    eng._bcast = lambda obj: msgs.pop(0)
    assert eng.follow() is True
    assert eng.cache.length(1) == 4 and int(eng._last_token[1]) == 9
    assert eng.follow() is False and msgs == []


def test_abort_request_is_flight_recorded():
    from horovod_tpu_torch.telemetry import flight

    eng = make_engine()
    req = eng.submit([1, 2, 3], max_new_tokens=4)
    assert eng.abort_request(req) == "queued"
    kind, args = flight.snapshot()[-1][1:]
    assert kind == "serve_abort_request" and args[0] == req.rid


def _relayed_pair(**kw):
    """Rank 0 and a follower as two engines in one process, the leader's
    broadcasts pickled into a queue the follower's receptions read."""
    import collections
    import pickle

    box = collections.deque()
    leader, follower = make_engine(**kw), make_engine(**kw)
    leader._multiprocess = lambda: True
    leader._bcast = lambda obj: box.append(pickle.dumps(obj))
    follower._bcast = lambda obj: pickle.loads(box.popleft())
    return leader, follower, box


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_follower_mirrors_a_cancel_and_a_prefill_finish_in_one_iteration(
        spec):
    """A client abort and an admission that finishes at its prefill in
    the same iteration, on a full pool: the follower frees them in rank
    0's order, so its free list, LRU and prefix index stay rank 0's after
    every iteration, and so do the page tables when later admissions
    reclaim cached pages."""
    kw = {"draft": (DRAFT, DRAFT_CFG), "spec_tokens": 3} if spec else {}
    leader, follower, box = _relayed_pair(prefix_pages=0, **kw)
    iters, hits = [0], []
    begin = leader.cache.begin_slot

    def begin_slot(slot, n, prefix_pages=()):
        hits.append(len(prefix_pages))
        return begin(slot, n, prefix_pages=prefix_pages)

    leader.cache.begin_slot = begin_slot

    def step():
        ran = leader.step()
        assert follower.follow() is True and not box
        for a, b in ((leader.cache, follower.cache),
                     (leader.draft_cache, follower.draft_cache)):
            if a is not None:
                assert pool_state(a) == pool_state(b), iters[0]
                assert torch.equal(a.k_pages[:, 1:], b.k_pages[:, 1:])
        iters[0] += 1
        return ran or not leader.scheduler.idle()

    reqs = pressure_trace(
        step, lambda n: leader.submit(PRESSURE[n][0],
                                      max_new_tokens=PRESSURE[n][1]),
        leader.abort_request)
    assert reqs["A"].finish_reason == FinishReason.CLIENT_DISCONNECT
    assert reqs["B"].finish_reason == "max_new_tokens"
    assert len(reqs["B"].result(0)) == 1
    for n in "BCEF":
        assert reqs[n].result(0) == rollout(PRESSURE[n][0], PRESSURE[n][1],
                                            32), n
    assert max(hits) >= 2  # E mapped A's two cached pages
    leader.stop_followers()
    assert follower.follow() is False


WORKER = """
import hashlib
import json
import urllib.request

from horovod_tpu_torch.models.transformer import TransformerConfig
from horovod_tpu_torch.serving import InferenceEngine, LMServer
from horovod_tpu_torch.telemetry import exporter
from serving_pressure import PRESSURE, pool_state, pressure_trace

SMALL = json.loads(sys.argv[6])
DRAFT_SMALL = json.loads(sys.argv[7])
cfg, dcfg = TransformerConfig(**SMALL), TransformerConfig(**DRAFT_SMALL)
params, draft = tree("target", False), tree("draft", False)


def engine(**kw):
    return InferenceEngine(params, cfg, device="cpu", max_slots=3,
                           page_size=8, capacity=32, **kw)


def digest(eng):
    h = hashlib.sha256()
    for c in (eng.cache, eng.draft_cache):
        if c is None:
            continue
        h.update(c.k_pages.numpy().tobytes())
        h.update(c.v_pages.numpy().tobytes())
        h.update(repr(pool_state(c)).encode())
    # The token state of live slots (a freed slot's last token is not
    # state: rank 0 keeps its pending token, a follower the fed one).
    live = eng.cache._lengths >= 0
    h.update(np.where(live, eng._last_token, -1).tobytes())
    h.update(np.where(live, eng._prev_token, -1).tobytes())
    return h.hexdigest()


def agree(eng):
    '''Both ranks' digests, after the same iteration.'''
    both = [None] * N
    dist.all_gather_object(both, digest(eng))
    return both[0] == both[1]


def state(eng, prefix):
    out = {f"{prefix}/k": eng.cache.k_pages.numpy(),
           f"{prefix}/v": eng.cache.v_pages.numpy(),
           f"{prefix}/table": eng.cache._table.copy(),
           f"{prefix}/lengths": eng.cache._lengths.copy(),
           f"{prefix}/last": np.where(eng.cache._lengths >= 0,
                                      eng._last_token, -1)}
    if eng.draft_cache is not None:
        out[f"{prefix}/dk"] = eng.draft_cache.k_pages.numpy()
        out[f"{prefix}/dv"] = eng.draft_cache.v_pages.numpy()
    return out


out = {}
header = list(range(10, 26))  # two full pages: the prefix hit
prompts = [header + [1, 2], [3, 4, 5], header + [7], [8, 9, 10, 11],
           [12, 13], [14, 15, 16, 17, 18]]
# Leg 1: plain engine; queueing (6 requests, 3 slots), a prefix hit, a
# request done at its prefill, a client abort, then abort_all.
eng = engine()
eng.warm_start()
iters, agreed = 0, 0
if RANK == 0:
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in
            zip(prompts, (6, 5, 4, 1, 7, 3))]
    while not eng.scheduler.idle():
        if iters == 2:
            eng.abort_request(reqs[1])
        eng.step()
        iters += 1
        agreed += agree(eng)
    out["plain/tokens"] = np.asarray(
        [t for r in reqs if r.finish_reason != "client_disconnect"
         for t in r.result(0)])
    out["plain/reasons"] = np.asarray([str(r.finish_reason)
                                       for r in reqs])
    out["plain/prefix_hits"] = np.asarray(
        hvd.metrics()["serving.prefix_hits"]["value"])
    # abort_all with requests in flight: both sides free every slot.
    late = [eng.submit(p, max_new_tokens=8) for p in prompts[:3]]
    eng.step()
    agreed += agree(eng)
    failed = eng.abort_all()
    out["abort/failed"] = np.asarray(len(failed))
    agreed += agree(eng)
    iters += 2
    eng.stop_followers()
else:
    while eng.follow():
        iters += 1
        agreed += agree(eng)
out["plain/iters"] = np.asarray(iters)
out["plain/agreed"] = np.asarray(agreed)
out["abort/free"] = np.asarray(eng.cache.free_pages())
out["abort/n_pages"] = np.asarray(eng.cache.n_pages)
out["abort/lengths"] = eng.cache._lengths.copy()
out.update(state(eng, "plain"))

# Leg 2: speculative (spec_tokens 3, the random draft).
eng = engine(draft=(draft, dcfg), spec_tokens=3)
eng.warm_start()
iters, agreed = 0, 0
if RANK == 0:
    reqs = [eng.submit(p, max_new_tokens=9) for p in prompts[:4]]
    while not eng.scheduler.idle():
        eng.step()
        iters += 1
        agreed += agree(eng)
    out["spec/tokens"] = np.asarray([t for r in reqs for t in r.result(0)])
    out["spec/rate"] = np.asarray(eng.spec_acceptance_rate)
    eng.stop_followers()
else:
    while eng.follow():
        iters += 1
        agreed += agree(eng)
out["spec/iters"] = np.asarray(iters)
out["spec/agreed"] = np.asarray(agreed)
out.update(state(eng, "spec"))

# Leg 3: a client abort and an admission done at its prefill in one
# iteration, on a full pool (tests/serving_pressure.py).
eng = engine(prefix_pages=0)
eng.warm_start()
iters, agreed = 0, 0
if RANK == 0:
    def step():
        global iters, agreed
        eng.step()
        iters += 1
        agreed += agree(eng)
        return not eng.scheduler.idle()

    reqs = pressure_trace(step, lambda n: eng.submit(
        PRESSURE[n][0], max_new_tokens=PRESSURE[n][1]), eng.abort_request)
    for n, r in reqs.items():
        out[f"pressure/reason_{n}"] = np.asarray(str(r.finish_reason))
        out[f"pressure/tokens_{n}"] = np.asarray(r.result(0) or [-1])
    eng.stop_followers()
else:
    while eng.follow():
        iters += 1
        agreed += agree(eng)
out["pressure/iters"] = np.asarray(iters)
out["pressure/agreed"] = np.asarray(agreed)
out["pressure/pool"] = np.frombuffer(repr(pool_state(eng.cache)).encode(),
                                     np.uint8)
out.update(state(eng, "pressure"))

# Leg 4: rank 0's LMServer answers a request; close() stops rank 1.
eng = engine()
if RANK == 0:
    routes = exporter.RouteRegistry()
    with LMServer(eng, port=0, routes=routes) as srv:
        srv.start()
        body = json.dumps({"tokens": prompts[0], "max_tokens": 5}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate", data=body,
            method="POST", headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            out["server/tokens"] = np.asarray(json.loads(r.read())["tokens"])
    out["server/stopped"] = np.asarray(1)
else:
    while eng.follow():
        pass
    out["server/stopped"] = np.asarray(1)
out.update(state(eng, "server"))
finish(out)
"""


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    import json

    tmp = tmp_path_factory.mktemp("follow")
    data = {**flat(jax.tree_util.tree_map(np.asarray, PARAMS_R), "target"),
            **flat(jax.tree_util.tree_map(np.asarray, DRAFT_R), "draft")}
    return _spawn(tmp, json.dumps(SMALL), json.dumps(DRAFT_SMALL),
                  data).results()


def _spawn(tmp, small, draft_small, data):
    """gloo_job.GlooJob's two workers, the configs as two more
    arguments."""
    import os
    import subprocess
    import sys
    import textwrap

    from gloo_job import PRELUDE, REPO

    job = GlooJob.__new__(GlooJob)
    job.tmp, job.n, job.timeout = tmp, 2, 400
    np.savez(tmp / "data.npz", **data)
    script = tmp / "worker.py"
    script.write_text(PRELUDE + textwrap.dedent(WORKER))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep))}
    for k in ("RANK", "WORLD_SIZE", "HVD_TPU_METRICS_PORT"):
        env.pop(k, None)
    job.procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp / "store"),
         str(tmp / "data.npz"), str(tmp / f"out{r}.npz"), "2", small,
         draft_small], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in range(2)]
    return job


def test_follower_digest_equal_after_every_iteration(job):
    r0, r1 = job
    for leg in ("plain", "spec", "pressure"):
        assert int(r0[f"{leg}/iters"]) == int(r1[f"{leg}/iters"]) > 3, leg
        assert int(r0[f"{leg}/agreed"]) == int(r0[f"{leg}/iters"]), leg
        assert int(r1[f"{leg}/agreed"]) == int(r1[f"{leg}/iters"]), leg


@pytest.mark.parametrize("leg", ["plain", "spec", "pressure", "server"])
def test_follower_pool_bitwise_rank0s(job, leg):
    r0, r1 = job
    keys = [k for k in r0 if k.startswith(leg + "/") and k.split("/")[1]
            in ("k", "v", "dk", "dv", "table", "lengths", "last", "pool")]
    assert len(keys) >= 5
    for k in keys:
        assert r0[k].tobytes() == r1[k].tobytes(), k


def test_trace_covers_queueing_prefix_hit_prefill_finish_and_abort(job):
    r0, _ = job
    reasons = list(r0["plain/reasons"])
    assert reasons.count("client_disconnect") == 1
    assert int(r0["plain/prefix_hits"]) >= 1
    assert reasons[3] == "max_new_tokens"  # 1 token: done at its prefill


def test_pressure_trace_on_two_ranks_finishes_as_one_process(job):
    """The abort and the prefill finish fell in one iteration, and every
    request's tokens are the single-process rollout's."""
    r0, _ = job
    assert str(r0["pressure/reason_A"]) == "client_disconnect"
    assert str(r0["pressure/reason_B"]) == "max_new_tokens"
    assert len(r0["pressure/tokens_B"]) == 1
    for n in "BCEF":
        assert list(r0[f"pressure/tokens_{n}"]) == rollout(
            PRESSURE[n][0], PRESSURE[n][1], 32), n


def test_abort_all_frees_every_slot_on_both_ranks(job):
    for r in job:
        assert int(r["abort/free"]) == int(r["abort/n_pages"]) - 1
        assert (r["abort/lengths"] < 0).all()
    assert int(job[0]["abort/failed"]) == 3


def test_multiprocess_tokens_equal_the_single_process_engine(job):
    r0, _ = job
    prompts = [list(range(10, 26)) + [1, 2], [3, 4, 5]]
    eng = make_engine()
    assert list(r0["server/tokens"]) == eng.generate(prompts[0],
                                                     max_new_tokens=5)
    spec = [t for p in ([list(range(10, 26)) + [1, 2], [3, 4, 5],
                         list(range(10, 26)) + [7], [8, 9, 10, 11]])
            for t in rollout(p, 9, 32)]
    assert list(r0["spec/tokens"]) == spec


def test_lmserver_close_stops_the_follower(job):
    assert all(int(r["server/stopped"]) == 1 for r in job)

