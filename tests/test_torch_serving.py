"""horovod_tpu_torch's serving runtime (serving/scheduler.py, kv_cache.py,
engine.py; the serving checkpoints of utils/checkpoint.py) against
horovod_tpu's.

The scheduler and KV-cache cases of tests/test_serving.py run on both
packages (parametrized): the same decisions, page tables and prefix-index
chain hashes.  Then the engine on the CPU: greedy rollouts bitwise the
port's non-incremental forward through the prefill and decode programs
(the port's contract, case for case with tests/test_serving.py:492-610),
equal to the reference's greedy tokens wherever its top-2 margin exceeds
1e-4, continuous and static batching identical on bench.py's trace, the
prefix cache bitwise and saving prefill, drain/import, abort, and the
serving checkpoints crossing between the packages byte for byte.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu_torch.telemetry as telemetry
from horovod_tpu.serving import InferenceEngine as RefEngine
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.serving import InferenceEngine, harness
from horovod_tpu_torch.serving.scheduler import FinishReason
from horovod_tpu_torch.utils.tree import tree_leaves
from torch_serving_cases import (CFG, CFG_R, PARAMS, PARAMS_R,
                                 assert_greedy_agrees, make_engine,
                                 reference_rollout, rollout)


class _Impl:
    """One package's scheduler and KV cache behind one interface."""

    def __init__(self, which):
        if which == "reference":
            from horovod_tpu.serving import kv_cache, scheduler
            self.extra = {}
        else:
            from horovod_tpu_torch.serving import kv_cache, scheduler
            self.extra = {"device": "cpu"}
        self.which = which
        self.Scheduler = scheduler.ContinuousBatchingScheduler
        self.Request = scheduler.Request
        self.Finish = scheduler.FinishReason
        self._kv = kv_cache.PagedKVCache

    def req(self, prompt=(1, 2, 3), **kw):
        kw.setdefault("max_new_tokens", 4)
        return self.Request(prompt=list(prompt), **kw)

    def cache(self, **kw):
        return self._kv(**kw, **self.extra)

    def prefix_cache(self, **kw):
        kw.setdefault("max_slots", 3)
        kw.setdefault("pages_per_slot", 4)
        kw.setdefault("page_size", 8)
        kw.setdefault("prefix_cache", True)
        kw.setdefault("fingerprint", "test-model")
        return self.cache(n_layers=1, n_heads=2, head_dim=8, **kw)


@pytest.fixture(params=["reference", "port"])
def impl(request):
    return _Impl(request.param)


# ---------------------------------------------------------------------------
# Scheduler (tests/test_serving.py:66-208, on both packages)
# ---------------------------------------------------------------------------

def test_scheduler_admission_is_fifo_lowest_slot_first(impl):
    s = impl.Scheduler(max_slots=2, capacity=32)
    r1, r2, r3 = (s.submit(impl.req()) for _ in range(3))
    admitted = s.admit()
    assert [(slot, r.rid) for slot, r in admitted] == [(0, r1.rid),
                                                      (1, r2.rid)]
    assert s.queue_depth() == 1 and s.occupancy() == 2
    r4 = s.submit(impl.req())
    assert s.admit() == []
    for _ in range(4):
        s.feed(1, 9)
    assert r2.finish_reason == impl.Finish.MAX_NEW_TOKENS
    assert [(slot, r.rid) for slot, r in s.admit()] == [(1, r3.rid)]
    assert s.queue_depth() == 1 and r4.done.is_set() is False


def test_scheduler_eviction_reasons_and_slot_reuse(impl):
    s = impl.Scheduler(max_slots=1, capacity=8)
    r_eos = s.submit(impl.req(max_new_tokens=10, eos_id=42))
    s.admit()
    assert s.feed(0, 7) is None
    assert s.feed(0, 42) == impl.Finish.EOS
    assert r_eos.result(0) == [7, 42]
    r_cap = s.submit(impl.req(prompt=[1, 2, 3, 4, 5], max_new_tokens=10))
    assert s.admit()[0][0] == 0
    assert s.feed(0, 1) is None
    assert s.feed(0, 1) is None
    assert s.feed(0, 1) == impl.Finish.CAPACITY
    r_max = s.submit(impl.req(max_new_tokens=1))
    s.admit()
    assert s.feed(0, 3) == impl.Finish.MAX_NEW_TOKENS
    assert r_max.result(0) == [3]
    assert r_cap.finish_reason == impl.Finish.CAPACITY


def test_scheduler_starvation_freedom_under_full_batch(impl):
    s = impl.Scheduler(max_slots=2, capacity=1000)
    for _ in range(2):
        s.submit(impl.req(max_new_tokens=100))
    s.admit()
    victim = s.submit(impl.req(max_new_tokens=1))
    for it in range(200):
        s.submit(impl.req(max_new_tokens=100))
        for slot, _ in s.active():
            s.feed(slot, 5)
        if any(r is victim for _, r in s.admit()):
            break
    else:
        pytest.fail("victim request was starved")
    assert it <= 100


def _trace_log(impl, budget=None):
    """tests/test_serving.py:127's seeded trace, with an optional page
    budget gate: the full admission/eviction log."""
    rng = np.random.default_rng(3)
    s = impl.Scheduler(max_slots=3, capacity=64)
    log = []
    for it in range(40):
        if rng.random() < 0.6:
            s.submit(impl.req(
                prompt=list(range(int(rng.integers(1, 30)))),
                max_new_tokens=int(rng.integers(1, 6)), arrival=it))
        for slot, _ in s.active():
            log.append(("feed", slot, s.feed(slot, int(rng.integers(0, 9)))))
        gate = {} if budget is None else {
            "page_budget": budget(it),
            "pages_needed": lambda r: -(-len(r.prompt) // 8)}
        log.append(tuple((slot, r.rid) for slot, r in s.admit(now=it,
                                                              **gate)))
        log.append(tuple(slot for slot, _ in s.active()))
    return log


@pytest.mark.parametrize("budget", [None, lambda it: it % 5])
def test_scheduler_decisions_equal_the_references(budget):
    """The same seeded trace through both packages' schedulers gives the
    same admissions, finish reasons and batch compositions, exactly."""
    port = _trace_log(_Impl("port"), budget)
    assert port == _trace_log(_Impl("reference"), budget)
    assert port == _trace_log(_Impl("port"), budget)


def test_scheduler_arrival_gating_and_drain(impl):
    s = impl.Scheduler(max_slots=2, capacity=32)
    r = s.submit(impl.req(arrival=5))
    assert s.admit(now=4) == []
    assert [x[1] for x in s.admit(now=5)] == [r]
    s.feed(0, 1)
    drained, pending = s.drain()
    assert drained == [r] and pending == []
    assert r.finish_reason == impl.Finish.DRAINED and r.result(0) == [1]
    with pytest.raises(RuntimeError):
        s.submit(impl.req())
    s.resume()
    s.submit(impl.req())
    assert len(s.admit()) == 1


def test_scheduler_snapshot_and_drain_reason(impl):
    s = impl.Scheduler(max_slots=1, capacity=32)
    r1 = s.submit(impl.req())
    s.admit()
    r2 = s.submit(impl.req())
    assert s.snapshot() == ([(0, r1)], [r2])
    drained, pending = s.drain(impl.Finish.ERROR)
    assert drained == [r1] and pending == [r2]
    assert r1.finish_reason == impl.Finish.ERROR and r1.done.is_set()
    assert r2.finish_reason is None and not r2.done.is_set()


def test_scheduler_feed_expect_tolerates_concurrent_eviction(impl):
    s = impl.Scheduler(max_slots=1, capacity=32)
    r1 = s.submit(impl.req())
    s.admit()
    s.drain()
    assert s.feed(0, 7, expect=r1) == impl.Finish.DRAINED
    assert r1.generated == []
    with pytest.raises(ValueError):
        s.feed(0, 7)


def test_scheduler_rejects_bad_prompts(impl):
    s = impl.Scheduler(max_slots=1, capacity=8)
    with pytest.raises(ValueError):
        s.submit(impl.req(prompt=[]))
    with pytest.raises(ValueError):
        s.submit(impl.req(prompt=list(range(8))))


def test_scheduler_admit_defers_on_page_budget(impl):
    s = impl.Scheduler(max_slots=2, capacity=64)
    big = s.submit(impl.req(prompt=list(range(40))))
    small = s.submit(impl.req(prompt=[1, 2, 3]))
    need = {big.rid: 5, small.rid: 1}
    assert s.admit(page_budget=4, pages_needed=lambda r: need[r.rid]) == []
    assert s.queue_depth() == 2
    admitted = s.admit(page_budget=8, pages_needed=lambda r: need[r.rid])
    assert [r.rid for _, r in admitted] == [big.rid, small.rid]


def test_scheduler_cancel_queued_active_gone(impl):
    s = impl.Scheduler(max_slots=1, capacity=32)
    a, b = s.submit(impl.req()), s.submit(impl.req())
    s.admit()
    assert s.cancel(b, "client_disconnect") == "queued" and b.done.is_set()
    assert s.cancel(a, "client_disconnect") == "active"
    assert s.evict_cancelled() == [0]
    assert a.finish_reason == "client_disconnect"
    assert s.cancel(a, "client_disconnect") == "gone"


# ---------------------------------------------------------------------------
# Paged KV cache and the prefix index (tests/test_serving.py:211-372)
# ---------------------------------------------------------------------------

def test_kv_cache_page_lifecycle_and_reuse(impl):
    c = impl.cache(n_layers=2, n_heads=4, head_dim=16, max_slots=2,
                   pages_per_slot=4, page_size=8)
    assert c.n_pages == 9 and c.free_pages() == 8
    c.begin_slot(0, 10)
    assert c.free_pages() == 6 and c.length(0) == 10
    assert 0 not in list(c._table[0][:2])
    c.ensure(0, 16)
    assert c.free_pages() == 5
    c.free_slot(0)
    assert c.free_pages() == 8 and c.length(0) == -1
    c.begin_slot(1, 30)
    assert c.free_pages() == 4
    with pytest.raises(ValueError):
        c.ensure(1, 32)
    with pytest.raises(ValueError):
        c.begin_slot(1, 2)


def test_kv_cache_ensure_on_freed_slot_is_a_leakfree_noop(impl):
    c = impl.cache(n_layers=1, n_heads=4, head_dim=8, max_slots=2,
                   pages_per_slot=4, page_size=8)
    c.begin_slot(0, 10)
    n = c.length(0)
    c.free_slot(0)
    free_before = c.free_pages()
    c.ensure(0, n)
    assert c.free_pages() == free_before
    assert list(c._table[0]) == [0] * 4
    c.begin_slot(0, 10)
    c.free_slot(0)
    assert c.free_pages() == c.n_pages - 1


def test_prefix_publish_lookup_chain_semantics(impl):
    c = impl.prefix_cache()
    prompt = list(range(20))
    c.begin_slot(0, len(prompt))
    assert c.publish_prefix(0, prompt) == 2
    assert len(c.lookup_prefix(prompt + [50, 51])) == 2
    assert len(c.lookup_prefix(prompt[:8] + [99] * 12)) == 1
    assert c.lookup_prefix([99] + prompt) == []
    assert len(c.lookup_prefix(prompt[:16])) == 1
    assert len(c.lookup_prefix([98] * 8 + prompt[8:16] + [1])) == 0


def test_prefix_refcount_lru_and_reclaim(impl):
    c = impl.prefix_cache(max_slots=2, pages_per_slot=4)
    prompt = list(range(17))
    c.begin_slot(0, len(prompt))
    c.publish_prefix(0, prompt)
    pages = c.lookup_prefix(prompt + [1])
    assert c.prefix_stats() == {"cached_pages": 2, "referenced_pages": 2,
                                "reclaimable_pages": 0}
    c.begin_slot(1, len(prompt) + 3, prefix_pages=pages)
    assert list(c._table[1][:2]) == pages
    c.free_slot(0)
    assert c.prefix_stats()["referenced_pages"] == 2
    c.free_slot(1)
    stats = c.prefix_stats()
    assert stats["referenced_pages"] == 0 and stats["reclaimable_pages"] == 2
    assert c.free_pages() == c.total_pages
    c.begin_slot(0, 32)
    c.begin_slot(1, 32)
    assert c.prefix_stats()["cached_pages"] == 0
    assert len(c.lookup_prefix(prompt + [1])) == 0


def test_prefix_referenced_pages_never_reclaimed(impl):
    c = impl.prefix_cache(max_slots=2, pages_per_slot=4)
    prompt = list(range(9))
    c.begin_slot(0, len(prompt))
    c.publish_prefix(0, prompt)
    c.ensure(0, 31)
    ghost_tokens = list(range(60, 76))
    c.publish_ghost(c.alloc_ghost(2), ghost_tokens)
    assert c.prefix_stats()["reclaimable_pages"] == 2
    assert c.free_pages() == 4
    shared_page = int(c._table[0][0])
    c.begin_slot(1, 32)
    stats = c.prefix_stats()
    assert stats["reclaimable_pages"] == 0 and stats["cached_pages"] == 1
    assert int(c._table[0][0]) == shared_page
    assert c.lookup_prefix(ghost_tokens + [1]) == []


def test_prefix_ghost_seed_roundtrip(impl):
    c = impl.prefix_cache()
    tokens = list(range(16))
    assert c.publish_ghost(c.alloc_ghost(2), tokens) == 2
    assert c.prefix_stats()["reclaimable_pages"] == 2
    assert len(c.lookup_prefix(tokens + [7])) == 2
    assert c.export_prefixes() == [tokens]
    free_before = c.free_pages()
    assert c.publish_ghost(c.alloc_ghost(2), tokens) == 0
    assert c.free_pages() == free_before


def test_prefix_disabled_cache_is_inert(impl):
    c = impl.prefix_cache(prefix_cache=False)
    prompt = list(range(20))
    c.begin_slot(0, len(prompt))
    assert c.publish_prefix(0, prompt) == 0
    assert c.lookup_prefix(prompt + [1]) == []
    assert c.prefix_stats()["cached_pages"] == 0


def test_prefix_index_keys_equal_the_references():
    """The same publishes give the same chain-hash keys (hex, in
    publish order), page tables and admission costs in both packages,
    and the engines' fingerprints match byte for byte."""
    prompts = [list(range(20)), list(range(8)) + [5] * 12,
               [3] * 33, list(range(40, 57))]
    caches = [_Impl(w).prefix_cache(max_slots=4, pages_per_slot=5)
              for w in ("reference", "port")]
    for c in caches:
        for slot, p in enumerate(prompts):
            c.begin_slot(slot, len(p), prefix_pages=c.lookup_prefix(p))
            c.publish_prefix(slot, p)
    ref, port = caches
    assert port.export_prefix_hashes() == ref.export_prefix_hashes()
    assert len(port.export_prefix_hashes()) == 9
    assert np.array_equal(port._table, ref._table)
    for p in prompts + [list(range(30)), [3] * 40]:
        assert port.admission_cost(p) == ref.admission_cost(p)
    eng = make_engine()
    assert eng.fingerprint == RefEngine(PARAMS_R, CFG_R, max_slots=1,
                                        page_size=8,
                                        capacity=32).fingerprint
    from horovod_tpu.routing import affinity as ra
    from horovod_tpu_torch.routing import affinity as ta

    fp = eng.fingerprint.encode()
    for p in prompts:
        assert (ta.prompt_header_hashes(fp, p, 8, 4)
                == ra.prompt_header_hashes(fp, p, 8, 4))


# ---------------------------------------------------------------------------
# Engine: the bitwise contract through the programs
# ---------------------------------------------------------------------------

def test_engine_bitwise_vs_noncached_forward_through_programs():
    eng = make_engine()
    assert eng.warm_start() == 0 and eng.ready
    prompt = [3, 1, 4, 1, 5, 9, 2]
    N = 6
    req = eng.submit(prompt, max_new_tokens=N)
    rows, pf = [], []
    orig_dec, orig_pf = eng._decode_iteration, eng._prefill

    def wrapped_dec(active):
        logits = orig_dec(active)
        rows.append(logits[active[0][0]].copy())
        return logits

    def wrapped_pf(slot, r):
        out = orig_pf(slot, r)
        pf.append(out.copy())
        return out

    eng._decode_iteration, eng._prefill = wrapped_dec, wrapped_pf
    eng.run_until_idle()
    full = prompt + req.result(0)
    with torch.no_grad():
        ref = TT.serving_forward(PARAMS, torch.tensor([full]), CFG,
                                 eng.capacity).numpy()
    P = len(prompt)
    assert pf[0].tobytes() == ref[0, P - 1].tobytes()
    assert len(rows) == N - 1
    for i, row in enumerate(rows):
        assert row.tobytes() == ref[0, P + i].tobytes(), f"decode {i}"


PROMPTS = [[5, 3, 8], [1, 2, 3, 4, 5, 6], [9, 9, 2, 6]]


def test_engine_greedy_matches_reference_and_batch_invariance():
    eng = make_engine()
    eng.warm_start()
    ref = [rollout(p, 7, eng.capacity) for p in PROMPTS]
    assert [eng.generate(list(p), max_new_tokens=7) for p in PROMPTS] == ref
    eng2 = make_engine()
    eng2.warm_start()
    reqs = [eng2.submit(list(p), max_new_tokens=7) for p in PROMPTS]
    eng2.run_until_idle()
    assert [r.result(0) for r in reqs] == ref
    for p, toks in zip(PROMPTS, ref):
        assert_greedy_agrees(p, toks, eng.capacity)


def test_engine_tokens_equal_the_reference_engines():
    """The two packages' engines, same weights and prompts: the same
    greedy tokens up to the first position where the reference's top-2
    margin is at most 1e-4 (there, float rounding may pick either)."""
    ref_eng = RefEngine(PARAMS_R, CFG_R, max_slots=3, page_size=8,
                        capacity=32)
    ref_eng.warm_start()
    prompts = PROMPTS + [[int(t) for t in np.random.default_rng(s).integers(
        0, CFG.vocab_size, n)] for s, n in ((1, 12), (2, 20))]
    ref_reqs = [ref_eng.submit(list(p), max_new_tokens=9) for p in prompts]
    ref_eng.run_until_idle()
    eng = make_engine()
    eng.warm_start()
    reqs = [eng.submit(list(p), max_new_tokens=9) for p in prompts]
    eng.run_until_idle()
    held = 0
    for p, r, rr in zip(prompts, reqs, ref_reqs):
        n = assert_greedy_agrees(p, r.result(0), eng.capacity)
        held += n
        got, want = r.result(0), rr.result(0)
        if n == len(got):
            assert got == want
    assert held >= 20


@pytest.mark.parametrize("capacity", [32, 64])
def test_engine_capacity_finished_rollout_is_bitwise(capacity):
    eng = make_engine(capacity=capacity)
    eng.warm_start()
    prompt = [int(t) for t in np.random.default_rng(7).integers(
        0, CFG.vocab_size, capacity - 4)]
    req = eng.submit(list(prompt), max_new_tokens=99)
    eng.run_until_idle()
    out = req.result(0)
    assert req.finish_reason == FinishReason.CAPACITY
    assert len(prompt) + len(out) == eng.capacity
    assert out == rollout(prompt, len(out), eng.capacity)


def test_engine_eos_and_sampling_determinism():
    eng = make_engine()
    eng.warm_start()
    ref = rollout([5, 3, 8], 12, eng.capacity)
    assert eng.generate([5, 3, 8], max_new_tokens=12, eos_id=ref[0]) \
        == ref[:1]
    a = eng.generate([5, 3, 8], max_new_tokens=6, temperature=0.8, seed=11)
    eng3 = make_engine()
    eng3.warm_start()
    assert a == eng3.generate([5, 3, 8], max_new_tokens=6,
                              temperature=0.8, seed=11)


def test_engine_one_program_per_decode_iteration():
    """A steady-state decode iteration calls the decode program exactly
    once (gather, forward, scatter in one program) and no other."""
    eng = make_engine()
    eng.warm_start()
    for p in ([1, 2, 3], [4, 5, 6, 7]):
        eng.submit(list(p), max_new_tokens=5)
    eng.step()
    calls = []
    programs = dict(eng._exec)
    for key, fn in programs.items():
        eng._exec[key] = (lambda *a, _k=key, _f=fn:
                          (calls.append(_k) or _f(*a)))
    eng.step()
    eng._exec.update(programs)
    assert calls == [("decode",)]
    eng.run_until_idle()


def test_continuous_and_static_batching_give_identical_tokens():
    """bench.py's seeded trace at a small width: the two admission
    policies differ only in time (and iterations), never in tokens."""
    trace = harness.serving_trace(14, CFG.vocab_size)
    legs = {}
    for continuous in (True, False):
        eng = make_engine(max_slots=4, page_size=8, capacity=64)
        eng.warm_start()
        legs[continuous] = harness.run_trace(eng, trace, continuous)
    assert legs[True]["tokens"] == legs[False]["tokens"]
    assert legs[True]["iterations"] < legs[False]["iterations"]
    assert [len(t) for t in legs[True]["tokens"]] == [
        min(t["max_new"], 64 - len(t["prompt"])) for t in trace]


def test_engine_serving_metrics_flow():
    eng = make_engine()
    eng.warm_start()
    before = telemetry.metrics().get("serving.tokens_generated",
                                     {}).get("value", 0)
    eng.generate([4, 4, 4], max_new_tokens=5)
    snap = telemetry.metrics()
    assert snap["serving.tokens_generated"]["value"] == before + 5
    assert snap["serving.ttft_seconds"]["count"] >= 1
    assert snap["serving.token_seconds"]["count"] >= 1


def test_engine_refuses_cuda_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(PARAMS, CFG, max_slots=1, page_size=8, capacity=32)


# ---------------------------------------------------------------------------
# Abort, drain and import
# ---------------------------------------------------------------------------

def test_engine_abort_all_fails_everything_and_reopens():
    eng = make_engine()
    eng.warm_start()
    reqs = [eng.submit([i + 1, 2, 3], max_new_tokens=8) for i in range(4)]
    eng.step()
    assert eng.scheduler.occupancy() == 3
    failed = eng.abort_all()
    assert {r.rid for r in failed} == {r.rid for r in reqs}
    for r in reqs:
        assert r.done.is_set() and r.finish_reason == FinishReason.ERROR
    assert eng.cache.free_pages() == eng.cache.n_pages - 1
    assert eng.generate([1, 2], max_new_tokens=2)


def test_engine_drain_with_nothing_in_flight_is_empty():
    eng = make_engine()
    eng.warm_start()
    assert eng.drain() == []
    eng.import_requests([])
    assert eng.generate([1, 2], max_new_tokens=2)


def test_engine_drain_finishes_pending_requests_fast():
    eng = make_engine()
    eng.warm_start()
    reqs = [eng.submit([i + 1, 2, 3], max_new_tokens=8) for i in range(4)]
    eng.step()
    assert len(eng.drain()) == 4
    for r in reqs:
        assert r.done.is_set() and r.finish_reason == FinishReason.DRAINED


def test_drain_then_import_reproduces_the_uninterrupted_rollout():
    ref = rollout([3, 1, 4, 1, 5], 10, 32)
    eng = make_engine()
    eng.warm_start()
    req = eng.submit([3, 1, 4, 1, 5], max_new_tokens=10)
    for _ in range(4):
        eng.step()
    exported = eng.drain()
    assert exported and req.finish_reason == FinishReason.DRAINED
    eng2 = make_engine()
    eng2.warm_start()
    [req2] = eng2.import_requests(exported)
    eng2.run_until_idle()
    assert req2.result(0) == ref
    # The reference's engine takes the port's export, and back.
    ref_eng = RefEngine(PARAMS_R, CFG_R, max_slots=3, page_size=8,
                        capacity=32)
    [r3] = ref_eng.import_requests(exported)
    assert r3.prompt == exported[0]["prompt"] and r3.prefix == req.generated


def test_import_requests_attaches_prefix_before_admissible():
    eng = make_engine()
    eng.warm_start()
    seen = []
    orig_submit = eng.scheduler.submit

    def spy(req):
        seen.append(list(req.prefix))
        return orig_submit(req)

    eng.scheduler.submit = spy
    eng.import_requests([{"prompt": [1, 2, 3, 9], "generated_prefix": [9],
                          "max_new_tokens": 4, "seed": 1,
                          "temperature": 0.7}])
    assert seen == [[9]]


def test_import_requests_skips_unresumable_continuations():
    eng = make_engine()
    oversized = {"prompt": list(range(eng.capacity + 4)),
                 "generated_prefix": [], "max_new_tokens": 8}
    ok = {"prompt": [1, 2, 3], "generated_prefix": [9], "max_new_tokens": 4}
    out = eng.import_requests([oversized, ok])
    assert len(out) == 1 and out[0].prompt == [1, 2, 3]
    assert out[0].prefix == [9]
    assert telemetry.recent_events()[-1]["where"] == "serve-import"


# ---------------------------------------------------------------------------
# The prefix cache at the engine level
# ---------------------------------------------------------------------------

def _counter(name):
    return telemetry.metrics().get(name, {}).get("value", 0)


def test_engine_prefix_hit_is_bitwise_and_saves_prefill():
    header = list(range(1, 18))
    ext = header + [40, 41, 42]
    a_off, b_off = rollout(header, 5, 32), rollout(ext, 5, 32)
    on = make_engine(prefix_cache=True)
    on.warm_start()
    assert on.generate(list(header), max_new_tokens=5) == a_off
    assert on.cache.prefix_stats()["cached_pages"] == 2
    hits0, pages0 = (_counter("serving.prefix_hits"),
                     _counter("serving.prefix_pages_shared"))
    tokens0 = _counter("serving.prefill_tokens")
    widths = []
    orig = on._prefill_exec

    def spy(bucket, draft=False):
        widths.append(bucket)
        return orig(bucket, draft)

    on._prefill_exec = spy
    assert on.generate(list(ext), max_new_tokens=5) == b_off
    on._prefill_exec = orig
    assert _counter("serving.prefix_hits") - hits0 == 1
    assert _counter("serving.prefix_pages_shared") - pages0 == 2
    assert max(widths) <= 4
    assert _counter("serving.prefill_tokens") - tokens0 == 4


def test_engine_prefix_refcounts_follow_slot_lifecycle():
    eng = make_engine(prefix_cache=True)
    eng.warm_start()
    header = list(range(1, 18))
    eng.generate(list(header), max_new_tokens=3)
    assert eng.cache.prefix_stats()["referenced_pages"] == 0
    req = eng.submit(header + [50], max_new_tokens=30)
    eng.step()
    assert eng.cache.prefix_stats()["referenced_pages"] == 2
    eng.run_until_idle()
    req.result(0)
    stats = eng.cache.prefix_stats()
    assert stats["referenced_pages"] == 0 and stats["cached_pages"] >= 2
    assert eng.cache.free_pages() == eng.cache.total_pages


def test_engine_prefix_cache_off_env(monkeypatch):
    monkeypatch.setenv("HVD_TPU_PREFIX_CACHE", "0")
    assert not make_engine().cache.prefix_enabled
    monkeypatch.delenv("HVD_TPU_PREFIX_CACHE")
    assert make_engine().cache.prefix_enabled


def test_engine_seed_prefixes_rebuilds_bitwise_pages():
    header = list(range(1, 17))
    ref = rollout(header + [7, 8], 6, 32)
    eng = make_engine(prefix_cache=True)
    eng.warm_start()
    assert eng.seed_prefixes([header]) == 2
    assert eng.cache.prefix_stats()["cached_pages"] == 2
    assert eng.generate(header + [7, 8], max_new_tokens=6) == ref
    assert eng.seed_prefixes([header]) == 0
    assert any(c[:16] == header for c in eng.export_prefix_index())


def test_seed_prefixes_failure_frees_ghost_pages_and_raises():
    """A prefill that raises mid-seed returns its ghost pages and
    propagates (the reference logs and goes on; the port passes over no
    launch failure); the next seed call still works."""
    eng = make_engine(prefix_cache=True)
    eng.warm_start()
    free_before = eng.cache.free_pages()
    orig = eng._prefill_exec

    def failing(bucket, draft=False):
        raise RuntimeError("seeded prefill failure")

    eng._prefill_exec = failing
    with pytest.raises(RuntimeError, match="seeded prefill failure"):
        eng.seed_prefixes([list(range(16))])
    eng._prefill_exec = orig
    assert eng.cache.free_pages() == free_before
    assert eng.seed_prefixes([list(range(50, 66))]) == 2
    assert eng.cache.prefix_stats()["cached_pages"] == 2


# ---------------------------------------------------------------------------
# Serving checkpoints, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_checkpoints_are_byte_compatible(tmp_path, dtype):
    from horovod_tpu.utils import checkpoint as RC
    from horovod_tpu_torch.utils import checkpoint as TC
    from horovod_tpu_torch.utils.convert import params_from_jax

    cfg_r = CFG_R if dtype == "float32" else type(CFG_R)(
        **{**CFG_R.__dict__, "dtype": jnp.bfloat16})
    cfg_t = CFG if dtype == "float32" else type(CFG)(
        **{**CFG.__dict__, "dtype": torch.bfloat16})
    pr = jax.tree_util.tree_map(lambda x: x.astype(cfg_r.dtype), PARAMS_R)
    pt = params_from_jax(jax.tree_util.tree_map(np.asarray, pr),
                         requires_grad=False)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    RC.save_serving_checkpoint(str(ref_dir), pr, cfg_r, extra={"s": 3},
                               block=True)
    assert TC.save_serving_checkpoint(str(port_dir), pt, cfg_t,
                                      extra={"s": 3}, block=True)
    for name in ("serving.json", "params.msgpack"):
        assert (ref_dir / name).read_bytes() == (port_dir / name).read_bytes()
    params, cfg, meta = TC.load_serving_checkpoint(str(ref_dir))
    assert cfg == cfg_t and meta["extra"] == {"s": 3}
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(pt)))
    _, cfg2, _ = RC.load_serving_checkpoint(str(port_dir))
    assert cfg2 == cfg_r


def test_reference_export_serves_the_references_greedy_tokens(tmp_path):
    """A save_serving_checkpoint from the JAX package loads into the
    port's engine and generates the reference's greedy tokens (where
    its top-2 margin is clear); the port's export loads into the
    reference's engine and generates the same tokens as the port."""
    from horovod_tpu.utils import checkpoint as RC
    from horovod_tpu_torch.utils import checkpoint as TC

    RC.save_serving_checkpoint(str(tmp_path / "ref"), PARAMS_R, CFG_R,
                               block=True)
    params, cfg, _ = TC.load_serving_checkpoint(str(tmp_path / "ref"))
    eng = InferenceEngine(params, cfg, device="cpu", max_slots=2,
                          page_size=8, capacity=32)
    eng.warm_start()
    prompt = [2, 7, 1, 8, 2, 8]
    out = eng.generate(prompt, max_new_tokens=8)
    want = reference_rollout(prompt, 8, 32)
    n = assert_greedy_agrees(prompt, out, 32)
    if n == len(out):
        assert out == want
    TC.save_serving_checkpoint(str(tmp_path / "port"), params, cfg,
                               block=True)
    rp, rc, meta = RC.load_serving_checkpoint(str(tmp_path / "port"))
    assert meta["format"] == "hvd-serving-checkpoint-v1"
    ref_eng = RefEngine(rp, rc, max_slots=2, page_size=8, capacity=32)
    ref_eng.warm_start()
    assert ref_eng.generate(prompt, max_new_tokens=8) == want
    assert os.path.exists(tmp_path / "port" / "serving.json")
    assert json.loads((tmp_path / "port" / "serving.json").read_text())[
        "model"]["dtype"] == "float32"


def test_chip_smoke_runs_a_serving_phase_before_word2vec():
    import chip_smoke

    phases = chip_smoke.PHASES
    assert phases.index("checkpoint") < phases.index("serving") \
        < phases.index("word2vec")
    assert "serving - GPT-2-small" in chip_smoke.__doc__
    assert chip_smoke.SERVING_ROWS == (2, 16, 37, 65, 127, 512, 1024)
