"""Speculative decoding in horovod_tpu_torch (serving/engine.py's propose and
verify programs, serving/harness.py), case for case with
tests/test_speculative.py:108-290.

The contract is bitwise: speculative greedy completions equal
non-speculative ones (here: the port's non-incremental forward) for any
draft, any depth, any acceptance pattern and batch mix, across a drain
and import and a prefix-cache hit.  The reference's random draft runs
through utils/convert.py; the agreement pair is the port's own
(torch-seeded) construction.
"""

import numpy as np
import pytest

import horovod_tpu_torch.telemetry as telemetry
from horovod_tpu_torch.models.transformer import TransformerConfig
from horovod_tpu_torch.serving import harness
from torch_serving_cases import (CFG, DRAFT, DRAFT_CFG, PARAMS,
                                 assert_greedy_agrees, make_engine, rollout)

AGREE_DRAFT_CFG = TransformerConfig(vocab_size=97, d_model=64, n_heads=4,
                                    n_layers=1, d_ff=32, max_seq_len=64)
_CACHED = {}


def make_spec_engine(**kw):
    kw.setdefault("draft", (DRAFT, DRAFT_CFG))
    kw.setdefault("spec_tokens", 3)
    return make_engine(**kw)


def _cached(name, build):
    if name not in _CACHED:
        _CACHED[name] = build()
    return _CACHED[name]


def _warm(e):
    e.warm_start()
    return e


def spec_eng():
    return _cached("spec", lambda: _warm(make_spec_engine()))


def base_eng():
    return _cached("base", lambda: _warm(make_engine()))


def agree_eng():
    def build():
        tp, dp = harness.agreement_pair(CFG, AGREE_DRAFT_CFG)
        e = _warm(make_engine(tp, CFG, draft=(dp, AGREE_DRAFT_CFG),
                              spec_tokens=3))
        return e, tp
    return _cached("agree", build)


PROMPTS = [[5, 3, 8], [1, 2, 3, 4, 5, 6], [9, 9, 2, 6]]


def test_spec_bitwise_with_uncorrelated_draft():
    eng = spec_eng()
    ref = [rollout(p, 7, eng.capacity) for p in PROMPTS]
    assert [eng.generate(list(p), max_new_tokens=7) for p in PROMPTS] == ref
    reqs = [eng.submit(list(p), max_new_tokens=7) for p in PROMPTS]
    eng.run_until_idle()
    assert [r.result(0) for r in reqs] == ref
    assert eng.spec_acceptance_rate is not None
    assert eng.spec_acceptance_rate < 0.5
    for p, toks in zip(PROMPTS, ref):
        assert_greedy_agrees(p, toks, eng.capacity)


@pytest.mark.parametrize("spec_tokens", [1, 3, 5])
def test_spec_depth_never_changes_tokens(spec_tokens):
    eng = _warm(make_spec_engine(spec_tokens=spec_tokens))
    assert eng.generate([7, 1, 4], max_new_tokens=9) == rollout(
        [7, 1, 4], 9, eng.capacity)


def test_spec_full_acceptance_emits_blocks():
    eng, tp = agree_eng()
    ref = rollout([5, 3, 8], 12, eng.capacity, tp)
    req = eng.submit([5, 3, 8], max_new_tokens=12)
    iters = 0
    while not eng.scheduler.idle():
        eng.step()
        iters += 1
    assert req.result(0) == ref
    assert eng.spec_acceptance_rate == 1.0
    assert iters <= 4


def test_spec_steady_state_is_one_propose_one_verify():
    """A steady-state speculative iteration calls ONE draft propose and
    ONE target verify program (no decode), and launches no serving
    kernel on the CPU (the plain versions run here)."""
    eng = spec_eng()
    for p in ([1, 2, 3], [4, 5, 6, 7]):
        eng.submit(list(p), max_new_tokens=8)
    eng.step()
    proposes, verifies, launches = harness.count_spec_dispatches(eng)
    assert (proposes, verifies) == (1, 1)
    assert launches == {"serving_gemm": 0, "cache_attention": 0}
    eng.run_until_idle()


def test_spec_eos_mid_block_stops_exactly_at_eos():
    eng, tp = agree_eng()
    ref = rollout([5, 3, 8], 12, 32, tp)
    assert eng.generate([5, 3, 8], max_new_tokens=12, eos_id=ref[3]) \
        == ref[:4]


@pytest.mark.parametrize("use_agreement", [False, True])
def test_spec_capacity_finish_is_bitwise(use_agreement):
    if use_agreement:
        tp, dp = harness.agreement_pair(CFG, AGREE_DRAFT_CFG)
        dcfg = AGREE_DRAFT_CFG
    else:
        tp, dp, dcfg = PARAMS, DRAFT, DRAFT_CFG
    eng = _warm(make_engine(tp, CFG, draft=(dp, dcfg), spec_tokens=3))
    prompt = [int(t) for t in np.random.default_rng(7).integers(
        0, CFG.vocab_size, eng.capacity - 5)]
    req = eng.submit(list(prompt), max_new_tokens=99)
    eng.run_until_idle()
    out = req.result(0)
    assert req.finish_reason == "capacity"
    assert len(prompt) + len(out) == eng.capacity
    assert out == rollout(prompt, len(out), eng.capacity, tp)


def test_spec_mixed_batch_with_temperature_slot():
    eng, base = spec_eng(), base_eng()
    greedy_ref = rollout([5, 3, 8], 6, eng.capacity)
    temp_base = base.generate([2, 4, 6], max_new_tokens=6, temperature=0.8,
                              seed=17)
    r_greedy = eng.submit([5, 3, 8], max_new_tokens=6)
    r_temp = eng.submit([2, 4, 6], max_new_tokens=6, temperature=0.8,
                        seed=17)
    eng.run_until_idle()
    assert r_greedy.result(0) == greedy_ref
    assert r_temp.result(0) == temp_base


def test_spec_drain_resume_reproduces_uninterrupted_rollout():
    ref = rollout([3, 1, 4, 1, 5], 10, 32)
    eng = _warm(make_spec_engine())
    req = eng.submit([3, 1, 4, 1, 5], max_new_tokens=10)
    eng.step()
    eng.step()
    exported = eng.drain()
    assert exported and req.finish_reason == "drained"
    eng2 = _warm(make_spec_engine())
    [req2] = eng2.import_requests(exported)
    eng2.run_until_idle()
    assert req2.result(0) == ref


def test_spec_client_disconnect_releases_draft_and_target_slots():
    eng = spec_eng()
    req = eng.submit(list(range(1, 18)), max_new_tokens=50)
    eng.step()
    assert eng.scheduler.occupancy() == 1
    assert eng.abort_request(req) == "active"
    eng.step()
    assert req.finish_reason == "client_disconnect"
    assert eng.cache.free_pages() == eng.cache.total_pages
    assert eng.draft_cache.free_pages() == eng.draft_cache.total_pages
    assert eng.cache.prefix_stats()["referenced_pages"] == 0


def test_spec_composes_with_prefix_cache():
    header = list(range(1, 17))
    a_ref = rollout(header + [20, 21], 6, 32)
    b_ref = rollout(header + [30, 31, 32], 6, 32)
    eng = spec_eng()
    assert eng.generate(header + [20, 21], max_new_tokens=6) == a_ref
    assert eng.cache.prefix_stats()["cached_pages"] >= 2
    assert eng.generate(header + [30, 31, 32], max_new_tokens=6) == b_ref


def test_spec_draft_store_takes_prefix_hits_of_its_own():
    def draft_hits():
        return telemetry.metrics().get("serving.prefix_hits_draft",
                                       {}).get("value", 0)

    header = list(range(40, 56))
    eng = spec_eng()
    eng.generate(header + [60, 61], max_new_tokens=4)
    assert len(eng.draft_cache.lookup_prefix(header + [70])) == 2
    assert eng.draft_cache.prefix_stats()["cached_pages"] >= 2
    h0 = draft_hits()
    ref = rollout(header + [70, 71], 4, 32)
    assert eng.generate(header + [70, 71], max_new_tokens=4) == ref
    assert draft_hits() - h0 == 1


def test_spec_warm_start_builds_the_speculative_programs():
    eng = make_spec_engine()
    assert not eng.ready and eng._exec == {}
    assert eng.warm_start() == 0 and eng.ready
    assert {("decode",), ("verify", 4), ("draft_propose", 3)} <= set(
        eng._exec)
    eng2 = make_spec_engine(spec_tokens=2)
    eng2.warm_start()
    assert ("verify", 3) in eng2._exec and ("verify", 4) not in eng2._exec


def test_spec_health_reports_speculation():
    ready, payload = spec_eng().health()
    assert ready and payload["speculative"] is True
    assert payload["spec_tokens"] == 3
    _, payload2 = base_eng().health()
    assert payload2["speculative"] is False


def test_spec_telemetry_counters_flow():
    def counter(name):
        return telemetry.metrics().get(name, {}).get("value", 0)

    before_p = counter("serving.spec_proposed")
    before_a = counter("serving.spec_accepted")
    eng, _ = agree_eng()
    eng.generate([5, 3, 8], max_new_tokens=8)
    assert counter("serving.spec_proposed") - before_p > 0
    assert counter("serving.spec_accepted") - before_a > 0
    assert counter("serving.spec_acceptance_rate") > 0.0


def test_spec_tokens_env_zero_is_fine_without_a_draft(monkeypatch):
    monkeypatch.setenv("HVD_TPU_SPEC_TOKENS", "0")
    assert make_engine().spec_tokens == 0
    with pytest.raises(ValueError, match="spec_tokens"):
        make_engine(draft=(DRAFT, DRAFT_CFG))


def test_spec_all_temperature_batch_falls_back_to_decode():
    eng = spec_eng()
    req = eng.submit([4, 4, 4], max_new_tokens=4, temperature=0.7, seed=5)
    eng.step()
    proposes = {"n": 0}
    pkey = ("draft_propose", 3)
    p_exec = eng._exec[pkey]
    eng._exec[pkey] = lambda *a: (
        proposes.__setitem__("n", proposes["n"] + 1) or p_exec(*a))
    eng.run_until_idle()
    eng._exec[pkey] = p_exec
    assert proposes["n"] == 0
    assert req.result(0) == base_eng().generate(
        [4, 4, 4], max_new_tokens=4, temperature=0.7, seed=5)


def test_spec_rejects_bad_draft_configs():
    bad_vocab = TransformerConfig(vocab_size=50, d_model=32, n_heads=2,
                                  n_layers=1, d_ff=64, max_seq_len=64)
    with pytest.raises(ValueError, match="vocab_size"):
        make_engine(draft=(DRAFT, bad_vocab))
    short = TransformerConfig(vocab_size=97, d_model=32, n_heads=2,
                              n_layers=1, d_ff=64, max_seq_len=16)
    with pytest.raises(ValueError, match="max_seq_len"):
        make_engine(draft=(DRAFT, short))
    with pytest.raises(ValueError, match="spec_tokens"):
        make_spec_engine(spec_tokens=0)


def test_agreement_pair_shares_the_heads_and_zeroes_the_layers():
    tp, dp = harness.agreement_pair(CFG, AGREE_DRAFT_CFG)
    for k in ("embed", "pos_embed", "unembed"):
        assert dp[k] is tp[k]
    for p in (tp, dp):
        for k in ("wo", "w_out", "b_out"):
            assert not p["layers"][k].any()
    with pytest.raises(ValueError, match="vocab_size and d_model"):
        harness.agreement_pair(CFG, DRAFT_CFG)
