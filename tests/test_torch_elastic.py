"""The port's elastic contract (``horovod_tpu_torch/elastic.py``) held
against the reference's (``horovod_tpu/elastic.py``).

Every case of tests/test_elastic.py runs on both packages (``pkg``), plus
the two elastic cases of tests/test_checkpoint.py (a commit that overlaps
the disk, a relaunch that resumes from an async commit), the serving
cases of tests/test_serving.py (a mid-flight drain's 503, ServingState's
drain, commit and resume with its prefix round trip) held to the
reference engine's greedy tokens, the commit file both ways (byte for
byte the reference's; each package's ``sync`` reads the other's), the
TrainerState's bitwise resumes in every storage mode, and one 2-rank
gloo job whose ``sync`` converges rank 1 on rank 0's values.
"""

import json
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu import elastic as R
from horovod_tpu.ops.collective import HorovodError as RefHorovodError
from horovod_tpu_torch import elastic as P
from horovod_tpu_torch.frontends.loop import Trainer
from horovod_tpu_torch.models import mnist as M
from horovod_tpu_torch.ops.collective import HorovodError
from horovod_tpu_torch.serving.scheduler import FinishReason
from horovod_tpu_torch.serving.server import LMServer
from horovod_tpu_torch.utils import checkpoint as ck
from horovod_tpu_torch.utils.tree import tree_leaves

from gloo_job import GlooJob
from torch_serving_cases import (CFG_R, PARAMS_R, assert_greedy_agrees,
                                 make_engine)


class Pkg:
    """One package's side of a case: its elastic module, its array type
    and its HorovodError."""

    def __init__(self, name):
        self.name = name
        if name == "port":
            self.elastic, self.Error = P, HorovodError
            self.arr = lambda x: torch.tensor(np.asarray(x, "float32"))
        else:
            self.elastic, self.Error = R, RefHorovodError
            self.arr = lambda x: jnp.asarray(np.asarray(x, "float32"))

    @staticmethod
    def np(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x)


@pytest.fixture(params=["port", "reference"])
def pkg(request, hvd):
    return Pkg(request.param)


@pytest.fixture()
def port():
    """horovod_tpu_torch on the CPU, one thread (bitwise CPU steps)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# tests/test_elastic.py, on both packages
# ---------------------------------------------------------------------------

def test_state_attribute_roundtrip(pkg):
    s = pkg.elastic.State(params={"w": pkg.arr(np.ones(3))}, epoch=0)
    assert s.epoch == 0
    s.epoch = 4
    s.extra = "tag"
    assert s.epoch == 4 and s.extra == "tag"
    with pytest.raises(AttributeError):
        _ = s.missing


def test_commit_restore_rolls_back_uncommitted(pkg):
    s = pkg.elastic.State(params={"w": pkg.arr(np.zeros(2))}, batch=0)
    s.params = {"w": pkg.arr(np.full(2, 5.0))}
    s.batch = 7
    s.commit()
    s.params = {"w": pkg.arr(np.full(2, -1.0))}
    s.batch = 11
    s.transient = 123  # added after the commit: gone on restore
    s.restore()
    np.testing.assert_array_equal(pkg.np(s.params["w"]), 5.0)
    assert s.batch == 7 and isinstance(s.batch, int)
    assert not hasattr(s, "transient")


def test_restore_before_any_commit_returns_to_construction(pkg):
    s = pkg.elastic.State(w=pkg.arr(np.ones(2)), epoch=3)
    s.w = pkg.arr(np.zeros(2))
    s.epoch = 9
    s.restore()
    np.testing.assert_array_equal(pkg.np(s.w), 1.0)
    assert s.epoch == 3


def test_disk_commit_and_fresh_incarnation_sync(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_TPU_ELASTIC_DIR", str(tmp_path))
    s = pkg.elastic.State(params={"w": pkg.arr(np.full(3, 2.5))}, epoch=6,
                          batch=1)
    s.commit()
    assert s.wait_committed(10.0)
    assert (tmp_path / "elastic_state.msgpack").exists()
    fresh = pkg.elastic.State(params={"w": pkg.arr(np.zeros(3))}, epoch=0,
                              batch=0)
    fresh.sync()
    np.testing.assert_array_equal(pkg.np(fresh.params["w"]), 2.5)
    assert fresh.epoch == 6 and isinstance(fresh.epoch, int)
    assert fresh.batch == 1
    fresh.epoch = 99
    fresh.restore()  # sync set the rollback point
    assert fresh.epoch == 6


def test_run_retries_rollback_and_reset_callbacks(pkg):
    s = pkg.elastic.State(w=pkg.arr(np.zeros(2)), step=0)
    resets = []
    s.register_reset_callbacks([lambda: resets.append(True)])

    @pkg.elastic.run
    def train(state):
        while state.step < 4:
            state.w = state.w + 1.0
            state.step += 1
            if state.step == 3 and not resets:
                raise pkg.Error("injected transient failure")
            state.commit()
        return "done"

    assert train(s) == "done"
    assert resets == [True]
    assert s.step == 4
    np.testing.assert_array_equal(pkg.np(s.w), 4.0)


def test_run_exhausts_retries_and_raises(pkg, monkeypatch):
    monkeypatch.setenv("HVD_TPU_ELASTIC_MAX_RETRIES", "2")
    s = pkg.elastic.State(step=0)
    attempts = []

    @pkg.elastic.run
    def train(state):
        attempts.append(True)
        raise pkg.Error("persistent failure")

    with pytest.raises(pkg.Error, match="persistent"):
        train(s)
    assert len(attempts) == 3


def test_run_non_horovod_errors_propagate_immediately(pkg):
    s = pkg.elastic.State(step=0)
    attempts = []

    @pkg.elastic.run
    def train(state):
        attempts.append(True)
        raise ValueError("user bug")

    with pytest.raises(ValueError):
        train(s)
    assert len(attempts) == 1


def test_run_initial_sync_resumes_from_disk(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_TPU_ELASTIC_DIR", str(tmp_path))
    prev = pkg.elastic.State(w=pkg.arr(np.full(2, 3.0)), step=5)
    prev.commit()
    seen = {}

    @pkg.elastic.run
    def train(state):
        seen["step"] = state.step
        seen["w"] = pkg.np(state.w).copy()
        return "ok"

    assert train(pkg.elastic.State(w=pkg.arr(np.zeros(2)), step=0)) == "ok"
    assert seen["step"] == 5
    np.testing.assert_array_equal(seen["w"], 3.0)


def test_commit_snapshot_is_isolated_from_inplace_mutation(pkg):
    """The reference's case with numpy in-place updates; on the port the
    same holds for tensors updated in place (an optimizer step)."""
    w = np.zeros(2, dtype="float32")
    s = pkg.elastic.State(w=w)
    s.commit()
    w += 1.0
    s.restore()
    np.testing.assert_array_equal(np.asarray(s.w), 0.0)
    restored = s.w
    restored += 5.0
    s.restore()
    np.testing.assert_array_equal(np.asarray(s.w), 0.0)


def test_commit_snapshot_is_isolated_from_inplace_tensor_updates():
    w = torch.zeros(2, dtype=torch.bfloat16)
    s = P.State(w=w, n=1)
    s.commit()
    w.add_(1.0)
    s.restore()
    assert torch.equal(s.w, torch.zeros(2, dtype=torch.bfloat16))
    assert s.w.dtype == torch.bfloat16 and s.w is not w
    restored = s.w
    restored.add_(5.0)  # an in-place update after restore
    s.restore()
    assert torch.equal(s.w, torch.zeros(2, dtype=torch.bfloat16))
    # The snapshot is a host copy, never a view of the live tensor.
    assert s._snapshot["w"].data_ptr() != s.w.data_ptr()


def test_retry_budget_resets_after_committed_progress(pkg, monkeypatch):
    monkeypatch.setenv("HVD_TPU_ELASTIC_MAX_RETRIES", "1")
    s = pkg.elastic.State(step=0)
    failures = []

    @pkg.elastic.run
    def train(state):
        while state.step < 4:
            state.step += 1
            state.commit()
            if len(failures) < state.step:
                failures.append(state.step)
                raise pkg.Error("transient")
        return state.step

    assert train(s) == 4
    assert failures == [1, 2, 3, 4]
    s2 = pkg.elastic.State(step=0)
    tries = []

    @pkg.elastic.run
    def never(state):
        tries.append(True)
        raise pkg.Error("stuck")

    with pytest.raises(pkg.Error):
        never(s2)
    assert len(tries) == 2


# ---------------------------------------------------------------------------
# TrainerState over the port's Trainer, every storage mode
# ---------------------------------------------------------------------------

MODES = ["plain", "zero", "fsdp", "model_state"]
IMAGES, LABELS = M.synthetic_mnist(64)


def _batches(epoch, step):
    i = (epoch * 2 + step) % 4 * 16
    return IMAGES[i:i + 16], LABELS[i:i + 16]


def _trainer(mode, seed=0):
    kw = {"zero": True} if mode == "zero" else (
        {"fsdp": True} if mode == "fsdp" else {})
    opt = dict(optimizer_fn=torch.optim.AdamW, lr=0.01,
               optimizer_kwargs={"weight_decay": 1e-4})
    if mode == "model_state":
        bn = M.MnistBNMLP(hidden=16)
        p, s = M.init_bn_mlp(bn, seed=seed)
        return Trainer(M.bn_mlp_loss_fn(bn), p, model_state=s, **opt)
    model = M.MnistMLP(hidden=16)
    return Trainer(lambda p, b: M.cross_entropy_loss(model.apply(p, b[0]),
                                                     b[1]),
                   M.init_params(model, seed), **opt, **kw)


def _fit_epoch(trainer, epoch):
    trainer.fit(_batches, epochs=epoch + 1, steps_per_epoch=2,
                initial_epoch=epoch)


def _final(trainer):
    """The trainer's parameters, model state and optimizer moments."""
    opt = P._optimizer_state(trainer)
    out = [x.detach().clone() for x in tree_leaves(trainer.params)]
    if trainer.model_state is not None:
        out += [x.clone() for x in tree_leaves(trainer.model_state)]
    return out + [st[k].clone() for _, st in sorted(opt["state"].items())
                  for k in sorted(st) if isinstance(st[k], torch.Tensor)]


def _bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("mode", MODES)
def test_trainer_state_commit_restore_and_retry(port, mode):
    """A transient failure after the trainer was diverged past the commit
    rolls it back (parameters, AdamW moments and step, model state) and
    the retried run ends bitwise an uninterrupted one."""
    straight = _trainer(mode)
    for e in range(3):
        _fit_epoch(straight, e)

    trainer = _trainer(mode)
    state = P.TrainerState(trainer, epoch=0)
    failed = []

    @P.run
    def train(state):
        while state.epoch < 3:
            _fit_epoch(trainer, state.epoch)
            state.epoch += 1
            state.commit()
            if state.epoch == 2 and not failed:
                _fit_epoch(trainer, 7)  # diverge past the commit
                params = trainer.params
                with torch.no_grad():
                    for x in tree_leaves(params):
                        x.zero_()
                trainer.params = params
                failed.append(True)
                raise HorovodError("transient")
        return trainer.history

    history = train(state)
    assert state.epoch == 3 and failed == [True]
    assert all(np.isfinite(h["loss"]) for h in history)
    _bitwise(_final(trainer), _final(straight))


@pytest.mark.parametrize("mode", MODES)
def test_trainer_state_resumes_bitwise_through_the_disk(port, mode, tmp_path,
                                                        monkeypatch):
    """A relaunched incarnation: a fresh trainer (other weights, an
    optimizer with no state yet) syncs the disk commit and ends bitwise
    the uninterrupted run."""
    monkeypatch.setenv("HVD_TPU_ELASTIC_DIR", str(tmp_path))
    straight = _trainer(mode)
    for e in range(4):
        _fit_epoch(straight, e)

    first = _trainer(mode)
    state = P.TrainerState(first, epoch=0)
    for e in range(2):
        _fit_epoch(first, e)
        state.epoch = e + 1
        state.commit()
    _fit_epoch(first, 2)  # uncommitted progress, lost with the process
    assert state.wait_committed(30.0)

    again = _trainer(mode, seed=1)
    resumed = P.TrainerState(again, epoch=0)
    resumed.sync()
    assert resumed.epoch == 2
    for e in range(resumed.epoch, 4):
        _fit_epoch(again, e)
    _bitwise(_final(again), _final(straight))


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py:155,168: the commit rides the background writer
# ---------------------------------------------------------------------------

def _slow_write(seconds):
    real = ck._write_bytes

    def write(path, data):
        time.sleep(seconds)
        real(path, data)

    return write


def test_elastic_commit_overlaps_disk(tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_TPU_ELASTIC_DIR", str(tmp_path))
    monkeypatch.setattr(ck, "_write_bytes", _slow_write(0.4))
    state = P.State(w=torch.arange(4.0), step=3)
    t0 = time.perf_counter()
    state.commit()
    latency = time.perf_counter() - t0
    assert latency < 0.2, f"commit blocked {latency:.3f}s on a 0.4s disk"
    assert state.wait_committed(10.0)
    assert (tmp_path / P._STATE_FILE).exists()


def test_elastic_relaunch_resumes_from_async_commit(tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_TPU_ELASTIC_DIR", str(tmp_path))
    monkeypatch.setattr(ck, "_write_bytes", _slow_write(0.3))
    first = P.State(w=torch.arange(4.0) * 2.0, step=9)
    first.commit()  # returns before the 0.3 s write lands
    relaunched = P.State(w=torch.zeros(4), step=0)
    relaunched.sync()  # fences the publish first
    assert relaunched.step == 9
    assert torch.equal(relaunched.w, torch.arange(4.0) * 2.0)


# ---------------------------------------------------------------------------
# The commit file, both ways
# ---------------------------------------------------------------------------

RNG = np.random.RandomState(3)
W32 = RNG.normal(size=(3, 4)).astype(np.float32)
B16 = RNG.normal(size=(5,)).astype(ml_dtypes.bfloat16)
BLOB = np.frombuffer(b'{"requests": [], "prefixes": []}', np.uint8).copy()


def _port_values():
    b16 = torch.from_numpy(B16.view(np.int16).copy()).view(torch.bfloat16)
    return dict(params={"w": torch.from_numpy(W32.copy()), "b": b16},
                step=7, lr=0.5, flag=True, blob=torch.from_numpy(BLOB))


def _ref_values():
    return dict(params={"w": jnp.asarray(W32), "b": jnp.asarray(B16)},
                step=7, lr=0.5, flag=True, blob=BLOB.copy())


def _commit(elastic, values, d, monkeypatch):
    monkeypatch.setenv("HVD_TPU_ELASTIC_DIR", str(d))
    s = elastic.State(**values)
    s.commit()
    assert s.wait_committed(10.0)
    return (d / "elastic_state.msgpack").read_bytes()


def test_commit_file_is_byte_identical_to_the_references(hvd, tmp_path,
                                                         monkeypatch):
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    mine = _commit(P, _port_values(), tmp_path / "p", monkeypatch)
    theirs = _commit(R, _ref_values(), tmp_path / "r", monkeypatch)
    assert mine == theirs


def _zeroed_port():
    return dict(params={"w": torch.zeros(3, 4),
                        "b": torch.zeros(5, dtype=torch.bfloat16)},
                step=0, lr=0.0, flag=False,
                blob=torch.zeros(1, dtype=torch.uint8))


def _zeroed_ref():
    return dict(params={"w": jnp.zeros((3, 4)),
                        "b": jnp.zeros((5,), jnp.bfloat16)},
                step=0, lr=0.0, flag=False, blob=np.zeros(1, np.uint8))


def test_port_sync_reads_the_references_commit(hvd, tmp_path, monkeypatch):
    _commit(R, _ref_values(), tmp_path, monkeypatch)
    s = P.State(**_zeroed_port())
    s.sync()
    assert torch.equal(s.params["w"], torch.from_numpy(W32))
    assert s.params["b"].dtype == torch.bfloat16
    assert np.array_equal(
        s.params["b"].view(torch.int16).numpy(), B16.view(np.int16))
    assert (s.step, s.lr, s.flag) == (7, 0.5, True)
    assert [type(v) for v in (s.step, s.lr, s.flag)] == [int, float, bool]
    assert bytes(s.blob.numpy()) == bytes(BLOB)


def test_reference_sync_reads_the_ports_commit(hvd, tmp_path, monkeypatch):
    _commit(P, _port_values(), tmp_path, monkeypatch)
    s = R.State(**_zeroed_ref())
    s.sync()
    np.testing.assert_array_equal(np.asarray(s.params["w"]), W32)
    assert np.array_equal(np.asarray(s.params["b"]).view(np.int16),
                          B16.view(np.int16))
    assert (s.step, s.lr, s.flag) == (7, 0.5, True)
    assert bytes(np.asarray(s.blob)) == bytes(BLOB)


def test_sync_names_a_value_the_commit_lacks(tmp_path, monkeypatch):
    _commit(P, {"w": torch.ones(2)}, tmp_path, monkeypatch)
    with pytest.raises(ValueError, match="epoch"):
        P.State(w=torch.zeros(2), epoch=0).sync()


def test_cluster_reformable_reads_the_runtime(monkeypatch):
    from horovod_tpu_torch.core import state as st

    class Runtime:
        peer_shutdown = False

        class _stopped:
            @staticmethod
            def is_set():
                return False

    rt = Runtime()
    monkeypatch.setattr(st, "_state", st._State(initialized=True, size=2,
                                                runtime=rt))
    assert P._cluster_reformable()
    rt.peer_shutdown = True
    assert not P._cluster_reformable()
    monkeypatch.setattr(st, "_state", st._State(initialized=True, size=1,
                                                runtime=rt))
    assert P._cluster_reformable()  # one rank: nothing to re-form


def test_a_waiter_on_a_stopped_runtime_gets_its_message(port):
    """A failed exchange stops the runtime before it fails the queued
    ops; a synchronize in that window raises the shutdown's
    HorovodError (which elastic.run handles), not an AttributeError of
    a missing result."""
    from horovod_tpu_torch.core import state as st

    rt = st._state.runtime
    with rt.cycle_lock:  # no cycle runs the op before the stop
        h = thvd.allreduce_async(torch.ones(2), name="stopped.op")
        rt.shutdown_message = "Horovod has been shut down: injected"
        rt._stopped.set()
    with pytest.raises(HorovodError, match="injected"):
        thvd.synchronize(h)


# ---------------------------------------------------------------------------
# Serving: tests/test_serving.py:891,1012,1289
# ---------------------------------------------------------------------------

PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5], [2, 7, 1, 8]]


def _reference_tokens(prompts, n, **kw):
    from horovod_tpu.serving import InferenceEngine as RefEngine

    eng = RefEngine(PARAMS_R, CFG_R, max_slots=3, page_size=8,
                    capacity=32, **kw)
    eng.warm_start()
    return [eng.generate(list(p), max_new_tokens=n) for p in prompts]


def _held_to_reference(prompts, got, n, **kw):
    """Each completion against the reference engine's greedy tokens: equal
    wherever the reference's top-2 margin decides the token."""
    for p, g, want in zip(prompts, got, _reference_tokens(prompts, n, **kw)):
        held = assert_greedy_agrees(p, g, 32)
        if held == len(g):
            assert g == want


def _post(url, payload, timeout=30.0):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def test_elastic_serving_state_drain_commit_resume(tmp_path, monkeypatch):
    """Drain mid-generation, commit, 'relaunch' a fresh engine, resume:
    completions equal the uninterrupted run exactly, and the reference
    engine's greedy tokens."""
    monkeypatch.setenv("HVD_TPU_ELASTIC_DIR", str(tmp_path))
    e0 = make_engine()
    e0.warm_start()
    ref = [e0.generate(list(p), max_new_tokens=10) for p in PROMPTS]
    e1 = make_engine()
    e1.warm_start()
    for p in PROMPTS:
        e1.submit(list(p), max_new_tokens=10)
    state = P.ServingState(e1)
    for _ in range(4):
        e1.step()
    exported = state.drain_commit()
    assert state.wait_committed()
    assert len(exported) == 3
    assert any(x["generated_prefix"] for x in exported)

    e2 = make_engine()
    e2.warm_start()
    state2 = P.ServingState(e2)
    state2.sync()
    pend = e2.scheduler.pending()
    assert len(pend) == 3
    e2.run_until_idle()
    results = sorted(tuple(r.result(0)) for r in pend)
    assert results == sorted(map(tuple, ref))
    _held_to_reference(PROMPTS, ref, 10)


def test_elastic_serving_state_prefix_roundtrip(tmp_path, monkeypatch):
    """drain_commit exports the prefix index beside the continuations; the
    relaunched engine's sync() rebuilds the shared pages, so the first
    request after it hits, bitwise."""
    from horovod_tpu_torch import telemetry

    def hits():
        return telemetry.metrics().get("serving.prefix_hits",
                                       {}).get("value", 0)

    monkeypatch.setenv("HVD_TPU_ELASTIC_DIR", str(tmp_path))
    header = list(range(1, 18))  # 2 full pages published
    eng = make_engine(prefix_cache=True)
    eng.warm_start()
    ref_a = eng.generate(list(header), max_new_tokens=4)
    assert eng.cache.prefix_stats()["cached_pages"] == 2
    state = P.ServingState(eng)
    mid = eng.submit(header + [60], max_new_tokens=6)
    exported = state.drain_commit()
    assert state.wait_committed()
    assert exported and mid.finish_reason == FinishReason.DRAINED

    fresh = make_engine(prefix_cache=True)
    fresh.warm_start()
    state2 = P.ServingState(fresh)
    state2.sync()
    assert fresh.cache.prefix_stats()["cached_pages"] >= 2
    pend = fresh.scheduler.pending()
    assert len(pend) == 1
    fresh.run_until_idle()
    plain = make_engine(prefix_cache=False)
    plain.warm_start()
    want = plain.generate(header + [60], max_new_tokens=6)
    assert pend[0].result(0) == want
    _held_to_reference([header + [60]], [want], 6)
    h0 = hits()
    assert fresh.generate(list(header), max_new_tokens=4) == ref_a
    assert hits() > h0


def test_lmserver_drain_and_resume_over_http():
    """POST /drain mid-generation: the in-flight handler answers a
    retryable 503 with finish_reason 'drained', /drain answers with the
    export and /healthz turns NOT_READY; POST /resume on a fresh server
    installs it and the completion equals the uninterrupted rollout."""
    import threading

    want = make_engine()
    want.warm_start()
    want = want.generate([3, 1, 4, 1, 5], max_new_tokens=10)
    engine = make_engine()
    with LMServer(engine, port=0).start() as srv:
        base = f"http://127.0.0.1:{srv.port}"
        orig = engine._decode_iteration
        steps, drained = [0], {}

        def slow(active):
            steps[0] += 1
            if steps[0] == 3:
                drained.update(_post(base + "/drain", {})[1])
            return orig(active)

        engine._decode_iteration = slow
        got = {}

        def client():
            try:
                _post(base + "/generate", {"tokens": [3, 1, 4, 1, 5],
                                           "max_tokens": 10})
            except urllib.error.HTTPError as e:
                got["code"], got["body"] = e.code, json.loads(e.read())

        t = threading.Thread(target=client)
        t.start()
        t.join(60.0)
        assert got["code"] == 503 and got["body"]["finish_reason"] == \
            "drained", got
        assert not engine.ready
        with pytest.raises(urllib.error.HTTPError) as health:
            urllib.request.urlopen(base + "/healthz", timeout=10)
        assert health.value.code == 503
    [cont] = drained["requests"]
    assert cont["generated_prefix"] and "prefixes" in drained

    fresh = make_engine()
    resumed = []
    real_import = fresh.import_requests

    def spy(exported):
        resumed.extend(real_import(exported))
        return resumed

    fresh.import_requests = spy
    with LMServer(fresh, port=0).start() as srv2:
        base = f"http://127.0.0.1:{srv2.port}"
        status, body = _post(base + "/resume", drained)
        assert status == 200 and body == {"installed": 1, "ready": True}
        [req] = resumed
        assert req.result(60.0) == want
        status, again = _post(base + "/generate",
                              {"tokens": [3, 1, 4, 1, 5], "max_tokens": 10})
        assert status == 200 and again["tokens"] == want
    _held_to_reference([[3, 1, 4, 1, 5]], [want], 10)


def test_lmserver_close_unregisters_drain_and_resume():
    from horovod_tpu_torch.telemetry import exporter

    routes = exporter.RouteRegistry()
    srv = LMServer(make_engine(), port=0, routes=routes).start()
    assert routes.lookup("POST", "/drain") is not None
    assert routes.lookup("POST", "/resume") is not None
    srv.close()
    assert routes.lookup("POST", "/drain") is None
    assert routes.lookup("POST", "/resume") is None


def test_serving_install_payload_takes_a_bare_request_list():
    eng = make_engine()
    eng.warm_start()
    req = eng.submit([3, 1, 4, 1, 5], max_new_tokens=10)
    eng.step()
    exported = eng.drain()
    assert req.finish_reason == FinishReason.DRAINED
    fresh = make_engine()
    fresh.warm_start()
    [installed] = P.serving_install_payload(fresh, exported)
    assert installed["generated_prefix"] == exported[0]["generated_prefix"]
    pend = fresh.scheduler.pending()
    fresh.run_until_idle()
    plain = make_engine()
    plain.warm_start()
    assert pend[0].result(0) == plain.generate([3, 1, 4, 1, 5],
                                               max_new_tokens=10)


# ---------------------------------------------------------------------------
# Two gloo ranks: sync converges rank 1 on rank 0's values
# ---------------------------------------------------------------------------

SYNC_WORKER = """
import os
from horovod_tpu_torch import elastic
from horovod_tpu_torch.frontends.loop import Trainer
from horovod_tpu_torch.models import mnist as M
from horovod_tpu_torch.ops.collective import HorovodError

out = {}
# Divergent values on the two ranks; no commit file: rank 0's win.
b16 = torch.full((3,), 1.5 + RANK, dtype=torch.bfloat16)
s = elastic.State(params={"w": torch.arange(4.0) * (RANK + 1), "b": b16},
                  step=3 + RANK, lr=0.5 * (RANK + 1), flag=RANK == 0,
                  host=np.full(2, float(RANK), "float64"))
s.sync()
out["w"] = s.params["w"].numpy()
out["b"] = s.params["b"].float().numpy()
out["b_dtype"] = str(s.params["b"].dtype)
out["scalars"] = np.array([s.step, s.lr, float(s.flag)])
out["types"] = np.array([type(s.step).__name__, type(s.lr).__name__,
                         type(s.flag).__name__])
out["host"] = s.host
# restore() returns to the synced values on every rank.
s.params = {"w": torch.zeros(4), "b": b16}
s.restore()
out["restored_w"] = s.params["w"].numpy()

# A relaunch: rank 0 reads a TrainerState commit holding AdamW's state,
# rank 1's fresh optimizer has none yet.
edir = os.path.join(os.path.dirname(OUT), "edir")
os.environ["HVD_TPU_ELASTIC_DIR"] = edir
model = M.MnistMLP(hidden=8)
images, labels = M.synthetic_mnist(32)
batches = lambda e, st: (images, labels)
def trainer(seed):
    return Trainer(lambda p, b: M.cross_entropy_loss(model.apply(p, b[0]),
                                                     b[1]),
                   M.init_params(model, seed), torch.optim.AdamW, lr=0.01)
t = trainer(0)
ts = elastic.TrainerState(t, epoch=0)
t.fit(batches, epochs=1, steps_per_epoch=2)
ts.epoch = 1
ts.commit()
ts.wait_committed(30)
dist.barrier()
fresh = trainer(RANK + 5)
fs = elastic.TrainerState(fresh, epoch=0)
fs.sync()
out["trainer_epoch"] = np.array(fs.epoch)
out["trainer_params"] = np.concatenate(
    [x.detach().numpy().ravel() for x in hvd.tree_leaves(fresh.params)])
out["trainer_moments"] = np.concatenate(
    [v.numpy().ravel() for st in fresh.optimizer.state_dict()["state"].values()
     for k, v in sorted(st.items())])

# A ServingState blob whose length differs between the ranks: the
# coordinator names the mismatch, as in the reference.
blob = elastic.State(requests_blob=torch.zeros(4 + RANK, dtype=torch.uint8))
os.environ.pop("HVD_TPU_ELASTIC_DIR")
try:
    blob.sync()
    out["mismatch"] = np.array("no error")
except HorovodError as e:
    out["mismatch"] = np.array(str(e))
finish(out)
"""


def test_two_gloo_ranks_sync_converges_on_rank_0(tmp_path):
    job = GlooJob(tmp_path, SYNC_WORKER, 2, {"unused": np.zeros(1)})
    results = job.results()
    for out in results:
        np.testing.assert_array_equal(out["w"], np.arange(4.0))
        np.testing.assert_array_equal(out["b"], np.full(3, 1.5))
        assert str(out["b_dtype"]) == "torch.bfloat16"
        np.testing.assert_array_equal(out["scalars"], [3, 0.5, 1.0])
        assert list(out["types"]) == ["int", "float", "bool"]
        np.testing.assert_array_equal(out["host"], np.zeros(2))
        np.testing.assert_array_equal(out["restored_w"], np.arange(4.0))
        assert int(out["trainer_epoch"]) == 1
        assert "Mismatch" in str(out["mismatch"]), out["mismatch"]
    a, b = results
    np.testing.assert_array_equal(a["trainer_params"], b["trainer_params"])
    np.testing.assert_array_equal(a["trainer_moments"], b["trainer_moments"])
    assert a["trainer_moments"].any()
