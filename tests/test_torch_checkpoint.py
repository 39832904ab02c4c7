"""horovod_tpu_torch's checkpointing (utils/checkpoint.py, utils/retry.py)
against horovod_tpu's.

* The counterparts of tests/test_checkpoint.py (the background writer,
  the sharded format), of test_chaos.py's retry and checkpoint-retry
  tests (the fault injected by patching the writer's ``open``: the chaos
  sites wait for ROADMAP A.5) and of test_callbacks.py's round trip.
* Cross-package: the reference's single-file and sharded checkpoints
  restore in the port bitwise, and the port's in the reference.
* Resume at a small width on the CPU (2 layers, d_model 64, one thread:
  the embedding's backward is bitwise only so), bitwise against
  straight runs: make_train_step with AdamW, ZeRO, FSDP, the pipeline's
  per-stage optimizers; the ResNet example's resume (ResNet18Thin, 33 px).
* Two gloo ranks (one job): rank 0 saves, rank 1 restores from
  divergent values, the broadcast elided with a shared file and taken
  with a file only rank 0 has, and a strict 2-rank sharded save
  restored at a world of 1.
* chip_smoke.py runs its checkpoint phase after the pipeline phase.
"""

import glob
import os
import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as flax_serialization

import horovod_tpu_torch as thvd
from gloo_job import GlooJob
from horovod_tpu.models import transformer as jt
from horovod_tpu.utils import checkpoint as jck
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.utils import checkpoint as ck
from horovod_tpu_torch.utils.convert import params_from_jax
from horovod_tpu_torch.utils.retry import BackoffPolicy, retry_call
from horovod_tpu_torch.utils.tree import tree_leaves

JCFG = jt.TransformerConfig(vocab_size=128, d_model=64, n_heads=4,
                            n_layers=2, d_ff=128, max_seq_len=64)
TCFG = tt.TransformerConfig(vocab_size=128, d_model=64, n_heads=4,
                            n_layers=2, d_ff=128, max_seq_len=64)


@pytest.fixture()
def port():
    """horovod_tpu_torch on the CPU, one thread (bitwise CPU steps)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()
    torch.set_num_threads(threads)


def _tree():
    return {"w": torch.arange(8.0), "b": np.arange(4.0, dtype="float32")}


def _slow_write(seconds):
    real = ck._write_bytes

    def write(path, data):
        time.sleep(seconds)
        real(path, data)

    return write


def _held_write(monkeypatch, seconds=0.0):
    """Hold every publish of the writer thread until the returned event
    is set (then take ``seconds`` more): the test, not the load on the
    machine, decides what happens while a write is in flight."""
    gate = threading.Event()
    real = ck._write_bytes

    def write(path, data):
        if not gate.wait(60.0):
            raise OSError("the test never released the write")
        time.sleep(seconds)
        real(path, data)

    monkeypatch.setattr(ck, "_write_bytes", write)
    return gate


def _stat(name):
    value = ck.stats()[name]
    return dict(value) if isinstance(value, dict) else value


# ---------------------------------------------------------------------------
# Background writes (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def test_save_checkpoint_async_roundtrip(port, tmp_path):
    path = str(tmp_path / "ckpt.msgpack")
    h = ck.save_checkpoint(path, _tree(), step=7)
    assert bool(h)  # truthy on the saving rank
    assert h.wait(10.0)
    target = {"w": torch.zeros(8), "b": np.zeros(4, "float32")}
    restored = ck.restore_checkpoint(path, target, broadcast=False)
    assert restored["w"] is target["w"]  # filled in place
    assert torch.equal(target["w"], torch.arange(8.0))
    np.testing.assert_array_equal(restored["b"], np.arange(4.0))
    assert ck.resume_epoch(path) == 7


def test_save_latency_excludes_disk(port, tmp_path, monkeypatch):
    """With a deliberately slow filesystem the save's latency is the
    host snapshot; the disk time lands on the writer thread."""
    before = _stat("checkpoint.write_seconds")
    gate = _held_write(monkeypatch, 0.5)
    path = str(tmp_path / "slow.msgpack")
    t0 = time.perf_counter()
    h = ck.save_checkpoint(path, _tree())
    call_latency = time.perf_counter() - t0
    assert call_latency < 0.25, (
        f"save_checkpoint blocked {call_latency:.3f}s on a held disk")
    assert not h.done
    gate.set()
    assert h.wait(10.0)
    assert os.path.exists(path)
    after = _stat("checkpoint.write_seconds")
    assert after["count"] >= before["count"] + 1
    assert after["sum"] - before["sum"] >= 0.5


def test_block_true_restores_sync_semantics(port, tmp_path):
    path = str(tmp_path / "sync.msgpack")
    h = ck.save_checkpoint(path, _tree(), block=True)
    assert h.done and os.path.exists(path)


def test_writer_killed_mid_write_previous_checkpoint_intact(
        port, tmp_path, monkeypatch):
    """A write that dies midway (partial tmp, no rename) leaves the
    previous checkpoint's bytes untouched and fails at wait()."""
    path = str(tmp_path / "atomic.msgpack")
    ck.save_checkpoint(path, {"v": torch.tensor(1.0)}).wait(10.0)
    good = open(path, "rb").read()

    def dying_write(p, data):
        blob = b"".join(ck._pieces(data))
        with open(f"{p}.tmp.partial", "wb") as f:
            f.write(blob[: len(blob) // 2])  # torn tmp left behind
        raise OSError("disk died mid-write")

    errors_before = _stat("checkpoint.errors")
    monkeypatch.setattr(ck, "_write_bytes", dying_write)
    h = ck.save_checkpoint(path, {"v": torch.tensor(2.0)})
    with pytest.raises(ck.CheckpointError, match="disk died"):
        h.wait(10.0)
    monkeypatch.undo()
    assert open(path, "rb").read() == good
    restored = ck.restore_checkpoint(path, {"v": torch.zeros(())},
                                     broadcast=False)
    assert float(restored["v"]) == 1.0
    assert _stat("checkpoint.errors") == errors_before + 1


def test_writes_apply_in_submission_order(port, tmp_path):
    path = str(tmp_path / "ordered.msgpack")
    handles = [ck.save_checkpoint(path, {"v": torch.tensor(float(i))})
               for i in range(5)]
    for h in handles:
        h.wait(10.0)
    restored = ck.restore_checkpoint(path, {"v": torch.zeros(())},
                                     broadcast=False)
    assert float(restored["v"]) == 4.0


def test_restore_fences_pending_writes(port, tmp_path, monkeypatch):
    monkeypatch.setattr(ck, "_write_bytes", _slow_write(0.3))
    path = str(tmp_path / "fence.msgpack")
    ck.save_checkpoint(path, {"v": torch.tensor(3.0)})
    restored = ck.restore_checkpoint(path, {"v": torch.zeros(())},
                                     broadcast=False)
    assert float(restored["v"]) == 3.0


@pytest.mark.parametrize("kind", ["numpy", "tensor", "optimizer"])
def test_leaves_snapshot_at_call_time(port, tmp_path, monkeypatch, kind):
    """An in-place change after save_checkpoint returns (the next step's
    update) never reaches the written bytes: the snapshot is a copy,
    taken at the call, also of an optimizer's moments."""
    gate = _held_write(monkeypatch)
    path = str(tmp_path / "snap.msgpack")
    p = torch.nn.Parameter(torch.arange(4.0))
    opt = torch.optim.Adam([p], lr=0.1)
    p.grad = torch.ones(4)
    opt.step()
    leaf = {"numpy": np.arange(4.0, dtype="float32"),
            "tensor": torch.arange(4.0), "optimizer": opt}[kind]
    want = ({"numpy": lambda: leaf.copy(), "tensor": lambda: leaf.clone(),
             "optimizer": lambda: opt.state[p]["exp_avg"].clone()}[kind])()
    h = ck.save_checkpoint(path, {"a": leaf})
    if kind == "numpy":
        leaf[:] = -1.0
    elif kind == "tensor":
        leaf.mul_(-1.0)
    else:
        opt.step()  # moves the moments in place
    assert not h.done
    gate.set()
    h.wait(10.0)
    if kind == "optimizer":
        q = torch.nn.Parameter(torch.zeros(4))
        fresh = torch.optim.Adam([q], lr=0.1)
        ck.restore_checkpoint(path, {"a": fresh}, broadcast=False)
        assert torch.equal(fresh.state[q]["exp_avg"], want)
        return
    target = {"a": np.zeros(4, "float32") if kind == "numpy"
              else torch.zeros(4)}
    got = ck.restore_checkpoint(path, target, broadcast=False)["a"]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_pending_gauge_and_wait_for_writes(port, tmp_path, monkeypatch):
    gate = _held_write(monkeypatch)
    path = str(tmp_path / "pending.msgpack")
    ck.save_checkpoint(path, _tree())
    assert ck.pending_writes() >= 1
    assert _stat("checkpoint.pending") >= 1
    gate.set()
    assert ck.wait_for_writes(10.0)
    assert ck.pending_writes() == 0
    assert _stat("checkpoint.pending") == 0


def test_compression_state_rides_checkpoints(port, tmp_path):
    """int8 error-feedback residuals ride a checkpoint: after
    load_compression_state the resumed allreduce replays bitwise."""
    from horovod_tpu_torch.ops import megakernel as mk

    thvd.set_compression("int8")
    try:
        rng = np.random.default_rng(21)
        x = torch.from_numpy(rng.standard_normal((4, 256))
                             .astype("float32"))
        thvd.allreduce(x, op=thvd.Sum, name="ckq")
        snap = thvd.compression_state()
        assert snap["residuals"]
        path = str(tmp_path / "q.msgpack")
        ck.save_checkpoint(path, {"params": _tree(), "quant": snap},
                           block=True)
        out_next = thvd.allreduce(x, op=thvd.Sum, name="ckq")
        mk.flush("test: relaunch")
        restored = ck.restore_checkpoint(
            path, {"params": _tree(), "quant": snap}, broadcast=False)
        thvd.load_compression_state(restored["quant"])
        out_resumed = thvd.allreduce(x, op=thvd.Sum, name="ckq")
        assert torch.equal(out_next, out_resumed)
    finally:
        thvd.set_compression()


def test_restore_refuses_a_mismatched_leaf_naming_its_path(port, tmp_path):
    path = str(tmp_path / "m.msgpack")
    ck.save_checkpoint(path, {"a": {"w": torch.zeros(3, 2)}}, block=True)
    with pytest.raises(ck.CheckpointError, match=r"\./a/w.*\(3, 2\)"):
        ck.restore_checkpoint(path, {"a": {"w": torch.zeros(2, 3)}})
    with pytest.raises(ck.CheckpointError, match=r"\./a/w.*float64"):
        ck.restore_checkpoint(path, {"a": {"w": torch.zeros(
            3, 2, dtype=torch.float64)}})
    with pytest.raises(ValueError, match=r"keys \{'v'\}.*path \./a"):
        ck.restore_checkpoint(path, {"a": {"w": torch.zeros(3, 2),
                                           "v": torch.zeros(1)}})


def test_shard_state_round_trips_its_optimizer():
    """ZeRO's ShardState saves and restores its shard's optimizer."""
    from horovod_tpu_torch.parallel.zero import ShardState

    shard = torch.zeros(5, requires_grad=True)
    state = ShardState(shard, torch.optim.AdamW([shard], lr=0.1))
    shard.grad = torch.arange(5.0)
    state.optimizer.step()
    other = torch.zeros(5, requires_grad=True)
    fresh = ShardState(other, torch.optim.AdamW([other], lr=0.5))
    fresh.load_state_dict(state.state_dict())
    assert fresh.optimizer.param_groups[0]["lr"] == 0.1
    assert torch.equal(fresh.optimizer.state[other]["exp_avg_sq"],
                       state.optimizer.state[shard]["exp_avg_sq"])


# ---------------------------------------------------------------------------
# Retries (tests/test_chaos.py: utils/retry.py and the checkpoint writer)
# ---------------------------------------------------------------------------

def test_backoff_policy_jitter_bounds_and_cap():
    p = BackoffPolicy(base=0.1, cap=1.0, rng=random.Random(7))
    for k in range(12):
        d = p.delay(k)
        assert 0.0 <= d <= min(1.0, 0.1 * 2 ** k)
    ceilings = [min(1.0, 0.1 * 2 ** k) for k in range(12)]
    assert ceilings[-1] == 1.0


def test_backoff_policy_rejects_nonsense():
    with pytest.raises(ValueError):
        BackoffPolicy(base=0.0)
    with pytest.raises(ValueError):
        BackoffPolicy(base=1.0, cap=0.5)


def test_retry_call_retries_then_succeeds_and_reports():
    calls = {"n": 0}
    seen = []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError(28, "flaky")
        return "ok"

    out = retry_call(flaky, attempts=4,
                     policy=BackoffPolicy(base=0.001, cap=0.002),
                     on_retry=lambda a, e, d: seen.append((a, str(e))))
    assert out == "ok" and calls["n"] == 3
    assert [a for a, _ in seen] == [0, 1]


def test_retry_call_exhaustion_reraises_original():
    with pytest.raises(OSError, match="always"):
        retry_call(lambda: (_ for _ in ()).throw(OSError("always")),
                   attempts=3,
                   policy=BackoffPolicy(base=0.001, cap=0.002))


def _failing_open(monkeypatch, failures):
    """The writer's open fails ``failures`` times on a tmp file with an
    injected transient ENOSPC (the reference's chaos site
    ``ckpt.oserror``), then opens normally."""
    left = {"n": failures}

    def fake_open(path, *args, **kwargs):
        if ".tmp." in str(path) and left["n"] > 0:
            left["n"] -= 1
            raise OSError(28, "injected ckpt.oserror (transient ENOSPC)",
                          path)
        return open(path, *args, **kwargs)

    monkeypatch.setattr(ck, "open", fake_open, raising=False)


def test_checkpoint_transient_oserror_retries_then_lands(tmp_path, capfd,
                                                         monkeypatch):
    _failing_open(monkeypatch, 2)
    before = _stat("checkpoint.retries")
    tree = {"w": np.arange(16, dtype=np.float32)}
    handle = ck.write_tree_async(str(tmp_path / "m.msgpack"), tree, step=4)
    assert handle.wait(timeout=30.0)
    assert (tmp_path / "m.msgpack").exists()
    assert (tmp_path / "m.msgpack.step").read_text() == "4"
    assert _stat("checkpoint.retries") - before >= 2
    assert "retrying" in capfd.readouterr().err
    assert not glob.glob(str(tmp_path / "*.tmp.*"))


def test_checkpoint_retry_exhaustion_names_fault(tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_TPU_CKPT_RETRIES", "2")
    _failing_open(monkeypatch, 9)
    retries, errors = _stat("checkpoint.retries"), _stat("checkpoint.errors")
    tree = {"w": np.arange(8, dtype=np.float32)}
    handle = ck.write_tree_async(str(tmp_path / "m.msgpack"), tree)
    with pytest.raises(ck.CheckpointError, match="ckpt.oserror"):
        handle.wait(timeout=30.0)
    assert _stat("checkpoint.retries") == retries + 1
    assert _stat("checkpoint.errors") == errors + 1
    assert not os.path.exists(tmp_path / "m.msgpack")


# ---------------------------------------------------------------------------
# tests/test_callbacks.py's round trip
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_resume(port, tmp_path):
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}
    path = str(tmp_path / "ckpt.msgpack")
    write = ck.save_checkpoint(path, params, step=7)
    assert write
    assert write.wait(10.0)
    target = {"w": torch.zeros((2, 3)), "b": torch.zeros(3)}
    restored = ck.restore_checkpoint(path, target)
    np.testing.assert_allclose(restored["w"].numpy(),
                               np.arange(6.0).reshape(2, 3))
    assert ck.resume_epoch(path) == 7


# ---------------------------------------------------------------------------
# Sharded checkpoints (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def _big_tree():
    rng = np.random.default_rng(11)
    return {
        "layers": [
            {"w": rng.standard_normal((16, 16)).astype("float32"),
             "b": rng.standard_normal((16,)).astype("float32")}
            for _ in range(3)
        ],
        "head": rng.standard_normal((16, 4)).astype("float64"),
        "meta": {"epoch": 9, "name": "m"},
    }


def _port_big_tree():
    t = _big_tree()
    return {"layers": [{k: torch.from_numpy(v) for k, v in layer.items()}
                       for layer in t["layers"]],
            "head": torch.from_numpy(t["head"]), "meta": t["meta"]}


def _zeros_like_big():
    return {
        "layers": [
            {"w": torch.zeros((16, 16)), "b": torch.zeros((16,))}
            for _ in range(3)
        ],
        "head": torch.zeros((16, 4), dtype=torch.float64),
        "meta": {"epoch": 0, "name": ""},
    }


def _bytes(x):
    """An array leaf's dtype name, shape and bytes, tensor or numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (str(x.dtype).removeprefix("torch."), tuple(x.shape),
                x.reshape(-1).view(torch.uint8).numpy().tobytes())
    return str(x.dtype), x.shape, np.ascontiguousarray(x).tobytes()


def _assert_trees_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, (np.ndarray, torch.Tensor)):
            assert _bytes(x) == _bytes(y)
        else:
            assert x == y


def test_shard_assignment_deterministic_and_balanced():
    sizes = [100, 90, 80, 10, 10, 10, 5, 0]
    a1 = ck.shard_assignment(sizes, 3)
    assert a1 == ck.shard_assignment(sizes, 3)
    load = [0, 0, 0]
    for i, w in enumerate(a1):
        load[w] += sizes[i]
    assert max(load) - min(load) <= max(sizes)
    assert set(a1) == {0, 1, 2}


@pytest.mark.parametrize("seed", range(6))
def test_shard_assignment_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    sizes = [int(x) for x in rng.integers(0, 1000, size=rng.integers(
        0, 60))]
    if seed % 2:
        sizes += [sizes[0]] * 5 if sizes else [7] * 5  # ties
    for world in (1, 2, 3, 4, 8, 64):
        assert ck.shard_assignment(sizes, world) == \
            jck.shard_assignment(sizes, world)


def test_sharded_save_restore_reshards_across_world_sizes(tmp_path):
    d = str(tmp_path / "sharded")
    tree_in = _port_big_tree()
    h = ck.save_checkpoint_sharded(d, tree_in, step=2, world=2, block=True)
    assert bool(h) and h.done
    man = ck.load_sharded_manifest(d)
    assert man["world"] == 2 and man["format"] == ck.SHARDED_FORMAT
    sd = os.path.join(d, man["save_dir"])
    assert sorted(f for f in os.listdir(sd) if f.endswith(".msgpack")) \
        == ["shard-00000-of-00002.msgpack", "shard-00001-of-00002.msgpack"]
    out1 = ck.restore_checkpoint_sharded(d, _zeros_like_big())
    _assert_trees_bitwise(out1, tree_in)
    ck.save_checkpoint_sharded(d, tree_in, step=3, world=4, block=True)
    out4 = ck.restore_checkpoint_sharded(d, _zeros_like_big())
    _assert_trees_bitwise(out4, tree_in)


def test_sharded_torn_fleet_keeps_previous_checkpoint(tmp_path,
                                                      monkeypatch):
    d = str(tmp_path / "torn")
    good = _port_big_tree()
    ck.save_checkpoint_sharded(d, good, step=1, world=2, block=True)
    monkeypatch.setenv("HVD_TPU_CKPT_MANIFEST_TIMEOUT", "0.4")
    bad = _port_big_tree()
    for layer in bad["layers"]:
        layer["w"] = layer["w"] * 2
    h = ck.save_checkpoint_sharded(d, bad, step=2, world=2, rank=0,
                                   virtual=False)
    with pytest.raises(ck.CheckpointError, match="never became durable"):
        h.wait(30.0)
    man = ck.load_sharded_manifest(d)
    assert man["step"] == 1
    out = ck.restore_checkpoint_sharded(d, _zeros_like_big())
    _assert_trees_bitwise(out, good)


def test_sharded_two_rank_fleet_commit_order(tmp_path):
    d = str(tmp_path / "fleet2")
    tree_in = _port_big_tree()
    h1 = ck.save_checkpoint_sharded(d, tree_in, step=5, world=2, rank=1,
                                    virtual=False, block=True)
    assert bool(h1)
    assert not os.path.exists(os.path.join(d, "MANIFEST"))
    h0 = ck.save_checkpoint_sharded(d, tree_in, step=5, world=2, rank=0,
                                    virtual=False, block=True)
    assert bool(h0)
    out = ck.restore_checkpoint_sharded(d, _zeros_like_big())
    _assert_trees_bitwise(out, tree_in)
    assert ck.load_sharded_manifest(d)["shard_digests"].keys() == {"0",
                                                                   "1"}


def test_sharded_restore_rejects_corrupt_shard(tmp_path):
    d = str(tmp_path / "corrupt")
    ck.save_checkpoint_sharded(d, _port_big_tree(), step=1, world=2,
                               block=True)
    man = ck.load_sharded_manifest(d)
    victim = os.path.join(d, man["save_dir"],
                          "shard-00001-of-00002.msgpack")
    with open(victim, "r+b") as f:
        f.seek(0)
        f.write(b"\xff\xff\xff\xff")
    with pytest.raises(ck.CheckpointError, match="digest mismatch"):
        ck.restore_checkpoint_sharded(d, _zeros_like_big())


def test_restore_broadcast_skip_decision(monkeypatch):
    calls = {}

    def fake_allgather(obj, name=None):
        calls["digest"], calls["name"] = obj, name
        return calls["fleet"]

    monkeypatch.setattr("horovod_tpu_torch.ops.objects.allgather_object",
                        fake_allgather)
    calls["fleet"] = ["d1", "d1", "d1"]
    assert ck._broadcast_skippable("d1")
    assert calls["name"] == "checkpoint.restore.digest"
    calls["fleet"] = ["d1", "d2", "d1"]
    assert not ck._broadcast_skippable("d1")
    calls["fleet"] = ["d1", None, "d1"]
    assert not ck._broadcast_skippable("d1")
    calls["fleet"] = []
    assert not ck._broadcast_skippable(None)


def test_sharded_untagged_save_requires_step_in_mp(tmp_path):
    with pytest.raises(ValueError, match="requires step="):
        ck.save_checkpoint_sharded(str(tmp_path / "x"), _port_big_tree(),
                                   world=2, rank=0, virtual=False)


def test_sharded_retry_ignores_stale_sidecars_from_torn_attempt(
        tmp_path, monkeypatch):
    d = str(tmp_path / "retry")
    tree_a = _port_big_tree()
    ck.save_checkpoint_sharded(d, tree_a, step=7, world=2, rank=1,
                               virtual=False, block=True)
    assert not os.path.exists(os.path.join(d, "MANIFEST"))
    stale_ok = os.path.join(d, "save-s7", "shard-00001-of-00002.msgpack.ok")
    past = time.time() - 3600
    os.utime(stale_ok, (past, past))
    monkeypatch.setenv("HVD_TPU_CKPT_MANIFEST_TIMEOUT", "0.6")
    tree_b = _port_big_tree()
    tree_b["head"] = tree_b["head"] + 1
    h = ck.save_checkpoint_sharded(d, tree_b, step=7, world=2, rank=0,
                                   virtual=False)
    with pytest.raises(ck.CheckpointError, match="never became durable"):
        h.wait(30.0)
    assert not os.path.exists(os.path.join(d, "MANIFEST"))


def test_sharded_optimizer_and_none_leaves_round_trip(tmp_path):
    """Port-only: the manifest's leaf paths rebuild an optimizer's state
    dict (its None hyperparameters and lazily made state included)."""
    p = torch.nn.Parameter(torch.arange(6.0))
    opt = torch.optim.AdamW([p], lr=0.01, foreach=False)
    p.grad = torch.ones(6)
    opt.step()
    d = str(tmp_path / "opt")
    ck.save_checkpoint_sharded(d, {"p": p, "opt": opt, "none": None},
                               world=3, block=True)
    q = torch.nn.Parameter(torch.zeros(6))
    fresh = torch.optim.AdamW([q], lr=0.5)
    out = ck.restore_checkpoint_sharded(d, {"p": q, "opt": fresh,
                                            "none": None})
    assert out["none"] is None and torch.equal(q, p)
    assert fresh.param_groups[0]["lr"] == 0.01
    assert fresh.param_groups[0]["betas"] == (0.9, 0.999)
    assert torch.equal(fresh.state[q]["exp_avg"], opt.state[p]["exp_avg"])


# ---------------------------------------------------------------------------
# Cross-package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(
        np.asarray, jt.init_transformer(jax.random.PRNGKey(0), JCFG))


def test_reference_checkpoint_restores_in_the_port(hvd, tmp_path,
                                                   jax_params):
    path = str(tmp_path / "ref.msgpack")
    assert jck.save_checkpoint(path, jax_params, step=4, block=True)
    target = tt.init_transformer(torch.Generator().manual_seed(5), TCFG)
    restored = ck.restore_checkpoint(path, target)
    want = params_from_jax(jax_params)
    _assert_trees_bitwise(restored, want)
    assert ck.resume_epoch(path) == 4


def test_port_checkpoint_restores_through_flax(tmp_path, jax_params):
    path = str(tmp_path / "port.msgpack")
    params = params_from_jax(jax_params)
    ck.save_checkpoint(path, params, block=True)
    blob = open(path, "rb").read()
    assert blob == flax_serialization.to_bytes(jax_params)
    zeros = jax.tree_util.tree_map(np.zeros_like, jax_params)
    back = flax_serialization.from_bytes(zeros, blob)
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(jax_params)):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_bf16_checkpoints_cross_both_ways(hvd, tmp_path):
    cfg = jt.TransformerConfig(vocab_size=128, d_model=64, n_heads=4,
                               n_layers=2, d_ff=128, max_seq_len=64,
                               dtype=jnp.bfloat16)
    jp = jax.tree_util.tree_map(
        np.asarray, jt.init_transformer(jax.random.PRNGKey(1), cfg))
    assert any(x.dtype.name == "bfloat16"
               for x in jax.tree_util.tree_leaves(jp))
    path = str(tmp_path / "bf.msgpack")
    jck.save_checkpoint(path, jp, block=True)
    target = params_from_jax(jax.tree_util.tree_map(np.zeros_like, jp))
    _assert_trees_bitwise(ck.restore_checkpoint(path, target),
                          params_from_jax(jp))
    back_path = str(tmp_path / "bf_back.msgpack")
    ck.save_checkpoint(back_path, target, block=True)
    assert open(back_path, "rb").read() == open(path, "rb").read()


def test_reference_sharded_directory_restores_in_the_port(tmp_path):
    d = str(tmp_path / "ref_sharded")
    jck.save_checkpoint_sharded(d, _big_tree(), step=2, world=2, block=True)
    out = ck.restore_checkpoint_sharded(d, _zeros_like_big())
    _assert_trees_bitwise(out, _port_big_tree())
    assert out["meta"] == {"epoch": 9, "name": "m"}


def test_port_sharded_directory_restores_in_the_reference(tmp_path):
    d = str(tmp_path / "port_sharded")
    ck.save_checkpoint_sharded(d, _port_big_tree(), step=3, world=3,
                               block=True)
    zeros = jax.tree_util.tree_map(
        lambda x: np.zeros_like(x) if isinstance(x, np.ndarray) else x,
        _big_tree())
    out = jck.restore_checkpoint_sharded(d, zeros)
    _assert_trees_bitwise(out, _big_tree())
    ref = str(tmp_path / "ref_sharded")
    jck.save_checkpoint_sharded(ref, _big_tree(), step=3, world=3,
                                block=True)
    # The same shard files: the same bytes under the same digests.
    assert ck.load_sharded_manifest(d)["shard_digests"] == \
        jck.load_sharded_manifest(ref)["shard_digests"]


# ---------------------------------------------------------------------------
# Resume at a small width, bitwise against straight runs
# ---------------------------------------------------------------------------

def _lm_data():
    tokens, targets = tt.synthetic_lm_batch(torch.Generator().manual_seed(1),
                                            4, 32, TCFG.vocab_size)
    return tokens, targets


def _weights(seed):
    return tt.init_transformer(torch.Generator().manual_seed(seed), TCFG)


def _adamw(leaves):
    return torch.optim.AdamW(leaves, lr=3e-3, weight_decay=1e-4,
                             foreach=True)


def _resume_case(build, path, monkeypatch, straight=6, first=3):
    """``build(seed) -> (step, tree, leaves)``.  Run A: ``straight``
    steps.  Run B: ``first`` steps, an async save, one more step before
    wait() (the write held until that step is done: a snapshot that
    aliased the live tensors would write its update), then new weights
    from seed 1 restored from the file and the remaining steps.  Returns
    both runs' losses and final weights."""
    gate = _held_write(monkeypatch)
    step, _, leaves = build(0)
    losses_a = [step() for _ in range(straight)]
    weights_a = [x.detach().clone() for x in leaves()]
    step, tree, _ = build(0)
    losses_b = [step() for _ in range(first)]
    h = ck.save_checkpoint(path, tree(), step=first)
    step()  # in place, while the write is in flight
    assert not h.done
    gate.set()
    h.wait(30.0)
    step, tree, leaves = build(1)
    ck.restore_checkpoint(path, tree())
    assert ck.resume_epoch(path) == first
    losses_b += [step() for _ in range(straight - first)]
    return (losses_a, weights_a), (losses_b,
                                   [x.detach() for x in leaves()])


def _assert_resume_bitwise(a, b):
    assert a[0] == b[0], (a[0], b[0])
    assert len(a[1]) == len(b[1])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


def test_resume_make_train_step_adamw_bitwise(port, tmp_path, monkeypatch):
    data = _lm_data()
    loss_fn = tt.make_loss_fn(TCFG)

    def build(seed):
        params = _weights(seed)
        opt = thvd.DistributedOptimizer(_adamw(tree_leaves(params)))
        step = thvd.make_train_step(loss_fn, opt)
        return (lambda: float(step(params, data)),
                lambda: {"params": params, "opt": opt},
                lambda: tree_leaves(params))

    _assert_resume_bitwise(*_resume_case(build, str(tmp_path / "m"),
                                         monkeypatch))


def test_resume_zero_bitwise(port, tmp_path, monkeypatch):
    from horovod_tpu_torch.parallel.zero import make_zero_train_step

    data = _lm_data()
    zstep = make_zero_train_step(tt.make_loss_fn(TCFG), _adamw)

    def build(seed):
        params = _weights(seed)
        held = {"opt": zstep.init(params)}

        def step():
            _, held["opt"], loss = zstep.step(params, held["opt"], data)
            return float(loss)

        return (step, lambda: {"params": params, "opt": held["opt"]},
                lambda: tree_leaves(params))

    _assert_resume_bitwise(*_resume_case(build, str(tmp_path / "z"),
                                         monkeypatch))


def test_resume_fsdp_bitwise(port, tmp_path, monkeypatch):
    """FSDP saves full_params(p_shard) and restores through
    shard_params."""
    from horovod_tpu_torch.parallel.fsdp import make_fsdp_train_step

    data = _lm_data()
    fstep = make_fsdp_train_step(tt.make_loss_fn(TCFG), _adamw)

    def build(seed):
        params = _weights(seed)
        p_shard, opt = fstep.init(params)
        held = {"p": p_shard, "opt": opt, "full": params}

        def step():
            if held["full"] is not None:  # restored into the full tree
                held["p"] = fstep.shard_params(held["full"])
                held["full"] = None
            held["p"], held["opt"], loss = fstep.step(held["p"],
                                                      held["opt"], data)
            return float(loss)

        def tree():
            if held["full"] is None:
                held["full"] = fstep.full_params(held["p"])
            return {"params": held["full"], "opt": held["opt"]}

        return (step, tree,
                lambda: tree_leaves(fstep.full_params(held["p"])))

    _assert_resume_bitwise(*_resume_case(build, str(tmp_path / "f"),
                                         monkeypatch))


def test_resume_pipeline_per_stage_optimizers_bitwise(port, tmp_path,
                                                     monkeypatch):
    from horovod_tpu_torch.parallel import pipeline as PL

    data = _lm_data()
    chain = tt.chained_lm_loss(TCFG)
    pstep = PL.make_pipeline_train_step(chain, _adamw, num_microbatches=2,
                                        schedule="1f1b")

    def build(seed):
        stages = tt.chained_lm_params(_weights(seed), TCFG)
        held = {"opt": pstep.init(stages)}
        assert isinstance(held["opt"], list) and len(held["opt"]) == 4

        def step():
            _, held["opt"], loss = pstep(stages, held["opt"], data)
            return float(loss)

        return (step, lambda: {"params": stages, "opt": held["opt"]},
                lambda: [x for st in stages for x in tree_leaves(st)])

    _assert_resume_bitwise(*_resume_case(build, str(tmp_path / "p"),
                                         monkeypatch, straight=4, first=2))


def test_resnet_example_resumes(port, tmp_path):
    """The example's resume (ResNet18Thin at 32 px): the restored
    parameters and BN statistics are bitwise the saved ones, the run
    resumes at epoch 1, its loss is finite, and it saves step=2."""
    from horovod_tpu_torch.examples import resnet50_synthetic as ex

    path = str(tmp_path / "resnet.msgpack")
    first = ex.fit(epochs=1, device="cpu", ckpt=path, prefetch=0)
    assert first["start_epoch"] == 0 and first["checkpoint"]
    first["checkpoint"].wait(30.0)
    trainer = first["trainer"]
    saved = [x.detach().clone() for x in tree_leaves(
        {"p": trainer.params, "s": trainer.model_state})]

    class Record:
        def __init__(self):
            self.epochs, self.begin = [], None

        def set_trainer(self, t):
            self.trainer = t

        def on_train_begin(self, logs=None):
            self.begin = [x.detach().clone() for x in tree_leaves(
                {"p": self.trainer.params, "s": self.trainer.model_state})]

        def on_epoch_begin(self, epoch, logs=None):
            self.epochs.append(epoch)

    rec = Record()
    second = ex.fit(epochs=2, device="cpu", ckpt=path, prefetch=0,
                    extra_callbacks=[rec])
    second["checkpoint"].wait(30.0)
    assert second["start_epoch"] == 1 and rec.epochs == [1]
    assert len(rec.begin) == len(saved)
    assert all(torch.equal(a, b) for a, b in zip(rec.begin, saved))
    assert len(second["history"]) == 1
    assert np.isfinite(second["history"][0]["loss"])
    assert ck.resume_epoch(path) == 2
    # A run that starts at its --epochs trains and saves nothing.
    third = ex.fit(epochs=2, device="cpu", ckpt=path, prefetch=0)
    assert third["start_epoch"] == 2 and third["history"] == []
    assert third["checkpoint"] is None and ck.resume_epoch(path) == 2


# ---------------------------------------------------------------------------
# Two gloo ranks
# ---------------------------------------------------------------------------

WORKER = """
import os
import time
from horovod_tpu_torch.utils import checkpoint as ck

tmp = os.path.dirname(OUT)
out = {}

# tests/mp_worker.py scenario_checkpoint: rank 0 saves, rank 1 starts from
# divergent values; the restore converges every rank on rank 0's.
path = os.path.join(tmp, "ckpt.msgpack")
good = {"w": np.full((3,), 7.0, "float32")}
if RANK == 0:
    assert ck.save_checkpoint(path, good, step=5)
else:
    assert not ck.save_checkpoint(path, {"w": np.zeros((3,))}, step=5)
while not os.path.exists(path + ".step"):
    time.sleep(0.05)
mine = {"w": torch.full((3,), float(RANK + 1))}
skipped = ck.stats()["checkpoint.broadcast_skipped"]
restored = ck.restore_checkpoint(path, mine)
out["scenario.w"] = restored["w"].numpy()
out["scenario.epoch"] = ck.resume_epoch(path)
out["shared.skipped"] = ck.stats()["checkpoint.broadcast_skipped"] - skipped

# A file only rank 0 has: rank 1 names a path it cannot read, so the
# digests differ and rank 0's values arrive by broadcast, an optimizer's
# state, a numpy leaf and scalars included.
p = torch.nn.Parameter(torch.arange(4.0) * (RANK + 1))
opt = torch.optim.Adam([p], lr=0.1 * (RANK + 1))
if RANK == 0:
    p.grad = torch.ones(4)
    opt.step()
tree = {"p": p, "opt": opt, "np": np.full((2,), float(RANK), "float64"),
        "meta": {"epoch": 3 * (1 - RANK), "name": "r0" if RANK == 0 else ""}}
own = os.path.join(tmp, "own.msgpack")
if RANK == 0:
    ck.save_checkpoint(own, tree, step=3, block=True)
dist.barrier()
skipped = ck.stats()["checkpoint.broadcast_skipped"]
mine_path = own if RANK == 0 else os.path.join(tmp, "absent.msgpack")
got = ck.restore_checkpoint(mine_path, tree)
out["own.skipped"] = ck.stats()["checkpoint.broadcast_skipped"] - skipped
out["own.p"] = p.detach().numpy()
out["own.exp_avg"] = opt.state[p]["exp_avg"].numpy()
out["own.lr"] = opt.param_groups[0]["lr"]
out["own.np"] = got["np"]
out["own.epoch"] = got["meta"]["epoch"]
out["own.name_ok"] = got["meta"]["name"] == "r0"
out["own.resume"] = ck.resume_epoch(mine_path)

# A strict 2-rank sharded save with step=: each rank writes its shard,
# rank 0 commits the manifest; the parent restores it at a world of 1.
sharded = {"a": torch.arange(40.0).reshape(8, 5),
           "b": torch.arange(7, dtype=torch.int64),
           "c": torch.ones(3, dtype=torch.bfloat16), "epoch": 11}
h = ck.save_checkpoint_sharded(os.path.join(tmp, "sharded"), sharded,
                               step=2)
h.wait(60.0)
dist.barrier()
finish(out)
"""


def test_two_gloo_ranks_restore_broadcast_and_shard(tmp_path):
    job = GlooJob(tmp_path, WORKER, 2, {"unused": np.zeros(1)})
    results = job.results()
    for r, out in enumerate(results):
        np.testing.assert_array_equal(out["scenario.w"], np.full(3, 7.0))
        assert int(out["scenario.epoch"]) == 5
        assert int(out["shared.skipped"]) == 1  # both read the file
        assert int(out["own.skipped"]) == 0     # rank 1 has none
        np.testing.assert_array_equal(out["own.p"], results[0]["own.p"])
        np.testing.assert_array_equal(out["own.exp_avg"],
                                      results[0]["own.exp_avg"])
        assert float(out["own.lr"]) == pytest.approx(0.1)
        np.testing.assert_array_equal(out["own.np"], np.zeros(2))
        assert int(out["own.epoch"]) == 3 and bool(out["own.name_ok"])
        assert int(out["own.resume"]) == 3
    assert results[0]["own.exp_avg"].any()
    d = str(tmp_path / "sharded")
    man = ck.load_sharded_manifest(d)
    assert man["world"] == 2 and man["step"] == 2
    assert sorted(man["shard_digests"]) == ["0", "1"]
    target = {"a": torch.zeros(8, 5), "b": torch.zeros(7, dtype=torch.int64),
              "c": torch.zeros(3, dtype=torch.bfloat16), "epoch": 0}
    out = ck.restore_checkpoint_sharded(d, target)
    assert torch.equal(out["a"], torch.arange(40.0).reshape(8, 5))
    assert torch.equal(out["b"], torch.arange(7))
    assert torch.equal(out["c"], torch.ones(3, dtype=torch.bfloat16))
    assert out["epoch"] == 11


# The placed pipeline of the two-rank resume test: two stages over a
# seeded 4-wide batch, defined once for its workers and for the one-rank
# restore in the test process.
PLACED_CASE = """
from horovod_tpu_torch.parallel.overlap import ChainedLoss

PLACED_BATCH = tuple(torch.randn(8, 4, generator=torch.Generator()
                                 .manual_seed(7 + i)) for i in range(2))


def placed_chain():
    return ChainedLoss([
        lambda p, c, b: torch.tanh(b[0] @ p["w"] + p["b"]),
        lambda p, c, b: ((c @ p["w"] + p["b"] - b[1]) ** 2).mean()])


def placed_weights(seed):
    g = torch.Generator().manual_seed(seed)
    return [{"b": (0.1 * torch.randn(4, generator=g)).requires_grad_(),
             "w": torch.randn(4, 4, generator=g).requires_grad_()}
            for _ in range(2)]


def adamw(leaves):
    return torch.optim.AdamW(leaves, lr=3e-3, weight_decay=1e-4,
                             foreach=True)
"""


SHARDED_WORKER = """
import os
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.parallel import pipeline as PL
from horovod_tpu_torch.parallel.fsdp import make_fsdp_train_step
from horovod_tpu_torch.parallel.zero import make_zero_train_step
from horovod_tpu_torch.utils import checkpoint as ck
from horovod_tpu_torch.utils.tree import tree_leaves

tmp = os.path.dirname(OUT)
cfg = tt.TransformerConfig(**CFG)
tokens, targets = tt.synthetic_lm_batch(torch.Generator().manual_seed(1),
                                        4, 32, cfg.vocab_size)
data = (rows(tokens), rows(targets))
loss_fn = tt.make_loss_fn(cfg)
out = {}


def weights(seed):
    return tt.init_transformer(torch.Generator().manual_seed(seed), cfg)


zstep = make_zero_train_step(loss_fn, adamw)
fstep = make_fsdp_train_step(loss_fn, adamw)


def zero(seed):
    params = weights(seed)
    held = {"opt": zstep.init(params)}

    def step():
        _, held["opt"], loss = zstep.step(params, held["opt"], data)
        return float(loss)

    return (step, lambda: {"params": params, "opt": held["opt"]},
            lambda: tree_leaves(params), held)


def fsdp(seed):
    params = weights(seed)
    p_shard, opt = fstep.init(params)
    held = {"p": p_shard, "opt": opt, "full": params}

    def step():
        if held["full"] is not None:  # restored into the full tree
            held["p"] = fstep.shard_params(held["full"])
            held["full"] = None
        held["p"], held["opt"], loss = fstep.step(held["p"], held["opt"],
                                                  data)
        return float(loss)

    def tree():  # full_params is a collective: every rank builds it
        if held["full"] is None:
            held["full"] = fstep.full_params(held["p"])
        return {"params": held["full"], "opt": held["opt"]}

    return (step, tree, lambda: tree_leaves(fstep.full_params(held["p"])),
            held)


def moment(held):
    opt = held["opt"].optimizer
    return opt.state[held["opt"].shard]["exp_avg"].detach().clone()


for kind, build in (("zero", zero), ("fsdp", fsdp)):
    step, _, leaves, held = build(0)
    straight = [step() for _ in range(4)]
    want = [x.detach().clone() for x in leaves()]
    want_moment = moment(held)
    for mode in ("shared", "rank0"):
        path = os.path.join(tmp, f"{kind}.{mode}.msgpack")
        step, tree, leaves, held = build(0)
        losses = [step() for _ in range(2)]
        # Every rank saves: the shard states are gathered whole.
        h = ck.save_checkpoint(path, tree(), step=2)
        assert bool(h) == (RANK == 0)
        h.wait(60.0)
        dist.barrier()
        step, tree, leaves, held = build(1)
        # "rank0": rank 1 names a file it lacks, so rank 0's read
        # arrives by broadcast; "shared": each rank reads the file.
        mine = path if mode == "shared" or RANK == 0 else path + ".absent"
        skipped = ck.stats()["checkpoint.broadcast_skipped"]
        ck.restore_checkpoint(mine, tree())
        out[f"{kind}.{mode}.skipped"] = \
            ck.stats()["checkpoint.broadcast_skipped"] - skipped
        out[f"{kind}.{mode}.epoch"] = ck.resume_epoch(mine)
        losses += [step() for _ in range(2)]
        got = [x.detach() for x in leaves()]
        out[f"{kind}.{mode}.losses"] = losses == straight
        out[f"{kind}.{mode}.weights"] = len(got) == len(want) and all(
            torch.equal(a, b) for a, b in zip(got, want))
        out[f"{kind}.{mode}.moment"] = torch.equal(moment(held), want_moment)
    out[f"{kind}.moment"] = want_moment.numpy()

# A placed pipeline: each rank holds one of the two stages.  Every rank
# saves (each stage's state comes from its owner), and a restore gives
# every rank all the parameters and each optimizer its own stage's state.
pstep = PL.make_pipeline_train_step(placed_chain(), adamw,
                                    num_microbatches=2,
                                    stage_meshes=PL.stage_submeshes(2))


def placed(seed):
    stages = placed_weights(seed)
    opts = pstep.init(stages)

    def step():
        _, _, loss = pstep(stages, opts, PLACED_BATCH)
        return float(loss)

    def held():
        (k,) = pstep._mine
        leaves = tree_leaves(stages[k])
        return ([x.detach().clone() for x in leaves],
                [opts[k].state[x]["exp_avg"].clone() for x in leaves]
                + [opts[k].state[x]["exp_avg_sq"].clone() for x in leaves])

    return step, {"params": stages, "opt": opts}, held


step, _, held = placed(0)
straight = [step() for _ in range(4)]
want, want_moments = held()
out["placed.straight"] = np.array(straight)
for mode in ("shared", "rank0"):
    path = os.path.join(tmp, f"placed.{mode}.msgpack")
    step, tree, held = placed(0)
    losses = [step() for _ in range(2)]
    h = ck.save_checkpoint(path, tree, step=2)
    assert bool(h) == (RANK == 0)
    h.wait(60.0)
    dist.barrier()
    step, tree, held = placed(1)
    mine = path if mode == "shared" or RANK == 0 else path + ".absent"
    skipped = ck.stats()["checkpoint.broadcast_skipped"]
    restored = ck.restore_checkpoint(mine, tree)
    out[f"placed.{mode}.skipped"] = \
        ck.stats()["checkpoint.broadcast_skipped"] - skipped
    # Every rank takes all the parameters, its stage's and the other's.
    for i, x in enumerate(tree_leaves(restored["params"])):
        out[f"placed.{mode}.restored.{i}"] = x.detach().numpy().copy()
    out[f"placed.{mode}.none"] = [o is None for o in restored["opt"]]
    losses += [step() for _ in range(2)]
    got, got_moments = held()
    out[f"placed.{mode}.losses"] = losses == straight
    out[f"placed.{mode}.weights"] = all(
        torch.equal(a, b) for a, b in zip(got, want))
    out[f"placed.{mode}.moments"] = all(
        torch.equal(a, b) for a, b in zip(got_moments, want_moments))
dist.barrier()
finish(out)
"""


def test_two_gloo_ranks_zero_and_fsdp_resume_bitwise(tmp_path):
    """ZeRO's and FSDP's shard states at two ranks: every rank saves
    (the moments are gathered whole), each restores its own slice, by
    the shared file or by rank 0's broadcast, and 2 + 2 steps are
    bitwise 4 straight ones.  So does a placed pipeline's AdamW step, one
    stage a rank: each stage's state comes from the rank that holds it,
    every rank takes all the parameters, a ``None`` slot stays ``None``,
    and the file restores into a one-rank unplaced step, whose next two
    losses are the placed run's within the placed-against-unplaced
    tolerance of tests/test_torch_pipeline.py (loss rtol 1e-6)."""
    cfg = {f: getattr(TCFG, f) for f in ("vocab_size", "d_model",
                                         "n_heads", "n_layers", "d_ff",
                                         "max_seq_len")}
    job = GlooJob(tmp_path, f"CFG = {cfg!r}\n" + PLACED_CASE
                  + SHARDED_WORKER, 2, {"unused": np.zeros(1)})
    results = job.results()
    for out in results:
        for kind in ("zero", "fsdp"):
            for mode, skipped in (("shared", 1), ("rank0", 0)):
                tag = f"{kind}.{mode}"
                assert bool(out[f"{tag}.losses"]), tag
                assert bool(out[f"{tag}.weights"]), tag
                assert bool(out[f"{tag}.moment"]), tag
                assert int(out[f"{tag}.skipped"]) == skipped, tag
                assert int(out[f"{tag}.epoch"]) == 2, tag
        for mode, skipped in (("shared", 1), ("rank0", 0)):
            tag = f"placed.{mode}"
            assert bool(out[f"{tag}.losses"]), tag
            assert bool(out[f"{tag}.weights"]), tag
            assert bool(out[f"{tag}.moments"]), tag
            assert int(out[f"{tag}.skipped"]) == skipped, tag
            assert list(out[f"{tag}.none"]).count(True) == 1, tag
            # Both ranks restored every stage's parameters alike.
            assert all(np.array_equal(out[f"{tag}.restored.{i}"],
                                      results[0][f"{tag}.restored.{i}"])
                       for i in range(4)), tag
    for kind in ("zero", "fsdp"):
        # Each rank holds its own half of the moments.
        a, b = (out[f"{kind}.moment"] for out in results)
        assert a.shape == b.shape and not np.array_equal(a, b), kind
    straight = results[0]["placed.straight"]
    np.testing.assert_array_equal(results[1]["placed.straight"], straight)
    # The placed file is a one-rank unplaced step's: restore it there.
    from horovod_tpu_torch.parallel import pipeline as PL

    case = {"torch": torch}
    exec(PLACED_CASE, case)
    thvd.init(device="cpu")
    try:
        pstep = PL.make_pipeline_train_step(case["placed_chain"](),
                                            case["adamw"],
                                            num_microbatches=2)
        for mode in ("shared", "rank0"):
            stages = case["placed_weights"](1)
            opts = pstep.init(stages)
            assert not any(o is None for o in opts)
            ck.restore_checkpoint(str(tmp_path / f"placed.{mode}.msgpack"),
                                  {"params": stages, "opt": opts})
            for i, x in enumerate(tree_leaves(stages)):
                assert np.array_equal(
                    x.detach().numpy(),
                    results[0][f"placed.{mode}.restored.{i}"]), (mode, i)
            losses = []
            for _ in range(2):
                _, opts, loss = pstep(stages, opts, case["PLACED_BATCH"])
                losses.append(float(loss))
            np.testing.assert_allclose(losses, straight[2:], rtol=1e-6)
    finally:
        thvd.shutdown()


def test_shard_state_full_state_takes_its_slice():
    """load_full_state_dict takes rank i's slice of a whole state and
    refuses one of another world's length."""
    from horovod_tpu_torch.core.topology import MeshAxis
    from horovod_tpu_torch.parallel.zero import ShardState

    whole = torch.zeros(6, requires_grad=True)
    full = ShardState(whole, torch.optim.AdamW([whole], lr=0.1))
    whole.grad = torch.arange(6.0)
    full.optimizer.step()
    saved = full.full_state_dict()  # one rank: its own state
    for index in range(2):
        shard = torch.zeros(3, requires_grad=True)
        state = ShardState(shard, torch.optim.AdamW([shard], lr=0.5),
                           MeshAxis(name="hvd", size=2, index=index,
                                    ranks=(0, 1)))
        state.load_full_state_dict(saved)
        got = state.optimizer.state[shard]
        assert torch.equal(got["exp_avg"], full.optimizer.state[whole][
            "exp_avg"][3 * index:3 * index + 3])
        assert float(got["step"]) == 1.0
        assert state.optimizer.param_groups[0]["lr"] == 0.1
    small = torch.zeros(2, requires_grad=True)
    odd = ShardState(small, torch.optim.AdamW([small], lr=0.1),
                     MeshAxis(name="hvd", size=2, index=0, ranks=(0, 1)))
    with pytest.raises(ValueError, match="6 elements.*2 x 2 = 4"):
        odd.load_full_state_dict(saved)


def test_chip_smoke_runs_a_checkpoint_phase_after_the_pipeline():
    import chip_smoke

    phases = chip_smoke.PHASES
    assert phases.index("checkpoint") == phases.index("pipeline") + 1
    assert "checkpoint - checkpoint and resume" in chip_smoke.__doc__
    assert chip_smoke.CKPT_SAVE_AT < chip_smoke.CKPT_STEPS
    assert chip_smoke.CKPT_TURNS.count("none") == \
        chip_smoke.CKPT_TURNS.count("write") >= 5
