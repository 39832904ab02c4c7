"""horovod_tpu_torch's bucketed-backward overlapped step
(parallel/overlap.py), after the reference's tests/test_overlap.py.

* Bitwise identity: the streaming schedule's losses and parameters equal
  the monolithic ``overlap="off"`` step's, bitwise, per leaf dtype and
  for a tree mixing them; the segmented schedule equals ``serial`` and
  the monolithic step bitwise; on 1 rank here and on 2 gloo ranks
  (``test_two_gloo_ranks_overlap_is_bitwise_the_monolithic_step``, which
  also runs tests/test_torch_overlap_state.py's stateful and has_aux
  steps: on == serial == off bitwise, the statistics and the aux the
  mean of the ranks' own).
* Steady state: one fused response a bucket, replayed from the response
  cache with no new negotiation.
* int8: the error-feedback residual of each bucket carries from step to
  step, ``on`` bitwise ``serial``.
* A fusion-threshold change re-cuts the buckets.
* The compression policy sees a bucket's wire name: a rule on the
  parameters' names does not reach the overlapped buckets.
* The named fallbacks (adasum, sparse, grad-tree, nonstatic-compression)
  count once and give the monolithic result.
* The knob: validation, ``auto``, the env fingerprint.
* The port's ``chained_lm_loss`` against the reference's.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.ops import compression as compression_mod
from horovod_tpu_torch.ops import megakernel as MK
from horovod_tpu_torch.parallel import overlap as OV
from horovod_tpu_torch.parallel.training import make_train_step
from horovod_tpu_torch.utils.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DIM = 64
_THRESHOLD = _DIM * _DIM * 4  # one f32 [64, 64] weight fills a bucket


def _plain_loss(params, batch):
    x, y = batch
    h = torch.tanh(x.to(params["w1"].dtype) @ params["w1"] + params["b1"])
    pred = h @ params["w2"] + params["b2"]
    return ((pred.float() - y) ** 2).mean()


def _plain_params(seed=0, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    s = 1.0 / np.sqrt(_DIM)

    def t(a):
        return torch.tensor(a, dtype=torch.float32).to(dtype)

    return {"w1": t(rng.randn(_DIM, _DIM) * s), "b1": t(np.zeros(_DIM)),
            "w2": t(rng.randn(_DIM, _DIM) * s), "b2": t(np.zeros(_DIM))}


def _chain():
    def stage0(p, carry, batch):
        x, _y = batch
        return torch.tanh(x @ p["w"] + p["b"])

    def stage1(p, carry, batch):
        return torch.tanh(carry @ p["w"] + p["b"])

    def stage2(p, carry, batch):
        _x, y = batch
        pred = carry @ p["w"] + p["b"]
        return ((pred - y) ** 2).mean()

    return OV.ChainedLoss([stage0, stage1, stage2])


def _chain_params(seed=0):
    rng = np.random.RandomState(seed)
    s = 1.0 / np.sqrt(_DIM)
    return [{"w": torch.tensor(rng.randn(_DIM, _DIM) * s,
                               dtype=torch.float32),
             "b": torch.zeros(_DIM)} for _ in range(3)]


def _batch(seed=1, per=4):
    rng = np.random.RandomState(seed)
    n = hvd.size()
    x = torch.tensor(rng.randn(per * n, _DIM), dtype=torch.float32)
    y = torch.tensor(rng.randn(per * n, _DIM), dtype=torch.float32)
    mine = slice(hvd.rank() * per, (hvd.rank() + 1) * per)
    return x[mine], y[mine]


def _fresh(params):
    return [{k: v.clone().requires_grad_() for k, v in p.items()}
            for p in params] if isinstance(params, list) else \
        {k: v.clone().requires_grad_() for k, v in params.items()}


def _run(params, steps, opt="adam", **kw):
    """``steps`` steps of a new step over a copy of ``params``: (losses,
    parameters, the step)."""
    p = _fresh(params)
    leaves = tree_leaves(p)
    inner = (torch.optim.Adam(leaves, lr=1e-3) if opt == "adam"
             else torch.optim.SGD(leaves, lr=0.1))
    loss_fn = kw.pop("loss_fn", _plain_loss)
    step = make_train_step(loss_fn, inner, **kw)
    batch = _batch()
    losses = [float(step(p, batch)) for _ in range(steps)]
    return losses, [x.detach().clone() for x in tree_leaves(p)], step


def _equal(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture
def one_rank():
    hvd.init(device="cpu")
    yield
    hvd.set_compression()
    hvd.shutdown()


# ---------------------------------------------------------------------------
# Bitwise identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_bitwise_identical_to_monolithic(one_rank, dtype):
    params = _plain_params(0, dtype)
    l_on, p_on, step = _run(params, 3, fusion_threshold=_THRESHOLD,
                            overlap="on")
    l_off, p_off, _ = _run(params, 3, fusion_threshold=_THRESHOLD,
                           overlap="off")
    # f32: b1 b2 | w1 | w2; bf16 halves the bytes: b1 b2 w1 | w2.
    assert step.overlap_active
    assert step.bucket_count == (3 if dtype == torch.float32 else 2)
    assert l_on == l_off
    assert _equal(p_on, p_off)


def test_stream_bitwise_identical_mixed_dtypes(one_rank):
    params = _plain_params(0)
    params["b1"] = params["b1"].to(torch.bfloat16)
    params["b2"] = params["b2"].to(torch.bfloat16)
    _, p_on, step = _run(params, 2, opt="sgd", fusion_threshold=_THRESHOLD,
                         overlap="on")
    _, p_off, _ = _run(params, 2, opt="sgd", fusion_threshold=_THRESHOLD,
                       overlap="off")
    assert step.bucket_count == 3  # the bf16 biases bucket apart
    assert _equal(p_on, p_off)


def test_segmented_stream_equals_serialized_bitwise(one_rank):
    """ChainedLoss: the streamed dispatch, the serialized dispatch of the
    same buckets and the monolithic step, bitwise (the reference holds
    its monolithic step to 1e-5 here; eager torch runs the same kernels
    stage by stage)."""
    kw = dict(loss_fn=_chain(), fusion_threshold=_THRESHOLD)
    l_on, p_on, step_on = _run(_chain_params(), 3, overlap="on", **kw)
    l_ser, p_ser, step_ser = _run(_chain_params(), 3, overlap="serial",
                                  **kw)
    l_off, p_off, _ = _run(_chain_params(), 3, overlap="off", **kw)
    assert step_on.overlap_active and step_on.schedule == "stream"
    assert step_ser.schedule == "serial"
    assert step_on.segment_count == 3
    assert step_on.bucket_count == 6  # (w, b) buckets per stage
    assert l_on == l_ser == l_off
    assert _equal(p_on, p_ser) and _equal(p_on, p_off)


def test_overlap_off_restores_static_step(one_rank, monkeypatch):
    inner = torch.optim.SGD(tree_leaves(_fresh(_plain_params())), lr=0.1)
    assert not hasattr(make_train_step(_plain_loss, inner, overlap="off"),
                       "overlap_active")
    monkeypatch.delenv(OV.OVERLAP_ENV, raising=False)
    # auto -> off on the CPU
    assert not hasattr(make_train_step(_plain_loss, inner),
                       "overlap_active")
    monkeypatch.setenv(OV.OVERLAP_ENV, "serial")
    assert make_train_step(_plain_loss, inner).schedule == "serial"


def test_hook_optimizer_keeps_its_own_overlap(one_rank):
    from horovod_tpu_torch.frontends import torch as fhvd

    p = _fresh(_plain_params())
    opt = fhvd.DistributedOptimizer(torch.optim.SGD(tree_leaves(p),
                                                    lr=0.1))
    assert not hasattr(make_train_step(_plain_loss, opt), "overlap_active")
    with pytest.raises(ValueError, match="hook-driven optimizer"):
        make_train_step(_plain_loss, opt, overlap="on")


# ---------------------------------------------------------------------------
# Steady state: one fused response a bucket, response-cache replay
# ---------------------------------------------------------------------------

def test_exactly_one_launch_per_bucket_and_cache_replay(one_rank):
    p = _fresh(_chain_params())
    step = make_train_step(_chain(), torch.optim.SGD(tree_leaves(p),
                                                     lr=0.1),
                           fusion_threshold=_THRESHOLD, overlap="on")
    batch = _batch()
    for _ in range(2):  # negotiation, then the first replayed step
        step(p, batch)
    n_buckets, n_leaves = step.bucket_count, len(tree_leaves(p))
    C.reset_stats()
    MK.reset_stats()
    step(p, batch)
    st = C.stats()
    # One fused response and one reduction a bucket, plus the loss.
    assert st["responses"] == n_buckets + 1
    assert MK.stats.launches == n_buckets + 1
    assert st["tensors"] == n_leaves + 1
    # Every request a cache hit: no negotiation in the steady state.
    assert st["cache_hits"] == n_leaves + 1 and st["cache_misses"] == 0


def test_telemetry_counters_and_timeline_instants(one_rank, tmp_path):
    p = _fresh(_chain_params())
    step = make_train_step(_chain(), torch.optim.SGD(tree_leaves(p),
                                                     lr=0.1),
                           fusion_threshold=_THRESHOLD, overlap="on")
    path = tmp_path / "overlap_timeline.json"
    hvd.start_timeline(str(path))
    try:
        for _ in range(2):
            step(p, _batch())
    finally:
        hvd.stop_timeline()
    stats = step.stats()
    assert stats["overlap.buckets_dispatched"] == 2 * step.bucket_count
    assert stats["overlap.fallbacks"] == 0
    assert stats["overlap.exposed_comm_seconds"]["count"] == 2
    assert stats["overlap.exposed_comm_seconds"]["sum"] >= 0.0
    events = json.loads(path.read_text())
    instants = [e for e in events if e.get("name") == "BUCKET_DISPATCH"]
    assert len(instants) == stats["overlap.buckets_dispatched"]
    assert {e["args"]["bucket"] for e in instants} == \
        set(range(step.bucket_count))


# ---------------------------------------------------------------------------
# Quantized wire: per-bucket error-feedback residuals
# ---------------------------------------------------------------------------

def test_int8_ef_residuals_carry_over_per_bucket(one_rank):
    kw = dict(loss_fn=_chain(), fusion_threshold=_THRESHOLD, opt="adam")
    _, p_fp, _ = _run(_chain_params(), 3, overlap="on", **kw)
    hvd.set_compression(default="int8")
    MK.flush("test")
    _, p_on, step_on = _run(_chain_params(), 3, overlap="on", **kw)
    # One residual a bucket, kept for the next step (and the loss's).
    assert MK.residual_count() >= step_on.bucket_count
    MK.flush("test")
    _, p_ser, _ = _run(_chain_params(), 3, overlap="serial", **kw)
    hvd.set_compression()
    assert _equal(p_on, p_ser)
    assert not _equal(p_on, p_fp)  # the wire really quantized


def test_policy_rules_see_bucket_wire_names(one_rank, monkeypatch):
    """The policy looks a format up by the bucket's wire name
    (``overlap.p<step>.g<bucket>.<i>``), as the reference's overlapped
    step does: a rule written for the parameters' names (here the
    biases) quantizes nothing less, and a rule on a bucket's wire name
    applies to that bucket whole."""
    launched = []
    launch = MK.launch

    def record(spec, v, comm, names):
        launched.append((tuple(names), spec.shapes,
                         None if spec.quant is None else spec.quant.name))
        return launch(spec, v, comm, names)

    monkeypatch.setattr(MK, "launch", record)

    def formats(rules):
        launched.clear()
        hvd.set_compression(default="int8", rules=rules)
        MK.flush("test")
        _, _, step = _run(_plain_params(), 1, opt="sgd", overlap="on",
                          fusion_threshold=_THRESHOLD)
        hvd.set_compression()
        return {shapes: fmt for names, shapes, fmt in launched
                if names[0].startswith("overlap.")}, step

    # f32 buckets: b1 b2 | w1 | w2, every one quantized although a rule
    # names the biases.
    by_name, step = formats([(r"^b\d$", "none")])
    assert step.overlap_active and step.bucket_count == 3
    assert by_name == {((_DIM,), (_DIM,)): "int8",
                       ((_DIM, _DIM),): "int8"}
    # A rule on the first bucket's wire name leaves that bucket whole in
    # full precision.
    prefix = f"overlap.p{OV._prefix_counter + 1}"
    by_wire, _ = formats([(rf"^{prefix}\.g0\.", "none")])
    assert by_wire == {((_DIM,), (_DIM,)): None, ((_DIM, _DIM),): "int8"}


# ---------------------------------------------------------------------------
# Fusion-threshold change
# ---------------------------------------------------------------------------

def test_fusion_threshold_change_replans_buckets(one_rank):
    """set_fusion_threshold between steps re-cuts the buckets on the next
    call; the result stays bitwise the monolithic step's through the same
    two thresholds."""
    batch = _batch()
    results = []
    for mode in ("on", "off"):
        p = _fresh(_plain_params())
        C.set_fusion_threshold(_THRESHOLD)
        step = make_train_step(_plain_loss, torch.optim.SGD(
            tree_leaves(p), lr=0.1), overlap=mode)
        step(p, batch)
        coarse = getattr(step, "bucket_count", None)
        # Below one bias leaf (256 B): every leaf its own bucket.
        C.set_fusion_threshold(128)
        step(p, batch)
        if mode == "on":
            assert step.bucket_count > coarse, (coarse, step.bucket_count)
            assert step.bucket_count == 4
        results.append([x.detach().clone() for x in tree_leaves(p)])
    C.set_fusion_threshold(64 * 1024 * 1024)
    assert _equal(*results)


# ---------------------------------------------------------------------------
# Fallbacks: once, named, and the monolithic result
# ---------------------------------------------------------------------------

def _assert_fell_back_once(step, reason):
    assert step.overlap_active is False
    assert step._fallback_reason == reason
    assert step.stats()["overlap.fallbacks"] == 1


def _embed_loss(params, batch):
    x, y = batch
    idx = (x[:, 0].abs() * 10).long() % _DIM
    e = F.embedding(idx, params["w1"], sparse=True)
    return ((e @ params["w2"] + params["b2"] - y) ** 2).mean() \
        + params["b1"].sum() * 0


def test_sparse_gradient_leaves_fall_back(one_rank, capsys):
    _, p_on, step = _run(_plain_params(), 2, opt="sgd", loss_fn=_embed_loss,
                         overlap="on")
    _, p_off, _ = _run(_plain_params(), 2, opt="sgd", loss_fn=_embed_loss,
                       overlap="off")
    _assert_fell_back_once(step, "sparse")
    assert _equal(p_on, p_off)
    assert capsys.readouterr().err.count("[hvd-overlap] falling back") == 1


def test_adasum_fallback_counts_once(one_rank):
    l_on, p_on, step = _run(_plain_params(), 2, opt="sgd", op=hvd.Adasum,
                            overlap="on")
    _, p_off, _ = _run(_plain_params(), 2, opt="sgd", op=hvd.Adasum,
                       overlap="off")
    assert np.isfinite(l_on).all()
    _assert_fell_back_once(step, "adasum")
    assert _equal(p_on, p_off)


def test_grad_tree_and_nonstatic_compression_fall_back(one_rank):
    p = _fresh(_plain_params())
    reordered = torch.optim.SGD(tree_leaves(p)[::-1], lr=0.1)
    step = make_train_step(_plain_loss, reordered, overlap="on")
    step(p, _batch())
    _assert_fell_back_once(step, "grad-tree")

    class ScaleCompressor:
        @staticmethod
        def compress(t):
            s = t.abs().max().clamp_min(1e-12)
            return t / s, s

        @staticmethod
        def decompress(t, s):
            return t * s

    outs = []
    for mode in ("on", "off"):
        q = _fresh(_plain_params())
        opt = hvd.DistributedOptimizer(torch.optim.SGD(tree_leaves(q),
                                                       lr=0.1),
                                       compression=ScaleCompressor)
        step = make_train_step(_plain_loss, opt, overlap=mode)
        for _ in range(2):
            step(q, _batch())
        outs.append([x.detach().clone() for x in tree_leaves(q)])
        if mode == "on":
            _assert_fell_back_once(step, "nonstatic-compression")
    assert _equal(*outs)


# ---------------------------------------------------------------------------
# Two gloo ranks
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    sys.path.insert(0, sys.argv[4])
    import test_torch_overlap as T
    import test_torch_overlap_state as S
    from horovod_tpu_torch.ops import megakernel as MK

    rank, store, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    hvd.init(device="cpu")
    out = {}

    def keep(tag, run):
        losses, leaves, _ = run
        out[tag + ".loss"] = np.array(losses)
        for i, x in enumerate(leaves):
            out[f"{tag}.{i}"] = x.float().numpy()

    plain = T._plain_params()
    mixed = T._plain_params()
    mixed["b1"] = mixed["b1"].to(torch.bfloat16)
    mixed["b2"] = mixed["b2"].to(torch.bfloat16)
    for name, params in (("f32", plain),
                         ("bf16", T._plain_params(0, torch.bfloat16)),
                         ("mixed", mixed)):
        for mode in ("on", "serial", "off"):
            keep(f"{name}.{mode}", T._run(params, 3, overlap=mode,
                                          fusion_threshold=T._THRESHOLD))
    for mode in ("on", "serial", "off"):
        keep(f"chain.{mode}", T._run(T._chain_params(), 3, overlap=mode,
                                     loss_fn=T._chain(),
                                     fusion_threshold=T._THRESHOLD))
    # The stateful step (BatchNorm statistics averaged over the ranks)
    # and has_aux, each rank on its own rows of one global batch.
    for mode in ("on", "serial", "off"):
        losses, params, stats, _ = S.stateful_run("bn_mlp", mode, rank=rank,
                                                  size=2)
        keep(f"state.{mode}", (losses, params + stats, None))
        losses, auxes, params, _ = S.aux_run(mode, rank=rank, size=2)
        keep(f"aux.{mode}", (losses, params, None))
        out[f"aux.{mode}.aux"] = np.array([[a["mae"], a["max"]]
                                           for a in auxes])
    _, _, stats, _ = S.stateful_run("bn_mlp", "on", steps=1, rank=rank,
                                    size=2)
    for i, x in enumerate(stats):
        out[f"stats1.{i}"] = x.numpy()
    hvd.set_compression(default="int8")
    for mode in ("on", "serial"):
        MK.flush("test")
        keep(f"int8.{mode}", T._run(T._chain_params(), 3, overlap=mode,
                                    loss_fn=T._chain(),
                                    fusion_threshold=T._THRESHOLD))
    hvd.set_compression()
    np.savez(out_path, **out)
    hvd.shutdown()
    dist.destroy_process_group()
    print("WORKER_OK", rank, flush=True)
""")


def test_two_gloo_ranks_overlap_is_bitwise_the_monolithic_step(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    for k in ("RANK", "WORLD_SIZE", OV.OVERLAP_ENV):
        env.pop(k, None)
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), store,
         str(tmp_path / f"out{r}.npz"), os.path.dirname(__file__)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in log, log
    outs = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]

    def same(a, b):
        return a.keys() == b.keys() and all(
            np.array_equal(a[k], b[k]) for k in a)

    def run(out, tag):
        return {k[len(tag) + 1:]: v for k, v in out.items()
                if k.startswith(tag + ".")}

    for out in outs:
        for name in ("f32", "bf16", "mixed", "chain", "state", "aux"):
            on = run(out, f"{name}.on")
            assert on and same(on, run(out, f"{name}.serial")), name
            assert same(on, run(out, f"{name}.off")), name
        assert same(run(out, "int8.on"), run(out, "int8.serial"))
        assert not same(run(out, "int8.on"), run(out, "chain.on"))
    # Both ranks hold the same parameters.
    assert same(outs[0], outs[1])
    # The ranks' batches differ, so the reduction was not the identity.
    assert not np.array_equal(outs[0]["f32.on.loss"][1:],
                              outs[0]["f32.on.loss"][:-1])
    # The stateful and has_aux steps averaged over the ranks: their first
    # step's new statistics and aux are the mean of each rank's own, run
    # alone on its rows from the same start.
    import test_torch_overlap_state as S

    hvd.init(device="cpu")
    try:
        alone = [(S.stateful_run("bn_mlp", "off", steps=1, rank=r, size=2),
                  S.aux_run("off", steps=1, rank=r, size=2))
                 for r in range(2)]
    finally:
        hvd.shutdown()
    for i, (a, b) in enumerate(zip(alone[0][0][2], alone[1][0][2])):
        assert not torch.equal(a, b)
        np.testing.assert_allclose(outs[0][f"stats1.{i}"],
                                   ((a + b) / 2).numpy(), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(
        outs[0]["aux.on.aux"][0],
        np.mean([[run[1][1][0]["mae"], run[1][1][0]["max"]]
                 for run in alone], axis=0), rtol=1e-6)


# ---------------------------------------------------------------------------
# Env knob: validation, resolution, fingerprint
# ---------------------------------------------------------------------------

def test_env_knob_validation(monkeypatch):
    monkeypatch.setenv(OV.OVERLAP_ENV, "bogus")
    with pytest.raises(ValueError, match="HVD_TPU_OVERLAP"):
        OV.validate_env()
    for ok in ("auto", "on", "off", "serial", "1", "0", "ON", " off "):
        monkeypatch.setenv(OV.OVERLAP_ENV, ok)
        OV.validate_env()
    monkeypatch.setenv(OV.OVERLAP_ENV, "1")
    assert OV.overlap_mode() == "on"
    monkeypatch.setenv(OV.OVERLAP_ENV, "0")
    assert OV.overlap_mode() == "off"


def test_init_rejects_malformed_overlap_env(monkeypatch):
    monkeypatch.setenv(OV.OVERLAP_ENV, "sideways")
    with pytest.raises(ValueError, match="HVD_TPU_OVERLAP"):
        hvd.init(device="cpu")
    assert not hvd.is_initialized()


def test_auto_resolution_per_device(monkeypatch):
    monkeypatch.delenv(OV.OVERLAP_ENV, raising=False)
    chain = _chain()
    assert OV.resolve_mode(None, "cpu", 8, chain) == "off"
    assert OV.resolve_mode(None, "cuda", 8, chain) == "stream"
    assert OV.resolve_mode(None, "cuda", 1, chain) == "off"  # one rank
    # A plain loss, or a chain of one stage, has one backward: auto keeps
    # the monolithic step's direct reduction.
    assert OV.resolve_mode(None, "cuda", 8, _plain_loss) == "off"
    assert OV.resolve_mode(None, "cuda", 8) == "off"
    assert OV.resolve_mode(None, "cuda", 8,
                           OV.ChainedLoss(chain.stages[:1])) == "off"
    assert OV.resolve_mode("on", "cpu", 1) == "stream"  # explicit wins
    assert OV.resolve_mode("on", "cuda", 8, _plain_loss) == "stream"
    assert OV.resolve_mode("serial", "cuda", 8) == "serial"
    assert OV.resolve_mode("off", "cuda", 8) == "off"
    with pytest.raises(ValueError, match="overlap"):
        OV.resolve_mode("diagonal", "cpu", 1)


def test_overlap_knob_in_hello_env_fingerprint(monkeypatch):
    assert "HVD_TPU_OVERLAP" in compression_mod._SPMD_ENV_KNOBS
    monkeypatch.setenv(OV.OVERLAP_ENV, "on")
    fp_on = compression_mod.env_fingerprint()
    monkeypatch.setenv(OV.OVERLAP_ENV, "off")
    assert compression_mod.env_fingerprint() != fp_on


# ---------------------------------------------------------------------------
# The chained LM loss against the reference's
# ---------------------------------------------------------------------------

def test_chained_lm_loss_matches_the_reference():
    """f32, 2 layers, d_model 64: the port's ChainedLoss form of the LM
    and the reference's give the same loss and gradients within 1e-5;
    the port's chained loss is bitwise its own monolithic loss."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models import transformer as jt
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.utils.convert import params_from_jax

    kw = dict(vocab_size=128, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              max_seq_len=64)
    jcfg, tcfg = jt.TransformerConfig(**kw), tt.TransformerConfig(**kw)
    jp = jax.tree_util.tree_map(
        np.asarray, jt.init_transformer(jax.random.PRNGKey(0), jcfg))
    toks = np.random.RandomState(3).randint(0, 128, size=(2, 33))
    tok, tgt = toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
    want, want_g = jax.value_and_grad(jt.chained_lm_loss(jcfg))(
        jt.chained_lm_params(jp, jcfg), (jnp.asarray(tok), jnp.asarray(tgt)))
    batch = (torch.from_numpy(tok).long(), torch.from_numpy(tgt).long())
    tp = tt.chained_lm_params(params_from_jax(jp), tcfg)
    loss = tt.chained_lm_loss(tcfg)(tp, batch)
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) < 1e-5
    got_g = [x.grad for x in tree_leaves(tp)]
    want_g = jax.tree_util.tree_leaves(want_g)
    assert len(got_g) == len(want_g) == 2 + 12 * 2 + 3
    for g, w in zip(got_g, want_g):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    # The stages compose to make_loss_fn's dense loss, op for op.
    mono = tt.make_loss_fn(tcfg)(params_from_jax(jp), batch)
    assert torch.equal(mono.detach(), loss.detach())
