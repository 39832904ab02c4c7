"""The data-parallel step's two forms beside the plain one, overlapped:
``make_train_step(..., has_aux=True)`` and
``make_train_step_with_state(..., overlap=)`` (parallel/training.py,
parallel/overlap.py), after the reference's ``_make_step``
(horovod_tpu/parallel/training.py:240-420).

* The stateful step's ``on``, ``serial`` and ``off`` schedules are
  bitwise equal over 3 steps, losses, parameters and BatchNorm
  statistics, on MnistBNMLP and on ResNet18Thin at 33 px; one fused
  response a bucket and no cache miss after the first step.
* ``has_aux=True``: ``step(params, batch) -> (loss, aux)``, ``on``,
  ``serial`` and ``off`` bitwise, the aux averaged.
* Against the reference's monolithic step (``overlap="off"``; its own
  overlapped f32 step is not bitwise its monolithic one), within
  tests/test_torch_resnet.py's tolerances: loss 1e-5, parameters and
  statistics 1e-4 (max abs over two SGD(0.1, momentum 0.9) steps).
* The named fallbacks give the monolithic step of the same kind.
* ``HVD_TPU_OVERLAP`` reaches ``Trainer`` with a model state and
  ``examples/resnet50_synthetic.bench``.

The two-rank cases run in tests/test_torch_overlap.py's gloo worker,
which imports this module's helpers (no jax at import).
"""

import functools

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.models import mnist as tm
from horovod_tpu_torch.models import resnet as tr
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.parallel import overlap as OV
from horovod_tpu_torch.utils.tree import tree_leaves

# BN MLP: Dense_0's [784, 64] kernel alone, the rest in one or two
# buckets; ResNet18Thin: several buckets.
_THRESHOLDS = {"bn_mlp": 64 * 64 * 4, "resnet": 1 << 16}
_AUX_DIM = 16


def _rows(x, rank, size):
    n = x.shape[0] // size
    return x[rank * n:(rank + 1) * n]


def _stateful_case(name, rank=0, size=1):
    """(loss_fn, params, stats, this rank's batch) of a seeded model, f32,
    from the port's init; the batch is the global one's rows."""
    if name == "bn_mlp":
        model = tm.MnistBNMLP()
        params, stats = tm.init_bn_mlp(model, seed=0)
        x, y = tm.synthetic_mnist(16)
        loss_fn = tm.bn_mlp_loss_fn(model)
    else:
        model = tr.ResNet18Thin(num_classes=10, compute_dtype=torch.float32)
        params, stats = tr.init_resnet(model, seed=0)
        x, y = tr.synthetic_imagenet(4 * size, image_size=33,
                                     num_classes=10)
        loss_fn = tr.resnet_loss_fn(model)
    return loss_fn, params, stats, (_rows(x, rank, size),
                                    _rows(y, rank, size))


def stateful_run(name, mode, steps=3, rank=0, size=1, case=None):
    """``steps`` stateful SGD(0.1, momentum 0.9) steps under ``mode``:
    (losses, parameter leaves, statistic leaves, the step)."""
    loss_fn, params, stats, batch = case or _stateful_case(name, rank, size)
    opt = torch.optim.SGD(tree_leaves(params), lr=0.1, momentum=0.9)
    step = thvd.make_train_step_with_state(
        loss_fn, opt, fusion_threshold=_THRESHOLDS[name], overlap=mode)
    losses = []
    for _ in range(steps):
        stats, loss = step(params, stats, batch)
        losses.append(float(loss))
    return (losses, [p.detach().clone() for p in tree_leaves(params)],
            [s.clone() for s in tree_leaves(stats)], step)


def _aux_params(seed=0):
    rng = np.random.RandomState(seed)
    s = 1.0 / np.sqrt(_AUX_DIM)
    return {"b1": np.zeros(_AUX_DIM, np.float32),
            "b2": np.zeros(_AUX_DIM, np.float32),
            "w1": (rng.randn(_AUX_DIM, _AUX_DIM) * s).astype(np.float32),
            "w2": (rng.randn(_AUX_DIM, _AUX_DIM) * s).astype(np.float32)}


def _aux_batch(rank=0, size=1, per=4, seed=1):
    rng = np.random.RandomState(seed)
    x = rng.randn(per * size, _AUX_DIM).astype(np.float32)
    y = rng.randn(per * size, _AUX_DIM).astype(np.float32)
    return _rows(x, rank, size), _rows(y, rank, size)


def aux_loss(params, batch):
    """An MSE with two metrics as its aux."""
    x, y = batch
    h = torch.tanh(x @ params["w1"] + params["b1"])
    err = h @ params["w2"] + params["b2"] - y
    return (err ** 2).mean(), {"mae": err.abs().mean(),
                               "max": err.abs().max()}


def aux_run(mode, steps=3, rank=0, size=1):
    """(losses, auxes, parameter leaves, the step) of ``steps`` SGD steps
    through ``make_train_step(aux_loss, ..., has_aux=True)``."""
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in _aux_params().items()}
    x, y = (torch.from_numpy(a) for a in _aux_batch(rank, size))
    step = thvd.make_train_step(
        aux_loss, torch.optim.SGD(tree_leaves(params), lr=0.1, momentum=0.9),
        fusion_threshold=_AUX_DIM * _AUX_DIM * 4, overlap=mode,
        has_aux=True)
    losses, auxes = [], []
    for _ in range(steps):
        loss, aux = step(params, (x, y))
        losses.append(float(loss))
        auxes.append({k: float(v) for k, v in aux.items()})
    return losses, auxes, [p.detach().clone()
                           for p in tree_leaves(params)], step


def _equal(a, b):
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture
def one_rank():
    thvd.init(device="cpu")
    yield
    thvd.shutdown()


# ---------------------------------------------------------------------------
# Bitwise across the schedules, one rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bn_mlp", "resnet"])
def test_stateful_schedules_bitwise_over_three_steps(one_rank, name):
    runs = {mode: stateful_run(name, mode)
            for mode in ("on", "serial", "off")}
    on, serial, off = runs["on"], runs["serial"], runs["off"]
    assert on[3].overlap_active and on[3].schedule == "stream"
    assert serial[3].schedule == "serial"
    assert on[3].bucket_count >= 2 and on[3].segment_count == 1
    assert not hasattr(off[3], "overlap_active")
    for other in (serial, off):
        assert on[0] == other[0]
        assert _equal(on[1], other[1]) and _equal(on[2], other[2])
    assert on[0][-1] < on[0][0]
    # The statistics moved, and the step returned them (not the input).
    _, _, stats0, _ = _stateful_case(name)
    assert not _equal(on[2], [s for s in tree_leaves(stats0)])


def test_stateful_overlap_one_response_a_bucket_and_cache_replay(one_rank):
    case = _stateful_case("bn_mlp")
    loss_fn, params, stats, batch = case
    step = thvd.make_train_step_with_state(
        loss_fn, torch.optim.SGD(tree_leaves(params), lr=0.1),
        fusion_threshold=_THRESHOLDS["bn_mlp"], overlap="on")
    for _ in range(2):
        stats, _ = step(params, stats, batch)
    C.reset_stats()
    stats, _ = step(params, stats, batch)
    st = C.stats()
    # One fused response a bucket plus the loss's; the statistics go by
    # the monolithic step's direct allreduce, not negotiated.
    assert st["responses"] == step.bucket_count + 1
    assert st["cache_misses"] == 0
    assert st["tensors"] == len(tree_leaves(params)) + 1
    assert step.stats()["overlap.buckets_dispatched"] == 3 * step.bucket_count


@pytest.mark.parametrize("mode", ["on", "serial"])
def test_has_aux_schedules_bitwise_and_aux_returned(one_rank, mode):
    got, off = aux_run(mode), aux_run("off")
    assert got[3].overlap_active
    assert got[0] == off[0] and got[1] == off[1]
    assert _equal(got[2], off[2])
    # One rank: the aux is this rank's own, averaged over one.
    params = {k: torch.tensor(v) for k, v in _aux_params().items()}
    loss, aux = aux_loss(params, tuple(torch.from_numpy(a)
                                       for a in _aux_batch()))
    assert got[0][0] == float(loss)
    assert got[1][0] == {k: float(v) for k, v in aux.items()}


def test_has_aux_false_keeps_the_plain_return(one_rank):
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in _aux_params().items()}
    batch = tuple(torch.from_numpy(a) for a in _aux_batch())
    for mode in ("on", "off"):
        step = thvd.make_train_step(lambda p, b: aux_loss(p, b)[0],
                                    torch.optim.SGD(tree_leaves(params),
                                                    lr=0.1), overlap=mode)
        out = step(params, batch)
        assert isinstance(out, torch.Tensor) and out.dim() == 0


def test_chained_loss_with_aux_is_not_segmented(one_rank):
    """A ChainedLoss whose last stage returns (loss, aux) keeps one
    backward, as the reference's (reference overlap.py:632-636)."""
    def stage0(p, carry, batch):
        return torch.tanh(batch[0] @ p["w"])

    def stage1(p, carry, batch):
        err = carry @ p["w"] - batch[1]
        return (err ** 2).mean(), {"mae": err.abs().mean()}

    chain = OV.ChainedLoss([stage0, stage1])
    out = {}
    for mode in ("on", "off"):
        params = [{"w": torch.tensor(_aux_params()[k], requires_grad=True)}
                  for k in ("w1", "w2")]
        step = thvd.make_train_step(
            chain, torch.optim.SGD(tree_leaves(params), lr=0.1),
            overlap=mode, has_aux=True)
        batch = tuple(torch.from_numpy(a) for a in _aux_batch())
        out[mode] = [step(params, batch) for _ in range(2)]
        if mode == "on":
            assert step.segment_count == 1
        out[mode] = ([float(a) for a, _ in out[mode]],
                     [float(b["mae"]) for _, b in out[mode]],
                     [p.detach().clone() for p in tree_leaves(params)])
    assert out["on"][:2] == out["off"][:2]
    assert _equal(out["on"][2], out["off"][2])


# ---------------------------------------------------------------------------
# Fallbacks: the monolithic step of the same kind
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["aux", "state"])
def test_adasum_falls_back_to_the_monolithic_step_of_its_kind(one_rank,
                                                               kind):
    def run(mode):
        if kind == "state":
            loss_fn, params, stats, batch = _stateful_case("bn_mlp")
            step = thvd.make_train_step_with_state(
                loss_fn, torch.optim.SGD(tree_leaves(params), lr=0.1),
                op=thvd.Adasum, overlap=mode)
            outs = []
            for _ in range(2):
                stats, loss = step(params, stats, batch)
                outs.append(float(loss))
            return outs, tree_leaves([params, stats]), step
        params = {k: torch.tensor(v, requires_grad=True)
                  for k, v in _aux_params().items()}
        batch = tuple(torch.from_numpy(a) for a in _aux_batch())
        step = thvd.make_train_step(
            aux_loss, torch.optim.SGD(tree_leaves(params), lr=0.1),
            op=thvd.Adasum, overlap=mode, has_aux=True)
        outs = [step(params, batch) for _ in range(2)]
        return ([(float(a), float(b["mae"])) for a, b in outs],
                tree_leaves(params), step)

    got, leaves_on, step = run("on")
    want, leaves_off, _ = run("off")
    assert step.overlap_active is False and step._fallback_reason == "adasum"
    assert step.stats()["overlap.fallbacks"] == 1
    assert got == want
    assert _equal([x.detach() for x in leaves_on],
                  [x.detach() for x in leaves_off])


def test_stateful_grad_tree_fallback_returns_state_and_loss(one_rank):
    loss_fn, params, stats, batch = _stateful_case("bn_mlp")
    reordered = torch.optim.SGD(tree_leaves(params)[::-1], lr=0.1)
    step = thvd.make_train_step_with_state(loss_fn, reordered,
                                           overlap="serial")
    new_stats, loss = step(params, stats, batch)
    assert step._fallback_reason == "grad-tree"
    assert isinstance(new_stats, dict) and loss.dim() == 0


# ---------------------------------------------------------------------------
# The knob reaches Trainer and the example
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("knob,schedule", [("on", "stream"),
                                           ("serial", "serial"),
                                           ("off", None), (None, None)],
                         ids=["on", "serial", "off", "unset"])
def test_trainer_with_state_reads_the_overlap_knob(one_rank, monkeypatch,
                                                   knob, schedule):
    from horovod_tpu_torch.frontends.loop import Trainer

    def fit():
        model = tm.MnistBNMLP()
        params, stats = tm.init_bn_mlp(model, seed=0)
        batch = tm.synthetic_mnist(16)
        trainer = Trainer(tm.bn_mlp_loss_fn(model), params, lr=0.1,
                          optimizer_kwargs={"momentum": 0.9},
                          model_state=stats)
        history = trainer.fit(lambda e, s: batch, epochs=1,
                              steps_per_epoch=3, prefetch=0)
        return trainer, history, tree_leaves([trainer.params,
                                              trainer.model_state])

    monkeypatch.delenv(OV.OVERLAP_ENV, raising=False)
    _, want_history, want = fit()
    if knob is not None:
        monkeypatch.setenv(OV.OVERLAP_ENV, knob)
    trainer, history, got = fit()
    assert getattr(trainer._step, "schedule", None) == schedule
    if schedule is not None:
        assert trainer._step.overlap_active
    assert history == want_history
    assert _equal([x.detach() for x in got], [x.detach() for x in want])


def test_resnet50_bench_follows_the_overlap_argument_and_knob(
        one_rank, monkeypatch):
    """``bench``'s step takes ``overlap=`` and, without it, the knob.  The
    recipe runs ResNet18Thin here (ResNet-50's 25.6M parameters cost the
    CPU suite minutes); chip_smoke.py's resnet phase runs ResNet-50."""
    from horovod_tpu_torch.examples import resnet50_synthetic as ex

    monkeypatch.setattr(ex.R, "ResNet50", functools.partial(
        tr.ResNet18Thin, compute_dtype=torch.float32))
    monkeypatch.delenv(OV.OVERLAP_ENV, raising=False)
    kw = dict(batch=2, image_size=32, warmup=1, iters=1, device="cpu")
    off = ex.bench(overlap="off", **kw)
    on = ex.bench(overlap="on", **kw)
    assert on["step"].schedule == "stream" and on["step"].overlap_active
    assert not hasattr(off["step"], "overlap_active")
    assert on["losses"] == off["losses"]
    assert _equal(tree_leaves([on["params"], on["stats"]]),
                  tree_leaves([off["params"], off["stats"]]))
    monkeypatch.setenv(OV.OVERLAP_ENV, "serial")
    serial = ex.bench(**kw)
    assert serial["step"].schedule == "serial"
    assert serial["losses"] == off["losses"]


# ---------------------------------------------------------------------------
# Against the reference's monolithic step
# ---------------------------------------------------------------------------

@pytest.fixture
def hvd1():
    """The reference on a one-device mesh (BatchNorm statistics of the
    whole batch, as a one-rank port run)."""
    import jax

    import horovod_tpu

    horovod_tpu.init(devices=jax.devices()[:1])
    yield horovod_tpu
    horovod_tpu.shutdown()


def _reference_case(name):
    """(reference loss_fn, port loss_fn, params, stats, x, y) as numpy
    trees and arrays, the reference's init (test_torch_resnet.py's)."""
    import jax

    from horovod_tpu.models import mnist as jm
    from horovod_tpu.models import resnet as jr

    if name == "bn_mlp":
        model, tmodel = jm.MnistBNMLP(), tm.MnistBNMLP()
        p, s = jax.tree_util.tree_map(np.asarray, jm.init_bn_mlp(model))
        x, y = jm.synthetic_mnist(16)
        return jm.bn_mlp_loss_fn(model), tm.bn_mlp_loss_fn(tmodel), p, s, \
            x, y
    import jax.numpy as jnp

    model = jr.ResNet18Thin(num_classes=10, compute_dtype=jnp.float32)
    tmodel = tr.ResNet18Thin(num_classes=10, compute_dtype=torch.float32)
    p, s = tr.init_resnet(tmodel, seed=0)
    from horovod_tpu_torch.utils.convert import params_to_numpy

    p, s = params_to_numpy(p), params_to_numpy(s)
    x, y = jr.synthetic_imagenet(4, image_size=33, num_classes=10)
    return jr.resnet_loss_fn(model), tr.resnet_loss_fn(tmodel), p, s, x, y


def _max_abs(got_tree, want_tree) -> float:
    import jax

    from horovod_tpu_torch.utils.convert import params_to_numpy

    got = jax.tree_util.tree_leaves(params_to_numpy(got_tree))
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    return max(float(np.max(np.abs(a - np.asarray(b, a.dtype))))
               for a, b in zip(got, want))


@pytest.mark.parametrize("mode", ["on", "serial"])
@pytest.mark.parametrize("name", ["bn_mlp", "resnet"])
def test_stateful_overlap_matches_the_reference_monolithic_step(
        hvd1, one_rank, name, mode):
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu.parallel import training as jtrain
    from horovod_tpu_torch.utils.convert import params_from_jax

    jloss, tloss, p, s, x, y = _reference_case(name)
    opt = optax.sgd(0.1, momentum=0.9)
    step = jtrain.make_train_step_with_state(jloss, opt, donate=False,
                                             overlap="off")
    params, stats = jax.tree_util.tree_map(jnp.asarray, (p, s))
    opt_state = opt.init(params)
    batch = jtrain.shard_batch((x, y))
    want = []
    for _ in range(2):
        params, stats, opt_state, loss = step(params, stats, opt_state,
                                              batch)
        want.append(float(loss))
    tp = params_from_jax(p)
    ts = params_from_jax(s, requires_grad=False)
    case = (tloss, tp, ts, (torch.from_numpy(np.asarray(x)),
                            torch.from_numpy(np.asarray(y))))
    got, _, got_stats, tstep = stateful_run(name, mode, steps=2, case=case)
    assert tstep.overlap_active
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert _max_abs(tp, jax.tree_util.tree_map(np.asarray, params)) < 1e-4
    want_stats = jax.tree_util.tree_leaves(stats)
    assert len(got_stats) == len(want_stats)
    assert max(float(np.max(np.abs(a.numpy() - np.asarray(b))))
               for a, b in zip(got_stats, want_stats)) < 1e-4


@pytest.mark.parametrize("mode", ["on", "off"])
def test_has_aux_matches_the_reference_monolithic_step(hvd1, one_rank,
                                                       mode):
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu.parallel import training as jtrain

    def jloss(params, batch):
        x, y = batch
        h = jnp.tanh(x @ params["w1"] + params["b1"])
        err = h @ params["w2"] + params["b2"] - y
        return jnp.mean(err ** 2), {"mae": jnp.mean(jnp.abs(err)),
                                    "max": jnp.max(jnp.abs(err))}

    opt = optax.sgd(0.1, momentum=0.9)
    step = jtrain.make_train_step(jloss, opt, donate=False, has_aux=True,
                                  overlap="off")
    params = jax.tree_util.tree_map(jnp.asarray, _aux_params())
    opt_state = opt.init(params)
    batch = jtrain.shard_batch(_aux_batch())
    want, want_aux = [], []
    for _ in range(3):
        params, opt_state, loss, aux = step(params, opt_state, batch)
        want.append(float(loss))
        want_aux.append({k: float(v) for k, v in aux.items()})
    got, got_aux, leaves, _ = aux_run(mode)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for g, w in zip(got_aux, want_aux):
        assert g.keys() == w.keys()
        np.testing.assert_allclose([g[k] for k in sorted(g)],
                                   [w[k] for k in sorted(w)], atol=1e-5,
                                   rtol=0)
    want_leaves = jax.tree_util.tree_leaves(params)
    assert max(float(np.max(np.abs(a.numpy() - np.asarray(b))))
               for a, b in zip(leaves, want_leaves)) < 1e-4


def test_chip_smoke_resnet_phase_runs_the_overlapped_leg():
    """chip_smoke.py's resnet phase ends with ResNet-50 overlapped: off,
    serial and on, each timed twice in turns."""
    import inspect

    import chip_smoke

    assert "resnet_overlap_leg(hvd, R, smi_line)" in inspect.getsource(
        chip_smoke.phase_resnet)
    turns = chip_smoke.RESNET_OVERLAP_TURNS
    assert sorted(turns) == sorted(("off", "serial", "on") * 2)
    assert "ResNet-50 overlapped" in chip_smoke.__doc__
    assert (chip_smoke.RESNET_OVERLAP_WARMUP,
            chip_smoke.RESNET_OVERLAP_STEPS) == (2, 5)
