"""horovod_tpu_torch's ZeRO-1 (parallel/zero.py) against horovod_tpu's:
every case of tests/test_zero.py on 4 ranks.

One spawned job of 4 gloo ranks runs the port's cases; the parent runs
the reference's builders on 4 of the conftest's CPU devices.  The
weights are the reference's ``init_params``, carried across with
``utils/convert.py``; the batches are ``synthetic_mnist``, each rank
taking its quarter as the reference's ``shard_batch`` does.  MnistMLP
with hidden 32 has 25,450 parameters, 2 more than a multiple of 4, so
the flat vector is padded.  Tolerances are the reference's own (loss
rtol 1e-5; parameters rtol 1e-4, atol 1e-5; the stateful case 1e-4 and
1e-3).  Port-only: the flat vector bitwise ``ravel_pytree``'s, Adam's
state surviving across steps, the probe's warning for an optimizer that
needs a closure.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

import horovod_tpu as hvd_api
import horovod_tpu_torch as thvd
from gloo_job import OPTIMIZERS, GlooJob, flat, unflat, to_tree
from horovod_tpu.models import mnist as jm
from horovod_tpu.parallel.training import shard_batch
from horovod_tpu.parallel.zero import (make_zero_train_step,
                                       make_zero_train_step_with_state)
from horovod_tpu_torch.parallel import zero as tz
from horovod_tpu_torch.utils.convert import params_from_jax

N = 4
LOSS_RTOL, P_RTOL, P_ATOL = 1e-5, 1e-4, 1e-5

exec(OPTIMIZERS)

WORKER = OPTIMIZERS + """
from horovod_tpu_torch.models import mnist as tm
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.parallel.data import DistributedOptimizer
from horovod_tpu_torch.parallel.zero import (make_zero_train_step,
                                             make_zero_train_step_with_state)

OPTS = {"sgdm": lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
        "adam": lambda ps: torch.optim.Adam(ps, lr=1e-2)}


def loss_of(model):
    def loss_fn(p, b):
        return tm.cross_entropy_loss(model.apply(p, b[0]), b[1])
    return loss_fn


def batch(k):
    return (rows(torch.from_numpy(D[f"images{k}"])),
            rows(torch.from_numpy(D[f"labels{k}"])))


def zero_run(prefix, opt, steps, b, hidden=32, **kw):
    lf = loss_of(tm.MnistMLP(hidden=hidden))
    p = tree(prefix)
    z = make_zero_train_step(lf, opt, **kw)
    s = z.init(p)
    losses = []
    for _ in range(steps):
        p, s, loss = z.step(p, s, b)
        losses.append(float(loss))
    return losses, p, s


out = {}
b64 = batch(64)
for name, opt in OPTS.items():
    p = tree("p32")
    plain = hvd.make_train_step(loss_of(tm.MnistMLP(hidden=32)),
                                opt(hvd.tree_leaves(p)))
    out[f"plain.{name}.losses"] = [float(plain(p, b64)) for _ in range(5)]
    out.update(flat(f"plain.{name}", p))
    losses, p, _ = zero_run("p32", opt, 5, b64)
    out[f"zero.{name}.losses"] = losses
    out.update(flat(f"zero.{name}", p))

# The sharded state after one step (torch creates it at the first).
_, _, s = zero_run("p32", lambda ps: torch.optim.Adam(ps, lr=1e-3), 1, b64)
st = s.optimizer.state[s.shard]
out["state.shard"] = tuple(s.shard.shape)
out["state.exp_avg"] = tuple(st["exp_avg"].shape)
out["state.exp_avg_sq"] = tuple(st["exp_avg_sq"].shape)
out["state.step_ndim"] = st["step"].dim()

# Adam's state survives across steps: the optimizer's shard is one
# tensor, its step count the number of steps.
z = make_zero_train_step(loss_of(tm.MnistMLP(hidden=32)),
                         lambda ps: torch.optim.Adam(ps, lr=1e-3))
p = tree("p32")
s = z.init(p)
shard = s.shard
for _ in range(3):
    p, s, _ = z.step(p, s, b64)
out["survive.same_shard"] = s.shard is shard and \\
    s.optimizer.param_groups[0]["params"][0] is shard
out["survive.step"] = float(s.optimizer.state[shard]["step"])

out["converge.losses"], _, _ = zero_run(
    "p64", lambda ps: torch.optim.Adam(ps, lr=1e-3), 30, batch(256),
    hidden=64)

p16 = tree("p16")
dopt = DistributedOptimizer(torch.optim.SGD(hvd.tree_leaves(p16), lr=0.05))
out["unwrap.losses"], _, _ = zero_run("p16", dopt, 1, batch(32), hidden=16)

# Stateful (synchronized BatchNorm) against make_train_step_with_state.
bn = tm.MnistBNMLP(hidden=32)
lf = tm.bn_mlp_loss_fn(bn)
b16 = batch(16)
p1, s1 = tree("bnp"), tree("bns", requires_grad=False)
plain = hvd.make_train_step_with_state(
    lf, torch.optim.SGD(hvd.tree_leaves(p1), lr=0.1, momentum=0.9))
p2, s2 = tree("bnp"), tree("bns", requires_grad=False)
z = make_zero_train_step_with_state(
    lf, lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9))
o2 = z.init(p2)
ls1, ls2 = [], []
for _ in range(3):
    s1, l1 = plain(p1, s1, b16)
    p2, s2, o2, l2 = z.step(p2, s2, o2, b16)
    ls1.append(float(l1))
    ls2.append(float(l2))
out["state.plain.losses"], out["state.zero.losses"] = ls1, ls2
for tag, t in (("state.plain.p", p1), ("state.plain.s", s1),
               ("state.zero.p", p2), ("state.zero.s", s2)):
    out.update(flat(tag, t))

# bf16 on the reduce-scatter's wire, through the DistributedOptimizer.
sgd = lambda ps: torch.optim.SGD(ps, lr=0.1)
_, p, _ = zero_run("p32", sgd, 1, b64)
out.update(flat("exact", p))
pc = tree("p32")
dopt = DistributedOptimizer(torch.optim.SGD(hvd.tree_leaves(pc), lr=0.1),
                            compression=Compression.bf16)
_, p, _ = zero_run("p32", dopt, 1, b64)
out.update(flat("comp", p))
out["comp.dtypes"] = [str(leaf.dtype) for leaf in hvd.tree_leaves(p)]

# The escape hatch: shard-local clipping by the shard's norm.
out["escape.losses"], p, _ = zero_run(
    "p16", lambda ps: GlobalNormClipSGD(ps, lr=0.1, max_norm=1.0), 1,
    batch(32), hidden=16, validate_elementwise=False)
out.update(flat("escape", p))
finish(out)
"""


def _loss_fn(model):
    def loss_fn(params, batch):
        images, labels = batch
        return jm.cross_entropy_loss(model.apply({"params": params}, images),
                                     labels)
    return loss_fn


def _inputs():
    data = {}
    for hidden in (16, 32, 64):
        data.update(flat(_np(jm.init_params(jm.MnistMLP(hidden=hidden))),
                         f"p{hidden}"))
    bnp, bns = jm.init_bn_mlp(jm.MnistBNMLP(hidden=32))
    data.update(flat(_np(bnp), "bnp"))
    data.update(flat(_np(bns), "bns"))
    for k in (16, 32, 64, 256):
        data[f"images{k}"], data[f"labels{k}"] = jm.synthetic_mnist(k)
    return data


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tree(data, prefix):
    return to_tree(unflat(data, prefix), jnp.asarray)


def _batch(data, k):
    return shard_batch((jnp.asarray(data[f"images{k}"]),
                        jnp.asarray(data[f"labels{k}"])))


def _reference(data):
    """The reference's builders on 4 devices."""
    ref = {}
    b64 = _batch(data, 64)
    loss32 = _loss_fn(jm.MnistMLP(hidden=32))
    for name, ctor in (("sgdm", lambda: optax.sgd(0.1, momentum=0.9)),
                       ("adam", lambda: optax.adam(1e-2))):
        zstep = make_zero_train_step(loss32, ctor(), donate=False)
        p = _tree(data, "p32")
        st = zstep.init(p)
        losses = []
        for _ in range(5):
            p, st, loss = zstep.step(p, st, b64)
            losses.append(float(loss))
        ref[f"zero.{name}"] = (losses, flat(_np(p), ""))
    zstep = make_zero_train_step(loss32, optax.adam(1e-3))
    st = zstep.init(_tree(data, "p32"))
    ref["state"] = [(tuple(leaf.shape), {s.data.shape[0] for s in
                                         leaf.addressable_shards})
                    for leaf in jax.tree_util.tree_leaves(st)
                    if leaf.ndim >= 1]
    ref["state_scalars"] = sum(leaf.ndim == 0 for leaf in
                               jax.tree_util.tree_leaves(st))
    loss16 = _loss_fn(jm.MnistMLP(hidden=16))
    dopt = hvd_api.DistributedOptimizer(optax.sgd(0.05))
    zstep = make_zero_train_step(loss16, dopt, donate=False)
    p = _tree(data, "p16")
    ref["unwrap"] = float(zstep.step(p, zstep.init(p),
                                     _batch(data, 32))[2])

    bn = jm.MnistBNMLP(hidden=32)
    lf = jm.bn_mlp_loss_fn(bn)
    b16 = _batch(data, 16)
    zstep = make_zero_train_step_with_state(
        lf, optax.sgd(0.1, momentum=0.9), donate=False)
    p2, s2 = _tree(data, "bnp"), _tree(data, "bns")
    o2 = zstep.init(p2)
    losses = []
    for _ in range(3):
        p2, s2, o2, loss = zstep.step(p2, s2, o2, b16)
        losses.append(float(loss))
    ref["with_state"] = (losses, flat(_np(p2), ""), flat(_np(s2), ""))

    from horovod_tpu.ops.compression import Compression

    comp = make_zero_train_step(
        loss32, hvd_api.DistributedOptimizer(optax.sgd(0.1),
                                             compression=Compression.bf16),
        donate=False)
    p = _tree(data, "p32")
    ref["comp"] = flat(_np(comp.step(p, comp.init(p), b64)[0]), "")

    clipped = optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(0.1))
    zstep = make_zero_train_step(loss16, clipped,
                                 validate_elementwise=False, donate=False)
    p = _tree(data, "p16")
    p, _, loss = zstep.step(p, zstep.init(p), _batch(data, 32))
    ref["escape"] = (float(loss), flat(_np(p), ""))
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = _inputs()
    job = GlooJob(tmp_path_factory.mktemp("zero"), WORKER, N, data)
    try:
        hvd_api.init(devices=jax.devices()[:N])
        try:
            ref = _reference(data)
        finally:
            hvd_api.shutdown()
    except BaseException:
        job.kill()
        raise
    return ref, job.results()


def _close_tree(got, want, rtol, atol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("opt", ["sgdm", "adam"])
def test_zero_matches_plain_dp(runs, opt):
    """The port's ZeRO step against the reference's and against the
    port's own monolithic step, 5 steps on 4 ranks."""
    ref, outs = runs
    ref_losses, ref_params = ref[f"zero.{opt}"]
    for out in outs:
        got = unflat(out, f"zero.{opt}")
        np.testing.assert_allclose(out[f"zero.{opt}.losses"][-1],
                                   ref_losses[-1], rtol=LOSS_RTOL)
        _close_tree(got, unflat(ref_params, ""), P_RTOL, P_ATOL, "vs ref")
        np.testing.assert_allclose(out[f"zero.{opt}.losses"],
                                   out[f"plain.{opt}.losses"],
                                   rtol=LOSS_RTOL)
        _close_tree(got, unflat(out, f"plain.{opt}"), P_RTOL, P_ATOL,
                    "vs plain")
        for k, v in got.items():  # every rank holds the same parameters
            assert v.tobytes() == unflat(outs[0], f"zero.{opt}")[k].tobytes()


def test_zero_state_is_sharded(runs):
    """Adam's moments are (padded / 4,)-slices on each rank, as the
    reference's are sharded; the step count stays a scalar."""
    ref, outs = runs
    padded = -(-25450 // N) * N
    assert ref["state"] == [((padded,), {padded // N})] * 2
    assert ref["state_scalars"] >= 1
    for out in outs:
        for key in ("state.shard", "state.exp_avg", "state.exp_avg_sq"):
            assert tuple(out[key]) == (padded // N,)
        assert int(out["state.step_ndim"]) == 0


def test_zero_adam_state_survives_steps(runs):
    """torch keys optimizer state by tensor: the step must keep one
    shard tensor, or Adam's moments reset every step."""
    _, outs = runs
    for out in outs:
        assert bool(out["survive.same_shard"])
        assert float(out["survive.step"]) == 3.0


def test_zero_training_converges(runs):
    _, outs = runs
    for out in outs:
        losses = out["converge.losses"]
        assert losses[-1] < losses[0] * 0.7, losses[::10]


def test_zero_unwraps_distributed_optimizer(runs):
    ref, outs = runs
    for out in outs:
        assert np.isfinite(out["unwrap.losses"][0])
        np.testing.assert_allclose(out["unwrap.losses"][0], ref["unwrap"],
                                   rtol=LOSS_RTOL)


def test_zero_with_state_matches_plain_dp(runs):
    """Synchronized BatchNorm: the port's stateful ZeRO step against the
    reference's and the port's make_train_step_with_state."""
    ref, outs = runs
    ref_losses, ref_p, ref_s = ref["with_state"]
    for out in outs:
        for want_l, want_p, want_s in (
                (ref_losses, unflat(ref_p, ""), unflat(ref_s, "")),
                (out["state.plain.losses"], unflat(out, "state.plain.p"),
                 unflat(out, "state.plain.s"))):
            np.testing.assert_allclose(out["state.zero.losses"], want_l,
                                       rtol=1e-4)
            _close_tree(unflat(out, "state.zero.p"), want_p, 1e-3, 1e-5,
                        "params")
            _close_tree(unflat(out, "state.zero.s"), want_s, 1e-3, 1e-5,
                        "stats")


def test_zero_composes_with_compression(runs):
    """bf16 on the reduce-scatter's wire stays within 5e-3 of the exact
    step (and of the reference's compressed step) and keeps f32
    parameters."""
    ref, outs = runs
    for out in outs:
        comp, exact = unflat(out, "comp"), unflat(out, "exact")
        assert set(out["comp.dtypes"]) == {"torch.float32"}
        for k in exact:
            assert comp[k].dtype == exact[k].dtype == np.float32
            np.testing.assert_allclose(comp[k], exact[k], atol=5e-3)
            np.testing.assert_allclose(comp[k], unflat(ref["comp"], "")[k],
                                       atol=5e-3)


def test_zero_rejects_global_norm_clipping(port_cpu):
    model = jm.MnistMLP(hidden=32)
    with pytest.raises(ValueError, match="ELEMENTWISE"):
        tz.make_zero_train_step(
            _loss_fn(model),
            lambda ps: GlobalNormClipSGD(ps, lr=0.1, max_norm=1.0))  # noqa: F821


def test_zero_elementwise_escape_hatch(runs):
    """validate_elementwise=False builds, and clips each shard by its own
    norm, as the reference's shard-local semantics do."""
    ref, outs = runs
    ref_loss, ref_p = ref["escape"]
    for out in outs:
        assert np.isfinite(out["escape.losses"][0])
        np.testing.assert_allclose(out["escape.losses"][0], ref_loss,
                                   rtol=LOSS_RTOL)
        _close_tree(unflat(out, "escape"), unflat(ref_p, ""), P_RTOL,
                    P_ATOL, "escape")


@pytest.mark.parametrize("opt", [
    lambda ps: torch.optim.AdamW(ps, lr=1e-3),
    lambda ps: ClampSGD(ps, lr=0.1, delta=1.0),  # noqa: F821 (per element)
    lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
], ids=["adamw", "clamp", "sgd_momentum"])
def test_zero_probe_accepts_elementwise_chains(port_cpu, opt):
    zstep = tz.make_zero_train_step(lambda p, b: 0, opt)
    assert zstep.init is not None


def test_zero_rejects_non_chunk_state_leaves(port_cpu):
    from horovod_tpu_torch.models import mnist as tm

    zstep = tz.make_zero_train_step(
        lambda p, b: 0, lambda ps: TableSGD(ps, lr=0.1))  # noqa: F821
    with pytest.raises(ValueError, match="per-parameter slice"):
        zstep.init(tm.init_params(tm.MnistMLP(hidden=16)))


def test_zero_probe_warns_for_a_closure_optimizer(port_cpu):
    """LBFGS's step() needs a closure: the probe warns and skips, as the
    reference does on a TypeError."""
    with pytest.warns(UserWarning, match="could not probe"):
        tz.make_zero_train_step(lambda p, b: 0,
                                lambda ps: torch.optim.LBFGS(ps))


def test_zero_rejects_an_optimizer_instance_and_many_groups(port_cpu):
    from horovod_tpu_torch.parallel.data import DistributedOptimizer

    w = torch.zeros(3, requires_grad=True)
    with pytest.raises(TypeError, match="factory"):
        tz.make_zero_train_step(lambda p, b: 0, torch.optim.SGD([w], lr=0.1))
    two = torch.optim.SGD([{"params": [w]},
                           {"params": [torch.zeros(2, requires_grad=True)]}],
                          lr=0.1)
    with pytest.raises(ValueError, match="one param group"):
        tz.make_zero_train_step(lambda p, b: 0, DistributedOptimizer(two))


def _layout_cases():
    from horovod_tpu.models import transformer as jt
    from horovod_tpu_torch.models import resnet as tr
    from horovod_tpu_torch.utils.convert import params_to_numpy

    cfg = jt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                               n_layers=2, d_ff=64, max_seq_len=64,
                               dtype=jnp.bfloat16)
    rng = np.random.default_rng(5)
    return {
        "mlp": lambda: jm.init_params(jm.MnistMLP(hidden=32)),
        "transformer_bf16": lambda: jt.init_transformer(
            jax.random.PRNGKey(0), cfg),
        # ResNet18Thin's tree from the port's init, whose keys and shapes
        # are the reference's (flax's init traces the model for ~20 s).
        "resnet18thin": lambda: params_to_numpy(tr.init_resnet(
            tr.ResNet18Thin(num_classes=16))[0]),
        "mixed_dtypes": lambda: {
            "a": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
            "b": {"c": jnp.asarray(rng.standard_normal(7), jnp.float32),
                  "d": jnp.asarray(rng.standard_normal((2, 2)),
                                   jnp.float16)}},
    }


@pytest.mark.parametrize("case", ["mlp", "transformer_bf16", "resnet18thin",
                                  "mixed_dtypes"])
def test_flat_layout_is_ravel_pytree(case):
    """The port's flat vector is bitwise ravel_pytree's (sorted-key leaf
    order, the promoted dtype); padded to a multiple of 4 with zeros;
    unravelled back bitwise, each leaf in its own dtype and shape."""
    ref_tree = _layout_cases()[case]()
    want, _ = ravel_pytree(ref_tree)
    want = np.asarray(want)
    mine = params_from_jax(jax.tree_util.tree_map(np.asarray, ref_tree))
    got, unravel, true_size = tz._pad_flat(mine, 1)
    assert true_size == want.size
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    got_np = got.float().numpy() if got.dtype == torch.bfloat16 \
        else got.numpy()
    want_np = want.astype(np.float32) if got.dtype == torch.bfloat16 \
        else want
    assert got_np.tobytes() == want_np.tobytes()
    padded, unravel4, _ = tz._pad_flat(mine, N)
    assert padded.numel() % N == 0 and padded.numel() - true_size < N
    assert torch.equal(padded[:true_size], got)
    assert not padded[true_size:].any()
    back = unravel4(padded)
    for a, b in zip(thvd.tree_leaves(back), thvd.tree_leaves(mine)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b.detach())


@pytest.fixture()
def port_cpu():
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()

