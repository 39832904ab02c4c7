"""horovod_tpu_torch.frontends.torch (the horovod.torch surface) against
horovod_tpu.frontends.torch.

* The reference's frontend cases on the port: in-place identity after
  poll, fire-and-forget handles pinning nothing, a temporary-view target,
  a dropped target, broadcast_optimizer_state, SyncBatchNorm against
  local BatchNorm (forward, backward, running statistics).
* The MNIST net trained 3 steps through both hook-driven
  DistributedOptimizers from one state_dict (the reference on one
  device, the port on one rank): parameters within 1e-6.
* A 2-layer, d_model 64 transformer trained 2 steps through the port's
  hook optimizer is bitwise equal to the port's make_train_step.
"""

import gc
import json

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import horovod_tpu_torch.frontends.torch as fhvd
from horovod_tpu_torch.examples.pytorch_mnist import Net
from horovod_tpu_torch.frontends import torch_sync_bn
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import collective as TC
from horovod_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                          tree_named_leaves)


@pytest.fixture()
def port():
    fhvd.init(device="cpu")
    yield fhvd
    fhvd.shutdown()


def _poll_until_done(h):
    while not fhvd.poll(h):
        pass


def test_inplace_identity_and_values(port, tmp_path):
    t = torch.arange(4.0)
    assert fhvd.allreduce_(t, average=False) is t
    h = fhvd.allreduce_async_(t, name="poll.id")
    _poll_until_done(h)
    assert fhvd.poll(h) is True  # idempotent after completion
    assert fhvd.synchronize(h) is t and torch.equal(t, torch.arange(4.0))
    u = torch.ones(3)
    assert fhvd.broadcast_(u, 0) is u
    a, b = torch.ones(2), torch.full((3,), 2.0)
    assert all(x is y for x, y in zip(fhvd.grouped_allreduce_([a, b]),
                                      [a, b]))
    # float64 computes in float64 (the reference rounds to float32).
    x = torch.tensor([1.0 + 1e-12], dtype=torch.float64)
    assert fhvd.allreduce(x).item() == 1.0 + 1e-12
    # Compression casts the wire down and restores the dtype, in place too.
    c = torch.tensor([1.0, 2.5])
    for comp in (fhvd.Compression.bf16, fhvd.Compression.fp16):
        out = fhvd.allreduce(c, compression=comp)
        assert out.dtype == torch.float32 and torch.equal(out, c)
        assert fhvd.allreduce_(c, compression=comp) is c
    assert torch.equal(fhvd.alltoall(torch.arange(3)), torch.arange(3))
    assert torch.equal(fhvd.reducescatter(torch.ones(2), op=fhvd.Sum),
                       torch.ones(2))
    assert torch.equal(fhvd.allgather(torch.ones(2, 1)), torch.ones(2, 1))
    # The timeline (A.2) is ported: a valid Chrome trace of the op.
    path = tmp_path / "timeline.json"
    fhvd.start_timeline(str(path))
    fhvd.allreduce(torch.ones(2), name="timeline.op")
    fhvd.stop_timeline()
    names = {e.get("name") for e in json.loads(path.read_text())}
    assert {"NEGOTIATE_ALLREDUCE", "ALLREDUCE",
            "GLOO_ALLREDUCE"} <= names


def test_inplace_fire_and_forget_pins_nothing(port):
    mgr = TC._runtime().handles
    base = mgr.live_count()
    t = torch.ones(4)
    h = fhvd.allreduce_async_(t, average=False, name="fire.forget")
    _poll_until_done(h)
    assert mgr.live_count() == base  # released by poll
    assert h in fhvd._pending  # a weakref record remains
    del t
    gc.collect()
    assert h not in fhvd._pending  # evicted with the target
    with pytest.raises(ValueError, match="already been cleared"):
        fhvd.synchronize(h)


def test_inplace_temporary_view_and_dropped_target(port):
    p = torch.nn.Parameter(torch.ones(4))
    h = fhvd.allreduce_async_(p.data, average=False, name="view.t")
    _poll_until_done(h)
    assert torch.equal(fhvd.synchronize(h), torch.ones(4))
    t = torch.ones(4)
    h = fhvd.allreduce_async_(t, name="poll.dropped")
    _poll_until_done(h)
    del t
    gc.collect()
    with pytest.raises(ValueError, match="garbage-collected|already been"):
        fhvd.synchronize(h)


def test_broadcast_parameters_and_optimizer_state(port):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.5, momentum=0.9)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    fhvd.broadcast_parameters(model.state_dict(), root_rank=0)
    fhvd.broadcast_parameters(model.named_parameters(), root_rank=0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    opt.param_groups[0]["lr"] = 123.0
    fhvd.broadcast_optimizer_state(opt, root_rank=0)
    assert opt.param_groups[0]["lr"] == 123.0
    sd = opt.state_dict()
    assert any("momentum_buffer" in st for st in sd["state"].values())
    dopt = fhvd.DistributedOptimizer(
        opt, named_parameters=model.named_parameters())
    fhvd.broadcast_optimizer_state(dopt, root_rank=0)
    assert dopt.param_groups[0]["lr"] == 123.0


def test_sync_batch_norm_matches_local_bn(port):
    """One rank: the global statistics are the local ones, so the
    synchronized autograd function (called directly: the module itself
    takes the stock path on one rank) matches BatchNorm1d."""
    torch.manual_seed(0)
    x = torch.randn(16, 4, dtype=torch.float64, requires_grad=True)
    x2 = x.detach().clone().requires_grad_(True)
    bn = torch.nn.BatchNorm1d(4, momentum=0.3).double()
    w = torch.nn.Parameter(torch.rand(4, dtype=torch.float64))
    b = torch.nn.Parameter(torch.rand(4, dtype=torch.float64))
    with torch.no_grad():
        bn.weight.copy_(w)
        bn.bias.copy_(b)
    rm, rv = torch.zeros(4, dtype=torch.float64), \
        torch.ones(4, dtype=torch.float64)
    out_s = torch_sync_bn._SyncBatchNormFn.apply(x, w, b, rm, rv, 1e-5, 0.3,
                                                 "sbn.test")
    out_r = bn(x2)
    np.testing.assert_allclose(out_s.detach(), out_r.detach(), atol=1e-12)
    g = torch.randn_like(out_s)
    out_s.backward(g)
    out_r.backward(g)
    np.testing.assert_allclose(x.grad, x2.grad, atol=1e-12)
    np.testing.assert_allclose(w.grad, bn.weight.grad, atol=1e-12)
    np.testing.assert_allclose(b.grad, bn.bias.grad, atol=1e-12)
    np.testing.assert_allclose(rm, bn.running_mean, atol=1e-12)
    np.testing.assert_allclose(rv, bn.running_var, atol=1e-12)
    sbn = fhvd.SyncBatchNorm(4, momentum=0.3)
    ref = torch.nn.BatchNorm1d(4, momentum=0.3)
    xf = x.detach().float()
    assert torch.equal(sbn(xf), ref(xf))
    sbn.eval()
    assert torch.isfinite(sbn(xf)).all()


def test_hook_optimizer_fires_during_backward(port):
    model = torch.nn.Linear(3, 2)
    opt = fhvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    model(torch.ones(4, 3)).pow(2).sum().backward()
    assert len(opt._handles) == 2  # enqueued from the hooks
    opt.step()
    assert not opt._handles


def _train_mnist(hvd, state_dict, batches):
    model = Net()
    model.load_state_dict(state_dict)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.5),
        named_parameters=model.named_parameters())
    for x, y in batches:
        opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
        opt.step()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_mnist_hook_optimizer_matches_the_reference():
    import horovod_tpu.frontends.torch as rhvd

    torch.manual_seed(0)
    init = Net().state_dict()
    rng = np.random.RandomState(0)
    batches = [(torch.from_numpy(rng.rand(32, 784).astype(np.float32)),
                torch.from_numpy(rng.randint(0, 10, 32))) for _ in range(3)]
    rhvd.init(devices=jax.devices()[:1])
    try:
        want = _train_mnist(rhvd, init, batches)
    finally:
        rhvd.shutdown()
    fhvd.init(device="cpu")
    try:
        got = _train_mnist(fhvd, init, batches)
    finally:
        fhvd.shutdown()
    for k in want:
        assert not torch.equal(want[k], init[k])
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)


def test_transformer_hook_path_is_bitwise_the_monolithic_step(port):
    import horovod_tpu_torch as hvd

    cfg = tt.TransformerConfig(vocab_size=128, d_model=64, n_heads=4,
                               n_layers=2, d_ff=128, max_seq_len=64)
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, 128, size=(4, 33)))
    batch = (toks[:, :-1], toks[:, 1:])
    init = tt.init_transformer(torch.Generator().manual_seed(0), cfg)
    runs = []
    for hooks in (False, True):
        params = tree_map(lambda t: t.detach().clone().requires_grad_(),
                          init)
        adamw = torch.optim.AdamW(tree_leaves(params), lr=1e-3,
                                  weight_decay=1e-4)
        opt = (fhvd.DistributedOptimizer(
            adamw, named_parameters=tree_named_leaves(params)) if hooks
            else hvd.DistributedOptimizer(adamw))
        step = hvd.make_train_step(tt.make_loss_fn(cfg), opt)
        TC.reset_stats()
        losses = [step(params, batch) for _ in range(2)]
        runs.append((losses, params, TC.stats()))
    (l0, p0, s0), (l1, p1, s1) = runs
    assert [float(x) for x in l0] == [float(x) for x in l1]
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a, b)
    n_leaves = len(tree_leaves(init))
    assert s0["tensors"] == 2  # the loss only
    assert s1["tensors"] == 2 * (n_leaves + 1)  # every gradient + the loss
