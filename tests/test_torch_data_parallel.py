"""horovod_tpu_torch's data-parallel glue against horovod_tpu's.

* Tensor Fusion bucket plans equal the reference's index list for index
  list (GPT-2-small's parameter shapes, and random shape/dtype lists).
* The port flattens parameter trees in the reference's pytree order.
* Two SGD train steps of a tiny transformer, port (one rank, CPU) against
  the JAX package's make_train_step on two virtual devices with the same
  global batch of 4: loss 1e-5, parameters 1e-4 (f32).  SGD, not Adam:
  Adam's first step is about lr*sign(g), which turns float noise on
  near-zero gradients into differences of 2*lr.
* Two gloo ranks in subprocesses: Average and Sum through
  allreduce_gradients, broadcast_parameters from root 1, the bf16/fp16
  cast compression restoring the dtype, and DistributedOptimizer keeping
  the ranks' parameters equal.
"""

import os
import subprocess
import sys
import textwrap
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel import data as jdata
from horovod_tpu.parallel.training import make_train_step as jax_train_step
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.utils.convert import params_from_jax, params_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Leaf = namedtuple("Leaf", "shape dtype")
TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                jnp.dtype(jnp.bfloat16): torch.bfloat16,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.int32): torch.int32}


def _as_torch_leaves(structs):
    return [Leaf(s.shape, TORCH_DTYPES[jnp.dtype(s.dtype)]) for s in structs]


def _gpt2_small_structs():
    cfg = jt.TransformerConfig(vocab_size=32768, d_model=768, n_heads=12,
                               n_layers=12, d_ff=3072, max_seq_len=1024,
                               dtype=jnp.bfloat16)
    tree = jax.eval_shape(lambda key: jt.init_transformer(key, cfg),
                          jax.random.PRNGKey(0))
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("threshold", [0, 1024, 16 << 20, 64 << 20])
def test_bucket_plan_matches_reference_on_gpt2_small(threshold):
    structs = _gpt2_small_structs()
    want = jdata.partition_fusion_buckets(structs, threshold)
    assert thvd.partition_fusion_buckets(_as_torch_leaves(structs),
                                         threshold) == want
    # The port's function also takes the reference's aval-likes directly.
    assert thvd.partition_fusion_buckets(structs, threshold) == want


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("threshold", [0, 1024, 64 << 20])
def test_bucket_plan_matches_reference_on_random_leaves(seed, threshold):
    rng = np.random.RandomState(seed)
    dtypes = [np.float32, jnp.bfloat16, np.float16, np.int32]
    structs = []
    for _ in range(rng.randint(1, 40)):
        shape = tuple(int(n) for n in rng.randint(1, 64,
                                                  size=rng.randint(0, 4)))
        structs.append(jax.ShapeDtypeStruct(
            shape, dtypes[rng.randint(len(dtypes))]))
    want = jdata.partition_fusion_buckets(structs, threshold)
    assert thvd.partition_fusion_buckets(_as_torch_leaves(structs),
                                         threshold) == want


def test_flatten_order_is_the_reference_pytree_order():
    cfg = jt.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                               n_layers=2, d_ff=64, max_seq_len=32)
    tree = jax.tree_util.tree_map(
        np.asarray, jt.init_transformer(jax.random.PRNGKey(0), cfg))
    want = jax.tree_util.tree_leaves(tree)
    got = thvd.tree_leaves(params_from_jax(tree))
    assert len(got) == len(want)
    for t, w in zip(got, want):
        assert np.array_equal(t.detach().numpy(), w)
    # The port's own init yields the same key order and shapes.
    mine = thvd.tree_leaves(tt.init_transformer(
        torch.Generator().manual_seed(0),
        tt.TransformerConfig(vocab_size=64, d_model=32, n_heads=2,
                             n_layers=2, d_ff=64, max_seq_len=32)))
    assert [tuple(t.shape) for t in mine] == [w.shape for w in want]


@pytest.fixture()
def port_cpu():
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def test_two_sgd_steps_match_jax_make_train_step(hvd2, port_cpu):
    jcfg = jt.TransformerConfig(vocab_size=128, d_model=64, n_heads=4,
                                n_layers=2, d_ff=128, max_seq_len=64)
    tcfg = tt.TransformerConfig(vocab_size=128, d_model=64, n_heads=4,
                                n_layers=2, d_ff=128, max_seq_len=64)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 128, size=(4, 33))
    tokens, targets = toks[:, :-1].astype(np.int32), toks[:, 1:].astype(
        np.int32)
    init = jax.tree_util.tree_map(
        np.asarray, jt.init_transformer(jax.random.PRNGKey(0), jcfg))

    # Reference: two replicas, two rows each.
    opt = hvd2.DistributedOptimizer(optax.sgd(0.1))
    step = jax_train_step(jt.make_loss_fn(jcfg, jt.ParallelAxes(data=None)),
                          opt)
    params = jax.tree_util.tree_map(jnp.asarray, init)
    opt_state = opt.init(params)
    want_losses = []
    for _ in range(2):
        params, opt_state, loss = step(
            params, opt_state, (jnp.asarray(tokens), jnp.asarray(targets)))
        want_losses.append(float(loss))

    # Port: one rank, the whole batch of four.
    tparams = params_from_jax(init)
    tstep = port_cpu.make_train_step(
        tt.make_loss_fn(tcfg), port_cpu.DistributedOptimizer(
            torch.optim.SGD(port_cpu.tree_leaves(tparams), lr=0.1)))
    batch = (torch.from_numpy(tokens).long(),
             torch.from_numpy(targets).long())
    got_losses = [float(tstep(tparams, batch)) for _ in range(2)]

    np.testing.assert_allclose(got_losses, want_losses, atol=1e-5, rtol=0)
    got = jax.tree_util.tree_leaves(params_to_numpy(tparams))
    for a, b in zip(got, jax.tree_util.tree_leaves(params)):
        assert float(np.max(np.abs(a - np.asarray(b)))) < 1e-4


def test_size_one_state_and_collectives(port_cpu):
    assert (port_cpu.size(), port_cpu.rank(), port_cpu.local_rank(),
            port_cpu.local_size(), port_cpu.cross_rank()) == (1, 0, 0, 1, 0)
    assert port_cpu.device() == torch.device("cpu")
    x = torch.arange(6, dtype=torch.float32)
    assert torch.equal(port_cpu.allreduce(x), x)
    assert torch.equal(port_cpu.allreduce(x, op=port_cpu.Sum), x)
    h = port_cpu.broadcast_async(x, 0)
    out = port_cpu.synchronize(h)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()
    with pytest.raises(ValueError, match="root_rank"):
        port_cpu.broadcast(x, 1)
    with pytest.raises(ValueError, match="mutually exclusive"):
        port_cpu.allreduce(x, average=True, op=port_cpu.Sum)
    assert torch.equal(port_cpu.allreduce(x, op=port_cpu.ReduceOp.MAX), x)
    assert torch.equal(port_cpu.allreduce(x, op=port_cpu.Adasum), x)


def test_adasum_and_sparse_raise_with_roadmap_items(port_cpu):
    # Adasum (A.6) and sparse gradients (A.2) are ported: one rank's
    # Adasum is the identity, a sparse COO leaf comes back sparse, and
    # the reference's own refusal of sparse Adasum leaves remains.
    w = torch.nn.Parameter(torch.ones(2))
    opt = port_cpu.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                        op=port_cpu.Adasum)
    (w * torch.tensor([1.0, 2.0])).sum().backward()
    opt.step()
    assert torch.allclose(w.detach(), torch.tensor([0.9, 0.8]))
    sparse = torch.sparse_coo_tensor([[0]], [1.0], (3,))
    (out,) = port_cpu.allreduce_gradients([sparse])
    assert out.is_sparse and torch.equal(out.to_dense(), sparse.to_dense())
    with pytest.raises(ValueError, match="sparse_as_dense=True"):
        port_cpu.allreduce_gradients([sparse], op=port_cpu.Adasum)


def test_not_initialized_raises():
    thvd.shutdown()
    with pytest.raises(thvd.NotInitializedError):
        thvd.size()
    with pytest.raises(thvd.NotInitializedError):
        thvd.allreduce_gradients([torch.zeros(2)])


WORKER = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd

    rank, store_path = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2)
    hvd.init(device="cpu")
    assert (hvd.size(), hvd.rank()) == (2, rank)
    assert (hvd.local_size(), hvd.local_rank()) == (2, rank)

    def grads(r):
        g = torch.Generator().manual_seed(100 + r)
        return {"w": torch.randn(5, 3, generator=g),
                "b": torch.randn(7, generator=g),
                "h": torch.randn(4, generator=g).to(torch.bfloat16)}

    mine, other = grads(rank), grads(1 - rank)
    for threshold in (0, 64, None):
        avg = hvd.allreduce_gradients(mine, fusion_threshold=threshold)
        total = hvd.allreduce_gradients(mine, average=False,
                                        fusion_threshold=threshold)
        for k in mine:
            s = mine[k].float() + other[k].float()
            assert avg[k].dtype == mine[k].dtype, k
            tol = 1e-6 if mine[k].dtype == torch.float32 else 2e-2
            assert torch.allclose(total[k].float(), s, atol=tol), k
            assert torch.allclose(avg[k].float(), s / 2, atol=tol), k
    # Cast compression: the wire is narrow, the result keeps the dtype.
    for comp in (hvd.Compression.bf16, hvd.Compression.fp16):
        out = hvd.allreduce_gradients(mine, compression=comp)
        for k in ("w", "b"):
            assert out[k].dtype == torch.float32
            want = (mine[k] + other[k]) / 2
            assert torch.allclose(out[k], want, atol=2e-2), (comp, k)
    # broadcast_parameters from root 1, in place.
    params = {"a": torch.full((3,), float(rank)),
              "z": {"c": torch.arange(4) * (rank + 1)}}
    hvd.broadcast_parameters(params, root_rank=1)
    assert torch.equal(params["a"], torch.ones(3))
    assert torch.equal(params["z"]["c"], torch.arange(4) * 2)
    # DistributedOptimizer: averaged gradients keep the ranks equal.
    w = torch.zeros(3, requires_grad=True)
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=1.0))
    (w * (rank + 1.0)).sum().backward()
    opt.step()
    assert torch.allclose(w.detach(), torch.full((3,), -1.5))
    hvd.barrier()
    hvd.shutdown()
    dist.destroy_process_group()
    print("WORKER_OK", rank)
""")


def test_two_gloo_ranks(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), store],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in out, out
