"""horovod_tpu_torch's sparse gradients (ops/sparse.py, the sparse leaves
of parallel/data.py) and word2vec (models/word2vec.py,
examples/word2vec.py) against horovod_tpu's, on one rank.

The cases of tests/test_sparse.py that one process can hold: average,
duplicates, ``apply_to``, no padding duplication, the ``allreduce``
dispatch, the optimizer's sparse gradient against the dense one and
``sparse_as_dense``; then ``nn.Embedding(sparse=True)``'s gradient
against the reference's ``np.unique`` rows, and one word2vec step of the
port's example against the reference example's step from the same
weights and batch, within 1e-5.  The union of rows across ranks is in
tests/test_torch_adasum.py's 4-rank spawn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.examples import word2vec as tex
from horovod_tpu_torch.models import word2vec as TW
from horovod_tpu_torch.ops import sparse as TS
from horovod_tpu_torch.utils import convert


@pytest.fixture()
def ref():
    import horovod_tpu as hvd

    hvd.init(devices=jax.devices()[:1])
    yield hvd
    hvd.shutdown()


@pytest.fixture()
def port():
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def _both(values, indices, shape):
    from horovod_tpu.ops import sparse as JS

    return (JS.IndexedSlices(jnp.asarray(values), jnp.asarray(indices),
                             shape),
            TS.IndexedSlices(torch.from_numpy(np.asarray(values)),
                             torch.from_numpy(np.asarray(indices)), shape))


def test_sparse_allreduce_average_divides_values(ref, port):
    from horovod_tpu.ops import sparse as JS

    jsl, tsl = _both(np.ones((2, 3), np.float32), np.array([0, 1]), (10, 3))
    want = JS.allreduce(jsl, average=True)
    got = TS.allreduce(tsl, average=True)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(TS.as_dense(got).numpy(),
                                  np.asarray(JS.as_dense(want)))


def test_as_dense_accumulates_duplicates(ref):
    from horovod_tpu.ops import sparse as JS

    jsl, tsl = _both(np.arange(6, dtype=np.float32).reshape(3, 2),
                     np.array([5, 5, 7]), (10, 2))
    dense = TS.as_dense(tsl).numpy()
    np.testing.assert_array_equal(dense, np.asarray(JS.as_dense(jsl)))
    np.testing.assert_array_equal(dense[5], [2.0, 4.0])


def test_apply_to_embedding_rows(ref):
    from horovod_tpu.ops import sparse as JS

    emb = np.random.RandomState(0).rand(8, 2).astype(np.float32)
    jsl, tsl = _both(np.ones((2, 2), np.float32), np.array([1, 3]), (8, 2))
    got = TS.apply_to(torch.from_numpy(emb), tsl, scale=-0.5).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JS.apply_to(jnp.asarray(emb), jsl, scale=-0.5)))
    np.testing.assert_array_equal(got[[0, 2]], emb[[0, 2]])


def test_sparse_grad_from_dense_no_padding_duplication(ref):
    from horovod_tpu.ops import sparse as JS

    dense = np.zeros((10, 2), np.float32)
    dense[9], dense[5] = 1.0, 2.0
    touched = np.array([5, 5, 9], np.int32)
    want = JS.sparse_grad_from_dense(jnp.asarray(dense), jnp.asarray(touched))
    got = TS.sparse_grad_from_dense(torch.from_numpy(dense),
                                    torch.from_numpy(touched))
    assert got.values.shape[0] == 2
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(TS.as_dense(got).numpy(),
                                  np.asarray(JS.as_dense(want)))


def test_allreduce_dispatches_indexed_slices(ref, port):
    import horovod_tpu as H

    jsl, tsl = _both(np.full((2, 3), 4.0, np.float32), np.array([3, 7]),
                     (20, 3))
    want = H.allreduce(jsl, average=True, name="dispatch.sparse")
    got = thvd.allreduce(tsl, average=True, name="dispatch.sparse")
    assert isinstance(got, TS.IndexedSlices)
    from horovod_tpu.ops import sparse as JS

    np.testing.assert_array_equal(TS.as_dense(got).numpy(),
                                  np.asarray(JS.as_dense(want)))
    for op in (thvd.Max, thvd.Adasum):
        with pytest.raises(ValueError, match="sum/average"):
            thvd.allreduce(tsl, op=op)


def test_embedding_sparse_grad_equals_unique_rows(ref):
    """``from_sparse_coo`` of nn.Embedding(sparse=True)'s gradient: the
    unique, summed rows of the reference's ``np.unique`` +
    ``dense_grad[rows]``."""
    from horovod_tpu.ops import sparse as JS

    rng = np.random.RandomState(3)
    table = rng.rand(12, 4).astype(np.float32)
    ids = torch.tensor([3, 7, 3, 11, 0, 7, 7])
    w = rng.rand(7, 4).astype(np.float32)
    grads = {}
    for sparse in (True, False):
        emb = torch.nn.Embedding(12, 4, sparse=sparse)
        with torch.no_grad():
            emb.weight.copy_(torch.from_numpy(table))
        (emb(ids) * torch.from_numpy(w)).sum().backward()
        grads[sparse] = emb.weight.grad
    got = TS.from_sparse_coo(grads[True])
    want = JS.sparse_grad_from_dense(jnp.asarray(grads[False].numpy()),
                                     jnp.asarray(ids.numpy()))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=1e-6)
    assert torch.equal(TS.to_sparse_coo(got).to_dense(),
                       grads[True].to_dense())


def test_distributed_optimizer_sparse_matches_dense(ref, port):
    """A sparse COO gradient through parallel/data.py's optimizer gives
    the dense gradient's update, and the reference's (optax SGD)."""
    import horovod_tpu as H

    dense_grad = np.zeros((12, 4), np.float32)
    dense_grad[2], dense_grad[9] = 1.5, -0.5
    rows = torch.tensor([2, 9])
    updated = []
    for sparse in (True, False):
        emb = torch.nn.Parameter(torch.ones(12, 4))
        w = torch.nn.Parameter(torch.ones(4))
        opt = thvd.DistributedOptimizer(torch.optim.SGD([emb, w], lr=0.1))
        g = torch.from_numpy(dense_grad)
        emb.grad = (torch.sparse_coo_tensor(rows[None], g[rows], (12, 4),
                                            check_invariants=False)
                    if sparse else g.clone())
        w.grad = torch.full((4,), 2.0)
        opt.step()
        assert emb.grad.is_sparse == sparse
        updated.append((emb.detach().clone(), w.detach().clone()))
    assert all(torch.equal(a, b) for a, b in zip(*updated))
    params = {"emb": jnp.ones((12, 4)), "w": jnp.ones((4,))}
    opt = H.DistributedOptimizer(optax.sgd(0.1))
    from horovod_tpu.ops import sparse as JS

    grads = {"emb": JS.sparse_grad_from_dense(jnp.asarray(dense_grad),
                                              jnp.asarray([2, 9])),
             "w": jnp.full((4,), 2.0)}
    upd, _ = opt.update(grads, opt.init(params), params)
    new = optax.apply_updates(params, upd)
    np.testing.assert_allclose(updated[0][0].numpy(), np.asarray(new["emb"]),
                               rtol=1e-6)
    np.testing.assert_allclose(updated[0][1].numpy(), np.asarray(new["w"]),
                               rtol=1e-6)


def test_distributed_optimizer_sparse_as_dense_override(port):
    for flag in (False, True):
        emb = torch.nn.Parameter(torch.zeros(8, 2))
        opt = thvd.DistributedOptimizer(torch.optim.SGD([emb], lr=1.0),
                                        sparse_as_dense=flag)
        emb.grad = torch.sparse_coo_tensor([[5]], torch.full((1, 2), 3.0),
                                           (8, 2))
        opt.step()
        assert emb.grad.is_sparse != flag
        out = emb.detach()
        assert out[5].tolist() == [-3.0, -3.0]
        assert not out[:5].any() and not out[6:].any()


def _ref_example_step(hvd, params, centers, targets, negs, lr, step):
    """The body of the reference's examples/word2vec.py loop, one step."""
    from horovod_tpu.models import word2vec as JW
    from horovod_tpu.ops import sparse as JS

    def loss(emb, nce_w, nce_b):
        return JW.nce_loss(JW.Word2VecParams(emb, nce_w, nce_b),
                           jnp.asarray(centers), jnp.asarray(targets),
                           jnp.asarray(negs))

    value, (g_emb, g_w, g_b) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2)))(*params)
    sl = JS.sparse_grad_from_dense(g_emb, jnp.asarray(centers))
    sl = hvd.allreduce(sl, average=True, name=f"w2v.emb.{step}")
    new_emb = JS.apply_to(params.embeddings, sl, scale=-lr)
    g_w = hvd.allreduce(g_w, name=f"w2v.w.{step}")
    g_b = hvd.allreduce(g_b, name=f"w2v.b.{step}")
    return float(value), JW.Word2VecParams(
        new_emb, params.nce_weights - lr * g_w, params.nce_biases - lr * g_b)


def test_word2vec_step_matches_the_reference_example(ref, port):
    from horovod_tpu.models import word2vec as JW

    vocab, dim, batch, negatives, lr = 300, 32, 64, 16, 0.2
    params = JW.init_params(vocab, dim)
    model = convert.word2vec_from_jax(params)
    corpus = JW.synthetic_corpus(vocab, 5000)
    assert np.array_equal(corpus, TW.synthetic_corpus(vocab, 5000))
    rng_ref, rng_port = np.random.RandomState(0), np.random.RandomState(0)
    for step in range(2):
        centers, targets = JW.skipgram_batch(rng_ref, corpus, batch)
        negs = rng_ref.randint(0, vocab, size=negatives).astype("int32")
        want_loss, params = _ref_example_step(ref, params, centers, targets,
                                              negs, lr, step)
        got_loss = tex.train_step(
            model, *tex.batch_tensors(rng_port, corpus, batch, negatives,
                                      vocab, "cpu"), lr, step)
        np.testing.assert_allclose(float(got_loss), want_loss, rtol=1e-5)
        for got, want in zip(model.params(), params):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=1e-5,
                                       atol=1e-6)


def test_word2vec_example_loss_falls(port):
    run = tex.train(vocab=500, dim=32, batch=64, negatives=16, steps=40,
                    corpus_len=20_000, device="cpu")
    assert np.isfinite(run["losses"]).all()
    assert np.mean(run["losses"][-5:]) < np.mean(run["losses"][:5])
    grad = run["model"].embeddings.grad
    assert grad.is_sparse and grad.coalesce().values().shape[0] <= 64
