"""horovod_tpu_torch's TensorFlow frontend (frontends/tensorflow.py)
against horovod_tpu's.

* tests/test_tf_frontend.py's 14 cases and tests/test_compression.py's TF
  case run in this process on both packages at one rank (the port on
  ``init(device="cpu")``, the reference on one CPU device), with the
  reference file's checks; their outputs are compared exactly.  The two
  fusion cases count the port's wire with ``collective.stats()``: a
  ``tf.function`` gradient batch of 10 is one response carrying 10
  tensors, ``grouped_allreduce`` in graph one response carrying 5.
* bfloat16 and float64 cross the bridge exactly (the reference rounds
  float64 to float32, x64 being off there).
* At 2 gloo ranks, in children on the TensorFlow Keras backend with jax
  blocked: tests/mp_worker.py's ``scenario_tf_function`` (a trace-time name
  reused over 3 executions, a rank-dependent loss driven to w = 1.5 on
  both ranks), a dense sum, a ragged allgather and an IndexedSlices
  allreduce of per-rank inputs, eager and in ``tf.function``, equal to the
  reference's collectives on the same per-replica inputs on 2 devices,
  and the ``DistributedOptimizer`` case on that backend.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import horovod_tpu.frontends.tensorflow as ref_tf  # noqa: E402
import horovod_tpu_torch as thvd  # noqa: E402
import horovod_tpu_torch.frontends.tensorflow as port_tf  # noqa: E402
from horovod_tpu_torch.ops import collective as TC  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def both():
    """Both packages initialized at one rank."""
    import horovod_tpu as hvd

    hvd.init(devices=jax.devices()[:1])
    thvd.init(device="cpu")
    try:
        yield {"reference": ref_tf, "port": port_tf}
    finally:
        thvd.shutdown()
        hvd.shutdown()


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


# ---------------------------------------------------------------------------
# tests/test_tf_frontend.py's cases: each returns its outputs, checked with
# the reference file's asserts, on whichever package it is given.
# ---------------------------------------------------------------------------

def case_allreduce_dense(h):
    x = tf.constant([1.0, 2.0, 3.0])
    avg = h.allreduce(x, average=True)
    np.testing.assert_allclose(avg.numpy(), [1.0, 2.0, 3.0], rtol=1e-6)
    total = h.allreduce(x, average=False)
    np.testing.assert_allclose(total.numpy(), np.asarray(x) * h.size(),
                               rtol=1e-6)
    return {"avg": avg, "sum": total}


def case_allreduce_indexed_slices(h):
    sl = tf.IndexedSlices(values=tf.constant([[1.0, 2.0], [3.0, 4.0]]),
                          indices=tf.constant([1, 5], dtype="int64"),
                          dense_shape=tf.constant([8, 2], dtype="int64"))
    out = h.allreduce(sl, average=True)
    assert isinstance(out, tf.IndexedSlices)
    assert out.values.shape[0] == 2 * h.size()
    dense = np.zeros((8, 2), "float32")
    np.add.at(dense, out.indices.numpy(), out.values.numpy())
    want = np.zeros((8, 2), "float32")
    want[1] = [1.0, 2.0]
    want[5] = [3.0, 4.0]
    np.testing.assert_allclose(dense, want, rtol=1e-5)
    return {"values": out.values, "indices": out.indices,
            "dense_shape": out.dense_shape}


def case_allgather_and_broadcast(h):
    gat = h.allgather(tf.constant([[1.0, 2.0]]))
    assert gat.shape == (h.size(), 2)
    bc = h.broadcast(tf.constant([7.0]), root_rank=0)
    np.testing.assert_allclose(bc.numpy(), [7.0], rtol=1e-6)
    return {"gather": gat, "bcast": bc}


def case_broadcast_variables(h):
    v1 = tf.Variable([1.0, 2.0])
    v2 = tf.Variable([[3.0]])
    before = [v1.numpy().copy(), v2.numpy().copy()]
    h.broadcast_variables([v1, v2], root_rank=0)
    np.testing.assert_allclose(v1.numpy(), before[0], rtol=1e-6)
    np.testing.assert_allclose(v2.numpy(), before[1], rtol=1e-6)
    return {"v1": v1, "v2": v2}


def case_distributed_gradient_tape(h):
    w = tf.Variable([2.0])
    with h.DistributedGradientTape(tf.GradientTape()) as tape:
        loss = w * w
    (g,) = tape.gradient(loss, [w])
    np.testing.assert_allclose(np.asarray(g), [4.0], rtol=1e-6)
    return {"g": g}


def case_distributed_optimizer_applies_reduced_grads(h):
    opt = h.DistributedOptimizer(tf.keras.optimizers.SGD(learning_rate=1.0))
    assert opt.__class__.__name__ == "SGD"
    v = tf.Variable([0.0, 0.0])
    opt.apply_gradients([(tf.constant([1.0, 2.0]), v)])
    np.testing.assert_allclose(v.numpy(), [-1.0, -2.0], rtol=1e-6)
    return {"v": v}


def case_collectives_inside_tf_function(h):
    @tf.function
    def f(x):
        return (h.allreduce(x, average=False), h.allgather(x),
                h.broadcast(x, root_rank=0))

    out = {}
    for i in range(3):  # name reuse across executions
        red, gat, bc = f(tf.constant([1.0, 2.0]))
        np.testing.assert_allclose(red.numpy(),
                                   np.array([1.0, 2.0]) * h.size())
        assert gat.shape == (2 * h.size(),)
        np.testing.assert_allclose(bc.numpy(), [1.0, 2.0])
        out.update({f"red{i}": red, f"gat{i}": gat, f"bc{i}": bc})
    return out


def case_indexed_slices_inside_tf_function(h):
    @tf.function
    def f(values, indices):
        sl = tf.IndexedSlices(values=values, indices=indices)
        out = h.allreduce(sl, average=False)
        return out.values, out.indices

    vals, idxs = f(tf.constant([[1.0, 2.0]]), tf.constant([3], dtype="int64"))
    assert vals.shape[0] == h.size()
    assert idxs.dtype == tf.int64
    np.testing.assert_allclose(vals.numpy()[0], [1.0, 2.0])
    return {"values": vals, "indices": idxs}


def case_compiled_train_step_through_frontend(h):
    w = tf.Variable([0.0, 0.0])
    x = tf.constant([[1.0, 2.0], [3.0, 4.0]])
    y = tf.constant([5.0, 6.0])

    @tf.function
    def train_step():
        with h.DistributedGradientTape(tf.GradientTape()) as tape:
            loss = tf.reduce_mean((tf.linalg.matvec(x, w) - y) ** 2)
        (g,) = tape.gradient(loss, [w])
        w.assign_sub(0.05 * g)
        return loss

    losses = [float(train_step()) for _ in range(20)]
    assert losses[-1] < 0.2 * losses[0], losses
    return {"losses": np.asarray(losses, np.float32), "w": w}


def case_dtype_preserved_float64_int64(h):
    x = tf.constant([1.0, 2.0], dtype=tf.float64)
    red = h.allreduce(x, average=True)
    assert red.dtype == tf.float64
    gat = h.allgather(tf.constant([1, 2], dtype=tf.int64))
    assert gat.dtype == tf.int64
    return {"red": red, "gat": gat}


def case_indexed_slices_without_dense_shape(h):
    sl = tf.IndexedSlices(values=tf.constant([[1.0]]),
                          indices=tf.constant([0], dtype="int64"))
    out = h.allreduce(sl, average=False)
    assert isinstance(out, tf.IndexedSlices)
    assert out.dense_shape is None
    assert out.indices.dtype == tf.int64
    return {"values": out.values, "indices": out.indices}


def case_tf_allreduce_op_and_process_set(h):
    """At one rank the set is [0] (the reference file's [0, 1] needs two
    ranks; the 2-rank children cover a set there)."""
    t = tf.constant([3.0, -1.0])
    mn = h.allreduce(t, op=h.Min)
    np.testing.assert_allclose(mn.numpy(), [3.0, -1.0])
    prod = h.allreduce(tf.constant([2.0]), op=h.Product)
    np.testing.assert_allclose(prod.numpy(), [2.0 ** h.size()])
    ps = h.add_process_set([0])
    in_set = h.allreduce(tf.constant([2.0]), average=False, process_set=ps)
    np.testing.assert_allclose(in_set.numpy(), [2.0 * ps.size()])
    with pytest.raises(ValueError, match="not both"):
        h.allreduce(t, average=True, op=h.Sum)

    @tf.function
    def f(x):
        return h.allreduce(x, op=h.Max, name="tf.fn.max")

    mx = f(tf.constant([5.0]))
    np.testing.assert_allclose(mx.numpy(), [5.0])
    return {"min": mn, "prod": prod, "set": in_set, "max": mx}


def case_compression(h):
    """tests/test_compression.py::test_tf_frontend_accepts_compression."""
    out = h.allreduce(tf.constant([2.0, 4.0]), average=True,
                      compression=h.Compression.bf16)
    assert out.dtype == tf.float32
    np.testing.assert_allclose(out.numpy(), [2.0, 4.0])
    w = tf.Variable([[2.0]])
    with h.DistributedGradientTape(
            tf.GradientTape(), compression=h.Compression.fp16) as tape:
        loss = w * w
    (g,) = tape.gradient(loss, [w])
    assert g.dtype == tf.float32
    np.testing.assert_allclose(g.numpy(), [[4.0]])
    return {"out": out, "g": g}


CASES = {
    "test_allreduce_dense": case_allreduce_dense,
    "test_allreduce_indexed_slices": case_allreduce_indexed_slices,
    "test_allgather_and_broadcast": case_allgather_and_broadcast,
    "test_broadcast_variables": case_broadcast_variables,
    "test_distributed_gradient_tape": case_distributed_gradient_tape,
    "test_distributed_optimizer_applies_reduced_grads":
        case_distributed_optimizer_applies_reduced_grads,
    "test_collectives_inside_tf_function":
        case_collectives_inside_tf_function,
    "test_indexed_slices_inside_tf_function":
        case_indexed_slices_inside_tf_function,
    "test_compiled_train_step_through_frontend":
        case_compiled_train_step_through_frontend,
    "test_dtype_preserved_float64_int64": case_dtype_preserved_float64_int64,
    "test_indexed_slices_without_dense_shape":
        case_indexed_slices_without_dense_shape,
    "test_tf_allreduce_op_and_process_set":
        case_tf_allreduce_op_and_process_set,
    "test_compression.py::test_tf_frontend_accepts_compression":
        case_compression,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reference_case_on_both_packages(both, name):
    outs = {pkg: CASES[name](h) for pkg, h in both.items()}
    ref, port = outs["reference"], outs["port"]
    assert sorted(ref) == sorted(port)
    for key in ref:
        r, p = _np(ref[key]), _np(port[key])
        assert p.dtype == r.dtype, (key, p.dtype, r.dtype)
        np.testing.assert_array_equal(p, r, err_msg=key)


def test_the_cases_cover_the_reference_file():
    import test_tf_frontend as R

    names = {n for n in dir(R) if n.startswith("test_")}
    fusion = {"test_tf_function_gradients_fuse_into_one_wire_collective",
              "test_tf_grouped_allreduce_eager_and_graph"}
    assert len(names) == 14
    assert names == {n for n in CASES if "::" not in n} | fusion


# ---------------------------------------------------------------------------
# Fusion, counted at the port's wire (the reference's two fusion cases)
# ---------------------------------------------------------------------------

@pytest.fixture()
def port():
    thvd.init(device="cpu")
    yield port_tf
    thvd.shutdown()


def _wire_delta(fn):
    before = TC.stats()
    out = fn()
    after = TC.stats()
    return out, {k: after[k] - before[k] for k in ("responses", "tensors")}


def test_tf_function_gradients_fuse_into_one_wire_collective(port):
    """The whole tape batch is one py_function node and one group: one
    response carrying all 10 gradients."""
    ws = [tf.Variable([float(i + 1), 2.0]) for i in range(10)]

    @tf.function
    def step():
        with port.DistributedGradientTape(tf.GradientTape()) as tape:
            loss = tf.add_n([tf.reduce_sum(w * w) for w in ws])
        return tape.gradient(loss, ws)

    step.get_concrete_function()  # tracing runs no collective
    grads, delta = _wire_delta(step)
    for w, g in zip(ws, grads):
        np.testing.assert_allclose(g.numpy(), 2.0 * w.numpy(), rtol=1e-6)
    assert delta == {"responses": 1, "tensors": 10}, delta


def test_tf_grouped_allreduce_eager_and_graph(port):
    xs = [tf.constant([float(i + 1)] * 3) for i in range(5)]
    outs, delta = _wire_delta(lambda: port.grouped_allreduce(
        xs, average=False, name="tf.grp"))
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o.numpy(), (i + 1.0) * port.size())
    assert delta == {"responses": 1, "tensors": 5}, delta

    @tf.function
    def f(*ts):
        return port.grouped_allreduce(list(ts), average=True,
                                      name="tf.grp.fn")

    outs, delta = _wire_delta(lambda: f(*xs))
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o.numpy(), i + 1.0, rtol=1e-6)
    assert delta == {"responses": 1, "tensors": 5}, delta


# ---------------------------------------------------------------------------
# The bridge keeps bfloat16 and float64 exact
# ---------------------------------------------------------------------------

def test_bfloat16_and_float64_cross_the_bridge_exactly(port):
    rng = np.random.RandomState(0)
    wide = rng.randn(64).astype(np.float64) * 1e-3 + 1.0
    x64 = tf.constant(wide)
    x16 = tf.constant(rng.randn(64).astype(np.float32), dtype=tf.bfloat16)
    for out in (port.allreduce(x64, average=False),
                port.broadcast(x64, root_rank=0),
                port.allgather(x64)):
        assert out.dtype == tf.float64
        np.testing.assert_array_equal(out.numpy(), wide)
    # Not representable in float32: the reference's bridge rounds it.
    assert np.any(wide.astype(np.float32).astype(np.float64) != wide)
    bits = x16.numpy().view(np.uint16)
    for out in (port.allreduce(x16, average=False),
                port.broadcast(x16, root_rank=0),
                port.grouped_allreduce([x16], average=False)[0]):
        assert out.dtype == tf.bfloat16
        np.testing.assert_array_equal(out.numpy().view(np.uint16), bits)

    @tf.function
    def f(a, b):
        return (port.allreduce(a, average=False),
                port.allreduce(b, average=False))

    r64, r16 = f(x64, x16)
    assert (r64.dtype, r16.dtype) == (tf.float64, tf.bfloat16)
    np.testing.assert_array_equal(r64.numpy(), wide)
    np.testing.assert_array_equal(r16.numpy().view(np.uint16), bits)


def test_sparse_allreduce_takes_sum_and_average_only(port):
    sl = tf.IndexedSlices(values=tf.constant([[1.0]]),
                          indices=tf.constant([0], dtype="int64"))
    with pytest.raises(ValueError, match="sum/average"):
        port.allreduce(sl, op=port.Max)
    with pytest.raises(ValueError, match="not both"):
        port.allreduce(sl, average=True, op=port.Sum)
    out = port.allreduce(sl, op=port.Sum)
    np.testing.assert_array_equal(out.values.numpy(), [[1.0]])


# ---------------------------------------------------------------------------
# 2 gloo ranks on the TensorFlow Keras backend
# ---------------------------------------------------------------------------

WORKER = """
import tensorflow as tf
import horovod_tpu_torch.frontends.tensorflow as htf

r = RANK
out = {}


@tf.function
def f(x):
    return htf.allreduce(x, average=False, name="tffn.op")


for i in range(3):  # repeated executions reuse the trace-time name
    got = f(tf.constant([float(r + 1 + i)]))
    np.testing.assert_allclose(got.numpy(), [3.0 + 2.0 * i])
    out[f"tffn.{i}"] = got.numpy()

w = tf.Variable([0.0])


@tf.function
def train_step():
    with htf.DistributedGradientTape(tf.GradientTape()) as tape:
        loss = (w[0] - float(r + 1)) ** 2
    (g,) = tape.gradient(loss, [w])
    w.assign_sub(0.25 * g)
    return loss


for _ in range(25):
    train_step()
np.testing.assert_allclose(w.numpy(), [1.5], atol=1e-3)
out["w"] = w.numpy()

dense = tf.constant(D[f"dense.{r}"])
out["sum"] = htf.allreduce(dense, average=False).numpy()
out["avg"] = htf.allreduce(dense).numpy()
ragged = tf.constant(D[f"ag.{r}"])
out["ag"] = htf.allgather(ragged).numpy()
sl = tf.IndexedSlices(tf.constant(D[f"sv.{r}"]), tf.constant(D[f"si.{r}"]),
                      dense_shape=tf.constant([8, 3], dtype="int64"))
red = htf.allreduce(sl, average=False)
out["sv"], out["si"] = red.values.numpy(), red.indices.numpy()
ps = htf.add_process_set([0, 1])
out["set"] = htf.allreduce(dense, average=False, process_set=ps).numpy()


@tf.function
def in_graph(x, g, v, i):
    red = htf.allreduce(tf.IndexedSlices(v, i), average=False)
    return (htf.allreduce(x, average=False), htf.allgather(g), red.values,
            red.indices)


s, a, v, i = in_graph(dense, ragged, sl.values, sl.indices)
out.update({"g.sum": s.numpy(), "g.ag": a.numpy(), "g.sv": v.numpy(),
            "g.si": i.numpy()})

opt = htf.DistributedOptimizer(tf.keras.optimizers.SGD(learning_rate=1.0))
assert opt.__class__.__name__ == "SGD"
var = tf.Variable([0.0, 0.0, 0.0])
opt.apply_gradients([(tf.constant(D[f"dense.{r}"][0]), var)])
out["opt"] = var.numpy()
import keras
out["backend"] = np.frombuffer(keras.backend.backend().encode(), np.uint8)
out["jax"] = np.asarray("jax" in sys.modules and sys.modules["jax"]
                        is not None)
finish(out)
"""


BLOCK_JAX = "import sys\nsys.modules['jax'] = None\n"


def _data():
    rng = np.random.RandomState(5)
    d = {}
    for r in range(2):
        d[f"dense.{r}"] = rng.randint(-8, 9, size=(2, 3)).astype(np.float32)
        d[f"ag.{r}"] = rng.randint(-8, 9, size=(r + 1, 3)).astype(np.float32)
        d[f"sv.{r}"] = rng.randint(-8, 9, size=(2 * r + 1, 3)).astype(
            np.float32)
        d[f"si.{r}"] = rng.randint(0, 8, size=(2 * r + 1,)).astype(np.int64)
    return d


def test_two_ranks_equal_the_reference(tmp_path):
    import horovod_tpu as hvd
    from gloo_job import GlooJob
    from horovod_tpu.ops import sparse as RS

    d = _data()
    job = GlooJob(tmp_path, WORKER, 2, d, timeout=150,
                  env={"KERAS_BACKEND": "tensorflow"}, head=BLOCK_JAX)
    hvd.init(devices=jax.devices()[:2])
    try:
        def per(key):
            return hvd.shard(jnp.stack([jnp.asarray(d[f"{key}.{r}"])
                                        for r in range(2)]))

        def replica0(out):
            out = np.asarray(out)
            np.testing.assert_array_equal(out[1], out[0])
            return out[0]

        want = {
            "sum": replica0(hvd.allreduce(per("dense"), average=False)),
            "avg": replica0(hvd.allreduce(per("dense"))),
            "ag": np.asarray(hvd.allgather(
                [jnp.asarray(d[f"ag.{r}"]) for r in range(2)])),
        }
        red = RS.allreduce(
            [RS.IndexedSlices(jnp.asarray(d[f"sv.{r}"]),
                              jnp.asarray(d[f"si.{r}"]), (8, 3))
             for r in range(2)], average=False)
        # The reference's frontend casts back to the caller's int64 (x64
        # is off there).
        want["sv"] = np.asarray(red.values)
        want["si"] = np.asarray(red.indices).astype(np.int64)
        want["opt"] = -replica0(hvd.allreduce(hvd.shard(jnp.stack(
            [jnp.asarray(d[f"dense.{r}"][0]) for r in range(2)]))))
    finally:
        hvd.shutdown()
    want["set"] = want["sum"]
    for k in ("sum", "ag", "sv", "si"):
        want[f"g.{k}"] = want[k]

    outs = job.results()
    for r, out in enumerate(outs):
        assert bytes(out["backend"]).decode() == "tensorflow"
        assert not out["jax"]
        for i in range(3):
            np.testing.assert_array_equal(out[f"tffn.{i}"], [3.0 + 2.0 * i])
        np.testing.assert_allclose(out["w"], [1.5], atol=1e-3)
        np.testing.assert_array_equal(out["w"], outs[0]["w"])
        for k, v in want.items():
            assert out[k].dtype == v.dtype, (r, k)
            np.testing.assert_array_equal(out[k], v, err_msg=f"{r} {k}")

