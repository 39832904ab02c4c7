"""horovod_tpu_torch's tensor parallelism (parallel/tensor.py) against
horovod_tpu's: every case of tests/test_tensor_parallel.py on a model
axis of 2.

One spawned group of 2 gloo ranks (FileStore in tmp_path) runs every
case; the parent runs the reference's ``shard_map`` on 2 of the
conftest's CPU devices and the dense products.  Inputs are drawn with
numpy from a seed.  A two-rank sum is the same in either order, so the
two ranks' replicated outputs are held bitwise against each other, and
the fused (chunked) closers bitwise against the unfused ones; against
the reference and dense, the reference's own tolerances (1e-5 outputs,
1e-4 gradients).
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from horovod_tpu.core import compat as _compat
from horovod_tpu.core.topology import MODEL_AXIS, make_mesh as jmake_mesh
from horovod_tpu.parallel import tensor as jtp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2
TOL, GTOL = 1e-5, 1e-4

WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.topology import make_mesh
    from horovod_tpu_torch.parallel.axis_ops import (pmean_loss,
                                                     reduce_gradients)
    from horovod_tpu_torch.parallel.tensor import (
        column_parallel, gather_column_parallel, local_shard, row_parallel,
        row_parallel_scatter, tp_mlp)

    torch.set_num_threads(1)
    rank, store, data_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                        sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    hvd.init(device="cpu")
    d = {k: torch.from_numpy(v) for k, v in np.load(data_path).items()}
    mesh = make_mesh(model=2)
    m = mesh.axis("model")
    out = {}

    def gelu(x):
        return F.gelu(x, approximate="tanh")

    def sh(w, dim):
        return local_shard(w, dim, axis=m)

    out["col_row"] = row_parallel(
        gelu(column_parallel(d["x1"], sh(d["w1a"], 1), sh(d["b1a"], 0),
                             axis=m)), sh(d["w2a"], 0), d["b2a"], axis=m)
    out["mlp"] = tp_mlp(d["x2"], sh(d["w1b"], 1), None, sh(d["w2b"], 0),
                        None, axis=m)
    out["gather"] = column_parallel(torch.eye(8), sh(d["wg"], 1), axis=m,
                                    gather_output=True)
    out["unsharded"] = row_parallel(d["x4"], sh(d["w4"], 0), axis=m,
                                    input_is_parallel=False)

    def mlp_bytes(fuse, chunks=None):
        return tp_mlp(d["x5"], sh(d["w1c"], 1), None, sh(d["w2c"], 0), None,
                      axis=m, fuse=fuse, fuse_chunks=chunks)

    for c in (2, 4):
        out[f"mlp_fused.{c}"] = mlp_bytes(True, c)
    out["mlp_unfused"] = mlp_bytes(False)
    for mode in ("off", "on"):
        os.environ["HVD_TPU_FUSE"] = mode
        out[f"mlp_env.{mode}"] = mlp_bytes(None)
    del os.environ["HVD_TPU_FUSE"]

    def pair(x, w1, w2, fuse=None, chunks=None):
        s = row_parallel_scatter(sh(x, 1), sh(w1, 0), axis=m, fuse=fuse,
                                 fuse_chunks=chunks)
        return gather_column_parallel(s, sh(w2, 1), axis=m, fuse=fuse,
                                      fuse_chunks=chunks)

    out["pair"] = pair(d["x6"], d["w6a"], d["w6b"])
    for c in (2, 4):
        out[f"pair_fused.{c}"] = pair(d["x7"], d["w7a"], d["w7b"], True, c)
    out["pair_unfused"] = pair(d["x7"], d["w7a"], d["w7b"], False)

    w1 = d["w1g"].clone().requires_grad_(True)
    w2 = d["w2g"].clone().requires_grad_(True)
    y = tp_mlp(d["xg"], sh(w1, 1), None, sh(w2, 0), None, axis=m)
    pmean_loss((y ** 2).sum(), mesh).backward()
    reduce_gradients([w1, w2], mesh)
    out["grad_w1"], out["grad_w2"] = w1.grad, w2.grad
    np.savez(out_path, **{k: v.detach().numpy() for k, v in out.items()})
    hvd.shutdown()
    dist.destroy_process_group()
    print("WORKER_OK", rank, flush=True)
""")


def _inputs():
    rng = np.random.default_rng(11)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"x1": normal(8, 16), "w1a": normal(16, 32, scale=0.1),
            "b1a": normal(32, scale=0.1), "w2a": normal(32, 16, scale=0.1),
            "b2a": normal(16, scale=0.1),
            "x2": normal(4, 8), "w1b": normal(8, 16, scale=0.1),
            "w2b": normal(16, 8, scale=0.1),
            "wg": np.arange(64, dtype=np.float32).reshape(8, 8),
            "x4": normal(4, 16), "w4": normal(16, 8, scale=0.1),
            "x5": normal(16, 8), "w1c": normal(8, 16, scale=0.1),
            "w2c": normal(16, 8, scale=0.1),
            "x6": normal(8, 16), "w6a": normal(16, 16, scale=0.1),
            "w6b": normal(16, 8, scale=0.1),
            "x7": normal(16, 16), "w7a": normal(16, 16, scale=0.1),
            "w7b": normal(16, 8, scale=0.1),
            "xg": normal(4, 8), "w1g": normal(8, 16, scale=0.1),
            "w2g": normal(16, 8, scale=0.1)}


def _reference(d):
    """The reference's functions on a model axis of 2, and dense."""
    mesh = jmake_mesh(model=N, devices=jax.devices()[:N])
    j = {k: jnp.asarray(v) for k, v in d.items()}
    gelu = jax.nn.gelu
    sh = jtp.local_shard

    def run(fn, *args, in_specs=None, out_specs=P()):
        in_specs = in_specs or (P(),) * len(args)
        return np.asarray(jax.jit(_compat.shard_map(
            fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False))(*args))

    ref = {
        "col_row": (run(lambda x, w1, b1, w2, b2: jtp.row_parallel(
            gelu(jtp.column_parallel(x, sh(w1, 1), sh(b1, 0))), sh(w2, 0),
            b2), j["x1"], j["w1a"], j["b1a"], j["w2a"], j["b2a"]),
            gelu(j["x1"] @ j["w1a"] + j["b1a"]) @ j["w2a"] + j["b2a"]),
        "mlp": (run(lambda x, w1, w2: jtp.tp_mlp(x, sh(w1, 1), None,
                                                 sh(w2, 0), None),
                    j["x2"], j["w1b"], j["w2b"]),
                gelu(j["x2"] @ j["w1b"]) @ j["w2b"]),
        "gather": (run(lambda x, w: jtp.column_parallel(
            x, sh(w, 1), gather_output=True), jnp.eye(8), j["wg"]),
            j["wg"]),
        "unsharded": (run(lambda x, w: jtp.row_parallel(
            x, sh(w, 0), input_is_parallel=False), j["x4"], j["w4"]),
            j["x4"] @ j["w4"]),
        "pair": (run(lambda x, w1, w2: jtp.gather_column_parallel(
            jtp.row_parallel_scatter(x, sh(w1, 0)), sh(w2, 1)),
            j["x6"], j["w6a"], j["w6b"],
            in_specs=(P(None, MODEL_AXIS), P(), P()),
            out_specs=P(None, MODEL_AXIS)),
            (j["x6"] @ j["w6a"]) @ j["w6b"]),
    }
    sm = _compat.shard_map(
        lambda x, w1, w2: jtp.tp_mlp(x, sh(w1, 1), None, sh(w2, 0), None),
        mesh=mesh, in_specs=(P(),) * 3, out_specs=P(), check_vma=False)
    ref["grads"] = [np.asarray(g) for g in jax.jit(jax.grad(
        lambda w1, w2: jnp.sum(sm(j["xg"], w1, w2) ** 2), (0, 1)))(
            j["w1g"], j["w2g"])]
    ref["dense_grads"] = [np.asarray(g) for g in jax.grad(
        lambda w1, w2: jnp.sum((gelu(j["xg"] @ w1) @ w2) ** 2), (0, 1))(
            j["w1g"], j["w2g"])]
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    d = _inputs()
    data_path = tmp / "data.npz"
    np.savez(data_path, **d)
    script = tmp / "worker.py"
    script.write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    for k in ("RANK", "WORLD_SIZE", "HVD_TPU_FUSE", "HVD_TPU_FUSE_CHUNKS"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp / "store"),
         str(data_path), str(tmp / f"out{r}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(N)]
    logs = []
    try:
        ref = _reference(d)
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in log, log
    return ref, [dict(np.load(tmp / f"out{r}.npz")) for r in range(N)]


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.mark.parametrize("case", ["col_row", "mlp", "gather", "unsharded"])
def test_matches_reference_and_dense(runs, case):
    ref, outs = runs
    sharded, dense = ref[case]
    for out in outs:
        assert _err(out[case], sharded) < TOL
        assert _err(out[case], dense) < TOL
    assert outs[0][case].tobytes() == outs[1][case].tobytes()


def test_scatter_gather_pair_matches_reference_and_dense(runs):
    ref, outs = runs
    sharded, dense = ref["pair"]
    for r, out in enumerate(outs):
        # Each rank holds its feature shard of the [8, 8] output.
        for want in (sharded, dense):
            assert _err(out["pair"], np.asarray(want)[:, 4 * r:4 * r + 4]) \
                < TOL


@pytest.mark.parametrize("chunks", [2, 4])
def test_fused_row_parallel_bitwise_vs_unfused(runs, chunks):
    _, outs = runs
    for out in outs:
        assert out[f"mlp_fused.{chunks}"].tobytes() == \
            out["mlp_unfused"].tobytes()
    assert outs[0]["mlp_unfused"].tobytes() == outs[1]["mlp_unfused"].tobytes()


def test_fused_env_off_pins_reference(runs):
    _, outs = runs
    for out in outs:
        assert out["mlp_env.off"].tobytes() == out["mlp_env.on"].tobytes()


@pytest.mark.parametrize("chunks", [2, 4])
def test_fused_scatter_gather_pair_bitwise_vs_unfused(runs, chunks):
    _, outs = runs
    for out in outs:
        assert out[f"pair_fused.{chunks}"].tobytes() == \
            out["pair_unfused"].tobytes()


def test_tp_gradients_match_reference_and_dense(runs):
    ref, outs = runs
    for out in outs:
        for name, want, dense in zip(("grad_w1", "grad_w2"), ref["grads"],
                                     ref["dense_grads"]):
            assert _err(out[name], want) < GTOL, name
            assert _err(out[name], dense) < GTOL, name
    for name in ("grad_w1", "grad_w2"):
        assert outs[0][name].tobytes() == outs[1][name].tobytes()
