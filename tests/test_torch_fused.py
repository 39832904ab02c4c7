"""horovod_tpu_torch's chunked computation-collective closers (ops/fused.py)
against horovod_tpu's.

In one process: ``plan_chunks`` equal to the reference's over a grid of
``(n_rows, chunks)``, the knobs' normalisation and errors (at ``init``
too), the knobs in the env fingerprint, ``chunked_map`` along axes 0 and
1.  One spawned group of 2 gloo ranks (FileStore in tmp_path) runs
``matmul_psum``, ``matmul_reduce_scatter`` and ``all_gather_matmul``
fused and unfused: bitwise equal, and within 1e-5 of the reference's
``shard_map`` on 2 of the conftest's CPU devices.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu_torch as thvd
from horovod_tpu.core import compat as _compat
from horovod_tpu.core.topology import MODEL_AXIS, make_mesh as jmake_mesh
from horovod_tpu.ops import compression as JC
from horovod_tpu.ops import fused as JF
from horovod_tpu_torch.ops import compression as TC
from horovod_tpu_torch.ops import fused as TF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2
CHUNKS = (1, 2, 3, 4)

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.topology import make_mesh
    from horovod_tpu_torch.ops import fused as F

    torch.set_num_threads(1)
    rank, store, data_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                        sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    hvd.init(device="cpu")
    d = {k: torch.from_numpy(v) for k, v in np.load(data_path).items()}
    m = make_mesh(model=2).axis("model")
    out = {}
    for fuse, chunks in [(False, None)] + [(True, c) for c in (1, 2, 3, 4)]:
        tag = f"{int(fuse)}.{chunks}"
        out[f"psum.{tag}"] = F.matmul_psum(d["x"], d["w"], axis=m,
                                           chunks=chunks, fuse=fuse)
        out[f"rs.{tag}"] = F.matmul_reduce_scatter(
            d["x"], d["w"], axis=m, chunks=chunks, fuse=fuse)
        out[f"ag.{tag}"] = F.all_gather_matmul(
            d["xs"][rank], d["wg"], axis=m, chunks=chunks, fuse=fuse)
    np.savez(out_path, **{k: v.numpy() for k, v in out.items()})
    hvd.shutdown()
    dist.destroy_process_group()
    print("WORKER_OK", rank, flush=True)
""")


def _inputs():
    rng = np.random.default_rng(0)
    return {"x": rng.standard_normal((17, 8)).astype(np.float32),
            "w": rng.standard_normal((8, 8)).astype(np.float32),
            "xs": rng.standard_normal((N, 16, 8)).astype(np.float32),
            "wg": rng.standard_normal((16, 8)).astype(np.float32)}


def _reference(d):
    mesh = jmake_mesh(model=N, devices=jax.devices()[:N])

    def run(fn, *args, in_specs, out_specs=P()):
        return np.asarray(jax.jit(_compat.shard_map(
            fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False))(*args))

    x, w = jnp.asarray(d["x"]), jnp.asarray(d["w"])
    return {
        "psum": run(lambda x, w: JF.matmul_psum(x, w, axis_name=MODEL_AXIS,
                                                fuse=False), x, w,
                    in_specs=(P(), P())),
        "rs": run(lambda x, w: JF.matmul_reduce_scatter(
            x, w, axis_name=MODEL_AXIS, fuse=False), x, w,
            in_specs=(P(), P()), out_specs=P(None, MODEL_AXIS)),
        "ag": run(lambda x, w: JF.all_gather_matmul(
            x, w, axis_name=MODEL_AXIS, fuse=False),
            jnp.asarray(np.concatenate(list(d["xs"]), axis=1)),
            jnp.asarray(d["wg"]), in_specs=(P(None, MODEL_AXIS), P())),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fused")
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


@pytest.mark.parametrize("op", ["psum", "rs", "ag"])
@pytest.mark.parametrize("chunks", CHUNKS)
def test_fused_bitwise_unfused_on_two_ranks(runs, op, chunks):
    _, outs = runs
    for out in outs:
        assert out[f"{op}.1.{chunks}"].tobytes() == \
            out[f"{op}.0.None"].tobytes()


@pytest.mark.parametrize("op", ["psum", "rs", "ag"])
def test_primitives_match_reference(runs, op):
    ref, outs = runs
    want = ref[op]
    for r, out in enumerate(outs):
        mine = want[:, 4 * r:4 * r + 4] if op == "rs" else want
        np.testing.assert_allclose(out[f"{op}.0.None"], mine, rtol=1e-5,
                                   atol=1e-5)
    if op == "psum":
        assert outs[0]["psum.0.None"].tobytes() == \
            outs[1]["psum.0.None"].tobytes()


@pytest.mark.parametrize("chunks", [1, 2, 3, 4, 5, 8, 9])
def test_plan_chunks_matches_reference(chunks):
    for n_rows in range(0, 41):
        assert TF.plan_chunks(n_rows, chunks) == JF.plan_chunks(n_rows,
                                                                chunks)


def test_plan_chunks_default_and_errors(monkeypatch):
    monkeypatch.setenv(TF.CHUNKS_ENV, "3")
    monkeypatch.setenv(JF.CHUNKS_ENV, "3")
    assert TF.plan_chunks(20) == JF.plan_chunks(20) == \
        ((0, 7), (7, 7), (14, 6))
    with pytest.raises(ValueError):
        TF.plan_chunks(8, 0)


@pytest.mark.parametrize("value", ["1", "0", "on", "off", "auto", "",
                                   " ON ", "Off"])
def test_fuse_mode_normalises_like_reference(monkeypatch, value):
    monkeypatch.setenv(TF.FUSE_ENV, value)
    assert TF.fuse_mode() == JF.fuse_mode()
    assert TF.enabled() == JF.enabled()
    assert TF.enabled(True) and not TF.enabled(False)


@pytest.mark.parametrize("bad", ["zero", "0", "-2", "1.5"])
def test_validate_env_rejects_bad_chunks(monkeypatch, bad):
    monkeypatch.delenv(TF.FUSE_ENV, raising=False)
    monkeypatch.setenv(TF.CHUNKS_ENV, bad)
    with pytest.raises(ValueError, match="HVD_TPU_FUSE_CHUNKS"):
        TF.validate_env()


@pytest.mark.parametrize("knob,bad", [("HVD_TPU_FUSE", "sideways"),
                                      ("HVD_TPU_FUSE_CHUNKS", "-1")])
def test_init_fails_on_a_bad_knob(monkeypatch, knob, bad):
    if thvd.is_initialized():
        thvd.shutdown()
    monkeypatch.setenv(knob, bad)
    with pytest.raises(ValueError, match=knob):
        thvd.init(device="cpu")
    assert not thvd.is_initialized()


def test_fusion_knobs_in_env_fingerprint(monkeypatch):
    for knob in (TF.FUSE_ENV, TF.CHUNKS_ENV):
        assert knob in TC._SPMD_ENV_KNOBS and knob in JC._SPMD_ENV_KNOBS
    monkeypatch.setenv(TF.FUSE_ENV, "off")
    monkeypatch.setenv(TF.CHUNKS_ENV, "3")
    fp = TC.env_fingerprint()
    assert "HVD_TPU_FUSE=off" in fp and "HVD_TPU_FUSE_CHUNKS=3" in fp


@pytest.mark.parametrize("axis", [0, 1])
def test_chunked_map_plans_like_reference_and_is_bitwise(axis):
    rng = np.random.default_rng(axis)
    x = rng.standard_normal((10, 10, 3)).astype(np.float32)
    w = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    seen_t, seen_j = [], []

    def fn(c):
        seen_t.append(tuple(c.shape))
        return torch.tanh(c) @ w

    got = TF.chunked_map(fn, torch.from_numpy(x), axis=axis, chunks=4,
                         fuse=True)
    JF.chunked_map(lambda c: seen_j.append(tuple(c.shape)) or c,
                   jnp.asarray(x), axis=axis, chunks=4, fuse=True)
    assert seen_t == seen_j and len(seen_t) == 4
    whole = torch.tanh(torch.from_numpy(x)) @ w
    assert got.numpy().tobytes() == whole.numpy().tobytes()
    calls = []
    TF.chunked_map(lambda c: calls.append(c.shape) or c,
                   torch.from_numpy(x), axis=axis, chunks=4, fuse=False)
    assert len(calls) == 1
