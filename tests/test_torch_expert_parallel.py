"""horovod_tpu_torch's expert parallelism (parallel/expert.py) against
horovod_tpu's.

``_top_k_dispatch`` is held bitwise against the reference on the same
probabilities (seeded grids and the edge cases of
tests/test_expert_parallel.py).  One spawned group of 4 gloo ranks
(FileStore in tmp_path) runs ``moe_layer`` over an expert axis of 4; the
parent runs the reference's ``shard_map`` on 4 of the conftest's CPU
devices (shard ``i`` is rank ``i``).  Weights are the reference's
``init_moe_params``; tokens are drawn with numpy from a seed.  Outputs,
aux losses and gradients within the reference tests' 1e-4; the chunked
round trip bitwise the unchunked one.
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

from horovod_tpu.core import compat as _compat
from horovod_tpu.core.topology import EXPERT_AXIS, make_mesh as jmake_mesh
from horovod_tpu.parallel import expert as jexp
from horovod_tpu_torch.core.topology import MeshAxis
from horovod_tpu_torch.parallel import expert as texp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
TOL = 1e-4
E, D, H = 8, 16, 32
TOKENS = 64

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.topology import make_mesh
    from horovod_tpu_torch.parallel.axis_ops import (pmean_loss,
                                                     reduce_gradients)
    from horovod_tpu_torch.parallel.expert import local_experts, moe_layer

    torch.set_num_threads(1)
    rank, store, data_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                        sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    hvd.init(device="cpu")
    d = {k: torch.from_numpy(v) for k, v in np.load(data_path).items()}
    mesh = make_mesh(expert=4)
    ax = mesh.axis("expert")
    full = {k: d[k] for k in ("router", "w_in", "w_out")}
    x = d["x"].chunk(4)[ax.index]
    out = {}

    def run(**kw):
        return moe_layer(x, local_experts(full, axis=ax), axis=ax,
                         num_experts=8, **kw)

    for k in (1, 2):
        r = run(top_k=k, capacity_factor=8.0)
        out[f"ample.{k}"] = r.out
        out[f"ample.{k}.aux"], out[f"ample.{k}.dropped"] = (r.aux_loss,
                                                            r.dropped_fraction)
    r = run(top_k=2, capacity_factor=1.0)
    out["tight"], out["tight.aux"], out["tight.dropped"] = r
    for c in (2, 4):
        out[f"fused.{c}"] = run(top_k=2, capacity_factor=1.0, fuse=True,
                                fuse_chunks=c).out
    out["unfused"] = run(top_k=2, capacity_factor=1.0, fuse=False).out

    params = {k: v.clone().requires_grad_(True) for k, v in full.items()}
    r = moe_layer(x, local_experts(params, axis=ax), axis=ax, num_experts=8,
                  top_k=2, capacity_factor=4.0)
    pmean_loss(4 * (r.out ** 2).sum() + r.aux_loss, mesh).backward()
    reduce_gradients(list(params.values()), mesh)
    for k, v in params.items():
        out[f"grad.{k}"] = v.grad
    np.savez(out_path, **{k: v.detach().numpy() for k, v in out.items()})
    hvd.shutdown()
    dist.destroy_process_group()
    print("WORKER_OK", rank, flush=True)
""")


def _inputs():
    params = jax.tree_util.tree_map(
        np.array, jexp.init_moe_params(jax.random.PRNGKey(0), E, D, H))
    x = np.random.default_rng(4).standard_normal((TOKENS, D)).astype(
        np.float32)
    return {"x": x, **params}


def _reference(d):
    """moe_layer on an expert axis of 4; aux and dropped per shard."""
    mesh = jmake_mesh(expert=N, devices=jax.devices()[:N])
    params = {k: jnp.asarray(d[k]) for k in ("router", "w_in", "w_out")}
    x = jnp.asarray(d["x"])

    def sharded(**kw):
        def f(x, params):
            mine = jexp.local_experts(params, axis_name=EXPERT_AXIS)
            o = jexp.moe_layer(x, mine, axis_name=EXPERT_AXIS,
                               num_experts=E, **kw)
            return o.out, o.aux_loss[None], o.dropped_fraction[None]

        return _compat.shard_map(f, mesh=mesh,
                                 in_specs=(P(EXPERT_AXIS), P()),
                                 out_specs=(P(EXPERT_AXIS),) * 3,
                                 check_vma=False)

    ref = {}
    for k in (1, 2):
        ref[f"ample.{k}"] = [np.asarray(a) for a in jax.jit(sharded(
            top_k=k, capacity_factor=8.0))(x, params)]
    ref["tight"] = [np.asarray(a) for a in jax.jit(sharded(
        top_k=2, capacity_factor=1.0))(x, params)]
    sm = sharded(top_k=2, capacity_factor=4.0)

    def loss(params):
        out, aux, _ = sm(x, params)
        return jnp.sum(out ** 2) + jnp.mean(aux)

    ref["grads"] = {k: np.asarray(v)
                    for k, v in jax.jit(jax.grad(loss))(params).items()}
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("expert_parallel")
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
    return d, ref, [dict(np.load(tmp / f"out{r}.npz")) for r in range(N)]


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _single(d, **kw):
    """The port's moe_layer on one rank: all experts local."""
    params = {k: torch.from_numpy(d[k]) for k in ("router", "w_in", "w_out")}
    return texp.moe_layer(torch.from_numpy(d["x"]), params,
                          axis=MeshAxis.local("expert"), num_experts=E, **kw)


@pytest.mark.parametrize("case", ["ample.1", "ample.2", "tight"])
def test_moe_layer_matches_reference(runs, case):
    _, ref, outs = runs
    out_ref, aux_ref, drop_ref = ref[case]
    per = TOKENS // N
    for r, out in enumerate(outs):
        assert _err(out[case], out_ref[r * per:(r + 1) * per]) < TOL
        assert _err(out[f"{case}.aux"], aux_ref[r]) < TOL
        assert float(out[f"{case}.dropped"]) == float(drop_ref[r])


@pytest.mark.parametrize("top_k", [1, 2])
def test_sharded_matches_single_group(runs, top_k):
    d, _, outs = runs
    one = _single(d, top_k=top_k, capacity_factor=8.0)
    assert float(one.dropped_fraction) == 0.0
    got = np.concatenate([out[f"ample.{top_k}"] for out in outs])
    assert _err(got, one.out.numpy()) < TOL
    assert all(float(out[f"ample.{top_k}.dropped"]) == 0.0 for out in outs)


def test_aux_loss_is_finite_and_positive_and_tight_capacity_drops(runs):
    _, _, outs = runs
    for out in outs:
        assert np.isfinite(out["ample.2.aux"]) and out["ample.2.aux"] > 0
    assert max(float(out["tight.dropped"]) for out in outs) > 0.0


@pytest.mark.parametrize("chunks", [2, 4])
def test_fused_round_trip_bitwise_vs_unfused(runs, chunks):
    _, _, outs = runs
    for out in outs:
        assert out[f"fused.{chunks}"].tobytes() == out["unfused"].tobytes()
        assert out["unfused"].tobytes() == out["tight"].tobytes()


def test_gradients_reach_every_param_group_and_match_reference(runs):
    _, ref, outs = runs
    for name, want in ref["grads"].items():
        for out in outs:
            got = out[f"grad.{name}"]
            assert np.all(np.isfinite(got)) and np.any(got != 0), name
            scale = float(np.max(np.abs(want)))
            assert _err(got, want) <= TOL * scale, name
        assert outs[0][f"grad.{name}"].tobytes() == \
            outs[-1][f"grad.{name}"].tobytes()


def test_moe_output_is_gated_expert_mix():
    d = _inputs()
    x = d["x"][:32]
    small = dict(d, x=x)
    out = _single(small, top_k=E, capacity_factor=float(E))
    assert float(out.dropped_fraction) == 0.0
    probs = jax.nn.softmax(x @ d["router"], axis=-1)
    h = jnp.einsum("td,edh->teh", x, d["w_in"])
    dense = jnp.einsum("teh,ehd->ted", jax.nn.gelu(h), d["w_out"])
    want = jnp.einsum("ted,te->td", dense, probs)
    assert _err(out.out.numpy(), want) < TOL


def test_layer_errors_match_reference():
    d = _inputs()
    params = {k: torch.from_numpy(d[k]) for k in ("router", "w_in", "w_out")}
    three = MeshAxis(name="expert", size=3, index=0, ranks=(0, 1, 2))
    with pytest.raises(ValueError, match="must divide"):
        texp.moe_layer(torch.from_numpy(d["x"]), params, axis=three,
                       num_experts=E)
    two = MeshAxis(name="expert", size=2, index=0, ranks=(0, 1))
    with pytest.raises(ValueError, match="local_experts"):
        texp.moe_layer(torch.from_numpy(d["x"]), params, axis=two,
                       num_experts=E)


def _dispatch_cases():
    rng = np.random.default_rng(9)
    cases = []
    for tokens, experts, k, capacity in ((64, 8, 1, 4), (64, 8, 2, 16),
                                         (32, 4, 2, 1), (16, 3, 3, 16),
                                         (128, 8, 2, 8), (20, 5, 2, 3)):
        logits = rng.standard_normal((tokens, experts)).astype(np.float32)
        probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
        cases.append((probs, k, capacity))
    # tests/test_expert_parallel.py's edge cases: capacity one, a token
    # dropped every round, top_k == E.
    cases.append((np.array([[0.9, 0.1], [0.8, 0.2]], np.float32), 1, 1))
    cases.append((np.array([[0.99, 0.01], [0.98, 0.02], [0.97, 0.03]],
                           np.float32), 1, 1))
    cases.append((np.asarray(jax.nn.softmax(jax.random.normal(
        jax.random.PRNGKey(3), (4, 3)), axis=-1)), 3, 4))
    # Ties: equal probabilities take the first maximum in both.
    cases.append((np.full((6, 4), 0.25, np.float32), 2, 3))
    return cases


@pytest.mark.parametrize("case", range(len(_dispatch_cases())))
def test_top_k_dispatch_bitwise_reference(case):
    probs, k, capacity = _dispatch_cases()[case]
    want = jexp._top_k_dispatch(jnp.asarray(probs), k, capacity)
    got = texp._top_k_dispatch(torch.from_numpy(probs), k, capacity)
    for w, g in zip(want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.dtype == g.dtype and w.shape == g.shape
        assert w.tobytes() == g.tobytes()


def test_top_k_dispatch_edge_cases():
    d, c, dropped = texp._top_k_dispatch(
        torch.tensor([[0.99, 0.01], [0.98, 0.02], [0.97, 0.03]]), 1, 1)
    assert float(d[1].sum()) == 0.0 and float(d[2].sum()) == 0.0
    assert float(c[1].sum()) == 0.0 and float(c[2].sum()) == 0.0
    assert float(dropped) == pytest.approx(2.0 / 3.0)


def test_init_moe_params_shapes_and_local_experts():
    p = texp.init_moe_params(torch.Generator().manual_seed(0), 8, 16, 32)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (16, 8), "w_in": (8, 16, 32), "w_out": (8, 32, 16)}
    ax = MeshAxis(name="expert", size=4, index=2, ranks=(0, 1, 2, 3))
    mine = texp.local_experts(p, axis=ax)
    assert torch.equal(mine["w_in"], p["w_in"][4:6])
    assert mine["router"] is p["router"]
