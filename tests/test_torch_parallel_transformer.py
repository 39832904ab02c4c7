"""horovod_tpu_torch's multi-axis transformer (models/transformer.py with
ParallelAxes, make_loss_fn over a mesh, parallel/training.py's
make_parallel_train_step) against horovod_tpu's shard_map.

One spawned group of 4 gloo ranks (FileStore in tmp_path) builds the
meshes data2 x seq2, seq2 x model2, data2 x model2, data4 (MoE, the
experts on the data axis) and data2 x pipe2 (the layers as GPipe stages)
in turn.  The parent computes the reference on
the same mesh shapes over 4 of the conftest's CPU devices, where shard
``i`` is rank ``i``.  Weights are the reference's init moved through
utils/convert.py; the batch is drawn with numpy from a seed.

Tolerances: every value within 1e-4 of the largest magnitude of what it
is compared with (f32, other summation orders); the gradients on every
rank are the same bits (they are one all_reduce's result).
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from horovod_tpu.core import compat as _compat
from horovod_tpu.core.topology import make_mesh as jmake_mesh
from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel import expert as jexp
from horovod_tpu.parallel.training import (
    make_parallel_train_step as jmake_parallel_train_step,
    shard_parallel_batch as jshard_parallel_batch)
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.parallel import expert as texp
from horovod_tpu_torch.utils.convert import params_from_jax, params_to_numpy
from horovod_tpu_torch.utils.tree import tree_named_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
RTOL = 1e-4
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq_len=128)
MOE = dict(num_experts=4, top_k=2, capacity_factor=4.0)
BATCH, SEQ = 4, 32
LR = 0.1
SPEC = ("data", "seq")
# name, mesh degrees, ParallelAxes, config overrides
CASES = [
    ("dp2_sp2", dict(data=2, seq=2), dict(data="data", seq="seq"), {}),
    ("sp2_tp2", dict(seq=2, model=2),
     dict(data="data", seq="seq", model="model"), {}),
    ("dp2_tp2", dict(data=2, model=2), dict(data="data", model="model"),
     {}),
    ("dp2_sp2_remat_chunked", dict(data=2, seq=2),
     dict(data="data", seq="seq"), dict(remat=True, loss_chunk=8)),
    ("moe_ep4", dict(data=4), dict(data="data", expert="data"), MOE),
    # Pipeline parallelism: the layers as gpipe stages over pipe, 2
    # microbatches (the reference's test_pipeline_forward_matches_single_
    # device mesh).
    ("dp2_pp2", dict(data=2, pipe=2), dict(data="data", pipe="pipe"), {}),
]
SGD_CASE = ("sp2_tp2", dict(seq=2, model=2),
            dict(data="data", seq="seq", model="model"))

WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.topology import make_mesh
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.parallel.axis_ops import reduce_gradients
    from horovod_tpu_torch.parallel.training import (
        make_parallel_train_step, shard_parallel_batch)
    from horovod_tpu_torch.utils.convert import params_from_jax
    from horovod_tpu_torch.utils.tree import tree_leaves, tree_named_leaves

    torch.set_num_threads(1)
    rank, store, data_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                        sys.argv[3], sys.argv[4])
    spec = json.loads(sys.argv[5])
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    hvd.init(device="cpu")
    data = dict(np.load(data_path))
    batch = tuple(torch.from_numpy(data[k]).long()
                  for k in ("tokens", "targets"))
    out = {}

    def params(prefix):
        tree = {}
        for key, value in data.items():
            if key.startswith(prefix + "/"):
                node = tree
                *path, leaf = key[len(prefix) + 1:].split("/")
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = value
        return params_from_jax(tree)

    def coords(mesh):
        return np.array([mesh.axis("data").index, mesh.axis("seq").index])

    for name, mesh_kw, ax_kw, cfg_kw in spec["cases"]:
        mesh = make_mesh(**mesh_kw)
        cfg = tt.TransformerConfig(**spec["cfg"], **cfg_kw)
        ax = tt.ParallelAxes(**ax_kw)
        p = params("moe" if cfg.num_experts else "dense")
        local = shard_parallel_batch(batch, mesh, tuple(spec["batch_spec"]))
        logits = tt.forward(p, local[0], cfg, ax, mesh=mesh)
        loss = tt.make_loss_fn(cfg, ax, mesh)(p, local)
        loss.backward()
        reduce_gradients(tree_leaves(p), mesh)
        out[f"{name}.logits"] = logits.detach().numpy()
        out[f"{name}.coords"] = coords(mesh)
        out[f"{name}.loss"] = loss.detach().numpy()
        for leaf, x in tree_named_leaves(p):
            out[f"{name}.grad.{leaf}"] = x.grad.numpy()

    name, mesh_kw, ax_kw = spec["sgd"]
    mesh = make_mesh(**mesh_kw)
    cfg = tt.TransformerConfig(**spec["cfg"])
    p = params("dense")
    opt = torch.optim.SGD(tree_leaves(p), lr=spec["lr"])
    step = make_parallel_train_step(
        tt.make_loss_fn(cfg, tt.ParallelAxes(**ax_kw), mesh), opt, mesh,
        tuple(spec["batch_spec"]))
    out["sgd.losses"] = np.array([float(step(p, batch)) for _ in range(3)])
    for leaf, x in tree_named_leaves(p):
        out[f"sgd.param.{leaf}"] = x.detach().numpy()
    np.savez(out_path, **out)
    hvd.shutdown()
    dist.destroy_process_group()
    print("WORKER_OK", rank, flush=True)
""")


def _flat(tree, prefix):
    return {f"{prefix}/{k}": np.asarray(v)
            for k, v in _named(tree)}


def _named(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _named(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    err = float(np.max(np.abs(got - want)))
    assert err <= RTOL * scale, (what, err, scale)


def _jcfg(cfg_kw):
    return jt.TransformerConfig(**CFG, **cfg_kw, block_q=16, block_k=16)


def _tcfg(cfg_kw):
    return tt.TransformerConfig(**CFG, **cfg_kw)


def _inputs():
    rng = np.random.RandomState(3)
    toks = rng.randint(0, CFG["vocab_size"], size=(BATCH, SEQ + 1))
    dense = jax.tree_util.tree_map(
        np.asarray, jt.init_transformer(jax.random.PRNGKey(0), _jcfg({})))
    moe = jax.tree_util.tree_map(
        np.asarray, jt.init_transformer(jax.random.PRNGKey(1), _jcfg(MOE)))
    return dense, moe, toks[:, :-1].astype(np.int32), \
        toks[:, 1:].astype(np.int32)


def _reference(dense, moe, tokens, targets):
    """The reference on each case's mesh shape: full logits, loss, grads;
    then 3 optax.sgd steps of its make_parallel_train_step."""
    ref = {}
    batch = (jnp.asarray(tokens), jnp.asarray(targets))
    for name, mesh_kw, ax_kw, cfg_kw in CASES:
        mesh = jmake_mesh(**mesh_kw, devices=jax.devices()[:N])
        cfg = _jcfg(cfg_kw)
        ax = jt.ParallelAxes(**ax_kw)
        params = moe if cfg_kw.get("num_experts") else dense
        spec = P("data", "seq") if "seq" in mesh_kw else P("data", None)
        logits = jax.jit(_compat.shard_map(
            lambda p, t: jt.forward(p, t, cfg, ax)[0], mesh=mesh,
            in_specs=(P(), spec), out_specs=P("data", "seq", None)
            if "seq" in mesh_kw else P("data", None, None),
            check_vma=False))(params, batch[0])
        loss_fn = jt.make_loss_fn(cfg, ax, mesh_axes=mesh.axis_names)
        sm = _compat.shard_map(loss_fn, mesh=mesh, in_specs=(P(), spec),
                               out_specs=P(), check_vma=False)
        loss, grads = jax.jit(jax.value_and_grad(sm))(params, batch)
        ref[name] = (np.asarray(logits), float(loss),
                     dict((k, np.asarray(v)) for k, v in _named(grads)))
    name, mesh_kw, ax_kw = SGD_CASE
    mesh = jmake_mesh(**mesh_kw, devices=jax.devices()[:N])
    loss_fn = jt.make_loss_fn(_jcfg({}), jt.ParallelAxes(**ax_kw),
                              mesh_axes=mesh.axis_names)
    opt = optax.sgd(LR)
    step = jmake_parallel_train_step(loss_fn, opt, mesh, P("data", "seq"),
                                     donate=False)
    params = jax.tree_util.tree_map(jnp.asarray, dense)
    sharded = jshard_parallel_batch(batch, mesh, P("data", "seq"))
    state = opt.init(params)
    losses = []
    for _ in range(3):
        params, state, loss = step(params, state, sharded)
        losses.append(float(loss))
    ref["sgd"] = (np.array(losses),
                  dict((k, np.asarray(v)) for k, v in _named(params)))
    return ref


def _single_rank(dense, moe, tokens, targets):
    """The port on one rank (no mesh): logits, loss and gradients."""
    out = {}
    batch = (torch.from_numpy(tokens).long(),
             torch.from_numpy(targets).long())
    for name, _mesh_kw, _ax_kw, cfg_kw in CASES:
        moe_case = bool(cfg_kw.get("num_experts"))
        cfg = _tcfg(cfg_kw)
        ax = tt.ParallelAxes(expert="data") if moe_case \
            else tt.ParallelAxes(data=None)
        params = params_from_jax(moe if moe_case else dense)
        logits = tt.forward(params, batch[0], cfg, ax)
        loss = tt.make_loss_fn(cfg, ax)(params, batch)
        loss.backward()
        out[name] = (logits.detach().numpy(), float(loss.detach()),
                     {k: v.grad.numpy() for k, v in tree_named_leaves(params)})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_transformer")
    dense, moe, tokens, targets = _inputs()
    data_path = tmp / "data.npz"
    np.savez(data_path, tokens=tokens, targets=targets,
             **_flat(dense, "dense"), **_flat(moe, "moe"))
    script = tmp / "worker.py"
    script.write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    for k in ("RANK", "WORLD_SIZE", "HVD_TPU_FUSE", "HVD_TPU_FUSE_CHUNKS"):
        env.pop(k, None)
    spec = json.dumps({"cases": CASES, "sgd": SGD_CASE, "cfg": CFG,
                       "lr": LR, "batch_spec": SPEC})
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(tmp / "store"),
         str(data_path), str(tmp / f"out{r}.npz"), spec],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for r in range(N)]
    logs = []
    try:
        ref = _reference(dense, moe, tokens, targets)
        single = _single_rank(dense, moe, tokens, targets)
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in log, log
    outs = [dict(np.load(tmp / f"out{r}.npz")) for r in range(N)]
    return ref, single, outs


def _local(full, out, name):
    """This rank's block of the full [batch, seq, vocab] logits."""
    logits = out[f"{name}.logits"]
    b, s = logits.shape[:2]
    di, si = (int(c) for c in out[f"{name}.coords"])
    return full[di * b:(di + 1) * b, si * s:(si + 1) * s]


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_parallel_forward_matches_reference_and_single_rank(runs, case):
    ref, single, outs = runs
    for out in outs:
        _close(out[f"{case}.logits"], _local(ref[case][0], out, case),
               f"{case} logits vs reference")
        _close(out[f"{case}.logits"], _local(single[case][0], out, case),
               f"{case} logits vs single rank")


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_parallel_loss_and_gradients_match(runs, case):
    ref, single, outs = runs
    _, ref_loss, ref_grads = ref[case]
    _, one_loss, one_grads = single[case]
    assert set(ref_grads) == set(one_grads)
    # The MoE aux loss is each shard's (its tokens' fractions), averaged:
    # not the one-rank aux of all the tokens, in the reference too.
    vs_single = not case.startswith("moe")
    for out in outs:
        _close(out[f"{case}.loss"], ref_loss, f"{case} loss")
        if vs_single:
            _close(out[f"{case}.loss"], one_loss, f"{case} loss vs single")
        for leaf in ref_grads:
            got = out[f"{case}.grad.{leaf}"]
            _close(got, ref_grads[leaf], f"{case} grad {leaf}")
            if vs_single:
                _close(got, one_grads[leaf], f"{case} grad {leaf} vs single")
            assert got.tobytes() == outs[0][f"{case}.grad.{leaf}"].tobytes()


def test_moe_gradients_reach_router_and_experts(runs):
    _, _, outs = runs
    for leaf in ("router", "moe_w_in", "moe_w_out"):
        g = outs[0][f"moe_ep4.grad.layers/{leaf}"]
        assert np.all(np.isfinite(g)) and np.any(g != 0), leaf


def test_three_sgd_steps_match_reference(runs):
    ref, _, outs = runs
    losses, params = ref["sgd"]
    for out in outs:
        _close(out["sgd.losses"], losses, "sgd losses")
        for leaf, want in params.items():
            _close(out[f"sgd.param.{leaf}"], want, f"sgd param {leaf}")
    assert outs[0]["sgd.losses"][-1] < outs[0]["sgd.losses"][0]


def test_moe_needs_an_expert_or_data_axis():
    cfg = _tcfg(MOE)
    params = tt.init_transformer(torch.Generator().manual_seed(0), cfg)
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="MoE needs an expert"):
        tt.forward(params, tokens, cfg, tt.ParallelAxes(data=None))


def test_moe_tree_round_trips_bitwise_through_convert():
    _, moe, _, _ = _inputs()
    params = params_from_jax(moe)
    assert {k for k, _ in tree_named_leaves(params)} == \
        {k for k, _ in _named(moe)}
    for (name, want), (_, got) in zip(_named(moe),
                                      _named(params_to_numpy(params))):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), \
            name
    layers = params["layers"]
    assert tuple(layers["router"].shape) == (2, 32, 4)
    assert tuple(layers["moe_w_in"].shape) == (2, 4, 32, 64)
    assert tuple(layers["moe_w_out"].shape) == (2, 4, 64, 32)
    # init_moe_params' dict, both ways and in bf16 (16-bit patterns).
    jp = jax.tree_util.tree_map(np.asarray, jexp.init_moe_params(
        jax.random.PRNGKey(2), 8, 16, 32, dtype=jnp.bfloat16))
    back = params_to_numpy(params_from_jax(jp))
    for k in jp:
        assert back[k].dtype == jp[k].dtype and \
            back[k].tobytes() == jp[k].tobytes(), k
    mine = texp.init_moe_params(torch.Generator().manual_seed(0), 8, 16, 32)
    again = params_from_jax(params_to_numpy(mine))
    for k in mine:
        assert torch.equal(again[k], mine[k]), k


def test_port_moe_init_matches_reference_shapes_and_scales():
    cfg = _tcfg(MOE)
    params = tt.init_transformer(torch.Generator().manual_seed(0), cfg)
    _, moe, _, _ = _inputs()
    for (name, want), (_, got) in zip(_named(moe), tree_named_leaves(params)):
        assert tuple(got.shape) == want.shape, name
        if want.std() > 0:
            assert abs(float(got.detach().std()) / float(want.std()) - 1) \
                < 0.1, name
