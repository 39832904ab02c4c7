"""horovod_tpu_torch's pipeline parallelism (parallel/pipeline.py) against
horovod_tpu's: every case of tests/test_pipeline_parallel.py, the
pipe-axis transformer tests of tests/test_transformer.py, and port-only
cases.

One spawned job of 4 gloo ranks runs the port's multi-rank cases; the
parent runs the reference on 4 of the conftest's CPU devices, where
device ``i`` is rank ``i``.  Weights and batches are the reference
test's own (its helpers, drawn with ``jax.random``), carried across with
``utils/convert.py``.  Tolerances are the reference's: the GPipe ticks
1e-5 against the sequential stages (gradients 1e-4); the pipeline step's
loss rtol 1e-5 and parameters rtol 2e-5, atol 2e-6; placed against
unplaced loss rtol 1e-6; the transformer 2e-4.  The chained LM step
(port-only) is held within 1e-4 of the largest magnitude of what it is
compared with, as tests/test_torch_parallel_transformer.py holds the
transformer.  Inside the port, 1F1B, GPipe and interleaved runs are
bitwise equal, unplaced and placed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd_api
import horovod_tpu_torch as thvd
import test_pipeline_parallel as RT
from gloo_job import GlooJob, flat, unflat
from horovod_tpu.core import compat as _compat
from horovod_tpu.core.topology import make_mesh as jmake_mesh
from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel import pipeline as JPL
from horovod_tpu.parallel.training import shard_batch
from horovod_tpu_torch.core.topology import Mesh, MeshAxis
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.parallel import pipeline as PL

N = 4
D = RT._D
TOL = RT.TOL
LOSS_RTOL, P_RTOL, P_ATOL = 1e-5, 2e-5, 2e-6
GPIPE_CASES = [(2, 2), (4, 4), (4, 8)]
LM_CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_seq_len=128)

WORKER = """
import weakref

from horovod_tpu_torch.core.topology import Mesh, make_mesh
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.ops import collective as C
from horovod_tpu_torch.parallel import pipeline as PL
from horovod_tpu_torch.parallel.axis_ops import pmean_loss, reduce_gradients
from horovod_tpu_torch.parallel.overlap import ChainedLoss
from horovod_tpu_torch.parallel.tensor import local_shard, tp_mlp

out = {}
leaves = hvd.tree_leaves


def T(key, grad=False):
    return torch.from_numpy(D[key]).requires_grad_(grad)


def stage_fn(p, x):
    w, b = p
    return torch.tanh(x @ w + b)


def st0(p, c, b):
    return torch.tanh(b[0] @ p["w"] + p["b"])


def stm(p, c, b):
    return torch.tanh(c @ p["w"] + p["b"])


def stl(p, c, b):
    return torch.mean((c @ p["w"] + p["b"] - b[1]) ** 2)


def chain(n=4):
    return ChainedLoss([st0] + [stm] * (n - 2) + [stl])


def pp(prefix, n=4):
    return [tree(f"{prefix}/{k}") for k in range(n)]


ADAM = lambda ps: torch.optim.Adam(ps, lr=1e-3)  # noqa: E731
SGD = lambda ps: torch.optim.SGD(ps, lr=0.1)  # noqa: E731


def run(tag, ch, params, opt, batch, steps, **kw):
    step = PL.make_pipeline_train_step(ch, opt, **kw)
    s = step.init(params)
    losses = []
    for _ in range(steps):
        params, s, loss = step(params, s, batch)
        losses.append(float(loss))
    out[f"{tag}.losses"] = losses
    for k in step._replica:
        out.update(flat(f"{tag}.p{k}", params[k]))
    return step, params, s


m44 = make_mesh(pipe=4)
m22 = make_mesh(data=2, pipe=2)

# -- GPipe ticks --------------------------------------------------------------
for n, m in ((2, 2), (4, 4), (4, 8)):
    ax = (m22 if n == 2 else m44).axis("pipe")
    mine = PL.select_stage_params((T(f"gp{n}/w"), T(f"gp{n}/b")), axis=ax)
    out[f"gpipe.{n}_{m}"] = PL.gpipe(stage_fn, mine, T("gp_x"),
                                     num_microbatches=m, axis=ax).numpy()

ax = m44.axis("pipe")
w, b = T("gg/w", True), T("gg/b", True)
y = PL.gpipe(stage_fn, PL.select_stage_params((w, b), axis=ax), T("gg_x"),
             num_microbatches=4, axis=ax)
pmean_loss((y ** 2).sum(), m44).backward()
reduce_gradients([w, b], m44)
out["gg.w"], out["gg.b"] = w.grad.numpy(), b.grad.numpy()

dax = m22.axis("data")
x = T("dp_x")
rows = x.shape[0] // 2
out["dp.out"] = PL.gpipe(
    stage_fn, PL.select_stage_params((T("dp/w"), T("dp/b")),
                                     axis=m22.axis("pipe")),
    x[dax.index * rows:(dax.index + 1) * rows], num_microbatches=2,
    axis=m22.axis("pipe")).numpy()
out["dp.data_index"] = dax.index

out["stage_index"] = PL.stage_index(ax)
sel = PL.select_stage_params({"w": torch.arange(12.).reshape(4, 3),
                              "b": torch.arange(4.)}, axis=ax)
out["select.w"], out["select.b"] = sel["w"].numpy(), sel["b"].numpy()

# play_gpipe against the gloo gpipe, the cotangent entering at the last
# stage.
w, b = T("gp4/w", True), T("gp4/b", True)
xg = T("gp_x", True)
y = PL.gpipe(stage_fn, PL.select_stage_params((w, b), axis=ax), xg,
             num_microbatches=8, axis=ax)
ct = T("play_ct") if ax.index == 3 else torch.zeros_like(y)
torch.autograd.backward(y, ct)
out["play.real.y"] = y.detach().numpy()
out["play.real.w"], out["play.real.b"] = w.grad[ax.index].numpy(), \\
    b.grad[ax.index].numpy()
out["play.real.x"] = xg.grad.numpy()
w2, b2 = T("gp4/w", True), T("gp4/b", True)
x2 = T("gp_x", True)
yp = PL.play_gpipe(stage_fn, [(w2[k], b2[k]) for k in range(4)], x2, n=4,
                   num_microbatches=8)
yp.backward(T("play_ct"))
out["play.y"], out["play.w"], out["play.b"], out["play.x"] = (
    yp.detach().numpy(), w2.grad.numpy(), b2.grad.numpy(), x2.grad.numpy())

# -- The transformer's pipe axis (data 2 x pipe 2) ---------------------------
cfg = tt.TransformerConfig(**LM_CFG)
ax2 = tt.ParallelAxes(data="data", pipe="pipe", num_microbatches=2)
tokens = torch.from_numpy(D["tf.tokens"]).long()
rows = tokens.shape[0] // 2
out["tf.logits"] = tt.forward(
    tree("tf"), tokens[dax.index * rows:(dax.index + 1) * rows], cfg, ax2,
    mesh=m22).detach().numpy()

# -- The unplaced step ------------------------------------------------------
batch = (T("b4/x"), T("b4/y"))
kw = dict(num_microbatches=4, fusion_threshold=_D * _D * 4)
for sched, v in (("1f1b", 1), ("gpipe", 1), ("1f1b", 2)):
    step, _, _ = run(f"bit.{sched}{v}", chain(), pp("pp"), ADAM, batch, 3,
                     schedule=sched, interleave=v, **kw)
    out[f"bit.{sched}{v}.buckets"] = step.bucket_count
for v in (1, 2):
    run(f"il.{v}", chain(), pp("pp"), SGD, batch, 2, schedule="1f1b",
        interleave=v, **kw)
run("mono", chain(), pp("pp"), SGD, batch, 1, num_microbatches=4,
    schedule="1f1b")

step = PL.make_pipeline_train_step(chain(), SGD, schedule="1f1b", **kw)
p = pp("pp")
s = step.init(p)
for _ in range(2):
    p, s, _ = step(p, s, batch)
stats = C._runtime().cache.stats
out["cache.before"] = [stats.misses, stats.replayed_tensors]
p, s, _ = step(p, s, batch)
out["cache.after"] = [stats.misses, stats.replayed_tensors]

b8 = (T("b8/x"), T("b8/y"))
for sched in ("1f1b", "gpipe"):
    step, _, _ = run(f"tel.{sched}", chain(3), pp("pp3", 3), SGD, b8, 1,
                     num_microbatches=8, schedule=sched)
    st = step.stats()
    out[f"tel.{sched}.micro"] = st["pipeline.microbatches"]
    out[f"tel.{sched}.bubble_count"] = st["pipeline.bubble_seconds"]["count"]
    out[f"tel.{sched}.peak"] = st["pipeline.inflight_activations"]
    out[f"tel.{sched}.peak_bytes"] = st["pipeline.inflight_activation_bytes"]
    out[f"tel.{sched}.plan_peak"] = step.plan.peak_activations

for tag, m, n_rows in (("val.m", 3, 4 * N), ("val.replica", 2 * N, 2 * N)):
    step = PL.make_pipeline_train_step(chain(), SGD, num_microbatches=m)
    z = torch.zeros(n_rows, _D)
    p = pp("pp")
    try:
        step(p, step.init(p), (z, z))
    except ValueError as e:
        out[tag] = str(e)

# Recompute: each stage's forward runs twice a microbatch, once without
# a graph; no forward's graph is alive when the next stage call starts.
calls = {}
f_refs = []
worst = [0]


def watched(k, fn):
    def stage(p, c, b):
        worst[0] = max(worst[0], sum(r() is not None for r in f_refs))
        calls.setdefault((k, torch.is_grad_enabled()), 0)
        calls[(k, torch.is_grad_enabled())] += 1
        # h, the stage's product's input, is what a graph would keep.
        if c is not None:
            h = c * 2.0 * 0.5
            out_ = fn(p, h, b)
        else:
            h = b[0] * 2.0 * 0.5
            out_ = fn(p, c, (h, b[1]))
        if not torch.is_grad_enabled():
            f_refs.append(weakref.ref(h))
        return out_
    return stage


ch = ChainedLoss([watched(k, f) for k, f in enumerate([st0, stm, stm, stl])])
step = PL.make_pipeline_train_step(ch, SGD, num_microbatches=4,
                                   schedule="1f1b")
p = pp("pp")
step(p, step.init(p), batch)
out["recompute.calls"] = [[calls.get((k, g), 0) for g in (False, True)]
                          for k in range(4)]
out["recompute.alive"] = worst[0]

# The chained LM loss through 1F1B.
lm = tt.chained_lm_loss(cfg)
lmp = tt.chained_lm_params(tree("tf"), cfg)
lmb = (torch.from_numpy(D["lm.tokens"]).long(),
       torch.from_numpy(D["lm.targets"]).long())
run("lm", lm, lmp, SGD, lmb, 2, num_microbatches=2, schedule="1f1b")

# -- Placed ------------------------------------------------------------------
meshes = PL.stage_submeshes(4)
out["sub.ranks"] = [m.ranks.reshape(-1).tolist() for m in meshes]
mp = PL.stage_submeshes(2, model=2)
out["sub.mp_shape"] = [list(m.shape) for m in mp]
out["sub.mp_names"] = [list(m.axis_names) for m in mp]
for tag, args in (("sub.err3", (3,)), ("sub.err_model", (4, 3))):
    try:
        PL.stage_submeshes(args[0], model=args[1] if len(args) > 1 else 1)
    except ValueError as e:
        out[tag] = str(e)

pb = (T("pb/x"), T("pb/y"))
for sched, v in (("1f1b", 1), ("gpipe", 1), ("1f1b", 2)):
    step, _, _ = run(f"placed.{sched}{v}", chain(), pp("pp"), ADAM, pb, 3,
                     num_microbatches=4, schedule=sched, interleave=v,
                     stage_meshes=meshes)
out["placed.mine"] = step._mine
out["placed.placed"] = step.placed and step.stage_meshes == meshes

step = PL.make_pipeline_train_step(chain(), SGD, num_microbatches=4,
                                   stage_meshes=meshes)
p = pp("pp")
s = step.init(p)
p1, s1, _ = step(p, s, pb)
out["own.changed"] = [any(not torch.equal(a.detach(), b.detach())
                          for a, b in zip(leaves(p1[k]), leaves(pp("pp")[k])))
                      for k in range(4)]
out["own.opt_none"] = [o is None for o in s1]

pu = (T("pu/x"), T("pu/y"))
run("pvu.placed", chain(), pp("pp"), SGD, pu, 1, num_microbatches=4,
    stage_meshes=meshes)
run("pvu.unplaced", chain(), pp("pp"), SGD, pu, 1, num_microbatches=4)


def mp_stage0(p, c, b):
    ax = mp[0].axis("model")
    return tp_mlp(b[0], local_shard(p["w"], 1, axis=ax), None,
                  local_shard(p["w2"], 0, axis=ax), None, axis=ax)


def plain_stage0(p, c, b):
    return torch.nn.functional.gelu(b[0] @ p["w"],
                                    approximate="tanh") @ p["w2"]


mpb = (T("mpb/x"), T("mpb/y"))
for sched in ("1f1b", "gpipe"):
    run(f"mp.{sched}", ChainedLoss([mp_stage0, stl]), pp("mpp", 2), SGD,
        mpb, 2, num_microbatches=4, schedule=sched, stage_meshes=mp)
run("mp.plain", ChainedLoss([plain_stage0, stl]), pp("mpp", 2), SGD, mpb, 2,
    num_microbatches=4, schedule="1f1b")

# A mesh without the data (replica) axis.
no_data = Mesh(axis_names=("pipe",), shape=(4,), ranks=np.arange(4),
               axes=(), group=None)
for tag, kw in (("pval.count", dict(stage_meshes=PL.stage_submeshes(2))),
                ("pval.replica", dict(stage_meshes=[no_data] * 4))):
    try:
        PL.make_pipeline_train_step(chain(), SGD, num_microbatches=4, **kw)
    except ValueError as e:
        out[tag] = str(e)
step = PL.make_pipeline_train_step(chain(), SGD, num_microbatches=4,
                                   stage_meshes=meshes)
try:
    p = pp("pp")
    step(p, SGD(leaves(p)), pb)
except ValueError as e:
    out["pval.opt_state"] = str(e)
finish(out)
"""


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _stage_list(prefix, params):
    data = {}
    for k, p in enumerate(params):
        data.update(flat(_np(p), f"{prefix}/{k}"))
    return data


def _inputs():
    data = {}
    for n in (2, 4):
        w, b = RT._stacked_params(n, 8)
        data[f"gp{n}/w"], data[f"gp{n}/b"] = np.asarray(w), np.asarray(b)
    data["gp_x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                (16, 8)))
    data["play_ct"] = np.asarray(jax.random.normal(jax.random.PRNGKey(9),
                                                   (16, 8)))
    w, b = RT._stacked_params(4, 8, seed=2)
    data["gg/w"], data["gg/b"] = np.asarray(w), np.asarray(b)
    data["gg_x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                                (8, 8)))
    w, b = RT._stacked_params(2, 8, seed=4)
    data["dp/w"], data["dp/b"] = np.asarray(w), np.asarray(b)
    data["dp_x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(5),
                                                (8, 8)))
    params, tokens, _ = _tf_data()
    data.update(flat(_np(params), "tf"))
    data["tf.tokens"] = np.asarray(tokens)
    lm_tok, lm_tgt = jt.synthetic_lm_batch(jax.random.PRNGKey(11), 8, 16,
                                           LM_CFG["vocab_size"])
    data["lm.tokens"], data["lm.targets"] = (np.asarray(lm_tok),
                                             np.asarray(lm_tgt))
    data.update(_stage_list("pp", RT._pipe_params(jax.random.PRNGKey(0))))
    data.update(_stage_list("pp3", RT._pipe_params(jax.random.PRNGKey(0),
                                                   3)))
    for tag, m in (("b4", 4), ("b8", 8)):
        kx, ky = jax.random.split(jax.random.PRNGKey(1))
        B = N * m * 2
        data[f"{tag}/x"] = np.asarray(jax.random.normal(kx, (B, D)))
        data[f"{tag}/y"] = np.asarray(jax.random.normal(ky, (B, D)))
    for tag, (n_rep, per_mb) in (("pb", (1, 2)), ("pu", (N, 1)),
                                 ("mpb", (2, 2))):
        x, y = RT._placed_batch(n_rep, per_mb=per_mb)
        data[f"{tag}/x"], data[f"{tag}/y"] = np.asarray(x), np.asarray(y)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    data.update(_stage_list("mpp", [
        {"w": jax.random.normal(k1, (D, D)) * D ** -0.5,
         "w2": jax.random.normal(k2, (D, D)) * D ** -0.5},
        {"w": jax.random.normal(k3, (D, D)) * D ** -0.5,
         "b": jnp.zeros((D,))}]))
    return data


def _tf_data():
    cfg = jt.TransformerConfig(**LM_CFG, block_q=16, block_k=16)
    kp, kd = jax.random.split(jax.random.PRNGKey(0))
    params = jt.init_transformer(kp, cfg)
    tokens, targets = jt.synthetic_lm_batch(kd, 8, 32, cfg.vocab_size)
    return params, tokens, targets


def _ref_steps(chain, params, opt, batch, steps, **kw):
    step = JPL.make_pipeline_train_step(chain, opt, **kw)
    placed = kw.get("stage_meshes") is not None
    p = params
    s = [opt.init(q) for q in p] if placed else opt.init(p)
    for _ in range(steps):
        p, s, loss = step(p, s, batch)
    return float(loss), [_np(q) for q in p]


def _reference(data):
    """The reference on 4 devices."""
    ref = {}
    devs = jax.devices()[:N]
    for n, m in GPIPE_CASES:
        mesh = jmake_mesh(pipe=n, devices=devs[:n])
        params = (jnp.asarray(data[f"gp{n}/w"]), jnp.asarray(data[f"gp{n}/b"]))
        x = jnp.asarray(data["gp_x"])

        def run(params, x, m=m):
            return JPL.gpipe(RT._stage_fn, JPL.select_stage_params(params),
                             x, num_microbatches=m)

        ref[f"gpipe.{n}_{m}"] = np.asarray(jax.jit(_compat.shard_map(
            run, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
            check_vma=False))(params, x))
        ref[f"seq.{n}"] = np.asarray(RT._sequential(params, x))

    mesh = jmake_mesh(pipe=4, devices=devs)
    params = (jnp.asarray(data["gg/w"]), jnp.asarray(data["gg/b"]))
    x = jnp.asarray(data["gg_x"])
    sm = _compat.shard_map(
        lambda p, x: JPL.gpipe(RT._stage_fn, JPL.select_stage_params(p), x,
                               num_microbatches=4),
        mesh=mesh, in_specs=(P(), P()), out_specs=P(), check_vma=False)
    ref["gg"] = [np.asarray(g) for g in jax.jit(
        jax.grad(lambda p: jnp.sum(sm(p, x) ** 2)))(params)]
    ref["gg.seq"] = [np.asarray(g) for g in jax.grad(
        lambda p: jnp.sum(RT._sequential(p, x) ** 2))(params)]

    mesh = jmake_mesh(data=2, pipe=2, devices=devs)
    params = (jnp.asarray(data["dp/w"]), jnp.asarray(data["dp/b"]))
    x = jnp.asarray(data["dp_x"])
    ref["dp"] = np.asarray(jax.jit(_compat.shard_map(
        lambda p, x: JPL.gpipe(RT._stage_fn, JPL.select_stage_params(p), x,
                               num_microbatches=2),
        mesh=mesh, in_specs=(P(), P("data")), out_specs=P("data"),
        check_vma=False))(params, x))
    ref["dp.seq"] = np.asarray(RT._sequential(params, x))

    # The transformer's pipe axis, and one device.
    tparams, tokens, _ = _tf_data()
    cfg = jt.TransformerConfig(**LM_CFG, block_q=16, block_k=16)
    ax = jt.ParallelAxes(data="data", pipe="pipe", num_microbatches=2)
    ref["tf"] = np.asarray(jax.jit(_compat.shard_map(
        lambda p, t: jt.forward(p, t, cfg, ax)[0], mesh=mesh,
        in_specs=(P(), P("data", None)), out_specs=P("data", None, None),
        check_vma=False))(tparams, tokens))
    ref["tf.single"] = np.asarray(jt.forward(
        tparams, tokens, cfg, jt.ParallelAxes(data=None))[0])

    # The pipeline step.
    chain = RT._pipe_chain()
    params = RT._pipe_params(jax.random.PRNGKey(0))
    batch, (x, y), B = RT._pipe_batch(hvd_api, jax.random.PRNGKey(1))
    kw = dict(num_microbatches=4, fusion_threshold=D * D * 4)
    ref["bit"] = _ref_steps(chain, params, optax.adam(1e-3), batch, 3,
                            schedule="1f1b", **kw)
    ref["il"] = _ref_steps(chain, params, optax.sgd(0.1), batch, 2,
                           schedule="1f1b", interleave=2, **kw)
    ref["mono"] = _ref_steps(chain, params, optax.sgd(0.1), batch, 1,
                             num_microbatches=4, schedule="1f1b")
    m = 4

    def mb_of(arr, i):
        lb = B // N
        return jnp.concatenate(
            [arr[r * lb:(r + 1) * lb].reshape(m, lb // m, D)[i]
             for r in range(N)], 0)

    def ref_loss(p):
        return sum(chain(p, (mb_of(x, i), mb_of(y, i)))
                   for i in range(m)) / m

    ref["mono.loss"] = float(ref_loss(params))
    ref["mono.grad"] = [np.asarray(g) for g in jax.tree_util.tree_leaves(
        jax.grad(ref_loss)(params))]

    meshes = JPL.stage_submeshes(4)
    ref["placed"] = _ref_steps(
        chain, params, optax.adam(1e-3),
        tuple(jnp.asarray(data[f"pb/{k}"]) for k in "xy"), 3,
        num_microbatches=4, schedule="1f1b", stage_meshes=meshes)
    ref["sub.mp_shape"] = [[int(mk.shape[a]) for a in mk.axis_names]
                           for mk in JPL.stage_submeshes(2, model=2)]

    lm_cfg = jt.TransformerConfig(**LM_CFG, block_q=16, block_k=16)
    lm = jt.chained_lm_loss(lm_cfg)
    lm_batch = shard_batch((jnp.asarray(data["lm.tokens"]),
                            jnp.asarray(data["lm.targets"])))
    ref["lm"] = _ref_steps(lm, jt.chained_lm_params(tparams, lm_cfg),
                           optax.sgd(0.1), lm_batch, 2, num_microbatches=2,
                           schedule="1f1b")
    ref["plans"] = {(sched, S, m, v): JPL.schedule_plan(S, m, sched, v)
                    for sched in ("1f1b", "gpipe")
                    for S, m, v in PLAN_CASES}
    return ref


PLAN_CASES = [(2, 2, 1), (4, 8, 1), (4, 8, 2), (4, 4, 4), (8, 4, 2),
              (3, 5, 1)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = _inputs()
    job = GlooJob(tmp_path_factory.mktemp("pipeline"),
                  f"LM_CFG = {LM_CFG!r}\n_D = {D}\n" + WORKER, N, data)
    try:
        hvd_api.init(devices=jax.devices()[:N])
        try:
            ref = _reference(data)
        finally:
            hvd_api.shutdown()
    except BaseException:
        job.kill()
        raise
    return data, ref, job.results()


def _leaves_close(got, want, rtol, atol, what):
    assert len(got) == len(want), what
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def _params(out, tag, k):
    """Stage ``k``'s leaves of ``tag`` in the reference's leaf order."""
    return [v for _, v in sorted(unflat(out, f"{tag}.p{k}").items())]


def _all_params(out, tag, n=4):
    return [leaf for k in range(n) for leaf in _params(out, tag, k)]


def _ref_leaves(ref_params):
    return [np.asarray(leaf) for p in ref_params
            for leaf in jax.tree_util.tree_leaves(p)]


def _bitwise(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# GPipe ticks over the pipe axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_stages,n_micro", GPIPE_CASES)
def test_gpipe_matches_sequential(runs, n_stages, n_micro):
    _, ref, outs = runs
    want = ref[f"seq.{n_stages}"]
    for out in outs:
        got = out[f"gpipe.{n_stages}_{n_micro}"]
        assert np.max(np.abs(got - want)) < TOL
        assert np.max(np.abs(got - ref[f"gpipe.{n_stages}_{n_micro}"])) \
            < TOL


def test_gpipe_gradients_match_sequential(runs):
    """The loss on the replicated output averaged over the axis
    (pmean_loss), each stage's gradients summed over it: the sequential
    gradient, not n times it (the final psum's backward is a psum of
    the ranks' 1/n cotangents)."""
    _, ref, outs = runs
    for out in outs:
        for got, want, seq in zip((out["gg.w"], out["gg.b"]), ref["gg"],
                                  ref["gg.seq"]):
            assert np.max(np.abs(got - seq)) < 1e-4
            assert np.max(np.abs(got - want)) < 1e-4


def _axis(n, index=0):
    return MeshAxis(name="pipe", size=n, index=index, ranks=tuple(range(n)))


def test_gpipe_rejects_indivisible_microbatches():
    w = torch.zeros(2, 4, 4)
    b = torch.zeros(2, 4)
    ax = _axis(2)
    with pytest.raises(ValueError, match="not divisible"):
        PL.gpipe(lambda p, x: x, PL.select_stage_params((w, b), axis=ax),
                 torch.zeros(6, 4), num_microbatches=4, axis=ax)


def test_stage_index(runs):
    _, _, outs = runs
    assert [int(out["stage_index"]) for out in outs] == [0, 1, 2, 3]


def test_gpipe_composes_with_data_parallel(runs):
    _, ref, outs = runs
    for out in outs:
        di = int(out["dp.data_index"])
        got = out["dp.out"]
        rows = got.shape[0]
        for want in (ref["dp"], ref["dp.seq"]):
            assert np.max(np.abs(got - want[di * rows:(di + 1) * rows])) \
                < TOL


def test_gpipe_error_names_axis_and_nearest_counts():
    ax = _axis(2)
    with pytest.raises(ValueError) as ei:
        PL.gpipe(lambda p, x: x, None, torch.zeros(6, 4), num_microbatches=4,
                 axis=ax)
    msg = str(ei.value)
    assert "size 6" in msg and "num_microbatches=4" in msg
    assert "3 or 6" in msg
    assert msg == JPL._indivisible_message("batch", 6, 4)


def test_select_stage_params_pytree(runs):
    _, _, outs = runs
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["select.w"], w[r])
        assert float(out["select.b"]) == float(r)


# ---------------------------------------------------------------------------
# The schedule plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["1f1b", "gpipe"])
@pytest.mark.parametrize("S,m,v", PLAN_CASES)
def test_schedule_plan_valid(schedule, S, m, v):
    """Valid (the reference test's checks), and the reference's plan tick
    for tick."""
    plan = PL.schedule_plan(S, m, schedule, v)
    RT._check_plan_valid(plan)
    want = JPL.schedule_plan(S, m, schedule, v)
    assert [[tuple(a) for a in t] for t in plan.ticks] == \
        [[tuple(a) for a in t] for t in want.ticks]
    assert (plan.bubble_ticks, plan.peak_activations, plan.n_executors,
            plan.bubble_fraction) == (want.bubble_ticks,
                                      want.peak_activations,
                                      want.n_executors, want.bubble_fraction)


def test_schedule_plan_1f1b_bounds_activation_memory():
    f = PL.schedule_plan(4, 16, "1f1b")
    g = PL.schedule_plan(4, 16, "gpipe")
    assert g.peak_activations == (4 - 1) * 16
    assert f.peak_activations <= 3 * 4
    assert f.peak_activations < g.peak_activations


def test_schedule_plan_interleave_shrinks_bubble():
    flat1 = PL.schedule_plan(4, 8, "1f1b", interleave=1)
    inter = PL.schedule_plan(4, 8, "1f1b", interleave=2)
    assert inter.bubble_fraction < flat1.bubble_fraction
    flat4 = PL.schedule_plan(4, 4, "1f1b", interleave=1)
    inter4 = PL.schedule_plan(8, 4, "1f1b", interleave=2)
    assert flat4.n_executors == inter4.n_executors == 4
    assert inter4.bubble_fraction < flat4.bubble_fraction


def test_schedule_plan_validation():
    with pytest.raises(ValueError, match="does not divide"):
        PL.schedule_plan(4, 8, "1f1b", interleave=3)
    with pytest.raises(ValueError, match="nearest valid interleave"):
        PL.schedule_plan(6, 8, "1f1b", interleave=4)
    with pytest.raises(ValueError, match="expected one of"):
        PL.schedule_plan(4, 8, "zigzag")
    with pytest.raises(ValueError, match=">= 1"):
        PL.schedule_plan(0, 8)


def test_schedule_plan_gpt2_figures():
    """The 14-stage GPT-2-small pipeline of chip_smoke.py at 8
    microbatches: ticks, bubble and peak carries as the reference's."""
    for sched, v, ticks, peak in (("gpipe", 1, 42, 104), ("1f1b", 1, 42, 83),
                                  ("1f1b", 2, 48, 83)):
        plan = PL.schedule_plan(14, 8, sched, v)
        want = JPL.schedule_plan(14, 8, sched, v)
        assert (plan.total_ticks, plan.peak_activations) == (ticks, peak)
        assert plan.bubble_fraction == want.bubble_fraction


# ---------------------------------------------------------------------------
# The knobs
# ---------------------------------------------------------------------------

def test_pipeline_env_knobs(monkeypatch):
    monkeypatch.setenv(PL.SCHEDULE_ENV, "bogus")
    with pytest.raises(ValueError, match="HVD_TPU_PIPELINE_SCHEDULE"):
        PL.validate_env()
    monkeypatch.setenv(PL.SCHEDULE_ENV, "gpipe")
    monkeypatch.setenv(PL.INTERLEAVE_ENV, "x")
    with pytest.raises(ValueError, match="HVD_TPU_PIPELINE_INTERLEAVE"):
        PL.validate_env()
    monkeypatch.setenv(PL.INTERLEAVE_ENV, "2")
    PL.validate_env()
    assert PL.schedule_plan(4, 4).schedule == "gpipe"
    assert PL.schedule_plan(4, 4).interleave == 2
    monkeypatch.delenv(PL.SCHEDULE_ENV)
    monkeypatch.delenv(PL.INTERLEAVE_ENV)
    assert PL.schedule_plan(4, 4).schedule == "1f1b"


def test_pipeline_knobs_in_hello_env_fingerprint(monkeypatch):
    from horovod_tpu_torch.ops import compression as TC

    assert "HVD_TPU_PIPELINE_SCHEDULE" in TC._SPMD_ENV_KNOBS
    assert "HVD_TPU_PIPELINE_INTERLEAVE" in TC._SPMD_ENV_KNOBS
    monkeypatch.setenv(PL.SCHEDULE_ENV, "1f1b")
    fp_a = TC.env_fingerprint()
    monkeypatch.setenv(PL.SCHEDULE_ENV, "gpipe")
    assert TC.env_fingerprint() != fp_a


def test_env_fingerprint_names_a_rank_with_another_schedule(monkeypatch,
                                                            capsys):
    from horovod_tpu_torch.ops import compression as TC
    from horovod_tpu_torch.ops import transport as TT

    monkeypatch.setenv(PL.SCHEDULE_ENV, "1f1b")
    monkeypatch.setenv(PL.INTERLEAVE_ENV, "2")
    theirs = TC.env_fingerprint().replace(
        "HVD_TPU_PIPELINE_SCHEDULE=1f1b", "HVD_TPU_PIPELINE_SCHEDULE=gpipe")
    TT.check_env_fingerprint(2, TC.env_fingerprint())
    assert "WARNING" not in capsys.readouterr().err
    TT.check_env_fingerprint(2, theirs)
    err = capsys.readouterr().err
    assert "WARNING: rank 2 disagrees with rank 0" in err
    assert "HVD_TPU_PIPELINE_SCHEDULE: rank0=1f1b rank2=gpipe" in err
    assert "HVD_TPU_PIPELINE_INTERLEAVE" not in err


def test_init_rejects_malformed_pipeline_env(monkeypatch):
    monkeypatch.setenv(PL.SCHEDULE_ENV, "sideways")
    with pytest.raises(ValueError, match="HVD_TPU_PIPELINE_SCHEDULE"):
        thvd.init(device="cpu")
    assert not thvd.is_initialized()


def test_init_rejects_malformed_pipeline_interleave(monkeypatch):
    monkeypatch.setenv(PL.INTERLEAVE_ENV, "0")
    with pytest.raises(ValueError, match="HVD_TPU_PIPELINE_INTERLEAVE"):
        thvd.init(device="cpu")
    assert not thvd.is_initialized()


# ---------------------------------------------------------------------------
# The unplaced step
# ---------------------------------------------------------------------------

def test_pipeline_step_1f1b_bitwise_equals_gpipe_leg(runs):
    """1F1B (buckets dispatched at each stage's last backward), GPipe
    (after the flush) and interleaved: losses and parameters bitwise,
    over 3 Adam steps on 4 ranks; against the reference's step."""
    _, ref, outs = runs
    ref_loss, ref_params = ref["bit"]
    for out in outs:
        base = _all_params(out, "bit.gpipe1")
        for tag in ("bit.1f1b1", "bit.1f1b2"):
            assert out[f"{tag}.losses"].tolist() == \
                out["bit.gpipe1.losses"].tolist()
            assert _bitwise(_all_params(out, tag), base)
        assert int(out["bit.1f1b1.buckets"]) >= 2 * 4
        np.testing.assert_allclose(out["bit.1f1b1.losses"][-1], ref_loss,
                                   rtol=LOSS_RTOL)
        _leaves_close(base, _ref_leaves(ref_params), P_RTOL, P_ATOL,
                      "vs the reference")


def test_pipeline_step_interleaved_bitwise(runs):
    _, ref, outs = runs
    for out in outs:
        assert _bitwise(_all_params(out, "il.1"), _all_params(out, "il.2"))
        _leaves_close(_all_params(out, "il.2"), _ref_leaves(ref["il"][1]),
                      P_RTOL, P_ATOL, "interleaved vs the reference")


def test_pipeline_step_matches_monolithic_reference(runs):
    """One SGD step equals p0 - lr * grad(mean-over-microbatches loss)."""
    data, ref, outs = runs
    p0 = [data[f"pp/{k}/{leaf}"] for k in range(4) for leaf in ("b", "w")]
    for out in outs:
        np.testing.assert_allclose(out["mono.losses"][0], ref["mono.loss"],
                                   rtol=1e-5)
        for a, q, g in zip(_all_params(out, "mono"), p0, ref["mono.grad"]):
            np.testing.assert_allclose(a, q - 0.1 * g, rtol=2e-5,
                                       atol=2e-6)
        _leaves_close(_all_params(out, "mono"), _ref_leaves(ref["mono"][1]),
                      P_RTOL, P_ATOL, "vs the reference's step")


def test_pipeline_steady_state_cache_replay(runs):
    """After warm-up every bucket replays from the response cache: a
    further step adds no miss, and rank 0 replays every gradient leaf
    plus the loss."""
    _, _, outs = runs
    for out in outs:
        assert out["cache.after"][0] == out["cache.before"][0]
    replayed = outs[0]["cache.after"][1] - outs[0]["cache.before"][1]
    assert replayed == 2 * 4 + 1


def test_pipeline_telemetry_and_memory(runs):
    """stats(): microbatches count m a step, bubble_seconds one sample a
    step, the peak carries the plan's (1F1B below GPipe, GPipe (S-1)m)."""
    _, _, outs = runs
    m = 8
    for out in outs:
        for sched in ("1f1b", "gpipe"):
            assert int(out[f"tel.{sched}.micro"]) == m
            assert int(out[f"tel.{sched}.bubble_count"]) == 1
            assert int(out[f"tel.{sched}.peak"]) == \
                int(out[f"tel.{sched}.plan_peak"])
        assert int(out["tel.1f1b.peak"]) < int(out["tel.gpipe.peak"])
        assert int(out["tel.gpipe.peak"]) == (3 - 1) * m
        carry = (N * m * 2 // N // m) * D * 4  # one microbatch's carry
        assert int(out["tel.gpipe.peak_bytes"]) == (3 - 1) * m * carry


def test_pipeline_batch_validation_names_counts(runs):
    _, _, outs = runs
    for out in outs:
        msg = str(out["val.m"])
        assert f"size {4 * N}" in msg and "num_microbatches=3" in msg
        assert "nearest valid counts" in msg
        assert "per-replica batch" in str(out["val.replica"])


def test_pipeline_single_stage_rejected():
    with pytest.raises(ValueError, match="at least 2 stages"):
        PL.make_pipeline_train_step(
            [lambda p, c, b: 0], lambda ps: torch.optim.SGD(ps, lr=0.1),
            num_microbatches=2)


def test_stage_forward_runs_twice_and_keeps_no_graph(runs):
    """Each stage's forward runs once without a graph and once, in its
    backward, with one (the in-segment recompute); no forward's
    intermediate is alive when the next stage call starts."""
    _, _, outs = runs
    for out in outs:
        assert out["recompute.calls"].tolist() == [[4, 4]] * 4
        assert int(out["recompute.alive"]) == 0


def test_chained_lm_loss_through_1f1b_matches_reference(runs):
    """GPT-style chained_lm_loss (embedding, 2 layers, head) at a small
    width, 2 SGD steps of the 1F1B step on 4 ranks, against the
    reference's pipeline step."""
    _, ref, outs = runs
    ref_loss, ref_params = ref["lm"]
    want = _ref_leaves(ref_params)
    for out in outs:
        np.testing.assert_allclose(out["lm.losses"][-1], ref_loss, rtol=1e-5)
        got = _all_params(out, "lm")
        assert len(got) == len(want)
        for a, b in zip(got, want):
            scale = max(float(np.max(np.abs(b))), 1e-30)
            assert float(np.max(np.abs(a - b))) <= 1e-4 * scale


# ---------------------------------------------------------------------------
# The transformer's pipe axis
# ---------------------------------------------------------------------------

def test_transformer_pipeline_forward_matches_single_device(runs):
    """ParallelAxes(data, pipe) on data 2 x pipe 2 (tests/test_transformer.py
    test_pipeline_forward_matches_single_device)."""
    _, ref, outs = runs
    for out in outs:
        di = int(out["dp.data_index"])
        got = out["tf.logits"]
        rows = got.shape[0]
        for want in (ref["tf"], ref["tf.single"]):
            assert np.max(np.abs(got - want[di * rows:(di + 1) * rows])) \
                < 2e-4


def test_transformer_pipeline_rejects_indivisible_layers():
    cfg = tt.TransformerConfig(**LM_CFG)
    params = tt.init_transformer(torch.Generator().manual_seed(0), cfg)
    mesh = Mesh(axis_names=("pipe",), shape=(3,), ranks=np.arange(3),
                axes=(_axis(3),), group=None)
    ax = tt.ParallelAxes(data=None, pipe="pipe")
    with pytest.raises(ValueError, match="not divisible"):
        tt.forward(params, torch.zeros((2, 8), dtype=torch.long), cfg, ax,
                   mesh=mesh)


def test_play_gpipe_is_bitwise_the_gloo_gpipe(runs):
    """The ticks played in one process give the 4-rank gloo gpipe's
    output, every stage's gradients and the input's gradient, bit for
    bit, with the output's cotangent entering at the last stage."""
    _, _, outs = runs
    play = outs[0]
    for r, out in enumerate(outs):
        assert np.array_equal(out["play.real.y"], play["play.y"])
        assert np.array_equal(out["play.real.w"], play["play.w"][r])
        assert np.array_equal(out["play.real.b"], play["play.b"][r])
    assert np.array_equal(outs[0]["play.real.x"], play["play.x"])
    for out in outs[1:]:
        assert not out["play.real.x"].any()


# ---------------------------------------------------------------------------
# Placement on stage rank groups
# ---------------------------------------------------------------------------

def test_stage_submeshes_split(runs):
    _, ref, outs = runs
    for out in outs:
        assert out["sub.ranks"].tolist() == [[0], [1], [2], [3]]
        assert out["sub.mp_shape"].tolist() == ref["sub.mp_shape"] \
            == [[1, 2], [1, 2]]
        assert out["sub.mp_names"].tolist() == [["data", "model"]] * 2
        assert "do not split" in str(out["sub.err3"])
        assert "not divisible by" in str(out["sub.err_model"])


def test_pipeline_placed_1f1b_bitwise_equals_gpipe(runs):
    """Each rank runs its own stage; 1F1B (each stage's reduce-and-apply
    at its last backward), GPipe and interleaved bitwise; against the
    reference's placed step on 4 devices."""
    _, ref, outs = runs
    ref_loss, ref_params = ref["placed"]
    for r, out in enumerate(outs):
        assert out["placed.mine"].tolist() == [r]
        assert bool(out["placed.placed"])
        base = _params(out, "placed.gpipe1", r)
        for tag in ("placed.1f1b1", "placed.1f1b2"):
            assert out[f"{tag}.losses"].tolist() == \
                out["placed.gpipe1.losses"].tolist()
            assert _bitwise(_params(out, tag, r), base)
        np.testing.assert_allclose(out["placed.1f1b1.losses"][-1], ref_loss,
                                   rtol=LOSS_RTOL)
        _leaves_close(base, _ref_leaves([ref_params[r]]), P_RTOL, P_ATOL,
                      f"stage {r} vs the reference")


def test_pipeline_placed_executables_live_on_declared_submeshes(runs):
    """A rank steps only its own stage's parameters and holds only its
    optimizer; the other entries come back untouched."""
    _, _, outs = runs
    for r, out in enumerate(outs):
        assert out["own.changed"].tolist() == [k == r for k in range(4)]
        assert out["own.opt_none"].tolist() == [k != r for k in range(4)]


def test_pipeline_placed_matches_unplaced_allclose(runs):
    _, _, outs = runs
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["pvu.placed.losses"],
                                   out["pvu.unplaced.losses"], rtol=1e-6)
        _leaves_close(_params(out, "pvu.placed", r),
                      _params(out, "pvu.unplaced", r), P_RTOL, P_ATOL,
                      "placed vs unplaced")


def test_pipeline_placed_mp_composition_bitwise(runs):
    """Stage meshes of data 1 x model 2, stage 0 running the fused
    tensor-parallel MLP on its model axis: 1F1B and GPipe bitwise."""
    _, _, outs = runs
    for r, out in enumerate(outs):
        assert np.all(np.isfinite(out["mp.1f1b.losses"]))
        assert out["mp.1f1b.losses"].tolist() == \
            out["mp.gpipe.losses"].tolist()
        k = r // 2
        assert _bitwise(_params(out, "mp.1f1b", k), _params(out, "mp.gpipe",
                                                            k))


def test_pipeline_placed_mp_matches_unplaced(runs):
    """The same chain with stage 0 unsharded, unplaced: the cotangent
    counted 1/model on each model rank, the carry's cotangent summed
    over them, the gradients summed over the stage mesh give its loss
    and parameters."""
    _, _, outs = runs
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["mp.1f1b.losses"],
                                   out["mp.plain.losses"], rtol=1e-5)
        k = r // 2
        _leaves_close(_params(out, "mp.1f1b", k), _params(out, "mp.plain", k),
                      P_RTOL, P_ATOL, f"stage {k}")


def test_pipeline_placed_validation(runs):
    _, _, outs = runs
    for out in outs:
        assert "one sub-mesh per stage" in str(out["pval.count"])
        assert "replica" in str(out["pval.replica"])
        assert "PER-STAGE opt_state" in str(out["pval.opt_state"])
