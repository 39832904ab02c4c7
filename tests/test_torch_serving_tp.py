"""Serving over a ``model`` mesh axis in horovod_tpu_torch (serving/
kv_cache.py head sharding, models/transformer.py's closers and
``axis_sum``, serving/engine.py ``mesh=``, utils/convert.py
``serving_shard``) against horovod_tpu's GSPMD-sharded engine.

A small f32 model with 6 heads (so 2 and 3 divide them) is served by a
job of 2 and a job of 3 gloo ranks, each a mesh ``make_mesh(model=n)``:
rank 0 schedules, the others follow.  At each axis size the bitwise
contract holds (prefill + decode rows equal ``serving_forward`` on the
axis, row by row), the logits are bitwise the same computation played in
one process (``play_forward_step``), within 1e-5 of the single-device
engine's, and the greedy tokens equal the single-device port engine's
and the reference's ``make_engine(mesh=make_mesh(data=1, model=2))``'s
(tests/test_serving.py:616).  At 3 ranks the fixed-order sum's output
does not depend on the number of rows.  tests/serving_pressure.py's
trace (a client abort and an admission done at its prefill in one
iteration, on a full pool) keeps every rank's free list, prefix LRU,
prefix index and page table equal after every iteration.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from horovod_tpu.core.topology import make_mesh as jmake_mesh
from horovod_tpu.models import transformer as RT
from horovod_tpu.serving import InferenceEngine as RefEngine
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.serving import InferenceEngine
from horovod_tpu_torch.utils.convert import params_from_jax, serving_shard
from horovod_tpu_torch.utils.tree import tree_leaves
from gloo_job import PRELUDE, REPO, flat

TP_SMALL = dict(vocab_size=97, d_model=96, n_heads=6, n_layers=2, d_ff=192,
                max_seq_len=64)
CFG_R = RT.TransformerConfig(**TP_SMALL)
CFG = TT.TransformerConfig(**TP_SMALL)
PARAMS_R = RT.init_transformer(jax.random.PRNGKey(3), CFG_R)
PARAMS = params_from_jax(jax.tree_util.tree_map(np.asarray, PARAMS_R),
                         requires_grad=False)
PROMPTS = [[2, 7, 1, 8, 2, 8], list(range(5, 25)), [40, 41]]
NEW = (8, 6, 9)
ENGINE = dict(max_slots=3, page_size=8, capacity=32)

WORKER = """
import json

from horovod_tpu_torch.core.topology import make_mesh
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.serving import InferenceEngine

SMALL, PROMPTS, NEW, ENGINE = json.loads(sys.argv[6])
cfg = tt.TransformerConfig(**SMALL)
params = tree("p", False)
mesh = make_mesh(model=N)
axis = mesh.axis("model")
eng = InferenceEngine(params, cfg, device="cpu", mesh=mesh, **ENGINE)
out = {"sharded": np.asarray(eng.cache.page_sharding() is not None),
       "local_heads": np.asarray(eng.cache.k_pages.shape[3])}
rows = {}
if RANK == 0:
    pf, dec = eng._prefill, eng._decode_iteration

    def prefill(slot, req):
        last = pf(slot, req)
        rows.setdefault(req.rid, []).append(last.copy())
        return last

    def decode(active):
        logits = dec(active)
        for slot, req in active:
            rows.setdefault(req.rid, []).append(logits[slot].copy())
        return logits

    eng._prefill, eng._decode_iteration = prefill, decode
    eng.warm_start()
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(PROMPTS, NEW)]
    eng.run_until_idle()
    eng.stop_followers()
    seqs = [p + r.result(0)[:-1] for p, r in zip(PROMPTS, reqs)]
    for i, r in enumerate(reqs):
        out[f"tokens/{i}"] = np.asarray(r.result(0))
        out[f"rows/{i}"] = np.stack(rows[r.rid])
else:
    eng.warm_start()
    while eng.follow():
        pass
    seqs = None
box = [seqs]
dist.broadcast_object_list(box, src=0)
seqs = box[0]
# A client abort and an admission done at its prefill in one iteration,
# on a full pool (tests/serving_pressure.py): after every iteration the
# ranks' free lists, prefix LRUs, prefix indexes and tables agree.
from serving_pressure import PRESSURE, pool_state, pressure_trace


def agree(e):
    both = [None] * N
    dist.all_gather_object(both, repr(pool_state(e.cache)))
    return len(set(both)) == 1


peng = InferenceEngine(params, cfg, device="cpu", mesh=mesh, prefix_pages=0,
                       **ENGINE)
peng.warm_start()
piters, pagreed = 0, 0
if RANK == 0:
    def pstep():
        global piters, pagreed
        peng.step()
        piters += 1
        pagreed += agree(peng)
        return not peng.scheduler.idle()

    preqs = pressure_trace(pstep, lambda n: peng.submit(
        PRESSURE[n][0], max_new_tokens=PRESSURE[n][1]), peng.abort_request)
    for n, r in preqs.items():
        out[f"pressure/reason_{n}"] = np.asarray(str(r.finish_reason))
        out[f"pressure/tokens_{n}"] = np.asarray(r.result(0) or [-1])
    peng.stop_followers()
else:
    while peng.follow():
        piters += 1
        pagreed += agree(peng)
out["pressure/iters"] = np.asarray(piters)
out["pressure/agreed"] = np.asarray(pagreed)
del peng
# serving_forward on the axis: a collective, every rank in one order.
with torch.no_grad():
    for i, seq in enumerate(seqs):
        out[f"forward/{i}"] = tt.serving_forward(
            eng.params, torch.tensor([seq]), cfg, ENGINE["capacity"],
            axis)[0].numpy()
# The fixed-order sum against the number of rows.
g = torch.Generator().manual_seed(100 + RANK)
part = torch.randn(40, 96, generator=g)
full = tt.axis_sum(part, axis)
differs = [m for m in (1, 2, 3, 7, 16, 33)
           if not torch.equal(tt.axis_sum(part[:m], axis), full[:m])]
out["sum/differs"] = np.asarray(differs + [-1])
out["sum/full"] = full.numpy()
ranks = [None] * N
dist.all_gather_object(ranks, full.numpy().tobytes())
out["sum/same_on_every_rank"] = np.asarray(len(set(ranks)) == 1)
finish(out)
"""


def _spawn(tmp, n):
    np.savez(tmp / "data.npz", **flat(jax.tree_util.tree_map(
        np.asarray, PARAMS_R), "p"))
    (tmp / "worker.py").write_text(PRELUDE + textwrap.dedent(WORKER))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [REPO, os.path.join(REPO, "tests")]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep))}
    for k in ("RANK", "WORLD_SIZE", "HVD_TPU_METRICS_PORT"):
        env.pop(k, None)
    arg = json.dumps([TP_SMALL, PROMPTS, NEW, ENGINE])
    return [subprocess.Popen(
        [sys.executable, str(tmp / "worker.py"), str(r), str(tmp / "store"),
         str(tmp / "data.npz"), str(tmp / f"out{r}.npz"), str(n), arg],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(n)]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Both jobs at once (2 and 3 ranks); each rank's results."""
    tmps = {n: tmp_path_factory.mktemp(f"tp{n}") for n in (2, 3)}
    procs = {n: _spawn(tmps[n], n) for n in (2, 3)}
    out = {}
    try:
        for n, ps in procs.items():
            logs = [p.communicate(timeout=400)[0] for p in ps]
            for r, (p, log) in enumerate(zip(ps, logs)):
                assert p.returncode == 0 and f"WORKER_OK {r}" in log, log
            out[n] = [dict(np.load(tmps[n] / f"out{r}.npz"))
                      for r in range(n)]
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return out


def _play_serving_forward(tokens, n):
    """serving_forward of an axis of n played in one process."""
    shards = [serving_shard(PARAMS, CFG, i, n) for i in range(n)]
    b, s = tokens.shape
    hd = CFG.d_model // CFG.n_heads
    zeros = [torch.zeros((CFG.n_layers, b, ENGINE["capacity"],
                          CFG.n_heads // n, hd)) for _ in range(n)]
    with torch.no_grad():
        return TT.play_forward_step(shards, tokens, torch.zeros(
            (b,), dtype=torch.long), zeros, zeros, CFG)[0]


@pytest.mark.parametrize("n", [2, 3])
def test_engine_shards_the_kv_heads(jobs, n):
    for r in jobs[n]:
        assert bool(r["sharded"]) and int(r["local_heads"]) == 6 // n


@pytest.mark.parametrize("n", [2, 3])
def test_contract_bitwise_on_the_axis(jobs, n):
    r0 = jobs[n][0]
    for i, p in enumerate(PROMPTS):
        rows, ref = r0[f"rows/{i}"], r0[f"forward/{i}"]
        assert len(rows) == NEW[i]
        for j, row in enumerate(rows):
            assert row.tobytes() == ref[len(p) - 1 + j].tobytes(), (i, j)


@pytest.mark.parametrize("n", [2, 3])
def test_every_rank_computes_the_same_logits(jobs, n):
    for i in range(len(PROMPTS)):
        want = jobs[n][0][f"forward/{i}"].tobytes()
        assert all(r[f"forward/{i}"].tobytes() == want for r in jobs[n])


@pytest.mark.parametrize("n", [2, 3])
def test_ranks_are_bitwise_the_played_axis(jobs, n):
    r0 = jobs[n][0]
    for i, p in enumerate(PROMPTS):
        seq = p + list(r0[f"tokens/{i}"][:-1])
        played = _play_serving_forward(torch.tensor([seq]), n)[0].numpy()
        assert played.tobytes() == r0[f"forward/{i}"].tobytes(), i


@pytest.mark.parametrize("n", [2, 3])
def test_logits_within_tolerance_of_the_single_device(jobs, n):
    r0 = jobs[n][0]
    for i, p in enumerate(PROMPTS):
        seq = p + list(r0[f"tokens/{i}"][:-1])
        with torch.no_grad():
            single = TT.serving_forward(PARAMS, torch.tensor([seq]), CFG,
                                        ENGINE["capacity"])[0].numpy()
        np.testing.assert_allclose(r0[f"forward/{i}"], single, atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("n", [2, 3])
def test_tokens_equal_single_device_port_engine(jobs, n):
    eng = InferenceEngine(PARAMS, CFG, device="cpu", **ENGINE)
    for i, p in enumerate(PROMPTS):
        assert list(jobs[n][0][f"tokens/{i}"]) == eng.generate(
            p, max_new_tokens=NEW[i]), i


@pytest.mark.parametrize("n", [2, 3])
def test_pool_mirrored_through_an_abort_and_a_prefill_finish(jobs, n):
    """tests/serving_pressure.py on the axis: every rank's pool agreed
    after every iteration, and the tokens are the single-device
    engine's."""
    from serving_pressure import PRESSURE

    iters = {int(r["pressure/iters"]) for r in jobs[n]}
    assert len(iters) == 1 and iters.pop() > 3
    assert all(int(r["pressure/agreed"]) == int(r["pressure/iters"])
               for r in jobs[n])
    r0 = jobs[n][0]
    assert str(r0["pressure/reason_A"]) == "client_disconnect"
    assert str(r0["pressure/reason_B"]) == "max_new_tokens"
    eng = InferenceEngine(PARAMS, CFG, device="cpu", **ENGINE)
    for name in "BCEF":
        prompt, new = PRESSURE[name]
        assert list(r0[f"pressure/tokens_{name}"]) == eng.generate(
            prompt, max_new_tokens=new), name


def test_tokens_equal_the_reference_tensor_parallel_engine(jobs):
    mesh = jmake_mesh(data=1, model=2, devices=jax.devices()[:2])
    ref = RefEngine(PARAMS_R, CFG_R, mesh=mesh, **ENGINE)
    assert ref.cache.page_sharding() is not None
    ref.warm_start()
    for i, p in enumerate(PROMPTS):
        want = ref.generate(p, max_new_tokens=NEW[i])
        for n in (2, 3):
            assert list(jobs[n][0][f"tokens/{i}"]) == want, (n, i)


def test_fixed_order_sum_does_not_depend_on_rows_at_3_ranks(jobs):
    for r in jobs[3]:
        assert list(r["sum/differs"]) == [-1]
        assert bool(r["sum/same_on_every_rank"])
    # And it is the rank-ordered sum of the three ranks' partials.
    parts = [torch.randn(40, 96, generator=torch.Generator().manual_seed(
        100 + r)) for r in range(3)]
    want = TT.ordered_sum(parts).numpy()
    assert jobs[3][0]["sum/full"].tobytes() == want.tobytes()


def unshard_serving(shards):
    """The full tree back from every rank's serving_shard, in rank order:
    columns of wq/wk/wv/w_in/b_in and rows of wo/w_out concatenated."""
    layers = {}
    for k in shards[0]["layers"]:
        parts = [sh["layers"][k] for sh in shards]
        dim = {"wq": -1, "wk": -1, "wv": -1, "w_in": -1, "b_in": -1,
               "wo": 1, "w_out": 1}.get(k)
        layers[k] = parts[0] if dim is None else torch.cat(parts, dim=dim)
    return {**shards[0], "layers": layers}


@pytest.mark.parametrize("n", [1, 2, 3])
def test_shards_concatenate_back_to_the_full_parameters(n):
    shards = [serving_shard(PARAMS, CFG, i, n) for i in range(n)]
    back = unshard_serving(shards)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                  tree_leaves(PARAMS)))
    if n > 1:
        lay = shards[1]["layers"]
        assert lay["wq"].shape[-1] == CFG.d_model // n
        assert lay["wo"].shape[1] == CFG.d_model // n
        assert lay["w_in"].shape[-1] == lay["b_in"].shape[-1] \
            == CFG.d_ff // n
        assert lay["w_out"].shape[1] == CFG.d_ff // n


def test_model_axis_of_one_is_the_single_device_program():
    """A played axis of one is the plain forward, bit for bit."""
    tokens = torch.tensor([PROMPTS[1]])
    with torch.no_grad():
        plain = TT.serving_forward(PARAMS, tokens, CFG, ENGINE["capacity"])
    assert torch.equal(_play_serving_forward(tokens, 1), plain)
