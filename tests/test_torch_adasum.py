"""horovod_tpu_torch's Adasum (ops/collective.py ``_adasum``, its checks,
parallel/data.py's whole-gradient Adasum) and its sparse allreduce
across ranks, against horovod_tpu's.

One spawned group of 4 gloo ranks (FileStore in tmp_path) runs every
multi-rank case in one launch:

* the ladder at n = 4 (6 elements < 2n) and VHDD (103 elements, not a
  multiple of 4: the pad), each also on orthogonal vectors, where
  Adasum is the plain sum; n = 2 (the ladder) through the process set
  [0, 1]; held to the reference's eager Adasum on 4 and 2 CPU devices
  with tests/test_allreduce.py's tolerances (rtol 1e-5 for the ladder;
  rtol 1e-4, atol 1e-5 for VHDD; 1e-6 for the orthogonal sums);
* the checks with the reference's messages: a set of 3 ranks (not a
  power of two), an int32 tensor, a rank that has joined;
* ``DistributedOptimizer(op=Adasum)`` of parallel/data.py: the whole
  gradient combined as one vector, against the pairwise numpy spec;
* the sparse allreduce: the union of each rank's rows (a different nnz
  on each rank) against the reference's per-replica IndexedSlices on 4
  devices, Average dividing by 4, and parallel/data.py's optimizer with
  a sparse COO gradient on each rank against the dense average.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4

WORKER = textwrap.dedent("""
    import sys, threading, time
    import numpy as np
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collective as C

    rank, store, data_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                        sys.argv[3], sys.argv[4])
    kv = dist.FileStore(store, 4)
    dist.init_process_group("gloo", store=kv, rank=rank, world_size=4)
    hvd.init(device="cpu")
    data = dict(np.load(data_path))
    out = {}

    def mine(key):
        return torch.from_numpy(data[key][rank])

    for key in ("ladder", "ladder.orth", "vhdd", "vhdd.orth"):
        out[key] = hvd.allreduce(mine(key), op=hvd.Adasum,
                                 name=key).numpy()
    pair = hvd.add_process_set([0, 1])
    if rank < 2:
        for key in ("ladder", "vhdd"):
            out[f"pair.{key}"] = hvd.allreduce(
                mine(key), op=hvd.Adasum, name=f"pair.{key}",
                process_set=pair).numpy()
    trio = hvd.add_process_set([0, 1, 2])
    errors = []
    if rank < 3:
        try:
            hvd.allreduce(mine("ladder"), op=hvd.Adasum, process_set=trio)
        except ValueError as e:
            errors.append(str(e))
    try:
        hvd.allreduce(torch.ones(2, dtype=torch.int32), op=hvd.Adasum)
    except ValueError as e:
        errors.append(str(e))
    # Rank 0 joins first (on a thread); while it has joined, its Adasum
    # is refused; then it tells the others, through the store, to join
    # and release it.
    if rank == 0:
        t = threading.Thread(target=hvd.join)
        t.start()
        while not C._runtime().joining:
            time.sleep(0.01)
        try:
            hvd.allreduce(mine("ladder"), op=hvd.Adasum, name="joined")
        except hvd.HorovodError as e:
            errors.append(str(e))
        kv.set("joined.checked", "1")
        t.join()
    else:
        kv.wait(["joined.checked"])
        hvd.join()
    out["errors"] = np.array(errors)
    # Whole-gradient Adasum of parallel/data.py.
    w = torch.nn.Parameter(torch.zeros(3, 2))
    b = torch.nn.Parameter(torch.zeros(2))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w, b], lr=1.0),
                                   op=hvd.Adasum)
    w.grad, b.grad = mine("gw"), mine("gb")
    opt.step()
    out["opt.w"], out["opt.b"] = w.detach().numpy(), b.detach().numpy()
    # The sparse allreduce: the union of rows, nnz (rank % 3) + 1.
    nnz = rank % 3 + 1
    sl = hvd.IndexedSlices(torch.full((nnz, 4), float(rank + 1)),
                           torch.arange(nnz) + 10 * rank, (100, 4))
    union = hvd.allreduce(sl, average=False, name="union")
    out["union.values"] = union.values.numpy()
    out["union.indices"] = union.indices.numpy()
    avg = hvd.allreduce(hvd.IndexedSlices(torch.ones(2, 3),
                                          torch.tensor([0, 1]), (10, 3)),
                        name="avg")
    out["avg.values"] = avg.values.numpy()
    # parallel/data.py's optimizer: a sparse COO gradient a rank.
    for dense in (False, True):
        emb = torch.nn.Parameter(torch.zeros(8, 2))
        opt = hvd.DistributedOptimizer(torch.optim.SGD([emb], lr=1.0),
                                       sparse_as_dense=dense)
        rows = torch.tensor([rank, (rank + 3) % 8])
        emb.grad = torch.sparse_coo_tensor(rows[None], mine("sg"), (8, 2),
                                           check_invariants=False)
        opt.step()
        out[f"sparse.opt.{dense}"] = emb.detach().numpy()
    np.savez(out_path, **out)
    hvd.shutdown()
    dist.destroy_process_group()
    print("WORKER_OK", rank, flush=True)
""")


def _adasum_spec(vs):
    """Pairwise recursive doubling, tests/test_allreduce.py's spec."""
    vs = [np.asarray(v, np.float64) for v in vs]
    while len(vs) > 1:
        nxt = []
        for a, b in zip(vs[0::2], vs[1::2]):
            dot, na, nb = a @ b, a @ a, b @ b
            ca = 1.0 - (dot / (2.0 * na) if na > 0 else 0.0)
            cb = 1.0 - (dot / (2.0 * nb) if nb > 0 else 0.0)
            nxt.append(ca * a + cb * b)
        vs = nxt
    return vs[0]


def _inputs():
    d = {"ladder": np.random.RandomState(7).normal(size=(N, 6))
         .astype(np.float32),
         "ladder.orth": np.eye(N, dtype=np.float32),
         "vhdd": np.random.RandomState(11).normal(size=(N, 103))
         .astype(np.float32),
         "vhdd.orth": np.eye(N, 4 * N, dtype=np.float32)}
    rng = np.random.RandomState(5)
    d["gw"] = rng.normal(size=(N, 3, 2)).astype(np.float32)
    d["gb"] = rng.normal(size=(N, 2)).astype(np.float32)
    d["sg"] = rng.normal(size=(N, 2, 2)).astype(np.float32)
    return d


def _reference(d):
    import horovod_tpu as hvd
    from horovod_tpu.ops import sparse as JS

    ref = {}
    hvd.init(devices=jax.devices()[:N])
    try:
        for key in ("ladder", "ladder.orth", "vhdd", "vhdd.orth"):
            ref[key] = np.asarray(hvd.allreduce(
                hvd.shard(jnp.asarray(d[key])), op=hvd.Adasum, name=key))[0]
        per = [JS.IndexedSlices(jnp.full((r % 3 + 1, 4), float(r + 1)),
                                jnp.arange(r % 3 + 1) + 10 * r, (100, 4))
               for r in range(N)]
        union = JS.allreduce(per, average=False)
        ref["union.values"] = np.asarray(union.values)
        ref["union.indices"] = np.asarray(union.indices)
        avg = JS.allreduce(JS.IndexedSlices(jnp.ones((2, 3)),
                                            jnp.asarray([0, 1]), (10, 3)))
        ref["avg.values"] = np.asarray(avg.values)
    finally:
        hvd.shutdown()
    hvd.init(devices=jax.devices()[:2])
    try:
        for key in ("ladder", "vhdd"):
            ref[f"pair.{key}"] = np.asarray(hvd.allreduce(
                hvd.shard(jnp.asarray(d[key][:2])), op=hvd.Adasum,
                name=key))[0]
    finally:
        hvd.shutdown()
    return ref


def test_four_gloo_ranks_adasum_and_sparse_match_the_reference(tmp_path):
    d = _inputs()
    data_path = tmp_path / "data.npz"
    np.savez(data_path, **d)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    for k in ("RANK", "WORLD_SIZE", "HOROVOD_TPU_SYNC_TIMEOUT"):
        env.pop(k, None)
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), store, str(data_path),
         str(tmp_path / f"out{r}.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(N)]
    logs = []
    try:
        ref = _reference(d)
        for p in procs:
            logs.append(p.communicate(timeout=150)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in log, log
    outs = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(N)]

    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["ladder"], ref["ladder"], rtol=1e-5)
        np.testing.assert_allclose(out["vhdd"], ref["vhdd"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(out["ladder.orth"], np.ones(N), rtol=1e-6)
        np.testing.assert_allclose(out["vhdd.orth"],
                                   d["vhdd.orth"].sum(0), rtol=1e-6,
                                   atol=1e-6)
        for key in ("ladder", "vhdd"):
            np.testing.assert_allclose(out[key], _adasum_spec(d[key]),
                                       rtol=1e-4, atol=1e-5)
        # Every rank holds the same bits (the formula is symmetric).
        for key in ("ladder", "vhdd"):
            np.testing.assert_array_equal(out[key], outs[0][key])
        errors = list(out["errors"])
        dtype_msg = ("op=Adasum is defined on floating-point gradients; "
                     "got dtype int32.")
        pow2_msg = ("op=Adasum requires a power-of-two contributor count "
                    "for its recursive-doubling ppermute ladder; got 3.")
        joined_msg = ("op=Adasum cannot run while this rank has joined: a "
                      "zero contribution is only an identity for "
                      "sum/average.")
        assert errors == ([pow2_msg] if r < 3 else []) + [dtype_msg] + \
            ([joined_msg] if r == 0 else []), errors
        flat = np.concatenate([d["gw"].reshape(N, -1), d["gb"]], axis=1)
        spec = _adasum_spec(flat)
        np.testing.assert_allclose(out["opt.w"].reshape(-1), -spec[:6],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["opt.b"], -spec[6:], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(out["union.values"],
                                      ref["union.values"])
        np.testing.assert_array_equal(out["union.indices"],
                                      ref["union.indices"])
        np.testing.assert_allclose(out["avg.values"], ref["avg.values"],
                                   rtol=1e-6)
        dense = np.zeros((8, 2), np.float32)
        for q in range(N):
            dense[[q, (q + 3) % 8]] += d["sg"][q]
        for flag in ("False", "True"):
            np.testing.assert_allclose(out[f"sparse.opt.{flag}"],
                                       -dense / N, rtol=1e-6, atol=1e-7)
    for r in (0, 1):
        np.testing.assert_allclose(outs[r]["pair.ladder"], ref["pair.ladder"],
                                   rtol=1e-5)
        np.testing.assert_allclose(outs[r]["pair.vhdd"], ref["pair.vhdd"],
                                   rtol=1e-5)
