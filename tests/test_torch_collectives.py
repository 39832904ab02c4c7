"""horovod_tpu_torch's negotiated collectives against horovod_tpu's.

* One rank on gloo: every API and every validation message of the
  reference's test_allreduce/alltoall/reducescatter/process_sets that
  applies to one process, the fused grouped path, quiesce, join, and the
  failure paths (a failed collective call and a broken control exchange
  reach the caller's handle as HorovodError).
* One spawned group of 3 gloo ranks (FileStore in tmp_path) runs every
  multi-rank scenario in one launch: each reduce op on float32, bfloat16
  and int32, a fused grouped allreduce, ragged allgather, broadcast from
  root 2, even and ragged alltoall, reducescatter, the set [0, 2], join
  with uneven steps, the mismatch errors with the reference's messages,
  a withdrawal on timeout, a stall warning, SyncBatchNorm and the hook
  optimizer across ranks, and names enqueued in a different order on
  each rank; the response cache across ranks (a flush at
  ``add_process_set``, every request a hit from the hook optimizer's
  second step on, the same bits as a new init with the cache off).  Its results are held against the reference's eager
  collectives on 3 CPU devices (per-replica inputs via ``hvd.shard``):
  exact for integers, Min/Max, broadcast, allgather and alltoall; float32
  Sum/Average/Product within 1e-6 relative (the order of the ranks'
  terms differs); bfloat16 within one ulp of the result.
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

import horovod_tpu_torch as thvd
from horovod_tpu_torch.ops import collective as TC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 3
OPS = ["SUM", "AVERAGE", "MIN", "MAX", "PRODUCT"]
DTYPES = ["float32", "bfloat16", "int32"]


@pytest.fixture()
def port_cpu():
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


# -- one rank --------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int32, torch.int64,
                                   torch.float64, torch.uint8])
def test_one_rank_allreduce_every_op(port_cpu, dtype):
    x = torch.arange(1, 7).reshape(2, 3).to(dtype)
    for op in (thvd.Sum, thvd.Average, thvd.Min, thvd.Max, thvd.Product):
        out = thvd.allreduce(x, op=op)
        assert out.dtype == dtype and torch.equal(out, x), op
        assert out.data_ptr() != x.data_ptr()
    assert torch.equal(thvd.allreduce(torch.tensor(3, dtype=dtype)),
                       torch.tensor(3, dtype=dtype))  # a scalar


def test_one_rank_grouped_fuses_into_one_response(port_cpu):
    ts = [torch.full((i + 1,), float(i)) for i in range(5)]
    TC.reset_stats()
    outs = thvd.grouped_allreduce(ts, average=False)
    assert [o.tolist() for o in outs] == [t.tolist() for t in ts]
    assert TC.stats()["responses"] == 1 and TC.stats()["tensors"] == 5
    # Overlapping anonymous groups get distinct names.
    h1 = thvd.grouped_allreduce_async(ts[:2])
    h2 = thvd.grouped_allreduce_async(ts[:2])
    assert [thvd.synchronize(h).tolist() for h in h1 + h2] == \
        [t.tolist() for t in ts[:2]] * 2
    # quiesce holds the cycle: separate calls still fuse.
    TC.reset_stats()
    with thvd.quiesce():
        hs = [thvd.allreduce_async(t, name=f"q.{i}")
              for i, t in enumerate(ts)]
    assert [thvd.synchronize(h).tolist() for h in hs] == \
        [t.tolist() for t in ts]
    assert TC.stats()["responses"] == 1
    # Different dtypes or ops never share a response.
    TC.reset_stats()
    hs = thvd.grouped_allreduce_async([torch.ones(2), torch.ones(2).double()])
    hs += [thvd.allreduce_async(torch.ones(2), op=thvd.Max)]
    for h in hs:
        thvd.synchronize(h)
    assert TC.stats()["responses"] == 3


def test_one_rank_collectives_and_validation(port_cpu):
    x = torch.arange(6.0)
    assert torch.equal(thvd.allreduce(torch.arange(5), average=True),
                       torch.arange(5))
    assert torch.equal(thvd.allgather(x.reshape(3, 2)), x.reshape(3, 2))
    assert [t.tolist() for t in thvd.grouped_allgather([x, x[:2]])] == \
        [x.tolist(), [0.0, 1.0]]
    assert torch.equal(thvd.broadcast(x, 0), x)
    assert torch.equal(thvd.alltoall(x), x)
    assert torch.equal(thvd.alltoall(x, splits=[6]), x)
    assert torch.equal(thvd.reducescatter(x, op=thvd.Sum), x)
    assert [t.tolist() for t in thvd.grouped_reducescatter([x, 2 * x])] == \
        [x.tolist(), (2 * x).tolist()]
    thvd.barrier()
    assert thvd.join() == 0
    with pytest.raises(ValueError, match="not both"):
        thvd.allreduce(x, average=True, op=thvd.Sum)
    # Adasum on one rank: no round, the input back exactly.
    assert torch.equal(thvd.allreduce(x, op=thvd.Adasum), x)
    with pytest.raises(ValueError, match="floating-point"):
        thvd.allreduce(torch.arange(3), op=thvd.Adasum)
    with pytest.raises(ValueError, match="root_rank"):
        thvd.broadcast(x, 1)
    with pytest.raises(ValueError, match="at least one dimension"):
        thvd.alltoall(torch.tensor(1.0))
    with pytest.raises(ValueError, match="entry per rank"):
        thvd.alltoall(x, splits=[2, 4])
    with pytest.raises(ValueError, match="not a list"):
        thvd.alltoall([x])
    with pytest.raises(ValueError, match="Average/Sum"):
        thvd.reducescatter(x, op=thvd.Max)
    with pytest.raises(ValueError, match="divisible"):
        thvd.reducescatter(torch.ones(0))
    with pytest.raises(ValueError, match="not a list"):
        thvd.reducescatter([x])
    with pytest.raises(thvd.HorovodError,
                       match="Rank zero tried to gather a rank-zero"):
        thvd.allgather(torch.tensor(1.0))
    with pytest.raises(ValueError, match="Unsupported dtype"):
        thvd.allreduce(torch.ones(2, dtype=torch.complex64))
    # quiesce holds the cycle, so the first "dup" is still pending when
    # the second is submitted (on one rank a cycle runs as soon as work
    # is posted, and under load it could complete the first in between).
    with thvd.quiesce():
        h = thvd.allreduce_async(x, name="dup")
        with pytest.raises(ValueError, match="already pending"):
            thvd.allreduce_async(x, name="dup")
    assert torch.equal(thvd.synchronize(h), x)
    with pytest.raises(ValueError, match="already been cleared"):
        thvd.synchronize(h)
    h = thvd.allreduce_async(x)
    while not thvd.poll(h):
        pass
    assert torch.equal(thvd.synchronize(h), x)


def test_one_rank_process_sets(port_cpu):
    ps = thvd.add_process_set([0])
    assert (ps.process_set_id, ps.ranks, ps.size(), ps.rank(),
            ps.included()) == (1, (0,), 1, 0, True)
    x = torch.arange(4.0)
    assert torch.equal(thvd.allreduce(x, process_set=ps), x)
    assert torch.equal(thvd.broadcast(x, 0, process_set=ps), x)
    assert torch.equal(thvd.allgather(x, process_set=ps), x)
    rt = TC._runtime()
    assert rt.auto_name("allreduce", ps) == "ps1.allreduce.noname.2"
    assert rt.auto_name("allreduce") == "allreduce.noname.1"
    with pytest.raises(ValueError, match="outside"):
        thvd.add_process_set([0, 1])
    with pytest.raises(ValueError, match="at least one"):
        thvd.add_process_set([])
    with pytest.raises(ValueError, match="not a member"):
        thvd.broadcast(x, 1, process_set=ps)
    g = thvd.global_process_set()
    assert g.process_set_id == 0 and g.ranks == (0,)
    assert torch.equal(thvd.allreduce(x, process_set=g), x)
    with pytest.raises(ValueError, match="cannot be removed"):
        thvd.remove_process_set(g)
    assert thvd.remove_process_set(ps) is True
    assert thvd.remove_process_set(ps) is False
    with pytest.raises(thvd.HorovodError, match="not registered"):
        thvd.allreduce(x, process_set=ps)


def test_failed_collective_reaches_the_handle(port_cpu, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("injected collective failure")

    monkeypatch.setattr(TC.dist, "all_reduce", broken)
    with pytest.raises(thvd.HorovodError, match="injected collective"):
        thvd.allreduce(torch.ones(3))
    monkeypatch.undo()
    assert torch.equal(thvd.allreduce(torch.ones(3)), torch.ones(3))


def test_broken_control_exchange_fails_pending_ops(port_cpu, monkeypatch):
    rt = TC._runtime()
    with rt.cycle_lock:  # no cycle runs until the op is queued
        h = thvd.allreduce_async(torch.ones(2), name="doomed")

        def broken(batches):
            raise OSError("control group lost")

        monkeypatch.setattr(rt, "_negotiate", broken)
    with pytest.raises(thvd.HorovodError, match="control group lost"):
        thvd.synchronize(h)
    with pytest.raises(thvd.HorovodError, match="control exchange failed"):
        thvd.allreduce(torch.ones(2))


def test_shutdown_fails_pending_and_later_ops(port_cpu):
    rt = TC._runtime()
    with rt.cycle_lock:
        h = thvd.allreduce_async(torch.ones(2))
        rt.peer_shutdown = True
    with pytest.raises(thvd.HorovodError, match="has been shut down"):
        thvd.allreduce(torch.ones(2))
    rt.peer_shutdown = False
    assert torch.equal(thvd.synchronize(h), torch.ones(2))


# -- three ranks ------------------------------------------------------------

WORKER = textwrap.dedent("""
    import os, sys, time
    import numpy as np
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.frontends.torch as fhvd
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.ops import transport

    rank, store, data_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                        sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", store=dist.FileStore(store, 3),
                            rank=rank, world_size=3)
    # Count the broadcasts a worker decodes: full lists and cache replays
    # sent as entry indices.
    payloads = {transport.PAYLOAD_RESPONSES: 0, transport.PAYLOAD_REPLAY: 0}
    decode = transport.decode_payload

    def counting_decode(buf):
        kind, body = decode(buf)
        payloads[kind] += 1
        return kind, body

    transport.decode_payload = counting_decode
    hvd.init(device="cpu")
    data = dict(np.load(data_path))
    DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}
    out = {}

    def mine(key, dtype="float32"):
        return torch.from_numpy(data[key][rank]).to(DT[dtype])

    def keep(key, t):
        out[key] = t.float().numpy() if t.dtype == torch.bfloat16 \\
            else t.numpy()

    # Names enqueued in a different order on each rank.
    names = [f"order.{i}" for i in range(6)]
    mine_order = names[rank:] + names[:rank]
    handles = {nm: hvd.allreduce_async(mine(f"order.{names.index(nm)}"),
                                       name=nm, op=hvd.Sum)
               for nm in mine_order}
    for nm in names:
        keep(nm, hvd.synchronize(handles[nm]))
    # Every reduce op on each dtype.
    for op in ("SUM", "AVERAGE", "MIN", "MAX", "PRODUCT"):
        for dt in DT:
            keep(f"ar.{op}.{dt}", hvd.allreduce(
                mine(f"x.{dt}", dt), op=getattr(hvd.ReduceOp, op),
                name=f"ar.{op}.{dt}"))
    # A grouped allreduce fuses into one response.
    C.reset_stats()
    for i, t in enumerate(hvd.grouped_allreduce(
            [mine(f"g.{i}") for i in range(4)], op=hvd.Sum)):
        keep(f"gar.{i}", t)
    assert C.stats()["responses"] == 1, C.stats()
    keep("ag", hvd.allgather(torch.from_numpy(data[f"ag.{rank}"])))
    keep("bc", hvd.broadcast(mine("x.float32"), root_rank=2))
    keep("a2a.even", hvd.alltoall(mine("a2a")))
    keep("a2a.splits", hvd.alltoall(mine("a2a"), splits=[1, 0, 2]))
    ragged = [[1, 2, 0], [0, 1, 1], [2, 0, 2]][rank]
    keep("a2a.ragged", hvd.alltoall(
        torch.arange(sum(ragged)) + 10 * rank, splits=ragged))
    for op in ("SUM", "AVERAGE"):
        for dt in ("float32", "int32"):
            keep(f"rs.{op}.{dt}", hvd.reducescatter(
                mine("rs", dt), op=getattr(hvd.ReduceOp, op)))
    # The set [0, 2]: set-local ranks on the wire, a global root.  Its
    # registration allgather flushes every rank's cache replica.
    epoch = C._runtime().cache.epoch
    ps = hvd.add_process_set([0, 2])
    out["cache.flushed.by.set"] = np.array(C._runtime().cache.epoch > epoch)
    assert ps.included() == (rank != 1)
    if rank != 1:
        keep("ps.ar", hvd.allreduce(mine("x.float32"), op=hvd.Sum,
                                    process_set=ps))
        keep("ps.ag", hvd.allgather(torch.from_numpy(data[f"ag.{rank}"]),
                                    process_set=ps))
        keep("ps.bc", hvd.broadcast(mine("x.float32"), root_rank=2,
                                    process_set=ps))
        # A set's request served from the cache: rank 1 holds a
        # placeholder entry and rebuilds the replay it does not run.
        C.reset_stats()
        for i in range(3):
            keep(f"ps.cached.{i}", hvd.allreduce(
                mine("x.float32"), op=hvd.Sum, name="ps.cached",
                process_set=ps))
        out["ps.cached.hits"] = np.array(C.stats()["cache_hits"])
    else:
        try:
            hvd.allreduce(torch.ones(1), process_set=ps)
        except hvd.HorovodError as e:
            assert "is not a member of process set 1" in str(e), e
    keep("world.after.set", hvd.allreduce(mine("x.float32"), op=hvd.Sum))
    # Cross-rank mismatches fail on every rank with the reference's text.
    errors = []
    for kind in ("shape", "dtype", "op", "root", "reduce"):
        try:
            if kind == "shape":
                hvd.allreduce(torch.zeros(rank + 1), name="bad.shape")
            elif kind == "dtype":
                hvd.allreduce(torch.zeros(2, dtype=[torch.float32,
                              torch.int32, torch.float32][rank]),
                              name="bad.dtype")
            elif kind == "op":
                (hvd.allgather if rank == 1 else hvd.allreduce)(
                    torch.zeros(2), name="bad.op")
            elif kind == "root":
                hvd.broadcast(torch.zeros(2), root_rank=rank,
                              name="bad.root")
            else:
                hvd.allreduce(torch.zeros(2), name="bad.reduce",
                              op=hvd.Max if rank == 2 else hvd.Min)
            errors.append("no error")
        except hvd.HorovodError as e:
            errors.append(str(e))
    out["errors"] = np.array(errors)
    # Join with uneven steps: joined ranks contribute zeros.
    for i in range(rank + 1):
        keep(f"join.sum.{i}", hvd.allreduce(torch.ones(2), op=hvd.Sum,
                                            name=f"join.sum.{i}"))
        keep(f"join.avg.{i}", hvd.allreduce(torch.full((2,), 3.0),
                                            name=f"join.avg.{i}"))
    out["join"] = np.array(hvd.join())
    # A stall: rank 2 submits late; rank 0 warns (1 s threshold).
    if rank == 2:
        time.sleep(2.5)
    keep("late", hvd.allreduce(torch.ones(1), op=hvd.Sum, name="late.op"))
    # A withdrawal: only rank 0 submits; it times out and withdraws, and
    # the ERROR reaches it through the response stream.
    if rank == 0:
        os.environ["HOROVOD_TPU_SYNC_TIMEOUT"] = "1"
        try:
            hvd.allreduce(torch.ones(1), name="orphan")
            out["withdraw"] = np.array("no error")
        except hvd.HorovodError as e:
            out["withdraw"] = np.array(str(e))
        del os.environ["HOROVOD_TPU_SYNC_TIMEOUT"]
    hvd.barrier()
    # SyncBatchNorm: statistics over all three ranks' rows.
    xs = torch.from_numpy(data["bn"]).requires_grad_()  # [3, 4, 3]
    bn = fhvd.SyncBatchNorm(3, momentum=0.5)
    y = bn(xs[rank].detach().clone().requires_grad_())
    keep("sbn.out", y.detach())
    keep("sbn.running_mean", bn.running_mean)
    # The hook optimizer: 3 SGD steps on each rank's rows, names
    # registered in a rank-dependent order; the response cache serves
    # every request after the first step.  Then the same with the cache
    # off (a new init): the same bits where the steps fused their
    # gradients into the same responses.  Each step's responses are kept:
    # which cycle a hook's request lands in decides whether w and b fuse,
    # and with 3 ranks that moves their elements in gloo's ring and so
    # the order of the sums.
    layout = []
    run_response = C.Runtime._run

    def recording_run(self, resp, *args, **kw):
        layout.append(",".join(resp.tensor_names))
        return run_response(self, resp, *args, **kw)

    C.Runtime._run = recording_run

    def hook_steps(tag):
        w = torch.nn.Parameter(torch.from_numpy(data["w0"].copy()))
        b = torch.nn.Parameter(torch.zeros(2))
        named = [("w", w), ("b", b)][::1 if rank % 2 else -1]
        opt = fhvd.DistributedOptimizer(torch.optim.SGD([w, b], lr=0.1),
                                        named_parameters=named)
        fhvd.broadcast_parameters({"w": w.data, "b": b.data}, root_rank=0)
        hits, responses = [], []
        for step in range(3):
            C.reset_stats()
            opt.zero_grad()
            rows = torch.from_numpy(data["hx"][rank])
            layout.clear()
            ((rows @ w + b) ** 2).sum().backward()
            opt.step()
            hits.append((C.stats()["cache_hits"], C.stats()["cache_misses"]))
            responses.append("|".join(layout))
        keep(f"{tag}.w", w.detach())
        keep(f"{tag}.b", b.detach())
        out[f"{tag}.hits"] = np.array(hits)
        out[f"{tag}.responses"] = np.array(responses)

    hook_steps("hook")
    out["replay.payloads"] = np.array(payloads[transport.PAYLOAD_REPLAY])
    hvd.shutdown()
    os.environ["HVD_TPU_RESPONSE_CACHE"] = "0"
    hvd.init(device="cpu")
    assert C._runtime().cache is None
    hook_steps("hook.nocache")
    np.savez(out_path, **out)
    hvd.shutdown()
    dist.destroy_process_group()
    print("WORKER_OK", rank, flush=True)
""")


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float() \
        .numpy()


def _inputs():
    rng = np.random.RandomState(0)
    d = {}
    for dt in DTYPES:
        v = rng.randint(1, 4, size=(N, 5, 3)).astype(np.float32)
        if dt == "float32":
            v = v + rng.rand(N, 5, 3).astype(np.float32)
        d[f"x.{dt}"] = v.astype(np.int32) if dt == "int32" else _bf16(v) \
            if dt == "bfloat16" else v
    for i in range(6):
        d[f"order.{i}"] = rng.rand(N, 4).astype(np.float32)
    for i in range(4):
        d[f"g.{i}"] = rng.rand(N, i + 2).astype(np.float32)
    for r in range(N):
        d[f"ag.{r}"] = rng.rand(r + 1, 2).astype(np.float32)
    d["a2a"] = rng.rand(N, 3, 2).astype(np.float32)
    d["rs"] = rng.randint(0, 10, size=(N, 6, 2)).astype(np.float32)
    d["bn"] = rng.rand(N, 4, 3).astype(np.float32)
    d["w0"] = rng.rand(3, 2).astype(np.float32)
    d["hx"] = rng.rand(N, 4, 3).astype(np.float32)
    return d


def _reference(d):
    """The reference's eager collectives on 3 CPU devices."""
    import horovod_tpu as hvd

    hvd.init(devices=jax.devices()[:N])
    try:
        ref = {}

        def per(key, dt="float32"):
            return hvd.shard(jnp.asarray(d[key]).astype(dt))

        for op in OPS:
            for dt in DTYPES:
                ref[f"ar.{op}.{dt}"] = np.asarray(hvd.allreduce(
                    per(f"x.{dt}", dt), op=getattr(hvd, op.title()))
                    .astype(jnp.float32 if dt == "bfloat16" else dt))
        for i in range(6):
            ref[f"order.{i}"] = np.asarray(hvd.allreduce(
                per(f"order.{i}"), average=False))
        outs = hvd.grouped_allreduce([per(f"g.{i}") for i in range(4)],
                                     average=False)
        for i, o in enumerate(outs):
            ref[f"gar.{i}"] = np.asarray(o)
        ref["ag"] = np.asarray(hvd.allgather(
            [jnp.asarray(d[f"ag.{r}"]) for r in range(N)]))
        ref["bc"] = np.asarray(hvd.broadcast(per("x.float32"), root_rank=2))
        ref["a2a.even"] = [np.asarray(o) for o in hvd.alltoall(per("a2a"))]
        ref["a2a.splits"] = [np.asarray(o) for o in
                             hvd.alltoall(per("a2a"), splits=[1, 0, 2])]
        for op in ("SUM", "AVERAGE"):
            for dt in ("float32", "int32"):
                ref[f"rs.{op}.{dt}"] = np.asarray(hvd.reducescatter(
                    per("rs", dt), average=op == "AVERAGE"))
        ps = hvd.add_process_set([0, 2])
        ref["ps.ag"] = np.asarray(hvd.allgather(
            [jnp.asarray(d["ag.0"]), jnp.asarray(d["ag.2"])],
            process_set=ps))
        return ref
    finally:
        hvd.shutdown()


def _within_one_bf16_ulp(got, want):
    want = np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(np.asarray(got, np.float32) - want) <= ulp), \
        (got, want)


def test_three_gloo_ranks_match_the_reference(tmp_path):
    d = _inputs()
    data_path = tmp_path / "data.npz"
    np.savez(data_path, **d)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", ""),
           "HOROVOD_STALL_WARNING_SECONDS": "1"}
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
        for op in OPS:
            for dt in DTYPES:
                key = f"ar.{op}.{dt}"
                got, want = out[key], ref[key][r]
                if dt == "bfloat16" and op in ("SUM", "AVERAGE", "PRODUCT"):
                    _within_one_bf16_ulp(got, want)
                elif dt == "float32" and op in ("SUM", "AVERAGE",
                                                "PRODUCT"):
                    np.testing.assert_allclose(got, want, rtol=1e-6)
                else:
                    np.testing.assert_array_equal(got, want, err_msg=key)
        for key in [f"order.{i}" for i in range(6)] + \
                [f"gar.{i}" for i in range(4)]:
            np.testing.assert_allclose(out[key], ref[key][r], rtol=1e-6)
        np.testing.assert_array_equal(out["ag"], ref["ag"])
        np.testing.assert_array_equal(out["bc"], ref["bc"])
        np.testing.assert_array_equal(out["a2a.even"], ref["a2a.even"][r])
        np.testing.assert_array_equal(out["a2a.splits"],
                                      ref["a2a.splits"][r])
        for op in ("SUM", "AVERAGE"):
            for dt in ("float32", "int32"):
                key = f"rs.{op}.{dt}"
                np.testing.assert_allclose(out[key], ref[key][r], rtol=1e-6)
        np.testing.assert_allclose(
            out["world.after.set"], d["x.float32"].sum(0), rtol=1e-6)
        # Join: step i sums the ranks that had an i-th step; Average
        # still divides by all three.
        for i in range(r + 1):
            live = sum(1 for q in range(N) if q + 1 > i)
            assert out[f"join.sum.{i}"].tolist() == [live] * 2
            np.testing.assert_allclose(out[f"join.avg.{i}"],
                                       [3.0 * live / N] * 2, rtol=1e-6)
        assert int(out["join"]) == N - 1
        assert out["late"].tolist() == [N]
        assert list(out["errors"]) == [
            "Mismatched allreduce tensor shapes: One rank sent a tensor of "
            "shape [1], but another rank sent a tensor of shape [2].",
            "Mismatched data types: One rank had type float32, but another "
            "rank had type int32.",
            "Mismatched collective operations: One rank did an allreduce, "
            "but another rank did an allgather.",
            "Mismatched broadcast root ranks: One rank specified root rank "
            "0, but another rank specified root rank 1.",
            "Mismatched reduce operations: One rank specified reduce op "
            "min, but another rank specified reduce op max."]
    ragged = [[1, 2, 0], [0, 1, 1], [2, 0, 2]]
    for r, out in enumerate(outs):
        want, off = [], [sum(row[:r]) for row in ragged]
        for s in range(N):
            want += list(range(10 * s + off[s], 10 * s + off[s]
                               + ragged[s][r]))
        assert out["a2a.ragged"].tolist() == want
    for r in (0, 2):
        np.testing.assert_allclose(
            outs[r]["ps.ar"], d["x.float32"][0] + d["x.float32"][2],
            rtol=1e-6)
        np.testing.assert_array_equal(outs[r]["ps.ag"], ref["ps.ag"])
        np.testing.assert_array_equal(outs[r]["ps.bc"], d["x.float32"][2])
        for i in range(3):
            np.testing.assert_array_equal(outs[r][f"ps.cached.{i}"],
                                          outs[r]["ps.ar"])
        assert int(outs[r]["ps.cached.hits"]) == 2
    # The response cache across ranks: a flush at add_process_set, hits
    # from the second step on, and the bits of the cache off.
    for out in outs:
        assert bool(out["cache.flushed.by.set"])
        # Workers rebuilt all-replay cycles from their replica.
        assert (int(out["replay.payloads"]) > 0) == (out is not outs[0])
        assert out["hook.hits"].tolist() == [[0, 2], [2, 0], [2, 0]]
        assert out["hook.nocache.hits"].tolist() == [[0, 2]] * 3
        # Every step reduced w and b, fused or apart.
        for tag in ("hook", "hook.nocache"):
            for resp in out[f"{tag}.responses"]:
                assert sorted(",".join(resp.split("|")).split(",")) == \
                    ["grad.b", "grad.w"], resp
        # The same fused responses every step: the same bits.  (Where they
        # differ, the comparison with SGD on the averaged gradient below
        # holds both runs.)
        if out["hook.responses"].tolist() == \
                out["hook.nocache.responses"].tolist():
            for key in ("hook.w", "hook.b"):
                np.testing.assert_array_equal(out[key], out[key.replace(
                    "hook", "hook.nocache")])
    assert "ps.ar" not in outs[1]
    assert str(outs[0]["withdraw"]) == (
        "Collective orphan was abandoned: rank 0 timed out waiting for the "
        "remaining ranks; the operation fails on all ranks.")
    assert "WARNING: Tensor late.op has been pending for" in logs[0] and \
        "waiting on replicas: [2]" in logs[0], logs[0]

    # SyncBatchNorm against BatchNorm over all ranks' rows at once.
    bn = torch.nn.BatchNorm1d(3, momentum=0.5)
    full = bn(torch.from_numpy(d["bn"].reshape(N * 4, 3))).detach().numpy()
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["sbn.out"], full[4 * r:4 * r + 4],
                                   atol=1e-5)
        np.testing.assert_allclose(out["sbn.running_mean"],
                                   bn.running_mean.numpy(), atol=1e-6)
    # The hook optimizer equals SGD on the averaged gradient.
    w = torch.nn.Parameter(torch.from_numpy(d["w0"]))
    b = torch.nn.Parameter(torch.zeros(2))
    opt = torch.optim.SGD([w, b], lr=0.1)
    for _ in range(3):
        opt.zero_grad()
        loss = sum(((torch.from_numpy(d["hx"][r]) @ w + b) ** 2).sum()
                   for r in range(N)) / N
        loss.backward()
        opt.step()
    for out in outs:
        for tag in ("hook", "hook.nocache"):
            np.testing.assert_allclose(out[f"{tag}.w"], w.detach().numpy(),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(out[f"{tag}.b"], b.detach().numpy(),
                                       rtol=1e-6, atol=1e-7)
