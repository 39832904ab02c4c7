"""horovod_tpu_torch's quantized and hierarchical allreduce across 4 gloo
ranks, against horovod_tpu's (ops/megakernel.py, ops/collective.py's
bucketed ALLREDUCE, core/topology.py, core/state.py's groups).

One spawned group of 4 gloo ranks (FileStore in tmp_path) runs every
case; the parent holds the results to the reference on 4 CPU devices:

* flat int8 and int4, stochastic and nearest, error feedback on and off
  (and one bf16 case), 3 ticks with the residuals carried: bitwise
  ``horovod_tpu.ops.compression.reference_allreduce`` of the stacked
  rows (zero residuals at tick 0, as the reference's executor adds);
* a mixed policy splitting one fused response into an int8 and an
  uncompressed bucket; a process set of 2; Average; a bf16 cast policy;
  int32 and Min/Max, which never quantize;
* ``compression_state`` saved by the reference's executor (its one-
  process ``sp_pr`` form: the [4, T] residual's row r and the tick under
  the port's ``mp`` key) and loaded into the port: the port's next tick
  is the reference's;
* 2 x 2 virtual nodes under ``HVD_TPU_HIERARCHICAL=on``: full-precision
  legs within 1e-5 of the flat sum; the cross-node leg inheriting int8,
  and int8 on every leg, bitwise the reference executor's result on a
  4-device mesh under the same seed and tick (as tests/test_megakernel.py
  :705-735 runs it);
* the hook-driven ``DistributedOptimizer`` under an int8 policy for 2
  SGD steps: the parameters bitwise equal on every rank and within the
  codebook's bound of the uncompressed run.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np

from horovod_tpu.ops import compression as J

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
SEED = 11
T = 1000  # pads to 4 * 256
FLAT_CASES = [(bits, rounding, ef, "float32")
              for bits in (8, 4) for rounding in ("stochastic", "nearest")
              for ef in ("1", "0")] + [(8, "stochastic", "1", "bfloat16")]

WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.frontends.torch as fhvd
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.ops import megakernel as MK

    rank, store, data_path, state_path, out_path = (
        int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5])
    cases = json.loads(sys.argv[6])
    kv = dist.FileStore(store, 4)
    dist.init_process_group("gloo", store=kv, rank=rank, world_size=4)
    hvd.init(device="cpu")
    data = dict(np.load(data_path))
    out = {}

    def mine(key, *idx):
        return torch.from_numpy(np.array(data[key][(rank,) + idx]))

    # Flat quantized cases, 3 ticks each.
    for bits, rounding, ef, dtype in cases:
        tag = f"flat.{bits}.{rounding}.{ef}.{dtype}"
        os.environ["HVD_TPU_QUANT_ROUNDING"] = rounding
        os.environ["HVD_TPU_QUANT_ERROR_FEEDBACK"] = ef
        hvd.set_compression(default=f"int{bits}")
        for tick in range(3):
            x = mine("flat", tick).to(getattr(torch, dtype))
            got = hvd.allreduce(x, op=hvd.Sum, name=tag)
            out[f"{tag}.{tick}"] = got.float().numpy()
        out[f"{tag}.residuals"] = np.array(MK.residual_count())
    os.environ.pop("HVD_TPU_QUANT_ROUNDING")
    os.environ.pop("HVD_TPU_QUANT_ERROR_FEEDBACK")

    # A mixed policy: one fused response, two buckets.
    hvd.set_compression(default="int8", rules=[(r"\\.ln$", "none")])
    before = (MK.stats.launches, MK.stats.quant_launches,
              C.stats()["responses"])
    with hvd.quiesce():  # one cycle: one fused response
        handles = [hvd.allreduce_async(mine(k), op=hvd.Sum, name=f"mix.{k}")
                   for k in ("emb", "ln")]
    emb, ln = [hvd.synchronize(h) for h in handles]
    out["mix.emb"], out["mix.ln"] = emb.numpy(), ln.numpy()
    out["mix.counts"] = np.array([
        MK.stats.launches - before[0], MK.stats.quant_launches - before[1],
        C.stats()["responses"] - before[2]])
    # A process set of 2, and Average.
    pair = hvd.add_process_set([0, 1])
    if rank < 2:
        out["pair"] = hvd.allreduce(mine("pair"), op=hvd.Sum, name="pair",
                                    process_set=pair).numpy()
    out["avg"] = hvd.allreduce(mine("avg"), op=hvd.Average,
                               name="avg").numpy()
    # Integers and Min/Max never quantize.
    q0 = MK.stats.quant_launches
    out["int"] = hvd.allreduce(mine("int"), op=hvd.Sum, name="int").numpy()
    out["max"] = hvd.allreduce(mine("avg"), op=hvd.Max, name="max").numpy()
    out["min"] = hvd.allreduce(mine("avg"), op=hvd.Min, name="min").numpy()
    out["never"] = np.array(MK.stats.quant_launches - q0)
    # A bf16 cast policy.
    hvd.set_compression(default="bf16")
    got = hvd.allreduce(mine("avg"), op=hvd.Sum, name="cast")
    out["cast"], out["cast.dtype"] = got.numpy(), np.array(str(got.dtype))
    # The reference's checkpoint, loaded here: the next tick.
    hvd.set_compression(default="int8")
    state = json.load(open(state_path))
    hvd.load_compression_state({
        "residuals": {k: np.asarray(v[rank], np.float32)
                      for k, v in state["residuals"].items()},
        "ticks": state["ticks"]})
    out["ckpt"] = hvd.allreduce(mine("ckpt", 1), op=hvd.Sum,
                                name="ckpt").numpy()

    # The hook optimizer, int8 (biases uncompressed) and uncompressed.
    def hook_run(policy):
        if policy:
            hvd.set_compression(default="int8", rules=[(r"b1$", "none")])
        else:
            hvd.set_compression()
        w1 = torch.nn.Parameter(torch.tensor(data["hw1"]))  # a copy
        b1 = torch.nn.Parameter(torch.zeros(32))
        w2 = torch.nn.Parameter(torch.tensor(data["hw2"]))
        params = [w1, b1, w2]
        opt = fhvd.DistributedOptimizer(
            torch.optim.SGD(params, lr=0.1),
            named_parameters=[("w1", w1), ("b1", b1), ("w2", w2)])
        gmax = 0.0
        for step in range(2):
            x, y = mine("hx", step), mine("hy", step)
            loss = ((torch.tanh(x @ w1 + b1) @ w2 - y) ** 2).mean()
            grads = torch.autograd.grad(loss, params, retain_graph=True)
            gmax = max([gmax] + [float(g.abs().max()) for g in grads])
            opt.zero_grad()
            loss.backward()
            opt.step()
        return [p.detach().numpy().copy() for p in params], gmax

    (out["hook.w1"], out["hook.b1"], out["hook.w2"]), gq = hook_run(True)
    (out["none.w1"], out["none.b1"], out["none.w2"]), gn = hook_run(False)
    out["hook.gmax"] = np.array(max(gq, gn))

    # 2 x 2 virtual nodes.
    hvd.shutdown()
    os.environ["HVD_TPU_HIERARCHICAL"] = "on"
    os.environ["HVD_TPU_VIRTUAL_SLICES"] = "2"
    hvd.init(device="cpu")
    h0 = MK.stats.hier_launches
    hvd.set_compression()
    out["hier.full"] = hvd.allreduce(mine("hier"), op=hvd.Sum,
                                     name="hier.full").numpy()
    hvd.set_compression(default="int8")
    out["hier.dcn"] = hvd.allreduce(mine("hier"), op=hvd.Sum,
                                    name="hier.dcn").numpy()
    os.environ["HVD_TPU_ICI_COMPRESS"] = "int8"
    out["hier.ici"] = hvd.allreduce(mine("hier"), op=hvd.Sum,
                                    name="hier.ici").numpy()
    out["hier.launches"] = np.array(MK.stats.hier_launches - h0)
    out["hier.residuals"] = np.array(MK.residual_count())
    np.savez(out_path, **out)
    hvd.shutdown()
    dist.destroy_process_group()
    print("WORKER_OK", rank, flush=True)
""")


def _inputs():
    rng = np.random.default_rng(7)
    d = {"flat": rng.standard_normal((N, 3, T)).astype(np.float32),
         "emb": rng.standard_normal((N, 64, 8)).astype(np.float32),
         # Integers: exact in any order of the sum, and not on the
         # int8 grid (amax 1031, scale 16).
         "ln": np.tile(np.arange(1000, 1032, dtype=np.float32), (N, 1)),
         "pair": rng.standard_normal((N, 300)).astype(np.float32),
         "avg": rng.standard_normal((N, 3, 70)).astype(np.float32),
         "int": rng.integers(-50, 50, size=(N, 40)).astype(np.int32),
         "ckpt": rng.standard_normal((N, 2, 500)).astype(np.float32),
         "hier": rng.standard_normal((N, 900)).astype(np.float32),
         "hw1": (rng.standard_normal((64, 32)) * 0.2).astype(np.float32),
         "hw2": (rng.standard_normal((32, 8)) * 0.2).astype(np.float32),
         "hx": rng.standard_normal((N, 2, 16, 64)).astype(np.float32),
         "hy": rng.standard_normal((N, 2, 16, 8)).astype(np.float32)}
    return d


def _same(port, ref):
    port = np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape
    assert port.tobytes() == ref.tobytes(), np.abs(port - ref).max()


def _flat_reference(d, bits, rounding, ef, dtype):
    """reference_allreduce over the stacked rows, 3 ticks, residuals
    carried."""
    fmt = J.WireFormat(kind="quant", name=f"int{bits}", bits=bits,
                       block=256, stochastic=rounding == "stochastic",
                       error_feedback=ef == "1")
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    res = jnp.zeros((N, T), jdt) if ef == "1" else None
    outs = []
    for tick in range(3):
        rows = jnp.asarray(d["flat"][:, tick]).astype(jdt)
        out, res = J.reference_allreduce(rows, fmt, tick, seed=SEED,
                                         residuals=res)
        outs.append(np.asarray(out.astype(jnp.float32)))
    return outs


def _executor_reference(d):
    """The reference's executor (megakernel ``sp_pr``) on 4 CPU devices:
    the checkpoint's two ticks, and the 2 x 2 hierarchy."""
    import horovod_tpu as hvd

    ref = {}
    env0 = dict(os.environ)
    os.environ["HVD_TPU_QUANT_SEED"] = str(SEED)
    hvd.init(devices=jax.devices()[:N])
    try:
        hvd.set_compression(default="int8")
        x = d["ckpt"]
        hvd.allreduce(hvd.shard(jnp.asarray(x[:, 0])), op=hvd.Sum,
                      name="ckpt")
        ref["state"] = hvd.compression_state()
        ref["ckpt"] = np.asarray(hvd.allreduce(
            hvd.shard(jnp.asarray(x[:, 1])), op=hvd.Sum, name="ckpt"))
        os.environ["HVD_TPU_HIERARCHICAL"] = "on"
        os.environ["HVD_TPU_VIRTUAL_SLICES"] = "2"
        xh = hvd.shard(jnp.asarray(d["hier"]))
        ref["hier.dcn"] = np.asarray(hvd.allreduce(xh, op=hvd.Sum,
                                                   name="hier.dcn"))
        os.environ["HVD_TPU_ICI_COMPRESS"] = "int8"
        ref["hier.ici"] = np.asarray(hvd.allreduce(xh, op=hvd.Sum,
                                                   name="hier.ici"))
    finally:
        hvd.set_compression()
        hvd.shutdown()
        os.environ.clear()
        os.environ.update(env0)
    return ref


def _port_state(ref_state):
    """The reference's one-process checkpoint as each rank's: the [4, T]
    residual's row r (index r of the list), the tick under ``mp``."""
    res = {k: np.asarray(v, np.float32).tolist()
           for k, v in ref_state["residuals"].items()}
    ticks = {}
    for k, v in ref_state["ticks"].items():
        key = json.loads(k)
        assert key[0] == "sp_pr"
        ticks[json.dumps(["mp"] + key[1:])] = v
    return {"residuals": res, "ticks": ticks}


def test_four_gloo_ranks_quantized_allreduce_matches_the_reference(tmp_path):
    d = _inputs()
    ref = _executor_reference(d)
    data_path = tmp_path / "data.npz"
    np.savez(data_path, **d)
    state_path = tmp_path / "state.json"
    state_path.write_text(json.dumps(_port_state(ref["state"])))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", ""),
           "HVD_TPU_QUANT_SEED": str(SEED)}
    for k in ("RANK", "WORLD_SIZE", "HOROVOD_TPU_SYNC_TIMEOUT",
              "HVD_TPU_COMPRESSION", "HVD_TPU_HIERARCHICAL",
              "HVD_TPU_VIRTUAL_SLICES", "HVD_TPU_DCN_COMPRESS",
              "HVD_TPU_ICI_COMPRESS"):
        env.pop(k, None)
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), store, str(data_path),
         str(state_path), str(tmp_path / f"out{r}.npz"),
         json.dumps(FLAT_CASES)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(N)]
    logs = []
    try:
        flat_ref = {case: _flat_reference(d, *case) for case in FLAT_CASES}
        int8 = J.WireFormat(kind="quant", name="int8", bits=8, block=256)
        emb_ref, _ = J.reference_allreduce(
            d["emb"].reshape(N, -1), int8, 0, seed=SEED,
            residuals=np.zeros((N, 512), np.float32))
        pair_ref, _ = J.reference_allreduce(
            d["pair"][:2], int8, 0, seed=SEED,
            residuals=np.zeros((2, 300), np.float32))
        avg_ref, _ = J.reference_allreduce(
            d["avg"].reshape(N, -1), int8, 0, seed=SEED,
            residuals=np.zeros((N, 210), np.float32))
        avg_ref = np.asarray(avg_ref) / np.float32(N)
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
        for case in FLAT_CASES:
            tag = "flat.{}.{}.{}.{}".format(*case)
            for tick in range(3):
                _same(out[f"{tag}.{tick}"], flat_ref[case][tick])
            assert int(out[f"{tag}.residuals"]) >= (case[2] == "1")
        _same(out["mix.emb"], np.asarray(emb_ref).reshape(64, 8))
        np.testing.assert_array_equal(out["mix.ln"], d["ln"][0] * N)
        assert list(out["mix.counts"]) == [2, 1, 1], (r, out["mix.counts"])
        _same(out["avg"], avg_ref.reshape(3, 70))
        np.testing.assert_array_equal(out["int"], d["int"].sum(0))
        np.testing.assert_array_equal(out["max"], d["avg"].max(0))
        np.testing.assert_array_equal(out["min"], d["avg"].min(0))
        assert int(out["never"]) == 0
        assert str(out["cast.dtype"]) == "torch.float32"
        exact = d["avg"].sum(0)
        np.testing.assert_allclose(out["cast"], exact, rtol=2 ** -6,
                                   atol=N * 2 ** -7)
        assert out["cast"].tobytes() != exact.tobytes()
        _same(out["ckpt"], ref["ckpt"][r])
        # The hierarchy.
        np.testing.assert_allclose(out["hier.full"], d["hier"].sum(0),
                                   rtol=1e-5, atol=1e-5)
        _same(out["hier.dcn"], ref["hier.dcn"][r])
        _same(out["hier.ici"], ref["hier.ici"][r])
        assert int(out["hier.launches"]) == 3
        assert int(out["hier.residuals"]) == 0
        # The hook optimizer: every rank's parameters bitwise equal, and
        # within the codebook's bound of the uncompressed run.  A rank's
        # residual element is at most one phase-1 step (<= 2 amax / 127)
        # plus the phase-2 step of its own chunk (<= 2 n amax / 127); the
        # error of a step's average is at most the residuals of two steps
        # summed over the ranks, / n: 4 (1 + n) amax / 127.  Two SGD steps
        # at lr 0.1, amax 10% above the largest gradient seen.
        gmax = max(float(o["hook.gmax"]) for o in outs) * 1.1
        bound = 0.1 * 2 * 4 * (1 + N) * gmax / 127
        for name in ("w1", "b1", "w2"):
            assert out[f"hook.{name}"].tobytes() == \
                outs[0][f"hook.{name}"].tobytes()
            diff = np.abs(out[f"hook.{name}"] - out[f"none.{name}"]).max()
            assert diff <= bound, (name, diff, bound)
        assert np.abs(out["hook.w1"] - out["none.w1"]).max() > 0
    for r in (0, 1):
        _same(outs[r]["pair"], pair_ref)
