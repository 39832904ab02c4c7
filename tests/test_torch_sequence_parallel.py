"""horovod_tpu_torch's sequence parallelism (parallel/sequence.py: ring and
Ulysses attention) and the collectives under it (parallel/axis_ops.py)
against horovod_tpu's, and against dense attention.

One spawned group of 4 gloo ranks (FileStore in tmp_path) runs every
multi-rank case on the meshes seq4 and data2 x seq2; the parent computes
the reference's ``shard_map`` on the same mesh shapes over the
conftest's CPU devices (shard ``i`` is rank ``i``) and ``mha_reference``
densely.  Inputs are drawn with numpy from a seed.

Tolerances are the reference tests' own (tests/test_sequence_parallel.py):
outputs 5e-5, gradients 1e-4; the collectives move or add f32 values in
one order and are held bitwise.  ``play_ring`` (the ring of 4 played in
one process, as ``chip_smoke.py`` plays it on the card) is held bitwise
against the 4-rank ring.
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
from horovod_tpu.core.topology import make_mesh as jmake_mesh
from horovod_tpu.ops.flash_attention import mha_reference as jmha
from horovod_tpu.parallel.sequence import (ring_attention as jring,
                                           ulysses_attention as julysses)
from horovod_tpu_torch.core.topology import MeshAxis
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.parallel import sequence as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
TOL, GTOL = 5e-5, 1e-4
# (split_axis, concat_axis) pairs that sequence.py and expert.py use.
A2A_PAIRS = [(1, 2), (2, 1), (0, 1), (1, 0)]

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.core.topology import make_mesh
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel import axis_ops
    from horovod_tpu_torch.parallel.sequence import (ring_attention,
                                                     ulysses_attention)

    torch.set_num_threads(1)
    rank, store, data_path, out_path = (int(sys.argv[1]), sys.argv[2],
                                        sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    hvd.init(device="cpu")
    d = {k: torch.from_numpy(v) for k, v in np.load(data_path).items()}
    seq4 = make_mesh(seq=4)
    dp2sp2 = make_mesh(data=2, seq=2)
    out = {}

    # Counting wrappers: the plain versions' calls stand for the kernel
    # launches a CUDA tensor would make.
    counts = {name: 0 for name in fa.KERNELS}
    for name in fa.KERNELS:
        def counted(*args, _fn=getattr(fa, name), _name=name):
            counts[_name] += 1
            return _fn(*args)
        setattr(fa, name, counted)

    def shard(x, mesh, batch=False):
        seq = mesh.axis("seq")
        s = x.shape[2] // seq.size
        x = x.narrow(2, seq.index * s, s)
        if batch:
            data = mesh.axis("data")
            b = x.shape[0] // data.size
            x = x.narrow(0, data.index * b, b)
        return x.contiguous()

    def run(tag, fn, mesh, qkv, w, batch=False, grads=True):
        q, k, v = (shard(d[n], mesh, batch).requires_grad_(True)
                   for n in qkv)
        for name in counts:
            counts[name] = 0
        o = fn(q, k, v)
        out[f"{tag}.o"] = o.detach().numpy()
        if grads:
            (o * d[w]).sum().backward()
            for n, x in zip("qkv", (q, k, v)):
                out[f"{tag}.d{n}"] = x.grad.numpy()
        out[f"{tag}.launches"] = np.array([counts[n] for n in fa.KERNELS])

    ax4, ax2 = seq4.axis("seq"), dp2sp2.axis("seq")
    for causal in (False, True):
        c = int(causal)
        run(f"ring4.{c}", lambda q, k, v: ring_attention(
            q, k, v, axis=ax4, causal=causal), seq4, ("q", "k", "v"), "w")
        run(f"ring4g.{c}", lambda q, k, v: ring_attention(
            q, k, v, axis=ax4, causal=causal), seq4,
            ("qg", "kg", "vg"), "wg")
        run(f"ring2.{c}", lambda q, k, v: ring_attention(
            q, k, v, axis=ax2, causal=causal), dp2sp2,
            ("qb", "kb", "vb"), "w", batch=True)
        run(f"uly4.{c}", lambda q, k, v: ulysses_attention(
            q, k, v, axis=ax4, causal=causal), seq4,
            ("qg", "kg", "vg"), "wg")
    try:
        ulysses_attention(*(shard(d[n], seq4) for n in ("q3",) * 3),
                          axis=ax4)
    except ValueError as e:
        out["uly.error"] = np.array(str(e))

    # The collectives over seq4, forward and backward.
    x = d["x"][rank].clone().requires_grad_(True)
    for split, concat in [tuple(p) for p in d["pairs"].tolist()]:
        x.grad = None
        y = axis_ops.all_to_all(x, ax4, split_axis=split, concat_axis=concat)
        (y * d[f"c.{split}.{concat}"][rank]).sum().backward()
        out[f"a2a.{split}.{concat}"] = y.detach().numpy()
        out[f"a2a.{split}.{concat}.grad"] = x.grad.numpy()
    for tag, fn in (
            ("psum", lambda t: axis_ops.psum(t, ax4)),
            ("gather", lambda t: axis_ops.all_gather(t, ax4, dim=1)),
            ("scatter", lambda t: axis_ops.psum_scatter(
                t, ax4, scatter_dimension=1)),
            ("ppermute", lambda t: axis_ops.ppermute(t, ax4))):
        x.grad = None
        y = fn(x)
        (y * d[f"c.{tag}"][rank]).sum().backward()
        out[tag] = y.detach().numpy()
        out[f"{tag}.grad"] = x.grad.numpy()
    np.savez(out_path, **out)
    hvd.shutdown()
    dist.destroy_process_group()
    print("WORKER_OK", rank, flush=True)
""")


def _inputs():
    rng = np.random.default_rng(5)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    d = {"q": normal(2, 4, 256, 32), "k": normal(2, 4, 256, 32),
         "v": normal(2, 4, 256, 32), "w": np.sin(np.arange(32)),
         "qg": normal(2, 4, 128, 16), "kg": normal(2, 4, 128, 16),
         "vg": normal(2, 4, 128, 16), "wg": np.sin(np.arange(16)),
         "qb": normal(4, 4, 128, 32), "kb": normal(4, 4, 128, 32),
         "vb": normal(4, 4, 128, 32), "q3": normal(2, 3, 256, 32),
         "x": normal(N, 8, 8, 8, 2), "pairs": np.array(A2A_PAIRS)}
    d["w"] = d["w"].astype(np.float32)
    d["wg"] = d["wg"].astype(np.float32)
    for s, c in A2A_PAIRS:
        shape = [8, 8, 8, 2]
        shape[s] //= N
        shape[c] *= N
        d[f"c.{s}.{c}"] = normal(N, *shape)
    d["c.psum"] = normal(N, 8, 8, 8, 2)
    d["c.gather"] = normal(N, 8, 32, 8, 2)
    d["c.scatter"] = normal(N, 8, 2, 8, 2)
    d["c.ppermute"] = normal(N, 8, 8, 8, 2)
    return d


def _sharded(fn, mesh, spec):
    return jax.jit(_compat.shard_map(fn, mesh=mesh, in_specs=spec,
                                     out_specs=spec, check_vma=False))


def _reference(d):
    """The reference's ring, Ulysses and collectives on the same mesh
    shapes; dense attention and its gradients."""
    ref = {}
    seq4 = jmake_mesh(seq=N, devices=jax.devices()[:N])
    dp2sp2 = jmake_mesh(data=2, seq=2, devices=jax.devices()[:N])
    spec, bspec = P(None, None, "seq"), P("data", None, "seq")
    for causal in (False, True):
        c = int(causal)
        for tag, mesh, sp, fn, names, w in (
                ("ring4", seq4, spec, jring, ("q", "k", "v"), "w"),
                ("ring4g", seq4, spec, jring, ("qg", "kg", "vg"), "wg"),
                ("ring2", dp2sp2, bspec, jring, ("qb", "kb", "vb"), "w"),
                ("uly4", seq4, spec, julysses, ("qg", "kg", "vg"), "wg")):
            q, k, v = (jnp.asarray(d[n]) for n in names)
            sm = _sharded(lambda q, k, v, fn=fn: fn(
                q, k, v, causal=causal, block_q=32, block_k=32), mesh, sp)
            wv = jnp.asarray(d[w])
            ref[f"{tag}.{c}"] = np.asarray(sm(q, k, v))
            ref[f"{tag}.{c}.grads"] = [np.asarray(g) for g in jax.grad(
                lambda q, k, v: jnp.sum(sm(q, k, v) * wv), (0, 1, 2))(
                    q, k, v)]
            ref[f"{tag}.{c}.dense"] = np.asarray(jmha(q, k, v,
                                                      causal=causal))
            ref[f"{tag}.{c}.dense_grads"] = [np.asarray(g) for g in jax.grad(
                lambda q, k, v: jnp.sum(jmha(q, k, v, causal=causal) * wv),
                (0, 1, 2))(q, k, v)]
    x = jnp.asarray(d["x"].reshape(N * 8, 8, 8, 2))
    one = P("seq")
    for s, c in A2A_PAIRS:
        sm = _sharded(lambda t, s=s, c=c: jax.lax.all_to_all(
            t, "seq", split_axis=s, concat_axis=c, tiled=True), seq4, one)
        cot = jnp.asarray(d[f"c.{s}.{c}"].reshape(
            (N * d[f"c.{s}.{c}"].shape[1],) + d[f"c.{s}.{c}"].shape[2:]))
        ref[f"a2a.{s}.{c}"] = np.asarray(sm(x))
        ref[f"a2a.{s}.{c}.grad"] = np.asarray(jax.grad(
            lambda t: jnp.sum(sm(t) * cot))(x))
    for tag, fn in (
            ("psum", lambda t: jax.lax.psum(t, "seq")),
            ("gather", lambda t: jax.lax.all_gather(t, "seq", axis=1,
                                                    tiled=True)),
            ("scatter", lambda t: jax.lax.psum_scatter(
                t, "seq", scatter_dimension=1, tiled=True)),
            ("ppermute", lambda t: jax.lax.ppermute(
                t, "seq", [(i, (i + 1) % N) for i in range(N)]))):
        sm = _sharded(fn, seq4, one)
        c = d[f"c.{tag}"]
        cot = jnp.asarray(c.reshape((N * c.shape[1],) + c.shape[2:]))
        ref[tag] = np.asarray(sm(x))
        ref[f"{tag}.grad"] = np.asarray(jax.grad(
            lambda t: jnp.sum(sm(t) * cot))(x))
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sequence_parallel")
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
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in log, log
    outs = [dict(np.load(tmp / f"out{r}.npz")) for r in range(N)]
    return d, ref, outs


def _block(full, rank, ring, batch=False):
    """Rank ``rank``'s shard of a [b, h, s, d] tensor: the sequence over
    the seq axis (the inner axis of the mesh), the batch over data."""
    seq_i, data_i = (rank % ring, rank // ring) if batch else (rank, 0)
    s = full.shape[2] // ring
    out = full[:, :, seq_i * s:(seq_i + 1) * s]
    if batch:
        b = full.shape[0] // 2
        out = out[data_i * b:(data_i + 1) * b]
    return out


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


CASES = [(tag, c) for tag in ("ring4", "ring4g", "ring2", "uly4")
         for c in (0, 1)]


@pytest.mark.parametrize("tag,causal", CASES)
def test_attention_matches_reference_and_dense(runs, tag, causal):
    _, ref, outs = runs
    ring, batch = (2, True) if tag == "ring2" else (N, False)
    key = f"{tag}.{causal}"
    for r, out in enumerate(outs):
        for want in (ref[key], ref[f"{key}.dense"]):
            assert _err(out[f"{key}.o"], _block(want, r, ring, batch)) < TOL


@pytest.mark.parametrize("tag,causal", CASES)
def test_gradients_match_reference_and_dense(runs, tag, causal):
    _, ref, outs = runs
    ring, batch = (2, True) if tag == "ring2" else (N, False)
    key = f"{tag}.{causal}"
    for r, out in enumerate(outs):
        for wants in (ref[f"{key}.grads"], ref[f"{key}.dense_grads"]):
            for n, want in zip("qkv", wants):
                got = out[f"{key}.d{n}"]
                assert _err(got, _block(want, r, ring, batch)) < GTOL, n


@pytest.mark.parametrize("causal", [0, 1])
def test_ring_launches_per_rank(runs, causal):
    """A causal ring of n launches my + 1 of each kernel on rank my
    (n(n+1)/2 in all); a non-causal one n on every rank."""
    _, _, outs = runs
    for my, out in enumerate(outs):
        want = my + 1 if causal else N
        assert out[f"ring4.{causal}.launches"].tolist() == [want] * 3
        ring2_my = my % 2
        assert out[f"ring2.{causal}.launches"].tolist() == \
            [ring2_my + 1 if causal else 2] * 3
    total = sum(int(out[f"ring4.{causal}.launches"][0]) for out in outs)
    assert total == (N * (N + 1) // 2 if causal else N * N)


@pytest.mark.parametrize("causal", [False, True])
def test_play_ring_is_the_ring_bitwise(runs, causal):
    d, _, outs = runs
    q, k, v = (torch.from_numpy(d[n]) for n in ("qg", "kg", "vg"))
    g = torch.from_numpy(d["wg"]).expand_as(q).contiguous()
    o, dq, dk, dv = ts.play_ring(q, k, v, g, N, causal=causal)
    c = int(causal)
    for r, out in enumerate(outs):
        for name, got in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
            mine = _block(got.numpy(), r, N)
            assert mine.tobytes() == out[f"ring4g.{c}.{name}"].tobytes(), \
                (name, r)


def test_ulysses_rejects_indivisible_heads(runs):
    _, _, outs = runs
    for out in outs:
        assert "divisible" in str(out["uly.error"])


@pytest.mark.parametrize("pair", A2A_PAIRS)
def test_all_to_all_matches_jax_tiled_bitwise(runs, pair):
    _, ref, outs = runs
    s, c = pair
    for key in (f"a2a.{s}.{c}", f"a2a.{s}.{c}.grad"):
        blocks = np.split(ref[key], N, axis=0)
        for r, out in enumerate(outs):
            assert out[key].tobytes() == blocks[r].tobytes(), (key, r)


@pytest.mark.parametrize("tag", ["psum", "gather", "scatter", "ppermute"])
def test_collective_and_its_transpose_match_jax(runs, tag):
    _, ref, outs = runs
    for key in (tag, f"{tag}.grad"):
        blocks = np.split(ref[key], N, axis=0)
        for r, out in enumerate(outs):
            # Four-term sums may be added in another order: 1 ulp.
            np.testing.assert_allclose(out[key], blocks[r], rtol=1e-6,
                                       atol=1e-6, err_msg=f"{key} {r}")


def test_merge_of_minus_inf_partials_gives_no_nan():
    ninf = torch.full((1, 2, 3), float("-inf"))
    assert torch.equal(torch.logaddexp(ninf, ninf), ninf)
    o, lse = ts._merge_partial(torch.zeros(1, 2, 3, 4), ninf,
                               torch.zeros(1, 2, 3, 4), ninf)
    assert torch.equal(lse, ninf)
    assert not torch.isnan(o).any() and torch.equal(o, torch.zeros_like(o))


def test_future_chunk_launches_nothing_and_equals_merging_its_partial():
    """The skip branch leaves (o, lse) and the gradient accumulators as
    they are: bitwise what merging the reference's zeros/-inf partial (and
    adding its zero gradients) gives."""
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((1, 2, 16, 8))
                                   .astype(np.float32)) for _ in range(4))
    o, lse = ts._forward_hop(q, k, v, 1, 1, True, 0.35, None, None)
    calls = []
    real = tfa.flash_fwd
    try:
        tfa.flash_fwd = lambda *a: calls.append(a) or real(*a)
        o2, lse2 = ts._forward_hop(q, k, v, 2, 1, True, 0.35, o, lse)
    finally:
        tfa.flash_fwd = real
    assert not calls and o2 is o and lse2 is lse
    merged, mlse = ts._merge_partial(o, lse, torch.zeros_like(o),
                                     torch.full_like(lse, float("-inf")))
    assert torch.equal(merged, o2) and torch.equal(mlse, lse2)
    assert merged.numpy().tobytes() == o2.numpy().tobytes()
    acc = ts._backward_hop(q, k, v, o.to(q.dtype), lse, g, 1, 1, True, 0.35,
                           None, None, None)
    skipped = ts._backward_hop(q, k, v, o.to(q.dtype), lse, g, 2, 1, True,
                               0.35, *acc)
    for a, b in zip(acc, skipped):
        assert a is b
        assert (a + torch.zeros_like(a)).numpy().tobytes() == \
            b.numpy().tobytes()


def test_ring_and_ulysses_of_one_are_flash_attention_bitwise():
    """A ring of one posts no P2P and does one diagonal hop; Ulysses over
    one rank exchanges nothing: both give flash_attention's bits."""
    rng = np.random.default_rng(1)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, 4, 64, 16))
                                   .astype(np.float32)) for _ in range(4))
    axis = MeshAxis.local("seq")
    results = []
    for fn in (lambda *t: tfa.flash_attention(*t, causal=True),
               lambda *t: ts.ring_attention(*t, axis=axis, causal=True),
               lambda *t: ts.ulysses_attention(*t, axis=axis, causal=True)):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*leaves)
        o.backward(g)
        results.append([o.detach()] + [t.grad for t in leaves])
    for other in results[1:]:
        for a, b in zip(results[0], other):
            assert a.numpy().tobytes() == b.numpy().tobytes()
