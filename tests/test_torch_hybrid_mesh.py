"""horovod_tpu_torch's make_hybrid_mesh (core/topology.py) against
horovod_tpu's: the hybrid cases of tests/test_topology.py.

The rank grid is held equal to the reference's ``_hybrid_layout`` device
grid (rank r in place of the device with id r, the same slice map) at 8
and 16 positions over 2 and 4 slices, with degrees that split the
cross-slice axis and that do not, and with interleaved slices.  One
spawned job of 4 gloo ranks builds the meshes (the single-host fallback,
a declared slice map) and trains a transformer on ``data=2, model=2``
over 2 declared slices through make_parallel_train_step, against the
reference's hybrid mesh on 4 of the conftest's CPU devices (losses
within the parallel-transformer tests' 1e-4 of their scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from gloo_job import GlooJob, flat
from horovod_tpu.core import topology as jT
from horovod_tpu.models import transformer as jt
from horovod_tpu.parallel.training import (make_parallel_train_step,
                                           shard_parallel_batch)
from horovod_tpu_torch.core import state as tstate
from horovod_tpu_torch.core import topology as T

N = 4
RTOL = 1e-4
CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq_len=64)
SLICES = {0: 0, 1: 1, 2: 0, 3: 1}  # interleaved: slice 0 = ranks 0 and 2

WORKER = f"CFG, SLICES = {CFG!r}, {SLICES!r}\n" + """
from horovod_tpu_torch.core.topology import make_hybrid_mesh, make_mesh
from horovod_tpu_torch.models import transformer as tt
from horovod_tpu_torch.parallel.training import make_parallel_train_step

out = {}
one = make_hybrid_mesh(data=2, model=2)  # one host: make_mesh's mesh
plain = make_mesh(data=2, model=2)
out["single.grid"], out["plain.grid"] = one.ranks, plain.ranks
out["single.lines"] = [r for ax in one.axes for r in (ax.size,) + ax.ranks]
out["plain.lines"] = [r for ax in plain.axes
                      for r in (ax.size,) + ax.ranks]

mesh = make_hybrid_mesh(data=2, model=2, slice_map=SLICES)
out["hybrid.grid"] = mesh.ranks
out["hybrid.model_line"] = mesh.axis("model").ranks
out["hybrid.data_line"] = mesh.axis("data").ranks
ax = tt.ParallelAxes(data="data", model="model")
params = tree("params")
opt = torch.optim.Adam(hvd.tree_leaves(params), lr=1e-2)
cfg = tt.TransformerConfig(**CFG)
step = make_parallel_train_step(tt.make_loss_fn(cfg, ax, mesh), opt, mesh,
                                ("data", None))
batch = (torch.from_numpy(D["tokens"]).long(),
         torch.from_numpy(D["targets"]).long())
out["losses"] = [float(step(params, batch)) for _ in range(3)]
finish(out)
"""


class _FakeDev:
    """A device as the reference's hybrid layout sees it (its id)."""

    def __init__(self, i, s):
        self.id = i
        self.slice_index = s
        self.process_index = s
        self.platform = "tpu"
        self.device_kind = "faketpu"
        self.coords = (i % 4, 0, 0)
        self.core_on_chip = 0


# positions, slice of a position, degrees, dcn axes
GRID_CASES = {
    "8_2slices_data2_model4": (8, lambda i: i // 4,
                               dict(data=2, model=4), ("data",)),
    "8_2slices_data4_model2_split": (8, lambda i: i // 4,
                                     dict(data=4, model=2), ("data",)),
    "8_2slices_data2_seq2_model2": (8, lambda i: i // 4,
                                    dict(data=2, seq=2, model=2),
                                    ("data",)),
    "8_2slices_interleaved": (8, lambda i: i % 2, dict(data=4, model=2),
                              ("data",)),
    "16_4slices_data4_model4": (16, lambda i: i // 4,
                                dict(data=4, model=4), ("data",)),
    "16_4slices_data8_model2_split": (16, lambda i: i // 4,
                                      dict(data=8, model=2), ("data",)),
    "16_2slices_data4_seq2_model2_split": (16, lambda i: i // 8,
                                           dict(data=4, seq=2, model=2),
                                           ("data",)),
    "16_4slices_data_and_pipe_across": (16, lambda i: i // 4,
                                        dict(data=2, pipe=2, model=4),
                                        ("data", "pipe")),
}


def _reference_ids(n, slice_of, degrees, dcn_axes):
    devs = [_FakeDev(i, slice_of(i)) for i in range(n)]
    mesh = jT.make_hybrid_mesh(devices=devs, dcn_axes=dcn_axes,
                               slice_map={i: slice_of(i) for i in range(n)},
                               **degrees)
    return mesh.axis_names, np.vectorize(lambda d: d.id)(mesh.devices)


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_hybrid_grid_matches_reference_layout(case):
    n, slice_of, degrees, dcn_axes = GRID_CASES[case]
    want_names, want = _reference_ids(n, slice_of, degrees, dcn_axes)
    names, grid = T._hybrid_grid(ranks=range(n), dcn_axes=dcn_axes,
                                 slice_map=slice_of, **degrees)
    assert names == tuple(want_names)
    np.testing.assert_array_equal(grid, want)
    # Every per-layer (model) line stays inside one slice.
    lines = np.moveaxis(grid, -1, 0).reshape(grid.shape[-1], -1).T
    for line in lines:
        assert len({slice_of(int(r)) for r in line}) == 1, line


def test_hybrid_mesh_places_ici_axes_within_slices():
    """2 slices x 4: data=2 x model=4 puts each model line in one slice;
    data=4 x model=2 splits data 2 across and 2 inside."""
    _, grid = T._hybrid_grid(ranks=range(8), slice_map=lambda r: r // 4,
                             data=2, model=4)
    for d in range(2):
        assert {int(r) // 4 for r in grid.reshape(2, 4)[d]} == {d}
    _, grid = T._hybrid_grid(ranks=range(8), slice_map=lambda r: r // 4,
                             data=4, model=2)
    rows = grid.reshape(4, 2)
    for d in range(4):
        assert len({int(r) // 4 for r in rows[d]}) == 1, rows[d]
    assert {int(r) // 4 for r in rows[:, 0]} == {0, 1}


def test_hybrid_mesh_validates_dcn_axes():
    with pytest.raises(ValueError, match="tile the slices"):
        T.make_hybrid_mesh(data=4, model=3, ranks=range(12),
                           slice_map=lambda r: r // 4, dcn_axes=("data",))
    with pytest.raises(ValueError, match="not in mesh axes"):
        T.make_hybrid_mesh(data=2, model=4, ranks=range(8),
                           slice_map=lambda r: r // 4, dcn_axes=("expert",))


def test_hybrid_grid_slices_by_host():
    """With no slice map a slice is a host: the host list init gathers."""
    saved = tstate._state.hosts
    tstate._state.hosts = ("b", "a", "b", "a")
    try:
        _, grid = T._hybrid_grid(ranks=range(4), data=2, model=2)
        assert grid.reshape(2, 2).tolist() == [[0, 2], [1, 3]]
        tstate._state.hosts = ("a",) * 4
        assert T._hybrid_grid(ranks=range(4), data=2, model=2)[1] is None
    finally:
        tstate._state.hosts = saved


def _reference_training(params, tokens, targets):
    devs = jax.devices()[:N]
    mesh = jT.make_hybrid_mesh(data=2, model=2, devices=devs,
                               slice_map={d.id: SLICES[i]
                                          for i, d in enumerate(devs)})
    cfg = jt.TransformerConfig(**CFG, block_q=16, block_k=16)
    ax = jt.ParallelAxes(data="data", model="model")
    loss_fn = jt.make_loss_fn(cfg, ax, mesh_axes=mesh.axis_names)
    opt = optax.adam(1e-2)
    step = make_parallel_train_step(loss_fn, opt, mesh,
                                    jax.sharding.PartitionSpec("data", None),
                                    donate=False)
    batch = shard_parallel_batch(
        (jnp.asarray(tokens), jnp.asarray(targets)), mesh,
        jax.sharding.PartitionSpec("data", None))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(params)
    losses = []
    for _ in range(3):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    return np.vectorize(lambda d: d.id)(mesh.devices), losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params = jax.tree_util.tree_map(np.asarray, jt.init_transformer(
        jax.random.PRNGKey(0), jt.TransformerConfig(**CFG)))
    tokens, targets = (np.asarray(x) for x in jt.synthetic_lm_batch(
        jax.random.PRNGKey(1), 8, 16, CFG["vocab_size"]))
    data = {"tokens": tokens, "targets": targets, **flat(params, "params")}
    job = GlooJob(tmp_path_factory.mktemp("hybrid"), WORKER, N, data)
    try:
        ref = _reference_training(params, tokens, targets)
    except BaseException:
        job.kill()
        raise
    return ref, job.results()


def test_hybrid_mesh_falls_back_on_single_slice(runs):
    """Every rank on one host: make_mesh's mesh, lines and all."""
    _, outs = runs
    for out in outs:
        np.testing.assert_array_equal(out["single.grid"], out["plain.grid"])
        np.testing.assert_array_equal(out["single.lines"],
                                      out["plain.lines"])


def test_hybrid_mesh_slice_map_layout(runs):
    """Ranks 0, 2 and 1, 3 declared as two slices: each model line lies
    in one slice, the data lines cross them, and the grid is the
    reference's over the same slice map."""
    (ref_grid, _), outs = runs
    for r, out in enumerate(outs):
        grid = out["hybrid.grid"]
        np.testing.assert_array_equal(grid.reshape(ref_grid.shape), ref_grid)
        assert grid.reshape(2, 2).tolist() == [[0, 2], [1, 3]]
        assert len({SLICES[int(x)] for x in out["hybrid.model_line"]}) == 1
        assert {SLICES[int(x)] for x in out["hybrid.data_line"]} == {0, 1}
        assert r in out["hybrid.model_line"]


def test_hybrid_mesh_trains_end_to_end(runs):
    """dp2 across the declared slices x tp2 inside one: the loss is
    finite, falls, and tracks the reference's on its hybrid mesh."""
    (_, ref_losses), outs = runs
    for out in outs:
        losses = out["losses"]
        assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
        err = float(np.max(np.abs(losses - np.asarray(ref_losses))))
        assert err <= RTOL * max(abs(x) for x in ref_losses), (
            losses, ref_losses)
        assert losses.tobytes() == outs[0]["losses"].tobytes()
