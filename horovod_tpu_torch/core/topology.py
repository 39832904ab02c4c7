"""The multi-axis mesh of a job, and its two-tier replica hierarchy
(port of horovod_tpu/core/topology.py:44-117, :243-371).

**The mesh** (:func:`make_mesh`).  The reference's mesh is an array of
devices under ``shard_map``; the port's is an object over the job's
ranks, one process a rank.  Rank ``r`` sits at the row-major position
``r`` of the mesh's shape in :data:`_AXIS_ORDER` (the reference places
device ``r`` there: ``np.asarray(devs).reshape(shape)``), so shard *i*
of a reference mesh over ``jax.devices()[:n]`` is rank *i* here.  Each
axis of the mesh is a :class:`MeshAxis`: this rank's coordinate along
it, its size, and a process group over the ranks that differ from this
one only along it.  The reference finds an axis from the ``shard_map``
context by name; the port has no such context, so the parallel
functions take the axis object from the caller (``mesh.axis("seq")``).
A size-1 axis keeps a group too, so the code is the same at every size.
The hybrid mesh (:func:`make_hybrid_mesh`, reference :120-233) lays a
multi-node job out so that the gradient axes (``data``) cross nodes and
every per-layer axis stays inside one node; a reference slice is a node
here, and a rank's node its host.

**The hierarchy** (:func:`replica_hierarchy`).

On a TPU the tiers are ICI inside a slice and DCN between slices; on
GPUs they are NVLink inside a node and the network between nodes, and a
rank's node is its host (the per-rank host list ``core/state.init``
gathers).  The hierarchical allreduce (:mod:`..ops.megakernel`)
reduce-scatters inside each node, sums the fragments across nodes and
all-gathers inside the node again, so only 1/node_size of the bytes
cross the network.  The names ``ici`` and ``dcn`` are kept from the
reference for the intra- and inter-node groups.

Env contract:
  HVD_TPU_HIERARCHICAL=auto|on|off   auto (default): hierarchical when
                                     more than one host holds an equal
                                     number of ranks; on: also honour
                                     HVD_TPU_VIRTUAL_SLICES on one host;
                                     off: always flat.
  HVD_TPU_VIRTUAL_SLICES=<k>         declare k equal contiguous virtual
                                     nodes (tests on one host).

Unequal nodes degrade to flat: the groups need a rectangular layout.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

HIERARCHICAL_ENV = "HVD_TPU_HIERARCHICAL"
VIRTUAL_SLICES_ENV = "HVD_TPU_VIRTUAL_SLICES"


def hierarchical_mode() -> str:
    mode = os.environ.get(HIERARCHICAL_ENV, "auto").lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(
            f"{HIERARCHICAL_ENV}={mode!r}: expected auto, on or off")
    return mode


def validate_env() -> None:
    """Fail ``init()``, not the first collective, on a malformed topology
    knob."""
    hierarchical_mode()
    value = os.environ.get(VIRTUAL_SLICES_ENV)
    if value:
        try:
            int(value)
        except ValueError:
            raise ValueError(
                f"{VIRTUAL_SLICES_ENV}={value!r}: expected an "
                f"integer") from None


@dataclass(frozen=True)
class ReplicaHierarchy:
    """Node x network decomposition of n ranks.  ``ici_groups``: one
    group of ranks per node; ``dcn_groups``: one per in-node position,
    pairing the k-th rank of every node."""

    n_slices: int
    ici_size: int
    ici_groups: Tuple[Tuple[int, ...], ...]
    dcn_groups: Tuple[Tuple[int, ...], ...]

    def slice_of_positions(self) -> Tuple[int, ...]:
        """Node ordinal of every rank."""
        table = [0] * (self.n_slices * self.ici_size)
        for si, group in enumerate(self.ici_groups):
            for pos in group:
                table[pos] = si
        return tuple(table)


def replica_hierarchy(hosts: Sequence[str]) -> Optional[ReplicaHierarchy]:
    """The hierarchy of the ranks whose hosts are ``hosts`` (rank order),
    or None when flat.  Nodes are ordered by their lowest rank."""
    mode = hierarchical_mode()
    if mode == "off":
        return None
    n = len(hosts)
    if n < 2:
        return None
    by_slice: dict = {}
    if len(set(hosts)) > 1:
        for pos, host in enumerate(hosts):
            by_slice.setdefault(host, []).append(pos)
    elif mode == "on":
        k = int(os.environ.get(VIRTUAL_SLICES_ENV, "0") or 0)
        if k > 1 and n % k == 0:
            ici = n // k
            by_slice = {s: list(range(s * ici, (s + 1) * ici))
                        for s in range(k)}
    if len(by_slice) < 2:
        return None
    if len({len(g) for g in by_slice.values()}) != 1:
        return None  # ragged nodes: no rectangular decomposition
    ici_groups = tuple(tuple(g) for g in by_slice.values())
    ici = len(ici_groups[0])
    dcn_groups = tuple(tuple(g[i] for g in ici_groups)
                       for i in range(ici))
    return ReplicaHierarchy(
        n_slices=len(ici_groups), ici_size=ici,
        ici_groups=ici_groups, dcn_groups=dcn_groups)


# ---------------------------------------------------------------------------
# The multi-axis mesh (reference :44-117, :342-371)
# ---------------------------------------------------------------------------

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"

# Outermost -> innermost (slowest -> fastest links).
_AXIS_ORDER = (DATA_AXIS, PIPE_AXIS, EXPERT_AXIS, SEQ_AXIS, MODEL_AXIS)


@dataclass(frozen=True)
class ParallelConfig:
    """Degrees of each parallelism strategy; their product is the rank
    count.  ``expert`` 0 (the default) rides the data axis; > 0 makes
    it an axis of its own."""

    data: int = 1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 0

    @property
    def device_count(self) -> int:
        n = self.data * self.model * self.seq * self.pipe
        return n * (self.expert if self.expert > 0 else 1)

    def axis_sizes(self) -> dict:
        sizes = {DATA_AXIS: self.data, PIPE_AXIS: self.pipe,
                 SEQ_AXIS: self.seq, MODEL_AXIS: self.model}
        if self.expert > 0:
            sizes[EXPERT_AXIS] = self.expert
        return sizes


@dataclass(frozen=True)
class MeshAxis:
    """One axis of a mesh as this rank sees it: ``index`` is its
    coordinate, ``ranks`` the global ranks along its line in coordinate
    order, ``group`` the process group over them (None only for
    :meth:`local`, which has no peers)."""

    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Any = None

    @classmethod
    def local(cls, name: str) -> "MeshAxis":
        """A size-1 axis with no process group: a caller with no mesh."""
        return cls(name=name, size=1, index=0, ranks=(0,))


@dataclass(frozen=True, eq=False)
class Mesh:
    """The ranks of a job laid out on named axes (see the module
    docstring).  ``group`` spans every rank of the mesh."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    ranks: np.ndarray  # the rank at each position (reference mesh.devices)
    axes: Tuple[MeshAxis, ...]
    group: Any

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def axis(self, name: str) -> MeshAxis:
        for ax in self.axes:
            if ax.name == name:
                return ax
        raise ValueError(
            f"mesh with axes {self.axis_names} has no axis {name!r}; build "
            f"it with horovod_tpu_torch.core.topology.make_mesh(...)")


def _resolve(config, ranks, degrees):
    """``(config, ranks)``: the config from keywords, and ranks default
    every rank of the job, as many as the config needs."""
    if config is None:
        config = ParallelConfig(**degrees)
    elif degrees:
        raise TypeError("pass either a ParallelConfig or keyword degrees, "
                        "not both")
    if ranks is None:
        if not dist.is_initialized():
            raise RuntimeError("make_mesh needs torch.distributed "
                               "initialised (horovod_tpu_torch.init() does "
                               "it)")
        ranks = range(dist.get_world_size())
    ranks = list(ranks)
    if config.device_count != len(ranks):
        raise ValueError(
            f"parallel config {config} needs {config.device_count} devices "
            f"but {len(ranks)} were provided")
    return config, ranks


def _names_and_sizes(config):
    sizes = config.axis_sizes()
    return tuple(a for a in _AXIS_ORDER if a in sizes), sizes


def make_mesh(config: Optional[ParallelConfig] = None,
              ranks: Optional[Sequence[int]] = None, **degrees) -> Mesh:
    """The mesh of a parallel configuration over ``ranks`` (default
    every rank of the job), from a :class:`ParallelConfig` or degrees as
    keywords (``make_mesh(data=2, model=2)``).  Size-1 axes are kept.

    Collective: every rank of the job calls it with the same arguments,
    since each axis line's group is created by every rank, in one order
    (``dist.new_group``)."""
    config, ranks = _resolve(config, ranks, degrees)
    names, sizes = _names_and_sizes(config)
    shape = tuple(sizes[a] for a in names)
    return _mesh_from_grid(names, np.asarray(ranks).reshape(shape))


def _mesh_from_grid(names: Tuple[str, ...], grid: np.ndarray,
                    outside_ok: bool = False) -> Mesh:
    """The mesh whose position ``idx`` holds rank ``grid[idx]``: every
    axis line's group created by every rank, in one order.  A rank
    outside the grid raises, or with ``outside_ok`` gets the mesh with
    no axes of its own (the pipeline's stage meshes: every rank knows
    every stage's ranks)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(horovod_tpu_torch.init() does it)")
    shape = grid.shape
    ranks = grid.reshape(-1).tolist()
    me = dist.get_rank()
    axes = []
    for dim, name in enumerate(names):
        # Every line along this axis (the other coordinates fixed); every
        # rank creates each line's group, in this order.
        lines = np.moveaxis(grid, dim, -1).reshape(-1, shape[dim]).tolist()
        groups = [dist.new_group(line) for line in lines]
        for line, group in zip(lines, groups):
            if me in line:
                axes.append(MeshAxis(name=name, size=shape[dim],
                                     index=line.index(me), ranks=tuple(line),
                                     group=group))
    whole = dist.new_group(ranks)
    if me not in ranks and not outside_ok:
        raise ValueError(f"rank {me} is not in the mesh's ranks {ranks}")
    return Mesh(axis_names=names, shape=shape, ranks=grid,
                axes=tuple(axes), group=whole)


def _hybrid_layout(ranks, slice_of, names, sizes, dcn_factor) -> np.ndarray:
    """The reference's explicit hybrid layout (:120), over ranks: the
    outer (cross-node) block of each split axis crosses nodes, the inner
    block stays inside one node.  Nodes are taken in sorted id order and
    a node's ranks in the order given."""
    groups: dict = {}
    for r in ranks:
        groups.setdefault(slice_of(r), []).append(r)
    slice_ids = sorted(groups)
    if len({len(g) for g in groups.values()}) != 1:
        raise ValueError(
            f"slices must be equal-sized; got "
            f"{ {s: len(g) for s, g in groups.items()} }")
    shape = tuple(sizes[a] for a in names)
    ici_shape = [sizes[a] // dcn_factor.get(a, 1) for a in names]
    dcn_shape = [dcn_factor.get(a, 1) for a in names]
    grid = np.empty(shape, dtype=np.int64)
    for idx in np.ndindex(shape):
        dcn_coord = [i // m for i, m in zip(idx, ici_shape)]
        ici_coord = [i % m for i, m in zip(idx, ici_shape)]
        sid = int(np.ravel_multi_index(dcn_coord, dcn_shape))
        wid = int(np.ravel_multi_index(ici_coord, ici_shape))
        grid[idx] = groups[slice_ids[sid]][wid]
    return grid


def _hybrid_grid(config: Optional[ParallelConfig] = None,
                 ranks: Optional[Sequence[int]] = None,
                 dcn_axes: Tuple[str, ...] = (DATA_AXIS,), slice_map=None,
                 **degrees) -> Tuple[Tuple[str, ...], Optional[np.ndarray]]:
    """``(axis names, rank grid)`` of :func:`make_hybrid_mesh`, the grid
    None on one node.  Creates no group."""
    import math

    config, ranks = _resolve(config, ranks, degrees)
    if slice_map is None:
        from . import state as _st

        # A node is a host, numbered by its lowest rank.
        hosts = _st._state.hosts
        node = {h: i for i, h in enumerate(dict.fromkeys(hosts))}
        slice_of = (lambda r: node[hosts[r]]) if hosts else (lambda r: 0)
    elif callable(slice_map):
        slice_of = slice_map
    else:
        slice_of = slice_map.__getitem__
    names, sizes = _names_and_sizes(config)
    num_slices = len({slice_of(r) for r in ranks})
    if num_slices <= 1:
        return names, None
    for a in dcn_axes:
        if a not in names:
            raise ValueError(f"dcn axis {a!r} not in mesh axes {names}")
    # Split each cross-node axis's degree into (cross-node, in-node)
    # factors, outermost first, until the nodes are exactly tiled.
    remaining = num_slices
    dcn_factor = {}
    for a in dcn_axes:
        f = math.gcd(sizes[a], remaining)
        dcn_factor[a] = f
        remaining //= f
    if remaining != 1:
        raise ValueError(
            f"DCN axes {dcn_axes} with degrees "
            f"{[sizes[a] for a in dcn_axes]} cannot tile {num_slices} "
            f"slices; the cross-slice axes must tile the slices exactly.")
    return names, _hybrid_layout(ranks, slice_of, names, sizes, dcn_factor)


def make_hybrid_mesh(config: Optional[ParallelConfig] = None,
                     ranks: Optional[Sequence[int]] = None,
                     dcn_axes: Tuple[str, ...] = (DATA_AXIS,),
                     slice_map=None, **degrees) -> Mesh:
    """The mesh of a multi-node job (reference :148): the ``dcn_axes``
    (outermost first; default ``data``, whose gradient exchange happens
    once a step) cross nodes over the network, and every per-layer axis
    (``model``, ``seq``, ``expert``) stays inside one node on NVLink.

    A node is a host (the host list ``init`` gathers).  ``slice_map``, a
    callable ``rank -> node id`` or a mapping ``{rank: node id}``,
    declares the nodes instead: the tests train over ranks of one host
    declared as two nodes.  On one node it is :func:`make_mesh`
    unchanged.  A cross-node axis whose degree exceeds its share of the
    node count is split: 2 nodes x 4 GPUs with ``data=4, model=2`` put a
    2-way data factor across nodes and a 2-way one inside each.

    Collective, as :func:`make_mesh`."""
    names, grid = _hybrid_grid(config, ranks, dcn_axes, slice_map,
                               **degrees)
    if grid is None:
        return make_mesh(config, ranks, **degrees)
    return _mesh_from_grid(names, grid)


def mesh_axis_sizes(mesh: Mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def validate_mesh(mesh: Mesh, required_axes: Tuple[str, ...]) -> None:
    """Raise with a clear message when a strategy is used on a mesh that
    lacks its axis (reference :360)."""
    missing = [a for a in required_axes if a not in mesh.axis_names]
    if missing:
        raise ValueError(
            f"mesh with axes {mesh.axis_names} is missing required "
            f"axes {missing}; build it with horovod_tpu_torch.core."
            f"topology.make_mesh(...)")
