"""The two-tier replica hierarchy of a job (port of
horovod_tpu/core/topology.py:243-341).

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
Mesh building (``make_mesh``, ``make_hybrid_mesh``) is ROADMAP.md A.3.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

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
