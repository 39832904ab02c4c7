"""Process sets: collectives over a subset of ranks (port of
horovod_tpu/ops/process_set.py:33-113; ≙ Horovod's ``hvd.add_process_set``
and the ``process_set=`` argument).

A set is declared with GLOBAL rank numbers (sorted, deduplicated); on the
wire and in its coordinator the members are numbered 0..k-1 (set-local),
so readiness counting, stall reports and allgather size tables keep their
rank-table shape.  Broadcast's ``root_rank`` is the GLOBAL rank at the
API and set-local on the wire.  Each set has one ``torch.distributed``
group for its data (every rank creates it, members or not: the torch
rule) and, on rank 0, its own coordinator.  A non-member may not submit
into a set; ``join()`` works with the global set only.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..core import state as _state


class ProcessSet:
    """A registered subset of ranks (``process_set_id`` 0 = global)."""

    def __init__(self, process_set_id: int, ranks: Tuple[int, ...],
                 group=None):
        self.process_set_id = process_set_id
        self.ranks = tuple(sorted(ranks))
        self.group = group  # torch.distributed group of the set's data
        self.coordinator = None  # rank 0 only

    def size(self) -> int:
        return len(self.ranks)

    def included(self) -> bool:
        """Is the calling process a member?"""
        return _state.rank() in self.ranks

    def rank(self) -> int:
        """The caller's SET-LOCAL index, or -1 if not a member."""
        try:
            return self.ranks.index(_state.rank())
        except ValueError:
            return -1

    def local_rank_of(self, global_rank: int) -> int:
        try:
            return self.ranks.index(global_rank)
        except ValueError:
            raise ValueError(
                f"rank {global_rank} is not a member of process set "
                f"{self.process_set_id} (ranks {list(self.ranks)})"
            ) from None

    def close(self) -> None:
        if self.coordinator is not None:
            self.coordinator.close()
            self.coordinator = None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ProcessSet(id={self.process_set_id}, "
                f"ranks={list(self.ranks)})")


def get(process_set_id: int) -> Optional[ProcessSet]:
    """The registered set of that id, or None."""
    return _state.process_sets().get(process_set_id)
