"""The Tensor Fusion packing decision (copied from
horovod_tpu/ops/cache.py:141-191; the reference's ``ResponseCache`` is
later work, ROADMAP.md A.2)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from . import wire
from .wire import ResponseType


@dataclass
class _FusionMeta:
    """The fields the fusion packing decision reads, per response."""

    response_type: ResponseType
    devices: Tuple[int, ...]
    reduce_op: wire.ReduceOp
    process_set_id: int
    dtype: Optional[wire.DataType]
    nbytes: int


def plan_fusion(metas: List[_FusionMeta],
                threshold_of: Callable[[int], int]) -> List[List[int]]:
    """Same-dtype, same-device, same-reduce-op, same-process-set
    ALLREDUCE responses merge while the payload sum stays under the
    process set's fusion threshold (≙ operations.cc:1328-1374); Adasum
    never fuses.  Returns index groups in emission order."""
    n = len(metas)
    used = [False] * n
    groups: List[List[int]] = []
    for i in range(n):
        if used[i]:
            continue
        used[i] = True
        m = metas[i]
        group = [i]
        if m.response_type != ResponseType.ALLREDUCE \
                or m.reduce_op == wire.ReduceOp.ADASUM:
            groups.append(group)
            continue
        total = m.nbytes
        threshold = threshold_of(m.process_set_id)
        for j in range(i + 1, n):
            if used[j]:
                continue
            o = metas[j]
            if (o.response_type == ResponseType.ALLREDUCE
                    and o.devices == m.devices
                    and o.reduce_op == m.reduce_op
                    and o.process_set_id == m.process_set_id
                    and o.dtype == m.dtype
                    and total + o.nbytes <= threshold):
                total += o.nbytes
                group.append(j)
                used[j] = True
        groups.append(group)
    return groups
