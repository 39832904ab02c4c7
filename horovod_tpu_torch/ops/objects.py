"""Collectives of picklable objects: ``allgather_object`` and
``broadcast_object`` (port of horovod_tpu/ops/objects.py).

The reference's recipe: pickle the object into a uint8 vector;
``allgather_object`` rides the variable-dim-0 allgather (one gather of
the byte counts gives each rank's split), ``broadcast_object`` first
broadcasts the byte count, then the payload.

Unpickling runs code: only trust peers you would trust with code
execution, as with Horovod's own object collectives.
"""

from __future__ import annotations

import pickle
from typing import Any, List, Optional

import numpy as np
import torch

from ..core import state as _state
from . import collective as _C

__all__ = ["allgather_object", "broadcast_object"]


def _to_bytes(obj: Any) -> torch.Tensor:
    return torch.from_numpy(
        np.frombuffer(pickle.dumps(obj), dtype=np.uint8).copy())


def allgather_object(obj: Any, name: Optional[str] = None) -> List[Any]:
    """One picklable object per rank; returns the rank-ordered list on
    every rank."""
    name = name or "allgather.object"
    data = _to_bytes(obj)
    sizes = _C.allgather(torch.tensor([data.numel()], dtype=torch.int64),
                         name=f"{name}.sizes")
    payload = _C.allgather(data, name=f"{name}.data").numpy()
    out: List[Any] = []
    off = 0
    for n in sizes.tolist():
        out.append(pickle.loads(payload[off:off + n].tobytes()))
        off += n
    return out


def broadcast_object(obj: Any = None, root_rank: int = 0,
                     name: Optional[str] = None) -> Any:
    """``root_rank``'s picklable object on every rank; other ranks may pass
    ``obj=None``."""
    name = name or "broadcast.object"
    is_root = _state.rank() == root_rank
    data = _to_bytes(obj) if is_root else None
    size = torch.tensor([data.numel() if is_root else 0], dtype=torch.int64)
    size = int(_C.broadcast(size, root_rank, name=f"{name}.size")[0])
    if not is_root:
        data = torch.zeros(size, dtype=torch.uint8)
    payload = _C.broadcast(data, root_rank, name=f"{name}.data")
    return pickle.loads(payload.numpy().tobytes())
