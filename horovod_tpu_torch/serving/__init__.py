"""Continuous-batching inference (port of horovod_tpu/serving).

* :mod:`.scheduler`: the request queue and the iteration-level
  continuous-batching scheduler (pure Python);
* :mod:`.kv_cache`: the paged KV cache with its shared-prefix index;
* :mod:`.engine`: prefill, decode and speculative programs over the
  cache, on the serving kernels (:mod:`..ops.serving`);
* :mod:`.server`: the HTTP front door (``/generate``, ``/healthz``);
* :mod:`.harness`: the speculative-decoding validation helpers.
"""

from __future__ import annotations

from .scheduler import (  # noqa: F401
    ContinuousBatchingScheduler,
    FinishReason,
    Request,
)
from .kv_cache import PagedKVCache  # noqa: F401
from .engine import InferenceEngine  # noqa: F401
from .server import LMServer  # noqa: F401
