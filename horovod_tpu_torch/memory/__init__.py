"""hvd-mem: device-memory observability (port of
horovod_tpu/memory/__init__.py:1-59).

Three coupled halves:

* :mod:`.ledger` -- the live byte ledger fed by every framework-owned
  allocation site (fusion buffers, EF residuals, KV pages, prefetch
  slots, pipeline carries, checkpoint snapshots), surfaced as
  ``memory.*`` telemetry gauges that ride the ``cluster_metrics`` pull,
  plus :class:`~.ledger.MemoryWatch`, the live leak detector.
* :mod:`.planner` -- the static memory planner: the reference's analytic
  byte models, and ``python -m horovod_tpu_torch.memory --plan``, the
  no-hardware dryrun answering "will this config fit" and its what-ifs.
* :mod:`.oom` -- out-of-memory capture at the dispatch sites: a forensic
  flight dump naming the failing executable and the top ledger
  categories, a simulated-capacity knob (``HVD_TPU_MEM_CAPACITY``) and
  the init/build-time pre-flight warnings.
"""

from __future__ import annotations

from . import ledger  # noqa: F401  (import installs collector + tail)
from . import oom  # noqa: F401
from . import planner  # noqa: F401
from .ledger import (  # noqa: F401
    MemoryLedger,
    MemoryWatch,
    device_memory_stats,
    live_array_report,
    tree_nbytes,
)

# The process-global ledger instance lives at memory.ledger.ledger (the
# flight/recorder convention); re-exporting it here as ``ledger`` would
# shadow the submodule for every ``from ..memory import ledger`` site.
from .oom import (  # noqa: F401
    ResourceExhaustedError,
    advertised_capacity,
    guard,
    is_resource_exhausted,
    oom_event,
    preflight_warn,
)
from .planner import (  # noqa: F401
    MemoryPlan,
    build_plan,
    fusion_group_bytes,
    harvested,
    kv_cache_bytes,
    model_names,
    pipeline_activation_bytes,
    record_compiled,
)
