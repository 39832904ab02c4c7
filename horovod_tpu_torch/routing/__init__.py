"""hvd-route: the pure-Python router tier over N serving replicas (port
of horovod_tpu/routing/, which imports no JAX).

Least-loaded + prefix-affinity dispatch, drain-aware failover, and
fleet autoscaling, all over the HTTP contract the port's serving tier
exports (``/healthz``, ``/generate``, and the fleet hooks
``/drain``/``/resume``/``/prefixes``, ``serving/server.py``).  No tensor
work anywhere in this package: like the scheduler, the router runs on
any front-end box.
"""

from .affinity import (chain_hashes, prompt_header_hashes,
                       published_page_hashes)
from .autoscale import AutoscaleConfig, FleetAutoscaler
from .replica import HttpReplicaClient, ReplicaUnreachable
from .router import Router, RouterConfig
from .server import RouterServer

__all__ = [
    "AutoscaleConfig",
    "FleetAutoscaler",
    "HttpReplicaClient",
    "ReplicaUnreachable",
    "Router",
    "RouterConfig",
    "RouterServer",
    "chain_hashes",
    "prompt_header_hashes",
    "published_page_hashes",
]
