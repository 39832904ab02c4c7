"""Replica clients: how the router speaks to one serving replica (a copy
of horovod_tpu/routing/replica.py, which imports no JAX).

The wire contract is exactly what hvd-serve already exports — no new
replica-side protocol: ``GET /healthz`` (readiness + queue depth + KV
headroom + the prefix index, ``serving/engine.py health()``), ``POST
/generate`` (the front door), and the fleet hooks ``POST /drain`` /
``POST /resume`` / ``GET /prefixes`` (``serving/server.py``).  A client
returns ``(status, payload)`` for every call and raises
:class:`ReplicaUnreachable` ONLY for transport-level failures
(connection refused/reset, timeout) — an HTTP error status is a
*reachable* replica saying no, and the router treats the two very
differently (failover-and-retry vs mark-dead-and-backoff).

Anything that implements this four-method surface can sit behind the
router: :class:`HttpReplicaClient` for real fleets, the simulated
replicas of ``bench.py --mode routing``, and the in-memory fakes of
tests/test_routing.py.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Optional, Tuple


class ReplicaUnreachable(Exception):
    """Transport-level failure talking to a replica (dead process,
    refused/reset connection, timeout) — the router's mark-dead
    signal, as opposed to an HTTP error status from a live one."""


class HttpReplicaClient:
    """urllib-based client for one replica's exporter endpoint.

    Stateless (one request per call, no pooled sockets), so a replica
    death can never wedge the client beyond the current call's
    timeout."""

    def __init__(self, host: str, port: int,
                 timeout: float = 120.0) -> None:
        self.host = host
        self.port = int(port)
        self.timeout = float(timeout)
        self._base = f"http://{host}:{int(port)}"

    def _call(self, method: str, path: str,
              payload: Optional[dict] = None,
              timeout: Optional[float] = None) -> Tuple[int, dict]:
        body = None if payload is None else json.dumps(payload).encode()
        req = urllib.request.Request(self._base + path, data=body,
                                     method=method)
        if body is not None:
            req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(
                    req, timeout=self.timeout if timeout is None
                    else float(timeout)) as resp:
                raw = resp.read()
                status = resp.status
        except urllib.error.HTTPError as e:
            # A status the server chose (503 draining, 400, 500): the
            # replica is alive — hand the body to the router's policy.
            raw = e.read()
            status = e.code
        except (urllib.error.URLError, ConnectionError, OSError,
                TimeoutError) as e:
            raise ReplicaUnreachable(
                f"{self._base}{path}: {type(e).__name__}: {e}") from e
        try:
            parsed = json.loads(raw.decode() or "{}")
        except ValueError:
            parsed = {"raw": raw.decode(errors="replace")}
        if not isinstance(parsed, dict):
            parsed = {"payload": parsed}
        return status, parsed

    # -- the replica surface ----------------------------------------------
    def health(self) -> Tuple[int, dict]:
        """``GET /healthz`` — (status, payload); 200 means ready, 503
        carries the same payload with ``status: NOT_READY``."""
        return self._call("GET", "/healthz", timeout=5.0)

    def generate(self, payload: dict,
                 timeout: Optional[float] = None) -> Tuple[int, dict]:
        """``POST /generate`` — blocks for the completion (or the
        replica's own failure status)."""
        return self._call("POST", "/generate", payload, timeout=timeout)

    def drain(self) -> Tuple[int, dict]:
        """``POST /drain`` — stop admission, evict in-flight work as
        continuations; the payload is the elastic export (requests +
        prefix index) the caller resubmits/seeds elsewhere."""
        return self._call("POST", "/drain", {})

    def resume(self, payload: dict) -> Tuple[int, dict]:
        """``POST /resume`` — install a drained export (continuations
        resubmitted, prefix chains ghost-seeded) into this replica."""
        return self._call("POST", "/resume", payload)

    def prefixes(self) -> Tuple[int, dict]:
        """``GET /prefixes`` — the live prefix index as token chains
        (the autoscale boot-seed source; no drain required)."""
        return self._call("GET", "/prefixes", timeout=10.0)
