"""The HTTP front door: ``/generate`` on the telemetry exporter's route
registry (port of horovod_tpu/serving/server.py).

``/healthz`` reports ``NOT_READY`` (HTTP 503) until the engine's
``warm_start`` completes, then ``ok`` with queue depth and batch
occupancy: what a load balancer needs to keep traffic off a server that
is still starting and to spread it by load afterwards.

``POST /generate`` takes JSON with ``tokens`` (a list of ids) or
``text`` (the byte tokenizer: UTF-8 bytes as ids, for a vocab of at
least 256), and optional ``max_tokens``, ``temperature``, ``seed``,
``timeout``.  The handler blocks until the scheduler evicts the
sequence and answers with the tokens, TTFT and the request's rate; 503
while draining, 504 on timeout, 499 when its client disconnected (the
slot is released through the abort path), 500 when the serve loop's
recovery failed it.  ``GET /prefixes`` gives the live prefix index as
token chains.  ``POST /drain`` drains the engine for a scale-down or a
relaunch (the in-flight handlers answer 503) and answers with the export
(queued requests, in-flight continuations, the prefix index) while
``/healthz`` turns NOT_READY; ``POST /resume`` installs such an export
and reopens admission (``elastic.serving_install_payload``).  Handlers run on the exporter's per-request threads and
only submit and wait; the engine loop runs on the server's own thread.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import Optional, Tuple

import torch

from .. import telemetry as _telemetry
from ..analysis import threads as _athreads
from ..core import state as _state
from ..telemetry import exporter as _exporter
from .engine import InferenceEngine
from .scheduler import FinishReason

HEALTH_KEY = "serving"
GENERATE_PATH = "/generate"
# Scale-down and boot/scale-up of one replica (elastic.py's payload).
DRAIN_PATH = "/drain"
RESUME_PATH = "/resume"
# The live prefix index, for a router or autoscaler warming a newcomer.
PREFIXES_PATH = "/prefixes"

# How often a blocked /generate handler looks at its client connection.
# The reference waits 0.2 s between looks; on the card a short request
# finishes within that, so its client would never be looked at (the
# chaos matrix's serving.disconnect scenarios then never fire).  A look
# is one zero-timeout select.
CLIENT_POLL_SECONDS = 0.01

# finish_reason -> (HTTP status, message) for requests that did not
# complete normally.  500: the serve loop's error recovery failed it.
# 503: an elastic drain evicted it mid-flight — the engine exported a
# continuation for the relaunched fleet, but THIS handler's request
# object never completes, so the client retries (consistent with the
# 503 a drained submit gets).
_FAILURE_STATUS = {
    FinishReason.ERROR: (
        500, "generation failed (engine error); partial tokens "
             "included"),
    FinishReason.DRAINED: (
        503, "generation interrupted by a serving drain; retry "
             "against the relaunched server"),
    # 499 (nginx convention): the client closed before the response;
    # nobody reads this body, but a late/raced completion must not
    # render as a 200.
    FinishReason.CLIENT_DISCONNECT: (
        499, "client disconnected mid-generation; slot released"),
}

_M_CLIENT_DISCONNECTS = _telemetry.counter(
    "serving.client_disconnects", "clients that vanished mid-generate "
    "(slot released via the abort path)")
_M_CP_LOSSES = _telemetry.counter(
    "serving.control_plane_losses", "serve loops degraded to 503+drain "
    "after a persistent control-plane loss")


def encode_text(text: str, vocab_size: int) -> list:
    """Byte tokenizer: UTF-8 bytes as token ids (needs vocab >= 256)."""
    if vocab_size < 256:
        raise ValueError(
            f"the byte tokenizer needs vocab_size >= 256, got "
            f"{vocab_size}; send token ids instead")
    return list(text.encode("utf-8"))


def decode_tokens(tokens: list, vocab_size: int) -> Optional[str]:
    """Inverse byte tokenizer (None when ids fall outside byte range)."""
    if vocab_size < 256 or any(not 0 <= t < 256 for t in tokens):
        return None
    return bytes(tokens).decode("utf-8", errors="replace")


class LMServer:
    """Serve-loop thread + route registration.

    ``start()`` warm-starts the engine (readiness flips ``/healthz``),
    starts the continuous-batching loop on its own thread, registers
    ``/generate`` and ``/prefixes``, and starts an exporter on ``port``
    (0 for a free one) serving the route registry.  ``routes`` is that
    registry: the process-global one by default, or a private
    :class:`~..telemetry.exporter.RouteRegistry` so that several servers
    in one process keep their ``/generate`` and ``/healthz`` apart.
    With the process-global registry, the exporter ``hvd.init()`` started
    on ``HVD_TPU_METRICS_PORT`` serves ``/generate`` when there is one,
    and ``port`` is its port; otherwise, without a ``port``, no exporter
    is started.

    The serve-loop thread sets the engine's CUDA device itself and is
    the only thread that runs tensor work; HTTP handler threads only
    submit and wait."""

    def __init__(self, engine: InferenceEngine,
                 port: Optional[int] = None,
                 host: str = "127.0.0.1",
                 routes: Optional[_exporter.RouteRegistry] = None
                 ) -> None:
        self.engine = engine
        self._port = port
        self._host = host
        self._routes = routes
        if routes is not None and port is None:
            raise ValueError("a private route registry needs its own "
                             "exporter: pass port (0 for ephemeral)")
        self._own_exporter: Optional[_exporter.MetricsExporter] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    @property
    def port(self) -> Optional[int]:
        if self._own_exporter is not None:
            return self._own_exporter.port
        exp = self._shared_exporter()
        return exp.port if exp is not None else None

    def _shared_exporter(self):
        """The exporter ``hvd.init()`` started, serving the global route
        registry (None with private routes or none started)."""
        if self._routes is not None:
            return None
        return _state._state.metrics_exporter

    def start(self) -> "LMServer":
        routes = (self._routes if self._routes is not None
                  else _exporter.routes())
        # Readiness first: a probing load balancer sees NOT_READY from
        # the instant the process answers, not a 404 window.
        routes.register_health(HEALTH_KEY, self.engine.health)
        self.engine.warm_start()
        # pass_client: the blocking /generate handler watches its
        # client connection and aborts the slot when it vanishes
        # (hvd-chaos hardening; exporter.ClientProbe).
        routes.register(GENERATE_PATH, self._handle_generate,
                        methods=("POST",), pass_client=True)
        routes.register(DRAIN_PATH, self._handle_drain,
                        methods=("POST",))
        routes.register(RESUME_PATH, self._handle_resume,
                        methods=("POST",))
        routes.register(PREFIXES_PATH, self._handle_prefixes,
                        methods=("GET",))
        if self._port is not None and self._shared_exporter() is None:
            self._own_exporter = _exporter.start_exporter(
                _telemetry.registry(), self._port, host=self._host,
                routes=self._routes)
        self._thread = threading.Thread(
            target=self._loop, name="hvd-serve-loop", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        # Worker ranks in follow() return False (reference :184).
        self.engine.stop_followers()
        routes = (self._routes if self._routes is not None
                  else _exporter.routes())
        routes.unregister(GENERATE_PATH)
        routes.unregister(DRAIN_PATH)
        routes.unregister(RESUME_PATH)
        routes.unregister(PREFIXES_PATH)
        routes.unregister_health(HEALTH_KEY)
        if self._own_exporter is not None:
            self._own_exporter.close()
            self._own_exporter = None

    def __enter__(self) -> "LMServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- the serve loop ----------------------------------------------------
    def _control_plane_lost(self) -> bool:
        """Persistent control-plane loss: the port's runtime stopped
        after a failed control exchange (a peer died) in a job of more
        than one rank.  Serving cannot make progress past it: degrade
        instead of wedging."""
        st = _state._state
        return bool(st.initialized and st.size > 1
                    and st.runtime is not None
                    and st.runtime.peer_shutdown)

    def _loop(self) -> None:  # thread: serve-loop
        _athreads.set_role("serve-loop")
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)
        degraded = False
        while not self._stop.is_set():
            if not degraded and self._control_plane_lost():
                # Graceful degradation, once: stop admission (new
                # /generate → 503), evict in-flight sequences as
                # DRAINED (their blocked handlers answer 503 instead
                # of hanging to the client timeout), and flip /healthz
                # NOT_READY so the load balancer drains traffic.
                degraded = True
                _M_CP_LOSSES.inc()
                _telemetry.error_event(
                    "hvd-serve: control plane lost; draining and "
                    "reporting NOT_READY (503) until relaunch")
                try:
                    self.engine.drain()
                except Exception as e:  # noqa: BLE001 — degradation
                    # must not kill the loop it is protecting
                    _telemetry.exception_event(
                        "serve-degrade", f"{type(e).__name__}: {e}")
                self.engine.mark_unready()
            if self.engine.scheduler.idle():
                # Park until a submission wakes us; short timeout so a
                # racing submit-after-idle-check is picked up anyway.
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                self.engine.step()
            except Exception as e:  # noqa: BLE001 — the loop must
                # survive one bad batch: the exception event keeps the
                # forensics, every caught-up request fails FAST (not at
                # its HTTP timeout) — abort_all fails exactly the
                # requests its drain removed, so a submission racing
                # the recovery cannot be silently lost — and the KV
                # slots/pages are freed so the next request serves
                # normally.
                _telemetry.exception_event("serve-loop",
                                           f"{type(e).__name__}: {e}")
                try:
                    self.engine.abort_all()
                except Exception as e2:  # noqa: BLE001 — a recovery
                    # that raises must not kill this thread: a dead
                    # serve loop with a still-ready /healthz blackholes
                    # every future request until its client timeout.
                    # But a FAILED recovery may have left admission
                    # closed and requests unanswered — flip /healthz
                    # to NOT_READY so the load balancer drains traffic
                    # instead of feeding the blackhole.
                    _telemetry.exception_event(
                        "serve-loop-recovery",
                        f"{type(e2).__name__}: {e2}")
                    self.engine.mark_unready()

    # -- /generate ---------------------------------------------------------
    def _handle_generate(self, query: str, body: bytes,
                         client=None) -> Tuple[int, bytes, str]:
        try:
            payload = json.loads(body.decode() or "{}")
        except ValueError:
            return (400, b'{"error": "invalid JSON"}\n',
                    "application/json")
        vocab = self.engine.cfg.vocab_size
        tokens = payload.get("tokens")
        if tokens is None and "text" in payload:
            try:
                tokens = encode_text(payload["text"], vocab)
            except ValueError as e:
                return (400, json.dumps({"error": str(e)}).encode(),
                        "application/json")
        if not tokens:
            return (400, b'{"error": "need tokens or text"}\n',
                    "application/json")
        if any(not 0 <= int(t) < vocab for t in tokens):
            return (400, json.dumps(
                {"error": f"token ids must be in [0, {vocab})"}).encode(),
                "application/json")
        try:
            req = self.engine.submit(
                [int(t) for t in tokens],
                max_new_tokens=int(payload.get("max_tokens", 32)),
                temperature=float(payload.get("temperature", 0.0)),
                seed=int(payload.get("seed", 0)))
        except ValueError as e:
            return (400, json.dumps({"error": str(e)}).encode(),
                    "application/json")
        except RuntimeError as e:
            # The scheduler is draining (elastic resize or the error
            # recovery's brief window) — a retryable server state, not
            # a malformed request.
            return (503, json.dumps({"error": str(e)}).encode(),
                    "application/json")
        self._wake.set()
        timeout = float(payload.get("timeout", 120.0))
        t0 = time.perf_counter()
        # Block for the completion in short slices, watching the client
        # connection between slices: a client that disconnected
        # mid-generation releases its slot through the abort path
        # instead of burning decode iterations on tokens nobody will
        # read (counted below).
        deadline = t0 + timeout
        while True:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                return (504, json.dumps(
                    {"error": "generation timed out", "rid": req.rid}
                ).encode(), "application/json")
            try:
                out = req.result(timeout=min(CLIENT_POLL_SECONDS,
                                             remaining))
                break
            except TimeoutError:
                if client is not None and client.disconnected():
                    _M_CLIENT_DISCONNECTS.inc()
                    disposition = self.engine.abort_request(req)
                    print(f"[hvd-serve] client of request {req.rid} "
                          f"disconnected mid-generation; slot "
                          f"released ({disposition})", file=sys.stderr)
                    self._wake.set()  # let the loop evict promptly
                    # The body goes nowhere (the client is gone); the
                    # status keeps the access path honest.
                    return (499, json.dumps(
                        {"error": "client disconnected",
                         "rid": req.rid}).encode(), "application/json")
        fail = _FAILURE_STATUS.get(req.finish_reason)
        if fail is not None:
            # Failures are explicit statuses, never a 200 that only
            # finish_reason distinguishes from success (partial tokens
            # included either way).
            code, msg = fail
            return (code, (json.dumps({
                "error": msg,
                "rid": req.rid, "finish_reason": req.finish_reason,
                "tokens": out}) + "\n").encode(), "application/json")
        total = time.perf_counter() - t0
        resp = {
            "rid": req.rid,
            "tokens": out,
            "finish_reason": req.finish_reason,
            "ttft_ms": round((req.t_first_token - req.t_submit) * 1e3, 3)
            if req.t_first_token else None,
            "total_ms": round(total * 1e3, 3),
            "tokens_per_sec": round(len(out) / total, 1) if total else None,
        }
        text = decode_tokens(out, vocab)
        if text is not None:
            resp["text"] = text
        return (200, (json.dumps(resp) + "\n").encode(),
                "application/json")

    def _handle_drain(self, query: str,
                      body: bytes) -> Tuple[int, bytes, str]:
        """Scale-down: drain the engine (in-flight handlers answer 503
        with their partials), export the queued work, the continuations
        and the prefix index for the caller to hand on, and turn
        ``/healthz`` NOT_READY so the fleet stops routing here
        (reference :368-382)."""
        from .. import elastic as _elastic

        # NOT_READY first: a drained request's handler answers 503 the
        # moment the drain finishes it, and its client may then read
        # /healthz (the reference flips readiness after the export).
        self.engine.mark_unready()
        exported = self.engine.drain()
        payload = _elastic.serving_export_payload(self.engine, exported)
        self._wake.set()  # the loop sees the emptied scheduler
        return (200, (json.dumps(payload) + "\n").encode(),
                "application/json")

    def _handle_resume(self, query: str,
                       body: bytes) -> Tuple[int, bytes, str]:
        """Boot or scale-up: install a drained export (the requests
        resubmit, the prefix chains ghost-seed the cache) and reopen
        admission; a replica drained NOT_READY warm-starts back to ready
        (reference :384-412).  A payload of prefixes alone (or none)
        seeds them without the wholesale drain, so a live replica's work
        survives the gift, and reopens a drained replica's admission."""
        from .. import elastic as _elastic

        try:
            payload = json.loads(body.decode() or "{}")
        except ValueError:
            return (400, b'{"error": "invalid JSON"}\n',
                    "application/json")
        if not self.engine.ready:
            self.engine.warm_start()
        if isinstance(payload, dict) and not payload.get("requests"):
            if payload.get("prefixes"):
                self.engine.seed_prefixes(payload["prefixes"])
            # A drained replica reopens admission here too (an empty
            # import does only that; a live one is untouched).  The
            # reference's prefix-only branch leaves a drained replica
            # ready but refusing every request with 503 (ROADMAP.md
            # §C.3), which a router would then mark draining again.
            self.engine.import_requests([])
            installed = []
        else:
            installed = _elastic.serving_install_payload(self.engine,
                                                         payload)
        self._wake.set()
        return (200, (json.dumps(
            {"installed": len(installed),
             "ready": self.engine.ready}) + "\n").encode(),
            "application/json")

    def _handle_prefixes(self, query: str,
                         body: bytes) -> Tuple[int, bytes, str]:
        """The live prefix index as maximal token chains — the
        autoscaler's boot-seed source (no drain required)."""
        return (200, (json.dumps(
            {"prefixes": self.engine.export_prefix_index()})
            + "\n").encode(), "application/json")
