"""The hvd-chaos scenario matrix: the no-hang contract (port of
horovod_tpu/chaos/matrix.py, for the sites the port hosts).

``python -m horovod_tpu_torch.chaos --matrix`` runs each scenario below
under a hard wall-clock cap a pass and holds it to its expectation:

* **recover**: the faulted run exits 0 and its ``CHAOS_RESULT`` digests
  equal a fault-free run's (full recovery, bitwise);
* **diagnostic**: the faulted run ends within the cap with a nonzero exit
  and its output names the injected fault (``needle``);
* **complete**: one pass with no fault spec that must finish (the
  request storm).

A run still alive at the cap is killed and reported as HANG.  Every
child zeroes the port's kernel launch counters just before its scenario
and prints them at its end (``CHAOS_LAUNCHES``); a scenario's report
sums them over its passes and ranks (``launches``) and names each
process that printed none (``unreported``).  Every
scenario's fault sequence is deterministic (``chaos/spec.py``), so a
failure reproduces from its spec line.

Scenario kinds:

* ``cp``: an np=2 or np=3 fleet of the port's real runtime: each rank a
  process that calls ``init()`` and drives negotiated allreduces through
  the TCP control channel (its session resume, replay rings, grace
  windows, frame deadlines and, with ``HVD_TPU_TREE``, the tree overlay),
  the coordinator and the response cache.  The digest covers every
  completed negotiation ``(step, tensor, response type)`` each rank
  executed, every RETUNE marker it applied ``(seq, token)``, and the
  results' bytes; rank 0 also pulls the fleet's metrics once mid-run and
  holds a seeded memory gauge to exact values.
  A fleet needs one card a rank: with fewer cards than ranks it runs on
  the CPU (gloo), and the output says so.
* ``local``: one process with the port's stack on ``--device`` (the
  checkpoint writer, the prefetch stager, the serving front door, the
  router);
  digests cover real bytes (the checkpoint file, trained values,
  generated tokens).

Every scenario of the reference is in the matrix (:data:`WAITING` is
empty).  The router's two (``router_replica_death``, ``router_restart``)
run toy transformer replicas on ``--device`` behind the real
:class:`~..routing.Router` over HTTP; ``router_restart`` kills its router
child once a replica's ``/healthz`` shows the long request admitted, not
after a fixed sleep, so that the kill lands mid-generation on a fast
device too.

``retune_midfault`` (hvd-tune): rank 0's :class:`~..tuning.Tuner` enqueues a
RETUNE marker at each of ``HVD_TPU_CHAOS_RETUNE_STEPS``.  Besides the
scenario's worker-side reset, the faulted pass resets the worker's
connection on the payload that carries the last marker: rank 0 arms that
reset when it enqueues the marker, holding ``cycle_lock``, so the next frame
it sends is that payload, which the worker then receives only through the
session resume's replay.  A count of frames from the fault-free pass could
not place it there: idle cycles send frames at the clock's pace.  The
records must equal the fault-free pass's: no marker lost, none applied
twice.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# ---------------------------------------------------------------------------
# The matrix
# ---------------------------------------------------------------------------


@dataclass
class Scenario:
    name: str
    kind: str                  # "cp" | "local"
    expect: str                # "recover" | "diagnostic" | "complete"
    spec: str = ""             # HVD_TPU_FAULTS for the faulted pass
    needle: str = ""           # substring the faulted output must show
    np: int = 2                # cp: process count
    cap: float = 90.0          # wall-clock cap a pass (seconds)
    env: Dict[str, str] = field(default_factory=dict)
    doc: str = ""


SCENARIOS: List[Scenario] = [
    # -- transport (ops/transport.py): the reconnect protocol ------------
    Scenario(
        "transport_reset_worker", "cp", "recover",
        spec="transport.reset:count=1:after=25:rank=1@11",
        needle="session resumed",
        doc="worker's control-plane connection reset mid-run; "
            "reconnect + ring replay; results identical"),
    Scenario(
        "transport_reset_np3", "cp", "recover", np=3,
        spec="transport.reset:count=1:after=25:rank=2@12",
        needle="session resumed", cap=120.0,
        doc="np=3: one of two workers resets; the other is "
            "undisturbed; results identical on all three"),
    Scenario(
        "transport_reset_controller", "cp", "recover",
        spec="transport.reset:count=1:after=25:rank=0@13",
        needle="session resumed",
        doc="controller-side reset of a worker's socket (send path); "
            "grace + reconnect; results identical"),
    Scenario(
        "transport_trunc", "cp", "recover",
        spec="transport.trunc:count=1:after=20:rank=1@14",
        needle="session resumed",
        doc="frame truncated mid-wire then connection reset; the "
            "replay ring re-sends the full frame"),
    Scenario(
        "transport_dup_delay", "cp", "recover",
        spec="transport.dup:count=3:after=10:rank=1;"
             "transport.delay:count=5:after=12:delay=0.05:rank=1@15",
        doc="duplicated + delayed frames; the stream survives (a "
            "duplicated batch carries a sequence number already taken)"),
    Scenario(
        "transport_drop", "cp", "diagnostic",
        spec="transport.drop:count=1:after=20:rank=1@16",
        needle="was abandoned",
        doc="a silently dropped frame (no reset, so no reconnect): the "
            "worker's timed-out synchronize withdraws at once, rank 0 "
            "takes the withdrawal in place of the lost batch, and the "
            "op fails by name"),
    Scenario(
        "transport_stall", "cp", "recover",
        spec="transport.stall:count=1:after=20:delay=3:rank=1@17",
        needle="frame deadline exceeded",
        env={"HVD_TPU_FRAME_TIMEOUT": "1"},
        doc="slow peer stalls mid-frame past HVD_TPU_FRAME_TIMEOUT: "
            "the deadline names peer+frame, then reconnect recovers"),
    Scenario(
        "grace_expiry", "cp", "diagnostic",
        needle="no reconnect within",
        env={"HVD_TPU_CHAOS_KILL_STEP": "12",
             "HVD_TPU_RECONNECT_GRACE": "1.5"},
        doc="worker dies hard (no reconnect ever comes): the grace "
            "window expires into a diagnostic naming the fault"),
    # -- tree overlay (ops/tree.py): interior-node death + re-parent -----
    Scenario(
        "tree_interior_down", "cp", "recover", np=3, cap=150.0,
        spec="tree.relay_reset:count=1:after=40:rank=1;"
             "transport.reset:count=1:after=30:rank=1@31",
        needle="re-parent",
        env={"HVD_TPU_TREE": "on", "HVD_TPU_TREE_FANOUT": "1",
             "HVD_TPU_RECONNECT_GRACE": "15",
             "HVD_TPU_RECONNECT_DEADLINE": "15"},
        doc="np=3 chain 0<-1<-2: both of the interior's links die "
            "(uplink reset + child-link relay reset); rank 1 resumes "
            "its uplink, rank 2 re-parents to the root via the "
            "session-resume listener; results (and the mid-run fleet "
            "metrics pull) identical to the fault-free tree run"),
    Scenario(
        "tree_leaf_reset", "cp", "recover", np=3, cap=150.0,
        spec="transport.reset:count=1:after=25:rank=2@32",
        needle="session resumed",
        env={"HVD_TPU_TREE": "on", "HVD_TPU_TREE_FANOUT": "1",
             "HVD_TPU_RECONNECT_GRACE": "15",
             "HVD_TPU_RECONNECT_DEADLINE": "15"},
        doc="np=3 chain: the leaf's uplink to its interior parent is "
            "reset; it re-parents to the root and the stream replay "
            "keeps every cache replica aligned"),
    # -- hvd-tune actuation (tuning/actuation.py) ------------------------
    Scenario(
        "retune_midfault", "cp", "recover",
        spec="transport.reset:count=1:after=26:rank=1@33",
        needle="session resumed",
        env={"HVD_TPU_CHAOS_RETUNE_STEPS": "10,25"},
        doc="RETUNE markers from rank 0's Tuner ride the response stream "
            "at steps 10 and 25; the worker's connection resets, and, "
            "placed by rank 0, resets again on the payload that carries "
            "the second marker, before the worker's apply: the session "
            "resume must deliver each marker exactly once (records "
            "identical to the fault-free pass: never lost, never applied "
            "twice)"),
    # -- the background loop and rank 0's negotiation (ops/collective.py)
    Scenario(
        "coord_tick_delay", "cp", "recover", cap=120.0,
        spec="coord.tick_delay:p=0.4:count=20:delay=0.03@18",
        doc="randomly starved background cycles; slower, never "
            "different"),
    Scenario(
        "coord_reorder", "cp", "recover",
        spec="coord.reorder:p=0.5:count=50@19",
        doc="freshly negotiated responses permuted within their cycle; "
            "completion set and results identical"),
    # -- checkpoint writer (utils/checkpoint.py) -------------------------
    Scenario(
        "ckpt_flaky", "local", "recover", cap=240.0,
        spec="ckpt.oserror:count=2@20",
        needle="retrying",
        doc="two transient ENOSPC during the tmp write; the retry "
            "loop lands the identical bytes"),
    Scenario(
        "ckpt_exhaustion", "local", "diagnostic", cap=240.0,
        spec="ckpt.oserror:count=9@21",
        needle="ckpt.oserror",
        env={"HVD_TPU_CKPT_RETRIES": "3"},
        doc="persistent write failure exhausts the retries: "
            "CheckpointError at wait() names the injected fault"),
    # -- prefetch stager (parallel/input.py) -----------------------------
    Scenario(
        "input_stall", "local", "recover", cap=240.0,
        spec="input.stall:count=3:after=2:delay=0.2@22",
        doc="loader stalls on the stager thread; training result "
            "bitwise (prefetch hides latency, never reorders)"),
    # -- serving front door (serving/server.py) --------------------------
    Scenario(
        "serving_disconnect", "local", "recover", cap=300.0,
        spec="serving.disconnect:count=1@23",
        needle="disconnected mid-generation",
        doc="client vanishes mid-generate: slot released through the "
            "abort path; the NEXT request's completion is identical "
            "to the fault-free run's"),
    Scenario(
        "serving_storm", "local", "complete", cap=300.0,
        doc="a burst of concurrent /generate requests: every one "
            "completes or fails explicitly; the front door never "
            "hangs"),
    Scenario(
        "serving_spec_disconnect", "local", "recover", cap=300.0,
        spec="serving.disconnect:count=1@27",
        needle="disconnected mid-generation",
        doc="client vanishes mid-speculation (draft model and prefix "
            "cache live): the abort releases the target and draft KV "
            "slots and the prefix references; the follow-up request "
            "(a prefix hit) completes identically to the fault-free "
            "run"),
    # -- hvd-route fleet router (routing/router.py) ----------------------
    Scenario(
        "router_replica_death", "local", "recover", cap=300.0,
        spec="router.replica_kill:count=1@40",
        needle="failed over",
        doc="two real replicas behind the real Router over real HTTP; "
            "the one that served the first request is drained and then "
            "killed hard: dispatch fails over to the survivor and every "
            "completion is identical to the fault-free fleet's"),
    Scenario(
        "router_restart", "local", "recover", cap=300.0,
        spec="router.kill:count=1@41",
        needle="severed router connection",
        doc="the real RouterServer runs as a separate process and is "
            "SIGKILLed mid-generation; the replicas abort the severed "
            "sockets via the client probe (no slot leak), a fresh router "
            "over the same fleet serves the resubmitted request, and "
            "completions are identical to the never-killed run (the "
            "bitwise contract makes the retry the same answer)"),
]

# The reference's scenarios whose sites the port did not host yet, by the
# step (ROADMAP.md §A.5) that brought them: none since the router (§A.5
# item 6) brought the last two.
WAITING: Dict[str, str] = {}


def find(name: str) -> Scenario:
    for s in SCENARIOS:
        if s.name == name:
            return s
    raise SystemExit(f"unknown chaos scenario {name!r}; "
                     f"--list shows the matrix")


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _digest(records) -> str:
    """Order-insensitive digest of a run's completion records; the
    recover contract compares it between the faulted and fault-free
    passes."""
    blob = json.dumps(sorted(map(list, records))).encode()
    return hashlib.sha256(blob).hexdigest()[:24]


def _result(rank: int, records) -> None:
    print(f"CHAOS_RESULT rank={rank} n={len(records)} "
          f"digest={_digest(records)}", flush=True)


def reset_launches() -> None:
    """Zero the port's kernel launch counters (flash attention, the
    quantized codec, serving): a child does so just before its
    scenario."""
    from ..ops import flash_attention, quant, serving

    for mod in (flash_attention, quant, serving):
        mod.reset_launches()


def launch_counts() -> Dict[str, int]:
    """The launch counters, by kernel."""
    from ..ops import flash_attention, quant, serving

    return {**flash_attention.launches, **quant.launches,
            **serving.launches}


def report_launches(rank: int) -> None:
    """Print the launch counters as one ``CHAOS_LAUNCHES`` line, written
    whole so that no other thread's output lands inside it."""
    sys.stdout.write(f"CHAOS_LAUNCHES rank={rank} "
                     f"{json.dumps(launch_counts(), sort_keys=True)}\n")
    sys.stdout.flush()


def _diag(rank: int, message: str) -> None:
    print(f"CHAOS_DIAG rank={rank}: {message}", file=sys.stderr,
          flush=True)
    sys.stdout.flush()
    raise SystemExit(1)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# A cp fleet's ranks join the TCPStore their parent hosts as clients, as
# torchrun's workers join their agent's (torch.distributed.rendezvous):
# every rank, rank 0 included, connects to MASTER_PORT and none binds it.
AGENT_STORE_ENV = {"TORCHELASTIC_USE_AGENT_STORE": "True",
                   "TORCHELASTIC_RESTART_COUNT": "0"}


def rendezvous_store():
    """The TCPStore of one cp fleet pass, served by this process on a port
    the OS picks at bind (``store.port``).  The port stays bound from its
    choice to the fleet's end: a port picked, released and bound later
    by the fleet's rank 0 could be taken meanwhile by any other process
    of the machine, and the fleet's ranks would then hang on that
    process's listener (its rendezvous retries for 30 minutes)."""
    from torch.distributed import TCPStore

    return TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)


def _device(name: Optional[str]):
    import torch

    return torch.device(name or "cuda")


# ---------------------------------------------------------------------------
# cp nodes: a real-process fleet of the port's runtime
# ---------------------------------------------------------------------------

CP_STEP_DEADLINE = 8.0
# retune_midfault's marker: the reference's tokens (its cp fleet's
# threshold doubled, a 4 ms cycle).
RETUNE_TOKENS = ("fusion_threshold=2097152", "cycle_time=0.004")
# One tensor a dtype, so the four are four responses of a cycle (tensors
# of one dtype fuse into one): coord.reorder has something to permute.
CP_DTYPES = ("float32", "float64", "int32", "int64")


def _cp_steps() -> int:
    """Steps a cp pass (the tests run a short fleet; the matrix's
    default is 40)."""
    return int(os.environ.get("HVD_TPU_CHAOS_CP_STEPS", "40"))


# Every cp rank seeds a rank-keyed ledger entry, so rank 0's mid-run
# metrics pull can hold the memory gauge family to exact values: every
# rank's own, and the fleet min/max/mean/sum (reference matrix.py:
# 308-351).
MEM_PROBE_GAUGE = "memory.bytes.chaos.probe"


def _seed_mem_probe(rank: int) -> None:
    from ..memory import ledger as _mem

    _mem.ledger.set("chaos.probe", (rank + 1) << 20)


def _check_mem_gauges(snaps, np_: int) -> None:
    """Rank 0, over one completed pull: the probe gauge from every rank
    with its exact value, and exact fleet aggregates."""
    from .. import telemetry as _telemetry

    agg = _telemetry.aggregate(snaps).get(MEM_PROBE_GAUGE)
    if agg is None:
        _diag(0, f"metrics pull carried no {MEM_PROBE_GAUGE} gauge")
    expect = {r: (r + 1) << 20 for r in range(np_)}
    got = {int(r): int(v) for r, v in agg.get("per_rank", {}).items()}
    if got != expect:
        _diag(0, f"{MEM_PROBE_GAUGE} per-rank mismatch: got {got}, "
                 f"expected {expect}")
    exact = {"min": 1 << 20, "max": np_ << 20,
             "mean": ((np_ + 1) << 20) / 2.0,
             "sum": (np_ * (np_ + 1) // 2) << 20}
    for key, want in exact.items():
        if agg.get(key) != want:
            _diag(0, f"{MEM_PROBE_GAUGE} {key} inexact: {agg.get(key)} "
                     f"!= {want}")
    print(f"CHAOS_MEMGAUGES ranks={np_} ok", flush=True)


def run_cp_node(device: Optional[str] = None) -> None:
    """One rank of the cp fleet (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
    and ``MASTER_PORT`` set by the CLI): ``init()``, then each step one
    grouped allreduce of a tensor a dtype, then synchronized.  Every
    response the runtime executes is recorded with the step it completed
    in; so are the results' bytes.  Three quarters in, rank 0 pulls the
    fleet's metrics (:func:`_check_mem_gauges`).  A rank whose step is
    ``HVD_TPU_CHAOS_KILL_STEP`` dies hard there (no exit handshake).  A
    synchronize gives up after the step deadline (the withdraw path).  At
    each of ``HVD_TPU_CHAOS_RETUNE_STEPS`` rank 0's Tuner enqueues a RETUNE
    marker; every rank records each marker it applies (see the module's
    docstring for the placed reset)."""
    import torch

    import horovod_tpu_torch as hvd
    from .. import chaos as _chaos
    from .. import telemetry as _telemetry
    from ..core import state as _state
    from ..ops.wire import ResponseType
    from ..tuning import Tuner

    os.environ.setdefault("HOROVOD_TPU_SYNC_TIMEOUT", str(CP_STEP_DEADLINE))
    retune_steps = sorted(
        int(v) for v in os.environ.get("HVD_TPU_CHAOS_RETUNE_STEPS", "")
        .replace(";", ",").split(",") if v.strip())
    faulted = bool(os.environ.get("HVD_TPU_FAULTS"))
    kill_step = int(os.environ.get("HVD_TPU_CHAOS_KILL_STEP", "-1"))
    hvd.init(device=device or "cuda")
    rank = hvd.rank()
    _seed_mem_probe(rank)
    dev = hvd.device()
    rt = _state._state.runtime
    records: List = []
    step_now = [0]
    data_types = (ResponseType.ALLREDUCE, ResponseType.ALLGATHER,
                  ResponseType.BROADCAST, ResponseType.REDUCESCATTER,
                  ResponseType.ALLTOALL)
    execute = rt._execute

    def recording(resp, tl=None):
        if resp.response_type in data_types:
            for n in resp.tensor_names:
                records.append((step_now[0], n, resp.response_type.name))
        elif resp.response_type == ResponseType.RETUNE:
            # Recorded as applied: a marker lost or applied twice across
            # the fault changes the digest.
            for n in resp.tensor_names:
                records.append((int(resp.tensor_sizes[0]), n, "RETUNE"))
        return execute(resp, tl)

    rt._execute = recording
    if retune_steps and rank == 0 and _state._state.tuner is None:
        # A bare controller (no policy, no sweep): the markers' source.
        _state._state.tuner = Tuner(_state._state)
    values = hashlib.sha256()
    steps = _cp_steps()
    try:
        for step in range(steps):
            step_now[0] = step
            if rank and step == kill_step:
                sys.stderr.flush()
                report_launches(rank)
                os._exit(1)  # a hard crash: no exit handshake, no resume
            if rank == 0 and step in retune_steps:
                with rt.cycle_lock:
                    _state._state.tuner._enqueue(list(RETUNE_TOKENS))
                    if faulted and step == retune_steps[-1]:
                        # The next frame rank 0 sends is the payload that
                        # carries this marker: reset the worker's
                        # connection before it.
                        os.environ["HVD_TPU_FAULTS"] = \
                            "transport.reset:count=1:after=0:rank=0@33"
                        _chaos.reload()
            # One batch: the four requests negotiate in the same cycle.
            handles = hvd.grouped_allreduce_async(
                [torch.full((8,), rank + 1 + step + k, device=dev,
                            dtype=getattr(torch, dt))
                 for k, dt in enumerate(CP_DTYPES)], op=hvd.Sum, name="t")
            t0 = time.monotonic()
            for h in handles:
                try:
                    out = hvd.synchronize(h)
                except hvd.HorovodError as e:
                    _diag(rank, f"step {step}: {e}")
                values.update(out.cpu().numpy().tobytes())
            if time.monotonic() - t0 > CP_STEP_DEADLINE:
                _diag(rank, f"step {step} took more than "
                            f"{CP_STEP_DEADLINE:.0f}s")
            if step == (3 * steps) // 4 and rank == 0 and hvd.size() > 1:
                snaps = rt.collect_metrics(_telemetry.metrics(), 10.0)
                if len(snaps) < hvd.size():
                    _diag(0, f"metrics pull covered only {sorted(snaps)} "
                             f"of {hvd.size()} ranks")
                _check_mem_gauges(snaps, hvd.size())
        records.append((-1, values.hexdigest(), "VALUES"))
        _result(rank, records)
    finally:
        rt._execute = execute
    hvd.shutdown()


# ---------------------------------------------------------------------------
# local scenarios (one process, the port's stack)
# ---------------------------------------------------------------------------

def scenario_ckpt(exhaust: bool, device: Optional[str] = None) -> None:
    """A background checkpoint write of a tree on ``device`` under an
    injected flaky filesystem (``ckpt.oserror``).  Recover: the published
    bytes equal the fault-free run's.  Exhaustion: ``CheckpointError`` at
    ``wait()`` naming the injected fault."""
    import tempfile

    import torch

    from ..utils import checkpoint as ckpt

    dev = _device(device)
    tree = {"w": torch.arange(64, dtype=torch.float32, device=dev),
            "b": torch.full((8,), 3.0, dtype=torch.float32, device=dev)}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "model.msgpack")
        handle = ckpt.write_tree_async(path, ckpt._host_snapshot(tree),
                                       step=7)
        try:
            handle.wait(timeout=60.0)
        except ckpt.CheckpointError as e:
            if exhaust:
                _diag(0, f"checkpoint failed after retries: {e}")
            raise
        if exhaust:
            print("CHAOS_NOTE: exhaustion scenario unexpectedly "
                  "succeeded", file=sys.stderr)
            raise SystemExit(1)
        with open(path, "rb") as f:
            blob = f.read()
        with open(path + ".step") as f:
            step = f.read()
        _result(0, [("ckpt", hashlib.sha256(blob).hexdigest(), step)])


def scenario_input_stall(device: Optional[str] = None) -> None:
    """A small loop over ``prefetch_to_device`` with injected loader
    stalls: the trained values must be bitwise the fault-free run's
    (prefetch adds latency, never reorders or drops batches)."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device=device or "cuda")
    try:
        nrep = hvd.size()
        rng = np.random.RandomState(7)
        batches = [rng.normal(size=(nrep * 4, 8)).astype("float32")
                   for _ in range(10)]
        w = torch.zeros(8, dtype=torch.float32, device=hvd.device())
        seen = 0
        for dev_batch in hvd.prefetch_to_device(iter(batches), depth=2):
            w = w + torch.tanh(dev_batch).mean(dim=0) * 0.1
            seen += 1
        host = w.cpu().numpy()
        _result(0, [("input", seen,
                     hashlib.sha256(host.tobytes()).hexdigest())])
    finally:
        hvd.shutdown()


def _small_engine(device: Optional[str], **kw):
    import torch

    from ..models.transformer import TransformerConfig, init_transformer
    from ..serving.engine import InferenceEngine

    cfg = TransformerConfig(vocab_size=256, d_model=32, n_heads=2,
                            n_layers=2, d_ff=64, max_seq_len=64)
    params = init_transformer(torch.Generator().manual_seed(5), cfg,
                              device=_device(device))
    return InferenceEngine(params, cfg, device=_device(device), max_slots=2,
                           page_size=8, capacity=64, **kw)


def _build_server(device: Optional[str] = None):
    from ..serving.server import LMServer

    return LMServer(_small_engine(device), port=0).start()


def _post_generate(port: int, payload: dict, timeout: float = 60.0):
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _disconnects() -> int:
    from .. import telemetry as _telemetry

    return _telemetry.metrics().get("serving.client_disconnects",
                                    {}).get("value", 0)


def scenario_serving_disconnect(device: Optional[str] = None) -> None:
    """``serving.disconnect`` fires in the ``/generate`` client probe: the
    first request's slot is released through the abort path
    (``serving.client_disconnects`` counts it) and the follow-up request,
    the digested result, completes identically to the fault-free run."""
    from .. import chaos as _chaos

    srv = _build_server(device)
    try:
        faulted = _chaos.active()
        first: dict = {}
        try:
            first = _post_generate(
                srv.port, {"tokens": [5, 6, 7], "max_tokens": 24,
                           "timeout": 45.0})
        except Exception as e:  # noqa: BLE001 — the faulted pass's 499
            # is an HTTPError; the follow-up is the test
            first = {"error": str(e)}
        follow = _post_generate(
            srv.port, {"tokens": [9, 10, 11], "max_tokens": 8,
                       "timeout": 45.0})
        if faulted and _disconnects() < 1:
            _diag(0, f"client disconnect was injected but never "
                     f"counted (serving.client_disconnects="
                     f"{_disconnects()}; first reply: {first})")
        _result(0, [("serve", tuple(follow["tokens"]),
                     follow["finish_reason"])])
    finally:
        srv.close()


def scenario_serving_spec_disconnect(device: Optional[str] = None) -> None:
    """``serving.disconnect`` mid-speculation: the engine runs a draft
    model and the prefix cache, the first request dies at the client
    probe, and its abort must release the target and draft KV slots and
    the prefix references (a leak shows in the page accounting the digest
    covers).  The follow-up request shares the first one's prompt header
    (a prefix hit) and must complete identically to the fault-free
    pass."""
    import torch

    from .. import chaos as _chaos
    from ..models.transformer import TransformerConfig, init_transformer
    from ..serving.server import LMServer

    dcfg = TransformerConfig(vocab_size=256, d_model=32, n_heads=2,
                             n_layers=1, d_ff=32, max_seq_len=64)
    draft = init_transformer(torch.Generator().manual_seed(6), dcfg,
                             device=_device(device))
    engine = _small_engine(device, draft=(draft, dcfg), spec_tokens=3,
                           prefix_cache=True)
    srv = LMServer(engine, port=0).start()
    try:
        faulted = _chaos.active()
        header = list(range(40, 56))  # two full 8-token pages
        first: dict = {}
        try:
            first = _post_generate(
                srv.port, {"tokens": header + [5, 6, 7],
                           "max_tokens": 24, "timeout": 45.0})
        except Exception as e:  # noqa: BLE001 — the faulted pass's 499
            # is an HTTPError; the follow-up is the test
            first = {"error": str(e)}
        follow = _post_generate(
            srv.port, {"tokens": header + [9, 10, 11],
                       "max_tokens": 8, "timeout": 45.0})
        if faulted and _disconnects() < 1:
            _diag(0, f"client disconnect was injected but never "
                     f"counted (serving.client_disconnects="
                     f"{_disconnects()}; first reply: {first})")
        # Every slot idle after the abort: free + cached pages cover every
        # page on both stores, and no cached page is still referenced.
        stats = engine.cache.prefix_stats()
        target_ok = (engine.cache.free_pages()
                     == engine.cache.total_pages)
        draft_ok = (engine.draft_cache.free_pages()
                    == engine.draft_cache.total_pages)
        _result(0, [("serve", tuple(follow["tokens"]),
                     follow["finish_reason"]),
                    ("pages", target_ok, draft_ok,
                     stats["referenced_pages"],
                     stats["cached_pages"])])
    finally:
        srv.close()


def scenario_serving_storm(device: Optional[str] = None) -> None:
    """A burst of concurrent ``/generate`` requests against two decode
    slots: every request must complete (or fail explicitly); the front
    door never hangs under a storm."""
    srv = _build_server(device)
    try:
        out: Dict[int, object] = {}

        def one(i: int) -> None:
            try:
                out[i] = tuple(_post_generate(
                    srv.port, {"tokens": [3 + i, 4, 5],
                               "max_tokens": 6,
                               "timeout": 90.0})["tokens"])
            except Exception as e:  # noqa: BLE001 — an explicit
                out[i] = f"error: {e}"  # failure is contract-legal

        threads = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        alive = [i for i, t in enumerate(threads) if t.is_alive()]
        if alive:
            _diag(0, f"storm requests {alive} still hanging")
        _result(0, sorted(("storm", i, str(out.get(i)))
                          for i in range(12)))
    finally:
        srv.close()


def scenario_router_replica_death(device: Optional[str] = None) -> None:
    """Two real replicas (identical params, so completions are bitwise
    identical wherever they run) behind the real Router over real HTTP.
    The faulted pass drains the replica that served the first request and
    then kills its front door hard: the remaining dispatches must fail
    over to the survivor, and the digested completions must match the
    fault-free fleet's exactly."""
    from .. import chaos as _chaos
    from ..routing import Router, RouterConfig
    from ..routing.replica import HttpReplicaClient
    from ..serving.server import LMServer
    from ..telemetry import exporter as _exporter

    def replica():
        # Private routes: two replicas in one process must not clobber
        # each other's /generate and /healthz (LMServer docstring).
        return LMServer(_small_engine(device, prefix_cache=True), port=0,
                        routes=_exporter.RouteRegistry()).start()

    servers = {"a": replica(), "b": replica()}
    router = Router(RouterConfig(probe_base=0.01))
    try:
        for name, srv in servers.items():
            router.add_replica(
                name, HttpReplicaClient("127.0.0.1", srv.port))
        router.poll()
        records = []
        header = list(range(40, 56))  # two full 8-token pages
        status, first = router.dispatch(
            {"tokens": header + [5, 6, 7], "max_tokens": 12})
        if status != 200:
            _diag(0, f"first dispatch failed: {status} {first}")
        records.append(("req0", tuple(first["tokens"]),
                        first["finish_reason"]))
        if _chaos.fire("router.replica_kill") is not None:
            victim = first["router"]["replica"]
            router.drain_replica(victim)  # real POST /drain
            servers[victim].close()       # then the hard death
            router.poll()                 # -> ReplicaUnreachable
        for i, prompt in enumerate((header + [9, 10, 11],
                                    [7, 8, 9, 10])):
            status, resp = router.dispatch({"tokens": prompt,
                                            "max_tokens": 8})
            if status != 200:
                _diag(0, f"dispatch {i + 1} failed after the replica "
                         f"death: {status} {resp}")
            records.append((f"req{i + 1}", tuple(resp["tokens"]),
                            resp["finish_reason"]))
        down = sorted(n for n, s in router.replica_status().items()
                      if s["status"] != "ready")
        if _chaos.active():
            if not down:
                _diag(0, "the kill was injected but every replica "
                         "still reads ready")
            print(f"[hvd-route] failed over from {down} to the "
                  f"surviving replica", flush=True)
        _result(0, records)
    finally:
        for srv in servers.values():
            try:
                srv.close()
            except Exception:  # noqa: BLE001 — the victim is already
                pass           # closed on the faulted pass


def _restart_engine(device: Optional[str], **kw):
    """``router_restart``'s replica: the reference's wider toy model (d 64,
    d_ff 256, 256 positions), so that a 220-token generation is a long
    request beside the first one.  ``kw`` goes to the engine."""
    import torch

    from ..models.transformer import TransformerConfig, init_transformer
    from ..serving.engine import InferenceEngine

    cfg = TransformerConfig(vocab_size=256, d_model=64, n_heads=2,
                            n_layers=2, d_ff=256, max_seq_len=256)
    params = init_transformer(torch.Generator().manual_seed(5), cfg,
                              device=_device(device))
    return InferenceEngine(params, cfg, device=_device(device), max_slots=2,
                           page_size=8, capacity=256, **kw)


def _await_admission(servers, severed, deadline_s: float = 60.0) -> None:
    """Until a replica's ``/healthz`` shows a request in a decode slot (the
    long request, admitted and generating): the kill must land
    mid-generation, and on a fast device a fixed sleep can outlast the
    whole generation."""
    import urllib.error
    import urllib.request

    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        for srv in servers:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{srv.port}/healthz",
                        timeout=5.0) as resp:
                    health = json.loads(resp.read())
            except (urllib.error.URLError, OSError, ValueError):
                continue
            if health.get("serving", {}).get("batch_occupancy", 0) > 0:
                return
        if severed:
            _diag(0, f"the long request ended before any replica showed "
                     f"it admitted: {severed}")
        time.sleep(0.002)
    _diag(0, "no replica admitted the long request")


def scenario_router_restart(device: Optional[str] = None) -> None:
    """The real RouterServer runs in a separate process over two real
    in-process replicas; the faulted pass SIGKILLs it mid-generation.  The
    replicas must abort the severed connections via the client probe (no
    slot leak), a fresh router over the same fleet serves the resubmitted
    request, and the digested completions are identical to the
    never-killed run (the serving bitwise contract makes the retry the
    same answer)."""
    import signal
    import urllib.request

    from .. import chaos as _chaos
    from ..serving.server import LMServer
    from ..telemetry import exporter as _exporter

    def replica():
        return LMServer(_restart_engine(device), port=0,
                        routes=_exporter.RouteRegistry()).start()

    servers = [replica(), replica()]

    def boot_router():
        port = _free_port()
        env = dict(os.environ)
        env.pop("HVD_TPU_FAULTS", None)  # the router child is plain
        env["HVD_TPU_CHAOS_REPLICAS"] = ",".join(
            str(s.port) for s in servers)
        env["HVD_TPU_CHAOS_ROUTER_PORT"] = str(port)
        proc = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.chaos",
             "--scenario", "router_restart_node"],
            env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                _diag(0, f"router child exited {proc.returncode} "
                         f"before becoming healthy")
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz",
                        timeout=2.0) as resp:
                    if resp.status == 200:
                        return proc, port
            except Exception:  # noqa: BLE001 — still booting
                time.sleep(0.1)
        proc.kill()
        _diag(0, "router child never became healthy")

    proc, port = boot_router()
    try:
        records = []
        r0 = _post_generate(port, {"tokens": [5, 6, 7],
                                   "max_tokens": 8})
        records.append(("req0", tuple(r0["tokens"]),
                        r0["finish_reason"]))
        long_payload = {"tokens": [11, 12, 13, 14], "max_tokens": 220}
        if _chaos.fire("router.kill") is not None:
            severed: Dict[str, object] = {}

            def fire_and_forget() -> None:
                try:
                    severed["resp"] = _post_generate(
                        port, long_payload, timeout=120.0)
                except Exception as e:  # noqa: BLE001 — the router
                    severed["error"] = str(e)  # we kill takes it down
            th = threading.Thread(target=fire_and_forget, daemon=True)
            th.start()
            _await_admission(servers, severed)
            proc.send_signal(signal.SIGKILL)
            proc.wait()
            th.join(timeout=30.0)
            proc, port = boot_router()
            aborted = 0
            deadline = time.monotonic() + 45.0
            while time.monotonic() < deadline:
                aborted = _disconnects()
                if aborted >= 1:
                    break
                time.sleep(0.2)
            if aborted < 1:
                _diag(0, f"router killed mid-generation but no "
                         f"replica aborted the orphaned request "
                         f"(client_disconnects={aborted}; severed "
                         f"reply: {severed})")
            print(f"[hvd-route] replica aborted the severed router "
                  f"connection (client_disconnects={aborted}); "
                  f"resubmitting through the restarted router",
                  flush=True)
        rl = _post_generate(port, long_payload, timeout=120.0)
        records.append(("long", tuple(rl["tokens"]),
                        rl["finish_reason"]))
        r2 = _post_generate(port, {"tokens": [9, 10, 11],
                                   "max_tokens": 8})
        records.append(("req2", tuple(r2["tokens"]),
                        r2["finish_reason"]))
        _result(0, records)
    finally:
        proc.kill()
        proc.wait()
        for srv in servers:
            srv.close()


def _router_restart_node(device: Optional[str] = None) -> None:
    """(child helper, no matrix row) The router process of
    ``router_restart``: the real RouterServer over HTTP clients to the
    parent scenario's replicas; the parent SIGKILLs it mid-generation on
    the faulted pass.  It runs no tensor work (``device`` is unused)."""
    from ..routing import Router, RouterConfig, RouterServer
    from ..routing.replica import HttpReplicaClient

    ports = [int(p) for p in
             os.environ["HVD_TPU_CHAOS_REPLICAS"].split(",")]
    router = Router(RouterConfig(probe_base=0.01))
    for i, port in enumerate(ports):
        router.add_replica(f"r{i}",
                           HttpReplicaClient("127.0.0.1", port))
    RouterServer(
        router, port=int(os.environ["HVD_TPU_CHAOS_ROUTER_PORT"]),
        poll_interval=0.2).start()
    while True:  # serve until the parent kills us
        time.sleep(60.0)


LOCAL_SCENARIOS = {
    "ckpt_flaky": lambda device=None: scenario_ckpt(False, device),
    "ckpt_exhaustion": lambda device=None: scenario_ckpt(True, device),
    "input_stall": scenario_input_stall,
    "serving_disconnect": scenario_serving_disconnect,
    "serving_spec_disconnect": scenario_serving_spec_disconnect,
    "serving_storm": scenario_serving_storm,
    "router_replica_death": scenario_router_replica_death,
    "router_restart": scenario_router_restart,
    "router_restart_node": _router_restart_node,
}


# ---------------------------------------------------------------------------
# The runner
# ---------------------------------------------------------------------------

def _child_env(s: Scenario, faulted: bool,
               extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    env = dict(os.environ)
    env.pop("HVD_TPU_FAULTS", None)
    env.update(s.env)
    if faulted and s.spec:
        env["HVD_TPU_FAULTS"] = s.spec
    # The children run with the lock-order and race checkers armed:
    # chaos is where cross-thread interleavings and stale reads on the
    # recovery paths surface.
    env.setdefault("HVD_TPU_LOCK_CHECK", "1")
    env.setdefault("HVD_TPU_RACE_CHECK", "1")
    env.update(extra or {})
    return env


@dataclass
class PassResult:
    rc: Optional[int]   # None = killed at the cap (HANG)
    output: str
    results: Dict[int, str]  # rank -> CHAOS_RESULT line payload
    seconds: float
    # rank -> its kernel launches (CHAOS_LAUNCHES), by kernel
    launches: Dict[int, Dict[str, int]] = field(default_factory=dict)


_RESULT_RE = re.compile(
    r"CHAOS_RESULT rank=(\d+) n=(\d+) digest=([0-9a-f]{24})")
_LAUNCHES_RE = re.compile(r"CHAOS_LAUNCHES rank=(\d+) (\{[^{}]*\})")


def _parse_results(output: str) -> Dict[int, str]:
    # Matched by the exact field shapes (a 24-hex-digit digest), not by
    # line splitting: a concurrent writer on the same descriptor can glue
    # a log fragment onto a digest line.
    out: Dict[int, str] = {}
    for m in _RESULT_RE.finditer(output):
        out[int(m.group(1))] = f"n={m.group(2)} digest={m.group(3)}"
    return out


def _parse_launches(output: str) -> Dict[int, Dict[str, int]]:
    return {int(m.group(1)): json.loads(m.group(2))
            for m in _LAUNCHES_RE.finditer(output)}


def fleet_device(s: Scenario, device: str) -> str:
    """The device a scenario's processes run on: a cp fleet needs one
    card a rank, so with fewer cards than ranks it runs on the CPU."""
    if s.kind != "cp" or device == "cpu":
        return device
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() >= s.np:
        return device
    return "cpu"


def _run_pass(s: Scenario, faulted: bool, device: str) -> PassResult:
    t0 = time.monotonic()
    cmd = [sys.executable, "-m", "horovod_tpu_torch.chaos",
           "--device", fleet_device(s, device)]
    if s.kind == "local":
        procs = [subprocess.Popen(
            cmd + ["--scenario", s.name],
            env=_child_env(s, faulted, {"HVD_TPU_RANK": "0"}),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)]
    else:
        store = rendezvous_store()
        procs = [subprocess.Popen(
            cmd + ["--node", str(rank), "--np", str(s.np),
                   "--port", str(store.port), "--scenario", s.name],
            env=_child_env(s, faulted, {"HVD_TPU_RANK": str(rank),
                                        **AGENT_STORE_ENV}),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for rank in range(s.np)]
    deadline = t0 + s.cap
    outputs: List[str] = [""] * len(procs)
    hang = False
    for i, p in enumerate(procs):
        remaining = deadline - time.monotonic()
        try:
            out, _ = p.communicate(timeout=max(0.1, remaining))
        except subprocess.TimeoutExpired:
            hang = True
            p.kill()
            out, _ = p.communicate()
        outputs[i] = out.decode(errors="replace")
    if hang:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    output = "\n".join(outputs)
    rcs = [p.returncode for p in procs]
    rc: Optional[int] = None if hang else max(rcs)
    return PassResult(rc=rc, output=output,
                      results=_parse_results(output),
                      seconds=time.monotonic() - t0,
                      launches=_parse_launches(output))


def _count_launches(report: Dict, nproc: int, *passes: PassResult) -> None:
    """The passes' kernel launches, summed by kernel, into ``report``,
    and the processes that reported none (``unreported``: a count of
    none is not a count of zero)."""
    total: Dict[str, int] = {}
    missing = []
    for i, p in enumerate(passes):
        for rank in range(nproc):
            if rank not in p.launches:
                missing.append(f"pass {i} rank {rank}")
                continue
            for k, n in p.launches[rank].items():
                total[k] = total.get(k, 0) + n
    report["launches"] = total
    report["unreported"] = missing


def run_scenario(s: Scenario, verbose: bool = False,
                 device: str = "cuda") -> Dict:
    """Run one scenario end to end; returns its report."""
    dev = fleet_device(s, device)
    report: Dict = {"scenario": s.name, "expect": s.expect,
                    "spec": s.spec, "cap": s.cap, "device": dev}
    if dev != device:
        report["note"] = (f"a fleet of {s.np} ranks needs {s.np} cards; "
                          f"ran on {dev}")

    def fail(status: str, detail: str, *passes: PassResult) -> Dict:
        report.update(status=status, detail=detail)
        print(f"  FAIL [{status}] {s.name}: {detail}", flush=True)
        for p in passes:
            tail = "\n".join(p.output.splitlines()[-25:])
            print(f"  ---- pass output tail ----\n{tail}", flush=True)
        return report

    nproc = s.np if s.kind == "cp" else 1
    if s.expect == "complete":
        p = _run_pass(s, False, device)
        report["seconds"] = p.seconds
        _count_launches(report, nproc, p)
        if p.rc is None:
            return fail("HANG", f"still running at the {s.cap:.0f}s "
                                f"cap", p)
        if p.rc != 0:
            return fail("FAIL", f"exit {p.rc}", p)
        report["status"] = "PASS"
        print(f"  PASS {s.name} on {dev} ({p.seconds:.1f}s)", flush=True)
        return report

    base: Optional[PassResult] = None
    if s.expect == "recover":
        base = _run_pass(s, False, device)
        if base.rc is None:
            return fail("HANG", "fault-free pass hit the cap", base)
        if base.rc != 0:
            return fail("FAIL", f"fault-free pass exited {base.rc}",
                        base)
    fp = _run_pass(s, True, device)
    report["seconds"] = (base.seconds if base else 0.0) + fp.seconds
    _count_launches(report, nproc, *([base, fp] if base else [fp]))
    report["fired"] = fp.output.count("[hvd-chaos] rank")
    if fp.rc is None:
        return fail("HANG", f"faulted run still alive at the "
                            f"{s.cap:.0f}s cap: the no-hang contract "
                            f"violation", fp)
    if s.expect == "recover":
        if fp.rc != 0:
            return fail("FAIL", f"expected recovery, got exit {fp.rc}",
                        fp)
        if fp.results != base.results or not fp.results:
            return fail(
                "DIVERGED",
                f"recovered but results differ: fault-free "
                f"{base.results} vs faulted {fp.results}", base, fp)
        if s.needle and s.needle not in fp.output:
            return fail("FAIL", f"recovered, but the fault was never "
                                f"exercised ({s.needle!r} not in "
                                f"output)", fp)
    else:  # diagnostic
        if fp.rc == 0:
            return fail("FAIL", "expected a named failure, run "
                                "exited 0", fp)
        if s.needle and s.needle not in fp.output:
            return fail("FAIL", f"failed, but without the diagnostic "
                                f"naming the fault ({s.needle!r} not "
                                f"in output)", fp)
    report["status"] = "PASS"
    print(f"  PASS {s.name} on {dev} ({report['seconds']:.1f}s, "
          f"{report['fired']} firing(s))", flush=True)
    if verbose:
        print(fp.output)
    return report


def run_matrix(only: Optional[List[str]] = None, verbose: bool = False,
               device: str = "cuda", jobs: int = 1) -> int:
    """Run the matrix (or ``only``'s scenarios) and print one JSON report;
    ``jobs`` scenarios run at a time.  Returns 1 if any failed."""
    todo = [find(n) for n in only] if only else SCENARIOS
    print(f"hvd-chaos matrix: {len(todo)} scenario(s) on {device}",
          flush=True)
    for s in todo:
        dev = fleet_device(s, device)
        print(f"- {s.name} [{s.kind} np={s.np if s.kind == 'cp' else 1}"
              f" expect={s.expect} device={dev}] {s.doc}"
              + (f" (a fleet of {s.np} ranks needs {s.np} cards: on "
                 f"{dev})" if dev != device else ""), flush=True)
    with ThreadPoolExecutor(max_workers=max(1, jobs)) as pool:
        # The matrix ends with its last scenario: start those with the
        # longest caps (the local serving and router ones) first; the
        # report keeps the matrix's order.
        futures = {i: pool.submit(run_scenario, s, verbose=verbose,
                                  device=device)
                   for i, s in sorted(enumerate(todo),
                                      key=lambda t: -t[1].cap)}
        reports = [futures[i].result() for i in range(len(todo))]
    failed = [r for r in reports if r.get("status") != "PASS"]
    print(json.dumps({"scenarios": reports,
                      "passed": len(reports) - len(failed),
                      "failed": len(failed)}, indent=1))
    return 1 if failed else 0
