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
scenario's fault sequence is deterministic (``chaos/spec.py``), so a
failure reproduces from its spec line.

Scenario kinds:

* ``cp``: an np=2 fleet of the port's real runtime: each rank a process
  that calls ``init()`` and drives negotiated allreduces through the
  gloo control exchange, the coordinator and the response cache.  The
  digest covers every completed negotiation ``(step, tensor, response
  type)`` each rank executed, and the results' bytes.  A fleet needs one
  card a rank: with fewer cards than ranks it runs on the CPU (gloo), and
  the output says so.
* ``local``: one process with the port's stack on ``--device`` (the
  checkpoint writer, the prefetch stager, the serving front door);
  digests cover real bytes (the checkpoint file, trained values,
  generated tokens).

The reference's other scenarios wait for the steps that bring their
sites (:data:`WAITING`): the TCP control channel's ``transport_*``,
``grace_expiry`` and ``tree_*``, tuning's ``retune_midfault`` and the
router's ``router_*`` (ROADMAP.md §A.5 items 4, 5 and 6).
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
]

# The reference's scenarios whose sites the port does not host yet, with
# the step (ROADMAP.md §A.5) that brings them.
_TCP = ("§A.5 item 4, the TCP decision: the reference's TCP control "
        "channel (ops/transport.py framing and session resume)")
WAITING: Dict[str, str] = {
    "transport_reset_worker": _TCP,
    "transport_reset_np3": _TCP,
    "transport_reset_controller": _TCP,
    "transport_trunc": _TCP,
    "transport_dup_delay": _TCP,
    "transport_drop": _TCP,
    "transport_stall": _TCP,
    "grace_expiry": _TCP + " and its reconnect grace window",
    "tree_interior_down": _TCP + " with the tree overlay ops/tree.py",
    "tree_leaf_reset": _TCP + " with the tree overlay ops/tree.py",
    "retune_midfault": "§A.5 item 5: tuning/ and its RETUNE markers "
                       "(and item 4's session resume)",
    "router_replica_death": "§A.5 item 6: routing/'s router and replicas",
    "router_restart": "§A.5 item 6: routing/'s router server",
}


def find(name: str) -> Scenario:
    for s in SCENARIOS:
        if s.name == name:
            return s
    if name in WAITING:
        raise SystemExit(f"chaos scenario {name!r} waits for "
                         f"{WAITING[name]}")
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


def _device(name: Optional[str]):
    import torch

    return torch.device(name or "cuda")


# ---------------------------------------------------------------------------
# cp nodes: a real-process fleet of the port's runtime
# ---------------------------------------------------------------------------

CP_STEP_DEADLINE = 8.0
# One tensor a dtype, so the four are four responses of a cycle (tensors
# of one dtype fuse into one): coord.reorder has something to permute.
CP_DTYPES = ("float32", "float64", "int32", "int64")


def _cp_steps() -> int:
    """Steps a cp pass (the tests run a short fleet; the matrix's
    default is 40)."""
    return int(os.environ.get("HVD_TPU_CHAOS_CP_STEPS", "40"))


def run_cp_node(device: Optional[str] = None) -> None:
    """One rank of the cp fleet (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
    and ``MASTER_PORT`` set by the CLI): ``init()``, then each step one
    grouped allreduce of a tensor a dtype, then synchronized.  Every
    response the runtime executes is recorded with the step it completed
    in; so are the results' bytes."""
    import torch

    import horovod_tpu_torch as hvd
    from ..core import state as _state
    from ..ops.wire import ResponseType

    hvd.init(device=device or "cuda")
    rank = hvd.rank()
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
        return execute(resp, tl)

    rt._execute = recording
    values = hashlib.sha256()
    try:
        for step in range(_cp_steps()):
            step_now[0] = step
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


LOCAL_SCENARIOS = {
    "ckpt_flaky": lambda device=None: scenario_ckpt(False, device),
    "ckpt_exhaustion": lambda device=None: scenario_ckpt(True, device),
    "input_stall": scenario_input_stall,
    "serving_disconnect": scenario_serving_disconnect,
    "serving_spec_disconnect": scenario_serving_spec_disconnect,
    "serving_storm": scenario_serving_storm,
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


_RESULT_RE = re.compile(
    r"CHAOS_RESULT rank=(\d+) n=(\d+) digest=([0-9a-f]{24})")


def _parse_results(output: str) -> Dict[int, str]:
    # Matched by the exact field shapes (a 24-hex-digit digest), not by
    # line splitting: a concurrent writer on the same descriptor can glue
    # a log fragment onto a digest line.
    out: Dict[int, str] = {}
    for m in _RESULT_RE.finditer(output):
        out[int(m.group(1))] = f"n={m.group(2)} digest={m.group(3)}"
    return out


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
        port = _free_port()
        procs = [subprocess.Popen(
            cmd + ["--node", str(rank), "--np", str(s.np),
                   "--port", str(port), "--scenario", s.name],
            env=_child_env(s, faulted, {"HVD_TPU_RANK": str(rank)}),
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
                      seconds=time.monotonic() - t0)


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

    if s.expect == "complete":
        p = _run_pass(s, False, device)
        report["seconds"] = p.seconds
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
    print(f"hvd-chaos matrix: {len(todo)} scenario(s) on {device}; "
          f"waiting for later steps: {', '.join(sorted(WAITING))}",
          flush=True)
    for s in todo:
        dev = fleet_device(s, device)
        print(f"- {s.name} [{s.kind} np={s.np if s.kind == 'cp' else 1}"
              f" expect={s.expect} device={dev}] {s.doc}"
              + (f" (a fleet of {s.np} ranks needs {s.np} cards: on "
                 f"{dev})" if dev != device else ""), flush=True)
    with ThreadPoolExecutor(max_workers=max(1, jobs)) as pool:
        reports = list(pool.map(
            lambda s: run_scenario(s, verbose=verbose, device=device),
            todo))
    failed = [r for r in reports if r.get("status") != "PASS"]
    print(json.dumps({"scenarios": reports,
                      "passed": len(reports) - len(failed),
                      "failed": len(failed)}, indent=1))
    return 1 if failed else 0
