"""horovod_tpu_torch's analysis package (analysis/) against horovod_tpu's.

* The pure cases of tests/test_analysis.py run on both packages
  (parametrized): that file's module globals (``L``, ``lockorder``,
  ``prog``, ``races``, ``troles``, ``wire``, ``hvd_analysis``, ``PKG``)
  are pointed at the port's modules for the port's run.  Left out, with
  their reasons, in ``EXCLUDED``: the donation pass's cases (the port has
  no counterpart, ROADMAP.md §A) and the cases that drive the JAX
  runtime, each of which has a port case below.
* The lint and thread-role findings of both packages on the same
  snippets render the same, exactly.
* ``compare_signatures``, ``cross_validate`` and ``ProgramTracker`` on
  200 seeded program pairs give equal messages, exactly.
* The port's runtime on one rank: the recorder's fields, the torch
  frontend's source tag, the coordinator's tracker error, the cache
  gate, ``verify_program`` without an exchange, the named locks.
* ``test_port_tree_is_clean``: no finding over the port's package, and
  the CLI's ``--strict`` exit codes.

The 3-rank ``verify_program`` exchange is in tests/test_torch_trace.py's
one gloo job.
"""

import inspect
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

import horovod_tpu.analysis as ref_analysis
from horovod_tpu.analysis import program as ref_prog
from horovod_tpu.ops import wire as ref_wire

import horovod_tpu_torch as thvd
import horovod_tpu_torch.analysis as port_analysis
from horovod_tpu_torch.analysis import lint as port_lint
from horovod_tpu_torch.analysis import lockorder as port_lockorder
from horovod_tpu_torch.analysis import program as port_prog
from horovod_tpu_torch.analysis import races as port_races
from horovod_tpu_torch.analysis import threads as port_threads
from horovod_tpu_torch.ops import wire as port_wire

import test_analysis as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = os.path.join(REPO, "horovod_tpu_torch")

EXCLUDED = {
    # analysis/donation.py has no counterpart (no buffer donation in
    # torch; ROADMAP.md §A "No counterpart needed").
    "test_post_donation_read_is_caught": "donation pass",
    "test_post_donation_rebind_idiom_is_clean": "donation pass",
    "test_post_donation_read_waiver": "donation pass",
    "test_guard_dispatch_names_the_original_donation": "donation pass",
    "test_donation_check_probe_and_poisoned_buffer": "donation pass",
    "test_guard_dispatch_disarmed_is_plain_call": "donation pass",
    "test_analyze_sources_merges_every_pass":
        "seeds a post-donation read; test_analyze_sources_merges_the_"
        "ports_passes holds the rest",
    # Cases that drive the JAX runtime or import its modules inside the
    # function; each has a port case in this file.
    "test_verify_program_single_process": "JAX runtime (hvd2)",
    "test_recorder_captures_signature_fields": "JAX runtime (hvd2)",
    "test_collective_source_tagging": "JAX runtime (hvd2)",
    "test_coordinator_program_check_emits_error_response":
        "imports the reference's Coordinator",
    "test_cli_strict_exit_codes": "imports the reference's main",
}

CASES = sorted(name for name, fn in inspect.getmembers(R, inspect.isfunction)
               if name.startswith("test_") and name not in EXCLUDED)


def test_every_reference_case_is_run_or_excluded_with_a_reason():
    names = {n for n, _ in inspect.getmembers(R, inspect.isfunction)
             if n.startswith("test_")}
    assert set(EXCLUDED) <= names
    assert set(CASES) | set(EXCLUDED) == names
    assert len(CASES) >= 30


def _point_at_port(monkeypatch):
    for attr, mod in (("L", port_lint), ("lockorder", port_lockorder),
                      ("prog", port_prog), ("races", port_races),
                      ("troles", port_threads), ("wire", port_wire),
                      ("hvd_analysis", port_analysis), ("PKG", PORT_PKG)):
        monkeypatch.setattr(R, attr, mod)


@pytest.mark.parametrize("which", ["reference", "port"])
@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, which, monkeypatch, tmp_path, capsys):
    if which == "port":
        _point_at_port(monkeypatch)
    fn = getattr(R, case)
    avail = {"monkeypatch": monkeypatch, "tmp_path": tmp_path,
             "capsys": capsys}
    fn(**{p: avail[p] for p in inspect.signature(fn).parameters})


# ---------------------------------------------------------------------------
# The same snippets, the same findings
# ---------------------------------------------------------------------------

SNIPPETS = {
    "guarded": R.GUARDED_CLASS + """
        def bad(self):
            return len(self.items)

        def waived(self):
            return len(self.items)  # lint: ok(snapshot for debug dump)
""",
    "blocking": """
    import threading
    import time

    _lock = threading.Lock()

    def f(sock, fut):
        with _lock:
            time.sleep(1)
            sock.recv(4)
            fut.result()
""",
    "rank": """
    from horovod_tpu_torch import allreduce, broadcast, rank, local_rank

    def f(x):
        if rank() == 0:
            allreduce(x)
        else:
            broadcast(x, 0)
        if local_rank() == 1:
            pass
        else:
            broadcast(x, 0)
""",
    "threads": R.THREADED_SRC,
    "stale": """
    def clean():
        return 2  # lint: ok(nothing fires here)
""",
    "merged": """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self.items = []  # guarded_by: _lock

        def bad(self):
            return len(self.items)

        def rx_loop(self):  # thread: rx
            self.flush()

        def flush(self):  # thread: writer
            pass

    def clean():
        return 2  # lint: ok(nothing fires here)
""",
}


@pytest.mark.parametrize("snippet", sorted(SNIPPETS))
def test_findings_render_the_same(snippet):
    src = {"seed.py": textwrap.dedent(SNIPPETS[snippet])}
    want = [f.render() for f in ref_analysis.analyze_sources(src)]
    got = [f.render() for f in port_analysis.analyze_sources(src)]
    assert got == want
    assert [f.render() for f in port_lint.lint_sources(src)] == \
        [f.render() for f in ref_analysis.lint_sources(src)]


def test_analyze_sources_merges_the_ports_passes():
    """The reference's merged-driver case without its donation seed:
    lint, thread-role and stale-waiver all report, sorted."""
    findings = port_analysis.analyze_sources(
        {"seed.py": textwrap.dedent(SNIPPETS["merged"])})
    assert sorted(f.rule for f in findings) == [
        "guarded-by", "stale-waiver", "thread-role"]


# ---------------------------------------------------------------------------
# compare_signatures / cross_validate / ProgramTracker on seeded programs
# ---------------------------------------------------------------------------

def _seeded_pair(seed):
    """Two or three ranks' programs from one seed: a common program, then
    one seeded change (none, dtype, shape, op, reduce op, order, count,
    a process-set swap, a ragged allgather) on one rank."""
    rng = np.random.RandomState(seed)
    ops = ["allreduce", "allgather", "broadcast", "alltoall",
           "reducescatter"]
    n = int(rng.randint(3, 9))
    base = []
    for i in range(n):
        op = ops[rng.randint(len(ops))]
        red = ["SUM", "AVERAGE", "MIN"][rng.randint(3)] \
            if op in ("allreduce", "reducescatter") else ""
        base.append(dict(seq=i, op=op, name=f"t.{i}",
                         dtype=["float32", "bfloat16", "int32"][
                             rng.randint(3)],
                         shape=tuple(int(d) for d in rng.randint(
                             1, 5, size=rng.randint(1, 3))),
                         reduce_op=red, process_set_id=int(rng.randint(3))))
    ranks = int(rng.randint(2, 4))
    progs = {r: [dict(e) for e in base] for r in range(ranks)}
    victim = int(rng.randint(1, ranks))
    kind = rng.randint(9)
    p = progs[victim]
    j = int(rng.randint(n))
    if kind == 1:
        p[j]["dtype"] = "float16"
    elif kind == 2:
        p[j]["shape"] = p[j]["shape"][:-1] + (p[j]["shape"][-1] + 1,)
    elif kind == 3:
        p[j]["op"] = "broadcast" if p[j]["op"] != "broadcast" else "allgather"
    elif kind == 4:
        p[j]["reduce_op"] = "MAX"
    elif kind == 5 and n > 1:
        k = (j + 1) % n
        p[j], p[k] = dict(p[k], seq=j), dict(p[j], seq=k)
    elif kind == 6:
        p.append(dict(p[-1], seq=n, name="t.extra"))
    elif kind == 7 and n > 1:
        k = (j + 1) % n
        p[j]["process_set_id"], p[k]["process_set_id"] = 1, 2
        progs[0][j]["process_set_id"], progs[0][k]["process_set_id"] = 1, 2
        p[j], p[k] = dict(p[k], seq=j), dict(p[j], seq=k)
    elif kind == 8:
        p[j]["shape"] = (p[j]["shape"][0] + 1,) + p[j]["shape"][1:]
    return progs


@pytest.mark.parametrize("chunk", range(4))
def test_signature_comparison_messages_equal_on_200_seeded_programs(chunk):
    diverged = 0
    for seed in range(chunk * 50, chunk * 50 + 50):
        progs = _seeded_pair(seed)
        msgs = []
        for prog in (ref_prog, port_prog):
            entries = {r: [prog.SignatureEntry(**e) for e in p]
                       for r, p in progs.items()}
            totals = {r: len(p) for r, p in entries.items()}
            direct = prog.compare_signatures(entries, totals)
            packed = {r: prog.pack_program(r, p, totals[r])
                      for r, p in entries.items()}
            assert prog.cross_validate(packed) == direct, seed
            tracker = prog.ProgramTracker(len(entries))
            fed = []
            wire = ref_wire if prog is ref_prog else port_wire
            rt = {"allreduce": wire.RequestType.ALLREDUCE,
                  "allgather": wire.RequestType.ALLGATHER,
                  "broadcast": wire.RequestType.BROADCAST,
                  "alltoall": wire.RequestType.ALLTOALL,
                  "reducescatter": wire.RequestType.REDUCESCATTER}
            dt = {"float32": wire.DataType.FLOAT32,
                  "bfloat16": wire.DataType.BFLOAT16,
                  "int32": wire.DataType.INT32,
                  "float16": wire.DataType.FLOAT16}
            red = {"": wire.ReduceOp.SUM, "SUM": wire.ReduceOp.SUM,
                   "AVERAGE": wire.ReduceOp.AVERAGE,
                   "MIN": wire.ReduceOp.MIN, "MAX": wire.ReduceOp.MAX}
            longest = max(len(p) for p in progs.values())
            for i in range(longest):
                for r in sorted(progs):
                    if i < len(progs[r]):
                        e = progs[r][i]
                        fed.append(tracker.feed(wire.Request(
                            request_rank=r, request_type=rt[e["op"]],
                            tensor_type=dt[e["dtype"]],
                            tensor_name=e["name"],
                            tensor_shape=e["shape"],
                            reduce_op=red[e["reduce_op"]],
                            process_set_id=e["process_set_id"])))
            msgs.append((direct, fed))
        assert msgs[1] == msgs[0], seed
        diverged += msgs[0][0] is not None
    assert diverged >= 25  # the seeds exercise the divergence paths


# ---------------------------------------------------------------------------
# The port's runtime on one rank
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank():
    thvd.init(device="cpu")
    port_prog.recorder().clear()
    yield thvd
    port_prog.recorder().clear()
    thvd.shutdown()


def test_verify_program_single_process(one_rank):
    one_rank.allreduce(torch.ones(3), average=False, name="vp.op")
    rep = one_rank.verify_program()
    assert rep.ranks == 1 and rep.entries == 1 and len(rep.digest) == 64
    assert port_prog.recorder().total() == 0  # reset=True


def test_recorder_captures_signature_fields(one_rank):
    one_rank.allreduce(torch.ones(4), average=False, name="cap.op")
    one_rank.allgather(torch.ones(2, 3, dtype=torch.bfloat16),
                       name="cap.g")
    a, g = port_prog.recorder().entries()
    assert (a.op, a.name, a.dtype, a.shape, a.reduce_op,
            a.process_set_id) == ("allreduce", "cap.op", "float32", (4,),
                                  port_wire.reduce_op_name(
                                      port_wire.ReduceOp.SUM), 0)
    assert (g.op, g.dtype, g.shape, g.reduce_op) == (
        "allgather", "bfloat16", (2, 3), "")
    assert a.reduce_op == ref_wire.reduce_op_name(ref_wire.ReduceOp.SUM)


def test_collective_source_tagging(one_rank):
    import horovod_tpu_torch.frontends.torch as fhvd

    with port_prog.collective_source("torch"):
        one_rank.allreduce(torch.ones(2), average=False, name="tag.op")
    fhvd.allreduce(torch.ones(2), name="tag.fe")
    e0, e1 = port_prog.recorder().entries()
    assert e0.source == "torch" and e1.source == "torch"


def test_coordinator_program_check_emits_error_response(monkeypatch):
    monkeypatch.setenv("HVD_TPU_VERIFY_PROGRAM", "1")
    monkeypatch.setenv("HVD_TPU_DISABLE_NATIVE", "1")
    from horovod_tpu_torch.ops import cache
    from horovod_tpu_torch.ops.coordinator import Coordinator

    assert not cache.cache_enabled()  # the tracker turns the cache off
    coord = Coordinator(size=2, fusion_threshold=1 << 20)
    coord.submit(R._req(0, "a"))
    coord.submit(R._req(1, "b"))
    resps = coord.poll_responses({})
    errs = [r for r in resps
            if r.response_type == port_wire.ResponseType.ERROR]
    assert errs, resps
    ref_msg = ref_prog.ProgramTracker(2)
    ref_msg.feed(R._req(0, "a"))
    assert errs[0].error_message == ref_msg.feed(R._req(1, "b"))
    coord.close()


def test_runtime_locks_are_the_references_named_locks(monkeypatch):
    monkeypatch.setenv("HVD_TPU_LOCK_CHECK", "1")
    thvd.init(device="cpu")
    try:
        from horovod_tpu_torch.core import state

        rt = state._state.runtime
        names = {rt._lock._name, rt.cycle_lock._name,
                 rt.handles._lock._name, rt.cache._lock._name,
                 rt.coordinator._inflight_lock._name,
                 state._state.lock._name}
        assert names == {"OpQueue._lock", "collective._drain_lock",
                         "HandleManager._lock", "ResponseCache._lock",
                         "Coordinator._inflight", "GlobalState.lock"}
        thvd.allreduce(torch.ones(2), name="locks.op")
    finally:
        thvd.shutdown()


def test_runtime_is_race_checked_under_the_env(monkeypatch):
    """tests/conftest.py arms both checkers for the whole suite, so the
    port's shared classes carry the tracking descriptors here."""
    if os.environ.get("HVD_TPU_RACE_CHECK") != "1":
        pytest.skip("the race checker is armed by tests/conftest.py")
    from horovod_tpu_torch.ops import cache, collective, coordinator, handles

    for cls, field in ((collective.Runtime, "_ops"),
                       (cache.ResponseCache, "_entries"),
                       (coordinator.PyCoordinator, "table"),
                       (coordinator.Coordinator, "_inflight"),
                       (handles.HandleManager, "_handles")):
        assert isinstance(cls.__dict__.get(field), port_races._TrackedField), \
            (cls, field)


def test_telemetry_publishes_the_checkers_counts():
    snap = thvd.metrics()
    assert snap["analysis.race_checks"]["value"] == port_races.check_count()
    assert "analysis.thread_role_asserts" in snap
    assert "analysis.donation_poisoned" not in snap


def test_thread_roles_are_stamped_on_the_ports_threads(tmp_path):
    from horovod_tpu_torch.parallel.input import prefetch_to_device

    seen = []

    def loader():
        seen.append(port_threads.current_role())
        yield {"x": torch.zeros(2)}

    thvd.init(device="cpu")
    try:
        with prefetch_to_device(loader(), depth=1) as it:
            list(it)
    finally:
        thvd.shutdown()
    assert seen == ["stager"]


# ---------------------------------------------------------------------------
# The acceptance gate
# ---------------------------------------------------------------------------

def test_port_tree_is_clean(tmp_path):
    findings = port_analysis.analyze_paths([PORT_PKG])
    assert findings == [], "\n".join(f.render() for f in findings)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    cli = [sys.executable, "-m", "horovod_tpu_torch.analysis"]
    ok = subprocess.run(cli + ["--strict", PORT_PKG], cwd=REPO, env=env,
                        capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "0 finding(s)" in ok.stderr
    bad = tmp_path / "bad.py"
    bad.write_text(textwrap.dedent("""
        import threading
        import time

        _lock = threading.Lock()

        def f():
            with _lock:
                time.sleep(1)
    """))
    advisory = subprocess.run(cli + [str(bad)], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
    assert advisory.returncode == 0
    strict = subprocess.run(cli + ["--strict", str(bad)], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=120)
    assert strict.returncode == 1
    assert "blocking-under-lock" in strict.stdout


def test_cli_main_matches_the_references(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import threading\n_lock = threading.Lock()\n\n"
                   "def f(fut):\n    with _lock:\n        fut.result()\n")
    assert port_analysis.main([str(bad)]) == 0
    port_out = capsys.readouterr().out
    assert ref_analysis.main([str(bad)]) == 0
    assert capsys.readouterr().out == port_out
    assert port_analysis.main(["--strict", str(bad)]) == 1


def test_a_finalizer_inside_the_graph_update_does_not_deadlock():
    """The port's one change to lockorder.py: the garbage collector may
    run a ``weakref.finalize`` callback (the memory ledger's frees)
    inside a thread's own lock-order graph update; a checked lock taken
    there records the hold and skips the graph instead of blocking on
    the graph's non-reentrant lock (which hung two suites' runs)."""
    import gc
    import weakref

    inner = port_lockorder.CheckedLock("fin.inner")
    ran = []

    class Holder:
        pass

    def finalizer():
        with inner:
            ran.append(port_lockorder._held_stack()[-1])

    obj = Holder()
    obj.cycle = obj  # collected by gc.collect(), not by refcount
    weakref.finalize(obj, finalizer)
    del obj
    done = threading.Event()

    def update():
        with port_lockorder._graph_section():
            gc.collect()
        done.set()

    t = threading.Thread(target=update, daemon=True)
    t.start()
    t.join(30)
    assert done.is_set() and ran == ["fin.inner"]
    with inner:  # the hold was released: the lock works afterwards
        pass
