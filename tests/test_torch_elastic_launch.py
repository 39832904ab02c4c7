"""``python -m horovod_tpu_torch.run`` over real processes on 2 gloo ranks
(``--device cpu``): the reference's slow-marked launcher cases
(tests/test_multiprocess.py:226,285 and tests/test_examples.py:176) run
here on the port.

* one hard death of rank 1 at step 5 gives exactly one relaunch; the
  survivor diagnoses the dead peer and exits EX_TEMPFAIL by itself; both
  ranks resume from the step-4 commit and end within 1e-4 of the
  reference test's numpy replay;
* two deaths (steps 3 and 7) give two relaunches, resuming from steps 2
  and 6;
* the example ``examples/elastic_train.py`` dies, relaunches and resumes;
* without ``--elastic`` each line carries its ``[rank]`` prefix;
* ``--grace`` ends a worker that hangs after its peer failed.

The launches start together (a module fixture) so the file takes about
as long as its longest launch; each test reads its own launch's output.
"""

import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_elastic_worker.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_elastic_worker import replay  # noqa: E402

TIMEOUT = 240.0


def _env(**extra):
    env = dict(os.environ)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT", "HVD_TPU_ELASTIC", "HVD_TPU_ELASTIC_DIR",
              "HVD_TPU_FAULTS"):
        env.pop(k, None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


class Launch:
    """One launcher run in the background; ``result()`` waits for it
    (killing it at the timeout) and returns ``(rc, output, seconds)``,
    ``seconds`` the launch's own, timed by a thread that waits for it from
    the start (not until the test that reads it runs)."""

    def __init__(self, args, **env):
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.run", *args],
            cwd=REPO, env=_env(**env), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self._out = None
        self._waiter = threading.Thread(target=self._wait, daemon=True)
        self._waiter.start()

    def _wait(self):
        try:
            out, _ = self.proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        self._out = (self.proc.returncode, out, time.monotonic() - self.t0)

    def result(self):
        self._waiter.join(timeout=TIMEOUT + 30.0)
        assert not self._waiter.is_alive(), "the launch did not end"
        return self._out


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    # A killed rank is diagnosed when its reconnect grace runs out; the
    # launches that kill one set a short window, as the chaos matrix's
    # grace_expiry does.
    grace = {"HVD_TPU_RECONNECT_GRACE": "1.5"}
    runs = {
        "elastic": Launch(["-np", "2", "--elastic", "--max-restarts", "2",
                           "--elastic-dir", str(d / "one"), WORKER,
                           "elastic"], **grace),
        "elastic2": Launch(["-np", "2", "--elastic", "--max-restarts", "3",
                            "--elastic-dir", str(d / "two"), WORKER,
                            "elastic2"], **grace),
        "example": Launch(["-np", "2", "--elastic", "--max-restarts", "2",
                           "--elastic-dir", str(d / "example"), "-m",
                           "horovod_tpu_torch.examples.elastic_train",
                           "--device", "cpu"],
                          HVD_TPU_EXAMPLE_DIE_AT="5", **grace),
        "plain": Launch(["-np", "2", "-m",
                         "horovod_tpu_torch.examples.elastic_train",
                         "--device", "cpu"]),
        "hang": Launch(["-np", "2", "--grace", "2", WORKER, "hang"]),
    }
    for name in ("one", "two", "example"):
        (d / name).mkdir(exist_ok=True)
    yield runs
    for run in runs.values():
        if run.proc.poll() is None:
            run.proc.kill()
            run.proc.communicate()


def test_one_death_one_relaunch_resumes_from_the_commit(launches):
    rc, out, seconds = launches["elastic"].result()
    assert rc == 0, out
    assert out.count("[elastic] job failed") == 1, out
    assert "ELASTIC_RESUMED rank=0 step=4" in out, out
    assert "ELASTIC_RESUMED rank=1 step=4" in out, out
    # The survivor diagnosed the dead peer and left by itself, well
    # before the launcher's 60 s grace window would have ended it.
    assert "ELASTIC_EXIT rank=0 code=75" in out, out
    assert "EX_TEMPFAIL(75)" in out, out
    assert seconds < 60.0, seconds
    want = replay(17, 8)
    got = [[float(v) for v in m.group(1).split(",")]
           for m in re.finditer(r"ELASTIC_OK rank=\d w=\[([^\]]+)\]", out)]
    assert len(got) == 2, out
    for g in got:
        np.testing.assert_allclose(g, want, atol=1e-4)


def test_two_deaths_two_relaunches(launches):
    rc, out, _ = launches["elastic2"].result()
    assert rc == 0, out
    assert out.count("[elastic] job failed") == 2, out
    for r in range(2):
        assert f"ELASTIC2_RESUMED rank={r} step=2" in out, out
        assert f"ELASTIC2_RESUMED rank={r} step=6" in out, out
        assert f"ELASTIC2_OK rank={r}" in out, out


def test_elastic_train_example(launches):
    rc, out, _ = launches["example"].result()
    assert rc == 0, out
    assert "elastic_train: rank 1 dying at step 5" in out
    assert out.count("[elastic] job failed") == 1, out
    assert "resumed rank=0 from committed step 4" in out
    assert "resumed rank=1 from committed step 4" in out
    assert "elastic_train: OK rank=0" in out
    assert "elastic_train: OK rank=1" in out


def test_without_elastic_every_line_carries_its_rank(launches):
    rc, out, _ = launches["plain"].result()
    assert rc == 0, out
    assert "[0] elastic_train: OK rank=0 size=2" in out, out
    assert "[1] elastic_train: OK rank=1 size=2" in out, out
    assert "[elastic]" not in out
    for line in out.splitlines():
        assert re.match(r"\[[01]\] ", line), line


def test_grace_ends_a_worker_that_hangs(launches):
    rc, out, seconds = launches["hang"].result()
    assert rc == 3, out
    assert "[0] HANG rank=0 sleeping" in out, out
    # Rank 0 would sleep for ten minutes: the 2 s grace ended it.
    assert seconds < 60.0, seconds


def test_launcher_splits_the_worker_command():
    from horovod_tpu_torch.run import _command_start

    assert _command_start(["-np", "2", "--elastic", "-m", "x", "-m"]) == 3
    assert _command_start(["-np", "2", "s.py", "-m", "y"]) == 2
    assert _command_start(["--grace=3", "-np", "1", "s.py", "--grace"]) == 3


def test_launcher_holds_the_rendezvous_port_while_the_ranks_run(
        monkeypatch):
    """The launcher holds the job's rendezvous port bound from its choice
    until every worker is done (a child process serves the store on it),
    and the workers join the store as clients: when each worker starts,
    and again when the last one ends, no other process can bind
    ``MASTER_PORT`` (a port picked and released, then bound by rank 0
    seconds later, can be taken meanwhile by another process of the
    machine)."""
    import io
    import socket

    from horovod_tpu_torch import run

    def taken(port):
        probe = socket.socket()
        try:
            probe.bind(("127.0.0.1", port))
            return False
        except OSError:
            return True
        finally:
            probe.close()

    seen = []

    class Worker:
        returncode = None

        def __init__(self, port):
            self.port = port
            self.stdout = io.BytesIO(b"")

        def poll(self):
            if self.returncode is None:
                seen.append(("ends", self.port, taken(self.port)))
                self.returncode = 0
            return self.returncode

        def wait(self, timeout=None):
            return self.poll()

    real_popen = run.subprocess.Popen

    def popen(cmd, env=None, **kw):
        if env is None:  # the store's own process
            return real_popen(cmd, **kw)
        port = int(env["MASTER_PORT"])
        seen.append(("starts", port, taken(port),
                     {k: env.get(k) for k in run.AGENT_STORE_ENV}))
        return Worker(port)

    monkeypatch.setattr(run.subprocess, "Popen", popen)
    assert run.main(["-np", "3", "script.py"]) == 0
    starts = [s for s in seen if s[0] == "starts"]
    ends = [s for s in seen if s[0] == "ends"]
    assert len(starts) == 3 and len(ends) == 3
    assert len({s[1] for s in seen}) == 1
    assert all(s[2] for s in seen), seen
    assert all(s[3] == run.AGENT_STORE_ENV for s in starts)
