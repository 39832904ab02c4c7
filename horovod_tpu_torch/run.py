"""Process launcher: ``python -m horovod_tpu_torch.run -np N script.py
[args...]`` (port of horovod_tpu/run.py).

Spawns N local worker processes, each with the environment
``core/state.py`` reads at ``init()``: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.
The launcher binds that port and holds it from its choice to the job's
end, a child process serves the job's rendezvous store on it, and the
workers join the store as clients, as
``torchrun``'s workers join their agent's
(``TORCHELASTIC_USE_AGENT_STORE``): a port picked, released and bound
later by rank 0 could be taken meanwhile by another process of the
machine.  Rank 0's TCP control channel listens on a port it
binds itself and sends to the others over that group at ``init``: the
reference's launcher exports a free one as ``HVD_TPU_CONTROLLER_PORT``
(its ``run.py:71``), which another process can take before rank 0 binds
it.  Each worker's output is prefixed with its rank, mpirun
style (``[1] ...``).  ``-m module`` runs a module instead of a script.
The worker chooses its device (``init()`` defaults to the card; the
port's examples take ``--device cpu``): the launcher never moves a
worker off the card.  The reference's ``--platform`` has no
counterpart.

For a job over several hosts, run one process per rank under a
scheduler (or ``torchrun``) with the same variables.

``--elastic`` adds fault tolerance: the launcher supervises the workers
and, when the job fails (a worker crashed, or a survivor exited
``EX_TEMPFAIL`` (75) after diagnosing a dead peer), tears it down and
relaunches it, up to ``--max-restarts`` times.  ``HVD_TPU_ELASTIC_DIR``
(exported to the workers) carries the committed
``horovod_tpu_torch.elastic.State`` across incarnations, so training
resumes from the last ``state.commit()``.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time


# The workers join the TCPStore their launcher serves as clients, as
# torchrun's workers join their agent's (torch.distributed.rendezvous):
# every rank, rank 0 included, connects to MASTER_PORT and none binds it.
AGENT_STORE_ENV = {"TORCHELASTIC_USE_AGENT_STORE": "True",
                   "TORCHELASTIC_RESTART_COUNT": "0"}


# The job's TCPStore is served by a child process of its own, on the
# launcher's listening socket: on a machine whose resolver cannot name the
# loopback address the store's first connection logs one c10d warning,
# which the launcher drops from its output, where it would be the one line
# without a rank.
_STORE_SERVER = """\
import signal, sys
from torch.distributed import TCPStore
signal.signal(signal.SIGINT, signal.SIG_IGN)  # the launcher ends it
store = TCPStore("127.0.0.1", int(sys.argv[2]), is_master=True,
                 wait_for_workers=False, master_listen_fd=int(sys.argv[1]))
sys.stdin.read()  # until the launcher closes it, or dies
"""
_STORE_NOISE = b"The hostname of the client socket cannot be retrieved"


class StoreServer:
    """The TCPStore of one job on ``port``.  The launcher binds the port
    and listens at once, and holds the socket until :meth:`close`, so no
    other process of the machine can take the port before the ranks
    connect (a rank whose store lands on another process's listener
    retries its rendezvous for 30 minutes).  A child process serves the
    store on that socket; the ranks, started meanwhile, wait in its
    backlog until it does."""

    def __init__(self):
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(socket.SOMAXCONN)
        self.port = self._sock.getsockname()[1]
        fd = self._sock.fileno()
        self._proc = subprocess.Popen(
            [sys.executable, "-c", _STORE_SERVER, str(fd), str(self.port)],
            stdin=subprocess.PIPE, stderr=subprocess.PIPE, pass_fds=(fd,))
        self._forward = threading.Thread(target=self._errors, daemon=True)
        self._forward.start()

    def _errors(self) -> None:
        for line in iter(self._proc.stderr.readline, b""):
            if _STORE_NOISE not in line:
                sys.stderr.buffer.write(line)
                sys.stderr.flush()

    def close(self) -> None:
        self._proc.kill()
        self._proc.wait()
        self._proc.stdin.close()
        self._forward.join(timeout=2.0)
        self._sock.close()


def _pump(stream, rank: int, out) -> None:
    for line in iter(stream.readline, b""):
        out.buffer.write(f"[{rank}] ".encode() + line)
        out.flush()


def _launch_once(args, extra_env=None) -> int:
    """One incarnation of the job: spawn N workers, forward their output,
    wait.

    Returns the first nonzero exit code (0 when every worker succeeds).
    A failed worker's peers diagnose the death themselves (rank 0 once
    the dead rank's reconnect grace, ``HVD_TPU_RECONNECT_GRACE``, runs
    out; the others from rank 0's diagnosis) and exit; ``--grace`` bounds
    how long the launcher waits for that before it terminates the
    stragglers."""
    store = StoreServer()
    try:
        return _run_workers(args, store.port, extra_env)
    finally:
        store.close()


def _run_workers(args, port: int, extra_env=None) -> int:
    procs = []
    pumps = []
    for rank in range(args.num_proc):
        env = dict(os.environ)
        env.update(extra_env or {})
        env.update(RANK=str(rank), WORLD_SIZE=str(args.num_proc),
                   LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(args.num_proc),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   **AGENT_STORE_ENV)
        # -u: a worker that dies abruptly must not lose block-buffered
        # output (mpirun's forwarding has the same property).
        p = subprocess.Popen([sys.executable, "-u"] + args.command, env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        procs.append(p)
        t = threading.Thread(target=_pump, args=(p.stdout, rank, sys.stdout),
                             daemon=True)
        t.start()
        pumps.append(t)

    rc = 0
    try:
        deadline = None
        # Poll EVERY worker each tick: any(...) would stop at the first
        # live process and never set the returncode of the ranks behind
        # it, so a crash behind a blocked rank 0 would go unseen and the
        # grace window would never arm.
        while None in [p.poll() for p in procs]:
            if rc == 0:
                rc = next((p.returncode for p in procs
                           if p.returncode not in (None, 0)), 0)
                if rc and args.grace > 0:
                    deadline = time.monotonic() + args.grace
            if deadline is not None and time.monotonic() > deadline:
                for p in procs:
                    if p.poll() is None:
                        p.terminate()
                for p in procs:
                    try:
                        p.wait(timeout=10.0)
                    except subprocess.TimeoutExpired:
                        p.kill()
                        p.wait()
                break
            time.sleep(0.2)
        for p in procs:
            if p.returncode is None:
                p.wait()
            rc = rc or (p.returncode or 0)
    except KeyboardInterrupt:
        for p in procs:
            p.send_signal(signal.SIGTERM)
        rc = 130
    for t in pumps:
        t.join(timeout=2.0)
    return rc


_VALUED = ("-np", "--num-proc", "--max-restarts", "--elastic-dir",
           "--grace")


def _command_start(argv: list) -> int:
    """Index of the worker command in ``argv``: the first token that is
    not one of the launcher's options or an option's value."""
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in _VALUED:
            i += 2
        elif tok.startswith("-") and tok != "-m":
            i += 1
        else:
            return i
    return i


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.run",
        description="Launch N cooperating horovod_tpu_torch processes "
                    "locally.")
    ap.add_argument("-np", "--num-proc", type=int, required=True)
    ap.add_argument("--elastic", action="store_true",
                    help="relaunch the job on worker failure, resuming "
                         "from the last horovod_tpu_torch.elastic.State "
                         "commit")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="elastic mode: maximum relaunches before giving "
                         "up (default 3)")
    ap.add_argument("--elastic-dir", default=None,
                    help="directory carrying committed elastic state "
                         "across incarnations (default: a fresh temporary "
                         "directory)")
    ap.add_argument("--grace", type=float, default=60.0,
                    help="seconds to let surviving workers diagnose a "
                         "peer failure and exit before the launcher "
                         "terminates them (0 disables)")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="script (and its arguments), or -m module ..., "
                         "to run in each process")
    argv = list(sys.argv[1:] if argv is None else argv)
    # argparse's REMAINDER cannot start with an option, so "-m module
    # ..." after the launcher's own options is split off by hand.
    start = _command_start(argv)
    args = ap.parse_args(argv[:start])
    args.command = argv[start:] or args.command
    if not args.command:
        ap.error("missing script to launch")

    if not args.elastic:
        return _launch_once(args)

    elastic_dir = args.elastic_dir or tempfile.mkdtemp(
        prefix="hvd_torch_elastic_")
    extra = {"HVD_TPU_ELASTIC": "1", "HVD_TPU_ELASTIC_DIR": elastic_dir}
    rc = 0
    for attempt in range(args.max_restarts + 1):
        rc = _launch_once(args, extra)
        if rc == 0:
            return 0
        if rc == 130:  # Ctrl-C is the user stopping the job, not a failure
            return rc
        if attempt == args.max_restarts:
            print(f"[elastic] giving up after {attempt} restart(s): "
                  f"rc={rc}", file=sys.stderr)
            return rc
        print(f"[elastic] job failed (rc={rc}); relaunching from the "
              f"last commit in {elastic_dir} "
              f"(restart {attempt + 1}/{args.max_restarts})",
              file=sys.stderr, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
