"""Process launcher: ``python -m horovod_tpu_torch.run -np N script.py
[args...]`` (port of horovod_tpu/run.py).

Spawns N local worker processes, each with the environment
``core/state.py`` reads at ``init()``: ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and a free
``MASTER_PORT``.  Each worker's output is prefixed with its rank,
mpirun style (``[1] ...``).  ``-m module`` runs a module instead of a
script.  The worker chooses its device (``init()`` defaults to the card;
the port's examples take ``--device cpu``): the launcher never moves a
worker off the card.  The reference's ``--platform`` and
``HVD_TPU_CONTROLLER_PORT`` have no counterpart: the control channel is a
gloo group on the same store.

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


def _free_ports(n: int) -> list:
    # Hold every socket open while allocating, so the kernel cannot hand
    # the same ephemeral port out twice.
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _pump(stream, rank: int, out) -> None:
    for line in iter(stream.readline, b""):
        out.buffer.write(f"[{rank}] ".encode() + line)
        out.flush()


def _launch_once(args, extra_env=None) -> int:
    """One incarnation of the job: spawn N workers, forward their output,
    wait.

    Returns the first nonzero exit code (0 when every worker succeeds).
    A failed worker's peers diagnose the death themselves (their gloo
    control exchange fails) and exit; ``--grace`` bounds how long the
    launcher waits for that before it terminates the stragglers."""
    (port,) = _free_ports(1)
    procs = []
    pumps = []
    for rank in range(args.num_proc):
        env = dict(os.environ)
        env.update(extra_env or {})
        env.update(RANK=str(rank), WORLD_SIZE=str(args.num_proc),
                   LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(args.num_proc),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
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
