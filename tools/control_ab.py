#!/usr/bin/env python3
"""Host timings of the negotiated collectives' control channel, for two or
more checkouts of the repo, in turns.

    python3 tools/control_ab.py --trees A,B [--rounds 5] [--tree 3:1,5:2]
        [--hits 18]

Each tree runs two jobs a round, and one more a ``--tree`` shape, under
its own launcher (``python -m horovod_tpu_torch.run -np N``), every rank
on the CPU (``--device cpu``, one thread a rank), the trees in the order
A, B, B, A each round:

- np 2, with ``HVD_TPU_FAULTS=transport.reset`` on rank 1 after 30
  frames and ``HVD_TPU_RECONNECT_GRACE=1.5``: ``reset_to_resumed``, the
  seconds from the reset (in the warm-up) to its ``session resumed``,
  from rank 1's flight records (a tree whose channel resumes sessions;
  an older one fires nothing); ``latency_np2``, the median of 200
  negotiated 4-byte allreduces (``hvd.allreduce`` of one f32) after 50
  warm-up ones, on rank 0's host clock; then ``kill_to_diagnosis``: rank
  1 dies hard (``os._exit``) and rank 0 allreduces until its
  ``HorovodError`` names the dead peer, wall clock, both ranks on one
  host;
- np 3: ``latency_np3``, the same median;
- with ``--tree NP:FANOUT,...``, one more job for each: ``latency_tree<NP>f
  <FANOUT>``, the same median at NP ranks under ``HVD_TPU_TREE=on`` and
  that fanout.

``--hits H`` makes each timed op a grouped allreduce of H one-element
tensors (``hvd.grouped_allreduce``), so each rank's steady batch carries H
cache hits (GPT-2-small's hook step sends 18); the default, 1, is the one
``hvd.allreduce``.  Every latency job also reports ``rx_bytes_*``: the
control bytes rank 0 received (``transport.bytes_received``, frame
headers included) over its 200 timed ops, divided by 200; the ranks
cycle while they wait, so a cycle with nothing in it counts too.

Every rank zeroes the port's kernel launch counters after ``init`` and
prints them before it exits; each job's line carries their sum
(``launches``), and the last line each tree's sum over its jobs.

Prints one JSON line a job, then one with each tree's medians over its
jobs.  Needs no GPU; run it on the machine whose host is measured.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KILL_GRACE = "1.5"
RESET_SPEC = "transport.reset:count=1:after=30:rank=1@5"


def _launch_counters():
    from horovod_tpu_torch.ops import flash_attention, quant, serving

    return flash_attention, quant, serving


def _report_launches(rank: int) -> None:
    counts = {}
    for mod in _launch_counters():
        counts.update(mod.launches)
    sys.stdout.write(f"CONTROL_AB_LAUNCHES rank={rank} "
                     f"{json.dumps(counts, sort_keys=True)}\n")
    sys.stdout.flush()


def rank_worker(mode: str) -> int:
    """One rank of a job (``RANK`` and the rest set by the launcher);
    prints ``CONTROL_AB {json}`` lines.  ``mode``: ``np2`` or
    ``latency``."""
    import torch

    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import telemetry
    from horovod_tpu_torch.telemetry import flight

    def received():
        return telemetry.metrics().get("transport.bytes_received",
                                       {}).get("value", 0)

    hvd.init(device="cpu")
    rank = hvd.rank()
    for mod in _launch_counters():
        mod.reset_launches()
    one = torch.ones(1)
    hits = int(os.environ.get("CONTROL_AB_HITS", "1"))
    ones = [torch.ones(1) for _ in range(hits)]

    def timed_op(name):
        if hits == 1:
            hvd.allreduce(one, name=name)
        else:
            hvd.grouped_allreduce(ones, name=name)

    for _ in range(50):
        timed_op("warm")
    times = []
    rx0 = received()
    for _ in range(200):
        t0 = time.perf_counter()
        timed_op("lat")
        times.append(time.perf_counter() - t0)
    if rank == 0:
        print("CONTROL_AB " + json.dumps(
            {"latency_ms": statistics.median(times) * 1e3,
             "rx_bytes": (received() - rx0) / 200}), flush=True)
    if mode == "latency":
        _report_launches(rank)
        hvd.shutdown()
        return 0
    if rank == 1:
        ev = flight.snapshot()
        reset = [t for t, kind, args in ev
                 if kind == "chaos" and args[0] == "transport.reset"]
        resumed = [t for t, kind, _ in ev if kind == "reconnected"]
        if reset and resumed:
            print("CONTROL_AB " + json.dumps(
                {"reset_to_resumed_s": resumed[0] - reset[0]}), flush=True)
        _report_launches(rank)
        print("CONTROL_AB " + json.dumps({"died": time.time()}), flush=True)
        os._exit(1)  # a hard death: no exit handshake
    try:
        while True:
            hvd.allreduce(one, name="after")
    except hvd.HorovodError as e:
        print("CONTROL_AB " + json.dumps(
            {"diagnosed": time.time(), "error": str(e)[:300]}), flush=True)
    _report_launches(rank)
    os._exit(0)


def _job(tree: str, np_: int, mode: str, env=None, hits: int = 1) -> dict:
    full = dict(os.environ)
    full.pop("HVD_TPU_FAULTS", None)
    full.update(env or {})
    full["CONTROL_AB_HITS"] = str(hits)
    full["PYTHONPATH"] = os.path.abspath(tree) + os.pathsep \
        + full.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_),
         "--grace", "30", os.path.abspath(__file__), "--rank-worker",
         mode], cwd=os.path.abspath(tree), env=full, capture_output=True,
        text=True, timeout=300)
    out = {}
    for m in re.finditer(r"CONTROL_AB (\{.*\})", proc.stdout):
        out.update(json.loads(m.group(1)))
    ranks = {int(m.group(1)): json.loads(m.group(2)) for m in re.finditer(
        r"CONTROL_AB_LAUNCHES rank=(\d+) (\{[^{}]*\})", proc.stdout)}
    if mode != "np2" and proc.returncode != 0 or not out \
            or sorted(ranks) != list(range(np_)):
        raise RuntimeError(f"{tree} {mode} np{np_}: rc {proc.returncode}, "
                           f"launches from ranks {sorted(ranks)}\n"
                           f"{proc.stdout[-3000:]}{proc.stderr[-2000:]}")
    out["launches"] = _sum_launches(ranks.values())
    return out


def _sum_launches(counts) -> dict:
    total = {}
    for c in counts:
        for k, n in c.items():
            total[k] = total.get(k, 0) + n
    return total


def measure(tree: str, shapes=(), hits: int = 1) -> dict:
    two = _job(tree, 2, "np2", {"HVD_TPU_FAULTS": RESET_SPEC,
                                "HVD_TPU_RECONNECT_GRACE": KILL_GRACE}, hits)
    if "diagnosed" not in two:
        raise RuntimeError(f"{tree}: rank 0 never diagnosed the death: "
                           f"{two}")
    three = _job(tree, 3, "latency", hits=hits)
    r = {"tree": tree, "latency_np2_ms": two["latency_ms"],
         "latency_np3_ms": three["latency_ms"],
         "rx_bytes_np2": two["rx_bytes"], "rx_bytes_np3": three["rx_bytes"],
         "kill_to_diagnosis_s": two["diagnosed"] - two["died"],
         "kill_error": two["error"]}
    jobs = [two, three]
    for np_, fanout in shapes:
        job = _job(tree, np_, "latency", {"HVD_TPU_TREE": "on",
                                          "HVD_TPU_TREE_FANOUT": str(fanout)},
                   hits)
        r[f"latency_tree{np_}f{fanout}_ms"] = job["latency_ms"]
        r[f"rx_bytes_tree{np_}f{fanout}"] = job["rx_bytes"]
        jobs.append(job)
    r["launches"] = _sum_launches([job["launches"] for job in jobs])
    if "reset_to_resumed_s" in two:
        r["reset_to_resumed_s"] = two["reset_to_resumed_s"]
    return r


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", default=".",
                    help="comma-separated checkouts to compare")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--tree", default="",
                    help="comma-separated NP:FANOUT tree jobs to add")
    ap.add_argument("--hits", type=int, default=1,
                    help="one-element tensors a timed op (default 1)")
    ap.add_argument("--rank-worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_worker is not None:
        return rank_worker(args.rank_worker)
    trees = args.trees.split(",")
    shapes = [tuple(int(v) for v in shape.split(":"))
              for shape in args.tree.split(",") if shape]
    order = list(range(len(trees))) + list(reversed(range(len(trees))))
    if len(trees) == 1:
        order = [0]
    runs = {t: [] for t in trees}
    for _ in range(args.rounds):
        for i in order:
            r = measure(trees[i], shapes, args.hits)
            print(json.dumps(r), flush=True)
            runs[trees[i]].append(r)
    keys = ("latency_np2_ms", "latency_np3_ms", "kill_to_diagnosis_s",
            "reset_to_resumed_s", "rx_bytes_np2", "rx_bytes_np3") + tuple(
                key for np_, fanout in shapes
                for key in (f"latency_tree{np_}f{fanout}_ms",
                            f"rx_bytes_tree{np_}f{fanout}"))
    print(json.dumps({"medians": {
        t: {k: statistics.median([r[k] for r in rs]) if rs and k in rs[0]
            else None for k in keys}
        | {f"{k}_by_job": [r.get(k) for r in rs] for k in keys}
        for t, rs in runs.items()},
        "launches": {t: _sum_launches(r["launches"] for r in rs)
                     for t, rs in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
