#!/usr/bin/env python3
"""Where the host time of one negotiated allreduce goes: ``cProfile``
over synchronous 4-byte in-place Sum allreduces through
``horovod_tpu_torch.frontends.torch``, one rank.

    python3 tools/negotiation_profile.py --device cpu
    python3 tools/negotiation_profile.py --device cuda --iters 1000

Prints one JSON line: the wall ms a call, profiled and not, the same
collective as a direct ``torch.distributed.all_reduce`` call, and the
top functions by cumulative time (ms a call), then by own time.  With
one rank a waiting caller runs the cycle inline, so the calling thread,
which ``cProfile`` sees, does the negotiation and the execution; the
background thread only wakes after the response has run.
``HVD_TPU_RESPONSE_CACHE=0`` in the environment turns the response
cache off, where the tree has one.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _where(func) -> str:
    path, line, name = func
    if path == "~":
        return name
    path = os.path.relpath(path, HERE) if path.startswith(HERE) else \
        os.path.basename(path)
    return f"{path}:{line}({name})"


def profile(device: str, iters: int, top: int) -> dict:
    sys.path.insert(0, HERE)
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.frontends.torch as fhvd

    fhvd.init(device=device)
    try:
        dev = hvd.device()
        x = torch.ones(1, device=dev)

        def one():
            fhvd.allreduce_(x, op=fhvd.Sum, name="profile.4B")
            _sync(dev)

        for _ in range(20):
            one()
        t0 = time.perf_counter()
        for _ in range(iters):
            one()
        plain_ms = (time.perf_counter() - t0) / iters * 1e3
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        for _ in range(iters):
            one()
        prof.disable()
        profiled_ms = (time.perf_counter() - t0) / iters * 1e3
        dist.all_reduce(x)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            dist.all_reduce(x)
            _sync(dev)
        direct_ms = (time.perf_counter() - t0) / iters * 1e3
    finally:
        fhvd.shutdown()
    st = pstats.Stats(prof)
    rows = [(func, cc, nc, tt, ct)
            for func, (cc, nc, tt, ct, _) in st.stats.items()]

    def table(key):
        return [{"function": _where(f), "calls_per_op": nc / iters,
                 "cum_ms_per_op": ct / iters * 1e3,
                 "own_ms_per_op": tt / iters * 1e3}
                for f, cc, nc, tt, ct in sorted(rows, key=key)[:top]]

    return {"device": str(dev), "iters": iters,
            "response_cache": os.environ.get("HVD_TPU_RESPONSE_CACHE", "1"),
            "ms_per_op": plain_ms, "profiled_ms_per_op": profiled_ms,
            "direct_ms_per_op": direct_ms,
            "by_cumulative": table(lambda r: -r[4]),
            "by_own_time": table(lambda r: -r[3])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    print(json.dumps(profile(args.device, args.iters, args.top)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
