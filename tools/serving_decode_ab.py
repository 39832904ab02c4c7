#!/usr/bin/env python3
"""Times GPT-2-small's decode iteration and 1024-token prefill through the
port's serving engine, for two or more checkouts of the repo, in turns.

    python3 tools/serving_decode_ab.py --trees A,B [--rounds 3]

Each tree runs in a process of its own (one ``horovod_tpu_torch`` a
process), in the order A, B, B, A each round, on one CUDA device.  A
process builds GPT-2-small (``examples/transformer_lm.bench_config``:
vocab 32768, d_model 768, 12 heads, 12 layers, d_ff 3072, bf16) with
seeded random weights and an engine of 8 slots over a 1024-token
capacity, warms it, then runs

- decode: 8 requests of 20-27-token prompts, 96 new tokens each; every
  decode iteration over all 8 slots is timed on the host clock (the
  iteration brings its logits to the host, so the time holds the
  device's);
- prefill: 6 prompts of 1000 tokens (the 1024 bucket), one at a time,
  each prefill timed the same way.

Prints one JSON line a process, then one with each tree's medians over
its processes' p50s.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _p50(xs):
    return statistics.median(xs) if xs else None


def worker(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from horovod_tpu_torch.examples import transformer_lm
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.serving import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = transformer_lm.bench_config()
    params = tt.init_transformer(torch.Generator().manual_seed(0), cfg,
                                 device="cuda")
    eng = InferenceEngine(params, cfg, device="cuda", max_slots=8,
                          page_size=16, capacity=1024)
    eng.warm_start()
    times = {"decode": [], "prefill": []}
    dec, pf = eng._decode_iteration, eng._prefill

    def decode(active):
        t0 = time.perf_counter()
        out = dec(active)
        if len(active) == 8:
            times["decode"].append((time.perf_counter() - t0) * 1e3)
        return out

    def prefill(slot, req):
        t0 = time.perf_counter()
        out = pf(slot, req)
        if len(req.prompt) == 1000:
            times["prefill"].append((time.perf_counter() - t0) * 1e3)
        return out

    eng._decode_iteration, eng._prefill = decode, prefill
    g = torch.Generator().manual_seed(1)
    eng.generate(torch.randint(0, cfg.vocab_size, (1000,),
                               generator=g).tolist(), max_new_tokens=2)
    times["prefill"].clear()  # the 1024 bucket's first run, off the clock
    for i in range(8):
        eng.submit(torch.randint(0, cfg.vocab_size, (20 + i,),
                                 generator=g).tolist(), max_new_tokens=96)
    eng.run_until_idle()
    decode_ms = times["decode"][4:]  # past the first iterations
    for _ in range(6):
        eng.generate(torch.randint(0, cfg.vocab_size, (1000,),
                                   generator=g).tolist(), max_new_tokens=1)
    return {"tree": tree, "decode_iteration_ms_p50": _p50(decode_ms),
            "decode_iteration_ms": decode_ms,
            "prefill_1024_ms_p50": _p50(times["prefill"]),
            "prefill_1024_ms": times["prefill"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", help="comma-separated checkouts to compare")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    trees = args.trees.split(",")
    order = list(range(len(trees))) + list(reversed(range(len(trees))))
    p50s = {t: {"decode": [], "prefill": []} for t in trees}
    for _ in range(args.rounds):
        for i in order:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 trees[i]], capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr)
                return proc.returncode
            r = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps(r), flush=True)
            p50s[trees[i]]["decode"].append(r["decode_iteration_ms_p50"])
            p50s[trees[i]]["prefill"].append(r["prefill_1024_ms_p50"])
    print(json.dumps({"medians": {
        t: {"decode_iteration_ms": _p50(v["decode"]),
            "prefill_1024_ms": _p50(v["prefill"]),
            "decode_iteration_ms_by_process": v["decode"],
            "prefill_1024_ms_by_process": v["prefill"]}
        for t, v in p50s.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
