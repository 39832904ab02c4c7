#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (horovod_tpu_torch) on one GPU.

    python3 chip_smoke.py                    # every phase, one card
    python3 chip_smoke.py --phases kernels   # a subset, for debugging
    python3 chip_smoke.py --out-dir DIR      # profile files (default
                                             # build/chip_smoke/)

Phases, in order; any failure exits non-zero and prints no result line:

1. device  - the card's name and power limit (nvidia-smi), torch and CUDA
             versions.
2. build   - nvcc builds the flash-attention kernels from
             horovod_tpu_torch/ops/csrc.
3. kernels - each kernel against its plain PyTorch version on the same
             inputs on the card, at the training shape (b8 h12 s1024 d64,
             causal, bf16) and at edge cases (ragged ends across a
             128-row tile, offsets that are not tile-aligned, masked rows,
             both kernel forms: the Hopper redesign of all three kernels
             for bf16 at head_dim 64 and 128, the first form for the
             rest); times of the
             kernel, the plain version and torch's
             scaled_dot_product_attention pinned to its FLASH_ATTENTION
             backend (a yardstick the port never calls), the card's bound,
             and the host time of one TMA tensor-map encode.
4. long    - the same comparison at b1 h12 s8192 d64 (the sequence regime
             of the TPU's streaming kernels).
5. trainer - the port's main path: init -> broadcast_parameters ->
             DistributedOptimizer(AdamW) -> make_train_step on GPT-2-small
             (bf16, batch 8, seq 1024), 2 warm-up and 5 timed steps; the
             loss must fall, every kernel must launch n_layers times a
             step, and the profiled step must show each redesigned
             kernel (forward, dK/dV, dQ) n_layers times and none of the
             first form's.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device, or without the
horovod_tpu_torch package beside this file, it exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("device", "build", "kernels", "long", "trainer")

# Published dense peaks of one H100 SXM at 700 W (NVIDIA data sheet).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# Tolerances of kernel against plain version, element by element.
# f32: |kernel - plain| <= 5e-5 forward, 1e-4 backward, the reference's
# own (tests/test_flash_attention.py).  lse is f32 arithmetic in every
# dtype (bf16 products are exact in f32), so it takes the f32 forward
# tolerance too.  bf16 outputs (o, dq, dk, dv):
#     |kernel - plain| <= RTOL_BF16 * |plain| + ATOL_BF16 * rms(row of plain)
#                         + ATOL_FLOOR_BF16 * rms(all of plain)
# where a row is one query's (o, dq) or one key's (dk, dv) head_dim
# values.  The plain version runs in f32 from the same bf16 inputs and
# rounds its outputs to bf16; the kernel rounds p to bf16 before p.v and
# p^T.dO, ds before ds.k and ds^T.q, and its outputs to bf16, as the TPU
# kernels do.  Two roundings of one value to bf16 differ by at most one
# ulp, <= 2^-7 relative: RTOL_BF16.  Each p or ds rounding is a relative
# 2^-9 error on one term of a row's sum, so the sum is off by about
# 2^-9 times the row's own size, and the largest of millions of such
# errors by a few times that: ATOL_BF16 = 2^-5 of the row's RMS leaves a
# margin of a few.  Tolerances relative to each row, not to the largest
# element, so that the small late rows of a causal output (o_i ~ 1/sqrt(i))
# are held as tightly as the large early ones.  A row that is exactly
# zero in the plain version (dq of a query that sees one key) is not
# exactly zero after delta = rowsum(dO * O) is rounded, so the allowance
# has a floor of 2^-9 of the RMS of the whole output.
TOL_F32_FWD, TOL_F32_BWD = 5e-5, 1e-4
RTOL_BF16, ATOL_BF16, ATOL_FLOOR_BF16 = 2.0 ** -7, 2.0 ** -5, 2.0 ** -9

# The library yardstick's backend (torch.nn.attention.SDPBackend member).
SDP_BACKEND_NAME = "FLASH_ATTENTION"


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(q_len, kv_len, causal, q_offset) -> int:
    """(query, key) pairs the mask lets through: the work these inputs
    need, not the most they could."""
    if not causal:
        return q_len * kv_len
    rows = np.clip(np.arange(q_len) + q_offset + 1, 0, kv_len)
    return int(rows.sum())


def bound(flops: float, nbytes: float, dtype):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bf16_allowed(want):
    """Per-element tolerance of a bf16 output (see RTOL_BF16 above)."""
    rms_row = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    rms_all = want.pow(2).mean().sqrt()
    return (ATOL_BF16 * rms_row + ATOL_FLOOR_BF16 * rms_all
            + RTOL_BF16 * want.abs())


def check(name, got, want, allowed):
    """Holds got against want element by element: entries where want is
    not finite (the -inf lse of masked rows) must match it exactly, every
    other one must be within allowed(want).  Returns (max abs err, worst
    err / allowed), the second the margin left (must be <= 1)."""
    got, want = got.float(), want.float()
    fin = torch.isfinite(want)
    if not bool(torch.equal(torch.isfinite(got), fin)) or not bool(
            torch.equal(got[~fin], want[~fin])):
        raise AssertionError(f"{name}: non-finite entries differ")
    err = torch.where(fin, (got - want).abs(), 0.0)
    tol = allowed(want)
    ratio = err / tol.clamp_min(torch.finfo(torch.float32).tiny)
    worst = float(ratio.max()) if ratio.numel() else 0.0
    if not worst <= 1.0:
        i = int(ratio.argmax())
        scale = float(want[fin].abs().max())
        raise AssertionError(
            f"{name}: element {i}: kernel {float(got.flatten()[i])} plain "
            f"{float(want.flatten()[i])} allowed {float(tol.flatten()[i])}; "
            f"max abs err {float(err.max())}, max |plain| {scale}")
    return (float(err.max()) if err.numel() else 0.0), worst


def kernel_case(fa, *, b, h, q_len, kv_len, d, causal, q_offset, dtype,
                seed, timing=False):
    """One kernel-against-plain comparison on the card.  Returns
    {kernel: {max_abs_err, worst_ratio, ...timings}}; worst_ratio is the
    largest error over its allowance, so at most 1."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(s):
        return torch.randn(b * h, s, d, generator=gen, device=dev,
                           dtype=torch.float32).to(dtype)

    q, k, v, g = rnd(q_len), rnd(kv_len), rnd(kv_len), rnd(q_len)
    scale = d ** -0.5
    args = dict(sm_scale=scale, causal=causal, q_block_offset=q_offset)
    o, lse = fa.flash_fwd(q, k, v, scale, causal, q_offset)
    o_ref, lse_ref = fa._dense_forward(q, k, v, scale, causal, q_offset)
    torch.cuda.synchronize()

    def const(tol):
        return lambda want: torch.full_like(want, tol)

    def tol_out(tol_f32):
        return const(tol_f32) if dtype == torch.float32 else bf16_allowed

    errs = {"o": check("o", o, o_ref, tol_out(TOL_F32_FWD)),
            "lse": check("lse", lse, lse_ref, const(TOL_F32_FWD))}

    # Backward: each kernel against the plain backward on the same inputs,
    # the kernel forward's lse and delta = rowsum(dO * O) of its o.
    delta = torch.sum(g.float() * o.float(), dim=-1)
    bwd = (q, k, v, g, lse, delta, scale, causal, q_offset)
    dk, dv = fa.flash_bwd_dkdv(*bwd)
    dq = fa.flash_bwd_dq(*bwd)
    dq_ref, dk_ref, dv_ref = fa._dense_backward_from_delta(
        q, k, v, g, lse, delta, **args)
    torch.cuda.synchronize()
    for name, got, want in (("dq", dq, dq_ref), ("dk", dk, dk_ref),
                            ("dv", dv, dv_ref)):
        errs[name] = check(name, got, want, tol_out(TOL_F32_BWD))

    # The autograd Function on the card runs the same kernels on the same
    # inputs, so its gradients equal the direct calls bitwise.  In f32 they
    # are also held against autograd through the plain forward at the
    # reference's 1e-4 (rows that see no key are left to the check above:
    # the plain forward's masked exp has no gradient there).  Not in bf16:
    # autograd through the plain forward takes delta from the unrounded
    # f32 o, the kernels' contract (the TPU kernels' too) from the bf16 o,
    # and in rows where dp ~ delta that difference, not the kernels, sets
    # the error.
    q4, k4, v4 = (t.view(b, h, -1, d).detach().requires_grad_(True)
                  for t in (q, k, v))
    o4 = fa.flash_attention(q4, k4, v4, causal=causal, sm_scale=scale,
                            q_block_offset=q_offset)
    grads = torch.autograd.grad(o4, (q4, k4, v4), g.view(b, h, -1, d))
    for name, got, want in zip(("dq", "dk", "dv"), grads, (dq, dk, dv)):
        if not bool(torch.equal(got.reshape(want.shape), want)):
            raise AssertionError(f"autograd {name} differs from the kernel's")
    if dtype == torch.float32 and not bool(torch.isneginf(lse_ref).any()):
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
        o_plain, _ = fa._dense_forward(qr, kr, vr, scale, causal, q_offset)
        for name, got, want in zip(
                ("dq", "dk", "dv"), (dq, dk, dv),
                torch.autograd.grad(o_plain, (qr, kr, vr), g)):
            check(f"autograd {name}", got, want, const(TOL_F32_BWD))

    def result(*names):
        return {"max_abs_err": max(errs[n][0] for n in names),
                "worst_ratio": max(errs[n][1] for n in names)}

    out = {"flash_fwd": result("o", "lse"),
           "flash_bwd_dkdv": result("dk", "dv"),
           "flash_bwd_dq": result("dq")}
    if not timing:
        return out

    bh, el = b * h, torch.tensor([], dtype=dtype).element_size()
    pairs = visible_pairs(q_len, kv_len, causal, q_offset) * bh
    q_bytes, kv_bytes, row_bytes = bh * q_len * d * el, bh * kv_len * d * el, \
        bh * q_len * 4
    work = {  # (flops, bytes): products of the kernel, inputs read once,
        #       outputs written once
        "flash_fwd": (4 * d * pairs, 2 * q_bytes + 2 * kv_bytes + row_bytes),
        "flash_bwd_dkdv": (8 * d * pairs,
                           2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
        "flash_bwd_dq": (6 * d * pairs,
                         3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
    }
    kernel_fns = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, scale, causal, q_offset),
        "flash_bwd_dkdv": lambda: fa.flash_bwd_dkdv(*bwd),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(*bwd),
    }
    plain_fns = {
        "flash_fwd": lambda: fa._dense_forward(q, k, v, scale, causal,
                                               q_offset),
        "flash_bwd_dkdv": lambda: fa._dense_backward_from_delta(
            q, k, v, g, lse, delta, **args),
        "flash_bwd_dq": lambda: fa._dense_backward_from_delta(
            q, k, v, g, lse, delta, **args),
    }
    # Yardstick: torch's fused attention on the same inputs, forward, and
    # backward (one call computes dq, dk and dv together), pinned to one
    # backend so that the number means the same thing from run to run.
    from torch.nn.attention import SDPBackend, sdpa_kernel
    f = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4, g4 = (t.view(b, h, -1, d) for t in (q, k, v, g))
    lib = {"flash_fwd": None, "bwd": None}
    if q_len == kv_len and q_offset == 0:
        with sdpa_kernel(getattr(SDPBackend, SDP_BACKEND_NAME)):
            lib["flash_fwd"] = cuda_time_ms(
                lambda: f(q4, k4, v4, is_causal=causal))
            ql, kl, vl = (t.detach().requires_grad_(True)
                          for t in (q4, k4, v4))
            o_lib = f(ql, kl, vl, is_causal=causal)
        lib["bwd"] = cuda_time_ms(lambda: torch.autograd.grad(
            o_lib, (ql, kl, vl), g4, retain_graph=True))
    for name, (flops, nbytes) in work.items():
        launches_before = dict(fa.launches)
        out[name]["ms"] = cuda_time_ms(kernel_fns[name])
        fa.launches.update(launches_before)  # timing launches do not count
        out[name]["plain_ms"] = cuda_time_ms(plain_fns[name], iters=5)
        out[name]["bound_ms"], out[name]["bound_by"] = bound(flops, nbytes,
                                                             dtype)
        out[name]["library_ms"] = lib["flash_fwd" if name == "flash_fwd"
                                      else "bwd"]
    return out


def tensor_map_encode_us(fa, iters=1000) -> float:
    """Host microseconds to encode one TMA tensor map, as the redesigned
    kernels do three (forward) or four (dK/dV, dQ) times a launch."""
    from horovod_tpu_torch.ops import _build
    fn = _build.library("flash_fwd").hvd_flash_tensor_map_us
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_double
    buf = torch.empty(96 * 1024 * 64, dtype=torch.bfloat16, device="cuda")
    us = fn(buf.data_ptr(), iters)
    if not us > 0:
        raise AssertionError(f"tensor map encode failed ({us})")
    return us


def phase_kernels(fa):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    main = kernel_case(fa, b=8, h=12, q_len=1024, kv_len=1024, d=64,
                       causal=True, q_offset=0, dtype=torch.bfloat16, seed=0,
                       timing=True)
    log({"phase": "kernels", "case": "main b8 h12 s1024 d64 causal bf16",
         "library": f"scaled_dot_product_attention, SDPBackend."
                    f"{SDP_BACKEND_NAME}", "result": main})
    us = tensor_map_encode_us(fa)
    log({"phase": "kernels", "tensor_map_encode_us": us,
         "encodes_per_trainer_step": 12 * (3 + 4 + 4),
         "host_ms_per_trainer_step": us * 12 * (3 + 4 + 4) / 1e3})
    cases = [
        ("f32 causal", dict(b=2, h=4, q_len=512, kv_len=512, d=64,
                            causal=True, q_offset=0, dtype=torch.float32)),
        ("bf16 non-causal", dict(b=2, h=4, q_len=512, kv_len=512, d=64,
                                 causal=False, q_offset=0,
                                 dtype=torch.bfloat16)),
        ("bf16 ragged 1000", dict(b=2, h=4, q_len=1000, kv_len=1000, d=64,
                                  causal=True, q_offset=0,
                                  dtype=torch.bfloat16)),
        ("bf16 ragged 1000 d128", dict(b=2, h=4, q_len=1000, kv_len=1000,
                                       d=128, causal=True, q_offset=0,
                                       dtype=torch.bfloat16)),
        ("bf16 ragged 200", dict(b=2, h=4, q_len=200, kv_len=200, d=64,
                                 causal=True, q_offset=0,
                                 dtype=torch.bfloat16)),
        ("bf16 ragged 200 d128", dict(b=2, h=4, q_len=200, kv_len=200,
                                      d=128, causal=True, q_offset=0,
                                      dtype=torch.bfloat16)),
        ("bf16 non-causal q300 kv1000", dict(b=2, h=4, q_len=300,
                                             kv_len=1000, d=64, causal=False,
                                             q_offset=0,
                                             dtype=torch.bfloat16)),
        ("bf16 non-causal q300 kv1000 d128", dict(b=2, h=4, q_len=300,
                                                  kv_len=1000, d=128,
                                                  causal=False, q_offset=0,
                                                  dtype=torch.bfloat16)),
        ("f32 ragged 1000 non-causal", dict(b=1, h=2, q_len=1000,
                                            kv_len=1000, d=32, causal=False,
                                            q_offset=0,
                                            dtype=torch.float32)),
        ("bf16 q256 kv1024 offset 768", dict(b=2, h=4, q_len=256,
                                             kv_len=1024, d=64, causal=True,
                                             q_offset=768,
                                             dtype=torch.bfloat16)),
        ("bf16 q256 kv1024 offset 700", dict(b=2, h=4, q_len=256,
                                             kv_len=1024, d=64, causal=True,
                                             q_offset=700,
                                             dtype=torch.bfloat16)),
        ("bf16 q256 kv1024 offset 700 d128", dict(b=2, h=4, q_len=256,
                                                  kv_len=1024, d=128,
                                                  causal=True, q_offset=700,
                                                  dtype=torch.bfloat16)),
        ("bf16 fully masked (offset -1000)", dict(
            b=1, h=2, q_len=128, kv_len=256, d=64, causal=True,
            q_offset=-1000, dtype=torch.bfloat16)),
        ("bf16 partly masked (offset -100)", dict(
            b=1, h=2, q_len=200, kv_len=256, d=64, causal=True,
            q_offset=-100, dtype=torch.bfloat16)),
        ("bf16 d128", dict(b=1, h=4, q_len=384, kv_len=384, d=128,
                           causal=True, q_offset=0, dtype=torch.bfloat16)),
        ("f32 d128", dict(b=1, h=2, q_len=160, kv_len=160, d=128,
                          causal=True, q_offset=0, dtype=torch.float32)),
        ("bf16 d16", dict(b=1, h=2, q_len=100, kv_len=300, d=16,
                          causal=False, q_offset=0, dtype=torch.bfloat16)),
    ]
    for i, (label, kw) in enumerate(cases):
        res = kernel_case(fa, seed=i + 1, **kw)
        log({"phase": "kernels", "case": label, "result": res})
    # The fully masked case's outputs are exact zeros, lse -inf.
    gen = torch.Generator(device="cuda").manual_seed(99)
    q = torch.randn(2, 64, 64, generator=gen, device="cuda").bfloat16()
    o, lse = fa.flash_fwd(q, q, q, 0.125, True, -1000)
    if not (bool((o == 0).all()) and bool(torch.isneginf(lse).all())):
        raise AssertionError("fully masked rows must give o = 0, lse = -inf")
    return main


def phase_long(fa):
    res = kernel_case(fa, b=1, h=12, q_len=8192, kv_len=8192, d=64,
                      causal=True, q_offset=0, dtype=torch.bfloat16, seed=7,
                      timing=True)
    log({"phase": "long", "case": "b1 h12 s8192 d64 causal bf16",
         "result": res})
    torch.cuda.empty_cache()


def profile_step(run, out_dir):
    """One more step under torch.profiler, tracing the device only (host
    op tracing nearly doubles the step): device time by kernel (from the
    trace's kernel, memcpy and memset events), and the share of that
    step's own wall time, on the host clock from a synchronized start to
    a synchronized end, in which no kernel ran."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run["step"](run["params"], run["data"])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "trainer_trace.json")
    prof.export_chrome_trace(trace_path)
    with open(os.path.join(out_dir, "trainer_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=40))
    with open(trace_path) as f:
        kernels = [e for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") in (
                       "kernel", "gpu_memcpy", "gpu_memset")]
    if not kernels:
        raise AssertionError("the profiler recorded no device activity")
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:  # union of kernel intervals (streams may overlap)
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict = {}
    for e in kernels:
        ms, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"device_busy_ms": busy_us / 1e3,
            "device_span_ms": (spans[-1][1] - spans[0][0]) / 1e3,
            "profiled_step_ms": wall_us / 1e3,
            "device_idle_share": 1 - busy_us / wall_us,
            "flash_kernels_ms": sum(ms for name, (ms, _) in top
                                    if "hvdflash" in name),
            "flash_kernels": {name.split("(")[0]: n for name, (_, n) in top
                              if "hvdflash" in name},
            "top": [{"kernel": name[:90], "ms": ms, "calls": n}
                    for name, (ms, n) in top[:12]]}


def phase_trainer(fa, smi_line, out_dir):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.examples import transformer_lm

    cfg = transformer_lm.bench_config()
    batch, seq, warmup, steps = 8, 1024, 2, 5
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    run = transformer_lm.train(cfg, batch=batch, seq=seq,
                               steps=warmup + steps, timed_from=warmup,
                               device="cuda", seed=0)
    launches = dict(fa.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = run["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    per_step = {n: c / (warmup + steps) for n, c in launches.items()}
    if any(c != cfg.n_layers * (warmup + steps) for c in launches.values()):
        raise AssertionError(
            f"each kernel must launch n_layers={cfg.n_layers} times a "
            f"step; launches over {warmup + steps} steps: {launches}")
    step_ms = run["timed_seconds"] / steps * 1e3
    log({"phase": "trainer", "model": "GPT-2-small",
         "params": run["n_params"], "batch": batch, "seq": seq,
         "dtype": "bfloat16", "losses": losses, "step_ms": step_ms,
         "tokens_per_s": batch * seq * steps / run["timed_seconds"],
         "launches_per_step": per_step, "device": smi_line,
         "peak_mem_gb": peak_gb})
    prof = profile_step(run, out_dir)
    log({"phase": "trainer_profile", **prof})
    # No fallback: bf16 at head_dim 64 runs the three redesigned kernels,
    # each once a layer, never the first form's kernels of the same names.
    names = " ".join(prof["flash_kernels"])
    for want in ("flash_fwd_sm90_kernel", "flash_bwd_dkdv_sm90_kernel",
                 "flash_bwd_dq_sm90_kernel"):
        ran = sum(n for name, n in prof["flash_kernels"].items()
                  if want in name)
        if ran != cfg.n_layers:
            raise AssertionError(f"the profiled step ran {want} {ran} times, "
                                 f"not {cfg.n_layers}: {names}")
    for first_form in ("flash_fwd_kernel<", "flash_bwd_dkdv_kernel<",
                       "flash_bwd_dq_kernel<"):
        if first_form in names:
            raise AssertionError(f"the profiled step ran {first_form}: "
                                 f"{names}")
    hvd.shutdown()
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--out-dir", default=os.path.join(HERE, "build",
                                                      "chip_smoke"),
                    help="where the profiled step's table and chrome "
                         "trace go")
    args = ap.parse_args()
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases: {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on a "
              "GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "horovod_tpu_torch")):
        print("chip_smoke: the horovod_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from horovod_tpu_torch.ops import _build
    from horovod_tpu_torch.ops import flash_attention as fa

    smi = nvidia_smi_line()
    log(smi)
    log({"phase": "device", "nvidia_smi": smi,
         "name": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count(), "torch": torch.__version__,
         "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    t0 = time.perf_counter()
    _build.build_all()
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "sources": list(_build.SOURCES)})
    main_case = phase_kernels(fa) if "kernels" in phases else None
    if "long" in phases:
        phase_long(fa)
    launches = (phase_trainer(fa, smi, args.out_dir) if "trainer" in phases
                else None)
    if main_case is None or launches is None:
        log({"phase": "done", "phases": phases})
        return 0

    # The main path's kernels: bf16 at head_dim 64 runs the redesigned
    # forward, dK/dV and dQ (the .cuh files, built into flash_fwd.cu and
    # flash_bwd.cu).
    sources = {
        "flash_fwd": "horovod_tpu_torch/ops/csrc/flash_fwd_sm90.cuh",
        "flash_bwd_dkdv": "horovod_tpu_torch/ops/csrc/flash_bwd_dkdv_sm90.cuh",
        "flash_bwd_dq": "horovod_tpu_torch/ops/csrc/flash_bwd_dq_sm90.cuh"}
    replaces = {
        "flash_fwd": "horovod_tpu/ops/flash_attention.py:133",
        "flash_bwd_dkdv": "horovod_tpu/ops/flash_attention.py:387",
        "flash_bwd_dq": "horovod_tpu/ops/flash_attention.py:431"}
    kernels = []
    for name in fa.KERNELS:
        r = main_case[name]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    log(smi)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
