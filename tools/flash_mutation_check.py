#!/usr/bin/env python3
"""Checks that chip_smoke.py's kernel comparisons catch wrong kernels.

    python3 tools/flash_mutation_check.py [--work-dir DIR] [--mutations a,b]

For each mutation below (or the ones named), copies chip_smoke.py and
horovod_tpu_torch/ into a fresh directory under --work-dir (default: a
new temporary directory), applies one textual change to a CUDA source
there, and runs chip_smoke.py on the copy: `--phases kernels` for the
flash kernels, `--phases serving` for the serving kernels.  Every
mutated copy must build and then fail a check (an AssertionError), and
the unmodified copy must pass both phases; the script exits non-zero
otherwise.  Each flash mutation leaves the early, large rows of a causal
output right and breaks only the later, smaller ones, which a tolerance
scaled by the largest output element can miss.  Each serving mutation
breaks one rule of the Hopper serving forms (ops/csrc/
serving_gemm_sm90.cuh, cache_attention_sm90.cuh); the message names the
check that caught it.  One JSON line per copy and phase: its return
code and the check's message.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join("horovod_tpu_torch", "ops", "csrc")

# name -> (source, text, replacement); 512 is half the main case's seq.
# The first three make one output 5% low on its later half of rows or
# keys; the last three drop or corrupt the diagonal tile of those rows'
# sums.  Every mutation edits a Hopper redesign, which bf16 at head_dim
# 64 (the main case) runs.
MUTATIONS = {
    "none": None,
    "fwd_o_5pct_low_late_rows": (
        "flash_fwd_sm90.cuh",
        "const float inv = no_valid ? 0.f : 1.f / l_row;",
        "const float inv =\n"
        "          no_valid ? 0.f : 1.f / l_row * (q0 >= 512 ? 0.95f : 1.f);"),
    "dkdv_dv_5pct_low_late_keys": (
        "flash_bwd_dkdv_sm90.cuh",
        "pack_bf16(acc_dv[i], acc_dv[i + 1]);",
        "pack_bf16(acc_dv[i] * (k0 >= 512 ? 0.95f : 1.f),\n"
        "                      acc_dv[i + 1] * (k0 >= 512 ? 0.95f : 1.f));"),
    "dq_5pct_low_late_rows": (
        "flash_bwd_dq_sm90.cuh",
        "pack_bf16(acc[i], acc[i + 1]);",
        "pack_bf16(acc[i] * (q0 >= 512 ? 0.95f : 1.f),\n"
        "                      acc[i + 1] * (q0 >= 512 ? 0.95f : 1.f));"),
    # Forward: q tiles past row 512 multiply their diagonal (last) K
    # tile's probabilities by the previous tile's V (the other stage).
    "fwd_stale_v_on_diagonal_tile": (
        "flash_fwd_sm90.cuh",
        "const uint32_t k_s = sK + s * L::kKV, v_s = sV + s * L::kKV;",
        "const uint32_t k_s = sK + s * L::kKV,\n"
        "                     v_s = sV + (kb > 0 && kb + 1 == hi && q0 >= 512"
        "\n                                     ? s ^ 1 : s) * L::kKV;"),
    # dKdV: k tiles past key 512 skip their diagonal q tile (producer and
    # consumers alike, so the ring stays in step).
    "dkdv_skip_diagonal_q_tile": (
        "flash_bwd_dkdv_sm90.cuh",
        "causal ? min(max(0, floordiv(k0 - q_offset, L::BM)), n_qb) : 0;",
        "causal ? min(max(0, floordiv(k0 - q_offset, L::BM) +\n"
        "                          (k0 >= 512 ? 1 : 0)), n_qb) : 0;"),
    # dQ: q tiles past row 512 skip their diagonal (last) k tile; the
    # block's bound hi caps the producer's loop and both consumers'.
    "dq_skip_diagonal_k_tile": (
        "flash_bwd_dq_sm90.cuh",
        "causal ? min(n_kb, cdiv(q0 + L::BM + q_offset, L::BN)) : n_kb;",
        "(causal ? min(n_kb, cdiv(q0 + L::BM + q_offset, L::BN)) : n_kb) -\n"
        "      (q0 >= 512 ? 1 : 0);"),
    # serving_gemm: the last K range stops one k tile short.
    "gemm_last_k_tile_dropped": (
        "serving_gemm_sm90.cuh",
        "const int kb0 = z * kt / split, kb1 = (z + 1) * kt / split;",
        "const int kb0 = z * kt / split,\n"
        "            kb1 = (z + 1) * kt / split - (z + 1 == split ? 1 : 0);"),
    # serving_gemm: the split partials of K ranges 1 and 2 added in
    # swapped order once a call has more than 781 rows, so a row's sum
    # depends on M.
    "gemm_split_sum_order_by_rows": (
        "serving_gemm_sm90.cuh",
        "cluster.map_shared_rank(part, r)[j * 128 + t]",
        "cluster.map_shared_rank(\n"
        "              part, M > 781 && r < 3 ? 3 - r : r)[j * 128 + t]"),
    # cache_attention: every block skips its last key tile.
    "attention_last_key_tile_skipped": (
        "cache_attention_sm90.cuh",
        "const int n_kb = (n_kv + L::BN - 1) / L::BN;",
        "const int n_kb = (n_kv + L::BN - 1) / L::BN - (n_kv > 0 ? 1 : 0);"),
    # cache_attention: the mask reads the row's index in the call instead
    # of its position q_pos (the same at a prefill from position 0).
    "attention_mask_from_row_index": (
        "cache_attention_sm90.cuh",
        "const int pos[2] = {pos_s[r0], pos_s[r0 + 8]};",
        "const int pos[2] = {i0 + r0, i0 + r0 + 8};"),
    # cache_attention: V rows past the block's furthest position are not
    # zeroed, so 0 * NaN reaches P V.
    "attention_tail_zeroing_removed": (
        "cache_attention_sm90.cuh",
        "if (k0 + L::BN > n_kv) {",
        "if (false && k0 + L::BN > n_kv) {"),
}

# The chip_smoke.py phase that runs each source's kernel.
PHASE_OF_SOURCE = {
    "flash_fwd_sm90.cuh": "kernels",
    "flash_bwd_dkdv_sm90.cuh": "kernels",
    "flash_bwd_dq_sm90.cuh": "kernels",
    "serving_gemm_sm90.cuh": "serving",
    "cache_attention_sm90.cuh": "serving",
}


def make_copy(dst: str, mutation) -> None:
    shutil.copy(os.path.join(HERE, "chip_smoke.py"), dst)
    shutil.copytree(os.path.join(HERE, "horovod_tpu_torch"),
                    os.path.join(dst, "horovod_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if mutation is None:
        return
    source, text, replacement = mutation
    path = os.path.join(dst, CSRC, source)
    with open(path) as f:
        code = f.read()
    if code.count(text) != 1:
        raise SystemExit(f"{source}: the text to mutate occurs "
                         f"{code.count(text)} times, not once")
    with open(path, "w") as f:
        f.write(code.replace(text, replacement))


def run_copy(dst: str, phase: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "chip_smoke.py", "--phases", phase, "--out-dir",
         os.path.join(dst, "out")],
        cwd=dst, capture_output=True, text=True, timeout=900)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work-dir", default=None,
                    help="where the copies go (default: a temporary "
                         "directory, removed afterwards)")
    ap.add_argument("--mutations", default=None,
                    help="comma-separated subset of the mutations (the "
                         "unmodified copy always runs)")
    args = ap.parse_args()
    names = list(MUTATIONS)
    if args.mutations:
        wanted = args.mutations.split(",")
        unknown = set(wanted) - set(MUTATIONS)
        if unknown:
            ap.error(f"unknown mutations: {sorted(unknown)}")
        names = ["none"] + [n for n in names if n in wanted and n != "none"]
    work = args.work_dir or tempfile.mkdtemp(prefix="flash_mutation_")
    ok = True
    try:
        for name in names:
            mutation = MUTATIONS[name]
            dst = os.path.join(work, name)
            os.makedirs(dst, exist_ok=True)
            make_copy(dst, mutation)
            phases = (sorted({PHASE_OF_SOURCE[MUTATIONS[n][0]]
                              for n in names if MUTATIONS[n] is not None})
                      if mutation is None else
                      [PHASE_OF_SOURCE[mutation[0]]])
            for phase in phases:
                proc = run_copy(dst, phase)
                lines = (proc.stderr.strip()
                         or proc.stdout.strip()).splitlines()
                caught = (proc.returncode != 0
                          and "AssertionError" in proc.stderr)
                expected = (proc.returncode == 0 if mutation is None
                            else caught)
                ok &= expected
                print(json.dumps({"mutation": name, "phase": phase,
                                  "rc": proc.returncode,
                                  "as_expected": expected,
                                  "message": lines[-1] if lines else ""}),
                      flush=True)
    finally:
        if args.work_dir is None:
            shutil.rmtree(work, ignore_errors=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
