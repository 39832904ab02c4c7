#!/usr/bin/env python3
"""Registers, stack and spills of every kernel the port builds.

    python3 tools/ptxas_usage.py [--match SUBSTRING]

Compiles each source of ``horovod_tpu_torch/ops/_build.SOURCES`` with the
build's own ``NVCC_FLAGS`` plus ``-Xptxas -v`` into a temporary
directory, and prints one JSON line a kernel: its demangled name, the
registers a thread, the stack frame, and the spill stores and loads in
bytes.  ``--match`` keeps the kernels whose demangled name contains the
substring.  Exits non-zero when a source does not build.  Needs ``nvcc``
(the machine with the card).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from horovod_tpu_torch.ops import _build  # noqa: E402

ENTRY = re.compile(r"Compiling entry function '(\S+)'")
FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                   r"(\d+) bytes spill loads")
USED = re.compile(r"Used (\d+) registers")


def demangle(names):
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def usage(source: str, out_dir: str) -> list:
    """``[{kernel, registers, stack, spill_stores, spill_loads}]`` of one
    source, from ptxas's report."""
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(out_dir, f"lib{source}.so"),
         str(_build.CSRC / f"{source}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {source}.cu failed:\n{proc.stderr}")
    rows, cur = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = ENTRY.search(line)
        if m:
            cur = {"kernel": m.group(1), "source": f"{source}.cu"}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = FRAME.search(line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = (
                int(x) for x in m.groups())
        m = USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    names = demangle([r["kernel"] for r in rows])
    for r in rows:
        r["kernel"] = names[r["kernel"]]
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--match", default=None,
                    help="keep kernels whose demangled name contains this")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory(prefix="ptxas_usage_") as out_dir:
        for source in _build.SOURCES:
            for row in usage(source, out_dir):
                if args.match is None or args.match in row["kernel"]:
                    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
