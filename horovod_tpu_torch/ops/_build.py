"""Build the port's CUDA kernels with ``nvcc`` at first use, and load them.

Each ``csrc/<name>.cu`` becomes ``lib<name>.so``, a shared library with a
plain C interface that :mod:`ctypes` loads: pointers and the stream go in
as ``c_void_p``, and each entry point returns the ``cudaError_t`` of its
launch.  No PyTorch headers are compiled, so a build takes seconds, not
minutes.

The libraries go into ``ops/_build/<hash>/``, where the hash covers every
source, header and flag, so an edited kernel is rebuilt and an unchanged
one is built once.  All sources are compiled at once, one ``nvcc`` each.
Nothing here runs at import: the CPU tests import every module, and this
module needs ``nvcc`` only when a kernel is first launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("flash_fwd", "flash_bwd", "quant", "serving")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels are "
        "built from horovod_tpu_torch/ops/csrc at first use")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every source not yet built (in parallel) and load it.
    Returns ``{name: ctypes.CDLL}``; raises with nvcc's output on failure."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        out_dir = BUILD_ROOT / _source_hash()
        out_dir.mkdir(parents=True, exist_ok=True)
        missing = [n for n in SOURCES
                   if not (out_dir / f"lib{n}.so").exists()]
        nvcc = nvcc_path() if missing else None
        procs = {}
        for name in missing:
            target = out_dir / f"lib{name}.so"
            # Build under a private name, then rename: processes that
            # start together never load a half-written library.
            tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, target)
        failures = []
        for name, (proc, tmp, target) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc {name}.cu failed "
                                f"(rc {proc.returncode}):\n{out}")
                continue
            os.replace(tmp, target)
        if failures:
            raise RuntimeError("\n".join(failures))
        for name in SOURCES:
            _libs[name] = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        return _libs


def library(name: str) -> ctypes.CDLL:
    return build_all()[name]
