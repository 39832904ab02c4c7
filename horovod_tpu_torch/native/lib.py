"""Build the port's host-side C++ runtime with ``g++`` at first use, and
load it with :mod:`ctypes` (port of horovod_tpu/native/lib.py).

The sources beside this file are copies of horovod_tpu/native/ (each
names its source; ``coordinator.cc`` carries the JOIN re-ready repair):

* ``coordinator.cc``    -- negotiation, validation, fusion, stall watch
                           (the C++ twin of ops/coordinator.py's
                           ``PyCoordinator``)
* ``wire.cc``/``wire.h`` -- the request and response layouts of ops/wire.py
* ``handle_manager.cc`` -- the ids of async handles (ops/handles.py)
* ``timeline.cc``       -- the Chrome-trace writer (utils/timeline.py)

They become ``libhvdtorch.so`` under ``native/_build/<hash>/``, where the
hash covers every source, header and flag, so an edited source is rebuilt
and an unchanged one is built once.  The build runs under a file lock and
links to a private name that is then renamed: processes that start
together (xdist workers, the ranks of one job) never load a half-written
library.  Nothing here runs at import.

The library is loaded as a ``ctypes.PyDLL``: its calls take microseconds
and keep the interpreter lock.  A ``CDLL`` call releases it, and with the
background cycle thread runnable the caller may then wait up to a switch
interval (5 ms) to get it back, on every call (the reference loads a
``CDLL``).

Selection follows the reference: with ``HVD_TPU_DISABLE_NATIVE`` set the
Python twins run; otherwise the native library is used, and a failed build
raises with g++'s output.  Unlike the reference there is no silent drop to
Python: a hidden fallback would leave a job on the other implementation
without a word.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

DISABLE_ENV = "HVD_TPU_DISABLE_NATIVE"
SRC_DIR = Path(__file__).resolve().parent
BUILD_ROOT = SRC_DIR / "_build"
SOURCES = ("wire.cc", "coordinator.cc", "handle_manager.cc", "timeline.cc")
HEADERS = ("wire.h",)
# The reference Makefile's flags, and a private C++ runtime: libstdc++
# linked in statically with its symbols hidden.  A library that carries
# libstdc++ code but exports it (what a g++ that links libstdc++
# statically makes of the reference's flags) has some of its calls bound
# to the process's own libstdc++.so, loaded by torch, and others to its
# copy; a stream then reads a locale facet by the other copy's index and
# dereferences null (on the H100 machine: SIGSEGV in
# ``hvd_coord_check_stalled``'s ``ostream << long``).  Hidden, every call
# stays inside the copy.
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-shared",
             "-static-libstdc++", "-static-libgcc",
             "-Wl,--exclude-libs,ALL")
LIBRARY = "libhvdtorch.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def enabled() -> bool:
    """False when ``HVD_TPU_DISABLE_NATIVE`` is set (to anything but an
    empty string): the Python twins run."""
    return not os.environ.get(DISABLE_ENV)


def source_hash(src_dir: Path = SRC_DIR) -> str:
    """Hash of the flags and of every source and header in ``src_dir``."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((Path(src_dir) / name).read_bytes())
    return h.hexdigest()[:16]


def build(src_dir: Path = SRC_DIR, out_root: Path = BUILD_ROOT) -> Path:
    """Compile ``src_dir``'s sources into ``out_root/<hash>/libhvdtorch.so``
    unless it is there already; returns its path.  Raises RuntimeError
    with the compiler's output when the build fails."""
    src_dir = Path(src_dir)
    out_dir = Path(out_root) / source_hash(src_dir)
    target = out_dir / LIBRARY
    if target.exists():
        return target
    out_dir.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            f"g++ not found: the port's native runtime is built from "
            f"{src_dir} at first use (set {DISABLE_ENV}=1 to run the "
            f"Python coordinator instead)")
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():  # another process built it meanwhile
            return target
        tmp = out_dir / f"{LIBRARY}.{os.getpid()}.tmp"
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
               *(str(src_dir / s) for s in SOURCES)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"building the native runtime failed (rc {proc.returncode}):"
                f" {' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, target)
    return target


def _declare(lib: ctypes.CDLL) -> None:
    """ctypes signatures (reference native/lib.py:80-117)."""
    c_void_p, c_int, c_char_p = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
    sigs = {
        "hvd_handle_manager_create": ([], c_void_p),
        "hvd_handle_manager_destroy": ([c_void_p], None),
        "hvd_handle_manager_allocate": ([c_void_p], c_int),
        "hvd_handle_manager_mark_done": ([c_void_p, c_int], None),
        "hvd_handle_manager_poll": ([c_void_p, c_int], c_int),
        "hvd_handle_manager_release": ([c_void_p, c_int], None),
        "hvd_coord_create": ([c_int, ctypes.c_longlong], c_void_p),
        "hvd_coord_destroy": ([c_void_p], None),
        "hvd_coord_submit": ([c_void_p, c_char_p, c_int], c_int),
        "hvd_coord_poll_responses": (
            [c_void_p, c_char_p, c_int, ctypes.c_double], c_int),
        "hvd_coord_fetch_responses": ([c_void_p, c_char_p, c_int], c_int),
        "hvd_coord_check_stalled": (
            [c_void_p, ctypes.c_double, c_char_p, c_int], c_int),
        "hvd_coord_withdraw": ([c_void_p, c_char_p, c_int, c_int], None),
        "hvd_coord_set_fusion_threshold": (
            [c_void_p, ctypes.c_longlong], None),
        "hvd_timeline_create": ([c_char_p], c_void_p),
        "hvd_timeline_event": (
            [c_void_p, c_int, c_char_p, c_char_p, c_char_p,
             ctypes.c_double], None),
        "hvd_timeline_close": ([c_void_p], None),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res


def load() -> ctypes.CDLL:
    """The native library, built on first use; raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.PyDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def active() -> Optional[ctypes.CDLL]:
    """The library the runtime should use: ``None`` when
    ``HVD_TPU_DISABLE_NATIVE`` selects the Python twins, else
    :func:`load`'s (which raises on a failed build)."""
    return load() if enabled() else None
