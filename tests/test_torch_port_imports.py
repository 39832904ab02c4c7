"""horovod_tpu_torch stands alone: it imports neither jax nor horovod_tpu
(nor flax or msgpack, which the GPU machine lacks: its checkpoints have a
codec of their own), it refuses to start on the CPU unless asked to, and
a CUDA tensor never takes a kernel's plain version.
"""

import ast
import os
import subprocess
import sys
import warnings

import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import flash_attention as tfa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "horovod_tpu_torch")
FORBIDDEN = ("jax", "horovod_tpu", "flax", "msgpack")


def _package_modules():
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(root, f)
                rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
                yield path, rel.removesuffix(".__init__")


def test_every_module_imports_with_jax_and_horovod_tpu_blocked():
    names = [name for _, name in _package_modules()]
    code = ("import importlib, sys, threading\n"
            f"for blocked in {FORBIDDEN!r}:\n"
            "    sys.modules[blocked] = None\n"
            "threads = threading.active_count()\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "loaded = [m for m, mod in sys.modules.items() if mod is not None"
            f" and m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not loaded, loaded\n"
            "assert threading.active_count() == threads, 'import started a "
            "thread'\n"
            "print('IMPORTS_OK')\n")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "IMPORTS_OK" in out.stdout, out.stderr
    assert {"horovod_tpu_torch.ops.wire", "horovod_tpu_torch.ops.cache",
            "horovod_tpu_torch.ops.coordinator",
            "horovod_tpu_torch.ops.process_set",
            "horovod_tpu_torch.ops.handles",
            "horovod_tpu_torch.ops.transport",
            "horovod_tpu_torch.ops.tree",
            "horovod_tpu_torch.ops.collective",
            "horovod_tpu_torch.frontends.torch",
            "horovod_tpu_torch.frontends.torch_sync_bn",
            "horovod_tpu_torch.examples.pytorch_mnist",
            "horovod_tpu_torch.examples.collectives_tour",
            "horovod_tpu_torch.examples.uneven_join",
            "horovod_tpu_torch.core.features",
            "horovod_tpu_torch.utils.timeline",
            "horovod_tpu_torch.ops.sparse",
            "horovod_tpu_torch.models.word2vec",
            "horovod_tpu_torch.examples.word2vec",
            "horovod_tpu_torch.ops.prng", "horovod_tpu_torch.ops.quant",
            "horovod_tpu_torch.ops.megakernel",
            "horovod_tpu_torch.core.topology",
            "horovod_tpu_torch.native.lib",
            "horovod_tpu_torch.parallel.overlap",
            "horovod_tpu_torch.utils.retry",
            "horovod_tpu_torch.utils.serialization",
            "horovod_tpu_torch.utils.checkpoint",
            "horovod_tpu_torch.ops.serving",
            "horovod_tpu_torch.routing",
            "horovod_tpu_torch.routing.affinity",
            "horovod_tpu_torch.routing.replica",
            "horovod_tpu_torch.routing.router",
            "horovod_tpu_torch.routing.autoscale",
            "horovod_tpu_torch.routing.server",
            "horovod_tpu_torch.telemetry",
            "horovod_tpu_torch.telemetry.registry",
            "horovod_tpu_torch.telemetry.exporter",
            "horovod_tpu_torch.serving",
            "horovod_tpu_torch.serving.scheduler",
            "horovod_tpu_torch.serving.kv_cache",
            "horovod_tpu_torch.serving.engine",
            "horovod_tpu_torch.serving.harness",
            "horovod_tpu_torch.serving.server",
            "horovod_tpu_torch.examples.serve_lm",
            "horovod_tpu_torch.tuning",
            "horovod_tpu_torch.tuning.policy",
            "horovod_tpu_torch.tuning.sensors",
            "horovod_tpu_torch.tuning.actuation",
            "horovod_tpu_torch.tuning.controller",
            "horovod_tpu_torch.utils.autotune",
            "horovod_tpu_torch.frontends.keras",
            "horovod_tpu_torch.frontends.tensorflow",
            "horovod_tpu_torch.examples.keras_mnist"} <= set(names)


FRONTENDS = ("horovod_tpu_torch.frontends.keras",
             "horovod_tpu_torch.frontends.tensorflow",
             "horovod_tpu_torch.examples.keras_mnist")


def test_the_keras_and_tensorflow_frontends_import_neither_framework():
    """Both frameworks are imported inside the functions that use them;
    importing the frontends leaves KERAS_BACKEND as the caller set it."""
    code = ("import importlib, os, sys\n"
            "sys.modules['jax'] = None\n"
            f"for name in {FRONTENDS!r}:\n"
            "    importlib.import_module(name)\n"
            "loaded = [m for m in sys.modules if m.split('.')[0] in "
            "('keras', 'tensorflow', 'tf_keras')]\n"
            "assert not loaded, loaded[:5]\n"
            "print('BACKEND', os.environ.get('KERAS_BACKEND'))\n")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    env.pop("KERAS_BACKEND", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "BACKEND torch" in out.stdout, out.stderr
    env["KERAS_BACKEND"] = "jax"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "BACKEND jax" in out.stdout, out.stderr


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_names_jax_or_horovod_tpu_in_an_import():
    for path, name in _package_modules():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for mod in _imported_roots(tree):
            root = mod.split(".")[0]
            assert root not in FORBIDDEN, f"{name} imports {mod}"


def test_init_without_a_gpu_raises_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    thvd.shutdown()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thvd.init()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        thvd.init(device="cuda")
    assert not thvd.is_initialized()
    thvd.init(device="cpu")
    try:
        assert thvd.device() == torch.device("cpu") and thvd.size() == 1
    finally:
        thvd.shutdown()


def test_cuda_tensors_never_take_the_plain_version(monkeypatch):
    """A CUDA tensor goes to the kernel: with no kernel to be had (no
    nvcc), the wrappers raise instead of answering with the plain
    version.  Fake CUDA tensors carry the device without a card."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain_called(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(tfa, "_entry_points", {})
    monkeypatch.setattr(tfa, "_dense_forward", plain_called)
    monkeypatch.setattr(tfa, "_dense_backward_from_delta", plain_called)
    tfa.reset_launches()
    with warnings.catch_warnings(), FakeTensorMode():
        warnings.simplefilter("ignore")  # data_ptr of a fake tensor
        q = torch.empty(2, 64, 16, device="cuda")
        stats = torch.empty(2, 64, device="cuda")
        assert q.device.type == "cuda"
        calls = [
            lambda: tfa.flash_fwd(q, q, q, 0.25, True, 0),
            lambda: tfa.flash_bwd_dkdv(q, q, q, q, stats, stats, 0.25, True,
                                       0),
            lambda: tfa.flash_bwd_dq(q, q, q, q, stats, stats, 0.25, True, 0),
        ]
        for call in calls:
            with pytest.raises(RuntimeError, match="nvcc not found"):
                call()
    assert tfa.launches == {name: 0 for name in tfa.KERNELS}


def test_cuda_tensors_never_take_the_plain_quantization(monkeypatch):
    """The same for the quantization kernels (ops/quant.py)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from horovod_tpu_torch.ops import compression as tc
    from horovod_tpu_torch.ops import quant as tq

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    def plain_called(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(tq, "_entry_points", {})
    monkeypatch.setattr(tq, "quant_pack_plain", plain_called)
    monkeypatch.setattr(tq, "unpack_dequantize_plain", plain_called)
    fmt = tc.WireFormat(kind="quant", name="int8", bits=8, block=256)
    tq.reset_launches()
    with warnings.catch_warnings(), FakeTensorMode():
        warnings.simplefilter("ignore")
        rows = torch.empty(2, 512, device="cuda")
        wire = torch.empty(2, tc.wire_bytes_per_chunk(512, fmt),
                           dtype=torch.uint8,
                           device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tq.quant_pack(rows, fmt, (0, 1))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tq.unpack_dequantize(wire, 512, fmt, sum_rows=True)
    assert tq.launches == {name: 0 for name in tq.KERNELS}
    with pytest.raises(ValueError, match="whole number"):
        tq.quant_pack(torch.zeros(1, 300), fmt, (0, 1))


def test_mixed_devices_are_refused():
    cpu = torch.zeros(1, 8, 16)
    meta = torch.zeros(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="all on the CPU"):
        tfa.flash_fwd(cpu, meta, cpu, 0.25, False, 0)


def test_build_is_keyed_by_the_sources_and_flags(monkeypatch):
    key = _build._source_hash()
    assert key == _build._source_hash() and len(key) == 16
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._source_hash() != key
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)
