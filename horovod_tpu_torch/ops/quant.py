"""The quantized allreduce's codec kernels: wrappers over
``csrc/quant.cu``, with their plain PyTorch versions.

The reference has no Pallas kernel for this: its megakernel
(horovod_tpu/ops/megakernel.py:40-50) compiles quantize -> exchange ->
dequantize into one XLA program.  The port does each leg's codec in one
hand-written pass:

=====================  ==================================================
``quant_pack``         compression.py ``quantize_blocks`` + ``wire_pack``
                       (+ the error-feedback residual), :510/:552
``unpack_dequantize``  ``wire_unpack`` + ``dequantize_blocks`` (+
                       ``ordered_sum``), :562/:535/:596
=====================  ==================================================

A CPU tensor takes the plain version (:mod:`.compression`'s block
primitives); a CUDA tensor launches the kernel, on the current stream
(the executor's), or raises.  Each launch adds one to
``launches[<kernel>]``.  The kernels are bit for bit the plain version.

``quant_pack`` has two forms (``csrc/quant.cu`` says how each is built):
the one pass, for power-of-two blocks from 64 to 1024, 16-byte aligned
rows and residual and r * C < 2^32; and the first form for the rest.
:func:`quant_pack_form` picks one from the shape, dtype, format and
pointer alignment alone; ``form_launches[<form>]`` counts each form's
launches beside ``launches["quant_pack"]``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import _build
from . import compression as _c

KERNELS = ("quant_pack", "unpack_dequantize")
launches = {name: 0 for name in KERNELS}
FORMS = ("one_pass", "first")
form_launches = {form: 0 for form in FORMS}
# Threads may launch at once (the executor's, a caller's inline cycle): a
# count's read-modify-write holds this leaf lock, so no launch is lost.
_counts_lock = threading.Lock()
ONE_PASS_BLOCKS = (64, 128, 256, 512, 1024)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I, _L, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_uint)
_SIGNATURES = {
    "hvd_quant_pack": [_P, _P, _P, _L, _L, _I, _I, _I, _I, _U, _U, _P],
    "hvd_quant_pack_one_pass": [_P, _P, _P, _L, _L, _I, _I, _I, _I, _U, _U,
                                _I, _P],
    "hvd_unpack_dequantize": [_P, _P, _L, _L, _I, _I, _I, _P],
}
_entry_points: dict = {}


def reset_launches() -> None:
    with _counts_lock:
        for name in KERNELS:
            launches[name] = 0
        for form in FORMS:
            form_launches[form] = 0


def _entry(symbol: str):
    fn = _entry_points.get(symbol)
    if fn is None:
        fn = getattr(_build.library("quant"), symbol)
        fn.argtypes = _SIGNATURES[symbol]
        fn.restype = ctypes.c_int
        _entry_points[symbol] = fn
    return fn


def _uses_plain(*tensors) -> bool:
    """True for CPU tensors; False for CUDA tensors; raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"the quantization kernels take tensors all on the CPU (plain "
            f"version) or all on one CUDA device (kernel); got "
            f"{sorted(str(t.device) for t in tensors)}")
    return False


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    with _counts_lock:
        launches[name] += 1


def _check_shape(C: int, fmt: _c.WireFormat) -> None:
    if fmt.kind != "quant" or fmt.bits not in (8, 4):
        raise ValueError(f"not a quantized wire format: {fmt}")
    if fmt.block < 2 or fmt.block % 2 or C % fmt.block:
        raise ValueError(f"row length {C} is not a whole number of even "
                         f"blocks of {fmt.block}")


def quant_pack_form(r: int, C: int, dtype: torch.dtype, fmt: _c.WireFormat,
                    rows_ptr: int = 0, residual_ptr: Optional[int] = None):
    """``(form, store)``: the form of the kernel that ``quant_pack`` launches
    for rows [r, C] of ``dtype`` at address ``rows_ptr`` (and a residual at
    ``residual_ptr``), and for the one pass the width in bytes of its code
    stores: the widest (8 for int8, 4 for int4) that every row's start in
    the wire keeps aligned (row i starts at i * frame), 0 for the first
    form."""
    frame = _c.wire_bytes_per_chunk(C, fmt)
    if (fmt.block not in ONE_PASS_BLOCKS or dtype not in _DTYPE_CODES
            or r * C >= 2 ** 32 or r > 65535 or rows_ptr % 16
            or (residual_ptr is not None and residual_ptr % 16)
            or (fmt.bits == 4 and frame % 2)):
        return "first", 0
    widest = 8 if fmt.bits == 8 else 4
    if r == 1:
        return "one_pass", widest
    return "one_pass", next(w for w in (widest, 4, 2) if frame % w == 0)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def quant_pack_plain(rows: torch.Tensor, fmt: _c.WireFormat, key,
                     residual_out: Optional[torch.Tensor] = None):
    """``wire_pack(quantize_blocks(rows))``, and ``rows - dequant`` in
    rows' dtype into ``residual_out``."""
    q, s = _c.quantize_blocks(rows, fmt, key)
    if residual_out is not None:
        residual_out.copy_(
            rows - _c.dequantize_blocks(q, s, fmt).to(rows.dtype))
    return _c.wire_pack(q, s, fmt)


def unpack_dequantize_plain(wire: torch.Tensor, C: int, fmt: _c.WireFormat,
                            sum_rows: bool) -> torch.Tensor:
    out = _c.dequantize_blocks(*_c.wire_unpack(wire, C, fmt), fmt)
    return _c.ordered_sum(out) if sum_rows else out


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def quant_pack(rows: torch.Tensor, fmt: _c.WireFormat, key,
               residual_out: Optional[torch.Tensor] = None,
               form: Optional[str] = None) -> torch.Tensor:
    """Quantize ``rows`` [r, C] (f32, bf16 or f16) block by block into one
    wire frame per row, [r, frame] uint8.  ``key`` is the call's noise
    key ``(k0, k1)`` (the dither's counter is the flat index in [r, C]);
    unused for nearest rounding.  ``residual_out`` [r, C] in rows' dtype,
    if given, receives ``rows - dequant(codes)``.  ``form`` (CUDA only)
    overrides :func:`quant_pack_form`'s choice, to hold the two forms
    against each other: ``"first"`` takes every call, ``"one_pass"``
    raises where it does not apply."""
    r, C = rows.shape
    _check_shape(C, fmt)
    tensors = (rows,) if residual_out is None else (rows, residual_out)
    if _uses_plain(*tensors):
        return quant_pack_plain(rows, fmt, key, residual_out)
    if rows.dtype not in _DTYPE_CODES:
        raise ValueError(f"quant_pack takes float32, bfloat16 or float16, "
                         f"got {rows.dtype}")
    rows = rows.contiguous()
    if residual_out is not None and (
            residual_out.dtype != rows.dtype
            or tuple(residual_out.shape) != (r, C)
            or not residual_out.is_contiguous()):
        raise ValueError("residual_out must be a contiguous [r, C] tensor "
                         "of rows' dtype")
    wire = torch.empty((r, _c.wire_bytes_per_chunk(C, fmt)),
                       dtype=torch.uint8, device=rows.device)
    k0, k1 = key if fmt.stochastic else (0, 0)
    resid_ptr = None if residual_out is None else residual_out.data_ptr()
    chosen, store = quant_pack_form(r, C, rows.dtype, fmt, rows.data_ptr(),
                                    resid_ptr)
    if form not in (None, chosen, "first"):
        raise ValueError(f"quant_pack's {form} form does not take rows "
                         f"{(r, C)} {rows.dtype} at {rows.data_ptr():#x} "
                         f"with block {fmt.block}")
    form = form or chosen
    if form == "one_pass":
        launch, store_arg = _entry("hvd_quant_pack_one_pass"), (store,)
    else:
        launch, store_arg = _entry("hvd_quant_pack"), ()
    err = launch(rows.data_ptr(), wire.data_ptr(), resid_ptr, r, C,
                 _DTYPE_CODES[rows.dtype], fmt.bits, fmt.block,
                 int(fmt.stochastic), int(k0), int(k1), *store_arg,
                 torch.cuda.current_stream(rows.device).cuda_stream)
    _check("quant_pack", err)
    with _counts_lock:
        form_launches[form] += 1
    return wire


def unpack_dequantize(wire: torch.Tensor, C: int, fmt: _c.WireFormat,
                      sum_rows: bool) -> torch.Tensor:
    """Decode ``wire`` [r, frame] into f32: [C], the rows summed in index
    order, when ``sum_rows``; else [r, C]."""
    r = wire.shape[0]
    _check_shape(C, fmt)
    frame = _c.wire_bytes_per_chunk(C, fmt)
    if wire.dtype != torch.uint8 or wire.dim() != 2 or \
            wire.shape[1] != frame:
        raise ValueError(f"wire must be uint8 [r, {frame}], got "
                         f"{wire.dtype} {tuple(wire.shape)}")
    if _uses_plain(wire):
        return unpack_dequantize_plain(wire, C, fmt, sum_rows)
    wire = wire.contiguous()
    out = torch.empty((C,) if sum_rows else (r, C), dtype=torch.float32,
                      device=wire.device)
    err = _entry("hvd_unpack_dequantize")(
        wire.data_ptr(), out.data_ptr(), r, C, fmt.bits, fmt.block,
        int(sum_rows), torch.cuda.current_stream(wire.device).cuda_stream)
    _check("unpack_dequantize", err)
    return out
