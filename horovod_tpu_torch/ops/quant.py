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
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from . import compression as _c

KERNELS = ("quant_pack", "unpack_dequantize")
launches = {name: 0 for name in KERNELS}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_P, _I, _L, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_uint)
_SIGNATURES = {
    "hvd_quant_pack": [_P, _P, _P, _L, _L, _I, _I, _I, _I, _U, _U, _P],
    "hvd_unpack_dequantize": [_P, _P, _L, _L, _I, _I, _I, _P],
}
_entry_points: dict = {}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


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
    launches[name] += 1


def _check_shape(C: int, fmt: _c.WireFormat) -> None:
    if fmt.kind != "quant" or fmt.bits not in (8, 4):
        raise ValueError(f"not a quantized wire format: {fmt}")
    if fmt.block < 2 or fmt.block % 2 or C % fmt.block:
        raise ValueError(f"row length {C} is not a whole number of even "
                         f"blocks of {fmt.block}")


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
               residual_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize ``rows`` [r, C] (f32, bf16 or f16) block by block into one
    wire frame per row, [r, frame] uint8.  ``key`` is the call's noise
    key ``(k0, k1)`` (the dither's counter is the flat index in [r, C]);
    unused for nearest rounding.  ``residual_out`` [r, C] in rows' dtype,
    if given, receives ``rows - dequant(codes)``."""
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
    err = _entry("hvd_quant_pack")(
        rows.data_ptr(), wire.data_ptr(),
        None if residual_out is None else residual_out.data_ptr(), r, C,
        _DTYPE_CODES[rows.dtype], fmt.bits, fmt.block, int(fmt.stochastic),
        int(k0), int(k1), torch.cuda.current_stream(rows.device).cuda_stream)
    _check("quant_pack", err)
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
