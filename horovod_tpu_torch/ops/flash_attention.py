"""Flash attention: hand-written Hopper kernels, with plain PyTorch versions.

Port of :mod:`horovod_tpu.ops.flash_attention`.  The three Pallas TPU
kernels on the training path become three CUDA C++ kernels for
``sm_90a`` (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), built by
:mod:`._build` at first use.  For bf16 at head_dim 64, 80, 96 and 128 all
three run their Hopper redesign (TMA, ``wgmma``, accumulators in registers:
``csrc/flash_fwd_sm90.cuh``, ``csrc/flash_bwd_dkdv_sm90.cuh``,
``csrc/flash_bwd_dq_sm90.cuh``); f32 and the other head dims run the
first, WMMA/FMA form.  The choice is made from (dtype, head_dim) inside
the library, never as a fallback.
The TPU kernels each replaces:

==================  =====================================================
``flash_fwd``       ``_fwd_kernel_resident`` (and ``_fwd_kernel``)
``flash_bwd_dkdv``  ``_bwd_dkdv_kernel_resident`` (and ``_bwd_dkdv_kernel``)
``flash_bwd_dq``    ``_bwd_dq_kernel_resident`` (and ``_bwd_dq_kernel``)
==================  =====================================================

Each wrapper takes its plain PyTorch version for tensors on the CPU (the
tests), and launches its kernel for tensors on a CUDA device, or raises:
a CUDA tensor never takes the plain path.  Each launch adds one to
``launches[<kernel>]`` and to ``launches_by_form[(<kernel>, <form>,
<head_dim>)]``, the form being :func:`kernel_form`'s.

Layout: ``q, k, v : [batch, heads, seq, head_dim]``, the same ``(o, lse)``
contract as the reference: ``lse`` is f32 ``[batch, heads, q_len]``, and
rows with no visible key give ``o = 0``, ``lse = -inf``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from . import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

KERNELS = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
launches = {name: 0 for name in KERNELS}
# (kernel, form, head_dim) -> launches, for the pairs launched since the
# last reset_launches().
launches_by_form: dict = {}
# Threads may launch at once (the autograd engine's, a serve loop's): a
# count's read-modify-write holds this leaf lock, so no launch is lost.
_counts_lock = threading.Lock()

# dtype codes of csrc/flash_common.cuh, and the head dims it is built for.
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 96, 128)


def reset_launches() -> None:
    with _counts_lock:
        for name in KERNELS:
            launches[name] = 0
        launches_by_form.clear()


def kernel_form(dtype: torch.dtype, head_dim: int) -> str:
    """The form the library runs for (dtype, head_dim), as ``hopper_form``
    in csrc/flash_common.cuh chooses it: "sm90" for bf16 at head_dim 64
    and above, "first" otherwise."""
    return "sm90" if dtype == torch.bfloat16 and head_dim >= 64 else "first"


# ---------------------------------------------------------------------------
# Plain versions (the reference's dense path, horovod_tpu flash_attention
# :55-95).  They take [..., seq, head_dim] tensors of any leading shape.
# ---------------------------------------------------------------------------

def _dense_mask(s, *, causal, q_block_offset):
    if not causal:
        return s
    q_len, k_len = s.shape[-2:]
    q_pos = q_block_offset + torch.arange(q_len, device=s.device)[:, None]
    k_pos = torch.arange(k_len, device=s.device)[None, :]
    return s.masked_fill(q_pos < k_pos, float("-inf"))


def _dense_probs(q, k, lse, *, sm_scale, causal, q_block_offset):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = _dense_mask(s, causal=causal, q_block_offset=q_block_offset)
    masked_row = torch.isneginf(lse)[..., None]
    return torch.where(masked_row, 0.0, torch.exp(s - lse[..., None]))


def _dense_forward(q, k, v, sm_scale, causal, q_block_offset):
    """(o, lse) by exact dense attention: the kernel's contract."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    s = _dense_mask(s, causal=causal, q_block_offset=q_block_offset)
    lse = torch.logsumexp(s, dim=-1)  # -inf on rows with no visible key
    p = torch.where(torch.isneginf(lse)[..., None], 0.0,
                    torch.exp(s - lse[..., None]))
    o = torch.matmul(p, v.float()).to(q.dtype)
    return o, lse


def _dense_backward_from_delta(q, k, v, do, lse, delta, *, sm_scale, causal,
                               q_block_offset):
    """(dq, dk, dv) from the saved lse and delta = rowsum(dO * O)."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), do.float()
    p = _dense_probs(q, k, lse, sm_scale=sm_scale, causal=causal,
                     q_block_offset=q_block_offset)
    dv = torch.matmul(p.transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * sm_scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _dense_backward(res, g, *, sm_scale, causal, q_block_offset):
    """The flash backward's math, densely, from the caller's ``o``/``lse``
    (so that ring attention's per-chunk gradients stay normalised across
    the whole sequence)."""
    q, k, v, o, lse = res
    delta = torch.sum(g.float() * o.float(), dim=-1)
    return _dense_backward_from_delta(q, k, v, g, lse, delta,
                                      sm_scale=sm_scale, causal=causal,
                                      q_block_offset=q_block_offset)


# ---------------------------------------------------------------------------
# Kernel wrappers.  Operands are [batch*heads, seq, head_dim].
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "hvd_flash_fwd": ("flash_fwd", [_P] * 5 + [_I] * 5 + [_F, _I, _I, _P]),
    "hvd_flash_bwd_dkdv": ("flash_bwd",
                           [_P] * 8 + [_I] * 5 + [_F, _I, _I, _P]),
    "hvd_flash_bwd_dq": ("flash_bwd", [_P] * 7 + [_I] * 5 + [_F, _I, _I, _P]),
}
_entry_points: dict = {}


def _entry(symbol: str):
    fn = _entry_points.get(symbol)
    if fn is None:
        lib_name, argtypes = _SIGNATURES[symbol]
        fn = getattr(_build.library(lib_name), symbol)
        fn.argtypes = argtypes
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
            f"flash attention takes tensors all on the CPU (plain version) "
            f"or all on one CUDA device (kernel); got "
            f"{sorted(str(t.device) for t in tensors)}")
    return False


def _kernel_operands(q, k, v, *rest):
    """Validate what the kernels take, and return contiguous operands."""
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash kernels take float32 or bfloat16, got "
                         f"{q.dtype}")
    head_dim = q.shape[-1]
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in {HEAD_DIMS}, got "
                         f"{head_dim}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype")
    if q.shape[0] != k.shape[0] or k.shape != v.shape or \
            k.shape[-1] != head_dim:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    out = []
    for t in (q, k, v, *rest):
        t = t.contiguous()
        if t.data_ptr() % 16:  # the kernels load 16 bytes per thread
            t = t.clone()
        out.append(t)
    return out


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name: str, q, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    key = (name, kernel_form(q.dtype, q.shape[-1]), q.shape[-1])
    with _counts_lock:
        launches[name] += 1
        launches_by_form[key] = launches_by_form.get(key, 0) + 1


def flash_fwd(q, k, v, sm_scale: float, causal: bool, q_block_offset: int):
    """Forward kernel: ``(o [BH, Sq, D], lse [BH, Sq] f32)``."""
    if _uses_plain(q, k, v):
        return _dense_forward(q, k, v, sm_scale, causal, q_block_offset)
    q, k, v = _kernel_operands(q, k, v)
    bh, q_len, head_dim = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, q_len), dtype=torch.float32, device=q.device)
    err = _entry("hvd_flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), bh, q_len, k.shape[1], head_dim,
        _DTYPE_CODES[q.dtype], float(sm_scale), int(causal),
        int(q_block_offset), _stream(q))
    _check("flash_fwd", q, err)
    return o, lse


def _bwd_stats(q, lse, delta):
    bh, q_len = q.shape[:2]
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (bh, q_len):
            raise ValueError(f"{name} must be float32 [{bh}, {q_len}], got "
                             f"{t.dtype} {tuple(t.shape)}")


def flash_bwd_dkdv(q, k, v, do, lse, delta, sm_scale: float, causal: bool,
                   q_block_offset: int):
    """dK/dV kernel: ``(dk, dv)`` like ``k``/``v``."""
    if _uses_plain(q, k, v, do, lse, delta):
        _, dk, dv = _dense_backward_from_delta(
            q, k, v, do, lse, delta, sm_scale=sm_scale, causal=causal,
            q_block_offset=q_block_offset)
        return dk, dv
    _bwd_stats(q, lse, delta)
    q, k, v, do, lse, delta = _kernel_operands(q, k, v, do.to(q.dtype), lse,
                                               delta)
    bh, q_len, head_dim = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _entry("hvd_flash_bwd_dkdv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
        q_len, k.shape[1], head_dim, _DTYPE_CODES[q.dtype], float(sm_scale),
        int(causal), int(q_block_offset), _stream(q))
    _check("flash_bwd_dkdv", q, err)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, sm_scale: float, causal: bool,
                 q_block_offset: int):
    """dQ kernel: ``dq`` like ``q``."""
    if _uses_plain(q, k, v, do, lse, delta):
        return _dense_backward_from_delta(
            q, k, v, do, lse, delta, sm_scale=sm_scale, causal=causal,
            q_block_offset=q_block_offset)[0]
    _bwd_stats(q, lse, delta)
    q, k, v, do, lse, delta = _kernel_operands(q, k, v, do.to(q.dtype), lse,
                                               delta)
    bh, q_len, head_dim = q.shape
    dq = torch.empty_like(q)
    err = _entry("hvd_flash_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, q_len,
        k.shape[1], head_dim, _DTYPE_CODES[q.dtype], float(sm_scale),
        int(causal), int(q_block_offset), _stream(q))
    _check("flash_bwd_dq", q, err)
    return dq


# ---------------------------------------------------------------------------
# [batch, heads, seq, head_dim] entry points
# ---------------------------------------------------------------------------

def _flat(x):
    return x.reshape(-1, x.shape[-2], x.shape[-1])


def _flash_forward(q, k, v, sm_scale, causal, q_block_offset):
    b, h, q_len, d = q.shape
    o, lse = flash_fwd(_flat(q), _flat(k), _flat(v), sm_scale, causal,
                       q_block_offset)
    return o.reshape(b, h, q_len, d), lse.reshape(b, h, q_len)


def flash_backward(res, g, *, sm_scale: float, causal: bool,
                   q_block_offset: int = 0):
    """``(dq, dk, dv)`` from ``res = (q, k, v, o, lse)`` and the output
    gradient ``g`` (reference ``_flash_backward``).  ``o``/``lse`` are
    the caller's, so ring attention can pass globally merged ones.
    delta = rowsum(dO * O) is taken in f32 here, outside the kernels, as
    the reference does (:634-636); the kernels get dO in q's dtype."""
    q, k, v, o, lse = res
    b, h, q_len, d = q.shape
    kv_len = k.shape[2]
    delta = torch.sum(g.float() * o.float(), dim=-1)
    args = (_flat(q), _flat(k), _flat(v), _flat(g.to(q.dtype)),
            lse.reshape(b * h, q_len), delta.reshape(b * h, q_len),
            sm_scale, causal, q_block_offset)
    dk, dv = flash_bwd_dkdv(*args)
    dq = flash_bwd_dq(*args)
    return (dq.reshape(b, h, q_len, d), dk.reshape(b, h, kv_len, d),
            dv.reshape(b, h, kv_len, d))


class _Flash(torch.autograd.Function):
    """Counterpart of the reference's ``_flash`` custom_vjp (:738-761):
    the forward saves ``q, k, v, o, lse``; the backward runs the dKdV and
    dQ kernels."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, q_block_offset):
        o, lse = _flash_forward(q, k, v, sm_scale, causal, q_block_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (sm_scale, causal, q_block_offset)
        return o

    @staticmethod
    def backward(ctx, g):
        sm_scale, causal, q_block_offset = ctx.args
        dq, dk, dv = flash_backward(ctx.saved_tensors, g, sm_scale=sm_scale,
                                    causal=causal,
                                    q_block_offset=q_block_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128, q_block_offset: int = 0):
    """Memory-linear attention, differentiable.

    Args:
      q, k, v: ``[batch, heads, seq, head_dim]`` (q_len may differ from
        kv_len).
      causal: lower-triangular mask; K tiles past the diagonal are skipped.
      sm_scale: softmax temperature; default ``1/sqrt(head_dim)``.
      block_q, block_k: kept for the reference's signature.  The kernels
        choose their own tiles (for bf16 at head_dim 64-128, 128 q rows
        or keys a block, streaming 128-key tiles in the forward, 64-row
        Q/dO tiles in dK/dV and 64-key K/V tiles in dQ; 64 rows for other
        bf16, 32 in f32), and the plain version has none.
      q_block_offset: global position of q's first row relative to k's
        first row, for sequence-sharded callers (ring attention).
    """
    del block_q, block_k
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _Flash.apply(q, k, v, float(sm_scale), bool(causal),
                        int(q_block_offset))


def flash_attention_with_lse(q, k, v, *, causal: bool = False,
                             sm_scale: Optional[float] = None,
                             block_q: int = 128, block_k: int = 128,
                             q_block_offset: int = 0):
    """Forward only, returning ``(out, lse)`` for callers that merge
    partial attention across sequence shards (ring attention)."""
    del block_q, block_k
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _flash_forward(q, k, v, float(sm_scale), bool(causal),
                          int(q_block_offset))


def mha_reference(q, k, v, *, causal: bool = False,
                  sm_scale: Optional[float] = None, q_block_offset: int = 0):
    """O(seq^2) reference attention: the plain forward's output."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _dense_forward(q, k, v, sm_scale, causal, q_block_offset)[0]
