"""The serving path's two kernels: wrappers over ``csrc/serving.cu``, with
their plain PyTorch versions.

The reference runs no Pallas kernel on its serving path
(horovod_tpu/models/transformer.py :444-659): its products and its
masked-softmax attention are jnp that XLA compiles, and its contract is
bitwise (a prefill plus N one-token decodes gives the non-incremental
forward's logits, row for row).  A library GEMM chooses its kernel, and
whether to split K, by shape, so row i of ``x[:M] @ W`` changes bits
with M; these kernels sum in one order that does not depend on M or the
batch:

===================  ==================================================
``serving_gemm``     every ``jnp.dot`` of ``forward_step``: the fused
                     QKV, ``wo``, ``w_in``, ``w_out`` (:556, :564,
                     :210, :213) and the f32 logits (:570)
``cache_attention``  ``cache_attention`` (:458-493)
===================  ==================================================

Each kernel has two forms.  The Hopper form (``"sm90"``: TMA and
``wgmma``, ``csrc/serving_gemm_sm90.cuh`` and
``csrc/cache_attention_sm90.cuh``) takes bf16; the first form
(``"first"``, ``csrc/serving.cu``) takes the rest, f32 included.
:func:`serving_gemm_form` chooses from ``(dtype, K, N)`` and
:func:`cache_attention_form` from ``(dtype, head_dim)``: never from the
number of rows or the batch, so a row meets the same arithmetic in a
prefill and in a decode.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
on the current stream or raises.  Each launch adds one to
``launches[<kernel>]`` and to ``launches_by_form[(<kernel>, <form>)]``
(a split-K product is one kernel too: its K ranges are the blocks of one
cluster, which add their partial sums among themselves).  The plain versions are row-invariant on the CPU too: every
product is a loop of fixed ``[16, K] @ [K, N]`` blocks (the last padded
with zero rows), and the attention runs one (batch, head) and 16 query
rows at a time, so each row meets the same library call whatever the
batch and the number of rows (one batched ``torch.matmul`` is not
row-invariant on the CPU).  On the card they are the yardstick
``chip_smoke.py`` holds the kernels to, within tolerance (their sums run
in another order).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

KERNELS = ("serving_gemm", "cache_attention")
FORMS = ("sm90", "first")
launches = {name: 0 for name in KERNELS}
launches_by_form = {(name, form): 0 for name in KERNELS for form in FORMS}

# Rows a block of the plain product (and of the kernel's tile).
BLOCK_ROWS = 16

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_SIGNATURES = {
    "hvd_serving_gemm_first": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "hvd_serving_gemm_sm90": [_P, _L, _P, _L, _P, _I, _I, _I, _I, _I, _I,
                              _P],
    "hvd_cache_attention_first": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                  _L, _I, _F, _P],
    "hvd_cache_attention_sm90": [_P, _L, _L, _L, _P, _L, _L, _L, _P, _L, _L,
                                 _L, _P, _P, _I, _I, _I, _I, _I, _F, _P],
}
_entry_points: dict = {}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0
    for key in launches_by_form:
        launches_by_form[key] = 0


def _entry(symbol: str):
    fn = _entry_points.get(symbol)
    if fn is None:
        fn = getattr(_build.library("serving"), symbol)
        fn.argtypes = _SIGNATURES[symbol]
        fn.restype = ctypes.c_int
        _entry_points[symbol] = fn
    return fn


def _uses_plain(*tensors) -> bool:
    """True for CPU tensors; False for CUDA tensors; raises otherwise.
    The CUDA test reads integers, not device objects: a decode pays it
    each launch."""
    first = tensors[0]
    if first.is_cuda:
        dev = first.get_device()
        if all(t.is_cuda and t.get_device() == dev for t in tensors[1:]):
            return False
    elif all(t.device.type == "cpu" for t in tensors):
        return True
    raise ValueError(
        f"the serving kernels take tensors all on the CPU (plain "
        f"version) or all on one CUDA device (kernel); got "
        f"{sorted(str(t.device) for t in tensors)}")


def _stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a handle."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _check(name: str, form: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} ({form} form) kernel launch failed: "
                           f"cudaError_t {err}")
    launches[name] += 1
    launches_by_form[(name, form)] += 1


# ---------------------------------------------------------------------------
# The forms
# ---------------------------------------------------------------------------

# The Hopper GEMM's tiles: 64 rows, 64 or 128 columns, 64-deep k tiles.
GEMM_TILE_K = 64
# N from which it takes 128-column tiles (one n128 wgmma reads x's tile
# once for twice the columns); narrower products keep 64.
GEMM_WIDE_N = 2048
# 64-column tiles x K ranges it aims for where K is long enough (at M 16
# one row tile: enough blocks to stream w at the card's rate).
GEMM_SPLIT_BLOCKS = 48
# k tiles each K range keeps at least (512 deep): only a long K splits.
GEMM_SPLIT_MIN_K_TILES = 8
# K ranges at most: the blocks of a cluster (the portable cluster size).
GEMM_SPLIT_MAX = 8
ATTENTION_HEAD_DIMS = (64, 128)


@functools.lru_cache(maxsize=None)
def serving_gemm_form(dtype: torch.dtype, K: int, N: int):
    """``(form, tile_n, split)`` of ``serving_gemm`` for ``x [M, K] @ w
    [K, N]`` of ``dtype``: the Hopper form for bf16 with K and N multiples
    of 8 (the tensor maps' 16-byte strides), with output tiles ``tile_n``
    columns wide and ``split`` fixed K ranges; the first form otherwise
    (``tile_n`` 0, split 1).  M is not an argument: a row's arithmetic may
    not depend on how many rows share the call.  Cached: a decode asks
    for the same few widths each launch."""
    if dtype != torch.bfloat16 or K < 1 or N < 1 or K % 8 or N % 8:
        return "first", 0, 1
    tile_n = 128 if N >= GEMM_WIDE_N and N % 128 == 0 else 64
    k_tiles = -(-K // GEMM_TILE_K)
    split = min(k_tiles // GEMM_SPLIT_MIN_K_TILES,
                GEMM_SPLIT_BLOCKS // -(-N // 64), GEMM_SPLIT_MAX)
    return "sm90", tile_n, max(1, split)


@functools.lru_cache(maxsize=None)
def cache_attention_form(dtype: torch.dtype, head_dim: int) -> str:
    """The form of ``cache_attention`` for ``dtype`` at ``head_dim``: the
    Hopper form for bf16 at head_dim 64 or 128, the first form otherwise.
    The batch, the number of query rows and the capacity are not
    arguments."""
    if dtype == torch.bfloat16 and head_dim in ATTENTION_HEAD_DIMS:
        return "sm90"
    return "first"


def _tma_rows(t: torch.Tensor):
    """``(t, row stride)`` for a 2-D GEMM operand: ``t`` itself if a
    tensor map can read it in place (unit column stride, rows a multiple
    of 8 elements apart and no closer than a row, 16-byte aligned), else
    a contiguous copy, which can.  The routing makes the row width a
    multiple of 8."""
    rows, cols = t.shape
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t, cols
    ld = t.stride(0) if rows > 1 else cols
    if t.stride(1) == 1 and ld % 8 == 0 and ld >= cols and \
            t.data_ptr() % 16 == 0:
        return t, ld
    return t.clone(memory_format=torch.contiguous_format), cols


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if a 4-D tensor map can describe it (unit last stride,
    the others multiples of 8 elements, 16-byte aligned), else a
    contiguous copy, which can.  The attention's strides go to the
    kernel; the routing makes the last dimension a multiple of 8, so a
    contiguous ``t`` needs only the alignment test."""
    if t.data_ptr() % 16 == 0 and (t.is_contiguous() or (
            t.stride(-1) == 1
            and all(st % 8 == 0 for st in t.stride()[:-1]))):
        return t
    return t.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _block_rows(x: torch.Tensor, w32: torch.Tensor) -> torch.Tensor:
    """f32 ``x [M, K] @ w32 [K, N]`` as a loop of ``[16, K] @ [K, N]``
    products, each block a fresh zero-padded f32 tensor (so every call is
    the same shape at the same alignment)."""
    M, K = x.shape
    out = torch.empty((M, w32.shape[1]), dtype=torch.float32,
                      device=x.device)
    for i in range(0, M, BLOCK_ROWS):
        n = min(BLOCK_ROWS, M - i)
        blk = torch.zeros((BLOCK_ROWS, K), dtype=torch.float32,
                          device=x.device)
        blk[:n] = x[i:i + n]
        out[i:i + n] = (blk @ w32)[:n]
    return out


def serving_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                       out_dtype=None) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` in f32, rounded once to ``out_dtype``
    (default ``x``'s dtype)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    lead = x.shape[:-1]
    out = _block_rows(x.reshape(-1, x.shape[-1]), w.float())
    return out.to(out_dtype).reshape(*lead, w.shape[1])


def cache_attention_plain(q: torch.Tensor, k_view: torch.Tensor,
                          v_view: torch.Tensor,
                          q_pos: torch.Tensor) -> torch.Tensor:
    """The reference's formula (transformer.py :458-493), one (batch,
    head) and 16 query rows at a time: f32 scores scaled by
    ``hd ** -0.5``, the mask ``j <= q_pos``, the guarded max and
    denominator, ``p @ v`` in f32 over the capacity, cast to ``q``'s
    dtype."""
    b, s, h, hd = q.shape
    cap = k_view.shape[1]
    scale = hd ** -0.5
    kv_pos = torch.arange(cap, device=q.device)
    out = torch.empty((b, s, h, hd), dtype=torch.float32, device=q.device)
    qf, kf, vf = q.float(), k_view.float(), v_view.float()
    for bi in range(b):
        for i in range(0, s, BLOCK_ROWS):
            n = min(BLOCK_ROWS, s - i)
            pos = torch.full((BLOCK_ROWS,), -1, dtype=torch.long,
                             device=q.device)
            pos[:n] = q_pos[bi, i:i + n]
            mask = kv_pos[None, :] <= pos[:, None]
            for hi in range(h):
                qb = torch.zeros((BLOCK_ROWS, hd), dtype=torch.float32,
                                 device=q.device)
                qb[:n] = qf[bi, i:i + n, hi]
                scores = (qb @ kf[bi, :, hi].t()) * scale
                scores = torch.where(mask, scores, float("-inf"))
                m = scores.amax(dim=-1, keepdim=True)
                m = torch.where(torch.isfinite(m), m, 0.0)
                p = torch.exp(scores - m)
                denom = p.sum(dim=-1, keepdim=True)
                denom = torch.where(denom == 0.0, 1.0, denom)
                out[bi, i:i + n, hi] = ((p / denom) @ vf[bi, :, hi])[:n]
    return out.to(q.dtype)


# Elements a piece of the CPU GELU: below ATen's parallel grain (32768), so
# each piece runs in one thread, its vector loop unbroken.
_GELU_PIECE = 16384


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``F.gelu(x, approximate="tanh")`` (``jax.nn.gelu``'s default), row
    invariant on the CPU too.  On the card every element runs the same
    function.  On the CPU ATen splits a large elementwise op across
    threads and each thread's last few elements take a scalar ``tanh``
    whose bits differ from the vectorized one, so a row's bits would
    depend on the number of rows; here the flat tensor goes in pieces of
    16,384 elements, each in one thread, so every element takes the
    vector path when the row width is a multiple of 32."""
    if x.device.type != "cpu":
        return torch.nn.functional.gelu(x, approximate="tanh")
    flat = x.reshape(-1)
    out = torch.empty_like(flat)
    for i in range(0, flat.numel(), _GELU_PIECE):
        out[i:i + _GELU_PIECE] = torch.nn.functional.gelu(
            flat[i:i + _GELU_PIECE], approximate="tanh")
    return out.reshape(x.shape)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def serving_gemm(x: torch.Tensor, w: torch.Tensor,
                 out_dtype=None) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` with f32 accumulation, rounded once to
    ``out_dtype`` (default ``x``'s dtype; f32 for the logits, which need
    no f32 copy of a bf16 ``w``).  Row i of the result has the same bits
    whatever the number of rows.  On CUDA tensors it launches the form
    :func:`serving_gemm_form` chooses."""
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"serving_gemm: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    if x.dtype != w.dtype:
        raise ValueError(f"serving_gemm: x is {x.dtype}, w {w.dtype}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if _uses_plain(x, w):
        return serving_gemm_plain(x, w, out_dtype)
    K, N = w.shape
    form, tile_n, split = serving_gemm_form(x.dtype, K, N)
    if form == "first":
        return _first_form_gemm(x, w, out_dtype)
    return _sm90_gemm(x, w, out_dtype, tile_n, split)


def _sm90_gemm(x: torch.Tensor, w: torch.Tensor, out_dtype, tile_n: int,
               split: int) -> torch.Tensor:
    """The Hopper form on CUDA tensors, at :func:`serving_gemm_form`'s
    ``tile_n`` and ``split`` for bf16 ``x`` and ``w``."""
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"serving_gemm takes bf16 -> bf16/f32, got "
                         f"{x.dtype} -> {out_dtype}")
    K, N = w.shape
    x2, ldx = _tma_rows(x.reshape(-1, K))
    w, ldw = _tma_rows(w)
    M = x2.shape[0]
    if M >= 2 ** 31:
        raise ValueError(f"serving_gemm: shape {M}x{K}x{N} too large")
    out = torch.empty(x.shape[:-1] + (N,), dtype=out_dtype, device=x.device)
    err = _entry("hvd_serving_gemm_sm90")(
        x2.data_ptr(), ldx, w.data_ptr(), ldw, out.data_ptr(), M, N, K,
        _DTYPE_CODES[out_dtype], tile_n, split, _stream(x))
    _check("serving_gemm", "sm90", err)
    return out


def _first_form_gemm(x: torch.Tensor, w: torch.Tensor,
                     out_dtype) -> torch.Tensor:
    """The first form on CUDA tensors: :func:`serving_gemm`'s route for
    what the Hopper form does not take (f32, widths not multiples of 8).
    ``chip_smoke.py`` and the tests also call it on bf16 to hold the
    first form's bf16 build against the Hopper form on the same inputs;
    no caller on the serving path does."""
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES or (
            x.dtype == torch.float32 and out_dtype != torch.float32):
        raise ValueError(f"serving_gemm takes f32 -> f32 or bf16 -> bf16/"
                         f"f32, got {x.dtype} -> {out_dtype}")
    K, N = w.shape
    x2, w = x.reshape(-1, K).contiguous(), w.contiguous()
    M = x2.shape[0]
    if M >= 2 ** 31 or max(N, K) >= 2 ** 31:
        raise ValueError(f"serving_gemm: shape {M}x{K}x{N} too large")
    out = torch.empty(x.shape[:-1] + (N,), dtype=out_dtype, device=x.device)
    err = _entry("hvd_serving_gemm_first")(
        x2.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype],
        _stream(x))
    _check("serving_gemm", "first", err)
    return out


# The first form's dynamic shared memory (hd + cap + 4 floats) stays
# within the H100's 227 KB a block; the Hopper form has no such limit.
MAX_CAPACITY = 56_000


def cache_attention(q: torch.Tensor, k_view: torch.Tensor,
                    v_view: torch.Tensor, q_pos: torch.Tensor) -> torch.Tensor:
    """Masked attention of ``q [b, s, heads, head_dim]`` at global
    positions ``q_pos [b, s]`` against a fixed-capacity view ``k_view``/
    ``v_view [b, capacity, heads, head_dim]`` (entry j holds position j;
    each batch's rows contiguous, the batch axis may be strided): entry j
    takes part in row (b, i) iff ``j <= q_pos[b, i]``; a row whose mask
    is empty (``q_pos < 0``) comes out all zero.  Output in ``q``'s
    dtype.  On CUDA tensors it launches the form
    :func:`cache_attention_form` chooses."""
    b, s, h, hd = q.shape
    if (k_view.dim() != 4 or k_view.shape[0] != b or k_view.shape[2:]
            != (h, hd) or v_view.shape != k_view.shape
            or tuple(q_pos.shape) != (b, s)):
        raise ValueError(f"cache_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k_view.shape)}, v {tuple(v_view.shape)}, "
                         f"q_pos {tuple(q_pos.shape)} do not agree")
    if not (q.dtype == k_view.dtype == v_view.dtype):
        raise ValueError("cache_attention: q, k and v must share a dtype")
    if _uses_plain(q, k_view, v_view, q_pos):
        return cache_attention_plain(q, k_view, v_view, q_pos)
    if cache_attention_form(q.dtype, hd) == "first":
        return _first_form_attention(q, k_view, v_view, q_pos)
    return _sm90_attention(q, k_view, v_view, q_pos)


def _sm90_attention(q: torch.Tensor, k_view: torch.Tensor,
                    v_view: torch.Tensor,
                    q_pos: torch.Tensor) -> torch.Tensor:
    """The Hopper form on CUDA tensors: bf16 at head_dim 64 or 128, the
    views read through their own strides."""
    b, s, h, hd = q.shape
    # int64 positions as forward_step makes them: no cast launch.
    pos = q_pos.to(torch.int64).contiguous()
    q, k_view, v_view = (_tma_ready(q), _tma_ready(k_view),
                         _tma_ready(v_view))
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    err = _entry("hvd_cache_attention_sm90")(
        q.data_ptr(), *q.stride()[:3], k_view.data_ptr(),
        *k_view.stride()[:3], v_view.data_ptr(), *v_view.stride()[:3],
        pos.data_ptr(), out.data_ptr(), b, s, h, k_view.shape[1], hd,
        hd ** -0.5, _stream(q))
    _check("cache_attention", "sm90", err)
    return out


def _first_form_attention(q: torch.Tensor, k_view: torch.Tensor,
                          v_view: torch.Tensor,
                          q_pos: torch.Tensor) -> torch.Tensor:
    """The first form on CUDA tensors: :func:`cache_attention`'s route
    for f32 and other head dims, and, as :func:`_first_form_gemm`, the
    bf16 build ``chip_smoke.py`` and the tests time and check beside the
    Hopper form."""
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"cache_attention takes f32 or bf16, got {q.dtype}")
    b, s, h, hd = q.shape
    cap = k_view.shape[1]
    if cap > MAX_CAPACITY:
        raise ValueError(f"cache_attention: capacity {cap} exceeds "
                         f"{MAX_CAPACITY}")
    row = h * hd
    if k_view.stride()[1:] != (row, hd, 1):
        k_view = k_view.contiguous()
    if v_view.stride()[1:] != (row, hd, 1):
        v_view = v_view.contiguous()
    if k_view.stride(0) != v_view.stride(0):
        k_view, v_view = k_view.contiguous(), v_view.contiguous()
    q = q.contiguous()
    pos = q_pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    err = _entry("hvd_cache_attention_first")(
        q.data_ptr(), k_view.data_ptr(), v_view.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, s, h, cap, hd, k_view.stride(0),
        _DTYPE_CODES[q.dtype], hd ** -0.5,
        _stream(q))
    _check("cache_attention", "first", err)
    return out
