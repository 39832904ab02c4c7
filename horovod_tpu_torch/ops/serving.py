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

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
on the current stream or raises.  Each launch adds one to
``launches[<kernel>]``.  The plain versions are row-invariant on the CPU
too: every product is a loop of fixed ``[16, K] @ [K, N]`` blocks (the
last padded with zero rows), and the attention runs one (batch, head)
and 16 query rows at a time, so each row meets the same library call
whatever the batch and the number of rows (one batched ``torch.matmul``
is not row-invariant on the CPU).  On the card they are the yardstick
``chip_smoke.py`` holds the kernels to, within tolerance (their sums run
in another order).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

KERNELS = ("serving_gemm", "cache_attention")
launches = {name: 0 for name in KERNELS}

# Rows a block of the plain product (and of the kernel's tile).
BLOCK_ROWS = 16

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_SIGNATURES = {
    "hvd_serving_gemm": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "hvd_cache_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _I,
                            _F, _P],
}
_entry_points: dict = {}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


def _entry(symbol: str):
    fn = _entry_points.get(symbol)
    if fn is None:
        fn = getattr(_build.library("serving"), symbol)
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
            f"the serving kernels take tensors all on the CPU (plain "
            f"version) or all on one CUDA device (kernel); got "
            f"{sorted(str(t.device) for t in tensors)}")
    return False


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    launches[name] += 1


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
    whatever the number of rows."""
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"serving_gemm: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    if x.dtype != w.dtype:
        raise ValueError(f"serving_gemm: x is {x.dtype}, w {w.dtype}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if _uses_plain(x, w):
        return serving_gemm_plain(x, w, out_dtype)
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES or (
            x.dtype == torch.float32 and out_dtype != torch.float32):
        raise ValueError(f"serving_gemm takes f32 -> f32 or bf16 -> bf16/"
                         f"f32, got {x.dtype} -> {out_dtype}")
    K, N = w.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K).contiguous()
    w = w.contiguous()
    M = x2.shape[0]
    if M >= 2 ** 31 or max(N, K) >= 2 ** 31:
        raise ValueError(f"serving_gemm: shape {M}x{K}x{N} too large")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    err = _entry("hvd_serving_gemm")(
        x2.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
        _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _check("serving_gemm", err)
    return out.reshape(*lead, N)


# The kernel's dynamic shared memory (hd + cap + 4 floats) stays within
# the H100's 227 KB a block.
MAX_CAPACITY = 56_000


def cache_attention(q: torch.Tensor, k_view: torch.Tensor,
                    v_view: torch.Tensor, q_pos: torch.Tensor) -> torch.Tensor:
    """Masked attention of ``q [b, s, heads, head_dim]`` at global
    positions ``q_pos [b, s]`` against a fixed-capacity view ``k_view``/
    ``v_view [b, capacity, heads, head_dim]`` (entry j holds position j;
    each batch's rows contiguous, the batch axis may be strided): entry j
    takes part in row (b, i) iff ``j <= q_pos[b, i]``; a row whose mask
    is empty (``q_pos < 0``) comes out all zero.  Output in ``q``'s
    dtype."""
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
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"cache_attention takes f32 or bf16, got {q.dtype}")
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
    err = _entry("hvd_cache_attention")(
        q.data_ptr(), k_view.data_ptr(), v_view.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, s, h, cap, hd, k_view.stride(0),
        _DTYPE_CODES[q.dtype], hd ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _check("cache_attention", err)
    return out
