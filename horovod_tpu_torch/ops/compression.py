"""Gradient compression for the allreduce wire (port of
horovod_tpu/ops/compression.py).

Two kinds of compressor, as in the reference:

* **Casts** (``fp16``/``bf16``, reference :105-165): ``compress`` casts a
  floating tensor wider than the wire dtype down for the collective and
  returns the original dtype as its context; ``decompress`` casts back.
  Integer and already-narrow tensors pass through.
* **Quantized wire formats** (``int8``/``int4``, reference :168-239):
  block-scaled integer codes with stochastic rounding and error-feedback
  residuals.  A sum of codes means nothing, so they cannot wrap a
  collective; the executor (:mod:`.megakernel`, through
  :mod:`.collective`) runs the two-phase exchange itself:

      phase 1   each rank splits its vector into n chunks, quantizes
                them block by block and all_to_alls the wire frames
                (int8 codes or packed int4 nibbles, then bf16 scales);
      reduce    each rank dequantizes the n frames it received and sums
                its chunk in float32, in rank order;
      phase 2   the reduced chunk is quantized again, all_gathered as a
                wire frame and dequantized everywhere.

  The residual (what a rank meant to send less what its peers decoded)
  is kept by the executor and added to the next step's contribution.

Selection (reference :369-445): :func:`set_compression` installs regex
rules over tensor names, per-process-set overrides and a default;
``HVD_TPU_COMPRESSION`` is the default's default.

The block primitives below (reference :453-741) are the plain PyTorch
version of the quantized reduction: CPU tensors take them, and the CUDA
kernels of :mod:`.quant` are held to them bit for bit.  Every scale is a
power of two computed with integer arithmetic on the float bits, so
every product and quotient by a scale is exact and the results do not
depend on the order a compiler picks.  The noise is JAX's threefry
(:mod:`.prng`), so the port's bits equal the reference's under the same
seed and tick.
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import prng

# Env contract (reference :94-102): every knob changes what the
# collectives compute, so it must be uniform across ranks; init
# validates them and compares env_fingerprint() across ranks.
DEFAULT_ENV = "HVD_TPU_COMPRESSION"          # default wire compressor
BLOCK_ENV = "HVD_TPU_QUANT_BLOCK"            # scaling-block elements
ROUNDING_ENV = "HVD_TPU_QUANT_ROUNDING"      # stochastic | nearest
EF_ENV = "HVD_TPU_QUANT_ERROR_FEEDBACK"      # 1 (default) | 0
SEED_ENV = "HVD_TPU_QUANT_SEED"              # stochastic-rounding seed
MIN_ELEMS_ENV = "HVD_TPU_QUANT_MIN_ELEMS"    # quantization floor

_DEFAULT_BLOCK = 256
_DEFAULT_MIN_ELEMS = 16


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return getattr(torch, name)


def _dtype_name(dtype) -> str:
    return str(torch_dtype(dtype)).replace("torch.", "")


class Compressor:
    """Interface: ``compress(tensor) -> (tensor, ctx)`` before the wire,
    ``decompress(tensor, ctx)`` after."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """Identity (Horovod's Compression.none)."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype = None  # set by subclasses

    @classmethod
    def compress(cls, tensor):
        dtype = tensor.dtype
        if dtype.is_floating_point and \
                dtype.itemsize > cls.wire_dtype.itemsize:
            return tensor.to(cls.wire_dtype), dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    """float16 wire dtype (Horovod's Compression.fp16): mind its 5-bit
    exponent."""

    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    """bfloat16 wire dtype: float32's exponent range at half the bytes."""

    wire_dtype = torch.bfloat16


class _QuantCompressor(Compressor):
    """Block-wise integer codebook (int8/int4).  It cannot wrap a sum
    collective, so ``compress``/``decompress`` raise naming the API that
    selects it; :meth:`quantize`/:meth:`dequantize` are the standalone
    codec."""

    bits: int = 0  # set by subclasses

    @classmethod
    def compress(cls, tensor):
        raise ValueError(
            f"{cls.__name__} is a wire-level quantized reduction format: "
            f"int codes cannot wrap a sum collective the way fp16/bf16 "
            f"casts do.  Select it with hvd.set_compression(default="
            f"'int{cls.bits}', ...) or HVD_TPU_COMPRESSION=int{cls.bits}; "
            f"the fused executor (ops/megakernel.py) compiles the "
            f"quantization into the reduction itself.")

    decompress = compress

    @classmethod
    def quantize(cls, tensor, *, key=None):
        """Block-wise quantization of ``tensor`` -> ``(wire, ctx)``:
        ``wire`` is ``(codes, scales)``, ``ctx`` what :meth:`dequantize`
        needs.  Round to nearest unless a ``key`` asks for stochastic
        rounding."""
        fmt = wire_format(cls.__name__.replace("Compressor", "").lower())
        flat = tensor.reshape(-1)
        pad = (-flat.shape[0]) % fmt.block
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        use = fmt if key is not None else \
            WireFormat(kind="quant", name=fmt.name, bits=fmt.bits,
                       block=fmt.block, stochastic=False,
                       error_feedback=False)
        q, s = quantize_blocks(flat[None], use, key)
        return (q[0], s[0]), (tensor.dtype, tuple(tensor.shape), use)

    @classmethod
    def dequantize(cls, wire, ctx):
        dtype, shape, fmt = ctx
        q, s = wire
        out = dequantize_blocks(q[None], s[None], fmt)[0]
        return out[:math.prod(shape)].reshape(shape).to(dtype)


class Int8Compressor(_QuantCompressor):
    """8-bit block-scaled codebook: 1 B an element plus a 2 B bf16 scale
    a block."""

    bits = 8


class Int4Compressor(_QuantCompressor):
    """4-bit block-scaled codebook, two codes a wire byte."""

    bits = 4


class Compression:
    """Namespace matching Horovod's ``hvd.Compression``."""

    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    int4 = Int4Compressor


def valid_names() -> Tuple[str, ...]:
    """Every name :func:`resolve` accepts."""
    return tuple(
        n for n in vars(Compression)
        if not n.startswith("_")
        and isinstance(getattr(Compression, n), type)
        and issubclass(getattr(Compression, n), Compressor))


def resolve(name: str):
    """Compressor by env-style name; a typo raises naming every valid
    choice."""
    key = str(name).strip().lower()
    comp = getattr(Compression, key, None)
    if not (isinstance(comp, type) and issubclass(comp, Compressor)):
        raise ValueError(
            f"unknown compressor {name!r}: expected one of "
            f"{', '.join(sorted(valid_names()))}")
    return comp


def wire_dtype_for(name: str, dtype) -> Optional[torch.dtype]:
    """The narrowed wire dtype ``name`` implies for ``dtype``, or None
    when cast compression does not apply."""
    wire = getattr(resolve(name), "wire_dtype", None)
    if wire is None:
        return None
    dt = torch_dtype(dtype)
    if dt.is_floating_point and dt.itemsize > wire.itemsize:
        return wire
    return None


# ---------------------------------------------------------------------------
# Wire formats (reference :294-362)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WireFormat:
    """Everything about one compressor choice that changes what the
    executor computes: part of a bucket's key."""

    kind: str                  # "cast" | "quant"
    name: str                  # registry name ("bf16", "int8", ...)
    bits: int                  # wire bits per element (16 / 8 / 4)
    wire_dtype: str = ""       # cast only: "bfloat16" / "float16"
    block: int = 0             # quant only: scaling-block elements
    stochastic: bool = True    # quant only: stochastic rounding
    error_feedback: bool = True  # quant only: EF residuals


def quant_block() -> int:
    return max(2, int(os.environ.get(BLOCK_ENV, str(_DEFAULT_BLOCK))))


def quant_seed() -> int:
    return int(os.environ.get(SEED_ENV, "0") or 0)


def _rounding() -> str:
    mode = os.environ.get(ROUNDING_ENV, "stochastic").strip().lower()
    if mode not in ("stochastic", "nearest"):
        raise ValueError(
            f"{ROUNDING_ENV}={mode!r}: expected stochastic or nearest")
    return mode


def wire_format(name: str) -> Optional[WireFormat]:
    """The :class:`WireFormat` of compressor ``name`` (None for the
    identity)."""
    comp = resolve(name)
    if comp is NoneCompressor:
        return None
    cast = getattr(comp, "wire_dtype", None)
    if cast is not None:
        return WireFormat(kind="cast", name=name.strip().lower(),
                          bits=8 * cast.itemsize,
                          wire_dtype=_dtype_name(cast),
                          stochastic=False, error_feedback=False)
    return WireFormat(
        kind="quant", name=name.strip().lower(), bits=comp.bits,
        block=quant_block(), stochastic=_rounding() == "stochastic",
        error_feedback=os.environ.get(EF_ENV, "1") != "0")


def wire_format_for(name: str, dtype, numel: int) -> Optional[WireFormat]:
    """``wire_format`` gated by applicability: floating payloads wider
    than the wire format only, and quantization skips tensors under
    ``HVD_TPU_QUANT_MIN_ELEMS`` elements."""
    fmt = wire_format(name)
    if fmt is None:
        return None
    dt = torch_dtype(dtype)
    if not dt.is_floating_point:
        return None
    if fmt.kind == "cast":
        if dt.itemsize * 8 <= fmt.bits:
            return None
        return fmt
    floor = int(os.environ.get(MIN_ELEMS_ENV, str(_DEFAULT_MIN_ELEMS)))
    if numel < max(floor, 1):
        return None
    return fmt


# ---------------------------------------------------------------------------
# Per-tensor / per-process-set selection policy (reference :369-445)
# ---------------------------------------------------------------------------

class CompressionPolicy:
    """Name-pattern -> compressor registry.  Precedence: first matching
    rule > the process set's override > the default.  Every name is
    resolved at construction."""

    def __init__(self, default: Optional[str] = None,
                 rules: Sequence[Tuple[str, str]] = (),
                 process_sets: Optional[Dict[int, str]] = None):
        self.default = (default.strip().lower()
                        if default is not None else None)
        if self.default is not None:
            resolve(self.default)
        self.rules: List[Tuple[re.Pattern, str]] = []
        for pattern, name in rules or ():
            resolve(name)
            self.rules.append((re.compile(pattern), name.strip().lower()))
        self.process_sets = {int(k): v.strip().lower()
                             for k, v in (process_sets or {}).items()}
        for name in self.process_sets.values():
            resolve(name)

    def name_for(self, tensor_name: str, process_set_id: int = 0) -> str:
        for pattern, name in self.rules:
            if pattern.search(tensor_name):
                return name
        if process_set_id in self.process_sets:
            return self.process_sets[process_set_id]
        if self.default is not None:
            return self.default
        return os.environ.get(DEFAULT_ENV, "none")


_policy: Optional[CompressionPolicy] = None


def set_compression(default: Optional[str] = None,
                    rules: Optional[Sequence[Tuple[str, str]]] = None,
                    process_sets: Optional[Dict[int, str]] = None) -> None:
    """Install the process-wide wire-compression policy (no arguments
    restores the env default).  Call it identically on every rank.  It
    flushes the executor's error-feedback residuals and ticks: a residual
    of one codebook means nothing under another."""
    global _policy
    if default is None and not rules and not process_sets:
        _policy = None
    else:
        _policy = CompressionPolicy(default, rules or (), process_sets)
    from . import megakernel as _megakernel

    _megakernel.flush("compression policy change")


def get_compression() -> Optional[CompressionPolicy]:
    return _policy


def policy_name_for(tensor_name: str, process_set_id: int = 0) -> str:
    """The compressor name for one tensor (rules > set override >
    default > env)."""
    p = _policy
    if p is not None:
        return p.name_for(tensor_name, process_set_id)
    return os.environ.get(DEFAULT_ENV, "none")


def policy_format_for(tensor_name: str, process_set_id: int,
                      dtype, numel: int) -> Optional[WireFormat]:
    """Policy lookup and applicability gate: what the executor splits a
    fused response by."""
    return wire_format_for(policy_name_for(tensor_name, process_set_id),
                           dtype, numel)


# ---------------------------------------------------------------------------
# Block-wise quantization primitives (reference :453-606): the plain
# version of csrc/quant.cu, on any device
# ---------------------------------------------------------------------------

def _levels(bits: int) -> int:
    return (1 << (bits - 1)) - 1  # 127 for int8, 7 for int4


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 codes in [-7, 7] two to a byte: the even element in the
    low nibble, +8 offset (last dim must be even)."""
    u = (q.to(torch.int16) + 8).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    lo = (p & 0xF).to(torch.int8) - 8
    hi = (p >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(
        p.shape[:-1] + (p.shape[-1] * 2,))


def _dither(key, shape, device) -> torch.Tensor:
    """The stochastic-rounding dither: uint8 threefry bits / 256, flat
    index over ``shape`` (reference :471)."""
    n = 1
    for d in shape:
        n *= d
    return (prng.bits_u8(key, n, device).reshape(shape).float()
            * (1.0 / 256.0))


def _pow2_scale(amax: torch.Tensor, bits: int) -> torch.Tensor:
    """The smallest power of two ``s`` with ``amax <= levels * s``, by
    integer arithmetic on the float bits (reference :481-507): the
    exponent field clipped to [1, 254], 0 for an all-zero block."""
    a = amax.float().contiguous().view(torch.int32).to(torch.int64) \
        & prng.MASK
    e = (a >> 23) - 127
    m_field = a & 0x7FFFFF
    if bits == 8:
        base, thresh = 6, int(0.984375 * (1 << 23))
    else:
        base, thresh = 2, int(0.75 * (1 << 23))
    p = e - base + (m_field > thresh).to(torch.int64)
    pe = torch.clamp(p + 127, 1, 254)
    scale = (pe << 23).to(torch.int32).view(torch.float32)
    return torch.where(amax > 0, scale, torch.zeros_like(scale))


def quantize_blocks(rows: torch.Tensor, fmt: WireFormat, key=None):
    """Quantize ``rows[..., m]`` (m % fmt.block == 0) block by block ->
    ``(codes, scales)``: int8 codes (uint8 nibble pairs for int4) and one
    bf16 power-of-two scale a block.  ``floor(x + u)`` with the threefry
    dither when stochastic (``key`` then required), else
    ``floor(x + 1/2)``."""
    lead, m = tuple(rows.shape[:-1]), rows.shape[-1]
    lv = float(_levels(fmt.bits))
    b = rows.float().reshape(lead + (m // fmt.block, fmt.block))
    scale = _pow2_scale(b.abs().amax(dim=-1), fmt.bits)
    x = b / torch.where(scale > 0, scale,
                        torch.ones_like(scale))[..., None]
    if fmt.stochastic:
        x = torch.floor(x + _dither(key, x.shape, x.device))
    else:
        x = torch.floor(x + 0.5)
    q = torch.clamp(x, -lv, lv).to(torch.int8).reshape(lead + (m,))
    if fmt.bits == 4:
        q = pack_int4(q)
    return q, scale.to(torch.bfloat16)


def dequantize_blocks(wire: torch.Tensor, scales: torch.Tensor,
                      fmt: WireFormat) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks`, in float32."""
    q = unpack_int4(wire) if fmt.bits == 4 else wire
    lead, m = tuple(q.shape[:-1]), q.shape[-1]
    b = q.float().reshape(lead + (m // fmt.block, fmt.block))
    return (b * scales.float()[..., None]).reshape(lead + (m,))


def wire_bytes_per_chunk(m: int, fmt: WireFormat) -> int:
    """Bytes of one m-element chunk's frame: codes, then bf16 scales."""
    return m * fmt.bits // 8 + (m // fmt.block) * 2


def wire_pack(q: torch.Tensor, s: torch.Tensor,
              fmt: WireFormat) -> torch.Tensor:
    """One uint8 frame per row: the codes, then the scales' bytes
    (little-endian bf16), so one collective moves both."""
    qb = q if fmt.bits == 4 else q.contiguous().view(torch.uint8)
    sb = s.contiguous().view(torch.uint8)
    return torch.cat([qb, sb], dim=-1)


def wire_unpack(w: torch.Tensor, m: int, fmt: WireFormat):
    """Split a :func:`wire_pack` frame into ``(codes, scales)``."""
    q_len = m * fmt.bits // 8
    n_blocks = m // fmt.block
    qb = w[..., :q_len]
    q = qb if fmt.bits == 4 else qb.contiguous().view(torch.int8)
    s = w[..., q_len:q_len + 2 * n_blocks].contiguous().view(torch.bfloat16)
    return q, s


def step_key(seed: int, tick: int):
    """The per-step root of every stochastic-rounding draw (reference
    :575): ``fold_in(PRNGKey(seed), tick)``, so a fixed seed and the
    bucket's tick give reproducible noise."""
    return prng.fold_in(prng.prng_key(seed), tick)


def _noise_key(key, tag: int, pos: int):
    """Leg and participant key (reference :583): ``tag`` separates phases
    and legs, ``pos`` decorrelates participants."""
    return prng.fold_in(prng.fold_in(key, tag), pos)


def padded_length(T: int, n: int, block: int) -> int:
    """T rounded up so each of the n exchange chunks is a whole number
    of scaling blocks."""
    unit = n * block
    return -(-T // unit) * unit


def ordered_sum(rows: torch.Tensor) -> torch.Tensor:
    """``rows[0] + rows[1] + ...`` in that order (reference :596)."""
    acc = rows[0]
    for i in range(1, rows.shape[0]):
        acc = acc + rows[i]
    return acc


def reference_allreduce(rows, fmt: WireFormat, tick: int, *,
                        seed: Optional[int] = None, residuals=None,
                        shared_noise: bool = False):
    """The quantized allreduce computed from the stacked per-rank rows
    (reference :694-741): ``rows`` [n, T] (row i = rank i's
    contribution), ``residuals`` [n, T] or None.  Returns ``(reduced [T]
    rows.dtype, new_residuals [n, T] | None)``; ``reduced`` is the SUM
    every rank decodes, bit for bit what the executor gives under the
    same (seed, tick)."""
    rows = torch.as_tensor(rows)
    n, T = rows.shape
    dtype = rows.dtype
    Tp = padded_length(T, n, fmt.block)
    vin = rows if residuals is None else rows + torch.as_tensor(residuals)
    if Tp != T:
        vin = F.pad(vin, (0, Tp - T))
    C = Tp // n
    key = step_key(quant_seed() if seed is None else seed, tick)
    ef = fmt.error_feedback
    phase2 = ef and not shared_noise
    deq = torch.stack([dequantize_blocks(*quantize_blocks(
        vin[i].reshape(n, C), fmt,
        _noise_key(key, 1, 0 if shared_noise else i)), fmt)
        for i in range(n)])                        # [contrib, chunk, C]
    red = ordered_sum(deq)                         # [chunk, C] float32
    deq2 = torch.stack([dequantize_blocks(*quantize_blocks(
        red[d][None], fmt, _noise_key(key, 2, d)), fmt)[0]
        for d in range(n)])
    out = deq2.reshape(-1)[:T].to(dtype)
    r_new = None
    if ef:
        r_new = vin - deq.reshape(n, Tp).to(dtype)
        if phase2:
            e2 = (red - deq2).to(dtype)
            for i in range(n):
                r_new[i, i * C:(i + 1) * C] = \
                    r_new[i, i * C:(i + 1) * C] + e2[i]
        r_new = r_new[:, :T]
    return out, r_new


# ---------------------------------------------------------------------------
# Init-time validation (reference :748-810), the knobs the port reads
# ---------------------------------------------------------------------------

_SPMD_ENV_KNOBS = (
    DEFAULT_ENV, "HVD_TPU_DCN_COMPRESS", "HVD_TPU_ICI_COMPRESS",
    BLOCK_ENV, ROUNDING_ENV, EF_ENV, SEED_ENV, MIN_ELEMS_ENV,
    "HVD_TPU_HIERARCHICAL", "HVD_TPU_VIRTUAL_SLICES",
    # The reference's executor switch: the port has one executor and
    # reads no value, but the HELLO names the reference's knobs in its
    # order, so a rank set apart from the others is still named.
    "HVD_TPU_MEGAKERNEL",
    # parallel/overlap.py: which step a rank runs (the monolithic one, or
    # bucketed collectives the other ranks must match).
    "HVD_TPU_OVERLAP",
    # parallel/pipeline.py: the schedule decides the order in which a
    # rank dispatches its per-stage buckets; ranks in different orders
    # would desynchronize the per-stage negotiation.
    "HVD_TPU_PIPELINE_SCHEDULE", "HVD_TPU_PIPELINE_INTERLEAVE",
    # ops/tree.py: who connects to whom and which frames flow; a rank
    # that differs would deadlock the handshake.
    "HVD_TPU_TREE", "HVD_TPU_TREE_FANOUT", "HVD_TPU_TREE_THRESHOLD",
    # ops/fused.py: a rank with another chunk plan issues other
    # collectives.
    "HVD_TPU_FUSE", "HVD_TPU_FUSE_CHUNKS",
)


def validate_env() -> None:
    """Fail init, not the first collective, on a malformed compression
    knob, with the valid names in the error."""
    for knob in (DEFAULT_ENV, "HVD_TPU_DCN_COMPRESS",
                 "HVD_TPU_ICI_COMPRESS"):
        value = os.environ.get(knob)
        if value:
            try:
                resolve(value)
            except ValueError as e:
                raise ValueError(f"{knob}={value!r}: {e}") from None
    _rounding()
    for knob in (BLOCK_ENV, SEED_ENV, MIN_ELEMS_ENV):
        value = os.environ.get(knob)
        if value:
            try:
                int(value)
            except ValueError:
                raise ValueError(
                    f"{knob}={value!r}: expected an integer") from None
    block = quant_block()
    if block % 2:
        raise ValueError(f"{BLOCK_ENV}={block}: the int4 nibble packing "
                         f"needs an even block size")


def env_fingerprint() -> str:
    """``knob=value;...`` of every knob above (unset is ``<unset>``):
    init compares it across ranks."""
    return ";".join(f"{knob}={os.environ.get(knob, '') or '<unset>'}"
                    for knob in _SPMD_ENV_KNOBS)
