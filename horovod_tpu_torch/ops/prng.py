"""The part of ``jax.random`` that the quantized allreduce's noise uses,
in plain PyTorch: threefry2x32, ``PRNGKey``, ``fold_in`` and 8-bit
``bits``, bit for bit as JAX computes them.

Port of ``jax/_src/prng.py`` (``threefry_seed``, ``_threefry2x32_lowering``,
``threefry_fold_in`` and ``_threefry_random_bits_partitionable``, the
default under ``jax_threefry_partitionable=True``), which
horovod_tpu/ops/compression.py:471-586 reaches through ``jax.random``.

A key is a pair of 32-bit words ``(k0, k1)`` held as Python ints.
``bits_u8(key, n)`` is ``uint8(b0 ^ b1)`` where ``(b0, b1)`` is
threefry2x32 of the element's flat index split into its high and low
32-bit words.  The arithmetic runs in int64 masked to 32 bits, since
torch's uint32 has few operations on the CPU; it runs on whichever
device ``device`` names.  The CUDA kernel of ``csrc/quant.cu`` computes
the same words in registers.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 with 20 rounds of the counter words ``(x0, x1)``
    under ``key``: int64 tensors (or Python ints) holding 32-bit values;
    returns the two output words the same way."""
    k0, k1 = int(key[0]) & MASK, int(key[1]) & MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed that fits 32 bits (JAX
    holds it as a 32-bit integer with x64 off, so the high word is 0)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} does not fit 32 bits")
    return (0, seed & MASK)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: threefry of the counter pair
    ``(0, data)`` under ``key``."""
    y0, y1 = threefry2x32(key, 0, int(data) & MASK)
    return (int(y0), int(y1))


def bits_u8(key: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.bits(key, (n,), jnp.uint8)``: [n] uint8."""
    idx = torch.arange(int(n), dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key, idx >> 32, idx & MASK)
    return ((b0 ^ b1) & 0xFF).to(torch.uint8)

