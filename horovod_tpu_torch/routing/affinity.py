"""The prompt-header chain-hash scheme: a copy of ``chain_hashes`` and
``prompt_header_hashes`` from horovod_tpu/routing/affinity.py (which
imports no JAX), so the port depends on nothing of the JAX package.

The replica's shared-prefix index (``serving/kv_cache.py``) keys its
pages with :func:`chain_hashes`, and a router derives the same keys from
a prompt (:func:`prompt_header_hashes`): a page-aligned chain hash,
``h = sha256(fingerprint)`` absorbing each page's token ids as
little-endian int32 bytes and emitting its digest, so ``h_j`` commits to
the model fingerprint and every token of pages ``0..j``.  The keys are
byte-identical to the reference's (tests/test_torch_serving.py holds
them so).  The rest of the routing tier waits for ROADMAP.md A.5.6.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence

import numpy as np


def chain_hashes(fingerprint: bytes, tokens: Sequence[int],
                 page_size: int, n_pages: int) -> List[bytes]:
    """Chain hash per page boundary over ``tokens[:n_pages *
    page_size]`` — the index keys of ``PagedKVCache`` (which delegates
    its ``_chain_hashes`` here)."""
    h = hashlib.sha256(fingerprint)
    out: List[bytes] = []
    ps = int(page_size)
    for j in range(n_pages):
        h.update(np.asarray(tokens[j * ps:(j + 1) * ps],
                            np.int32).tobytes())
        out.append(h.digest())
    return out


def prompt_header_hashes(fingerprint: bytes, tokens: Sequence[int],
                         page_size: int,
                         pages_per_slot: int) -> List[str]:
    """Hex chain hashes of a prompt's page-aligned STRICT-prefix header
    — the router-side mirror of ``PagedKVCache.lookup_prefix``'s key
    sequence (same ``min((len - 1) // page_size, pages_per_slot)``
    bound: at least one suffix token always remains for the replica to
    prefill)."""
    if not tokens:
        return []
    max_pages = min((len(tokens) - 1) // int(page_size),
                    int(pages_per_slot))
    if max_pages <= 0:
        return []
    return [d.hex() for d in chain_hashes(fingerprint, tokens,
                                          page_size, max_pages)]
