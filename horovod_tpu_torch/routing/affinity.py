"""The prompt-header chain-hash scheme: a copy of horovod_tpu/routing/
affinity.py (which imports no JAX), so the port depends on nothing of the
JAX package.

The replica's shared-prefix index (``serving/kv_cache.py``) keys its
pages with :func:`chain_hashes`, and a router derives the same keys from
a prompt (:func:`prompt_header_hashes`): a page-aligned chain hash,
``h = sha256(fingerprint)`` absorbing each page's token ids as
little-endian int32 bytes and emitting its digest, so ``h_j`` commits to
the model fingerprint and every token of pages ``0..j``.  After a
completed dispatch the router adds :func:`published_page_hashes` (the
keys ``PagedKVCache.publish_prefix`` writes) to its model of the replica's
index.  The keys are byte-identical to the reference's
(tests/test_torch_serving.py and tests/test_torch_routing.py hold them
so).
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


def published_page_hashes(fingerprint: bytes, tokens: Sequence[int],
                          page_size: int,
                          pages_per_slot: int) -> List[str]:
    """Hex chain hashes of the pages a replica PUBLISHES after fully
    prefilling ``tokens`` (``PagedKVCache.publish_prefix``'s key set:
    every page entirely covered by the prompt, NOT the strict-prefix
    bound) — what the router adds to its model of a replica's index
    after a completed dispatch."""
    n_full = min(len(tokens) // int(page_size), int(pages_per_slot))
    if n_full <= 0:
        return []
    return [d.hex() for d in chain_hashes(fingerprint, tokens,
                                          page_size, n_full)]
