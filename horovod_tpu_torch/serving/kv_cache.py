"""Paged KV cache: fixed-size pages, free-list recycling, a shared-prefix
index (port of horovod_tpu/serving/kv_cache.py).

Storage is two tensors per engine, ``k_pages``/``v_pages: [n_layers,
n_pages, page_size, n_heads, head_dim]`` on the engine's device (``cuda``
unless asked for the CPU), plus a host page table (``[max_slots,
pages_per_slot]`` int32, numpy) mapping each decode slot's logical
positions onto physical pages.  Pages are allocated as a sequence grows
and recycled through a free list the moment the scheduler evicts it, so
slot reuse never copies or zeroes KV data: the old values become
unreachable, masked by :func:`..models.transformer.cache_attention`.
The engine writes new entries in place (:meth:`PagedKVCache.write`, an
indexed assignment into the pool) and reads a slot's logical view
through :meth:`PagedKVCache.gather_views`; nothing copies the pool.

Page 0 is the reserved *trash* page: unmapped table entries point at it,
so scatters of padded or inactive positions land somewhere harmless.
Nothing reads trash through an unmasked attention row (entry ``j`` is
unmasked only for ``j <= q_pos < length``, and every position below
``length`` is mapped); written values are finite, so masked entries
contribute exact zeros.

**Shared-prefix page cache**: completed prompt-prefix pages are indexed
by a page-aligned chain hash over the token ids keyed by the engine's
model fingerprint (:func:`..routing.affinity.chain_hashes`), refcounted
and read-only.  A request whose prompt extends a cached prefix maps
those pages into its table copy-free and prefills only the suffix.
Shared pages are never written and never freed while referenced; a page
whose count reaches zero parks in an LRU of reclaimable pages, still
hittable, recycled only when the free list runs dry.  Ghost rows
(:meth:`PagedKVCache.alloc_ghost`) let ``seed_prefixes`` prefill a
prefix without a decode slot.

Waiting for later work: sharding the head axis over a ``model`` mesh
axis (ROADMAP.md A.4, later), the memory ledger and planner, the live
retune of the index's size (the reference's ``set_prefix_target``, with
tuning actuation), the lock-order and race-checker hooks (ROADMAP.md
A.5; a plain ``threading.Lock`` here).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..routing.affinity import chain_hashes as _chain_hash_scheme

# Free-page headroom beside serving.batch_occupancy: a router dispatches
# on how much KV room a replica has left, not only on its queue.  Set
# under the cache lock at every page-management transition, so /healthz
# reads it current.
_M_KV_FREE = _telemetry.gauge(
    "serving.kv_free_pages",
    "KV pages available for allocation: free list + reclaimable "
    "prefix-cache pages (admission headroom)")
_M_KV_TOTAL = _telemetry.gauge(
    "serving.kv_total_pages",
    "allocatable KV pages (capacity; excludes the trash page)")
_M_KV_RECLAIM = _telemetry.gauge(
    "serving.kv_reclaimable_pages",
    "unreferenced prefix-cache pages (reclaimed LRU-first when the "
    "free list runs dry; counted inside kv_free_pages)")
_M_PREFIX_CACHED = _telemetry.gauge(
    "serving.prefix_cached_pages",
    "pages currently held by the shared-prefix index (referenced + "
    "reclaimable)")
_M_PREFIX_HITS = _telemetry.counter(
    "serving.prefix_hits",
    "admissions that mapped at least one cached prefix page copy-free")
_M_PREFIX_PAGES = _telemetry.counter(
    "serving.prefix_pages_shared",
    "cached prefix pages mapped into admitted slots (copy-free)")
_M_PREFIX_BYTES = _telemetry.counter(
    "serving.prefix_bytes_saved",
    "KV bytes NOT recomputed thanks to prefix-cache hits (global "
    "logical bytes of the shared pages)")
_M_PREFIX_HITS_DRAFT = _telemetry.counter(
    "serving.prefix_hits_draft",
    "admissions whose speculative DRAFT prefill mapped cached prefix "
    "pages copy-free (the target's hits stay in serving.prefix_hits)")


class PagedKVCache:
    """The paged store for one :class:`~.engine.InferenceEngine`.

    The host-side bookkeeping (page table, lengths, free list) is
    guarded by an internal lock: the serve loop mutates it every
    iteration, and the engine's drain family (``_free_all_slots``) may
    run concurrently from another thread; ``free_slot`` is idempotent
    and ``advance`` is a no-op on a freed slot, so an eviction racing
    the loop can never double-free a page or resurrect a slot.  The
    page tensors have one writer, the serve loop."""

    def __init__(self, n_layers: int, n_heads: int, head_dim: int,
                 max_slots: int, pages_per_slot: int, page_size: int,
                 dtype=torch.float32, device="cuda",
                 prefix_cache: bool = False, prefix_pages: int = 0,
                 fingerprint: str = "", gauges: bool = True) -> None:
        if pages_per_slot < 1 or page_size < 1:
            raise ValueError("pages_per_slot and page_size must be >= 1")
        if prefix_pages < 0:
            raise ValueError(f"prefix_pages must be >= 0, got "
                             f"{prefix_pages}")
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.head_dim = head_dim
        self.max_slots = max_slots
        self.pages_per_slot = pages_per_slot
        self.page_size = page_size
        self.capacity = pages_per_slot * page_size  # per sequence
        # +1: trash page; +prefix_pages: dedicated headroom for the
        # shared-prefix index, so a busy engine need not thrash cached
        # prefixes against live slots.
        self.prefix_enabled = bool(prefix_cache)
        self.prefix_pages = int(prefix_pages) if prefix_cache else 0
        self.n_pages = (1 + max_slots * pages_per_slot
                        + self.prefix_pages)
        self.dtype = dtype
        self.device = torch.device(device)
        self._fingerprint = fingerprint.encode()
        # Only the primary (target) store owns the process-global
        # serving.* page gauges; a draft store must not clobber them.
        self._gauges = bool(gauges)

        shape = (n_layers, self.n_pages, page_size, n_heads, head_dim)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=self.device)

        self._lock = threading.Lock()
        self._free: List[int] = list(range(1, self.n_pages))
        # guarded_by: _lock
        self._table = np.zeros((max_slots, pages_per_slot), np.int32)
        self._lengths = np.full((max_slots,), -1, np.int32)
        # -- shared-prefix index (all guarded_by: _lock) ------------------
        # chain hash -> physical page holding that page-aligned prefix's
        # KV; _page_hash is the reverse map (page -> hash), _page_tokens
        # keeps the token ids per entry for the export, _refcount counts
        # slots currently mapping a shared page, and _lru holds
        # unreferenced cached pages in reclaim order.
        self._index: Dict[bytes, int] = {}
        self._page_hash: Dict[int, bytes] = {}
        self._page_tokens: Dict[bytes, List[int]] = {}
        self._refcount: Dict[int, int] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        if self._gauges:
            _M_KV_TOTAL.set(self.total_pages)
        self._set_page_gauges_locked()

    # -- gauges ------------------------------------------------------------
    def _set_page_gauges_locked(self) -> None:
        if not self._gauges:
            return
        _M_KV_FREE.set(len(self._free) + len(self._lru))
        _M_KV_RECLAIM.set(len(self._lru))
        _M_PREFIX_CACHED.set(len(self._page_hash))

    # -- page management ---------------------------------------------------
    def begin_slot(self, slot: int, n_tokens: int,
                   prefix_pages: Sequence[int] = ()) -> None:
        """Map pages for a freshly admitted sequence's first
        ``n_tokens`` positions (the prompt) and set its length.
        ``prefix_pages`` (from :meth:`lookup_prefix`) are mapped
        COPY-FREE as the leading read-only pages: each gets a
        reference (it leaves the reclaimable LRU while mapped) and
        only the remainder allocates fresh pages — the suffix is all
        the caller prefills."""
        with self._lock:
            if self._lengths[slot] >= 0:
                raise ValueError(f"slot {slot} already active")
            self._table[slot] = 0
            for j, page in enumerate(prefix_pages):
                if self._page_hash.get(int(page)) is None:
                    raise ValueError(
                        f"page {page} is not a cached prefix page")
                self._table[slot, j] = int(page)
                self._ref_page_locked(int(page))
            self._lengths[slot] = 0
            self._ensure_locked(slot, n_tokens - 1)
            self._lengths[slot] = n_tokens
            if prefix_pages:
                # Split by store: the target's hits on serving.prefix_*,
                # a draft store's on serving.prefix_hits_draft.
                if self._gauges:
                    _M_PREFIX_HITS.inc()
                    _M_PREFIX_PAGES.inc(len(prefix_pages))
                    _M_PREFIX_BYTES.inc(
                        len(prefix_pages) * self.page_global_bytes)
                else:
                    _M_PREFIX_HITS_DRAFT.inc()
            self._set_page_gauges_locked()

    def ensure(self, slot: int, pos: int) -> None:
        """Map pages so position ``pos`` of ``slot`` is writable.
        A no-op on a freed slot: the serve loop reads ``length`` and
        calls this as two separate lock holds, so a drain landing
        between them must not map pages into the freed slot — its own
        idempotence check would then never recycle them (a permanent
        page leak), and ``begin_slot`` zeroes the row on reuse."""
        with self._lock:
            if self._lengths[slot] < 0:
                return
            self._ensure_locked(slot, pos)

    def _alloc_page_locked(self) -> int:
        """One allocatable page: free list first, then the LRU of
        unreferenced cached prefix pages (refcount-aware eviction — a
        REFERENCED shared page is never a candidate by construction:
        it is absent from both pools)."""
        if self._free:
            return self._free.pop(0)
        if self._lru:
            page, _ = self._lru.popitem(last=False)
            self._drop_index_locked(page)
            return page
        raise RuntimeError(
            "paged KV cache out of pages (free list and prefix-cache "
            "LRU both empty) — sizing guarantees this cannot happen "
            "while every slot stays within pages_per_slot")

    def _drop_index_locked(self, page: int) -> None:
        key = self._page_hash.pop(page, None)
        if key is not None:
            self._index.pop(key, None)
            self._page_tokens.pop(key, None)
        self._refcount.pop(page, None)

    def _ref_page_locked(self, page: int) -> None:
        self._refcount[page] = self._refcount.get(page, 0) + 1
        self._lru.pop(page, None)

    def _unref_page_locked(self, page: int) -> None:
        rc = self._refcount.get(page, 0) - 1
        if rc <= 0:
            self._refcount.pop(page, None)
            self._lru[page] = None
            self._lru.move_to_end(page)
        else:
            self._refcount[page] = rc

    def _ensure_locked(self, slot: int, pos: int) -> None:
        if pos >= self.capacity:
            raise ValueError(
                f"position {pos} exceeds per-slot capacity "
                f"{self.capacity}")
        for p in range(pos // self.page_size + 1):
            if self._table[slot, p] == 0:
                self._table[slot, p] = self._alloc_page_locked()
        self._set_page_gauges_locked()

    def advance(self, slot: int) -> int:
        """One decoded token was written at the current length; map the
        page first via :meth:`ensure`.  Returns the new length, or -1
        without advancing when the slot was freed by a concurrent
        eviction (a drain racing the loop must not resurrect it)."""
        with self._lock:
            if self._lengths[slot] < 0:
                return -1
            self._lengths[slot] += 1
            return int(self._lengths[slot])

    def free_slot(self, slot: int) -> None:
        """Evict: recycle the slot's pages.  Refcount-aware: a page the
        prefix index holds is UNREFERENCED (parked in the reclaimable
        LRU when its count reaches zero — never put on the free list
        while cached), every other page goes back on the free list.
        Idempotent — a second free of the same slot (the serve loop
        and a concurrent drain both evicting) is a no-op, never a
        double-insert into the free list."""
        with self._lock:
            if self._lengths[slot] < 0:
                return
            for p in range(self.pages_per_slot):
                page = int(self._table[slot, p])
                if page != 0:
                    if page in self._page_hash:
                        self._unref_page_locked(page)
                    else:
                        self._free.append(page)
            self._table[slot] = 0
            self._lengths[slot] = -1
            self._set_page_gauges_locked()

    # -- shared-prefix index -----------------------------------------------
    @property
    def page_global_bytes(self) -> int:
        """GLOBAL logical KV bytes of one page (K + V, all layers) —
        the byte model memory/planner.prefix_pages_bytes shares."""
        return (2 * self.n_layers * self.page_size * self.n_heads
                * self.head_dim * self.k_pages.element_size())

    def _chain_hashes(self, tokens: Sequence[int],
                      n_pages: int) -> List[bytes]:
        """Chain hash per page boundary: ``h_j`` commits to the model
        fingerprint AND every token of pages ``0..j`` — a hit on page
        ``j`` implies the whole prefix matches, so the index needs no
        token comparison on lookup.  Delegates to
        :func:`..routing.affinity.chain_hashes`, the scheme a router
        derives the same keys with."""
        return _chain_hash_scheme(self._fingerprint, tokens,
                                  self.page_size, n_pages)

    def lookup_prefix(self, tokens: Sequence[int]) -> List[int]:
        """Physical pages of the longest cached page-aligned STRICT
        prefix of ``tokens`` (at least one suffix token always remains
        to prefill — the admission needs its logits to sample from).
        Pure: no refcounts move until :meth:`begin_slot` maps the
        pages, so the admission-headroom gate can call this freely."""
        if not self.prefix_enabled or not tokens:
            return []
        max_pages = min((len(tokens) - 1) // self.page_size,
                        self.pages_per_slot)
        if max_pages <= 0:
            return []
        hashes = self._chain_hashes(tokens, max_pages)
        pages: List[int] = []
        with self._lock:
            for key in hashes:
                page = self._index.get(key)
                if page is None:
                    break
                pages.append(page)
        return pages

    def admission_cost(self, tokens: Sequence[int]) -> int:
        """How much of the :meth:`free_pages` budget admitting this
        prompt consumes, EXACTLY: fresh pages for the unshared tail,
        plus one unit per shared prefix page currently parked in the
        reclaimable LRU (mapping it moves it to referenced — out of
        the pool — while a page other slots already reference costs
        nothing).  The scheduler's page-budget gate prices admissions
        with this; under the default sizing it is a safety net (a
        free slot always implies enough headroom), but the arithmetic
        stays honest for overcommitted configs."""
        if not tokens:
            return 0
        total = -(-len(tokens) // self.page_size)
        if not self.prefix_enabled:
            return total
        max_pages = min((len(tokens) - 1) // self.page_size,
                        self.pages_per_slot)
        hashes = self._chain_hashes(tokens, max_pages) if max_pages \
            else []
        with self._lock:
            shared = 0
            lru_hits = 0
            for key in hashes:
                page = self._index.get(key)
                if page is None:
                    break
                shared += 1
                if page in self._lru:
                    lru_hits += 1
        return total - shared + lru_hits

    def publish_prefix(self, slot: int, tokens: Sequence[int]) -> int:
        """Insert ``slot``'s fully-prefilled prompt pages into the
        index (pages entirely covered by ``tokens`` — pad garbage past
        the prompt never lands in a published page).  Pages already
        indexed (including the slot's own looked-up prefix) are
        skipped; newly published pages become shared with the slot
        holding the first reference.  Returns how many pages were newly
        published."""
        if not self.prefix_enabled:
            return 0
        ps = self.page_size
        n_full = min(len(tokens) // ps, self.pages_per_slot)
        if n_full <= 0:
            return 0
        hashes = self._chain_hashes(tokens, n_full)
        published = 0
        with self._lock:
            if self._lengths[slot] < 0:
                return 0
            for j in range(n_full):
                page = int(self._table[slot, j])
                if page == 0:
                    break
                key = hashes[j]
                if key in self._index or page in self._page_hash:
                    continue
                self._index[key] = page
                self._page_hash[page] = key
                self._page_tokens[key] = [int(t)
                                          for t in tokens[:(j + 1) * ps]]
                self._refcount[page] = self._refcount.get(page, 0) + 1
                published += 1
            if published:
                self._set_page_gauges_locked()
        return published

    def alloc_ghost(self, n_pages: int) -> np.ndarray:
        """A ``[1, pages_per_slot]`` table row of ``n_pages`` freshly
        allocated pages bound to NO slot — the elastic seed path
        (:meth:`publish_ghost`) prefills cached prefixes through it on
        a relaunched engine without burning a decode slot."""
        if not 0 < n_pages <= self.pages_per_slot:
            raise ValueError(
                f"ghost prefix needs 1..{self.pages_per_slot} pages, "
                f"got {n_pages}")
        row = np.zeros((1, self.pages_per_slot), np.int32)
        with self._lock:
            for j in range(n_pages):
                row[0, j] = self._alloc_page_locked()
        return row

    def free_ghost(self, row: np.ndarray) -> None:
        """Return a ghost row's pages to the free list WITHOUT
        indexing them — the seed path's failure cleanup (a prefill
        that raised must not strand allocated pages outside every
        pool, or the sizing invariant silently erodes)."""
        with self._lock:
            for page in row[0]:
                if int(page) != 0:
                    self._free.append(int(page))
            self._set_page_gauges_locked()

    def publish_ghost(self, row: np.ndarray,
                      tokens: Sequence[int]) -> int:
        """Index the ghost row's prefilled pages with refcount zero
        (straight into the reclaimable LRU — hittable, evictable).
        Pages whose chain hash is already indexed go back on the free
        list.  Returns the newly indexed page count."""
        ps = self.page_size
        n_pages = sum(1 for p in row[0] if p != 0)
        n_full = min(len(tokens) // ps, n_pages)
        hashes = self._chain_hashes(tokens, n_full)
        published = 0
        with self._lock:
            for j in range(self.pages_per_slot):
                page = int(row[0, j])
                if page == 0:
                    continue
                key = hashes[j] if j < n_full else None
                if key is not None and key not in self._index:
                    self._index[key] = page
                    self._page_hash[page] = key
                    self._page_tokens[key] = [
                        int(t) for t in tokens[:(j + 1) * ps]]
                    self._lru[page] = None
                    self._lru.move_to_end(page)
                    published += 1
                else:
                    self._free.append(page)
            self._set_page_gauges_locked()
        return published

    def export_prefixes(self) -> List[List[int]]:
        """The cached prefixes as token-id lists, MAXIMAL chains only
        (an entry that is a strict prefix of another cached entry is
        implied by it — seeding the long chain republishes every page
        boundary).  The elastic drain exports this so a relaunched
        fleet rebuilds the shared pages instead of re-prefilling every
        cached prefix cold."""
        with self._lock:
            chains = sorted((list(t) for t in self._page_tokens.values()),
                            key=len, reverse=True)
        out: List[List[int]] = []
        for c in chains:
            if not any(len(k) > len(c) and k[:len(c)] == c for k in out):
                out.append(c)
        return out

    def export_prefix_hashes(self, limit: int = 512) -> List[str]:
        """The index keys as hex chain-hash digests, most recently
        published last, bounded to ``limit`` (newest kept) — the
        /healthz affinity export the router tier matches its
        router-side header hashes against.  Hex (not token chains):
        the router needs membership, not reconstruction, and the
        payload stays small on a hot index."""
        with self._lock:
            keys = list(self._index)
        return [k.hex() for k in keys[-int(limit):]]

    def reclaimable_pages(self) -> int:
        """Unreferenced cached prefix pages — allocatable on demand, so
        they count toward admission headroom."""
        with self._lock:
            return len(self._lru)

    def prefix_stats(self) -> Dict[str, int]:
        """Index occupancy for /healthz and tests."""
        with self._lock:
            return {
                "cached_pages": len(self._page_hash),
                "referenced_pages": len(self._refcount),
                "reclaimable_pages": len(self._lru),
            }

    def length(self, slot: int) -> int:
        with self._lock:
            return int(self._lengths[slot])

    @property
    def total_pages(self) -> int:
        """Allocatable pages (the trash page is never handed out) —
        the ONE place the reserved-page invariant is priced in."""
        return self.n_pages - 1

    def free_pages(self) -> int:
        """Pages available for allocation: the free list PLUS the
        unreferenced cached prefix pages (reclaimed LRU-first on
        demand) — the honest admission-headroom figure /healthz and
        the scheduler's page-budget gate consume."""
        with self._lock:
            return len(self._free) + len(self._lru)

    def table_row(self, slot: int) -> np.ndarray:
        """One slot's page-table row, ``[1, pages_per_slot]`` (a copy —
        the live table may be mutated by a concurrent eviction)."""
        with self._lock:
            return self._table[slot:slot + 1].copy()

    # -- device views ------------------------------------------------------
    def device_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(page_table, lengths) as int64 tensors on the store's device
        (one consistent copy of the host bookkeeping)."""
        with self._lock:
            table_np = self._table.copy()
            lengths_np = self._lengths.copy()
        return (torch.from_numpy(table_np).to(self.device, torch.long),
                torch.from_numpy(lengths_np).to(self.device, torch.long))

    def gather_views(self, table: torch.Tensor):
        """The logical KV views ``[n_layers, rows, capacity, heads,
        head_dim]`` of the page-table rows ``table [rows,
        pages_per_slot]``: a gather into new tensors, the store
        untouched."""
        shape = (self.n_layers, table.shape[0], self.capacity,
                 self.n_heads, self.head_dim)
        return (self.k_pages[:, table].reshape(shape),
                self.v_pages[:, table].reshape(shape))

    def write(self, flat: torch.Tensor, k_new: torch.Tensor,
              v_new: torch.Tensor) -> None:
        """Write entries in place at flat positions ``page * page_size +
        offset`` (``flat [n]``; ``k_new``/``v_new [n_layers, n, heads,
        head_dim]``).  Positions meant to drop point into the trash page
        0; several may share a position there, and which one lands is
        immaterial."""
        shape = (self.n_layers, self.n_pages * self.page_size,
                 self.n_heads, self.head_dim)
        self.k_pages.view(shape)[:, flat] = k_new
        self.v_pages.view(shape)[:, flat] = v_new
