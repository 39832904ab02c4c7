"""The inference engine: prefill and decode programs over the paged KV
cache, driven by the continuous-batching scheduler (port of
horovod_tpu/serving/engine.py).

Each serving phase is one program, gather -> cache-aware forward
(:func:`..models.transformer.forward_step`) -> in-place scatter of the new
KV entries into the paged store (:meth:`.kv_cache.PagedKVCache.write`).
The reference compiles each into a donated XLA executable; PyTorch runs
eagerly, so a program here is a Python callable, kept per key in
``_exec`` as the reference keeps its executables: ``("decode",)``,
``("prefill", bucket)``, ``("verify", spec_tokens + 1)``,
``("draft_propose", spec_tokens)``, ``("draft_prefill", bucket)``.
Their products and attention are the serving kernels of
:mod:`..ops.serving` on a CUDA device, the plain versions on the CPU.

Bitwise contract: a prefill of the prompt followed by N one-token decode
iterations reproduces, bit for bit, the logits of the non-incremental
:func:`..models.transformer.serving_forward` of the same tokens, so
greedy generation is exactly reproducible across the static and
continuous schedules, batch compositions, slot assignments, prefix-cache
hits, speculative decoding and engine relaunches.  It rests on the
serving kernels summing in an order that does not depend on the number
of rows; every token block is still at least 2 wide (decode pads a
discarded dummy column), as in the reference.

:meth:`InferenceEngine.warm_start` builds the serving kernels and runs
the decode program once on the trash page (propose and verify too with a
draft), then marks the engine ready; the reference's replay of a
manifest of AOT executables has no counterpart (nothing is compiled
ahead).  Telemetry: the reference's ``serving.*`` series, through
:mod:`..telemetry`; a single request's abort is flight-recorded.

Multi-process serving (reference :1104-1203): rank 0 owns the scheduler
and the HTTP front door; every other rank runs :meth:`InferenceEngine.
follow` in a loop and repeats rank 0's iteration from what rank 0
broadcasts (``broadcast_object`` under the name ``hvd-serve-plan``): the
admission plan, the post-prefill sync, the fed tokens (or the
speculative acceptance).  A follower has no scheduler; it runs the same
prefill, decode, propose and verify programs in the same order, so its
page pool stays bitwise rank 0's.  The plan rides the negotiated
broadcast on CPU tensors; the runtime moves them to its device, so this
works when ``init()`` chose NCCL for the data group.  ``abort_all``
broadcasts an abort marker so blocked followers free their mirrors too;
:meth:`stop_followers` ends their loops.

With a ``mesh`` whose ``model`` axis has more than one rank, each rank of
the axis holds its shard of the weights (``utils/convert.py``
``serving_shard``) and its heads of every KV page, and the programs'
row-parallel closers sum over the axis in rank order
(:func:`..models.transformer.axis_sum`): every rank of the axis runs the
data plane, rank 0 schedules and the others follow.  The draft's cache
and weights are sharded on the same axis.

The analysis, trace and memory hooks (reference :225-262, :418-438,
:859-866, :901-996, :1354-1360): the drain lock is the lock-order
checker's named lock and ``abort_all`` asserts the ``serve-loop`` role;
every program dispatch (prefill, draft prefill, decode, draft propose,
verify) runs inside :func:`..memory.oom.guard`; each iteration that ran
work is a ``serving.iteration`` trace span and each finished request a
``serving.request`` span; the weights are charged to the memory ledger
(``serving.params``, ``serving.draft_params``) and ``warm_start`` runs
the pre-flight.  ``drain``, ``export_prefix_index``, ``seed_prefixes``
and ``import_requests`` are what ``elastic.ServingState`` and the
server's ``/drain`` and ``/resume`` move a fleet's work with.  Waiting
for later work (ROADMAP.md A.5.5): tuning actuation (the reference's
``set_spec_tokens``).
"""

from __future__ import annotations

import json
import os
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry as _telemetry
from .. import trace as _trace
from ..analysis import lockorder as _lockorder
from ..analysis import threads as _athreads
from ..core.topology import MODEL_AXIS
from ..memory import ledger as _mem
from ..memory import oom as _oom
from ..models import transformer as _transformer
from ..telemetry import flight as _flight
from ..utils.convert import serving_shard
from ..utils.serialization import DTYPE_NAMES
from ..utils.tree import tree_leaves, tree_map
from .kv_cache import PagedKVCache
from .scheduler import ContinuousBatchingScheduler, FinishReason, Request

_M_TTFT = _telemetry.histogram(
    "serving.ttft_seconds", "seconds",
    "time from submission to the first generated token")
_M_TOKEN_LAT = _telemetry.histogram(
    "serving.token_seconds", "seconds",
    "per-token decode latency (one continuous-batching iteration)")
_M_TOKENS = _telemetry.counter(
    "serving.tokens_generated", "tokens sampled across all sequences")
_M_PREFILLS = _telemetry.counter(
    "serving.prefills", "prefill executions (one per admission)")
_M_PREFILL_TOKENS = _telemetry.counter(
    "serving.prefill_tokens",
    "token positions run through the target's prefill (padded bucket "
    "widths; a prefix-cache hit runs only the suffix's bucket)")
_M_DECODES = _telemetry.counter(
    "serving.decode_iterations", "batched decode iterations")
_M_WARM = _telemetry.counter(
    "serving.warm_starts", "engines made ready by warm_start")
_M_SPEC_PROPOSED = _telemetry.counter(
    "serving.spec_proposed", "draft tokens proposed per speculative "
    "iteration (spec_tokens per active greedy slot)")
_M_SPEC_ACCEPTED = _telemetry.counter(
    "serving.spec_accepted", "draft tokens the bitwise-greedy verify "
    "accepted (the bonus/correction token is not counted)")
_M_SPEC_RATE = _telemetry.gauge(
    "serving.spec_acceptance_rate", "cumulative spec_accepted / "
    "spec_proposed for this engine")

def _model_dict(cfg) -> dict:
    """The model identity: the prefix cache's fingerprint (byte for byte
    the reference's, so both packages key prefixes alike) and the
    draft's identity."""
    return {
        "vocab_size": cfg.vocab_size,
        "d_model": cfg.d_model,
        "n_heads": cfg.n_heads,
        "n_layers": cfg.n_layers,
        "d_ff": cfg.d_ff,
        "max_seq_len": cfg.max_seq_len,
        "num_experts": cfg.num_experts,
        "dtype": DTYPE_NAMES[cfg.dtype],
    }


def _resident_bytes(*trees) -> int:
    """Bytes of the tensors in ``trees``, each storage counted once (the
    serving tree shares all but its fused QKV weight with the params)."""
    seen, total = set(), 0
    for tree in trees:
        for x in tree_leaves(tree):
            if isinstance(x, torch.Tensor):
                st = x.untyped_storage()
                if st.data_ptr() not in seen:
                    seen.add(st.data_ptr())
                    total += st.nbytes()
    return total


def _on(device, params):
    """The parameter tree on ``device``, detached from autograd."""
    return tree_map(lambda x: torch.as_tensor(x).detach().to(device), params)


class InferenceEngine:
    """Continuous-batching inference over one transformer LM.

    ``params``/``cfg`` are the training-side parameter tree and
    :class:`~..models.transformer.TransformerConfig`; ``device`` is where
    the parameters, the KV pages and every program live (``cuda`` unless
    asked for the CPU).  With a ``mesh`` (``core/topology.make_mesh``)
    whose ``model`` axis has more than one rank, the head axis of the KV
    pages and the attention/FFN weights shard over it (every rank passes
    the FULL ``params``; each keeps its shard).  Threading contract: the
    data plane (``step``/``follow``/``generate``/``run_until_idle``/
    ``warm_start``) is driven from ONE thread (the serve loop); ``submit``
    is thread-safe (the scheduler's lock), and the drain family
    (``drain``, ``import_requests``, ``export_requests``) may run from
    other threads, serialized by ``_drain_lock``.  ``abort_all``
    broadcasts under multi-process serving, so there only the serve-loop
    thread may call it (between iterations).
    """

    def __init__(self, params: Any, cfg, *, device="cuda", mesh=None,
                 max_slots: int = 8, page_size: int = 16,
                 capacity: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 prefix_pages: Optional[int] = None,
                 draft: Optional[Tuple[Any, Any]] = None,
                 spec_tokens: Optional[int] = None) -> None:
        cap = capacity if capacity is not None else cfg.max_seq_len
        cap = min(cap, cfg.max_seq_len)
        cap -= cap % page_size
        # Compare against the page-floored max_seq_len, or the default
        # capacity is spuriously rejected when page_size < max_seq_len <
        # 2 * page_size with an unaligned max_seq_len.
        max_cap = cfg.max_seq_len - cfg.max_seq_len % page_size
        if cap < 2 * page_size and cap < max_cap:
            raise ValueError(
                f"capacity {capacity} too small for page_size "
                f"{page_size} (needs >= 2 pages' worth or "
                f"max_seq_len)")
        if cap < 2:
            raise ValueError("KV capacity must be >= 2")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "InferenceEngine: no CUDA device; pass device='cpu' to "
                    "serve on the CPU")
            if self.device.index is None:  # the serve loop sets it
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        self.cfg = cfg
        self.eos_id = eos_id
        self.max_slots = max_slots
        # Shared-prefix page cache: on unless the env or the kwarg opts
        # out; hits are bitwise-invisible.
        if prefix_cache is None:
            prefix_cache = os.environ.get(
                "HVD_TPU_PREFIX_CACHE", "1") != "0"
        if prefix_pages is None:
            prefix_pages = int(os.environ.get(
                "HVD_TPU_PREFIX_PAGES", "0"))
        fingerprint = json.dumps(_model_dict(cfg), sort_keys=True)
        # Exported verbatim in /healthz: a router keys its prefix-
        # affinity chain hashes off it (routing/affinity.py).
        self.fingerprint = fingerprint
        self.cache = PagedKVCache(
            cfg.n_layers, cfg.n_heads, cfg.d_model // cfg.n_heads,
            max_slots, cap // page_size, page_size, dtype=cfg.dtype,
            device=self.device, prefix_cache=prefix_cache,
            prefix_pages=prefix_pages, fingerprint=fingerprint, mesh=mesh)
        # The model axis the programs' closers sum over (None: one device
        # or an axis of one rank, whose program is the single-device one).
        self._axis = self.cache.page_sharding()
        self.capacity = self.cache.capacity
        self.scheduler = ContinuousBatchingScheduler(max_slots,
                                                     self.capacity)
        self.params = _on(self.device, self._shard(params, cfg))
        # The fused QKV weight built once, not on every forward.
        self._step_params = _transformer.serving_params(self.params)
        # Speculative decoding: a draft model proposes spec_tokens greedy
        # tokens an iteration; ONE verify program runs the target over
        # the block and accepts by the bitwise-greedy rule.  Without a
        # draft the decode path is unchanged.
        if spec_tokens is None:
            spec_tokens = int(os.environ.get("HVD_TPU_SPEC_TOKENS", "3"))
        self.spec_tokens = spec_tokens
        self._draft_params = None
        self._draft_cfg = None
        self.draft_cache: Optional[PagedKVCache] = None
        if draft is not None:
            # Validated only when a draft is armed: HVD_TPU_SPEC_TOKENS=0
            # must not break draft-less engines.
            if spec_tokens < 1:
                raise ValueError(
                    f"spec_tokens must be >= 1, got {spec_tokens}")
            draft_params, draft_cfg = draft
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab_size {draft_cfg.vocab_size} must "
                    f"match the target's {cfg.vocab_size} (the "
                    f"acceptance rule compares token ids)")
            if draft_cfg.max_seq_len < cap:
                raise ValueError(
                    f"draft max_seq_len {draft_cfg.max_seq_len} must "
                    f"cover the KV capacity {cap}")
            self._draft_cfg = draft_cfg
            # The draft store rides a shared-prefix index of its own,
            # keyed by the DRAFT's fingerprint (the two hold different
            # models' KV).
            self.draft_cache = PagedKVCache(
                draft_cfg.n_layers, draft_cfg.n_heads,
                draft_cfg.d_model // draft_cfg.n_heads,
                max_slots, cap // page_size, page_size,
                dtype=draft_cfg.dtype, device=self.device,
                prefix_cache=prefix_cache,
                fingerprint=json.dumps(_model_dict(draft_cfg),
                                       sort_keys=True),
                gauges=False, mesh=mesh,
                ledger_category="serving.draft_kv")
            self._draft_params = _transformer.serving_params(
                _on(self.device, self._shard(draft_params, draft_cfg)))
        self._buckets = [b for b in (2 ** i for i in range(1, 31))
                         if b <= self.capacity]
        if self._buckets[-1] != self.capacity:
            self._buckets.append(self.capacity)
        self._exec: Dict[Tuple, Any] = {}
        self._last_token = np.zeros((max_slots,), np.int64)
        # The second-newest context token per slot: the catch-up column
        # of the draft's propose block (transformer.speculative_propose).
        self._prev_token = np.zeros((max_slots,), np.int64)
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._ready = False
        self._drained = False
        # Serializes drain/abort_all/import_requests: the serve loop's
        # recovery and a drain from another thread run concurrently, and
        # the "_drained" check-then-act must be atomic with the
        # scheduler drain it guards.  Taken BEFORE the scheduler's lock.
        self._drain_lock = _lockorder.make_lock(
            "serving.InferenceEngine._drain_lock")
        # hvd-mem: the engine's resident weights (the target's as
        # ``serving.params``, a draft's as the reference's
        # ``serving.draft_params``), keyed and released by gc.
        self._ledger_key = id(self)
        charges = [("serving.params",
                    _resident_bytes(self.params, self._step_params))]
        if self._draft_params is not None:
            charges.append(("serving.draft_params",
                            _resident_bytes(self._draft_params)))
        for category, nbytes in charges:
            if _mem.enabled():
                _mem.ledger.alloc(category, nbytes, key=self._ledger_key)
            weakref.finalize(self, _mem.ledger.free_deferred, category,
                             key=self._ledger_key)

    def _shard(self, params, cfg):
        """This rank's serving parameters: its shard on a model axis of
        more than one rank, else the tree as it is."""
        if self._axis is None:
            return params
        return serving_shard(params, cfg, self._axis.index, self._axis.size)

    # -- readiness / warm start -------------------------------------------
    @property
    def ready(self) -> bool:
        """True once :meth:`warm_start` completed: the ``/healthz``
        readiness bit."""
        return self._ready

    def mark_unready(self) -> None:
        """Failure latch: flip ``/healthz`` back to NOT_READY (recovery
        itself failed; the load balancer should drain traffic)."""
        self._ready = False

    def health(self) -> Tuple[bool, dict]:
        """Exporter health contributor (``RouteRegistry.register_health``)."""
        prefix = self.cache.prefix_stats()
        return self._ready, {
            "ready": self._ready,
            "queue_depth": self.scheduler.queue_depth(),
            "batch_occupancy": self.scheduler.occupancy(),
            "kv_free_pages": self.cache.free_pages(),
            "kv_total_pages": self.cache.total_pages,
            "kv_reclaimable_pages": prefix["reclaimable_pages"],
            "prefix_cached_pages": prefix["cached_pages"],
            "page_size": self.cache.page_size,
            "pages_per_slot": self.cache.pages_per_slot,
            "fingerprint": self.fingerprint,
            "prefix_index": self.cache.export_prefix_hashes(),
            "speculative": self._draft_params is not None,
            "spec_tokens": (self.spec_tokens
                            if self._draft_params is not None else 0),
            "slots": self.max_slots,
            "executables": len(self._exec),
            "device": str(self.device),
        }

    def warm_start(self) -> int:
        """Build the serving kernels (on a CUDA device), run the decode
        program once over the trash page (every slot inactive; with a
        draft, the propose and verify programs too), then mark the engine
        ready.  Readiness means "can decode".  Returns 0: the reference's
        count of manifest entries rebuilt has no counterpart."""
        if self.device.type == "cuda":
            from ..ops import _build

            _build.build_all()
        B, pps = self.max_slots, self.cache.pages_per_slot
        trash = torch.zeros((B, pps), dtype=torch.long, device=self.device)
        idle = torch.full((B,), -1, dtype=torch.long, device=self.device)
        zeros = torch.zeros((B,), dtype=torch.long, device=self.device)
        self._decode_exec()(trash, idle, zeros)
        if self._draft_params is not None:
            self._propose_exec()(trash, idle, zeros, zeros)
            self._verify_exec()(trash, idle, torch.zeros(
                (B, self.spec_tokens + 1), dtype=torch.long,
                device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # hvd-mem pre-flight (reference :418-438): the KV pools and the
        # resident weights against the advertised capacity.
        try:
            per_device = (self.cache.k_pages.nbytes
                          + self.cache.v_pages.nbytes
                          + _resident_bytes(self.params, self._step_params))
            if self.draft_cache is not None:
                per_device += (self.draft_cache.k_pages.nbytes
                               + self.draft_cache.v_pages.nbytes
                               + _resident_bytes(self._draft_params))
            _oom.preflight_warn(per_device, "serving.warm_start",
                                "KV pools + resident weights "
                                "(per-device bytes)")
        except Exception:  # noqa: BLE001 — sizing is observability
            pass
        _M_WARM.inc()
        self._ready = True
        return 0

    # -- programs ----------------------------------------------------------
    def _program(self, key: Tuple, build) -> Any:
        fn = self._exec.get(key)
        if fn is None:
            fn = self._exec[key] = build()
        return fn

    @staticmethod
    def _flat(table, pos, cache: PagedKVCache):
        """Flat pool positions of logical ``pos [rows, w]`` through
        ``table [rows, pages_per_slot]``; positions outside [0,
        capacity) go to the trash page 0."""
        ps, pps = cache.page_size, cache.pages_per_slot
        page = torch.gather(table, 1, (pos // ps).clamp(0, pps - 1))
        live = (pos >= 0) & (pos < cache.capacity)
        page = torch.where(live, page, 0)
        return (page * ps + torch.where(live, pos % ps, 0)).reshape(-1)

    def _decode_exec(self) -> Any:
        """``(table [B, pps], lengths [B], tokens [B]) -> logits [B,
        vocab]``: a width-2 ``[token, dummy]`` block through the target
        for every slot; the token's KV lands at its slot's length."""
        cfg, cache = self.cfg, self.cache

        def program(table, lengths, tokens):
            with torch.no_grad():
                k_view, v_view = cache.gather_views(table)
                blk = torch.stack([tokens, torch.zeros_like(tokens)], dim=1)
                logits, k_new, v_new = _transformer.forward_step(
                    self._step_params, blk, lengths, k_view, v_view, cfg,
                    self._axis)
                flat = self._flat(table, lengths.clamp(min=0)[:, None],
                                  cache)
                cache.write(flat, k_new[:, :, 0], v_new[:, :, 0])
                return logits[:, 0]

        return self._program(("decode",), lambda: program)

    def _prefill_exec(self, bucket: int, draft: bool = False) -> Any:
        """``(table_row [1, pps], start, n_valid, tokens [1, bucket]) ->
        logits [vocab]`` of the last real token.  ``start`` is the number
        of already-cached positions (the shared prefix on a prefix-cache
        hit, so only the suffix runs); padding and positions past the
        capacity land in the trash page.  ``draft=True``: the same
        program over the draft model and store."""
        cfg = self._draft_cfg if draft else self.cfg
        cache = self.draft_cache if draft else self.cache
        params = self._draft_params if draft else self._step_params

        def program(table_row, start, n_valid, tokens):
            with torch.no_grad():
                k_view, v_view = cache.gather_views(table_row)
                start_t = torch.tensor([start], dtype=torch.long,
                                       device=self.device)
                logits, k_new, v_new = _transformer.forward_step(
                    params, tokens, start_t, k_view, v_view, cfg,
                    self._axis)
                pos = start + torch.arange(bucket, device=self.device)
                flat = self._flat(table_row, pos[None], cache)
                cache.write(flat, k_new[:, 0], v_new[:, 0])
                return logits[0, n_valid - 1]

        key = ("draft_prefill" if draft else "prefill", bucket)
        return self._program(key, lambda: program)

    def _verify_exec(self) -> Any:
        """The speculative verify program, ``(table, lengths, blocks [B,
        spec_tokens + 1]) -> logits [B, spec_tokens + 1, vocab]``: ONE
        target pass over ``[pending, d_1..d_spec]`` for every slot, its
        KV scattered.  Rejected positions' entries are rolled back on the
        host (the write cursor does not advance over them) and
        overwritten before they could unmask."""
        cfg, cache = self.cfg, self.cache
        W = self.spec_tokens + 1

        def program(table, lengths, blocks):
            with torch.no_grad():
                k_view, v_view = cache.gather_views(table)
                logits, k_new, v_new = _transformer.forward_step(
                    self._step_params, blocks, lengths, k_view, v_view, cfg,
                    self._axis)
                pos = (lengths.clamp(min=0)[:, None]
                       + torch.arange(W, device=self.device)[None])
                flat = self._flat(table, pos, cache)
                L, B = k_new.shape[:2]
                cache.write(flat, k_new.reshape(L, B * W, *k_new.shape[3:]),
                            v_new.reshape(L, B * W, *v_new.shape[3:]))
                return logits

        return self._program(("verify", W), lambda: program)

    def _propose_exec(self) -> Any:
        """The draft's propose program, ``(table, lengths, prev, pending)
        -> proposals [B, spec_tokens]``: ``spec_tokens`` greedy draft
        steps a slot (transformer.speculative_propose), the derived draft
        KV scattered into the draft's store."""
        dcfg, dcache = self._draft_cfg, self.draft_cache
        m = self.spec_tokens

        def program(table, lengths, prev, pending):
            with torch.no_grad():
                k_view, v_view = dcache.gather_views(table)
                sp = lengths - 1
                proposals, kc, vc = _transformer.speculative_propose(
                    self._draft_params, prev, pending, sp, k_view, v_view,
                    dcfg, m, self._axis)
                pos = sp[:, None] + torch.arange(m + 1,
                                                 device=self.device)[None]
                flat = self._flat(table, pos, dcache)
                L, B = kc.shape[:2]
                dcache.write(flat, kc.reshape(L, B * (m + 1), *kc.shape[3:]),
                             vc.reshape(L, B * (m + 1), *vc.shape[3:]))
                return proposals

        return self._program(("draft_propose", m), lambda: program)

    def _bucket_for(self, n: int) -> int:
        n = max(2, min(n, self.capacity))
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _tokens(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.int64), device=self.device)

    # -- request surface ---------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 32,
               eos_id: Optional[int] = None, temperature: float = 0.0,
               seed: int = 0, arrival: int = 0,
               prefix: Optional[List[int]] = None) -> Request:
        """``prefix`` (relaunch continuations) is attached BEFORE the
        request enters the queue: a live serve loop may admit and sample
        it at once, and the sampling rng keys on ``len(prefix) +
        len(generated)``."""
        req = Request(prompt=[int(t) for t in prompt],
                      max_new_tokens=max_new_tokens,
                      eos_id=self.eos_id if eos_id is None else eos_id,
                      temperature=temperature, seed=seed,
                      arrival=arrival)
        if prefix is not None:
            req.prefix = list(prefix)
        req.t_submit = time.perf_counter()
        return self.scheduler.submit(req)

    def generate(self, prompt: List[int], max_new_tokens: int = 32,
                 **kw) -> List[int]:
        """Synchronous convenience: submit + drive to completion."""
        req = self.submit(prompt, max_new_tokens, **kw)
        self.run_until_idle()
        return req.result(timeout=0)

    def run_until_idle(self, max_iterations: int = 1_000_000) -> int:
        """Drive :meth:`step` until queue and batch are empty; returns
        iterations run."""
        it = 0
        while not self.scheduler.idle() and it < max_iterations:
            self.step()
            it += 1
        return it

    # -- the continuous-batching iteration --------------------------------
    def step(self, now: Optional[int] = None, admit: bool = True) -> bool:
        """ONE iteration: admit into free slots (prefill each new
        sequence and sample its first token from the prefill logits),
        evict cancelled slots, then one batched decode (or speculative
        propose + verify) over every active slot: sequences finish and
        admit mid-stream, with no batch boundary.  ``now`` gates
        admission on logical arrival stamps (trace replay); ``admit=
        False`` skips admission, which is the whole difference between
        this engine and a static batcher.  Returns whether any work
        ran.

        Multi-process: rank 0 (the only rank with a scheduler) broadcasts
        the admission plan, then the post-prefill state, then the sampled
        tokens, so :meth:`follow` on the other ranks mirrors the cache
        and runs the same programs in the same order."""
        mt0 = time.monotonic() if _trace.enabled() else 0.0
        mp = self._multiprocess()
        admitted = self._admit(now) if admit else []
        if mp:
            self._bcast({"stop": False,
                         "admit": [(slot, list(req.prompt))
                                   for slot, req in admitted]})
        finished = [slot for slot, req in admitted
                    if self._prefill_and_sample(slot, req) is not None]
        # Clean abort of disconnected clients' slots, at the iteration
        # boundary on the serve-loop thread (the only one that frees KV
        # slots).  The slots are freed here, after every prefill, in the
        # order of the sync's evict list, which the followers replay: the
        # free list is FIFO and the prefix LRU ordered, so freeing an
        # admission that finished at its prefill before a later
        # admission's pages are mapped, or before the cancelled slots,
        # would leave the ranks' page ids apart.
        cancelled = [s for s in self.scheduler.evict_cancelled()
                     if self.cache.length(s) >= 0]
        evict = cancelled + [s for s, _ in admitted if s not in cancelled
                             and (s in finished or self.cache.length(s) < 0)]
        for slot in evict:
            self._free_slot(slot)
        active = self.scheduler.active()
        # A speculative iteration writes spec_tokens positions past the
        # length (target) and spec_tokens - 1 (draft): map the whole
        # block first.  An all-temperature batch runs plain decode
        # (sampled slots never consult proposals).  Page allocation (the
        # host step that can raise) runs before the decode announcement:
        # a follower that has read a non-empty "decode" list is inside
        # the programs and no abort marker reaches it.
        spec = (self._draft_params is not None
                and any(req.temperature <= 0.0 for _, req in active))
        depth = self.spec_tokens if spec else 0
        self._ensure_block(active, depth)
        if mp:
            # Post-prefill sync: first sampled tokens, the slots that
            # decode (a max_new_tokens=1 admission can finish at
            # prefill), and the evictions.
            self._bcast({
                "last": {s: int(self._last_token[s]) for s, _ in active},
                "decode": [s for s, _ in active],
                "spec": spec,
                "evict": evict})
        if active:
            if spec:
                self._speculative_iteration(active)
            else:
                self._decode_iteration(active)
        if (admitted or active) and _trace.enabled():
            # hvd-trace: one serving span per iteration that ran work,
            # so the host-bound decode loop decomposes in the fleet
            # trace next to training cycles.
            _trace.span("serving.iteration", "serving", mt0,
                        time.monotonic(),
                        args={"admitted": len(admitted),
                              "active": len(active), "spec": spec})
        return bool(admitted or active)

    def _admit(self, now: Optional[int]) -> List[Tuple[int, Request]]:
        """Headroom-gated admission: each candidate's prefill is priced
        against the KV page budget (free list + the prefix cache's
        reclaimable pages) before it takes a slot."""
        return self.scheduler.admit(
            now, page_budget=self.cache.free_pages(),
            pages_needed=lambda req:
                self.cache.admission_cost(req.prompt))

    def _ensure_block(self, active, depth: int) -> None:
        for slot, _ in active:
            ln = self.cache.length(slot)
            if ln < 0:
                continue
            self.cache.ensure(slot, min(ln + depth, self.capacity - 1))
            if depth and self.draft_cache is not None:
                self.draft_cache.ensure(
                    slot, min(ln + depth - 1,
                              self.draft_cache.capacity - 1))

    def _sample(self, req: Request, logits: np.ndarray) -> int:
        if req.temperature <= 0.0:
            return int(np.argmax(logits))
        z = (logits - logits.max()) / req.temperature
        p = np.exp(z)
        p /= p.sum()
        # Keyed on request-local state only (seed + decode position),
        # never on scheduler history, so a sampled rollout reproduces
        # across engines, relaunches and batch mixes.
        rng = np.random.default_rng(
            (req.seed, len(req.prefix) + len(req.generated)))
        return int(rng.choice(len(p), p=p))

    def _free_slot(self, slot: int) -> None:
        """Release one slot's KV in the target's store and the draft's
        (idempotent)."""
        self.cache.free_slot(slot)
        if self.draft_cache is not None:
            self.draft_cache.free_slot(slot)

    def _feed(self, slot: int, req: Request, token: int,
              free: bool = True) -> Optional[str]:
        """Record one sampled/accepted token; returns the finish reason
        when this token ended the sequence, else None.  A finished
        sequence's slot is freed here unless ``free`` is False (then the
        caller frees it)."""
        if not req.generated:
            req.t_first_token = time.perf_counter()
            _M_TTFT.observe(req.t_first_token - req.t_submit)
        _M_TOKENS.inc()
        # expect=req: a concurrent drain may have evicted the slot
        # mid-iteration; the token is then discarded (the exported
        # continuation reproduces it).
        reason = self.scheduler.feed(slot, token, expect=req)
        if reason is not None:
            req.t_done = time.perf_counter()
            if free:
                self._free_slot(slot)  # idempotent vs the drain
            if _trace.enabled():
                # hvd-trace serving span (reference :859-866): the whole
                # request lifetime, from the engine's wall stamps.
                mnow = time.monotonic()
                _trace.span("serving.request", "serving",
                            mnow - (req.t_done - req.t_submit), mnow,
                            args={"rid": req.rid,
                                  "tokens": len(req.generated),
                                  "reason": reason})
        else:
            self._last_token[slot] = token
        return reason

    def _prefill(self, slot: int, req: Request) -> np.ndarray:
        """Admission prefill.  On a prefix-cache hit the shared pages map
        copy-free and only the suffix runs through the model (its KV is
        bitwise a cold full prefill's: the kernels' sums do not depend
        on the number of rows).  The prompt's full pages publish into
        the index afterwards.  With a draft, the draft's prefill rides
        its own index the same way."""
        prompt = list(req.prompt)
        last = self._prefill_store(slot, prompt, draft=False)
        if self._draft_params is not None:
            self._prefill_store(slot, prompt, draft=True)
        self._prev_token[slot] = prompt[-1]
        _M_PREFILLS.inc()
        return last

    def _prefill_store(self, slot: int, prompt: List[int],
                       draft: bool) -> np.ndarray:
        cache = self.draft_cache if draft else self.cache
        shared = cache.lookup_prefix(prompt)
        n_shared = len(shared) * cache.page_size
        cache.begin_slot(slot, len(prompt), prefix_pages=shared)
        suffix = prompt[n_shared:]
        bucket = self._bucket_for(len(suffix))
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :len(suffix)] = suffix
        program = self._prefill_exec(bucket, draft=draft)
        with _oom.guard(f"serving/{'draft_' if draft else ''}prefill/"
                        f"{bucket}"):
            last = program(self._tokens(cache.table_row(slot)), n_shared,
                           len(suffix), self._tokens(tokens))
        cache.publish_prefix(slot, prompt)
        if not draft:
            _M_PREFILL_TOKENS.inc(bucket)
        return last.cpu().numpy()

    def _decode_iteration(self, active) -> np.ndarray:
        """One batched decode over ``active``; the caller (step) has
        already run ``cache.ensure`` for every slot."""
        t0 = time.perf_counter()
        table, lengths = self.cache.device_tables()
        tokens = np.zeros((self.max_slots,), np.int64)
        for slot, _ in active:
            tokens[slot] = self._last_token[slot]
        with _oom.guard("serving/decode"):
            logits = self._decode_exec()(table, lengths,
                                         self._tokens(tokens))
        logits_np = logits.cpu().numpy()
        fed, evicted = {}, []
        for slot, req in active:
            self.cache.advance(slot)  # the input token's KV landed
            fed[slot] = self._sample(req, logits_np[slot])
            self._feed(slot, req, fed[slot])
            if self.cache.length(slot) < 0:
                evicted.append(slot)
        if self._multiprocess():
            self._bcast({"tokens": fed, "evict": evicted})
        _M_DECODES.inc()
        _M_TOKEN_LAT.observe(time.perf_counter() - t0)
        return logits_np

    def _prefill_and_sample(self, slot: int,
                            req: Request) -> Optional[str]:
        """Prefill and feed the first token; a sequence that finishes
        here keeps its slot until :meth:`step` frees it."""
        last = self._prefill(slot, req)
        return self._feed(slot, req, self._sample(req, last), free=False)

    # -- speculative decoding ---------------------------------------------
    def _spec_dispatch(self, slots: Sequence[int]):
        """The speculative iteration's two programs, draft propose then
        target verify.  Returns ``(proposals [B, spec_tokens], logits
        [B, spec_tokens + 1, vocab])`` as numpy."""
        B = self.max_slots
        prev = np.zeros((B,), np.int64)
        pending = np.zeros((B,), np.int64)
        for s in slots:
            prev[s] = self._prev_token[s]
            pending[s] = self._last_token[s]
        dtable, dlengths = self.draft_cache.device_tables()
        with _oom.guard(f"serving/draft_propose/{self.spec_tokens}"):
            props = self._propose_exec()(dtable, dlengths,
                                         self._tokens(prev),
                                         self._tokens(pending))
        props = props.cpu().numpy()
        W = self.spec_tokens + 1
        blocks = np.zeros((B, W), np.int64)
        for s in slots:
            blocks[s, 0] = pending[s]
            blocks[s, 1:] = props[s]
        table, lengths = self.cache.device_tables()
        with _oom.guard(f"serving/verify/{W}"):
            logits = self._verify_exec()(table, lengths,
                                         self._tokens(blocks))
        return props, logits.cpu().numpy()

    def _speculative_iteration(self, active) -> None:
        """One speculative iteration over ``active``: propose + verify,
        then the host-side bitwise-greedy acceptance.  For a greedy slot
        the accepted tokens plus the correction/bonus token are exactly
        what non-speculative greedy decode emits (the verify logits are
        bitwise the decode program's at every position, and the rule is
        the same f32 argmax).  A temperature slot samples from the
        block's first position, as decode would.  A rejected tail's
        entries stay masked: the write cursor does not advance over
        them."""
        t0 = time.perf_counter()
        m = self.spec_tokens
        props, logits_np = self._spec_dispatch([s for s, _ in active])
        fed: Dict[int, int] = {}
        prev: Dict[int, int] = {}
        advance: Dict[int, int] = {}
        evicted: List[int] = []
        for slot, req in active:
            if req.temperature <= 0.0:
                greedy = np.argmax(logits_np[slot], axis=-1)
                accept = 0
                while (accept < m
                       and int(props[slot, accept])
                       == int(greedy[accept])):
                    accept += 1
                emitted = [int(props[slot, j]) for j in range(accept)]
                emitted.append(int(greedy[accept]))
                self._spec_proposed += m
                self._spec_accepted += accept
                _M_SPEC_PROPOSED.inc(m)
                if accept:
                    _M_SPEC_ACCEPTED.inc(accept)
            else:
                emitted = [self._sample(req, logits_np[slot, 0])]
                accept = 0
            last_before = int(self._last_token[slot])
            finished = False
            for t in emitted:
                if self._feed(slot, req, t) is not None:
                    finished = True
                    break
            if finished or self.cache.length(slot) < 0:
                evicted.append(slot)
                continue
            # The accepted inputs' KV is now valid: pending plus the
            # accepted drafts (the bonus token is the new pending).
            for _ in range(1 + accept):
                self.cache.advance(slot)
                self.draft_cache.advance(slot)
            self._prev_token[slot] = (emitted[-2] if len(emitted) >= 2
                                      else last_before)
            fed[slot] = int(self._last_token[slot])
            prev[slot] = int(self._prev_token[slot])
            advance[slot] = 1 + accept
        if self._spec_proposed:
            _M_SPEC_RATE.set(self._spec_accepted / self._spec_proposed)
        if self._multiprocess():
            self._bcast({"tokens": fed, "prev": prev, "advance": advance,
                         "evict": evicted})
        _M_DECODES.inc()
        _M_TOKEN_LAT.observe(time.perf_counter() - t0)

    @property
    def spec_acceptance_rate(self) -> Optional[float]:
        """Cumulative accepted/proposed draft-token ratio (None before
        the first speculative iteration)."""
        if not self._spec_proposed:
            return None
        return self._spec_accepted / self._spec_proposed

    # -- multi-process mirroring (reference :1104-1203) ---------------------
    def _multiprocess(self) -> bool:
        from ..core import state as _state

        return _state.is_initialized() and _state.size() > 1

    def _bcast(self, obj):
        from ..ops.objects import broadcast_object

        return broadcast_object(obj, root_rank=0, name="hvd-serve-plan")

    def follow(self) -> bool:
        """A worker rank's mirror of ONE rank-0 :meth:`step`: receive the
        admission plan (prefill those slots), the post-prefill sync
        (first tokens, the decode batch, early evictions), run the same
        decode (or propose + verify) program when rank 0 does, then
        apply its fed tokens and evictions to the local mirror.  Returns
        False when rank 0 announced shutdown (:meth:`stop_followers`).

        Any of the three receptions may instead carry rank 0's ``abort``
        marker (:meth:`abort_all` after a step died mid-iteration): the
        worker frees every cache slot and returns, so the ranks' caches
        stay identical for the next iteration."""
        plan = self._bcast(None)
        if plan.get("stop"):
            return False
        if plan.get("abort"):
            self._free_all_slots()
            return True
        for slot, prompt in plan.get("admit", ()):
            self._prefill(int(slot), Request(prompt=list(prompt)))
        sync = self._bcast(None)
        if sync.get("abort"):
            self._free_all_slots()
            return True
        for slot, token in sync.get("last", {}).items():
            self._last_token[int(slot)] = int(token)
        for slot in sync.get("evict", ()):
            if self.cache.length(int(slot)) >= 0:
                self._free_slot(int(slot))
        decode = [int(s) for s in sync.get("decode", ())]
        if not decode:
            return True
        spec = bool(sync.get("spec")) and self._draft_params is not None
        self._ensure_block([(s, None) for s in decode],
                           self.spec_tokens if spec else 0)
        if spec:
            # Rank 0's two programs, then ITS acceptance results.
            self._spec_dispatch(decode)
        else:
            table, lengths = self.cache.device_tables()
            tokens = np.zeros((self.max_slots,), np.int64)
            for slot in decode:
                tokens[slot] = self._last_token[slot]
            with _oom.guard("serving/decode"):
                self._decode_exec()(table, lengths, self._tokens(tokens))
        fed = self._bcast(None)
        if fed.get("abort"):
            # Rank 0's iteration died before it broadcast the tokens (and
            # it never advanced): free everything, as it did.
            self._free_all_slots()
            return True
        if spec:
            for slot, n_adv in fed.get("advance", {}).items():
                for _ in range(int(n_adv)):
                    self.cache.advance(int(slot))
                    self.draft_cache.advance(int(slot))
            for slot, token in fed.get("prev", {}).items():
                self._prev_token[int(slot)] = int(token)
        else:
            for slot in decode:
                self.cache.advance(slot)
        for slot, token in fed.get("tokens", {}).items():
            self._last_token[int(slot)] = int(token)
        for slot in fed.get("evict", ()):
            if self.cache.length(int(slot)) >= 0:
                self._free_slot(int(slot))
        return True

    def stop_followers(self) -> None:
        """Rank 0: end the followers' :meth:`follow` loops."""
        if self._multiprocess():
            self._bcast({"stop": True})

    # -- drain / resume ----------------------------------------------------
    @staticmethod
    def _export_request(req: Request) -> dict:
        """A request as a resubmittable continuation: the prompt extended
        by what it generated so far (the bitwise contract makes the
        continuation reproduce the uninterrupted greedy rollout).
        ``generated`` is read ONCE, as a concurrent feed may extend it."""
        gen = list(req.generated)
        return {
            "prompt": list(req.prompt) + gen,
            "generated_prefix": list(req.prefix) + gen,
            "max_new_tokens": req.max_new_tokens - len(gen),
            "eos_id": req.eos_id, "temperature": req.temperature,
            "seed": req.seed,
        }

    def export_requests(self) -> List[dict]:
        """Queued + in-flight work as resubmittable dicts (one atomic
        scheduler snapshot).  Does not stop the engine."""
        active, pending = self.scheduler.snapshot()
        return [self._export_request(req)
                for req in [r for _, r in active] + pending]

    def drain(self) -> List[dict]:
        """Capture every queued and in-flight request as a continuation,
        then evict everything and stop admission.  The export is built
        from exactly the requests the scheduler's drain removed (one lock
        hold), so a submission racing the drain is either exported or
        rejected, never lost.  :meth:`import_requests` resubmits it."""
        with self._drain_lock:
            self._drained = True
            drained, pending = self._drain_and_finish(
                FinishReason.DRAINED)
        return [self._export_request(req) for req in drained + pending]

    def _free_all_slots(self) -> None:
        for slot in range(self.max_slots):
            if self.cache.length(slot) >= 0:
                self._free_slot(slot)

    def export_prefix_index(self) -> List[List[int]]:
        """The prefix cache's maximal cached chains as token-id lists
        (what a relaunched engine seeds from)."""
        return self.cache.export_prefixes()

    def seed_prefixes(self, prefixes: Sequence[Sequence[int]]) -> int:
        """Rebuild exported prefixes into this engine's cache: each chain
        prefills once through a ghost page row (no decode slot) and
        publishes with refcount zero, hittable and reclaimable.  Returns
        the number of pages seeded.  A prefill that raises returns its
        ghost pages to the free list and propagates (the reference logs
        it and goes on to the next chain; here a device or launch
        failure is never passed over)."""
        if not self.cache.prefix_enabled:
            return 0
        seeded = 0
        ps = self.cache.page_size
        for chain in prefixes:
            tokens = [int(t) for t in chain]
            n_pages = min(len(tokens) // ps, self.cache.pages_per_slot)
            if n_pages <= 0:
                continue
            tokens = tokens[:n_pages * ps]
            # +[0] sentinel: lookup_prefix matches STRICT prefixes only.
            if len(self.cache.lookup_prefix(tokens + [0])) >= n_pages:
                continue
            row = self.cache.alloc_ghost(n_pages)
            n = len(tokens)
            bucket = self._bucket_for(n)
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :n] = tokens
            try:
                self._prefill_exec(bucket)(self._tokens(row), 0, n,
                                           self._tokens(toks))
            except BaseException:
                self.cache.free_ghost(row)
                raise
            seeded += self.cache.publish_ghost(row, tokens)
        return seeded

    def _drain_and_finish(self, reason: str):
        """The shared eviction sequence (caller holds ``_drain_lock``):
        scheduler drain with ``reason``, free every KV slot, and finish
        the still-queued requests with the same reason so their blocked
        handlers answer at once.  Returns ``(drained, pending)``."""
        drained, pending = self.scheduler.drain(reason)
        self._free_all_slots()
        for req in pending:
            req.finish_reason = reason
            req.done.set()
        return drained, pending

    def abort_all(self) -> List[Request]:
        """Error recovery (the serve loop's path after a step raised):
        evict and FAIL every queued and in-flight request
        (``finish_reason`` "error" before ``done`` is set), free the KV
        slots, and re-open admission unless a :meth:`drain` is pending.
        Returns the failed requests.

        Multi-process: broadcasts an abort marker first, so followers
        blocked in :meth:`follow` free their mirrors too (reference
        :1332-1380).  A dead control plane must not stop the local
        recovery: the broadcast's failure is swallowed.  The broadcast
        is outside the lock (a wedged control plane would otherwise hold
        the drain family too)."""
        # The class threading contract, machine-checked: a stamped
        # runtime thread of another role entering here raises
        # ThreadRoleError (unstamped callers pass; reference :1354-1360).
        _athreads.require("serve-loop", "InferenceEngine.abort_all")
        if self._multiprocess():
            try:
                self._bcast({"abort": True})
            except Exception:  # noqa: BLE001 — see the docstring
                pass
        with self._drain_lock:
            drained, pending = self._drain_and_finish(FinishReason.ERROR)
            if not self._drained:
                self.scheduler.resume()
        return drained + pending

    def abort_request(self, req: Request,
                      reason: str = FinishReason.CLIENT_DISCONNECT) -> str:
        """Clean abort of ONE request (its client vanished): a queued
        request finishes at once; an active one is marked and evicted by
        the serve loop at its next iteration boundary.  Returns
        "queued"/"active"/"gone"."""
        disposition = self.scheduler.cancel(req, reason)
        _flight.record("serve_abort_request", req.rid, reason, disposition)
        return disposition

    def import_requests(self, exported: List[dict]) -> List[Request]:
        """Resubmit a drained export.  Continuations keep their
        already-generated prefix, so callers see uninterrupted results.
        A continuation this engine cannot admit (its prompt outgrew the
        capacity) is skipped with an exception event."""
        with self._drain_lock:
            if self._drained:
                self.scheduler.resume()
                self._drained = False
            out = []
            for d in exported:
                if d.get("max_new_tokens", 0) <= 0:
                    continue
                try:
                    out.append(self.submit(
                        d["prompt"], max_new_tokens=d["max_new_tokens"],
                        eos_id=d.get("eos_id"),
                        temperature=d.get("temperature", 0.0),
                        seed=d.get("seed", 0),
                        prefix=d.get("generated_prefix", [])))
                except ValueError as e:
                    _telemetry.exception_event(
                        "serve-import",
                        f"dropping unresumable continuation "
                        f"({len(d['prompt'])} prompt tokens vs "
                        f"capacity {self.capacity}): {e}")
        return out
