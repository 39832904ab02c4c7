"""The negotiation response cache and the Tensor Fusion packing decision
(copied from horovod_tpu/ops/cache.py; ``ResponseCache`` :241-721,
``plan_fusion`` :152).

A training loop's collective program is the same every step, yet each
step pays the whole negotiation: one request per tensor and rank to rank
0, ``PyCoordinator.submit``, ``construct_response``'s cross-rank checks,
``plan_fusion`` and the response broadcast.  The cache takes those off
the steady state.

Every rank keeps a replica of one :class:`ResponseCache`.  Entries are
inserted in the order of the broadcast response stream, which every rank
executes in the same order, so entry index ``i`` names the same tensor on
every rank with no agreement round.  An entry keeps, per rank, the
request of the completed negotiation and the validated single-tensor
response.

A request equal to an entry's is a **hit**: the rank ships the entry's
index in its cycle batch instead of the request (the ``KIND_HITS``
record of :mod:`.transport`); when every rank of the entry's set has hit,
rank 0 replays the stored response (``submit`` and
``construct_response`` never run) and fuses the replayed responses with
a plan memoized per cycle key.  A cycle that is all replay broadcasts
entry indices, and the workers rebuild the responses from their replica.

Invalidation is an epoch change at the same stream position on every
rank: ``CACHE_FLUSH`` marker responses from rank 0 (``join``, a
withdrawal, a program change seen as a request whose name matches an
entry but whose fields differ, capacity overflow) and a deterministic
rule (the registration allgather of ``add_process_set`` /
``remove_process_set``).  A hit that raced a flush carries its old epoch;
rank 0 turns it back into the stored request and submits that
(downgrade).  ``join`` also disarms insertion until the JOIN release.

The flight recorder keeps each flush (``cache_flush``) and downgrade
(``cache_downgrade``), as in the reference.  The cache is off while the
program tracker runs (``HVD_TPU_VERIFY_PROGRAM=1``, ``analysis/
program.py``), and its lock and guarded fields carry the analysis
checkers (reference :96, :240-270).

Env contract (the reference's):
  HVD_TPU_RESPONSE_CACHE=0           disable (default on)
  HVD_TPU_RESPONSE_CACHE_CAPACITY    live entries before a flush (default
                                     4096; enforced on rank 0)
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..analysis import lockorder as _lockorder
from ..analysis import program as _program
from ..analysis import races as _races
from ..telemetry import flight as _flight
from . import wire
from .wire import Request, Response, ResponseType


# The signature records and their digest are the program verifier's
# (reference ops/cache.py:96-150 reuses them the same way).
SignatureEntry = _program.SignatureEntry
entries_digest = _program.entries_digest


# Retired epochs kept for stale-bit downgrade resolution.  Bits flow at
# the 5 ms drain cadence while flushes are rare events, so a handful of
# epochs is an enormous safety margin.
RETAINED_EPOCHS = 8

# Substrings of allgather names that mark a process-set membership
# change; observing one flushes the cache deterministically on every
# rank (ops/collective.py add_process_set / remove_process_set).
_MEMBERSHIP_MARKERS = ("process_set.register.", "process_set.remove.")


def cache_enabled() -> bool:
    """Env gate.  The cache is OFF while the in-negotiation program
    tracker runs (HVD_TPU_VERIFY_PROGRAM=1): cache hits bypass
    ``Coordinator.submit``, which would blind the tracker's positional
    streams and mis-pair later entries."""
    if os.environ.get("HVD_TPU_RESPONSE_CACHE", "1") == "0":
        return False
    return not _program.program_check_enabled()


def cache_capacity() -> int:
    return int(os.environ.get("HVD_TPU_RESPONSE_CACHE_CAPACITY", "4096"))


def request_key(req: Request) -> tuple:
    """Exact cache key: every negotiated field — name, op, dtype, shape,
    reduce op, process set, root, device, splits AND the submitting rank
    — so two ranks' (or two programs') requests collide only when they
    are identical, i.e. when replaying the cached response is exactly
    what negotiation would have produced.  A plain field tuple (not the
    packed wire bytes): this lookup runs once per collective per rank on
    the steady-state hot path, and tuple hashing is several times
    cheaper than re-serializing."""
    return (req.request_rank, req.request_type, req.tensor_type,
            req.tensor_name, req.root_rank, req.device,
            tuple(req.tensor_shape), req.reduce_op,
            req.process_set_id, tuple(req.splits))


def signature_of(req: Request) -> SignatureEntry:
    """The signature record of one request, for diagnostics and cycle
    digests."""
    return SignatureEntry(
        seq=0, op=req.request_type.name.lower(), name=req.tensor_name,
        dtype=wire.dtype_name(req.tensor_type),
        shape=tuple(req.tensor_shape),
        reduce_op=(wire.reduce_op_name(req.reduce_op)
                   if req.request_type in (wire.RequestType.ALLREDUCE,
                                           wire.RequestType.REDUCESCATTER)
                   else ""),
        process_set_id=req.process_set_id)


def cycle_digest(entries: List[SignatureEntry]) -> str:
    """Program digest of one cached cycle (the fusion-plan memo key's
    printable form)."""
    return entries_digest(entries)


@dataclass
class _FusionMeta:
    """The fields the fusion packing decision reads, per response."""

    response_type: ResponseType
    devices: Tuple[int, ...]
    reduce_op: wire.ReduceOp
    process_set_id: int
    dtype: Optional[wire.DataType]
    nbytes: int


def plan_fusion(metas: List[_FusionMeta],
                threshold_of: Callable[[int], int]) -> List[List[int]]:
    """The Tensor Fusion packing decision (≙ reference
    operations.cc:1328-1374), factored out of the coordinator's response
    loop so the cache can memoize it per cycle: same-dtype, same-device,
    same-reduce-op, same-process-set ALLREDUCE responses merge while the
    payload sum stays under the process set's fusion threshold; Adasum
    never fuses (its dot products are per-tensor scale adaptations).
    Returns index groups in emission order."""
    n = len(metas)
    used = [False] * n
    groups: List[List[int]] = []
    for i in range(n):
        if used[i]:
            continue
        used[i] = True
        m = metas[i]
        group = [i]
        if m.response_type != ResponseType.ALLREDUCE \
                or m.reduce_op == wire.ReduceOp.ADASUM:
            groups.append(group)
            continue
        total = m.nbytes
        threshold = threshold_of(m.process_set_id)
        for j in range(i + 1, n):
            if used[j]:
                continue
            o = metas[j]
            if (o.response_type == ResponseType.ALLREDUCE
                    and o.devices == m.devices
                    and o.reduce_op == m.reduce_op
                    and o.process_set_id == m.process_set_id
                    and o.dtype == m.dtype
                    and total + o.nbytes <= threshold):
                total += o.nbytes
                group.append(j)
                used[j] = True
        groups.append(group)
    return groups


def _nbytes_of_request(req: Request) -> int:
    n = 1
    for d in req.tensor_shape:
        n *= int(d)
    return n * wire.dtype_size(req.tensor_type)


@dataclass
class _Entry:
    """One cached negotiation outcome (a single tensor's response)."""

    idx: int
    name: str
    process_set_id: int
    # Validated single-tensor response template; replay copies it, never
    # mutates it (fusion extends name/shape lists on fresh objects).
    response: Response
    # global rank -> that rank's Request from the completed negotiation
    # (set-local request_rank inside, ready for a downgrade re-submit).
    # Empty on a rank that held no local op (process-set non-member):
    # such a placeholder keeps entry indices aligned across ranks but
    # can never be hit.
    requests: Dict[int, Request] = field(default_factory=dict)
    nbytes: int = 0
    dtype: Optional[wire.DataType] = None
    # Ranks that hit this entry in the current cycle.
    pending: set = field(default_factory=set)
    # False when any of this cycle's hits arrived as a full request
    # frame (a rank running with the cache disabled): the replay must
    # then broadcast full responses — that rank has no replica to
    # rebuild a compact replay broadcast from.
    compact_ok: bool = True


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    replayed_responses: int = 0
    replayed_tensors: int = 0
    plan_hits: int = 0
    plan_misses: int = 0
    flushes: int = 0
    downgrades: int = 0
    inserts: int = 0


@_races.race_checked
class ResponseCache:
    """One rank's replica of the negotiation response cache.

    Thread-safety: a single leaf lock — no other runtime lock is ever
    acquired while holding it (submit paths and the cycle call in).  Methods returning
    orphaned requests expect the CALLER to re-submit them outside the
    lock."""

    def __init__(self, rank: int = 0, capacity: Optional[int] = None):
        self.rank = rank
        self.capacity = capacity if capacity is not None \
            else cache_capacity()
        self._lock = _lockorder.make_lock("ResponseCache._lock")
        self._entries: List[_Entry] = []  # guarded_by: _lock
        self._by_key: Dict[tuple, Tuple[int, int]] = {}  # guarded_by: _lock
        self._by_name: Dict[str, int] = {}  # guarded_by: _lock
        self._ready: List[int] = []  # guarded_by: _lock
        self._retired: Dict[int, Dict[int, _Entry]] = {}  # guarded_by: _lock
        self._plans: Dict[tuple, List[List[int]]] = {}  # guarded_by: _lock
        self._epoch = 0  # guarded_by: _lock
        self._disarmed = False  # guarded_by: _lock
        # Controller-side: a pending CACHE_FLUSH marker to broadcast
        # (epoch, disarm) — consumed by the cycle.
        self._marker: Optional[Tuple[int, bool]] = None  # guarded_by: _lock
        # Controller-side staging: name -> {global rank -> Request} of
        # freshly completed negotiations, captured by the Coordinator
        # facade at poll time and consumed by observe_response.
        self._staged: Dict[str, Dict[int, Request]] = {}  # guarded_by: _lock
        self.stats = CacheStats()

    # -- introspection ----------------------------------------------------
    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def live_entries(self) -> int:
        with self._lock:
            return len(self._entries)

    def entry_index(self, name: str) -> Optional[int]:
        """Live entry index for a tensor name (tests + bench)."""
        with self._lock:
            return self._by_name.get(name)

    def signature_entries(self) -> List[SignatureEntry]:
        """Signatures of the live entries (diagnostics)."""
        with self._lock:
            return self._signature_entries_locked()

    def _signature_entries_locked(self) -> List[SignatureEntry]:
        out = []
        for e in self._entries:
            req = next(iter(e.requests.values()), None)
            if req is not None:
                out.append(signature_of(req))
        return out

    def _replica_id_locked(self) -> str:
        """Replica fingerprint for desync diagnostics: the program
        digest of the live entries —
        equal fingerprints across ranks ⇔ identical replicas."""
        return (f"epoch {self._epoch}, {len(self._entries)} entries, "
                f"digest {cycle_digest(self._signature_entries_locked())[:12]}")

    # -- flush / epoch machinery ------------------------------------------
    def _log(self, msg: str) -> None:
        print(f"[hvd-cache] rank {self.rank}: {msg}", file=sys.stderr)

    def _flush_locked(self, reason: str, disarm: bool,
                      broadcast: bool) -> List[Request]:
        orphans: List[Request] = []
        for idx in self._ready:
            # Ready-but-untaken entries: all ranks agreed, but the
            # replay never went out — downgrade every participant so
            # the ops still complete through a real negotiation.
            entry = self._entries[idx]
            entry.pending = set(entry.requests)
        for entry in self._entries:
            for r in sorted(entry.pending):
                req = entry.requests.get(r)
                if req is not None:
                    orphans.append(req)
            entry.pending = set()
        if self._entries:
            self._retired[self._epoch] = {e.idx: e for e in self._entries}
            for old in sorted(self._retired):
                if old <= self._epoch - RETAINED_EPOCHS:
                    del self._retired[old]
        n = len(self._entries)
        self._entries = []
        self._by_key = {}
        self._by_name = {}
        self._ready = []
        self._plans = {}
        self._epoch += 1
        self._disarmed = disarm or self._disarmed
        if broadcast:
            self._marker = (self._epoch, self._disarmed)
        self.stats.flushes += 1
        # Flight ring: epoch transitions are the divergence points a
        # forensic replay needs (record() takes no lock, so the cache
        # lock stays a leaf).
        _flight.record("cache_flush", reason, self._epoch, n)
        if n or disarm:
            self._log(f"cache flush ({reason}): {n} entries dropped, "
                      f"epoch {self._epoch}"
                      + (", insertion disarmed" if self._disarmed else ""))
        return orphans

    def flush(self, reason: str, disarm: bool = False,
              broadcast: bool = False) -> List[Request]:
        """Invalidate every live entry.  Returns the requests of any
        partially-hit entries — the caller MUST re-submit them through
        the real negotiation path (outside this cache's lock)."""
        with self._lock:
            return self._flush_locked(reason, disarm, broadcast)

    def disarm(self, reason: str) -> List[Request]:
        """hvd.join(): flush and stop inserting until the JOIN release
        (negotiations completed via joins lack the joined ranks'
        requests and must never become entries)."""
        return self.flush(reason, disarm=True, broadcast=True)

    def take_flush_marker(self) -> Optional[Response]:
        """Rank 0's cycle: the pending CACHE_FLUSH response to
        broadcast (epoch + disarm flag in tensor_sizes), or None."""
        with self._lock:
            if self._marker is None:
                return None
            epoch, disarm = self._marker
            self._marker = None
        return Response(ResponseType.CACHE_FLUSH,
                        tensor_sizes=[epoch, 1 if disarm else 0])

    def check_capacity(self) -> List[Request]:
        """Rank 0's cycle, before polling: flush when the entry
        table outgrew the capacity (rank-0-enforced so every replica
        flushes via the broadcast marker, even if their local env
        differs)."""
        with self._lock:
            if len(self._entries) <= self.capacity:
                return []  # flush only on OVERFLOW: a program with
                # exactly `capacity` tensors must still cache
            return self._flush_locked(
                f"capacity {self.capacity} exceeded", disarm=False,
                broadcast=True)

    def invalidate_plans(self, reason: str) -> None:
        """Autotune hook: a fusion-threshold change invalidates the
        memoized packing plans (entries stay valid — the negotiation
        outcome does not depend on the threshold)."""
        with self._lock:
            n = len(self._plans)
            self._plans = {}
        if n:
            self._log(f"fusion plans flushed ({reason}): {n} plans")

    # -- submit-side fast path --------------------------------------------
    def lookup_and_hit(self, req: Request) -> Tuple[str, object]:
        """Classify one locally-submitted request against the cache.

        Returns one of:
          ("hit", completed: bool)     — accounted; True when every rank
                                         of the entry's set has now hit
                                         (the entry joined the replay
                                         queue);
          ("miss", None)               — no entry; negotiate normally;
          ("conflict", orphans: list)  — the NAME matches a live entry
                                         but the request changed (the
                                         program changed mid-run): the
                                         cache flushed itself; the
                                         caller must submit the orphaned
                                         requests AND this one through
                                         the real path.
        """
        key = request_key(req)
        with self._lock:
            pos = self._by_key.get(key)
            if pos is not None:
                idx, grank = pos
                # A hit that arrived as a FULL request from another
                # rank (not a bit) means that rank may have no replica
                # (HVD_TPU_RESPONSE_CACHE off there): the replay must
                # then broadcast full responses it can parse, never the
                # compact entry-index frame.
                done = self._hit_locked(idx, grank,
                                        compact=grank == self.rank)
                self.stats.hits += 1
                return "hit", done
            if req.tensor_name in self._by_name:
                entry = self._entries[self._by_name[req.tensor_name]]
                old = next(iter(entry.requests.values()), None)
                desc = (signature_of(old).describe() if old is not None
                        else "<placeholder>")
                self._log(
                    f"program changed: {signature_of(req).describe()} no "
                    f"longer matches cached {desc}")
                orphans = self._flush_locked(
                    f"program change on {req.tensor_name!r}",
                    disarm=False, broadcast=True)
                self.stats.misses += 1
                return "conflict", orphans
            self.stats.misses += 1
            return "miss", None

    def worker_lookup(self, req: Request) -> Optional[Tuple[int, int]]:
        """Worker submit path: (epoch, entry idx) when the request hits
        the replica — the transport ships the bit — else None (ship the
        full request; rank 0 owns conflict/downgrade resolution)."""
        with self._lock:
            pos = self._by_key.get(request_key(req))
            if pos is None:
                self.stats.misses += 1
                return None
            self.stats.hits += 1
            return self._epoch, pos[0]

    def _hit_locked(self, idx: int, grank: int, compact: bool) -> bool:
        entry = self._entries[idx]
        entry.pending.add(grank)
        if not compact:
            entry.compact_ok = False
        if len(entry.pending) == len(entry.requests):
            entry.pending = set()
            self._ready.append(idx)
            return True
        return False

    def hit_from_wire(self, idx: int, grank: int,
                      epoch: int) -> Optional[Request]:
        """Controller: account one worker bit.  Returns None when
        accounted against a live entry; returns the stored Request to
        DOWNGRADE into a real submit when the bit raced a flush (its
        epoch names a retired generation); logs and drops a bit no
        retired generation can explain (the sender's own stall/withdraw
        machinery reports the op)."""
        with self._lock:
            if epoch == self._epoch and 0 <= idx < len(self._entries):
                entry = self._entries[idx]
                if grank in entry.requests:
                    self._hit_locked(idx, grank, compact=True)
                    return None
            retired = self._retired.get(epoch, {})
            entry = retired.get(idx)
            if entry is not None and grank in entry.requests:
                self.stats.downgrades += 1
                _flight.record("cache_downgrade", entry.name, grank,
                               epoch)
                return entry.requests[grank]
        self._log(f"dropping unresolvable cache bit (entry {idx}, rank "
                  f"{grank}, epoch {epoch}; current epoch {self.epoch})")
        return None

    # -- replay ------------------------------------------------------------
    def take_ready(self, threshold_of: Callable[[int], int]
                   ) -> Tuple[List[Response], List[List[int]], int, bool]:
        """Drain the fully-hit entries into fused replay responses.

        Returns (responses, index groups, epoch, compact_ok): the index
        groups let the transport broadcast the cycle as a compact
        replay (entry indices) when every hit was a true bit
        (``compact_ok``); workers rebuild the identical fused responses
        from their replicas.  The fusion packing is memoized per cycle
        key — the ordered entry indices — so the steady state never
        recomputes it (the cached-fusion-plan leg of the fast path).

        ``threshold_of`` runs under this cache's LEAF lock and must be
        pure — callers snapshot per-process-set thresholds beforehand
        (ops/collective._threshold_snapshot).
        """
        with self._lock:
            idxs, self._ready = self._ready, []
            if not idxs:
                return [], [], self._epoch, True
            entries = [self._entries[i] for i in idxs]
            compact = all(e.compact_ok for e in entries)
            for e in entries:
                e.compact_ok = True
            plan_key = tuple(idxs)
            plan = self._plans.get(plan_key)
            if plan is None:
                if len(self._plans) >= 256:
                    # Jittery tick partitioning of a stable program can
                    # mint a new ready-order key per step; bound the
                    # memo instead of growing for the job's lifetime.
                    self._plans = {}
                metas = [_FusionMeta(
                    response_type=e.response.response_type,
                    devices=tuple(e.response.devices),
                    reduce_op=e.response.reduce_op,
                    process_set_id=e.process_set_id,
                    dtype=e.dtype, nbytes=e.nbytes) for e in entries]
                plan = plan_fusion(metas, threshold_of)
                self._plans[plan_key] = plan
                self.stats.plan_misses += 1
            else:
                self.stats.plan_hits += 1
            groups = [[idxs[i] for i in g] for g in plan]
            responses = [self._build_group_locked(g) for g in groups]
            self.stats.replayed_responses += len(responses)
            self.stats.replayed_tensors += len(idxs)
            epoch = self._epoch
        return responses, groups, epoch, compact

    def _build_group_locked(self, idxs: List[int]) -> Response:
        r = self._entries[idxs[0]].response
        names: List[str] = []
        shapes: List[Tuple[int, ...]] = []
        for i in idxs:
            e = self._entries[i].response
            names.extend(e.tensor_names)
            shapes.extend(e.tensor_shapes)
        return Response(
            response_type=r.response_type, tensor_names=names,
            error_message="", devices=list(r.devices),
            tensor_sizes=list(r.tensor_sizes), tensor_type=r.tensor_type,
            tensor_shapes=shapes, reduce_op=r.reduce_op,
            process_set_id=r.process_set_id)

    def rebuild_groups(self, groups: List[List[int]],
                       epoch: int) -> List[Response]:
        """Worker: reconstitute a compact replay broadcast into the
        full fused response list from the local replica.  Raises when
        the epoch or an index cannot be resolved — a replica desync is a
        protocol bug and must fail loudly, not execute garbage."""
        with self._lock:
            if epoch != self._epoch:
                raise RuntimeError(
                    f"response-cache replica desync: controller replayed "
                    f"epoch {epoch} but this rank holds "
                    f"{self._replica_id_locked()}")
            for g in groups:
                for i in g:
                    if not 0 <= i < len(self._entries):
                        raise RuntimeError(
                            f"response-cache replica desync: controller "
                            f"replayed entry {i} but this rank holds "
                            f"{self._replica_id_locked()}")
            return [self._build_group_locked(g) for g in groups]

    # -- insertion (response-stream driven, identical order everywhere) ----
    def stage_negotiated(self, name: str,
                         requests: Dict[int, Request]) -> None:
        """Controller facade, at poll time: remember the per-rank
        requests of a freshly completed negotiation for the
        observe_response insertion that follows in the same tick."""
        with self._lock:
            self._staged[name] = requests

    def drop_staged(self, names: List[str]) -> None:
        with self._lock:
            self._drop_staged_locked(names)

    def _drop_staged_locked(self, names: List[str]) -> None:
        for n in names:
            self._staged.pop(n, None)

    def observe_response(self, resp: Response,
                         own_requests: Optional[Dict[int, Dict[
                             str, Request]]] = None,
                         replay: bool = False) -> None:
        """Process one broadcast response IN STREAM ORDER — the one rule
        that keeps every rank's replica index-aligned.  ``own_requests``
        (worker side) maps global rank -> {name -> Request} for this
        rank's own pending ops; the controller side uses the staged
        per-rank requests instead.

        Replayed responses are never inserted: rank 0 marks them
        explicitly (``replay=True`` — its replica may have flushed
        between building the replay and observing it), while workers
        skip them through the name-presence check (their replica cannot
        flush before the marker that follows the replays in-stream) —
        the two rules reach the same decision in every interleaving,
        which is what keeps entry indices aligned."""
        rt = resp.response_type
        if rt == ResponseType.CACHE_FLUSH:
            sizes = list(resp.tensor_sizes) + [0, 0]
            epoch, disarm = int(sizes[0]), bool(sizes[1])
            with self._lock:
                if epoch > self._epoch:
                    self._flush_locked("flush marker from rank 0",
                                       disarm=disarm, broadcast=False)
                    # Adopt rank 0's numbering exactly (several flushes
                    # may collapse into one observed marker).
                    self._epoch = epoch
                elif disarm:
                    self._disarmed = True
            return
        if rt == ResponseType.RETUNE:
            # hvd-tune's knob marker (tuning/actuation.py): every rank's
            # executor applies it at this same stream position; the
            # negotiated outcome does not depend on the knobs, so entries
            # stay valid.
            return
        if rt == ResponseType.JOIN:
            with self._lock:
                if self._disarmed:
                    self._disarmed = False
                    self._log("insertion re-armed (join released)")
            return
        if rt in (ResponseType.ERROR, ResponseType.SHUTDOWN,
                  ResponseType.DONE):
            self.drop_staged(list(resp.tensor_names))
            return
        if not replay:
            self._insert_from(resp, own_requests or {})
        # Deterministic membership-change rule: the registration
        # allgather names the event; every rank flushes at this exact
        # stream position (single-process registration flushes directly
        # from add/remove_process_set instead).
        if rt == ResponseType.ALLGATHER and any(
                m in n for n in resp.tensor_names
                for m in _MEMBERSHIP_MARKERS):
            orphans = self.flush("process-set membership change")
            if orphans:
                # Cannot happen on a healthy stream (a membership change
                # is collective, so no cached cycle is mid-flight), but
                # never swallow a submission silently.
                self._log(f"dropping {len(orphans)} mid-flight cached "
                          f"submissions across a membership change")

    def _insert_from(self, resp: Response,
                     own_requests: Dict[int, Dict[str, Request]]) -> None:
        with self._lock:
            if self._disarmed:
                self._drop_staged_locked(list(resp.tensor_names))
                return
            for pos, name in enumerate(resp.tensor_names):
                if name in self._by_name:
                    continue
                staged = True
                reqs = self._staged.pop(name, None)
                if reqs is None:
                    staged = False
                    reqs = {}
                    for grank, by_name in own_requests.items():
                        req = by_name.get(name)
                        if req is not None:
                            reqs[grank] = req
                if os.environ.get("HVD_TPU_CACHE_DEBUG") == "1":
                    self._log(f"insert entry {len(self._entries)} "
                              f"{name!r} ranks={sorted(reqs)} "
                              f"{'staged' if staged else 'fallback'}")
                single = self._single_response(resp, pos)
                sample = next(iter(reqs.values()), None)
                entry = _Entry(
                    idx=len(self._entries), name=name,
                    process_set_id=resp.process_set_id, response=single,
                    requests=reqs,
                    nbytes=(_nbytes_of_request(sample)
                            if sample is not None else 0),
                    dtype=(sample.tensor_type if sample is not None
                           else resp.tensor_type))
                self._entries.append(entry)
                self._by_name[name] = entry.idx
                for grank, req in reqs.items():
                    self._by_key[request_key(req)] = (entry.idx, grank)
                self.stats.inserts += 1

    @staticmethod
    def _single_response(resp: Response, pos: int) -> Response:
        """The single-tensor slice of a (possibly fused) data response —
        what replay re-fuses from.  Non-fusing response types (only
        ALLREDUCE fuses) keep their full metadata."""
        if len(resp.tensor_names) == 1:
            shapes = [tuple(s) for s in resp.tensor_shapes]
        else:
            shapes = ([tuple(resp.tensor_shapes[pos])]
                      if pos < len(resp.tensor_shapes) else [])
        return Response(
            response_type=resp.response_type,
            tensor_names=[resp.tensor_names[pos]], error_message="",
            devices=list(resp.devices),
            tensor_sizes=list(resp.tensor_sizes),
            tensor_type=resp.tensor_type, tensor_shapes=shapes,
            reduce_op=resp.reduce_op,
            process_set_id=resp.process_set_id)
