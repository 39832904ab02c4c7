"""Trace-time collective-program signature verifier (port of
horovod_tpu/analysis/program.py:1-493).

The coordinator (ops/coordinator.py) catches collective mismatches only at
negotiation, after every rank has queued work, and only for tensors that
reach the same name.  This module proves the same invariants earlier:

* every collective entry point appends a
  ``(name, op_kind, dtype, shape, reduce_op, process_set_id)`` record to
  this process's :class:`ProgramRecorder` (hook: ``ops/collective.py``
  ``_enqueue``, the funnel every frontend routes through);
* :func:`verify_program` hashes the per-rank signature and
  cross-validates it on rank 0 *before* any data-plane work, reporting the
  first divergent entry with both ranks' views.  The reference ships the
  signatures in TCP ``FRAME_SIGNATURE`` frames; the port's TCP control
  channel carries one lockstep exchange a cycle, so each worker's packed
  signature rides its next batch (``KIND_SIGNATURE``, ops/transport.py)
  and rank 0's verdict rides a broadcast (``PAYLOAD_SIGNATURE``), both on
  the thread that runs the cycle;
* :class:`ProgramTracker` is the automatic in-negotiation twin: fed by the
  coordinator as requests arrive (``HVD_TPU_VERIFY_PROGRAM=1``), it flags
  rank-divergent program *order* the moment the streams disagree.

Beyond the five runtime mismatch kinds (op, dtype, shape, reduce-op,
process-set), the comparison catches rank-divergent collective *count* and
process-set deadlock *cycles* (rank 0 issues set-A-then-set-B while rank 1
issues B-then-A).

Env: ``HVD_TPU_PROGRAM_RECORD=0`` stops the recording (default on),
``HVD_TPU_PROGRAM_WINDOW`` bounds it (default 65536 entries),
``HVD_TPU_VERIFY_PROGRAM=1`` arms the tracker (and turns the response
cache off, as in the reference), ``HVD_TPU_VERIFY_TIMEOUT`` is
:func:`verify_program`'s default wait (60 s).
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import json
import os
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Tuple
from . import lockorder as _lockorder
from . import races as _races

# Cap on retained records: verification aligns on absolute sequence
# numbers, so a long-running job keeps a sliding window instead of the
# whole history (the total count still rides the exchange, catching
# count divergence beyond the window).
PROGRAM_WINDOW = int(os.environ.get("HVD_TPU_PROGRAM_WINDOW", "65536"))


class SignatureEntry(NamedTuple):
    """One collective call in a rank's program signature."""

    seq: int                 # absolute position in this rank's program
    op: str                  # request kind: allreduce/allgather/...
    name: str                # wire tensor name
    dtype: str               # wire dtype name
    shape: Tuple[int, ...]   # this rank's payload shape
    reduce_op: str           # SUM/AVERAGE/... ("" for non-reductions)
    process_set_id: int      # 0 = the global set
    source: str = ""         # issuing frontend ("", "tf", "torch", ...)

    def describe(self) -> str:
        src = f", source={self.source}" if self.source else ""
        red = f", reduce_op={self.reduce_op}" if self.reduce_op else ""
        return (f"{self.op}(name={self.name!r}, dtype={self.dtype}, "
                f"shape={tuple(self.shape)}{red}, "
                f"process_set={self.process_set_id}{src})")


def _entry_mismatch(a: SignatureEntry, b: SignatureEntry) -> Optional[str]:
    """The first disagreeing field between two same-index entries, as a
    reference-style mismatch label — or None when the entries are
    compatible.  Shape rules follow the runtime validator: allgather
    ragged dim 0 is legal (operations.cc:334-392), alltoall compares
    trailing dims only; everything else is exact."""
    if a.name != b.name:
        return "Mismatched tensor names (rank-divergent program order)"
    if a.op != b.op:
        return "Mismatched collective operations"
    if a.process_set_id != b.process_set_id:
        return "Mismatched process sets"
    if a.dtype != b.dtype:
        return "Mismatched data types"
    if a.op in ("allgather", "alltoall"):
        if len(a.shape) != len(b.shape) or \
                tuple(a.shape[1:]) != tuple(b.shape[1:]):
            return "Mismatched tensor shapes"
    elif tuple(a.shape) != tuple(b.shape):
        return "Mismatched tensor shapes"
    if a.reduce_op != b.reduce_op:
        return "Mismatched reduce operations"
    return None


def _format_divergence(kind: str, rank_a: int, a: SignatureEntry,
                       rank_b: int, b: SignatureEntry) -> str:
    return (f"Collective program divergence at entry #{a.seq}: {kind}.\n"
            f"  rank {rank_a}: {a.describe()}\n"
            f"  rank {rank_b}: {b.describe()}")


def _find_cycle(rank_a: int, prog_a: List[SignatureEntry],
                rank_b: int, prog_b: List[SignatureEntry],
                i: int) -> Optional[str]:
    """Given the first divergent index ``i`` between two programs, test
    whether it is an ORDER SWAP across two process sets — the wait-for
    cycle no runtime check can catch.  X = rank_a's entry, Y = rank_b's
    entry at ``i``; a deadlock needs X and Y later on the *other* rank
    (both ranks will issue both ops) in swapped order, in different
    process sets (same-set swaps surface as that set's order
    divergence)."""
    x, y = prog_a[i], prog_b[i]
    if x.process_set_id == y.process_set_id:
        return None

    def _later(prog, entry) -> Optional[SignatureEntry]:
        for e in prog[i + 1:]:
            if e.name == entry.name and e.process_set_id == \
                    entry.process_set_id and e.op == entry.op:
                return e
        return None

    x_on_b = _later(prog_b, x)
    y_on_a = _later(prog_a, y)
    if x_on_b is None or y_on_a is None:
        return None
    pa, pb = x.process_set_id, y.process_set_id
    return (
        f"Potential process-set deadlock cycle: process sets "
        f"{pa} -> {pb} -> {pa} form a wait-for cycle.\n"
        f"  rank {rank_a} issues {x.describe()} (entry #{x.seq}) before "
        f"{y_on_a.describe()} (entry #{y_on_a.seq})\n"
        f"  rank {rank_b} issues {y.describe()} (entry #{y.seq}) before "
        f"{x_on_b.describe()} (entry #{x_on_b.seq})\n"
        f"Each set's coordinator sees a consistent stream, so no runtime "
        f"mismatch can fire; synchronous callers deadlock here.")


def compare_signatures(
        programs: Dict[int, List[SignatureEntry]],
        totals: Optional[Dict[int, int]] = None) -> Optional[str]:
    """Cross-validate per-rank program signatures.

    Returns ``None`` when every rank traced a compatible collective
    program, else a diagnostic naming the first divergent entry with
    both ranks' records.  ``totals`` carries each rank's lifetime
    collective count when the entry lists are a bounded window.
    """
    ranks = sorted(programs)
    if len(ranks) < 2:
        return None
    r0 = ranks[0]
    base = programs[r0]
    for r in ranks[1:]:
        other = programs[r]
        # Align by ABSOLUTE seq, not list position: bounded windows that
        # slid by different amounts (one rank traced extras before both
        # overflowed PROGRAM_WINDOW) would otherwise pair unrelated
        # entries and misreport the first divergence.
        a_list, b_list = base, other
        if a_list and b_list and a_list[0].seq != b_list[0].seq:
            start = max(a_list[0].seq, b_list[0].seq)
            a_list = a_list[start - a_list[0].seq:]
            b_list = b_list[start - b_list[0].seq:]
        for i, (a, b) in enumerate(zip(a_list, b_list)):
            kind = _entry_mismatch(a, b)
            if kind is None:
                continue
            cycle = _find_cycle(r0, a_list, r, b_list, i)
            if cycle is not None:
                return cycle
            return _format_divergence(kind, r0, a, r, b)
        n0 = totals[r0] if totals else len(base)
        n1 = totals[r] if totals else len(other)
        if n0 != n1:
            msg = (f"Rank-divergent collective count: rank {r0} recorded "
                   f"{n0} collectives but rank {r} recorded {n1}.")
            # Name the extra entry only when the higher-count rank's
            # window still holds it past the seq-aligned common prefix
            # (with offset sliding windows it may have slid out).
            longer_rank, longer = (r0, a_list) if n0 > n1 else (r, b_list)
            cut = min(len(a_list), len(b_list))
            if cut < len(longer):
                extra = longer[cut]
                msg += (f"\n  first unmatched entry (rank {longer_rank} "
                        f"only): {extra.describe()}")
            return msg
    return None


class ProgramRecorder:
    """This process's collective-program signature (thread-safe)."""

    def __init__(self, window: int = PROGRAM_WINDOW) -> None:
        self._lock = _lockorder.make_lock("analysis.ProgramRecorder._lock")
        self._entries: deque = deque(maxlen=window)
        self._total = 0

    def record(self, op: str, name: str, dtype: str,
               shape: Tuple[int, ...], reduce_op: str = "",
               process_set_id: int = 0, source: str = "") -> None:
        with self._lock:
            self._entries.append(SignatureEntry(
                seq=self._total, op=op, name=name, dtype=dtype,
                shape=tuple(int(d) for d in shape), reduce_op=reduce_op,
                process_set_id=int(process_set_id), source=source))
            self._total += 1

    def entries(self) -> List[SignatureEntry]:
        with self._lock:
            return list(self._entries)

    def total(self) -> int:
        with self._lock:
            return self._total

    def snapshot(self) -> Tuple[List[SignatureEntry], int]:
        """Atomic (entries, total) pair — verify_program must pack a
        consistent view while other threads may still be recording."""
        with self._lock:
            return list(self._entries), self._total

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._total = 0

    def digest(self) -> str:
        """SHA-256 over the canonical encoding of the signature — equal
        digests ⇒ byte-identical programs (the exchange's fast path)."""
        with self._lock:
            entries, total = list(self._entries), self._total
        return _digest(entries, total)


def _digest(entries: List[SignatureEntry], total: int) -> str:
    h = hashlib.sha256()
    h.update(str(total).encode())
    for e in entries:
        # source is per-rank provenance, not program content.
        h.update(repr(e[:7]).encode())
    return h.hexdigest()


def entries_digest(entries: List[SignatureEntry],
                   total: Optional[int] = None) -> str:
    """Public digest over a list of signature entries — the canonical
    program-identity scheme shared by verify_program's exchange and the
    response cache's cycle keys (ops/cache.py): equal digests ⇔
    identical programs under the same encoding everywhere."""
    return _digest(entries, len(entries) if total is None else total)


def pack_program(rank: int, entries: List[SignatureEntry],
                 total: int) -> bytes:
    return json.dumps({
        "rank": rank,
        "total": total,
        "digest": _digest(entries, total),
        "entries": [list(e) for e in entries],
    }).encode("utf-8")


def unpack_program(payload: bytes) -> Tuple[int, int, str,
                                            List[SignatureEntry]]:
    obj = json.loads(payload.decode("utf-8"))
    entries = [SignatureEntry(e[0], e[1], e[2], e[3], tuple(e[4]), e[5],
                              e[6], e[7] if len(e) > 7 else "")
               for e in obj["entries"]]
    return obj["rank"], obj["total"], obj["digest"], entries


def cross_validate(payloads: Dict[int, bytes]) -> Optional[str]:
    """Controller-side check over every rank's packed signature: equal
    digests short-circuit; otherwise decode and diff."""
    digests = {}
    programs: Dict[int, List[SignatureEntry]] = {}
    totals: Dict[int, int] = {}
    for r, payload in payloads.items():
        rank, total, digest, entries = unpack_program(payload)
        digests[r] = digest
        programs[r] = entries
        totals[r] = total
    if len(set(digests.values())) <= 1:
        return None
    return compare_signatures(programs, totals)


# ---------------------------------------------------------------------------
# Per-process recording (hooked from ops/collective._enqueue)
# ---------------------------------------------------------------------------

_recorder = ProgramRecorder()
_source: contextvars.ContextVar = contextvars.ContextVar(
    "hvd_tpu_collective_source", default="")


def recorder() -> ProgramRecorder:
    return _recorder


# Cached at import (like PROGRAM_WINDOW): recording sits on the
# per-collective dispatch path, so it must not re-read the environment
# every call.
_RECORDING = os.environ.get("HVD_TPU_PROGRAM_RECORD", "1") != "0"


def recording_enabled() -> bool:
    return _RECORDING


@contextlib.contextmanager
def collective_source(tag: str):
    """Tag collectives recorded inside the block with their issuing
    frontend — the TF/torch/Keras bridges wrap their dispatch in this so
    a divergence diagnostic names which binding issued the entry."""
    token = _source.set(tag)
    try:
        yield
    finally:
        _source.reset(token)


def tag_source(tag: str):
    """Decorator form of :func:`collective_source` — the one shared
    spelling the frontend entry points use."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with collective_source(tag):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def record_collective(op: str, name: str, dtype: str,
                      shape: Tuple[int, ...], reduce_op: str = "",
                      process_set_id: int = 0) -> None:
    if not recording_enabled():
        return
    _recorder.record(op, name, dtype, shape, reduce_op=reduce_op,
                     process_set_id=process_set_id,
                     source=_source.get())


# ---------------------------------------------------------------------------
# Coordinator-side automatic tracker (HVD_TPU_VERIFY_PROGRAM=1)
# ---------------------------------------------------------------------------

def program_check_enabled() -> bool:
    return os.environ.get("HVD_TPU_VERIFY_PROGRAM") == "1"


@_races.race_checked
class ProgramTracker:
    """Per-rank request streams as the coordinator's negotiation path
    sees them.  ``feed`` appends one request's signature and compares it
    against every other rank's entry at the same absolute position —
    divergent *order* (which the name-keyed table would stall on
    forever) is reported immediately, before any data-plane work.  The
    cross-checked common prefix is trimmed, so memory stays bounded by
    the ranks' skew, not the job length.

    Two self-disarms keep the tracker honest: a JOIN request disables
    it for the rest of the run (``hvd.join`` explicitly legalizes
    rank-divergent programs, so positional comparison would report
    false divergences on a healthy uneven workload), and a stream
    outgrowing ``PROGRAM_WINDOW`` entries — an idle peer pinning the
    trim — disables it rather than growing without bound."""

    def __init__(self, size: int,
                 window: int = PROGRAM_WINDOW) -> None:
        self.size = size
        self.window = window
        self._lock = _lockorder.make_lock("analysis.ProgramTracker._lock")
        self._disabled = False  # guarded_by: _lock
        self._streams: List[List[SignatureEntry]] = [[] for _ in range(size)]
        self._base = 0  # absolute seq of each stream's first entry

    def disable(self) -> None:
        with self._lock:
            self._disabled = True
            self._streams = [[] for _ in range(self.size)]

    def feed(self, req) -> Optional[str]:
        """Record one Request; returns a divergence diagnostic or None.
        A JOIN request disables tracking (see the class docstring)."""
        from ..ops import wire

        if req.request_type == wire.RequestType.JOIN:
            self.disable()
            return None
        entry = SignatureEntry(
            seq=0, op=req.request_type.name.lower(),
            name=req.tensor_name,
            dtype=wire.dtype_name(req.tensor_type),
            shape=tuple(req.tensor_shape),
            reduce_op=(wire.reduce_op_name(req.reduce_op)
                       if req.request_type.name in ("ALLREDUCE",
                                                    "REDUCESCATTER")
                       else ""),
            process_set_id=req.process_set_id)
        with self._lock:
            if self._disabled or not 0 <= req.request_rank < self.size:
                return None
            mine = self._streams[req.request_rank]
            idx = self._base + len(mine)
            entry = entry._replace(seq=idx)
            mine.append(entry)
            diag = None
            for r, stream in enumerate(self._streams):
                if r == req.request_rank:
                    continue
                off = idx - self._base
                if off < len(stream):
                    other = stream[off]
                    kind = _entry_mismatch(other, entry)
                    if kind is not None:
                        diag = _format_divergence(
                            kind, r, other, req.request_rank, entry)
                        break
            if diag is None:
                trim = min(len(s) for s in self._streams)
                if trim:
                    for s in self._streams:
                        del s[:trim]
                    self._base += trim
                elif len(mine) > self.window:
                    # An idle peer pins the trim; stop tracking instead
                    # of accumulating one entry per collective forever.
                    self._disabled = True
                    self._streams = [[] for _ in range(self.size)]
            return diag


# ---------------------------------------------------------------------------
# verify_program — the explicit pre-data-plane barrier check
# ---------------------------------------------------------------------------

class ProgramReport(NamedTuple):
    ranks: int
    entries: int
    digest: str


def verify_program(reset: bool = True,
                   timeout: Optional[float] = None) -> ProgramReport:
    """Cross-validate every rank's recorded collective program.

    Call it after issuing the collectives whose agreement you want
    proven -- typically right after the first training step -- before
    committing to the data plane.  With more than one rank each worker's
    signature rides its next control batch to rank 0, which diffs them
    and broadcasts the verdict; a divergence raises :class:`HorovodError`
    on every rank, naming the first divergent entry with both ranks'
    records.  One rank has exactly one program, so only the recording
    itself is reported (no exchange).

    Args:
      reset: clear the recorder afterwards (default), so successive
        phases verify independently.
      timeout: seconds to wait for the other ranks (default
        ``HVD_TPU_VERIFY_TIMEOUT``, 60).
    """
    from ..core import state as _state
    from ..ops.handles import HorovodError

    _state._check_initialized()
    size, rank = _state.size(), _state.rank()
    if timeout is None:
        timeout = float(os.environ.get("HVD_TPU_VERIFY_TIMEOUT", "60"))
    entries, total = _recorder.snapshot()
    report = ProgramReport(ranks=size, entries=total,
                           digest=_digest(entries, total))
    error: Optional[str] = None
    if size > 1:
        rt = _state._state.runtime
        payload = pack_program(rank, entries, total)
        if rank == 0:
            payloads = rt.collect_signatures(payload, timeout)
            error = cross_validate(payloads)
            rt.broadcast_signature_result(error, timeout)
        else:
            error = rt.exchange_signature(payload, timeout)
    if reset:
        _recorder.clear()
    if error is not None:
        raise HorovodError(error)
    return report
