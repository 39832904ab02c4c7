"""The tree overlay of the control channel (port of horovod_tpu/ops/tree.py):
at ``HVD_TPU_TREE_THRESHOLD`` ranks (default 64, or always with
``HVD_TPU_TREE=on``) the star becomes a ``HVD_TPU_TREE_FANOUT``-ary tree
(default 8), so rank 0 receives one frame a direct child a cycle instead
of one a worker.

* **Upward**: an interior waits in its cycle's ``gather`` for the batch
  of each live child link and sends its own batch and its subtree's as
  ONE merged ``FRAME_SUBTREE_BATCH`` (:func:`merge_batch_items`): the
  cache-hit records that two or more ranks share, by ``(epoch, entry
  indices)``, travel as one section, so in the steady state, where every
  rank hits the same entries, a whole subtree's hits are one section,
  and each rank's batch keeps the rest of its messages with a reference
  in place of each grouped record.  Rank 0 expands the envelope
  (:func:`expand_subtree_batch`) into the per-rank batches the flat star
  gives it, byte for byte, so the negotiation, and the response stream
  every cache replica follows, are the flat ones.  Metrics and trace
  pulls ride the batches (the reference's ``FRAME_METRICS_TREE``/
  ``FRAME_TRACE_TREE`` are not sent).
* **Downward**: an interior relays every frame from its parent to its
  children verbatim, before it acts on it (``allow_dup=False``), so each
  rank's stream is rank 0's broadcast stream and rank 0 keeps ONE shared
  replay ring.
* **Self-healing**: a rank whose parent link dies reconnects straight to
  rank 0's session-resume listener, which adopts it as a direct child
  and replays the stream from its global index; the rank replays its
  upward suffix, and rank 0 drops batches it already took (each carries
  its sequence number).  An interior whose child link stays dead past
  the grace window reports ``FRAME_CHILD_LOST``; only rank 0 decides a
  rank is lost.  ``tree.relay_reset`` (chaos) fires in the relay.

Every rank derives the same layout from the world size, the fanout and
``HVD_TPU_VIRTUAL_SLICES``.  ``core/state.py`` passes each interior's
relay listener address through the host exchange at ``init``; a
transport built by hand finds it with :func:`parent_address`
(``HVD_TPU_TREE_PORT_BASE``, ``HVD_TPU_TREE_HOSTS``).  The tree knobs ride
the HELLO fingerprint (``ops/compression.env_fingerprint``).
"""

from __future__ import annotations

import os
import socket
import struct
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import transport as T
from .. import chaos as _chaos
from .. import telemetry as _telemetry
from ..analysis import lockorder as _lockorder
from ..analysis import races as _races
from ..analysis import threads as _athreads
from ..telemetry import flight as _flight

# -- copied from horovod_tpu/ops/tree.py:88-321 (it imports no JAX; the
# -- port's pulls ride the cycle batch, so its pull_timeout is left out) --

TREE_ENV = "HVD_TPU_TREE"
FANOUT_ENV = "HVD_TPU_TREE_FANOUT"
THRESHOLD_ENV = "HVD_TPU_TREE_THRESHOLD"
PORT_BASE_ENV = "HVD_TPU_TREE_PORT_BASE"
HOSTS_ENV = "HVD_TPU_TREE_HOSTS"


def tree_mode() -> str:
    mode = os.environ.get(TREE_ENV, "auto").lower()
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"{TREE_ENV}={mode!r}: expected auto, on or off")
    return mode


def tree_fanout() -> int:
    v = int(os.environ.get(FANOUT_ENV, "8"))
    if v < 1:
        raise ValueError(f"{FANOUT_ENV}={v}: expected >= 1")
    return v


def tree_threshold() -> int:
    return int(os.environ.get(THRESHOLD_ENV, "64"))


def validate_env() -> None:
    """Fail ``hvd.init()`` — not the first drain tick — on malformed
    tree knobs (the same up-front contract every other control-plane
    knob follows)."""
    tree_mode()
    tree_fanout()
    tree_threshold()
    base = os.environ.get(PORT_BASE_ENV)
    if base:
        int(base)
    hosts = os.environ.get(HOSTS_ENV)
    if hosts:
        _parse_hosts(hosts)


def tree_active(world: int) -> bool:
    """Whether the overlay is armed for this world size."""
    mode = tree_mode()
    if mode == "off" or world < 3:
        return False
    if mode == "on":
        return True
    return world >= tree_threshold()


def _parse_hosts(spec: str) -> Dict[int, str]:
    out: Dict[int, str] = {}
    for kv in spec.split(","):
        kv = kv.strip()
        if not kv:
            continue
        r, _, h = kv.partition("=")
        out[int(r)] = h
    return out


def relay_port(controller_port: int, rank: int) -> int:
    """Deterministic relay listen port for an interior rank — every
    rank derives the same map with no extra rendezvous round."""
    base = int(os.environ.get(PORT_BASE_ENV, "0") or 0)
    if not base:
        base = controller_port + 1000
    return base + rank


def parent_address(controller_host: str, controller_port: int,
                   parent: int) -> Tuple[str, int]:
    """Where a child connects: the controller itself for parent 0,
    otherwise the parent's relay listener (host from HVD_TPU_TREE_HOSTS
    when the fleet spans machines; the controller host by default —
    the single-host multiprocess deployment)."""
    if parent == 0:
        return controller_host, controller_port
    host = _parse_hosts(os.environ.get(HOSTS_ENV, "")).get(
        parent, controller_host)
    return host, relay_port(controller_port, parent)


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

def _slice_table(world: int) -> Optional[List[int]]:
    """Slice id per rank, from the same HVD_TPU_VIRTUAL_SLICES contract
    ``core/topology.replica_hierarchy`` applies to the replica axis —
    contiguous equal blocks, or None when the process space is flat."""
    k = int(os.environ.get("HVD_TPU_VIRTUAL_SLICES", "0") or 0)
    if k > 1 and world % k == 0 and world // k >= 1:
        ici = world // k
        return [r // ici for r in range(world)]
    return None


@dataclass(frozen=True)
class TreeLayout:
    """The agreed tree shape: every rank derives the identical layout
    from (world, fanout, slice table) with no communication."""

    world: int
    fanout: int
    order: Tuple[int, ...]          # heap order; order[0] == 0
    pos: Dict[int, int]             # rank -> index in order

    def parent(self, rank: int) -> Optional[int]:
        i = self.pos[rank]
        if i == 0:
            return None
        return self.order[(i - 1) // self.fanout]

    def children(self, rank: int) -> Tuple[int, ...]:
        i = self.pos[rank]
        lo = i * self.fanout + 1
        return tuple(self.order[j]
                     for j in range(lo, min(lo + self.fanout,
                                            len(self.order))))

    def subtree(self, rank: int) -> Tuple[int, ...]:
        """The rank and every descendant (preorder)."""
        out = [rank]
        stack = list(self.children(rank))
        while stack:
            r = stack.pop()
            out.append(r)
            stack.extend(self.children(r))
        return tuple(out)

    def is_interior(self, rank: int) -> bool:
        return rank != 0 and bool(self.children(rank))

    def interior_ranks(self) -> Tuple[int, ...]:
        return tuple(r for r in self.order if self.is_interior(r))

    def depth(self) -> int:
        """Edges on the longest root-to-leaf path."""
        d = 0
        n = len(self.order)
        i = n - 1
        while i > 0:
            i = (i - 1) // self.fanout
            d += 1
        return d


def build_layout(world: int, fanout: Optional[int] = None,
                 slices: Optional[Sequence[int]] = None) -> TreeLayout:
    """Derive the tree shape.  Ranks order slice-major (ICI x DCN:
    subtrees nest inside slices so aggregation rides the fast links),
    rank 0 always the root; then a ``fanout``-ary heap over that
    order."""
    if fanout is None:
        fanout = tree_fanout()
    if slices is None:
        slices = _slice_table(world)
    rest = [r for r in range(world) if r != 0]
    if slices is not None:
        rest.sort(key=lambda r: (slices[r], r))
    order = tuple([0] + rest)
    return TreeLayout(world=world, fanout=fanout, order=order,
                      pos={r: i for i, r in enumerate(order)})


def expected_root_frames(world: int, fanout: Optional[int] = None) -> int:
    """Frames rank 0 receives per steady-state tick under the tree —
    one merged envelope per direct child (vs world-1 flat)."""
    return len(build_layout(world, fanout).children(0))


def depth_bound(world: int, fanout: Optional[int] = None) -> int:
    return max(1, build_layout(world, fanout).depth())


# ---------------------------------------------------------------------------
# Wire helpers (handshake + merged frames)
# ---------------------------------------------------------------------------

def pack_hello_tree(entries: List[Tuple[int, str, str]]) -> bytes:
    """``entries`` = (rank, hostname, env fingerprint) for a whole
    subtree, the subtree's own root FIRST (the controller reads
    ``entries[0]`` as the connecting child)."""
    out = [struct.pack("<H", len(entries))]
    for rank, host, fp in entries:
        hb = host.encode("utf-8")
        fb = fp.encode("utf-8")
        out.append(struct.pack("<iH", rank, len(hb)) + hb
                   + struct.pack("<H", len(fb)) + fb)
    return b"".join(out)


def parse_hello_tree(payload: bytes) -> List[Tuple[int, str, str]]:
    (n,) = struct.unpack_from("<H", payload)
    off = 2
    out = []
    for _ in range(n):
        rank, hlen = struct.unpack_from("<iH", payload, off)
        off += 6
        host = payload[off:off + hlen].decode("utf-8")
        off += hlen
        (flen,) = struct.unpack_from("<H", payload, off)
        off += 2
        fp = payload[off:off + flen].decode("utf-8")
        off += flen
        out.append((rank, host, fp))
    return out


def pack_topo_tree(cache_flag: int,
                   entries: List[Tuple[int, "T.Topology"]]) -> bytes:
    out = [struct.pack("<BH", cache_flag, len(entries))]
    for rank, t in entries:
        out.append(struct.pack("<iiiii", rank, t.local_rank,
                               t.local_size, t.cross_rank, t.cross_size))
    return b"".join(out)


def parse_topo_tree(payload: bytes) -> Tuple[int, Dict[int, "T.Topology"]]:
    cache_flag, n = struct.unpack_from("<BH", payload)
    off = 3
    out: Dict[int, T.Topology] = {}
    for _ in range(n):
        rank, lr, ls, cr, cs = struct.unpack_from("<iiiii", payload, off)
        off += 20
        out[rank] = T.Topology(lr, ls, cr, cs)
    return cache_flag, out


# ---------------------------------------------------------------------------
# The merged envelope (reference :340-489 and :1070, on the port's batches)
# ---------------------------------------------------------------------------
#
# FRAME_SUBTREE_BATCH payload: <H nsections>, then typed sections, the hit
# sections first:
#   kind 0 hits:   <B 0><I epoch><H nranks><i*nranks><H nidx><I*nidx>, the
#                  reference's bits section byte for byte: each listed rank
#                  (two or more) sent a KIND_HITS record of exactly these
#                  entry indices, in this order, at this epoch
#   kind 4 batch:  <B 4><i rank><Q seq><I cum><B nref><I len> + one rank's
#                  batch, each of its nref grouped KIND_HITS records
#                  replaced by a KIND_HITS_REF message, <B 20><H index of
#                  its hit section>; a record no other rank of the
#                  envelope sent stays in place.  ``cum`` counts the rank's
#                  upward frames folded in so far (the re-parent resume's
#                  count; 0 for the sender's own)
# The reference's counts section (kind 3) is not sent: each rank's count
# rides its batch section.
#
# A steady-state envelope of n >= 2 ranks that each hit the same h entries
# and sent nothing else is 2 + (9 + 4n + 4h) + n * STEADY_BATCH_BYTES bytes,
# each batch section one KIND_TRACE_CTX message (25 B) longer when the post
# was traced (``HVD_TPU_TRACE``, on by default).  A rank whose records are
# not grouped costs its 22-byte section head where the batches' plain
# concatenation took 20 (an <I cum><I len> entry head and <i rank><Q seq>).

_SEC_BITS, _SEC_BATCH = 0, 4
_BITS_HEAD = struct.Struct("<BIH")
_BATCH_HEAD = struct.Struct("<BiQIBI")
_REF = struct.Struct("<BH")
# A batch section holding one hit reference and nothing else.
STEADY_BATCH_BYTES = _BATCH_HEAD.size + _REF.size


def parse_request_batch(payload: bytes) -> Tuple[
        int, int, List[Tuple[Tuple[int, Tuple[int, ...]], int, int]]]:
    """``(rank, seq, hits)`` of one ``FRAME_REQUEST_BATCH`` payload, the
    interior's parse side of the merge: ``hits`` holds ``((epoch, entry
    indices), start, end)`` for each KIND_HITS record in order,
    ``payload[start:end]`` the record.  Raises ValueError (or
    ``struct.error``) on a batch it cannot read."""
    rank, seq = T._CYCLE.unpack_from(payload)
    hits = []
    for kind, start, end in T.iter_messages(payload, T._CYCLE.size):
        if kind == T.KIND_HITS:
            epoch, count = struct.unpack_from("<II", payload, start + 1)
            hits.append(((epoch, struct.unpack_from(
                f"<{count}I", payload, start + 9)), start, end))
        elif kind == T.KIND_HITS_REF:
            raise ValueError("control batch: a hit reference in a rank's "
                             "batch")
    return rank, seq, hits


def merge_batch_items(entries: List[Tuple[int, bytes]]) -> Tuple[
        List[Tuple[int, Tuple[int, ...], Tuple[int, ...]]],
        List[Tuple[int, int, int, int, bytes]]]:
    """Group one cycle's batches for an envelope.  ``entries``: ``(cum,
    FRAME_REQUEST_BATCH payload)`` in wire order (the interior's own, then
    each child link's).  Hit records group by ``(epoch, entry indices in
    their order)`` across ranks, and a group of two or more ranks becomes
    a hit section: the steady state collapses a subtree into one.  The
    reference groups by the sorted index set (its :486), and a single
    rank too; the port keeps the order, since rank 0 replays downgraded
    hits in wire order.  Returns ``bits``, ``(epoch, ranks, indices)``
    groups in the reference's order, and ``batches``, ``(rank, seq, cum,
    nref, body)`` in entry order, each body its batch with a reference in
    place of each grouped record.  A batch the walk cannot read, or whose
    records do not fit the sections, goes up whole."""
    groups: Dict[Tuple[int, Tuple[int, ...]], set] = {}
    split = []
    for cum, payload in entries:
        rank, seq = T._CYCLE.unpack_from(payload)
        try:
            hits = parse_request_batch(payload)[2]
        except (ValueError, struct.error):
            hits = []
        if len(hits) > 0xFF or any(len(key[1]) > 0xFFFF
                                   for key, _s, _e in hits):
            hits = []
        for key, _s, _e in hits:
            groups.setdefault(key, set()).add(rank)
        split.append((rank, seq, cum, payload, hits))
    keys = sorted(key for key, ranks in groups.items() if len(ranks) > 1)
    index = {key: i for i, key in enumerate(keys)}
    bits = [(key[0], tuple(sorted(groups[key])), key[1]) for key in keys]
    batches = []
    for rank, seq, cum, payload, hits in split:
        body, off = [], T._CYCLE.size
        for key, start, end in hits:
            if key in index:
                body += [payload[off:start],
                         _REF.pack(T.KIND_HITS_REF, index[key])]
                off = end
        body.append(payload[off:])
        batches.append((rank, seq, cum, (len(body) - 1) // 2,
                        b"".join(body)))
    return bits, batches


def pack_subtree_batch(
        bits: List[Tuple[int, Tuple[int, ...], Tuple[int, ...]]],
        batches: Sequence[Tuple[int, int, int, int, bytes]] = ()) -> bytes:
    """Assemble one envelope from :func:`merge_batch_items`' ``bits`` and
    ``batches``."""
    out = [struct.pack("<H", len(bits) + len(batches))]
    for epoch, ranks, idxs in bits:
        out.append(_BITS_HEAD.pack(_SEC_BITS, epoch, len(ranks))
                   + struct.pack(f"<{len(ranks)}iH{len(idxs)}I", *ranks,
                                 len(idxs), *idxs))
    for rank, seq, cum, nref, body in batches:
        out.append(_BATCH_HEAD.pack(_SEC_BATCH, rank, seq, cum, nref,
                                    len(body)) + body)
    return b"".join(out)


def iter_subtree_sections(payload: bytes):
    """Yield the envelope's sections: ``("bits", epoch, ranks, idxs)`` and
    ``("batch", rank, seq, cum, nref, body)``."""
    (n,) = struct.unpack_from("<H", payload)
    off = 2
    for _ in range(n):
        kind = payload[off]
        if kind == _SEC_BITS:
            _k, epoch, nranks = _BITS_HEAD.unpack_from(payload, off)
            off += _BITS_HEAD.size
            ranks = struct.unpack_from(f"<{nranks}i", payload, off)
            off += 4 * nranks
            (nidx,) = struct.unpack_from("<H", payload, off)
            idxs = struct.unpack_from(f"<{nidx}I", payload, off + 2)
            off += 2 + 4 * nidx
            yield ("bits", epoch, list(ranks), list(idxs))
        elif kind == _SEC_BATCH:
            _k, rank, seq, cum, nref, blen = _BATCH_HEAD.unpack_from(
                payload, off)
            off += _BATCH_HEAD.size
            yield ("batch", rank, seq, cum, nref, payload[off:off + blen])
            off += blen
        else:
            raise ValueError(f"subtree envelope: unknown section kind "
                             f"{kind} at byte {off}")


def expand_subtree_batch(payload: bytes) -> Tuple[List[Tuple[int, bytes]],
                                                  int]:
    """Rank 0's (and an interior's, for a child's envelope) inverse of the
    merge: ``([(cum, FRAME_REQUEST_BATCH payload)], hit sections)``, one
    payload a batch section in wire order, each hit reference replaced by
    its section's KIND_HITS record -- byte for byte the payload the rank
    sent."""
    records: List[Tuple[set, bytes]] = []
    out: List[Tuple[int, bytes]] = []
    for sec in iter_subtree_sections(payload):
        if sec[0] == "bits":
            _k, epoch, ranks, idxs = sec
            records.append((set(ranks), struct.pack(
                f"<BII{len(idxs)}I", T.KIND_HITS, epoch, len(idxs), *idxs)))
            continue
        _k, rank, seq, cum, nref, body = sec
        if nref:
            body = _fill_refs(body, records, rank, nref)
        out.append((cum, T.batch_payload(rank, seq, body)))
    return out, len(records)


def _fill_refs(body: bytes, records: List[Tuple[set, bytes]], rank: int,
               nref: int) -> bytes:
    out: List[bytes] = []
    off = 0
    for kind, start, end in T.iter_messages(body):
        if kind == T.KIND_HITS_REF:
            ranks, record = records[struct.unpack_from("<H", body,
                                                       start + 1)[0]]
            if rank not in ranks:
                raise ValueError(f"subtree envelope: rank {rank} refers "
                                 f"to a hit section that does not list it")
            out += [body[off:start], record]
            off = end
    if len(out) != 2 * nref:
        raise ValueError(f"subtree envelope: rank {rank}'s batch holds "
                         f"{len(out) // 2} hit references, not {nref}")
    out.append(body[off:])
    return b"".join(out)


def steady_envelope(layout: TreeLayout, child: int, epoch: int,
                    idxs: Sequence[int]) -> bytes:
    """The envelope direct child ``child`` of rank 0 sends in its first
    steady-state cycle: every rank of its subtree hit the same cache
    entries and sent nothing else -- built through the same merge the
    live interiors run."""
    batch = T.encode_hits([(epoch, i) for i in idxs])
    entries = [(0 if r == child else 1, T.batch_payload(r, 1, batch))
               for r in layout.subtree(child)]
    return pack_subtree_batch(*merge_batch_items(entries))


# ---------------------------------------------------------------------------
# The tree worker (reference :196-734, on the port's lockstep cycle)
# ---------------------------------------------------------------------------

@dataclass
class _ChildLink:
    """One accepted child connection on an interior's relay listener:
    its socket (None once dropped), the ranks its subtree covers, the
    frames received, the cycle entries not yet sent up, and the grace
    bookkeeping."""

    rank: int
    conn: Optional[socket.socket]
    covers: set = field(default_factory=set)
    rx_count: int = 0
    items: List[Tuple[int, bytes]] = field(default_factory=list)
    grace_deadline: Optional[float] = None
    reported: bool = False
    left: bool = False


# Sequence of a SHUTDOWN an interior hands its children when it loses the
# controller for good: newer than any broadcast, outside rank 0's stream.
_POISON_SEQ = (1 << 63) - 1


@_races.race_checked
class TreeWorkerTransport(T.WorkerTransport):
    """A non-root rank under the tree overlay: a leaf is a worker whose
    "controller" is its parent's relay listener; an interior also
    accepts its children, merges their cycle batches into its own
    upward frame and relays the downward stream.  Reconnects always go
    to rank 0 (the re-parent path)."""

    def __init__(self, host: str, port: int, rank: int, layout: TreeLayout,
                 hostname: Optional[str] = None,
                 connect_timeout: Optional[float] = None,
                 parent_addr: Optional[Tuple[str, int]] = None,
                 listen_sock: Optional[socket.socket] = None) -> None:
        self.layout = layout
        self.rank = rank
        self._root_host, self._root_port = host, port
        self._reparented = False
        self._children_ranks = layout.children(rank)
        self._links_lock = _lockorder.make_lock(
            "TreeWorkerTransport._links_lock")
        self._child_cond = threading.Condition(self._links_lock)
        self._links: Dict[int, _ChildLink] = {}  # guarded_by: _links_lock
        # Frames from the parent that arrive before the children have
        # their TOPO_TREE wait here, so every child's stream starts at
        # global index 0.
        self._relay_ready = False  # guarded_by: _links_lock
        self._relay_buffer: List[Tuple[int, bytes]] = []  # guarded_by: _links_lock
        self._child_hellos: Dict[int, List[Tuple[int, str, str]]] = {}
        self._srv = listen_sock
        if self._children_ranks:
            self._accept_children(port)
        parent = layout.parent(rank)
        if parent_addr is None:
            parent_addr = parent_address(host, port, parent)
        super().__init__(parent_addr[0], parent_addr[1], rank,
                         hostname=hostname, connect_timeout=connect_timeout)
        if self._children_ranks:
            self._finish_children()

    # -- bootstrap ---------------------------------------------------------
    def _accept_children(self, controller_port: int) -> None:
        srv = self._srv
        if srv is None:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("0.0.0.0", relay_port(controller_port, self.rank)))
            srv.listen(len(self._children_ranks))
        accept_timeout = T._connect_timeout()
        srv.settimeout(accept_timeout)
        self._srv = srv
        got: Dict[int, socket.socket] = {}
        for _ in range(len(self._children_ranks)):
            try:
                conn, _addr = srv.accept()
            except socket.timeout:
                missing = sorted(set(self._children_ranks) - set(got))
                raise TimeoutError(
                    f"tree rank {self.rank}: child ranks {missing} did not "
                    f"connect within {accept_timeout}s") from None
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            ftype, payload = T._recv_frame(conn)
            if ftype != T.FRAME_HELLO_TREE:
                raise RuntimeError(
                    f"tree rank {self.rank}: expected HELLO_TREE from a "
                    f"child, got {T.frame_name(ftype)}")
            entries = parse_hello_tree(payload)
            child = entries[0][0]
            self._child_hellos[child] = entries
            got[child] = conn
            with self._links_lock:
                self._links[child] = _ChildLink(
                    rank=child, conn=conn, covers={r for r, _h, _f in entries})
        # Reconnects go to rank 0, never back through an interior.
        srv.close()
        self._srv = None

    def _handshake(self, hostname: Optional[str]) -> None:
        from . import compression as _compression

        entries = [(self.rank, hostname or socket.gethostname(),
                    _compression.env_fingerprint())]
        for child in self._children_ranks:
            entries.extend(self._child_hellos.get(child, []))
        T._send_frame(self._sock, T.FRAME_HELLO_TREE,
                      pack_hello_tree(entries))
        ftype, payload = T._recv_frame(self._sock)
        if ftype != T.FRAME_TOPO_TREE:
            raise RuntimeError(f"tree rank {self.rank} expected TOPO_TREE "
                               f"from its parent, got {T.frame_name(ftype)}")
        cache_flag, topo_map = parse_topo_tree(payload)
        self.controller_cache = bool(cache_flag)
        self.topology = topo_map[self.rank]
        self._topo_map = topo_map

    def _finish_children(self) -> None:
        with self._links_lock:
            links = list(self._links.values())
        for link in links:
            T._send_frame(link.conn, T.FRAME_TOPO_TREE, pack_topo_tree(
                1 if self.controller_cache else 0,
                [(r, self._topo_map[r]) for r in sorted(link.covers)]))
            link.conn.settimeout(T._frame_timeout())
            threading.Thread(
                target=self._child_rx, args=(link, link.conn),
                name=f"hvd-tree-rx-{self.rank}-{link.rank}",
                daemon=True).start()
        # Drain, then arm: buffered frames go out before ready flips, so
        # a later frame cannot overtake them on a child link.
        while True:
            with self._links_lock:
                if not self._relay_buffer:
                    self._relay_ready = True
                    break
                buffered, self._relay_buffer = self._relay_buffer, []
            for ftype, payload in buffered:
                self._relay_send(ftype, payload)

    # -- the cycle ---------------------------------------------------------
    def gather(self, batch: bytes) -> None:
        """A leaf sends its batch; an interior waits for one entry from
        each live child link and sends its own with them, merged
        (:func:`merge_batch_items`), as one ``FRAME_SUBTREE_BATCH``."""
        if not self._children_ranks:
            super().gather(batch)
            return
        T._account_batch(batch)
        self._seq += 1
        own = T.batch_payload(self.rank, self._seq, batch)
        while True:
            with self._links_lock:
                waiting = [link for link in self._links.values()
                           if link.conn is not None and not link.items]
                if not waiting:
                    entries: List[Tuple[int, bytes]] = []
                    for link in self._links.values():
                        entries.extend(link.items)
                        link.items = []
                    break
                self._child_cond.wait(0.05)
            self._idle()
        bits, batches = merge_batch_items([(0, own)] + entries)
        T._M_TREE_MERGED.inc(len(entries))
        # Counted once a rank (reference :878): the subtree's hits as the
        # flat star's batches count them.
        T._M_TREE_BITS.inc(sum(len(idxs) * len(ranks)
                               for _e, ranks, idxs in bits))
        _flight.record("frame_tx_subtree", len(batches), len(bits))
        self._send(T.FRAME_SUBTREE_BATCH, pack_subtree_batch(bits, batches))

    def _idle(self) -> None:
        self._sweep()
        super()._idle()

    # -- downward relay ----------------------------------------------------
    def _relay_downward(self, ftype: int, payload: bytes) -> None:
        with self._links_lock:
            if not self._relay_ready:
                if self._links:
                    self._relay_buffer.append((ftype, payload))
                return
        self._relay_send(ftype, payload)

    def _relay_send(self, ftype: int, payload: bytes) -> None:
        with self._links_lock:
            links = [(link, link.conn) for link in self._links.values()
                     if link.conn is not None]
        for link, conn in links:
            if _chaos.active() \
                    and _chaos.fire("tree.relay_reset") is not None:
                # The "interior died" wire effect on one child link: the
                # child's recv fails and it re-parents to rank 0.
                T._hard_close(conn)
                self._drop_link(link, "hvd-chaos: tree.relay_reset")
                continue
            try:
                # No dup: each child's stream must stay rank 0's stream
                # index for index (a re-parent resumes from that index).
                T._send_frame_or_fault(conn, ftype, payload,
                                       allow_dup=False)
                T._M_TREE_RELAYED.inc()
            except OSError as e:
                self._drop_link(link, f"relay send failed: {e}")

    # -- upward (child receive threads) ------------------------------------
    def _child_rx(self, link: _ChildLink,
                  conn: socket.socket) -> None:  # thread: rx
        _athreads.set_role("rx")
        try:
            self._child_rx_inner(link, conn)
        except Exception:
            import traceback

            _telemetry.exception_event("tree-child-rx",
                                       traceback.format_exc())
            raise

    def _child_rx_inner(self, link: _ChildLink, conn: socket.socket) -> None:
        while True:
            try:
                ftype, payload = T._recv_frame(
                    conn, peer=f"child rank {link.rank}")
            except OSError:
                ftype = None
            if ftype is None:
                if not (self._closing or self.shutdown_received.is_set()):
                    self._drop_link(link, "eof")
                return
            entries: List[Tuple[int, bytes]] = []
            with self._links_lock:
                link.rx_count += 1
                cum = link.rx_count
            if ftype == T.FRAME_REQUEST_BATCH:
                entries.append((cum, payload))
            elif ftype == T.FRAME_SUBTREE_BATCH:
                # A deeper interior's envelope: back to its batches, which
                # merge again with this subtree's in the next gather.
                for c, body in expand_subtree_batch(payload)[0]:
                    rank = struct.unpack_from("<i", body)[0]
                    entries.append((cum if rank == link.rank else c, body))
            elif ftype == T.FRAME_WITHDRAW:
                wrank, name, psid = T.parse_withdraw(payload)
                entries.append((cum if wrank == link.rank else 0,
                                T.batch_payload(wrank, 0, T.encode_withdraw(
                                    name, psid))))
            elif ftype == T.FRAME_SHUTDOWN:
                with self._links_lock:
                    link.left = True
                entries.append((cum, T.batch_payload(
                    link.rank, 0, T.encode_shutdown())))
            elif ftype == T.FRAME_CHILD_LOST:
                self._send(ftype, payload)  # rank 0 arbitrates
                continue
            with self._links_lock:
                link.items.extend(entries)
                self._child_cond.notify_all()

    # -- link health -------------------------------------------------------
    def _drop_link(self, link: _ChildLink, why: str) -> None:
        with self._links_lock:
            conn, link.conn = link.conn, None
            self._child_cond.notify_all()
            if conn is not None:
                T._wake_close(conn)
            if self._closing or link.reported or link.left:
                return
            if link.grace_deadline is not None:
                return
            link.grace_deadline = time.monotonic() + T._grace_seconds()
        _flight.record("tree_link_down", link.rank, why)
        print(f"[hvd-tree] rank {self.rank}: child rank {link.rank} link "
              f"lost ({why}); it should re-parent to the root",
              file=sys.stderr)

    def _sweep(self) -> None:
        """A child link dead past the grace window: report every rank it
        covered to rank 0, the liveness arbiter."""
        now = time.monotonic()
        report: List[set] = []
        with self._links_lock:
            for link in self._links.values():
                if (link.grace_deadline is not None and not link.reported
                        and now > link.grace_deadline):
                    link.reported = True
                    report.append(set(link.covers))
        for covers in report:
            for r in sorted(covers):
                reason = (f"child link of interior rank {self.rank} died "
                          f"without re-parent")
                rb = reason.encode("utf-8")
                self._send(T.FRAME_CHILD_LOST,
                           struct.pack("<iH", r, len(rb)) + rb)

    # -- failure propagation / reconnect -----------------------------------
    def _poison(self, detail: str) -> None:
        """The subtree below can no longer reach rank 0 either: hand the
        children the same diagnosis (outside rank 0's stream; terminal)."""
        payload = (T._BSEQ.pack(_POISON_SEQ) + T._shutdown_payload(
            f"Horovod has been shut down: interior tree rank {self.rank} "
            f"lost the controller ({detail})."))
        with self._links_lock:
            conns = [link.conn for link in self._links.values()
                     if link.conn is not None]
        for conn in conns:
            try:
                T._send_frame(conn, T.FRAME_RESPONSES, payload)
            except OSError:
                pass
        super()._poison(detail)

    def _reconnect(self) -> Optional[str]:
        if not self._reparented and (self._host, self._port) != (
                self._root_host, self._root_port):
            print(f"[hvd-tree] rank {self.rank}: parent link lost; "
                  f"re-parenting to the root controller at "
                  f"{self._root_host}:{self._root_port}", file=sys.stderr)
            _flight.record("tree_reparent_attempt", self.rank)
            self._host, self._port = self._root_host, self._root_port
            self._reparented = True
        return super()._reconnect()

    def close(self) -> None:
        super().close()
        with self._links_lock:
            live = [link.conn for link in self._links.values()
                    if link.conn is not None]
        for conn in live:
            # The parent leaves cleanly: the children's EOF is benign.
            try:
                T._send_frame(conn, T.FRAME_SHUTDOWN)
            except OSError:
                pass
        with self._links_lock:
            conns = [link.conn for link in self._links.values()
                     if link.conn is not None]
            for link in self._links.values():
                link.conn = None
        for conn in conns:
            T._wake_close(conn)
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
