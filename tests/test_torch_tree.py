"""The port's tree overlay (``horovod_tpu_torch/ops/tree.py``) held against
the reference's (``horovod_tpu/ops/tree.py``; tests/test_tree.py:37-297).

* The layout: its invariants on a world × fanout grid, equal to the
  reference's ``build_layout`` rank for rank; slice-major order;
  ``expected_root_frames``, the frame accounting and ``depth_bound``;
  ``tree_active``'s modes; ``validate_env``'s typos; the relay ports and
  parent addresses.
* The handshake packers, byte for byte both ways.
* The merged envelope: hit groups equal to the reference's
  ``merge_batch_items`` and its sections byte for byte the reference's
  ``pack_subtree_batch``; 200 seeded cycles of mixed batches merged at
  every interior of worlds 5 and 7 (fanout 1 and 2) and expanded at rank
  0 into every rank's flat payloads, byte for byte; the reference's
  cache-alignment case on the port's ``ResponseCache`` and
  ``steady_envelope``; a stale seq dropped for its rank alone; the steady
  envelope's size, ``11 + 4n + 4h + n * c``.
* Real processes (the chaos matrix's cp fleet): np 3 as a chain and with
  both leaves under rank 0 (fanout 8), np 5 at fanout 2, each bitwise
  its flat run, with the memory gauges aggregated exactly through the
  interiors, the cache replicas aligned and rank 0's steady envelopes one
  hit section of the formula's size.
* A re-parent after an interior's child link dies, in one process:
  rank 0 adopts the leaf and the cycles go on; rank 0 receives
  ``expected_root_frames`` frames a cycle before it.  Steady cycles
  through that chain: one hit section, and the subtree's hits counted as
  the flat star counts them.
"""

import json
import math
import re
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from horovod_tpu.ops import cache as rcache
from horovod_tpu.ops import transport as RT
from horovod_tpu.ops import tree as rtree
from horovod_tpu.ops import wire as rwire
from horovod_tpu_torch import telemetry as tel
from horovod_tpu_torch.chaos import matrix as M
from horovod_tpu_torch.ops import cache
from horovod_tpu_torch.ops import transport as T
from horovod_tpu_torch.ops import tree
from horovod_tpu_torch.ops import wire

# A steady batch section: <B 4><i rank><Q seq><I cum><B nref><I len> and a
# 3-byte hit reference; a traced post adds a 25-byte KIND_TRACE_CTX.
C_UNTRACED, C_TRACED = 25, 50


def steady_bytes(n, h, c):
    """The envelope of n ranks that each sent the same h hits: the <H>
    section count, one hit section, and n batch sections of c bytes."""
    return 2 + (9 + 4 * n + 4 * h) + n * c


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 3, 4, 7, 8, 9, 17, 64, 256, 1024])
@pytest.mark.parametrize("fanout", [1, 2, 4, 8])
def test_layout_invariants(world, fanout):
    layout = tree.build_layout(world, fanout)
    ref = rtree.build_layout(world, fanout)
    assert layout.order == ref.order and layout.pos == ref.pos
    assert layout.order[0] == 0
    assert sorted(layout.order) == list(range(world))
    for r in range(world):
        assert layout.children(r) == ref.children(r)
        assert layout.parent(r) == ref.parent(r)
        assert len(layout.children(r)) <= fanout
        hops, cur = 0, r
        while cur != 0:
            cur = layout.parent(cur)
            hops += 1
            assert hops <= world
        if fanout > 1:
            assert hops <= math.ceil(math.log(max(world, 2), fanout)) + 1
    covered = [0]
    for c in layout.children(0):
        covered.extend(layout.subtree(c))
    assert sorted(covered) == list(range(world))
    assert layout.interior_ranks() == ref.interior_ranks()
    assert layout.depth() == ref.depth()
    assert tree.expected_root_frames(world, fanout) == \
        rtree.expected_root_frames(world, fanout)
    assert tree.depth_bound(world, fanout) == rtree.depth_bound(world, fanout)


def test_layout_slice_major_ordering(monkeypatch):
    monkeypatch.setenv("HVD_TPU_VIRTUAL_SLICES", "2")
    layout = tree.build_layout(8, 2)
    rest = list(layout.order[1:])
    assert rest == sorted(rest, key=lambda r: (r // 4, r))
    assert layout.order == rtree.build_layout(8, 2).order
    assert tree._slice_table(8) == rtree._slice_table(8)


def test_root_frames_drop_from_linear_to_fanout_log():
    for world in (64, 256, 1024):
        got = tree.expected_root_frames(world, 8)
        assert got == rtree.simulate_cycle_frames(world, 8)[
            "tree_frames_per_cycle"]
        bound = 2 * 8 * max(1, math.ceil(math.log(world, 8)))
        assert got <= bound and got < (world - 1) / 4
    assert tree.expected_root_frames(3, 1) == 1


def test_tree_active_modes(monkeypatch):
    for mod in (tree, rtree):
        monkeypatch.setenv(mod.TREE_ENV, "off")
        assert not mod.tree_active(4096)
        monkeypatch.setenv(mod.TREE_ENV, "on")
        assert mod.tree_active(3)
        assert not mod.tree_active(2)  # a 2-rank "tree" is the star
        monkeypatch.setenv(mod.TREE_ENV, "auto")
        monkeypatch.setenv(mod.THRESHOLD_ENV, "16")
        assert not mod.tree_active(15)
        assert mod.tree_active(16)
        monkeypatch.delenv(mod.THRESHOLD_ENV)
        assert mod.tree_active(64) and not mod.tree_active(63)


@pytest.mark.parametrize("env,fragment", [
    ({"HVD_TPU_TREE": "sometimes"}, "auto, on or off"),
    ({"HVD_TPU_TREE_FANOUT": "0"}, "expected >= 1"),
    ({"HVD_TPU_TREE_THRESHOLD": "x"}, "invalid literal"),
    ({"HVD_TPU_TREE_PORT_BASE": "p"}, "invalid literal"),
])
def test_validate_env_rejects_typos(monkeypatch, env, fragment):
    for mod in (tree, rtree):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(ValueError, match=fragment):
            mod.validate_env()


def test_init_fails_on_a_tree_typo(monkeypatch):
    import horovod_tpu_torch as thvd

    monkeypatch.setenv("HVD_TPU_TREE", "sometimes")
    with pytest.raises(ValueError, match="auto, on or off"):
        thvd.init(device="cpu")
    assert not thvd.is_initialized()


def test_relay_ports_and_parent_addresses(monkeypatch):
    for env in ({}, {"HVD_TPU_TREE_PORT_BASE": "41000",
                     "HVD_TPU_TREE_HOSTS": "1=hostB, 3=hostC"}):
        for k in ("HVD_TPU_TREE_PORT_BASE", "HVD_TPU_TREE_HOSTS"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for parent in (0, 1, 2, 3):
            assert tree.parent_address("hostA", 29500, parent) == \
                rtree.parent_address("hostA", 29500, parent)
            assert tree.relay_port(29500, parent) == \
                rtree.relay_port(29500, parent)


# ---------------------------------------------------------------------------
# The handshake packers
# ---------------------------------------------------------------------------

def test_hello_and_topo_round_trips_are_the_references():
    entries = [(3, "hostA", "K=a;L=b"), (5, "hostB", "K=a;L=b"),
               (6, "", "")]
    packed = tree.pack_hello_tree(entries)
    assert packed == rtree.pack_hello_tree(entries)
    assert tree.parse_hello_tree(packed) == entries
    assert rtree.parse_hello_tree(packed) == entries
    topo = [(3, T.Topology(0, 2, 1, 2)), (5, T.Topology(1, 2, 1, 2))]
    rtopo = [(r, RT.Topology(*t.__dict__.values())) for r, t in topo]
    packed = tree.pack_topo_tree(1, topo)
    assert packed == rtree.pack_topo_tree(1, rtopo)
    flag, parsed = tree.parse_topo_tree(packed)
    assert flag == 1 and parsed == dict(topo)
    rflag, rparsed = rtree.parse_topo_tree(packed)
    assert rflag == 1
    assert {r: tuple(t.__dict__.values()) for r, t in rparsed.items()} == \
        {r: tuple(t.__dict__.values()) for r, t in parsed.items()}


def test_subtree_batch_round_trip():
    """Entries that carry no hits (a batch the merge cannot read, an empty
    one, an exit handshake folded in with seq 0) go up whole and come back
    as they were, with their counts."""
    entries = [(0, T.batch_payload(1, 7, b"abc")),
               (12, T.batch_payload(2, 7, b"")),
               (3, T.batch_payload(4, 0, T.encode_shutdown()))]
    bits, batches = tree.merge_batch_items(entries)
    assert bits == [] and [b[3] for b in batches] == [0, 0, 0]
    payload = tree.pack_subtree_batch(bits, batches)
    assert tree.expand_subtree_batch(payload) == (entries, 0)


# ---------------------------------------------------------------------------
# The merged envelope
# ---------------------------------------------------------------------------

def _req(rank, name, shape=(8,)):
    return wire.Request(rank, wire.RequestType.ALLREDUCE,
                        wire.DataType.FLOAT32, name, -1, -1, shape,
                        wire.ReduceOp.SUM, 0, ())


@pytest.mark.parametrize("seed", range(5))
def test_hit_groups_and_sections_are_the_references(seed):
    """Hits-only batches, every rank of a group sending the same entries
    in the same (ascending) order: the port's groups are the reference's
    ``merge_batch_items`` groups of two or more ranks (a record no other
    rank sent stays in its batch), and its hit sections are the
    reference's ``pack_subtree_batch`` byte for byte, read back alike by
    both packages."""
    rng = np.random.RandomState(seed)
    patterns = [(int(rng.randint(0, 3)),
                 tuple(sorted(rng.choice(64, rng.randint(1, 12),
                                         replace=False).tolist())))
                for _ in range(3)]
    entries, ritems = [], []
    for rank in range(1, 12):
        runs = [patterns[i] for i in sorted(rng.choice(
            3, rng.randint(1, 3), replace=False))]
        runs.sort(key=lambda run: run[0])
        if len({e for e, _ in runs}) < len(runs):
            runs = runs[:1]
        hits = [(e, i) for e, idxs in runs for i in idxs]
        entries.append((rank, T.batch_payload(rank, 5, T.encode_hits(hits))))
        ritems += [("bits", e, (rank,), idxs) for e, idxs in runs]
    bits, batches = tree.merge_batch_items(entries)
    rbits, _rreqs, _rarr = rtree.merge_batch_items(ritems)
    shared = [group for group in rbits if len(group[1]) > 1]
    assert bits == shared and shared
    for rank, _s, _c, nref, _b in batches:
        assert nref == sum(rank in ranks for _e, ranks, _i in bits)
    mine = tree.pack_subtree_batch(bits)
    assert mine == rtree.pack_subtree_batch(shared, [], [], {})
    secs = list(tree.iter_subtree_sections(mine))
    assert secs == list(rtree.iter_subtree_sections(mine))
    assert [(e, tuple(rs), tuple(ii)) for _k, e, rs, ii in secs] == bits


def test_hits_group_by_their_order():
    """The departure from the reference: a rank that hits the same entries
    as two others in another order is not in their group (rank 0 replays
    downgraded hits in wire order), where the reference makes one group of
    the three; its record, shared with no rank, stays in its batch."""
    ab, ba = T.encode_hits([(0, 2), (0, 5)]), T.encode_hits([(0, 5), (0, 2)])
    entries = [(0, T.batch_payload(1, 1, ab)), (0, T.batch_payload(2, 1, ba)),
               (0, T.batch_payload(3, 1, ab))]
    bits, batches = tree.merge_batch_items(entries)
    assert bits == [(0, (1, 3), (2, 5))]
    assert [(b[0], b[3]) for b in batches] == [(1, 1), (2, 0), (3, 1)]
    assert batches[1][4] == ba
    rbits, _, _ = rtree.merge_batch_items(
        [("bits", 0, r, idxs) for r, idxs in ((1, (2, 5)), (2, (5, 2)),
                                             (3, (2, 5)))])
    assert rbits == [(0, (1, 2, 3), (2, 5))]
    assert tree.expand_subtree_batch(tree.pack_subtree_batch(
        bits, batches)) == (entries, 1)


def test_a_record_no_other_rank_sent_stays_in_its_batch():
    """Ranks that share no hit record send no hit section: each batch
    goes up as it was, its records in place, at 22 bytes of section head a
    rank (the plain concatenation's entry head and ``(rank, seq)`` took
    20)."""
    rng = np.random.RandomState(7)
    entries = []
    for rank in range(1, 6):
        idxs = rng.permutation(64)[:rank + 2].tolist()
        batch = T.encode_hits([(1, i) for i in idxs]) + T.encode_request(
            _req(rank, f"g{rank}"))
        entries.append((rank, T.batch_payload(rank, 3, batch)))
    bits, batches = tree.merge_batch_items(entries)
    assert bits == [] and all(b[3] == 0 for b in batches)
    env = tree.pack_subtree_batch(bits, batches)
    assert len(env) == 2 + sum(22 + len(p) - 12 for _c, p in entries)
    assert tree.expand_subtree_batch(env) == (entries, 0)


def _messages(rng, rank, steady):
    """One rank's cycle batch as a list of messages, in a random order:
    requests, withdrawals, hit records of up to three epochs (the oldest
    one a flush already passed, whose hits rank 0 downgrades), metrics,
    signature and trace replies, a probe answer and a trace context."""
    if steady is not None:
        return [T.encode_hits(steady)]
    msgs = []
    for k in range(rng.randint(0, 3)):
        msgs.append(T.encode_request(_req(rank, f"g{k}.{rng.randint(9)}",
                                          (int(rng.randint(1, 9)),))))
    if rng.rand() < 0.3:
        msgs.append(T.encode_withdraw(f"w{rng.randint(9)}",
                                      int(rng.randint(0, 3))))
    epoch = int(rng.randint(1, 4))
    for e in (epoch - 1, epoch, epoch + 1):
        if rng.rand() < 0.6:
            n = int(rng.randint(1, 6))
            idxs = list(range(n)) if rng.rand() < 0.5 else \
                rng.permutation(16)[:n].tolist()
            msgs.append(T.encode_hits([(e, i) for i in idxs]))
    if rng.rand() < 0.3:
        msgs.append(T.encode_metrics({"memory.bytes.chaos.probe": {
            "type": "gauge", "value": (rank + 1) << 20}}))
    if rng.rand() < 0.2:
        msgs.append(T.encode_signature(rng.bytes(int(rng.randint(0, 40)))))
    if rng.rand() < 0.2:
        msgs.append(T.encode_trace([{"name": "x", "rank": rank}]))
    if rng.rand() < 0.3:
        msgs.append(T.encode_pong(*rng.rand(3).tolist()))
    if rng.rand() < 0.5:
        msgs.append(T.encode_trace_ctx(rng.bytes(16), float(rng.rand())))
    if rng.rand() < 0.05:
        msgs.append(T.encode_shutdown())
    order = rng.permutation(len(msgs))
    return [msgs[i] for i in order]


def _up(layout, rank, flat, cums):
    """The frames ``rank`` sends its parent in one cycle: a leaf its flat
    entries, an interior its seq-0 entries flat and then one envelope
    merged from its batch and its children's frames, as
    ``TreeWorkerTransport`` builds it."""
    own = flat[rank]
    if not layout.children(rank):
        return [(T.FRAME_REQUEST_BATCH, body) for body in own]
    frames = [(T.FRAME_REQUEST_BATCH, body) for body in own[:-1]]
    entries = [(0, own[-1])]
    for child in layout.children(rank):
        for ftype, body in _up(layout, child, flat, cums):
            if ftype == T.FRAME_REQUEST_BATCH:
                r = struct.unpack_from("<i", body)[0]
                entries.append((cums[r], body))
            else:
                entries += [
                    (cums[child] if struct.unpack_from("<i", b)[0] == child
                     else c, b) for c, b in tree.expand_subtree_batch(body)[0]]
    envelope = tree.pack_subtree_batch(*tree.merge_batch_items(entries))
    return frames + [(T.FRAME_SUBTREE_BATCH, envelope)]


@pytest.mark.parametrize("world,fanout", [(5, 1), (5, 2), (7, 1), (7, 2)])
def test_merge_at_every_interior_expands_to_the_flat_payloads(world,
                                                              fanout):
    """50 seeded cycles a layout (200 in all): mixed batches, some with a
    withdrawal sent ahead as its own seq-0 entry, merged at every interior
    and expanded at rank 0 give every rank's flat payloads byte for byte,
    in order, with the counts the interiors folded in; a steady cycle's
    envelope from a direct child is the formula's size."""
    layout = tree.build_layout(world, fanout)
    rng = np.random.RandomState(1000 * world + fanout)
    steady_seen = 0
    for cycle in range(1, 51):
        steady = None
        if rng.rand() < 0.25:
            epoch = int(rng.randint(0, 3))
            steady = [(epoch, int(i)) for i in rng.permutation(40)[
                :rng.randint(1, 20)]]
        flat = {}
        for rank in range(1, world):
            body = [T.batch_payload(rank, cycle, b"".join(
                _messages(rng, rank, steady)))]
            if steady is None and rng.rand() < 0.2:
                body.insert(0, T.batch_payload(rank, 0, T.encode_withdraw(
                    f"late{rank}", 0)))
            flat[rank] = body
        cums = {r: 7 * cycle + r for r in range(world)}
        got = {r: [] for r in range(1, world)}
        for child in layout.children(0):
            for ftype, body in _up(layout, child, flat, cums):
                if ftype == T.FRAME_REQUEST_BATCH:
                    got[struct.unpack_from("<i", body)[0]].append(body)
                    continue
                entries, groups = tree.expand_subtree_batch(body)
                for cum, payload in entries:
                    r = struct.unpack_from("<i", payload)[0]
                    assert cum == (0 if r == child else cums[r])
                    got[r].append(payload)
                if steady is not None:
                    n = len(layout.subtree(child))
                    size = steady_bytes(n, len(steady), C_UNTRACED)
                    assert M.steady_shape(body) == (n, len(steady), 0, 1,
                                                    size)
                    assert len(body) == size
                    steady_seen += 1
        assert got == flat, f"cycle {cycle}"
    assert steady_seen > 0


def test_merged_envelope_drives_cache_like_flat_bits():
    """The reference's case (tests/test_tree.py:171) on the port's
    ``ResponseCache`` and ``steady_envelope``: a whole subtree's
    steady-state envelope, expanded at rank 0, accounts the same per-rank
    hits as the flat per-rank batches -- the same entries ready, the same
    pending sets -- and is those batches byte for byte."""
    def build_cache(ranks, mod, wmod):
        c = mod.ResponseCache(rank=0)
        for name in ("g0", "g1"):
            c.stage_negotiated(name, {
                rr: wmod.Request(rr, wmod.RequestType.ALLREDUCE,
                                 wmod.DataType.FLOAT32, name, -1, -1, (8,),
                                 wmod.ReduceOp.SUM, 0, ()) for rr in ranks})
            c.observe_response(wmod.Response(
                wmod.ResponseType.ALLREDUCE, tensor_names=[name],
                tensor_shapes=[(8,)], tensor_type=wmod.DataType.FLOAT32))
        return c

    ranks = [0, 1, 2, 3, 4]
    layout = tree.build_layout(5, 2)
    epoch, idxs = 0, [0, 1]
    flat_payloads = {r: T.batch_payload(r, 1, T.encode_hits(
        [(epoch, i) for i in idxs])) for r in ranks[1:]}

    flat = build_cache(ranks, cache, wire)
    for r in ranks:
        for i in idxs:
            assert flat.hit_from_wire(i, r, epoch) is None
    flat_ready = flat.take_ready(lambda _p: 1 << 20)

    merged = build_cache(ranks, cache, wire)
    for i in idxs:  # rank 0's own hits
        assert merged.hit_from_wire(i, 0, epoch) is None
    for child in layout.children(0):
        env = tree.steady_envelope(layout, child, epoch, idxs)
        entries, groups = tree.expand_subtree_batch(env)
        assert groups == int(len(layout.subtree(child)) > 1)
        for _cum, payload in entries:
            r = struct.unpack_from("<i", payload)[0]
            assert payload == flat_payloads[r]
            for kind, body in T.decode_batch(payload[12:]):
                assert kind == T.KIND_HITS
                for i in body[1]:
                    assert merged.hit_from_wire(i, r, body[0]) is None
    merged_ready = merged.take_ready(lambda _p: 1 << 20)
    assert [r.tensor_names for r in flat_ready[0]] \
        == [r.tensor_names for r in merged_ready[0]]
    assert flat_ready[1:] == merged_ready[1:]
    # And the reference's own cache, fed the reference's envelope, agrees.
    ref = build_cache(ranks, rcache, rwire)
    for i in idxs:
        assert ref.hit_from_wire(i, 0, epoch) is None
    for child in layout.children(0):
        for sec in rtree.iter_subtree_sections(rtree.steady_envelope(
                rtree.build_layout(5, 2), child, epoch, idxs)):
            if sec[0] == "bits":
                for r in sec[2]:
                    for i in sec[3]:
                        assert ref.hit_from_wire(i, r, sec[1]) is None
    assert [r.tensor_names for r in ref.take_ready(lambda _p: 1 << 20)[0]] \
        == [r.tensor_names for r in flat_ready[0]]


@pytest.mark.parametrize("n,h", [(1, 18), (7, 18), (7, 1), (3, 40)])
def test_steady_envelope_size_is_the_formula(n, h):
    """``steady_envelope`` of an n-rank subtree (n >= 2) with h hits each
    is ``11 + 4n + 4h + n * c`` bytes, c = 25 (no trace context), against
    ``2 + n * (29 + 4h)`` for the envelope that only concatenated the
    batches (an 8-byte entry header, ``(rank, seq)`` and the hit record a
    rank); GPT-2-small's 18 hits over a 7-rank subtree: 709 B
    concatenated, 286 B merged.  A lone rank's record stays in its batch:
    2 bytes more than concatenated."""
    layout = tree.build_layout(n + 1, 1)  # rank 1's subtree: n ranks
    env = tree.steady_envelope(layout, 1, 2, list(range(h)))
    flat = 2 + n * (8 + 12 + 9 + 4 * h)  # the concatenated envelope
    if n == 1:
        assert len(env) == flat + 2 == 2 + 22 + 9 + 4 * h
        return
    assert len(env) == steady_bytes(n, h, C_UNTRACED) \
        == 11 + 4 * n + 4 * h + n * tree.STEADY_BATCH_BYTES
    if (n, h) == (7, 18):
        assert (flat, len(env)) == (709, 286)
    assert len(env) < flat


def test_a_stale_seq_in_a_group_drops_that_rank_alone(monkeypatch):
    """Rank 0 took rank 2's seq 5 already (a replay after a re-parent):
    an envelope whose one hit section lists ranks 1, 2 and 3 delivers
    ranks 1 and 3 and drops rank 2 alone; the counts still rise."""
    monkeypatch.setenv("HVD_TPU_TREE", "on")
    layout = tree.build_layout(4, 8)
    ctrl = T.ControllerTransport(4, 0, tree=layout)
    try:
        hits = T.encode_hits([(0, 3), (0, 1)])
        entries = [(0, T.batch_payload(1, 6, hits)),
                   (9, T.batch_payload(2, 5, hits)),
                   (4, T.batch_payload(3, 6, hits))]
        bits, batches = tree.merge_batch_items(entries)
        assert bits == [(0, (1, 2, 3), (3, 1))]
        with ctrl._lock:
            ctrl._last_seq[2] = 5
        ctrl._take_subtree(tree.pack_subtree_batch(bits, batches))
        with ctrl._lock:
            assert ctrl._inbox == {1: [hits], 3: [hits]}
            assert ctrl._last_seq == {1: 6, 2: 5, 3: 6}
            assert ctrl._rank_rx == {2: 9, 3: 4}
            assert ctrl._cycle_frames == 1
    finally:
        ctrl.close()


# ---------------------------------------------------------------------------
# np 3 on real processes
# ---------------------------------------------------------------------------

_TREE_RE = re.compile(r"CHAOS_TREE rank=0 (\[[^\n]*\])")


def _fleet(np_, env):
    s = M.Scenario("tree_identity", "cp", "complete", np=np_, cap=120.0,
                   env={"HVD_TPU_CHAOS_CP_STEPS": "40", **env})
    p = M._run_pass(s, faulted=False, device="cpu")
    assert p.rc == 0, f"fleet pass failed (rc={p.rc}):\n" \
        + "\n".join(p.output.splitlines()[-30:])
    assert sorted(p.results) == list(range(np_)), p.results
    m = _TREE_RE.search(p.output)
    steady = json.loads(m.group(1)) if m else None
    return p.results, p.output, steady


FLEETS = {
    "flat3": (3, {"HVD_TPU_TREE": "off"}),
    "chain3": (3, {"HVD_TPU_TREE": "on", "HVD_TPU_TREE_FANOUT": "1"}),
    "leaves3": (3, {"HVD_TPU_TREE": "on", "HVD_TPU_TREE_FANOUT": "8"}),
    "flat5": (5, {"HVD_TPU_TREE": "off"}),
    "tree5": (5, {"HVD_TPU_TREE": "on", "HVD_TPU_TREE_FANOUT": "2"}),
}


@pytest.fixture(scope="module")
def fleets():
    """Every fleet of the file, 40 steps each, started three at a time in
    the order the tests read them: each test waits only for its own."""
    with ThreadPoolExecutor(max_workers=3) as pool:
        yield {name: pool.submit(_fleet, *args)
               for name, args in FLEETS.items()}


def _assert_steady_merged(steady, n):
    """Rank 0's steady envelopes (``[ranks, h, trailer, hit sections,
    bytes, envelopes]``) from an n-rank subtree: there are some, every
    one is one hit section, and each is the formula's size, c the steady
    batch section and the trace context if the post was traced."""
    assert steady, "no steady-state envelope reached rank 0"
    for ranks, h, trailer, groups, nbytes, count in steady:
        assert (ranks, groups) == (n, 1) and count >= 1
        assert nbytes == steady_bytes(n, h, C_UNTRACED + trailer)
        assert C_UNTRACED + trailer in (C_UNTRACED, C_TRACED)


def test_np3_tree_byte_identical_to_flat_with_exact_gauges(fleets):
    """Controller, interior and leaf (a fanout-1 chain) negotiate the
    records the flat star does, bit for bit; the mid-run metrics pull
    through the interior carries every rank's memory gauge exactly
    (``CHAOS_MEMGAUGES``); the steady state's compact cache replays, which
    every replica must rebuild from an index-aligned cache, never desync;
    and the interior merged: every steady-state envelope rank 0 received
    carried both ranks' hits in one section."""
    flat, flat_out, flat_steady = fleets["flat3"].result()
    tr, tr_out, tr_steady = fleets["chain3"].result()
    assert tr == flat
    assert len(set(tr.values())) == 1
    for out in (flat_out, tr_out):
        assert "CHAOS_MEMGAUGES ranks=3 ok" in out
        assert "desync" not in out
    assert flat_steady is None
    _assert_steady_merged(tr_steady, 2)


def test_np3_tree_direct_leaves_fanout8(fleets):
    """The reference's other np 3 shape (tests/test_tree.py:259): fanout
    8 puts both workers right under rank 0, a tree with no interior, so
    rank 0 takes only flat batches; bitwise the flat star, gauges exact,
    and no envelope."""
    res, out, steady = fleets["leaves3"].result()
    assert res == fleets["flat3"].result()[0]
    assert "CHAOS_MEMGAUGES ranks=3 ok" in out and "desync" not in out
    assert steady == []


def test_np5_fanout2_tree_bitwise_flat_with_steady_bytes(fleets):
    """np 5 at fanout 2: rank 1 is an interior over leaves 3 and 4, rank 2
    a leaf under rank 0.  The results are bitwise the flat star's, the
    gauges exact through the interior, and rank 0's steady envelopes from
    rank 1's subtree are one hit section of ``11 + 4n + 4h + n * c``
    bytes for the h measured, n = 3."""
    assert tree.build_layout(5, 2).subtree(1) == (1, 4, 3)
    flat, _, _ = fleets["flat5"].result()
    res, out, steady = fleets["tree5"].result()
    assert res == flat and len(set(res.values())) == 1
    assert "CHAOS_MEMGAUGES ranks=5 ok" in out and "desync" not in out
    _assert_steady_merged(steady, 3)


def test_fleet_rendezvous_port_stays_bound_while_the_ranks_run(
        monkeypatch):
    """A cp fleet's rendezvous port is bound by the pass itself from its
    choice until the fleet ends, and the ranks join that store as
    clients: no other process can take the port between its choice and
    the rendezvous (a port picked and released, then bound by rank 0
    seconds later, was taken by another process under load, and the
    fleet's ranks hung on its listener)."""
    seen = []

    class Done:
        returncode = 0

        def communicate(self, timeout=None):
            return b"", None

        def poll(self):
            return 0

        def kill(self):
            pass

    def popen(cmd, env=None, **kw):
        port = int(cmd[cmd.index("--port") + 1])
        probe = socket.socket()
        try:
            probe.bind(("127.0.0.1", port))
            taken = False
        except OSError:
            taken = True
        finally:
            probe.close()
        seen.append((port, taken, {k: env.get(k)
                                   for k in M.AGENT_STORE_ENV}))
        return Done()

    monkeypatch.setattr(M.subprocess, "Popen", popen)
    s = M.Scenario("tree_identity", "cp", "complete", np=3, cap=10.0)
    assert M._run_pass(s, faulted=False, device="cpu").rc == 0
    assert len(seen) == 3 and len({port for port, _, _ in seen}) == 1
    assert all(taken for _, taken, _ in seen)
    assert all(env == M.AGENT_STORE_ENV for _, _, env in seen)


# ---------------------------------------------------------------------------
# A re-parent, in one process
# ---------------------------------------------------------------------------

def _chain(monkeypatch):
    """Rank 0, interior rank 1 and leaf rank 2 (fanout 1), each end built
    on its own thread as the ranks' processes would."""
    monkeypatch.setenv("HVD_TPU_TREE", "on")
    monkeypatch.setenv("HVD_TPU_TREE_FANOUT", "1")
    layout = tree.build_layout(3, 1)
    ctrl = T.ControllerTransport(3, 0, tree=layout)
    relay = socket.socket()
    relay.bind(("127.0.0.1", 0))
    relay.listen(1)
    relay_addr = ("127.0.0.1", relay.getsockname()[1])
    root = ("127.0.0.1", ctrl.port)
    ends = {}

    def build(rank):
        if rank == 0:
            ctrl.accept()
            ends[0] = ctrl
        elif rank == 1:
            ends[1] = tree.TreeWorkerTransport(
                *root, 1, layout, parent_addr=root, listen_sock=relay)
        else:
            ends[2] = tree.TreeWorkerTransport(
                *root, 2, layout, parent_addr=relay_addr)

    ths = [threading.Thread(target=build, args=(r,), daemon=True)
           for r in range(3)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=20.0)
    assert sorted(ends) == [0, 1, 2]
    return ends


def _tree_cycle(ends, tag):
    got = {}

    def work(rank):
        ends[rank].gather(tag + bytes([rank]))
        got[rank] = ends[rank].broadcast()

    ths = [threading.Thread(target=work, args=(r,), daemon=True)
           for r in (1, 2)]
    for th in ths:
        th.start()
    batches = ends[0].gather(tag + b"\x00")
    ends[0].broadcast(tag)
    for th in ths:
        th.join(timeout=10.0)
    assert got == {1: tag, 2: tag}, got
    return batches


def test_a_leaf_reparents_when_its_interior_link_dies(monkeypatch, capfd):
    ends = _chain(monkeypatch)
    ctrl, interior, leaf = ends[0], ends[1], ends[2]
    try:
        for i in range(4):
            tag = b"c%d." % i
            assert _tree_cycle(ends, tag) == [tag + bytes([r])
                                              for r in range(3)]
        # One frame from the interior a cycle carries all three ranks.
        assert ctrl.frame_counts.most_common(1)[0][0] == \
            tree.expected_root_frames(3, 1)
        assert interior.topology == T._assign_topology(
            {r: socket.gethostname() for r in range(3)})[1]
        before = tel.metrics().get("transport.reparents",
                                   {}).get("value", 0)
        # The interior's link to its child dies (tree.relay_reset's wire
        # effect): the leaf re-parents to rank 0.
        with interior._links_lock:
            link = interior._links[2]
        T._hard_close(link.conn)
        interior._drop_link(link, "test: relay link reset")
        for i in range(4, 8):
            tag = b"c%d." % i
            assert _tree_cycle(ends, tag) == [tag + bytes([r])
                                              for r in range(3)]
        assert tel.metrics()["transport.reparents"]["value"] == before + 1
        with ctrl._lock:
            assert ctrl._sess[2].conn is not None
            assert ctrl._sess[1].covers == {1, 2} - {2}
        err = ""
        deadline = time.monotonic() + 5.0
        while "adopting rank 2" not in err and time.monotonic() < deadline:
            err += capfd.readouterr().err
            time.sleep(0.05)
        assert "re-parenting to the root" in err
        assert "adopting rank 2 as a direct child" in err
        assert "session resumed" in err
    finally:
        for r in (2, 1):
            ends[r].close()
        ctrl.close()


def test_a_chain_merges_steady_hits_into_one_section(monkeypatch):
    """Steady cycles through a live chain: the interior and the leaf send
    the same hits, rank 0's ``gather`` returns their batches byte for
    byte, each envelope is one hit section of the formula's size, the
    interior counts its subtree's hits once a rank
    (``transport.tree_merged_cache_bits``), and the hits the ranks count
    in their own batches (``transport.batched_cache_bits``) are the flat
    star's."""
    def value(name):
        return tel.metrics().get(name, {}).get("value", 0)

    ends = _chain(monkeypatch)
    ctrl = ends[0]
    hits = [(4, i) for i in (9, 2, 7)]
    batch = T.encode_hits(hits)
    try:
        merged0 = value("transport.tree_merged_cache_bits")
        counted0 = value("transport.batched_cache_bits")
        steady = M.tally_steady_envelopes(ctrl)
        for i in range(3):
            got = {}

            def work(rank):
                ends[rank].gather(batch)
                got[rank] = ends[rank].broadcast()

            ths = [threading.Thread(target=work, args=(r,), daemon=True)
                   for r in (1, 2)]
            for th in ths:
                th.start()
            assert ctrl.gather(b"") == [b"", batch, batch]
            ctrl.broadcast(b"ok")
            for th in ths:
                th.join(timeout=10.0)
            assert got == {1: b"ok", 2: b"ok"}
        assert steady == {
            (2, 3, 0, 1, steady_bytes(2, 3, C_UNTRACED)): 3}
        assert value("transport.tree_merged_cache_bits") - merged0 == 3 * 6
        assert value("transport.batched_cache_bits") - counted0 == 3 * 6
    finally:
        for r in (2, 1):
            ends[r].close()
        ctrl.close()
