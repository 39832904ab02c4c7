"""The port's tree overlay (``horovod_tpu_torch/ops/tree.py``) held against
the reference's (``horovod_tpu/ops/tree.py``; tests/test_tree.py:37-297).

* The layout: its invariants on a world × fanout grid, equal to the
  reference's ``build_layout`` rank for rank; slice-major order;
  ``expected_root_frames``, the frame accounting and ``depth_bound``;
  ``tree_active``'s modes; ``validate_env``'s typos; the relay ports and
  parent addresses.
* The handshake packers, byte for byte both ways.
* np 3 on real processes (the chaos matrix's cp fleet): the tree's
  results byte-identical to the flat star's, the memory gauges
  aggregated exactly through the interior, the cache replicas aligned.
* A re-parent after an interior's child link dies, in one process:
  rank 0 adopts the leaf and the cycles go on; rank 0 receives
  ``expected_root_frames`` frames a cycle before it.
"""

import math
import socket
import threading
import time

import pytest

from horovod_tpu.ops import transport as RT
from horovod_tpu.ops import tree as rtree
from horovod_tpu_torch import telemetry as tel
from horovod_tpu_torch.chaos import matrix as M
from horovod_tpu_torch.ops import transport as T
from horovod_tpu_torch.ops import tree


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
    entries = [(0, T.batch_payload(1, 7, b"abc")),
               (12, T.batch_payload(2, 7, b"")),
               (3, T.batch_payload(4, 0, T.encode_shutdown()))]
    assert T.parse_subtree_batch(T.pack_subtree_batch(entries)) == entries


# ---------------------------------------------------------------------------
# np 3 on real processes
# ---------------------------------------------------------------------------

def _fleet(env):
    s = M.Scenario("tree_identity", "cp", "complete", np=3, cap=120.0,
                   env=dict(env))
    p = M._run_pass(s, faulted=False, device="cpu")
    assert p.rc == 0, f"fleet pass failed (rc={p.rc}):\n" \
        + "\n".join(p.output.splitlines()[-30:])
    assert sorted(p.results) == [0, 1, 2], p.results
    return p.results, p.output


def test_np3_tree_byte_identical_to_flat_with_exact_gauges():
    """Controller, interior and leaf (a fanout-1 chain) negotiate the
    records the flat star does, bit for bit; the mid-run metrics pull
    through the interior carries every rank's memory gauge exactly
    (``CHAOS_MEMGAUGES``); and the steady state's compact cache replays,
    which every replica must rebuild from an index-aligned cache, never
    desync."""
    from concurrent.futures import ThreadPoolExecutor

    base = {"HVD_TPU_CHAOS_CP_STEPS": "12"}
    envs = [{**base, "HVD_TPU_TREE": "off"},
            {**base, "HVD_TPU_TREE": "on", "HVD_TPU_TREE_FANOUT": "1"}]
    with ThreadPoolExecutor(max_workers=2) as pool:
        (flat, flat_out), (tr, tr_out) = list(pool.map(_fleet, envs))
    assert tr == flat
    assert len(set(tr.values())) == 1
    for out in (flat_out, tr_out):
        assert "CHAOS_MEMGAUGES ranks=3 ok" in out
        assert "desync" not in out


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
