"""horovod_tpu_torch's response cache (ops/cache.py, the ``Coordinator``
facade of ops/coordinator.py, the hit records of ops/transport.py)
against horovod_tpu's.

The cases of tests/test_cache.py run on both packages (parametrized):
key exactness, hit and fused replay through the facade, the memoized
fusion plan, and every invalidation (program change, join, process-set
membership, fusion threshold, withdrawal, capacity, a stale-epoch hit).
Then the port's runtime on one rank: handles and the timeline mark cache
hits, and a program's outputs are bitwise the same with the cache on and
off.
"""

import json

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.ops import collective as TC
from horovod_tpu_torch.ops import transport

THRESHOLD = 1 << 20


class _Impl:
    def __init__(self, which):
        if which == "reference":
            from horovod_tpu.ops import cache, coordinator, wire
        else:
            from horovod_tpu_torch.ops import cache, coordinator, wire
        self.cache, self.Coordinator, self.w = cache, coordinator.Coordinator, \
            wire

    def req(self, rank, name, shape=(4,), op=None, dtype=None, root=-1,
            device=-1, red=None, psid=0, splits=()):
        w = self.w
        return w.Request(rank, op or w.RequestType.ALLREDUCE,
                         dtype or w.DataType.FLOAT32, name, root, device,
                         shape, red or w.ReduceOp.SUM, psid, splits)

    def tick(self, coord, cache):
        """One rank-0 cycle: marker, replay, fresh negotiation, then the
        observation of every response in that order."""
        resps = []
        marker = cache.take_flush_marker()
        if marker is not None:
            resps.append(marker)
        replayed, _, _, _ = cache.take_ready(lambda psid: THRESHOLD)
        resps += replayed
        negotiated = coord.poll_responses({})
        resps += negotiated
        for r in resps:
            cache.observe_response(r)
        return resps, replayed, negotiated

    def program(self, coord, cache):
        """Two fusable allreduces and an allgather from both ranks."""
        for name in ("a", "b"):
            for r in range(2):
                coord.submit(self.req(r, name))
        for r in range(2):
            coord.submit(self.req(r, "g", shape=(2, 3),
                                  op=self.w.RequestType.ALLGATHER))
        return self.tick(coord, cache)


@pytest.fixture(params=["reference", "port"])
def impl(request):
    return _Impl(request.param)


def test_request_key_same_name_different_shape_never_collides(impl):
    key = impl.cache.request_key
    keys = {key(impl.req(0, "t", shape=s)) for s in ((4,), (8,), (4, 1))}
    assert len(keys) == 3


def test_request_key_covers_every_negotiated_field(impl):
    w, key = impl.w, impl.cache.request_key
    variants = [impl.req(1, "t"), impl.req(0, "t",
                                           op=w.RequestType.ALLGATHER),
                impl.req(0, "t", dtype=w.DataType.INT32),
                impl.req(0, "t", root=1), impl.req(0, "t", device=3),
                impl.req(0, "t", red=w.ReduceOp.MAX),
                impl.req(0, "t", psid=2),
                impl.req(0, "t", op=w.RequestType.ALLTOALL, splits=(2, 2))]
    keys = {key(impl.req(0, "t"))} | {key(v) for v in variants}
    assert len(keys) == len(variants) + 1


def test_signature_digest_equals_the_reference():
    ref, port = _Impl("reference"), _Impl("port")
    sigs = {}
    for name, im in (("ref", ref), ("port", port)):
        sig = im.cache.signature_of(im.req(0, "grad.0",
                                           red=im.w.ReduceOp.AVERAGE))
        sigs[name] = (sig.describe(), im.cache.cycle_digest([sig]))
    assert sigs["ref"] == sigs["port"] and len(sigs["port"][1]) == 64


def test_cache_hit_skips_negotiation_and_replays_fused(impl):
    cache = impl.cache.ResponseCache(rank=0)
    coord = impl.Coordinator(2, THRESHOLD, cache=cache)
    _, replayed, negotiated = impl.program(coord, cache)
    assert not replayed and len(negotiated) == 2  # fused a+b, g
    assert cache.live_entries() == 3 and cache.stats.hits == 0
    _, replayed, negotiated = impl.program(coord, cache)
    assert cache.stats.hits == 6 and negotiated == []
    by_type = {r.response_type: r for r in replayed}
    assert sorted(by_type[impl.w.ResponseType.ALLREDUCE].tensor_names) == \
        ["a", "b"]
    assert by_type[impl.w.ResponseType.ALLGATHER].tensor_sizes == [2, 2]
    assert cache.stats.plan_misses == 1
    _, replayed, negotiated = impl.program(coord, cache)
    assert negotiated == [] and len(replayed) == 2
    assert cache.stats.plan_hits == 1  # the memoized packing plan
    coord.close()


def test_program_change_flushes_and_surfaces_mismatch(impl, capfd):
    cache = impl.cache.ResponseCache(rank=0)
    coord = impl.Coordinator(2, THRESHOLD, cache=cache)
    for r in range(2):
        coord.submit(impl.req(r, "t"))
    impl.tick(coord, cache)
    assert cache.live_entries() == 1
    coord.submit(impl.req(0, "t"))
    coord.submit(impl.req(1, "t", shape=(8,)))
    resps, replayed, _ = impl.tick(coord, cache)
    assert replayed == []
    errs = [r for r in resps
            if r.response_type == impl.w.ResponseType.ERROR]
    assert len(errs) == 1
    assert "Mismatched allreduce tensor shapes" in errs[0].error_message
    assert cache.live_entries() == 0 and cache.stats.downgrades == 0
    err = capfd.readouterr().err
    assert "[hvd-cache]" in err and "program change" in err
    for r in range(2):
        coord.submit(impl.req(r, "t", shape=(8,)))
    _, _, negotiated = impl.tick(coord, cache)
    assert [r.response_type for r in negotiated] == \
        [impl.w.ResponseType.ALLREDUCE]
    assert cache.live_entries() == 1
    coord.close()


def test_join_disarms_insertion_until_release(impl, capfd):
    w = impl.w
    cache = impl.cache.ResponseCache(rank=0)
    coord = impl.Coordinator(2, THRESHOLD, cache=cache)
    for r in range(2):
        coord.submit(impl.req(r, "warm"))
    impl.tick(coord, cache)
    assert cache.live_entries() == 1
    coord.submit(w.Request(0, w.RequestType.JOIN, w.DataType.UINT8,
                           "hvd.join"))
    assert "hvd.join" in capfd.readouterr().err
    coord.submit(impl.req(1, "through.join"))
    resps, _, negotiated = impl.tick(coord, cache)
    assert any(r.response_type == w.ResponseType.CACHE_FLUSH for r in resps)
    assert any(r.response_type == w.ResponseType.ALLREDUCE
               for r in negotiated)
    assert cache.live_entries() == 0
    coord.submit(w.Request(1, w.RequestType.JOIN, w.DataType.UINT8,
                           "hvd.join"))
    resps, _, _ = impl.tick(coord, cache)
    assert any(r.response_type == w.ResponseType.JOIN for r in resps)
    for r in range(2):
        coord.submit(impl.req(r, "post.join"))
    impl.tick(coord, cache)
    assert cache.live_entries() == 1  # insertion armed again
    coord.close()


def test_membership_allgather_flushes_deterministically(impl):
    w = impl.w
    cache = impl.cache.ResponseCache(rank=0)
    coord = impl.Coordinator(2, THRESHOLD, cache=cache)
    for r in range(2):
        coord.submit(impl.req(r, "warm"))
    impl.tick(coord, cache)
    assert cache.live_entries() == 1
    for r in range(2):
        coord.submit(impl.req(r, "process_set.register.7.sizes", shape=(1,),
                              op=w.RequestType.ALLGATHER,
                              dtype=w.DataType.INT64))
    impl.tick(coord, cache)
    assert cache.live_entries() == 0
    coord.close()


def test_threshold_change_flushes_plans(impl, capfd):
    cache = impl.cache.ResponseCache(rank=0)
    coord = impl.Coordinator(2, THRESHOLD, cache=cache)
    impl.program(coord, cache)
    impl.program(coord, cache)
    assert cache.stats.plan_misses == 1
    coord.set_fusion_threshold(123456)
    err = capfd.readouterr().err
    assert "fusion plans flushed" in err and "123456" in err
    assert cache.live_entries() == 3  # entries survive
    impl.program(coord, cache)
    assert cache.stats.plan_misses == 2
    coord.close()


def test_withdraw_flushes_and_still_fails_group_wide(impl):
    cache = impl.cache.ResponseCache(rank=0)
    coord = impl.Coordinator(2, THRESHOLD, cache=cache)
    for r in range(2):
        coord.submit(impl.req(r, "w"))
    impl.tick(coord, cache)
    coord.submit(impl.req(0, "w"))
    coord.withdraw("w", 0)
    resps, replayed, _ = impl.tick(coord, cache)
    assert replayed == []
    errs = [r for r in resps
            if r.response_type == impl.w.ResponseType.ERROR]
    assert len(errs) == 1
    assert "was abandoned: rank 0" in errs[0].error_message
    assert cache.live_entries() == 0
    coord.close()


def test_capacity_flush_is_marker_driven(impl):
    cache = impl.cache.ResponseCache(rank=0, capacity=2)
    coord = impl.Coordinator(1, 0, cache=cache)
    for name in ("a", "b", "c"):
        coord.submit(impl.req(0, name))
    impl.tick(coord, cache)
    assert cache.live_entries() == 3
    assert cache.check_capacity() == []
    assert cache.live_entries() == 0
    marker = cache.take_flush_marker()
    assert marker.response_type == impl.w.ResponseType.CACHE_FLUSH
    assert marker.tensor_sizes[0] == cache.epoch
    coord.close()


def test_stale_epoch_bit_downgrades_to_real_submit(impl):
    cache = impl.cache.ResponseCache(rank=0)
    coord = impl.Coordinator(2, THRESHOLD, cache=cache)
    for r in range(2):
        coord.submit(impl.req(r, "t"))
    impl.tick(coord, cache)
    old_epoch = cache.epoch
    cache.flush("test-induced", broadcast=True)
    down = cache.hit_from_wire(0, 1, old_epoch)
    assert down is not None and down.tensor_name == "t"
    assert cache.stats.downgrades == 1
    coord.submit(down)
    coord.submit(impl.req(0, "t"))
    resps, replayed, _ = impl.tick(coord, cache)
    assert replayed == []
    assert impl.w.ResponseType.ALLREDUCE in [r.response_type for r in resps]
    coord.close()


def test_hit_records_and_replay_payload_round_trip():
    batch = transport.encode_hits([(3, 0), (3, 7), (4, 1)])
    assert transport.decode_batch(batch) == [
        (transport.KIND_HITS, (3, [0, 7])),
        (transport.KIND_HITS, (4, [1]))]
    kind, body = transport.decode_payload(
        transport.encode_replay([[2, 0], [5]], 9))
    assert kind == transport.PAYLOAD_REPLAY and body == ([[2, 0], [5]], 9)
    with pytest.raises(ValueError, match="unknown payload kind"):
        transport.decode_payload(b"\x05")


# -- the runtime, one rank ----------------------------------------------------

def _program(steps=3):
    """A little training-like program: a grouped allreduce, an averaged
    allreduce, an allgather and a broadcast each step, fixed names."""
    rng = np.random.RandomState(0)
    outs = []
    for _ in range(steps):
        xs = [torch.from_numpy(rng.rand(n).astype(np.float32))
              for n in (3, 5, 7)]
        outs += thvd.grouped_allreduce(xs, op=thvd.Sum, name="g")
        outs.append(thvd.allreduce(xs[0], name="avg"))
        outs.append(thvd.allgather(xs[1].reshape(5, 1), name="ag"))
        outs.append(thvd.broadcast(xs[2], 0, name="bc"))
    return outs


def test_numerical_identity_cache_on_vs_off(monkeypatch):
    got = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("HVD_TPU_RESPONSE_CACHE", flag)
        thvd.init(device="cpu")
        try:
            assert (TC._runtime().cache is not None) == (flag == "1")
            TC.reset_stats()
            got[flag] = _program()
            got[flag + "stats"] = TC.stats()
        finally:
            thvd.shutdown()
    assert all(torch.equal(a, b) for a, b in zip(got["1"], got["0"]))
    # 6 requests a step: all miss in the first step, all hit after.
    assert got["1stats"]["cache_hits"] == 12
    assert got["1stats"]["cache_misses"] == 6
    assert got["0stats"]["cache_hits"] == 0
    assert got["1stats"]["responses"] == got["0stats"]["responses"]


def test_handle_and_timeline_surface_cache_hits(tmp_path):
    thvd.init(device="cpu")
    path = tmp_path / "tl.json"
    try:
        thvd.start_timeline(str(path))
        rt = TC._runtime()
        flags = []
        for _ in range(2):
            h = thvd.allreduce_async(torch.ones(2), name="surf")
            flags.append(rt.handles.get(h).cache_hit)
            thvd.synchronize(h)
        thvd.stop_timeline()
    finally:
        thvd.shutdown()
    assert flags == [False, True]
    events = json.loads(path.read_text())
    execute = [e.get("args", {}).get("cache") for e in events
               if e.get("name") == "ALLREDUCE"]
    assert execute == ["miss", "hit"]
    assert any(e.get("name") == "CACHE_HIT" for e in events)
    assert any(e.get("name") == "CACHE_MISS" for e in events)
