"""horovod_tpu_torch's wire format and coordinator against horovod_tpu's.

* Requests and responses pack to the reference's bytes and round-trip.
* 200 seeded request sequences go to the reference's ``PyCoordinator``
  and to the port's: allreduce, allgather, broadcast, alltoall and
  reducescatter over several dtypes, shapes, reduce ops, roots and
  splits, with mismatches, joins, withdrawals, two process-set ids,
  duplicate requests and fusion thresholds 0, 64 B and 64 MB.  Every
  poll's packed response list is byte-identical, and so are the stall
  warnings at a given time.
"""

import numpy as np
import pytest

from horovod_tpu.ops import coordinator as jcoord
from horovod_tpu.ops import wire as jwire
from horovod_tpu_torch.ops import coordinator as tcoord
from horovod_tpu_torch.ops import transport
from horovod_tpu_torch.ops import wire as twire

OPS = ["ALLREDUCE", "ALLGATHER", "BROADCAST", "ALLTOALL", "REDUCESCATTER"]
DTYPES = ["FLOAT32", "BFLOAT16", "INT32", "FLOAT16", "INT64"]
REDUCE_OPS = ["AVERAGE", "SUM", "MIN", "MAX", "PRODUCT"]
THRESHOLDS = [0, 64, 64 << 20]


def _requests(fields):
    """The same request in both packages."""
    out = []
    for w in (jwire, twire):
        f = dict(fields)
        f["request_type"] = w.RequestType[f["request_type"]]
        f["tensor_type"] = w.DataType[f["tensor_type"]]
        f["reduce_op"] = w.ReduceOp[f["reduce_op"]]
        out.append(w.Request(**f))
    return out


def _random_fields(rng, size):
    op = OPS[rng.randint(len(OPS))]
    ndim = rng.randint(0 if op in ("ALLREDUCE", "BROADCAST") else 1, 4)
    shape = tuple(int(d) for d in rng.randint(1, 9, size=ndim))
    if op == "REDUCESCATTER" and shape:
        shape = (shape[0] * size,) + shape[1:]
    splits = ()
    if op == "ALLTOALL" and shape and rng.rand() < 0.6:
        cuts = np.sort(rng.randint(0, shape[0] + 1, size=size - 1))
        splits = tuple(int(s) for s in np.diff(
            np.concatenate([[0], cuts, [shape[0]]])))
    return dict(request_type=op, tensor_type=DTYPES[rng.randint(len(DTYPES))],
                tensor_shape=shape,
                reduce_op=REDUCE_OPS[rng.randint(len(REDUCE_OPS))],
                root_rank=int(rng.randint(size)) if op == "BROADCAST" else -1,
                device=-1 if rng.rand() < 0.5 else 0,
                process_set_id=int(rng.randint(2)), splits=splits)


def _perturb(rng, fields, size):
    """One rank's request differs from the others' in one field."""
    f = dict(fields)
    which = rng.randint(6)
    if which == 0:
        f["tensor_type"] = DTYPES[(DTYPES.index(f["tensor_type"]) + 1)
                                  % len(DTYPES)]
    elif which == 1:
        f["request_type"] = OPS[(OPS.index(f["request_type"]) + 1)
                                % len(OPS)]
    elif which == 2:
        f["tensor_shape"] = tuple(f["tensor_shape"]) + (2,)
    elif which == 3 and f["tensor_shape"]:
        f["tensor_shape"] = (f["tensor_shape"][0] + 1,) + tuple(
            f["tensor_shape"][1:])
    elif which == 4:
        f["root_rank"] = (f["root_rank"] + 1) % size
        f["reduce_op"] = REDUCE_OPS[(REDUCE_OPS.index(f["reduce_op"]) + 1)
                                    % len(REDUCE_OPS)]
    else:
        f["device"] = -1 if f["device"] != -1 else 3
    return f


def _sequence(seed):
    """(size, threshold, events): ("submit", fields, now), ("join", rank,
    now), ("withdraw", name, rank), ("poll",)."""
    rng = np.random.RandomState(seed)
    size = int(rng.randint(1, 5))
    threshold = THRESHOLDS[seed % 3]
    events = []
    for t in range(int(rng.randint(1, 10))):
        name = f"t{seed}.{t}"
        fields = _random_fields(rng, size)
        if rng.rand() < 0.5:  # a gradient-like allreduce that can fuse
            fields.update(request_type="ALLREDUCE", tensor_type="FLOAT32",
                          reduce_op="SUM", device=0, process_set_id=0,
                          root_rank=-1, splits=())
        ranks = list(range(size))
        rng.shuffle(ranks)
        if rng.rand() < 0.2:
            ranks = ranks[:rng.randint(1, size + 1)]  # some never submit
        bad = int(rng.randint(size)) if rng.rand() < 0.25 else -1
        for r in ranks:
            f = _perturb(rng, fields, size) if r == bad else dict(fields)
            f.update(request_rank=r, tensor_name=name)
            events.append(("submit", f, float(t)))
            if rng.rand() < 0.05:
                events.append(("submit", f, float(t)))  # duplicate
        if rng.rand() < 0.1:
            events.append(("withdraw", name, int(rng.randint(size))))
    rng.shuffle(events)
    for r in range(size):
        if rng.rand() < 0.15:  # a joined rank submits nothing more
            last = max([i for i, ev in enumerate(events)
                        if ev[0] == "submit" and ev[1]["request_rank"] == r],
                       default=-1)
            events.insert(int(rng.randint(last + 1, len(events) + 1)),
                          ("join", r, 5.0))
    for _ in range(int(rng.randint(1, 4))):
        events.insert(int(rng.randint(len(events) + 1)), ("poll",))
    events.append(("poll",))
    return size, threshold, events


@pytest.mark.parametrize("block", range(10))
def test_coordinator_responses_are_byte_identical(block):
    for seed in range(block * 20, block * 20 + 20):
        size, threshold, events = _sequence(seed)
        ref = jcoord.PyCoordinator(size, threshold)
        port = tcoord.PyCoordinator(size, threshold)
        for ev in events:
            if ev[0] == "submit":
                jreq, treq = _requests(ev[1])
                outcome = []
                for coord, req in ((ref, jreq), (port, treq)):
                    try:
                        outcome.append(coord.submit(req, now=ev[2]))
                    except ValueError as exc:
                        outcome.append(str(exc))
                assert outcome[0] == outcome[1], (seed, ev)
            elif ev[0] == "join":
                jreq, treq = _requests(dict(
                    request_rank=ev[1], request_type="JOIN",
                    tensor_type="UINT8", tensor_name="hvd.join",
                    reduce_op="AVERAGE"))
                assert ref.submit(jreq, now=ev[2]) == \
                    port.submit(treq, now=ev[2]), (seed, ev)
            elif ev[0] == "withdraw":
                ref.withdraw(ev[1], ev[2])
                port.withdraw(ev[1], ev[2])
            else:
                want = jwire.pack_response_list(ref.poll_responses({}))
                got = twire.pack_response_list(port.poll_responses({}))
                assert got == want, seed
        for now, threshold in ((100.0, 30.0), (8.0, 3.5)):
            assert port.check_stalled(now, threshold) == \
                ref.check_stalled(now, threshold), seed


def test_fusion_uses_the_queue_sizes_first():
    ref = jcoord.PyCoordinator(1, 100)
    port = tcoord.PyCoordinator(1, 100)
    for i in range(4):
        f = dict(request_rank=0, request_type="ALLREDUCE",
                 tensor_type="FLOAT32", tensor_name=f"g{i}",
                 tensor_shape=(4,), reduce_op="SUM")
        jreq, treq = _requests(f)
        ref.submit(jreq, now=0.0)
        port.submit(treq, now=0.0)
    sizes = {"g0": 60, "g1": 30, "g2": 20, "g3": 90}
    want = ref.poll_responses(sizes)
    assert twire.pack_response_list(port.poll_responses(sizes)) == \
        jwire.pack_response_list(want)
    assert [r.tensor_names for r in want] == [["g0", "g1"], ["g2"], ["g3"]]
    # A new threshold applies from the next poll on.
    for coord, w in ((ref, jwire), (port, twire)):
        coord.set_fusion_threshold(200)
        for i in range(4):
            coord.submit(w.Request(0, w.RequestType.ALLREDUCE,
                                   w.DataType.FLOAT32, f"h{i}",
                                   tensor_shape=(4,),
                                   reduce_op=w.ReduceOp.SUM), now=0.0)
    want = jwire.pack_response_list(ref.poll_responses(sizes))
    assert twire.pack_response_list(port.poll_responses(sizes)) == want
    assert len(jwire.unpack_response_list(want)) == 1


@pytest.mark.parametrize("seed", range(4))
def test_wire_packs_to_the_reference_bytes_and_round_trips(seed):
    rng = np.random.RandomState(seed)
    for _ in range(25):
        size = int(rng.randint(1, 5))
        f = _random_fields(rng, size)
        f.update(request_rank=int(rng.randint(size)),
                 tensor_name=f"näme.{rng.randint(1000)}")
        jreq, treq = _requests(f)
        assert treq.pack() == jreq.pack()
        back, end = twire.Request.unpack(treq.pack())
        assert back == treq and end == len(treq.pack())
        assert transport.decode_batch(transport.encode_request(treq)) == \
            [(transport.KIND_REQUEST, treq)]
        rf = dict(response_type=int(rng.randint(9)),
                  tensor_names=[f"n{i}" for i in range(rng.randint(4))],
                  error_message="é" * (seed * 3), devices=[0, -1][:size],
                  tensor_sizes=list(f["tensor_shape"]) + list(f["splits"]),
                  tensor_type=None if seed == 0 else int(rng.randint(13)),
                  tensor_shapes=[tuple(f["tensor_shape"])] * 2,
                  reduce_op=int(twire.ReduceOp[f["reduce_op"]]),
                  process_set_id=f["process_set_id"])
        resp = {w: w.Response(**{
            **rf, "response_type": w.ResponseType(rf["response_type"]),
            "tensor_type": None if rf["tensor_type"] is None
            else w.DataType(rf["tensor_type"]),
            "reduce_op": w.ReduceOp(rf["reduce_op"])})
            for w in (jwire, twire)}
        assert resp[twire].pack() == resp[jwire].pack()
        packed = twire.pack_response_list([resp[twire], resp[twire]])
        assert packed == jwire.pack_response_list([resp[jwire]] * 2)
        assert twire.unpack_response_list(packed) == [resp[twire]] * 2


def test_control_batch_round_trip():
    req = twire.Request(2, twire.RequestType.ALLTOALL,
                        twire.DataType.BFLOAT16, "x", tensor_shape=(6, 3),
                        splits=(1, 2, 3), process_set_id=4)
    batch = (transport.encode_request(req)
             + transport.encode_withdraw("grad.w", 4)
             + transport.encode_shutdown())
    assert transport.decode_batch(batch) == [
        (transport.KIND_REQUEST, req),
        (transport.KIND_WITHDRAW, (4, "grad.w")),
        (transport.KIND_SHUTDOWN, None)]
    with pytest.raises(ValueError, match="unknown message kind"):
        transport.decode_batch(b"\x07")


def test_torch_dtypes_map_to_the_reference_wire_types():
    import jax.numpy as jnp
    import torch

    pairs = [(torch.float32, np.float32), (torch.float64, np.float64),
             (torch.int32, np.int32), (torch.int64, np.int64),
             (torch.uint8, np.uint8), (torch.int8, np.int8),
             (torch.int16, np.int16), (torch.bool, np.bool_),
             (torch.float16, np.float16),
             (torch.bfloat16, jnp.dtype(jnp.bfloat16))]
    for t, n in pairs:
        assert int(twire.dtype_of(t)) == int(jwire.dtype_of(n))
        assert twire.torch_dtype_of(twire.dtype_of(t)) == t
        assert twire.dtype_size(twire.dtype_of(t)) == t.itemsize
    with pytest.raises(ValueError, match="Unsupported dtype"):
        twire.dtype_of(torch.complex64)


# -- the JOIN re-ready repair (ROADMAP.md C.1) ------------------------------

def test_join_then_late_request_gives_one_response():
    """A rank's request for a tensor a JOIN already made ready: the
    reference appends the name to its ready list a second time and its
    next poll raises KeyError; the port gives the one response."""
    got = {}
    for name, coord_mod, w in (("ref", jcoord, jwire),
                               ("port", tcoord, twire)):
        coord = coord_mod.PyCoordinator(2, 1 << 20)

        def req(rank):
            return w.Request(rank, w.RequestType.ALLREDUCE,
                             w.DataType.FLOAT32, "t", tensor_shape=(2,))

        assert coord.submit(req(0), now=0.0) is False
        coord.submit(w.Request(1, w.RequestType.JOIN, w.DataType.UINT8,
                               "hvd.join"), now=0.0)
        assert coord.submit(req(1), now=0.0) is True
        try:
            got[name] = coord.poll_responses({})
        except KeyError as exc:
            got[name] = exc
    assert isinstance(got["ref"], KeyError)
    assert [(r.response_type, r.tensor_names) for r in got["port"]] == \
        [(twire.ResponseType.ALLREDUCE, ["t"])]


# -- the response cache on the same 200 sequences ----------------------------

def _cached(mod_coord, mod_cache, size, threshold, python_impl=None):
    cache = mod_cache.ResponseCache(rank=0)
    coord = mod_coord.Coordinator(size, threshold, cache=cache)
    if python_impl is not None:
        # The port copies the reference's Python coordinator; hold the
        # reference to it, not to its native twin.
        coord._impl = python_impl(size, threshold)
    return coord, cache


def _tick(coord, cache, threshold):
    """One rank-0 cycle as ops/collective.py orders it: the flush
    marker, the replayed responses, the fresh ones; every response
    observed in that order."""
    marker = cache.take_flush_marker()
    replayed, _, _, _ = cache.take_ready(lambda psid: threshold)
    negotiated = coord.poll_responses({})
    resps = ([marker] if marker is not None else []) + replayed + negotiated
    for r in resps:
        cache.observe_response(r, replay=any(r is x for x in replayed))
    return resps


def _per_tensor(w, resps):
    """A poll's responses as sorted per-tensor records: what each tensor
    executes, whatever the fusion and with the cache's markers left out."""
    out = []
    for r in resps:
        if r.response_type == w.ResponseType.CACHE_FLUSH:
            continue
        for i, n in enumerate(r.tensor_names):
            shape = (tuple(r.tensor_shapes[i]) if len(r.tensor_shapes) > 1
                     else tuple(tuple(s) for s in r.tensor_shapes))
            out.append((n, int(r.response_type), r.error_message,
                        tuple(r.devices), tuple(r.tensor_sizes),
                        None if r.tensor_type is None else int(r.tensor_type),
                        shape, int(r.reduce_op), r.process_set_id))
    if not out and any(r.response_type == w.ResponseType.JOIN
                       for r in resps):
        out.append(("join",))
    return sorted(out, key=repr)


@pytest.mark.parametrize("block", range(10))
def test_cached_coordinator_streams_match_the_reference_and_cache_off(block):
    """Each seeded sequence runs twice (two "steps", the second one
    served from the cache where its requests repeat).  The port's cached
    stream is byte-identical to the reference's cached stream, poll for
    poll, markers and replays included; its per-tensor records equal the
    port's with the cache off.  A rank's request for a name it still has
    pending is left out: the runtime refuses it at enqueue, and a cache
    hit, in the reference as here, does not re-check duplicates (the
    uncached test above holds the duplicate message).  Where the reference's own poll raises the
    KeyError of its JOIN re-ready fault (ROADMAP.md C.1; a joined rank
    carried into the second step), the comparison with it stops there
    and the port's stream is still held to the cache-off stream."""
    from horovod_tpu.ops import cache as jcache
    from horovod_tpu_torch.ops import cache as tcache

    for seed in range(block * 20, block * 20 + 20):
        size, threshold, events = _sequence(seed)
        ref, rcache = _cached(jcoord, jcache, size, threshold,
                              jcoord.PyCoordinator)
        port, pcache = _cached(tcoord, tcache, size, threshold)
        off = tcoord.PyCoordinator(size, threshold)
        ref_ok = True
        for step in range(2):
            for ev in events:
                if ev[0] == "submit" and ev[1]["tensor_name"] in off.table \
                        and ev[1]["request_rank"] in \
                        off.table[ev[1]["tensor_name"]].ranks:
                    continue
                if ev[0] in ("submit", "join"):
                    f = ev[1] if ev[0] == "submit" else dict(
                        request_rank=ev[1], request_type="JOIN",
                        tensor_type="UINT8", tensor_name="hvd.join",
                        reduce_op="AVERAGE")
                    jreq, treq = _requests(f)
                    outcome = []
                    for coord, req in ((ref, jreq), (port, treq),
                                       (off, treq)):
                        try:
                            outcome.append(coord.submit(req))
                        except ValueError as exc:
                            outcome.append(str(exc))
                    assert outcome[1] == outcome[2] or \
                        isinstance(outcome[1], str), (seed, step, ev)
                    assert not ref_ok or outcome[0] == outcome[1], \
                        (seed, step, ev)
                elif ev[0] == "withdraw":
                    for coord in (ref, port, off):
                        coord.withdraw(ev[1], ev[2])
                else:
                    got = _tick(port, pcache, threshold)
                    if ref_ok:
                        try:
                            want = _tick(ref, rcache, threshold)
                        except KeyError:
                            ref_ok = False
                    if ref_ok:
                        assert twire.pack_response_list(got) == \
                            jwire.pack_response_list(want), (seed, step)
                    assert _per_tensor(twire, got) == _per_tensor(
                        twire, off.poll_responses({})), (seed, step)
        if ref_ok:
            assert pcache.stats.hits == rcache.stats.hits, seed
            assert pcache.live_entries() == rcache.live_entries(), seed
