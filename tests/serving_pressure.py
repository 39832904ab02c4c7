"""A serving trace that puts a client abort and an admission finishing at
its prefill into one iteration, on a full page pool, for the tests that
hold a follower's page pool to rank 0's (in one process and on gloo
ranks).  Imports neither jax nor a serving package, so a worker process
can use it too.

The engines are 3 slots of 4 pages of 8 tokens (capacity 32, no extra
prefix pages): a pool of 12 pages.  A (25 tokens) holds 4; in one
iteration B (25 tokens, one new token: done at its prefill) and C (25
tokens) take the other 8 while A's client aborts.  Then E maps A's two
cached prefix pages and F needs pages that the prefix LRU must give up.
"""

PRESSURE = {"A": (list(range(1, 26)), 6),
            "B": (list(range(40, 65)), 1),
            "C": (list(range(70, 95)), 4),
            "E": (list(range(1, 17)) + [5, 6, 7], 3),
            "F": (list(range(20, 45)), 3)}


def pool_state(cache):
    """The host side of a page pool that must be identical on every rank:
    the free list and the prefix LRU in their order, the prefix index in
    its insertion order, the reference counts, the page table and the
    lengths."""
    return (list(cache._free), list(cache._lru), list(cache._index.items()),
            sorted(cache._refcount.items()), cache._table.tobytes(),
            cache._lengths.tobytes())


def pressure_trace(step, submit, abort):
    """Drive :data:`PRESSURE` on rank 0: ``submit(name)`` submits one
    request, ``abort(req)`` is the engine's ``abort_request``, and
    ``step()`` runs one iteration and returns whether work remains.
    Returns the requests by name."""
    reqs = {"A": submit("A")}
    step()
    reqs["B"], reqs["C"] = submit("B"), submit("C")
    assert abort(reqs["A"]) == "active"
    step()
    reqs["E"], reqs["F"] = submit("E"), submit("F")
    while step():
        pass
    return reqs
