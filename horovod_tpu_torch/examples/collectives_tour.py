"""Tour of the negotiated collectives: the port's twin of
examples/collectives_tour.py.  Allreduce with its reduce operators,
ragged allgather, broadcast, reducescatter, ragged alltoall, grouped
allreduce, object collectives, a process set and barrier, each checked
against its closed form.

    python -m horovod_tpu_torch.examples.collectives_tour --device cpu
    # several ranks: one process each under a launcher that sets RANK,
    # WORLD_SIZE, MASTER_ADDR and MASTER_PORT (torchrun does), e.g.
    torchrun --nproc-per-node 2 -m horovod_tpu_torch.examples.collectives_tour --device cpu
"""

from __future__ import annotations

import argparse

import torch

import horovod_tpu_torch as hvd


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    hvd.init(device=args.device)
    r, n, dev = hvd.rank(), hvd.size(), hvd.device()

    # allreduce: sum / min / max / product (rank r contributes r + 1).
    x = torch.full((4,), float(r + 1), device=dev)
    assert float(hvd.allreduce(x, average=False)[0]) == n * (n + 1) / 2
    assert float(hvd.allreduce(x, op=hvd.Min)[0]) == 1.0
    assert float(hvd.allreduce(x, op=hvd.Max)[0]) == float(n)
    fact = 1
    for k in range(1, n + 1):
        fact *= k
    assert float(hvd.allreduce(x, op=hvd.Product)[0]) == float(fact)

    # ragged allgather: rank r contributes r + 1 rows.
    g = hvd.allgather(torch.full((r + 1, 2), float(r), device=dev))
    assert g.shape[0] == n * (n + 1) // 2

    # broadcast from the last rank.
    b = hvd.broadcast(torch.full((3,), float(r), device=dev), n - 1)
    assert torch.equal(b, torch.full((3,), float(n - 1), device=dev))

    # reducescatter: this rank's chunk of the summed arange.
    rs = hvd.reducescatter(torch.arange(2.0 * n, device=dev) + r,
                           average=False)
    want = (n * torch.arange(2.0 * n) + sum(range(n)))[2 * r:2 * r + 2]
    assert torch.equal(rs.cpu(), want)

    # ragged alltoall: rank r sends r + 1 rows to each destination; the
    # rows from sender s carry the value s, in rank order.
    rows = torch.full(((r + 1) * n, 1), float(r), device=dev)
    recv = hvd.alltoall(rows, splits=[r + 1] * n).cpu()
    assert recv.shape[0] == n * (n + 1) // 2
    off = 0
    for s in range(n):
        assert bool((recv[off:off + s + 1] == s).all())
        off += s + 1

    # grouped: one fused response.
    outs = hvd.grouped_allreduce([torch.ones(2, device=dev),
                                  torch.ones(3, device=dev)], average=False)
    assert all(float(o[0]) == n for o in outs)

    # object collectives.
    objs = hvd.allgather_object({"rank": r})
    assert [o["rank"] for o in objs] == list(range(n))

    # a singleton process set beside world ops.
    ps = hvd.add_process_set([0])
    if ps.included():
        assert float(hvd.allreduce(torch.ones(1, device=dev), average=False,
                                   process_set=ps)[0]) == 1.0
    hvd.remove_process_set(ps)

    hvd.barrier()
    print(f"collectives_tour: OK rank={r} size={n}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
