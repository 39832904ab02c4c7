"""CLI for hvd-chaos (port of horovod_tpu/chaos/__main__.py).

  python -m horovod_tpu_torch.chaos --matrix            run the scenario
                                                        matrix on the card
  python -m horovod_tpu_torch.chaos --matrix --device cpu
  python -m horovod_tpu_torch.chaos --matrix --only A B run a subset
  python -m horovod_tpu_torch.chaos --list              print the matrix
                                                        and what waits
  python -m horovod_tpu_torch.chaos --scenario NAME     (child) one local
                                                        scenario here
  python -m horovod_tpu_torch.chaos --node R --np N \\
      --port P --scenario NAME                          (child) one rank of
                                                        a cp fleet
"""

from __future__ import annotations

import argparse
import os
import sys

from . import matrix as _matrix


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.chaos")
    ap.add_argument("--matrix", action="store_true",
                    help="run the no-hang scenario matrix")
    ap.add_argument("--only", nargs="*", default=None,
                    help="scenario subset for --matrix")
    ap.add_argument("--list", action="store_true",
                    help="list the matrix scenarios and those waiting")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; a cp fleet runs on the "
                         "CPU when there are fewer cards than ranks")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--matrix: scenarios run at a time")
    ap.add_argument("--scenario", default=None,
                    help="(child) scenario name")
    ap.add_argument("--node", type=int, default=None,
                    help="(child) cp fleet rank")
    ap.add_argument("--np", type=int, default=2,
                    help="(child) cp fleet size")
    ap.add_argument("--port", type=int, default=0,
                    help="(child) the fleet's rendezvous port")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for s in _matrix.SCENARIOS:
            print(f"{s.name:26s} {s.kind:5s} expect={s.expect:10s} "
                  f"cap={s.cap:.0f}s spec={s.spec!r}")
        for name, step in sorted(_matrix.WAITING.items()):
            print(f"{name:26s} waits for {step}")
        return 0
    if args.matrix:
        return _matrix.run_matrix(only=args.only, verbose=args.verbose,
                                  device=args.device, jobs=args.jobs)
    if args.node is not None:
        os.environ.update(RANK=str(args.node), WORLD_SIZE=str(args.np),
                          LOCAL_RANK=str(args.node),
                          MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(args.port))
        _matrix.run_cp_node(args.device)
        return 0
    if args.scenario:
        fn = _matrix.LOCAL_SCENARIOS.get(args.scenario)
        if fn is None:
            print(f"unknown local scenario {args.scenario!r}",
                  file=sys.stderr)
            return 2
        fn(args.device)
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
