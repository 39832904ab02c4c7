"""CLI: ``python -m horovod_tpu_torch.trace <fleet-trace.json> [--json out]``
(copied from horovod_tpu/trace/__main__.py:1-46).

Prints the human critical-path / straggler report (trace/analyze.py);
``--json`` additionally writes the machine report (``-`` for stdout —
the machine-readable form).
"""

from __future__ import annotations

import argparse
import json
import sys

from .analyze import analyze, load_trace, render


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.trace",
        description="hvd-trace fleet-trace analyzer (docs/tracing.md)")
    ap.add_argument("trace", help="merged fleet trace "
                    "(hvd.dump_fleet_trace output) or a rank-0 "
                    "Chrome timeline")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the JSON report ('-' = stdout, "
                    "suppressing the human report)")
    args = ap.parse_args(argv)
    try:
        events = load_trace(args.trace)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    report = analyze(events)
    text = json.dumps(report, sort_keys=True, indent=1)
    if args.json == "-":
        print(text)
        return 0
    if args.json:
        with open(args.json, "w") as f:
            f.write(text + "\n")
    sys.stdout.write(render(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
