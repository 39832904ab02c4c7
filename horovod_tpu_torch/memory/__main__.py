"""``python -m horovod_tpu_torch.memory`` — the no-hardware memory dryrun
(copied from horovod_tpu/memory/__main__.py:1-130; the
``hvd.schedule_plan`` convention).

``--plan`` prints one deterministic JSON plan for a named model and its
what-if knobs; identical arguments produce byte-identical output, and the
same output as the reference's ``python -m horovod_tpu.memory --plan``.
No devices are touched and nothing is
compiled — answering "will this config fit" must not itself need the
hardware it is sizing.

Examples::

  python -m horovod_tpu_torch.memory --plan --model transformer_lm \\
      --batch-size 64 --world 8 --capacity-bytes $((16 << 30))
  python -m horovod_tpu_torch.memory --plan --model pipeline \\
      --stages 4 --microbatches 8 --schedule gpipe   # the what-if
  python -m horovod_tpu_torch.memory --plan --model serving --kv-slots 32
"""

from __future__ import annotations

import argparse
import sys

from . import planner


def _build(args: argparse.Namespace) -> "planner.MemoryPlan":
    cap = args.capacity_bytes
    if args.model == "dataplane":
        return planner.plan_dataplane(
            tensors=args.tensors, elems=args.elems, world=args.world,
            dtype=args.dtype, fusion_threshold=args.fusion_threshold,
            capacity=cap)
    if args.model == "pipeline":
        return planner.plan_pipeline(
            n_stages=args.stages, num_microbatches=args.microbatches,
            microbatch_rows=args.microbatch_rows, width=args.width,
            world=args.world, schedule=args.schedule,
            interleave=args.interleave, dtype=args.dtype, capacity=cap)
    if args.model == "serving":
        return planner.plan_serving(
            n_layers=args.layers, n_heads=args.heads,
            head_dim=args.head_dim, max_slots=args.kv_slots,
            pages_per_slot=args.kv_pages, page_size=args.page_size,
            world=args.world, dtype=args.dtype,
            prefix_pages=args.prefix_pages,
            draft_layers=args.draft_layers,
            vocab_size=args.vocab_size, capacity=cap)
    return planner.plan_transformer_lm(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_heads=args.heads, n_layers=args.layers, d_ff=args.d_ff,
        max_seq_len=args.seq_len, batch_size=args.batch_size,
        world=args.world, optimizer=args.optimizer,
        prefetch_depth=args.prefetch_depth, dtype=args.dtype,
        capacity=cap)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.memory",
        description="static HBM planner: predict peak per-rank bytes "
                    "and answer what-if questions without hardware")
    ap.add_argument("--plan", action="store_true",
                    help="print the resolved plan JSON (deterministic: "
                         "same config => byte-identical output)")
    ap.add_argument("--model", default="transformer_lm",
                    choices=list(planner.model_names()))
    ap.add_argument("--world", type=int, default=1,
                    help="replica count (per-rank figures divide the "
                         "batch by it)")
    ap.add_argument("--capacity-bytes", type=int, default=None,
                    help="advertised per-rank HBM; adds fits/headroom "
                         "to the plan")
    ap.add_argument("--dtype", default="float32")
    # transformer_lm / serving model shape
    ap.add_argument("--vocab-size", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-ff", type=int, default=256)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--prefetch-depth", type=int, default=2)
    ap.add_argument("--head-dim", type=int, default=16)
    # serving KV what-ifs
    ap.add_argument("--kv-slots", type=int, default=8)
    ap.add_argument("--kv-pages", type=int, default=8,
                    help="pages per slot")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefix-pages", type=int, default=0,
                    help="dedicated shared-prefix page reserve "
                         "(hvd-spec; the serving.prefix_pages ledger "
                         "partition)")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="speculative-decoding draft model depth "
                         "(prices serving.draft_kv + "
                         "serving.draft_params; 0 = no draft)")
    # pipeline what-ifs
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--microbatch-rows", type=int, default=32)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--schedule", default=None,
                    choices=["1f1b", "gpipe"],
                    help="pipeline schedule what-if (default: the "
                         "HVD_TPU_PIPELINE_SCHEDULE env / 1f1b)")
    ap.add_argument("--interleave", type=int, default=None)
    # dataplane what-ifs
    ap.add_argument("--tensors", type=int, default=32)
    ap.add_argument("--elems", type=int, default=256)
    ap.add_argument("--fusion-threshold", type=int, default=None)
    args = ap.parse_args(argv)

    if not args.plan:
        ap.print_help()
        return 2
    try:
        plan = _build(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(plan.to_json())
    if plan.capacity_bytes and not plan.to_dict()["fits"]:
        return 3  # scriptable "does not fit" verdict
    return 0


if __name__ == "__main__":
    sys.exit(main())
