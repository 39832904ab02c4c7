"""Transformer LM training, data parallel: the port's twin of
examples/transformer_lm.py.

    # tiny LM on the GPU (or --device cpu), loss must fall:
    python -m horovod_tpu_torch.examples.transformer_lm

    # GPT-2-small shape (136M parameters, bf16, batch 8, seq 1024), one
    # tokens/sec JSON line:
    python -m horovod_tpu_torch.examples.transformer_lm --bench

    # the hook-driven optimizer of the horovod.torch surface instead of
    # the monolithic reduce after backward:
    python -m horovod_tpu_torch.examples.transformer_lm --hooks --device cpu

    # the LM in stages (chained_lm_loss), its gradient buckets streamed
    # out of the backward stage by stage (parallel/overlap.py); serial
    # sends the same buckets after the whole backward, off is the
    # monolithic step on the staged loss:
    python -m horovod_tpu_torch.examples.transformer_lm --overlap on \
        --device cpu

    # the reference's multi-axis route: make_mesh(data=n/tp, model=tp)
    # (tp = 2 on an even rank count above 1), make_loss_fn over the mesh,
    # make_parallel_train_step; --remat recomputes each layer in the
    # backward pass:
    python -m horovod_tpu_torch.examples.transformer_lm --parallel \
        --remat --device cpu

    # several GPUs: one process per GPU under a launcher that sets RANK,
    # WORLD_SIZE, MASTER_ADDR, MASTER_PORT (torchrun does).

The flow is Horovod's: init -> broadcast_parameters ->
DistributedOptimizer(AdamW(3e-4)) -> make_train_step -> steps.  With
``--hooks`` the optimizer is ``frontends.torch.DistributedOptimizer``
over the named parameter leaves: each gradient's negotiated
``allreduce_async_`` starts from its hook during backward and ``step()``
synchronizes them.  With ``--parallel`` the optimizer is AdamW itself:
``make_parallel_train_step`` sums the gradients over the mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.core.topology import make_mesh
from horovod_tpu_torch.frontends import torch as hvd_torch
from horovod_tpu_torch.models.transformer import (ParallelAxes,
                                                  TransformerConfig,
                                                  chained_lm_loss,
                                                  chained_lm_params,
                                                  init_transformer,
                                                  make_loss_fn,
                                                  synthetic_lm_batch)
from horovod_tpu_torch.parallel.training import make_parallel_train_step
from horovod_tpu_torch.utils.tree import tree_named_leaves


def bench_config(seq: int = 1024, loss_chunk: int = 0) -> TransformerConfig:
    """GPT-2-small, as examples/transformer_lm.py --bench: vocab 32768,
    d_model 768, 12 heads, 12 layers, d_ff 3072, bf16."""
    return TransformerConfig(vocab_size=32768, d_model=768, n_heads=12,
                             n_layers=12, d_ff=3072, max_seq_len=seq,
                             dtype=torch.bfloat16, loss_chunk=loss_chunk)


def tiny_config(seq: int = 64) -> TransformerConfig:
    return TransformerConfig(vocab_size=512, d_model=64, n_heads=4,
                             n_layers=2, d_ff=128, max_seq_len=max(seq, 128))


def train(cfg: TransformerConfig, *, batch: int, seq: int, steps: int,
          timed_from: int = 0, device=None, seed: int = 0,
          lr: float = 3e-4, hooks: bool = False,
          overlap: Optional[str] = None, parallel: bool = False) -> dict:
    """Initialize, then run ``steps`` train steps on one fixed synthetic
    batch (``batch`` is global; each rank takes its share); ``hooks``
    reduces the gradients through the hook-driven optimizer; ``overlap``
    (``on``, ``serial`` or ``off``) trains the staged form,
    :func:`chained_lm_loss`, with that schedule; ``parallel`` takes the
    reference's multi-axis route (``make_mesh(data=n // tp, model=tp)``,
    ``tp = 2`` on an even rank count above 1, and
    :func:`make_parallel_train_step`).  Returns the
    per-step losses, the wall time of steps ``timed_from..`` (ended by a
    device synchronise), the parameter count, and the step, parameters,
    batch and optimizer for further steps."""
    hvd.init(device=device)
    dev = hvd.device()
    if batch % hvd.size():
        raise ValueError(f"global batch {batch} not divisible by "
                         f"{hvd.size()} ranks")
    params = init_transformer(torch.Generator().manual_seed(seed), cfg,
                              device=dev)
    loss_fn = make_loss_fn(cfg)
    if overlap is not None:
        params, loss_fn = chained_lm_params(params, cfg), chained_lm_loss(cfg)
    hvd.broadcast_parameters(params, root_rank=0)
    leaves = hvd.tree_leaves(params)
    # optax.adamw's weight decay is 1e-4; torch's default is 1e-2.
    adamw = torch.optim.AdamW(leaves, lr=lr, weight_decay=1e-4)
    tokens, targets = synthetic_lm_batch(
        torch.Generator().manual_seed(seed + 1), batch, seq, cfg.vocab_size)
    if parallel:
        n = hvd.size()
        tp = 2 if n % 2 == 0 and n > 1 else 1
        mesh = make_mesh(data=n // tp, model=tp)
        ax = ParallelAxes(data="data", model="model" if tp > 1 else None)
        opt = adamw
        step = make_parallel_train_step(make_loss_fn(cfg, ax, mesh), adamw,
                                        mesh, ("data", None))
        # The step takes the global batch and keeps this rank's shard.
        data = (tokens.to(dev), targets.to(dev))
    else:
        opt = (hvd_torch.DistributedOptimizer(
            adamw, named_parameters=tree_named_leaves(params)) if hooks
            else hvd.DistributedOptimizer(adamw))
        step = hvd.make_train_step(loss_fn, opt, overlap=overlap)
        per_rank = batch // hvd.size()
        mine = slice(hvd.rank() * per_rank, (hvd.rank() + 1) * per_rank)
        data = (tokens[mine].to(dev), targets[mine].to(dev))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses, t0 = [], time.perf_counter()
    for i in range(steps):
        if i == timed_from:
            sync()
            t0 = time.perf_counter()
        losses.append(step(params, data))
    sync()
    elapsed = time.perf_counter() - t0
    return {"losses": [float(x) for x in losses], "timed_seconds": elapsed,
            "n_params": sum(p.numel() for p in leaves), "step": step,
            "params": params, "data": data, "optimizer": opt}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bench", action="store_true",
                    help="GPT-2-small shape; print one tokens/sec JSON line")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--loss-chunk", type=int, default=0,
                    help="chunked cross-entropy: never hold the full "
                         "[batch, seq, vocab] logits")
    ap.add_argument("--hooks", action="store_true",
                    help="reduce each gradient from its hook during "
                         "backward (frontends.torch.DistributedOptimizer)")
    ap.add_argument("--overlap", choices=("off", "serial", "on"),
                    default=None,
                    help="train the staged loss with this overlap schedule")
    ap.add_argument("--parallel", action="store_true",
                    help="the multi-axis route: a data x model mesh and "
                         "make_parallel_train_step")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer in the backward pass")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    if args.parallel and (args.hooks or args.overlap):
        ap.error("--parallel takes neither --hooks nor --overlap")

    if args.bench:
        seq = args.seq or 1024
        cfg = bench_config(seq, args.loss_chunk)
        batch, steps, warmup = args.batch or 8, args.steps or 20, 3
    else:
        seq = args.seq or 64
        cfg = tiny_config(seq)
        batch, steps, warmup = args.batch or 4, args.steps or 30, 0
    cfg = dataclasses.replace(cfg, remat=args.remat)
    run = train(cfg, batch=batch, seq=seq, steps=warmup + steps,
                timed_from=warmup, device=args.device, hooks=args.hooks,
                overlap=args.overlap, parallel=args.parallel)
    dev = hvd.device()
    if args.bench:
        print(json.dumps({
            "metric": "transformer_lm_tokens_per_sec",
            "value": batch * seq * steps / run["timed_seconds"],
            "unit": "tokens/sec",
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "ranks": hvd.size(), "params": run["n_params"], "batch": batch,
            "seq": seq, "loss_chunk": args.loss_chunk, "hooks": args.hooks,
            "overlap": args.overlap, "parallel": args.parallel,
            "remat": args.remat,
            "step_ms": run["timed_seconds"] / steps * 1e3}))
    else:
        first, last = run["losses"][0], run["losses"][-1]
        print(f"loss {first:.4f} -> {last:.4f} "
              f"({run['n_params'] / 1e6:.2f}M params, {hvd.size()} ranks)")
        if not last < first:
            raise SystemExit("transformer_lm: loss did not improve")
        print("transformer_lm: OK")
    hvd.shutdown()


if __name__ == "__main__":
    main()
