"""Distill a draft model from a served transformer LM: the port's twin of
examples/distill_draft.py.

Speculative decoding needs a small draft that agrees with the target
often enough to pay for itself.  This loads the serving checkpoint
``transformer_lm --export`` writes, derives a half-size draft config
(same vocab and max_seq_len, so the bitwise-greedy acceptance rule
applies as it is), trains the draft by temperature-softened KL against
the frozen teacher's logits on synthetic batches through the port's
``make_train_step`` (on the GPU its attention is the flash kernels),
reports the greedy agreement on held-out data, and ``--export``s a
serving checkpoint that ``serve_lm --draft`` loads.

    python -m horovod_tpu_torch.examples.transformer_lm --device cpu \\
        --export /tmp/lm-ckpt
    python -m horovod_tpu_torch.examples.distill_draft /tmp/lm-ckpt \\
        --device cpu --export /tmp/lm-draft
    python -m horovod_tpu_torch.examples.serve_lm /tmp/lm-ckpt \\
        --device cpu --draft /tmp/lm-draft --tokens 5,3,8,1 -n 16

One difference from the reference: the draft keeps the teacher's dtype
(the reference's config takes its default, float32), so a bf16 teacher's
draft trains on the bf16 Hopper kernels.  ``HVD_TPU_EXAMPLE_STEPS``
sets the default step count (60), as in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Callable

import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                  forward, init_transformer,
                                                  synthetic_lm_batch)
from horovod_tpu_torch.utils.checkpoint import (load_serving_checkpoint,
                                                save_serving_checkpoint)
from horovod_tpu_torch.utils.tree import tree_leaves, tree_map


def draft_config(cfg: TransformerConfig) -> TransformerConfig:
    """Half the teacher along every axis that costs decode latency (the
    reference's :40-50), the same vocab and max_seq_len."""
    return dataclasses.replace(
        cfg, d_model=max(32, cfg.d_model // 2),
        n_heads=max(1, cfg.n_heads // 2),
        n_layers=max(1, cfg.n_layers // 2),
        d_ff=max(64, cfg.d_ff // 2), num_experts=0, remat=False,
        loss_chunk=0)


def distill_loss(dcfg: TransformerConfig, temperature: float) -> Callable:
    """``loss(params, (tokens, teacher_logits))``: the temperature-
    softened KL(teacher || draft), scaled by T^2 (reference :76-82)."""

    def loss(params, batch):
        toks, tlogits = batch
        t = temperature
        log_s = torch.log_softmax(forward(params, toks, dcfg) / t, dim=-1)
        log_t = torch.log_softmax(tlogits / t, dim=-1)
        kl = (log_t.exp() * (log_t - log_s)).sum(dim=-1)
        return kl.mean() * t * t

    return loss


def distill(tparams, tcfg: TransformerConfig, *, steps: int, batch: int,
            seq: int, temperature: float = 2.0, lr: float = 1e-3) -> dict:
    """Train the draft of ``tcfg`` for ``steps`` steps (after
    ``hvd.init``).  Returns the losses, the draft's parameters and
    config, the held-out greedy agreement, and the train step with its
    last batch (to time further steps)."""
    dev = hvd.device()
    dcfg = draft_config(tcfg)
    tparams = tree_map(lambda x: x.detach().to(dev), tparams)
    dparams = init_transformer(torch.Generator().manual_seed(2), dcfg,
                               device=dev)
    leaves = tree_leaves(dparams)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(leaves, lr=lr,
                                                     weight_decay=1e-4))
    step = hvd.make_train_step(distill_loss(dcfg, temperature), opt)

    def teacher(toks):
        with torch.no_grad():
            return forward(tparams, toks, tcfg)

    losses = []
    for s in range(steps):
        toks, _ = synthetic_lm_batch(torch.Generator().manual_seed(100 + s),
                                     batch, seq, dcfg.vocab_size, dev)
        data = (toks, teacher(toks))
        losses.append(float(step(dparams, data)))
        if (s + 1) % 20 == 0:
            print(f"step {s + 1}: distill_kl={losses[-1]:.4f}")
    # Held-out greedy agreement: what speculative decoding's acceptance
    # rate tracks.
    etoks, _ = synthetic_lm_batch(torch.Generator().manual_seed(9), batch,
                                  seq, dcfg.vocab_size, dev)
    with torch.no_grad():
        d_pick = forward(dparams, etoks, dcfg).argmax(dim=-1)
    agreement = float((teacher(etoks).argmax(dim=-1) == d_pick).float()
                      .mean())
    return {"losses": losses, "params": dparams, "cfg": dcfg,
            "agreement": agreement, "step": step, "last_batch": data,
            "teacher_params": sum(x.numel() for x in tree_leaves(tparams)),
            "draft_params": sum(x.numel() for x in leaves)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint", help="TARGET serving checkpoint "
                                       "(transformer_lm --export)")
    ap.add_argument("--export", type=str, default=None, metavar="DIR",
                    help="write the distilled draft's serving checkpoint "
                         "here (serve_lm --draft DIR)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=2.0,
                    help="distillation softening temperature")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    hvd.init(device=args.device)
    tparams, tcfg, meta = load_serving_checkpoint(args.checkpoint)
    steps = args.steps or int(os.environ.get("HVD_TPU_EXAMPLE_STEPS", "60"))
    seq = min(args.seq or 64, tcfg.max_seq_len)
    run = distill(tparams, tcfg, steps=steps, batch=args.batch, seq=seq,
                  temperature=args.temperature)
    first, final = run["losses"][0], run["losses"][-1]
    print(f"distill_kl {first:.4f} -> {final:.4f} "
          f"(teacher {run['teacher_params'] / 1e6:.1f}M -> draft "
          f"{run['draft_params'] / 1e6:.1f}M params, greedy agreement "
          f"{run['agreement']:.2f})")
    if not final < first:
        raise SystemExit("distill_draft: distillation loss did not improve")
    if args.export:
        w = save_serving_checkpoint(
            args.export, run["params"], run["cfg"],
            tokenizer=meta["tokenizer"]["kind"],
            extra={"distilled_from": os.path.abspath(args.checkpoint),
                   "distill_steps": steps,
                   "greedy_agreement": round(run["agreement"], 4)},
            block=True)
        if w:
            print(f"draft checkpoint exported: {args.export}")
    hvd.shutdown()
    print("distill_draft: OK")


if __name__ == "__main__":
    main()
