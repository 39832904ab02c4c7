"""Skip-gram word2vec with sparse gradient exchange: the port's twin of
examples/word2vec.py (≙ upstream Horovod's
examples/tensorflow_word2vec.py, the workload of the IndexedSlices
allreduce).

    python -m horovod_tpu_torch.examples.word2vec --device cpu
    torchrun --nproc-per-node 2 -m horovod_tpu_torch.examples.word2vec \\
        --device cpu
    # upstream's configuration on the GPU (vocabulary 50,000, embedding
    # 128, batch 128, 64 negatives, a Zipf corpus of 1,000,000 tokens):
    python -m horovod_tpu_torch.examples.word2vec --vocab 50000 \\
        --corpus 1000000 --steps 200

Each step: the NCE loss's backward gives the embedding a sparse COO
gradient; its rows go as ``IndexedSlices`` through ``hvd.allreduce`` (an
allgather of values and indices, averaged) and are applied with
``apply_to``; the NCE weights and biases are averaged densely.  The
sparse pair takes a name per step (its nnz changes, so a fixed name would
be a new program every step for the response cache); the dense pair keeps
fixed names and is served from the cache after the first step.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import word2vec as W
from horovod_tpu_torch.ops import sparse as S


def batch_tensors(rng: np.random.RandomState, corpus: np.ndarray,
                  batch: int, negatives: int, vocab: int, device,
                  window: int = 2):
    """One step's (centers, targets, negatives) on ``device``, drawn as
    the reference's example draws them."""
    centers, targets = W.skipgram_batch(rng, corpus, batch, window)
    negs = rng.randint(0, vocab, size=negatives).astype("int32")
    return tuple(torch.from_numpy(a).long().to(device)
                 for a in (centers, targets, negs))


def train_step(model: W.Word2Vec, centers, targets, negs, lr: float,
               step: int) -> torch.Tensor:
    """One synchronous data-parallel SGD step; returns the loss (this
    rank's batch).  ``model`` is updated in place."""
    model.zero_grad(set_to_none=True)
    loss = model(centers, targets, negs)
    loss.backward()
    sl = hvd.allreduce(S.from_sparse_coo(model.embeddings.grad),
                       average=True, name=f"w2v.emb.{step}")
    g_w = hvd.allreduce(model.nce_weights.grad, name="w2v.w")
    g_b = hvd.allreduce(model.nce_biases.grad, name="w2v.b")
    with torch.no_grad():
        model.embeddings.copy_(S.apply_to(model.embeddings, sl, scale=-lr))
        model.nce_weights.sub_(lr * g_w)
        model.nce_biases.sub_(lr * g_b)
    return loss.detach()


def train(*, vocab: int = 2000, dim: int = 128, batch: int = 128,
          negatives: int = 64, steps: int = 100, corpus_len: int = 100_000,
          lr: float = 0.2, window: int = 2, seed: int = 0, device=None,
          timed_from: int = 0, log_every: int = 0) -> dict:
    """Initialize (same weights on every rank, from ``seed``), then
    ``steps`` steps of ``batch`` pairs a rank.  Returns the losses, the
    wall time of steps ``timed_from..`` (ended by a device synchronise),
    the model and the corpus."""
    hvd.init(device=device)
    dev = hvd.device()
    model = W.init_params(vocab, dim, torch.Generator().manual_seed(seed),
                          device=dev)
    corpus = W.synthetic_corpus(vocab, corpus_len, seed)
    rng = np.random.RandomState(seed + hvd.rank())

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses, t0 = [], time.perf_counter()
    for step in range(steps):
        if step == timed_from:
            sync()
            t0 = time.perf_counter()
        loss = train_step(model, *batch_tensors(rng, corpus, batch,
                                                 negatives, vocab, dev,
                                                 window), lr, step)
        losses.append(loss)
        if log_every and step % log_every == 0:
            print(f"step {step}: loss={float(loss):.4f}")
    sync()
    elapsed = time.perf_counter() - t0
    return {"losses": [float(x) for x in losses], "timed_seconds": elapsed,
            "model": model, "corpus": corpus}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--vocab", type=int, default=2000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--negatives", type=int, default=64)
    ap.add_argument("--corpus", type=int, default=100_000,
                    help="tokens of the synthetic Zipf corpus")
    ap.add_argument("--lr", type=float, default=0.2)
    args = ap.parse_args()
    run = train(vocab=args.vocab, dim=args.dim, batch=args.batch,
                negatives=args.negatives, steps=args.steps,
                corpus_len=args.corpus, lr=args.lr, device=args.device,
                log_every=20)
    first, last = run["losses"][0], run["losses"][-1]
    print(f"final loss={last:.4f} (first {first:.4f}, {hvd.size()} ranks)")
    if not last < first:
        raise SystemExit("word2vec: loss did not improve")
    print("word2vec: OK")
    hvd.shutdown()


if __name__ == "__main__":
    main()
