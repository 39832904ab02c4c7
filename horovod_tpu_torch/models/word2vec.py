"""Skip-gram word2vec with an NCE-style loss: the sparse-gradient
workload (port of horovod_tpu/models/word2vec.py; ≙ upstream Horovod's
examples/tensorflow_word2vec.py).

The embedding lookup is ``F.embedding(..., sparse=True)``, so the
embedding's gradient is a sparse COO tensor of the looked-up rows, which
:mod:`..ops.sparse` exchanges as an allgather of values and indices.  The
NCE weights and biases are gathered by index too, but their gradients
are dense, as in the reference.  The corpus and batch samplers are the
reference's numpy code, so a seed gives the same batches in both.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class Word2VecParams(NamedTuple):
    embeddings: torch.Tensor   # [vocab, dim]
    nce_weights: torch.Tensor  # [vocab, dim]
    nce_biases: torch.Tensor   # [vocab]


class Word2Vec(nn.Module):
    """The three parameter tensors; ``forward`` is :func:`nce_loss`."""

    def __init__(self, params: Word2VecParams, sparse: bool = True):
        super().__init__()
        self.embeddings = nn.Parameter(params.embeddings)
        self.nce_weights = nn.Parameter(params.nce_weights)
        self.nce_biases = nn.Parameter(params.nce_biases)
        self.sparse = sparse

    def params(self) -> Word2VecParams:
        return Word2VecParams(self.embeddings, self.nce_weights,
                              self.nce_biases)

    def forward(self, centers: torch.Tensor, targets: torch.Tensor,
                neg_samples: torch.Tensor) -> torch.Tensor:
        return nce_loss(self.params(), centers, targets, neg_samples,
                        sparse=self.sparse)


def init_params(vocab_size: int, dim: int = 128,
                generator: torch.Generator = None, device=None,
                sparse: bool = True) -> Word2Vec:
    """Uniform [-1, 1] embeddings, truncated-normal NCE weights over
    sqrt(dim), zero biases: the standard word2vec init
    (≙ examples/tensorflow_word2vec.py:137-148), drawn from ``generator``
    on the CPU and moved to ``device``."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    emb = nn.init.uniform_(torch.empty(vocab_size, dim), -1.0, 1.0,
                           generator=gen)
    nce_w = nn.init.trunc_normal_(torch.empty(vocab_size, dim), 0.0, 1.0,
                                  -2.0, 2.0, generator=gen) / math.sqrt(dim)
    params = Word2VecParams(emb, nce_w, torch.zeros(vocab_size))
    return Word2Vec(Word2VecParams(*(p.to(device) for p in params)),
                    sparse=sparse)


def nce_loss(params: Word2VecParams, centers: torch.Tensor,
             targets: torch.Tensor, neg_samples: torch.Tensor,
             sparse: bool = True) -> torch.Tensor:
    """Sampled NCE objective of one skip-gram batch.

    centers: [B] input word ids; targets: [B] context word ids (the
    positives); neg_samples: [K] one negative draw shared by the batch.
    """
    h = F.embedding(centers, params.embeddings, sparse=sparse)    # [B, D]
    pos_w = params.nce_weights[targets]                            # [B, D]
    pos_logit = (h * pos_w).sum(-1) + params.nce_biases[targets]   # [B]
    neg_w = params.nce_weights[neg_samples]                        # [K, D]
    neg_logit = h @ neg_w.T + params.nce_biases[neg_samples][None, :]
    pos_loss = F.softplus(-pos_logit)
    neg_loss = F.softplus(neg_logit).sum(-1)
    return (pos_loss + neg_loss).mean()


def skipgram_batch(rng: np.random.RandomState, corpus: np.ndarray,
                   batch_size: int, window: int = 2
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Sample (center, context) pairs from a token array (the
    reference's sampler, draw for draw)."""
    idx = rng.randint(window, len(corpus) - window, size=batch_size)
    offs = rng.randint(1, window + 1, size=batch_size)
    sign = rng.choice([-1, 1], size=batch_size)
    centers = corpus[idx]
    targets = corpus[idx + sign * offs]
    return centers.astype("int32"), targets.astype("int32")


def synthetic_corpus(vocab_size: int, length: int, seed: int = 0
                     ) -> np.ndarray:
    """Zipf-distributed token stream (word frequencies are Zipfian, which
    is what makes the sparse path worthwhile)."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab_size + 1, dtype="float64")
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    return rng.choice(vocab_size, size=length, p=probs).astype("int32")
