"""Shared inputs of the port's serving tests: tests/test_serving.py's small
config, the reference's seed-0 weights and the same weights in the port
(through utils/convert.py), and greedy rollouts through each package's
non-incremental ``serving_forward``."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from horovod_tpu.models import transformer as RT
from horovod_tpu_torch.models import transformer as TT
from horovod_tpu_torch.serving import InferenceEngine
from horovod_tpu_torch.utils.convert import params_from_jax

SMALL = dict(vocab_size=97, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             max_seq_len=64)
CFG_R = RT.TransformerConfig(**SMALL)
CFG = TT.TransformerConfig(**SMALL)
PARAMS_R = RT.init_transformer(jax.random.PRNGKey(0), CFG_R)
PARAMS = params_from_jax(jax.tree_util.tree_map(np.asarray, PARAMS_R),
                         requires_grad=False)

# tests/test_speculative.py's random draft (acceptance ~0), in the port.
DRAFT_SMALL = dict(vocab_size=97, d_model=32, n_heads=2, n_layers=1,
                   d_ff=64, max_seq_len=64)
DRAFT_CFG_R = RT.TransformerConfig(**DRAFT_SMALL)
DRAFT_CFG = TT.TransformerConfig(**DRAFT_SMALL)
DRAFT_R = RT.init_transformer(jax.random.PRNGKey(9), DRAFT_CFG_R)
DRAFT = params_from_jax(jax.tree_util.tree_map(np.asarray, DRAFT_R),
                        requires_grad=False)

# Greedy tokens of the two packages are held equal where the reference's
# top-2 logit margin exceeds this (f32 logits agree within ~1e-5).
MARGIN = 1e-4


def make_engine(params=PARAMS, cfg=CFG, **kw):
    kw.setdefault("max_slots", 3)
    kw.setdefault("page_size", 8)
    kw.setdefault("capacity", 32)
    kw.setdefault("device", "cpu")
    return InferenceEngine(params, cfg, **kw)


def rollout(prompt, n, capacity, params=PARAMS, cfg=CFG):
    """Greedy rollout through the port's non-incremental forward."""
    seq, out = list(prompt), []
    with torch.no_grad():
        for _ in range(n):
            logits = TT.serving_forward(params, torch.tensor([seq]), cfg,
                                        capacity)
            tok = int(np.argmax(logits[0, -1].numpy()))
            out.append(tok)
            seq.append(tok)
    return out


_SF_R = jax.jit(RT.serving_forward, static_argnums=(2, 3))


def reference_logits(tokens, capacity, params=PARAMS_R, cfg=CFG_R):
    return np.asarray(_SF_R(params, jnp.asarray(tokens, jnp.int32), cfg,
                            capacity))


def reference_rollout(prompt, n, capacity, params=PARAMS_R, cfg=CFG_R):
    """Greedy rollout through the reference's non-incremental forward."""
    seq, out = list(prompt), []
    for _ in range(n):
        tok = int(np.argmax(reference_logits([seq], capacity, params,
                                             cfg)[0, -1]))
        out.append(tok)
        seq.append(tok)
    return out


def assert_greedy_agrees(prompt, port_tokens, capacity):
    """The port's greedy tokens against the reference's logits on the
    same sequence: equal at every position where the reference's top-2
    margin exceeds :data:`MARGIN`, and at least one such position.
    Returns the number of positions held."""
    seq = list(prompt) + list(port_tokens)
    logits = reference_logits([seq], capacity)[0]
    held = 0
    for i, tok in enumerate(port_tokens):
        row = logits[len(prompt) - 1 + i]
        top2 = np.sort(row)[-2:]
        if top2[1] - top2[0] > MARGIN:
            assert tok == int(np.argmax(row)), (i, tok, int(np.argmax(row)))
            held += 1
    assert held > 0, "no position with a clear top-2 margin"
    return held
