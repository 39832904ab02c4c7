"""Validation harness (port of horovod_tpu/serving/harness.py): the
speculative agreement pair and dispatch count, and bench.py's seeded
serving trace with its continuous and static replays, shared by the
tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..utils.tree import tree_map


def zeroed_layer_params(params: dict) -> dict:
    """Zero every layer's residual contribution (the attention output and
    FFN output projections): the logits reduce to ``ln_f(embed + pos) @
    unembed``, whatever the depth or width (the construction behind
    :func:`agreement_pair`).  New tensors; ``params`` is not written."""
    layers = dict(params["layers"])
    for k in ("wo", "w_out", "b_out"):
        layers[k] = torch.zeros_like(layers[k])
    out = dict(params)
    out["layers"] = layers
    return out


def agreement_pair(target_cfg, draft_cfg, seed: int = 0, device=None):
    """A ``(target_params, draft_params)`` pair whose greedy argmax agrees
    at every position: both models' layer contributions are zeroed and
    the draft shares the target's embed/pos/ln_f/unembed, so their
    logits are bitwise equal while the draft pays only its own layer
    stack.  Acceptance under the bitwise-greedy rule is therefore 1.0.
    Weights from ``torch.Generator`` seeds ``seed`` and ``seed + 1``
    (the reference draws from ``jax.random.PRNGKey``: the same
    construction, other numbers).  Requires matching ``vocab_size`` and
    ``d_model``."""
    from ..models.transformer import init_transformer

    if (draft_cfg.vocab_size != target_cfg.vocab_size
            or draft_cfg.d_model != target_cfg.d_model):
        raise ValueError(
            "agreement_pair needs matching vocab_size and d_model "
            "(the embed/unembed halves are shared)")

    def init(cfg, s):
        return tree_map(lambda x: x.detach(), init_transformer(
            torch.Generator().manual_seed(s), cfg, device=device))

    target = zeroed_layer_params(init(target_cfg, seed))
    draft = zeroed_layer_params(init(draft_cfg, seed + 1))
    for k in ("embed", "pos_embed", "ln_f", "unembed"):
        draft[k] = target[k]
    return target, draft


def count_spec_dispatches(engine) -> Tuple[int, int, Dict[str, int]]:
    """Run ONE steady-state speculative iteration on ``engine`` (which
    must have active slots, e.g. after a ``step()`` that admitted) and
    return ``(propose_calls, verify_calls, launches)``: the programs
    called, and the serving kernels' launches during the iteration
    (:data:`..ops.serving.launches`; zero on the CPU, where the plain
    versions run).  The contract is one propose and ONE verify; the
    launches are what those two programs need: the draft's
    ``spec_tokens`` forward steps and the target's one."""
    from ..ops import serving as _serving

    calls = {"verify": 0, "propose": 0}
    vkey = ("verify", engine.spec_tokens + 1)
    pkey = ("draft_propose", engine.spec_tokens)
    v_exec, p_exec = engine._exec[vkey], engine._exec[pkey]

    def verify(*a):
        calls["verify"] += 1
        return v_exec(*a)

    def propose(*a):
        calls["propose"] += 1
        return p_exec(*a)

    engine._exec[vkey], engine._exec[pkey] = verify, propose
    before = dict(_serving.launches)
    try:
        engine.step()
    finally:
        engine._exec[vkey], engine._exec[pkey] = v_exec, p_exec
    launches = {k: _serving.launches[k] - before[k] for k in before}
    return calls["propose"], calls["verify"], launches


def serving_trace(n_requests: int = 40, vocab_size: int = 256,
                  seed: int = 7) -> List[dict]:
    """bench.py's seeded ragged-arrival serving trace (``_serving_bench``,
    bench.py:1826-1845): prompts of 4-16 tokens, a quarter of the
    requests generating 48-64 tokens and the rest 4-12 (the heavy tail
    static batching handles worst), arrivals advancing 0 or 1 iteration
    a request."""
    rng = np.random.default_rng(seed)
    trace = []
    arrival = 0
    for _ in range(n_requests):
        arrival += int(rng.integers(0, 2))
        if rng.random() < 0.25:
            max_new = int(rng.integers(48, 65))
        else:
            max_new = int(rng.integers(4, 13))
        trace.append({
            "prompt": [int(t) for t in
                       rng.integers(0, vocab_size,
                                    size=int(rng.integers(4, 17)))],
            "max_new": max_new,
            "arrival": arrival,
        })
    return trace


def run_trace(engine, trace: List[dict], continuous: bool) -> dict:
    """Replay ``trace`` through ``engine`` on its logical arrival clock:
    continuous batching admits into any free slot every iteration,
    static batching only when every slot is empty (bench.py's two legs).
    Returns the requests' tokens, the iteration count and the host
    seconds (the device is synchronized at the end; each iteration
    already waits for its logits)."""
    reqs = [engine.submit(t["prompt"], max_new_tokens=t["max_new"],
                          arrival=t["arrival"]) for t in trace]
    it = 0
    t0 = time.perf_counter()
    while not engine.scheduler.idle():
        engine.step(now=it, admit=continuous
                    or engine.scheduler.occupancy() == 0)
        it += 1
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    seconds = time.perf_counter() - t0
    return {"tokens": [list(r.generated) for r in reqs], "iterations": it,
            "seconds": seconds, "requests": reqs}
