"""horovod_tpu_torch/examples/distill_draft.py against examples/
distill_draft.py, and the serving examples end to end on the CPU.

``draft_config`` halves a config as the reference's does (GPT-2-small's
draft: d_model 384, 6 heads, 6 layers, d_ff 1536, vocab 32768), the
softened-KL loss equals the reference's formula on the same logits, and
a tiny run chains ``transformer_lm --export`` -> ``distill_draft
--export`` -> ``serve_lm --draft``, whose speculative tokens must equal
plain decode's, and ``serve_lm --tp 2`` under ``torchrun`` (a 2-rank
model axis, rank 1 following) gives the same tokens as one rank.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models.transformer import TransformerConfig as RefConfig
from horovod_tpu_torch.examples import distill_draft as D
from horovod_tpu_torch.examples.transformer_lm import bench_config
from horovod_tpu_torch.models.transformer import TransformerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ref_distill_draft", os.path.join(REPO, "examples",
                                          "distill_draft.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [
    dict(vocab_size=32768, d_model=768, n_heads=12, n_layers=12, d_ff=3072,
         max_seq_len=1024),
    dict(vocab_size=512, d_model=64, n_heads=4, n_layers=2, d_ff=128,
         max_seq_len=128),
    dict(vocab_size=97, d_model=48, n_heads=1, n_layers=1, d_ff=96,
         max_seq_len=64),
])
def test_draft_config_halves_as_the_reference(shape):
    ref = _reference_module().draft_config(RefConfig(**shape))
    got = D.draft_config(TransformerConfig(**shape))
    for k in ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff",
              "max_seq_len"):
        assert getattr(got, k) == getattr(ref, k), k


def test_gpt2_small_draft_is_half_size_and_keeps_bf16():
    d = D.draft_config(bench_config())
    assert (d.d_model, d.n_heads, d.n_layers, d.d_ff, d.vocab_size) == \
        (384, 6, 6, 1536, 32768)
    assert d.d_model // d.n_heads == 64 and d.dtype == torch.bfloat16


def test_distill_loss_equals_the_reference_formula(monkeypatch):
    cfg = D.draft_config(TransformerConfig(vocab_size=97, d_model=64,
                                           n_heads=4, n_layers=2, d_ff=128,
                                           max_seq_len=64))
    rng = np.random.default_rng(0)
    slog = rng.standard_normal((2, 5, 97)).astype(np.float32) * 3
    tlog = rng.standard_normal((2, 5, 97)).astype(np.float32) * 3
    monkeypatch.setattr(D, "forward", lambda p, toks, c: torch.from_numpy(
        slog))
    got = float(D.distill_loss(cfg, 2.0)(None, (None, torch.from_numpy(
        tlog))))
    t = 2.0
    soft_t = jax.nn.softmax(tlog / t, axis=-1)
    kl = jnp.sum(soft_t * (jax.nn.log_softmax(tlog / t, axis=-1)
                           - jax.nn.log_softmax(slog / t, axis=-1)), axis=-1)
    assert got == pytest.approx(float(jnp.mean(kl) * t * t), rel=1e-5)


def _run(args, env=None, timeout=300):
    proc = subprocess.run([sys.executable, "-m"] + args, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env={**os.environ, **(env or {})})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _tokens(out):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")][-1]["tokens"]


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distill")
    lm, draft = str(tmp / "lm"), str(tmp / "draft")
    _run(["horovod_tpu_torch.examples.transformer_lm", "--device", "cpu",
          "--steps", "10", "--export", lm])
    out = _run(["horovod_tpu_torch.examples.distill_draft", lm, "--device",
                "cpu", "--steps", "12", "--batch", "4", "--seq", "32",
                "--export", draft])
    return lm, draft, out


def test_distill_loss_falls_and_exports(exports):
    _, draft, out = exports
    assert "distill_draft: OK" in out and "greedy agreement" in out
    meta = json.load(open(os.path.join(draft, "serving.json")))
    assert meta["model"]["d_model"] == 32 and meta["model"]["n_layers"] == 1
    assert meta["extra"]["distill_steps"] == 12


def test_serve_lm_draft_loads_the_export_and_decodes_as_plain(exports):
    lm, draft, _ = exports
    args = ["horovod_tpu_torch.examples.serve_lm", lm, "--device", "cpu",
            "--tokens", "5,3,8,1", "-n", "12"]
    plain = _tokens(_run(args))
    spec = _tokens(_run(args + ["--draft", draft, "--spec-tokens", "3"]))
    assert spec == plain and len(plain) == 12


def test_serve_lm_tp2_under_torchrun_equals_one_rank(exports):
    lm, draft, _ = exports
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    args = ["--tokens", "5,3,8,1", "-n", "10", "--device", "cpu"]
    one = _tokens(_run(["horovod_tpu_torch.examples.serve_lm", lm] + args))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "HVD_TPU_METRICS_PORT")}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port", str(port),
         "-m", "horovod_tpu_torch.examples.serve_lm", lm, "--tp", "2",
         "--draft", draft] + args, cwd=REPO, capture_output=True, text=True,
        timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert _tokens(proc.stdout) == one
