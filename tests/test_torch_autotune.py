"""The autotune sweep in horovod_tpu_torch (utils/autotune.py, folded into
tuning/controller.py's Tuner) against horovod_tpu's.

Under one fake clock both packages' ``Autotuner`` commit the same candidate
and write the same CSV bytes (``HOROVOD_AUTOTUNE_LOG``); the env contract
(``HOROVOD_AUTOTUNE_WARMUP_SAMPLES``, ``HOROVOD_AUTOTUNE_SAMPLE_SECONDS``)
reads alike.  The fold-in pins the sweep's two knobs away from the rule
table, and ``done`` waits for the commit marker to be applied.  Then
``HOROVOD_AUTOTUNE=1`` with ``HVD_TPU_TUNE=1`` through the hook-driven
optimizer at 2 layers on one CPU rank: every candidate goes out as a RETUNE
marker and is applied in order, the committed pair lands in the runtime,
and the losses and parameters are bitwise an untuned run's.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from horovod_tpu.tuning import controller as ref_controller
from horovod_tpu.utils import autotune as ref_autotune
from horovod_tpu_torch.tuning import actuation as port_act
from horovod_tpu_torch.tuning import controller as port_controller
from horovod_tpu_torch.utils import autotune as port_autotune

PKGS = {"reference": ref_autotune, "port": port_autotune}


def _sweep(mod, path, **kw):
    """A whole sweep under a fake clock: each tick records a seeded
    number of bytes and moves the clock on by an uneven step."""
    t = [0.0]
    applied = []
    tuner = mod.Autotuner(lambda th, cy: applied.append((th, cy)),
                          log_path=str(path), clock=lambda: t[0], **kw)
    i = 0
    while not tuner.done:
        tuner.record_bytes(((i * 7919) % 997 + 1) * 1000)
        t[0] += 0.25 + (i % 3) * 0.5
        tuner.maybe_step()
        i += 1
    tuner.close()
    return tuner.committed, applied, path.read_bytes()


@pytest.mark.parametrize("kw", [
    dict(warmup_samples=2, sample_seconds=1.0),
    dict(warmup_samples=0, sample_seconds=3.0),
    dict(warmup_samples=1, sample_seconds=0.5, thresholds=[1 << 20, 2 << 20],
         cycles=[0.001, 0.002, 0.004])], ids=["default", "no-warmup", "grid"])
def test_the_sweep_commits_and_logs_as_the_reference(tmp_path, kw):
    port = _sweep(port_autotune, tmp_path / "port.csv", **kw)
    ref = _sweep(ref_autotune, tmp_path / "ref.csv", **kw)
    assert port == ref
    committed, applied, csv = port
    rows = csv.decode().splitlines()
    n = len(kw.get("thresholds", port_autotune.DEFAULT_THRESHOLDS)) * len(
        kw.get("cycles", port_autotune.DEFAULT_CYCLES))
    assert rows[0] == "score_bytes_per_sec,fusion_threshold,cycle_time_s"
    assert len(rows) == n + 2
    assert rows[-1] == f"# committed,{committed[0]},{committed[1]}"
    assert applied[-1] == committed and len(applied) == n + 1


def test_the_env_contract_reads_as_the_reference(monkeypatch, tmp_path):
    monkeypatch.setenv("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "1")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_SAMPLE_SECONDS", "0.75")
    got = []
    for name, mod in PKGS.items():
        monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG",
                           str(tmp_path / f"{name}.csv"))
        t = mod.Autotuner(lambda th, cy: None, clock=lambda: 0.0)
        got.append((t._warmup, t._sample_s, t._configs))
        t.close()
        assert (tmp_path / f"{name}.csv").read_text().startswith(
            "score_bytes_per_sec,")
    assert got[0] == got[1]
    assert got[0][:2] == (1, 0.75) and len(got[0][2]) == 15


def _fake_state():
    return SimpleNamespace(rank=0, process_index=0, size=1,
                           multiprocess=False, transport=None, runtime=None,
                           coordinator=None, response_cache=None, tuner=None,
                           fusion_threshold_bytes=64 << 20,
                           tick_seconds=0.005)


@pytest.mark.parametrize("mod", [port_controller, ref_controller],
                         ids=["port", "reference"])
def test_the_fold_in_pins_the_sweep_knobs(monkeypatch, mod):
    monkeypatch.delenv("HOROVOD_AUTOTUNE_LOG", raising=False)
    monkeypatch.setenv("HVD_TPU_TUNE_PIN", "dcn_compress")
    tuner = mod.Tuner(_fake_state(), sweep=True, closed_loop=True)
    assert tuner.policy.cfg.pinned == frozenset(
        {"dcn_compress", "fusion_threshold", "cycle_time"})
    tuner.close()
    tuner = mod.Tuner(_fake_state(), closed_loop=True)
    assert tuner.policy.cfg.pinned == frozenset({"dcn_compress"})


def test_done_waits_for_the_commit_to_be_applied(monkeypatch):
    monkeypatch.delenv("HOROVOD_AUTOTUNE_LOG", raising=False)
    monkeypatch.setenv("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "0")
    monkeypatch.setenv("HOROVOD_AUTOTUNE_SAMPLE_SECONDS", "0")
    st = _fake_state()
    tuner = port_controller.Tuner(st, sweep=True)
    st.tuner = tuner
    while tuner.committed is None:
        tuner.record_bytes(1)
        tuner.maybe_step()
    assert not tuner.done  # enqueued, not applied
    markers = tuner.take_markers()
    assert len(markers) == 16  # 15 candidates and the commit
    for m in markers[:-1]:
        port_act.apply_marker(m, st)
        assert not tuner.done
    port_act.apply_marker(markers[-1], st)
    assert tuner.done
    assert (st.fusion_threshold_bytes, st.tick_seconds) == tuner.committed


# ---------------------------------------------------------------------------
# The hook path on one CPU rank, tuned against untuned
# ---------------------------------------------------------------------------

APPLY_RE = re.compile(r"\[hvd-tune\] rank 0 applied seq=(\d+) "
                      r"fusion_threshold=(\d+) cycle_time=([0-9.e-]+)$")


def _train(monkeypatch, tmp_path, tuned, steps=None):
    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.frontends.torch as fhvd
    from horovod_tpu_torch.core import state as _state
    from horovod_tpu_torch.models import transformer as tt
    from horovod_tpu_torch.utils.tree import (tree_leaves, tree_map,
                                              tree_named_leaves)

    for k in ("HOROVOD_AUTOTUNE", "HVD_TPU_TUNE", "HOROVOD_AUTOTUNE_LOG"):
        monkeypatch.delenv(k, raising=False)
    if tuned:
        monkeypatch.setenv("HOROVOD_AUTOTUNE", "1")
        monkeypatch.setenv("HVD_TPU_TUNE", "1")
        monkeypatch.setenv("HVD_TPU_TUNE_WINDOW", "4")
        monkeypatch.setenv("HOROVOD_AUTOTUNE_LOG", str(tmp_path / "at.csv"))
        monkeypatch.setenv("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "1")
        monkeypatch.setenv("HOROVOD_AUTOTUNE_SAMPLE_SECONDS", "0.02")
    cfg = tt.TransformerConfig(vocab_size=128, d_model=64, n_heads=4,
                               n_layers=2, d_ff=128, max_seq_len=64)
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, 128, size=(4, 33)))
    batch = (toks[:, :-1], toks[:, 1:])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # bitwise CPU backward (embedding gather)
    hvd.init(device="cpu")
    try:
        st = _state._state
        params = tree_map(lambda t: t.detach().clone().requires_grad_(),
                          tt.init_transformer(torch.Generator().manual_seed(0),
                                              cfg))
        adamw = torch.optim.AdamW(tree_leaves(params), lr=1e-3,
                                  weight_decay=1e-4)
        opt = fhvd.DistributedOptimizer(
            adamw, named_parameters=tree_named_leaves(params))
        step = hvd.make_train_step(tt.make_loss_fn(cfg), opt)
        losses = []
        while (len(losses) < steps if steps is not None
               else not st.autotuner.done and len(losses) < 2000):
            losses.append(float(step(params, batch)))
        got = {"losses": losses,
               "params": [t.detach().clone() for t in tree_leaves(params)]}
        if tuned:
            tuner = st.autotuner
            got.update(
                done=tuner.done, committed=tuner.committed,
                decided=[d.knob for d in tuner.policy.decisions],
                runtime=(st.fusion_threshold_bytes, st.tick_seconds,
                         [c.fusion_threshold
                          for c in st.runtime._coordinators()]))
        return got
    finally:
        hvd.shutdown()
        torch.set_num_threads(threads)


def test_autotune_through_the_hook_path_commits_bitwise_untuned(
        monkeypatch, tmp_path, capfd):
    tuned = _train(monkeypatch, tmp_path, True)
    err = capfd.readouterr().err
    assert tuned["done"]
    th, cy = tuned["committed"]
    assert tuned["runtime"] == (th, cy, [th])
    # Every candidate went out as a marker and was applied in order,
    # then the commit.
    applied = [(int(m[1]), int(m[2]), float(m[3])) for m in map(
        APPLY_RE.match, err.splitlines()) if m]
    grid = [(t, c) for t in port_autotune.DEFAULT_THRESHOLDS
            for c in port_autotune.DEFAULT_CYCLES]
    assert [(t, c) for _, t, c in applied] == grid + [(th, cy)]
    assert [s for s, _, _ in applied] == list(range(16))
    rows = (tmp_path / "at.csv").read_text().splitlines()
    assert len(rows) == 17 and rows[-1] == f"# committed,{th},{cy}"
    # The rule table never touched the sweep's knobs.
    assert not {"fusion_threshold", "cycle_time"} & set(tuned["decided"])
    plain = _train(monkeypatch, tmp_path, False, steps=len(tuned["losses"]))
    assert plain["losses"] == tuned["losses"]
    for a, b in zip(plain["params"], tuned["params"]):
        assert torch.equal(a, b)
