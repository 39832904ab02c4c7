"""horovod_tpu_torch's memory package (memory/) against horovod_tpu's.

* The pure cases of tests/test_memory.py (the ledger, ``MemoryWatch``,
  the planner, the OOM guard, the flight tail) run on both packages
  (parametrized): that file's module globals (``M``, ``ledger_mod``,
  ``oom_mod``, ``planner``, ``_telemetry``) point at the port's modules
  for the port's run.  ``EXCLUDED`` lists the rest with their reasons;
  each has a port case below.
* Every ``plan_*`` on a seeded grid of arguments, and the ``--plan``
  CLI, give byte-identical JSON (and the same errors) on both packages.
* ``_transformer_param_bytes`` equals the bytes of the port's own
  GPT-2-small tree (shapes only: its draws are made on the meta device).
* Ledger sequences, ``MemoryWatch`` and the simulated OOM's message and
  dump tail equal the reference's; the allocation sites of the port
  (KV pages, serving weights, prefetch, checkpoint snapshots, EF
  residuals, pipeline carries, the step window) feed the ledger.
* On the CPU ``device_memory_stats`` is None, as the reference's CPU
  backend answers, and the live sweep counts each storage once.
"""

import glob
import inspect
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import horovod_tpu.memory as ref_M
from horovod_tpu.memory import ledger as ref_ledger
from horovod_tpu.memory import oom as ref_oom
from horovod_tpu.memory import planner as ref_planner

import horovod_tpu_torch as thvd
import horovod_tpu_torch.memory as port_M
import horovod_tpu_torch.telemetry as port_telemetry
from horovod_tpu_torch.memory import ledger as port_ledger
from horovod_tpu_torch.memory import oom as port_oom
from horovod_tpu_torch.memory import planner as port_planner
from horovod_tpu_torch.telemetry import flight as port_flight

import test_memory as R
from gloo_job import REPO

EXCLUDED = {
    "test_plan_cli_is_deterministic_and_parseable":
        "imports the reference's CLI; test_plan_cli_output_equals_the_"
        "references holds both",
    "test_plan_cli_fit_verdict_rc": "imports the reference's CLI; "
        "test_plan_cli_fit_verdict_rc_port",
    "test_preflight_warn_fires_only_over_capacity":
        "its text names the reference's CLI; test_preflight_warn_port",
    "test_live_array_report_shape": "sweeps jax arrays; "
        "test_live_sweep_counts_each_storage_once",
    "test_kv_cache_feeds_ledger_and_free_pages_gauge":
        "the reference's PagedKVCache; test_kv_cache_feeds_ledger_port",
    "test_engine_health_includes_kv_free_pages":
        "the reference's engine; test_engine_charges_its_weights",
    "test_prefetch_accounts_staged_batches": "JAX runtime (hvd); "
        "test_prefetch_charges_are_released",
    "test_prefetch_mid_epoch_close_never_leaks_charges": "JAX runtime "
        "(hvd); test_prefetch_charges_are_released",
    "test_checkpoint_snapshot_accounting": "JAX runtime (hvd); "
        "test_checkpoint_snapshot_accounting_port",
    "test_dataplane_plan_matches_ledger_watermark": "JAX runtime (hvd); "
        "test_megakernel_launch_charges_the_plans_fusion_bytes",
    "test_pipeline_plan_matches_ledger_activations": "JAX runtime (hvd); "
        "test_pipeline_carries_ride_the_ledger",
    "test_residual_store_rides_ledger": "JAX runtime (hvd); "
        "test_residual_store_rides_ledger_port",
    "test_step_watermark_gauge_advances": "JAX runtime (hvd); "
        "test_step_window_closes_per_train_step",
}

CASES = sorted(name for name, fn in inspect.getmembers(R, inspect.isfunction)
               if name.startswith("test_") and name not in EXCLUDED)

PACKAGES = {"reference": (ref_M, ref_ledger, ref_oom, ref_planner),
            "port": (port_M, port_ledger, port_oom, port_planner)}


def test_every_reference_case_is_run_or_excluded_with_a_reason():
    names = {n for n, _ in inspect.getmembers(R, inspect.isfunction)
             if n.startswith("test_")}
    assert set(EXCLUDED) <= names
    assert set(CASES) | set(EXCLUDED) == names
    assert len(CASES) >= 25


def _reset_port_dump_rate_limit():
    with port_flight.recorder._dump_lock:
        port_flight.recorder._last_dump.clear()


@pytest.mark.parametrize("which", ["reference", "port"])
@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, which, monkeypatch, tmp_path, capsys):
    M, ledger_mod, oom_mod, planner = PACKAGES[which]
    if which == "port":
        for attr, mod in (("M", port_M), ("ledger_mod", port_ledger),
                          ("oom_mod", port_oom), ("planner", port_planner),
                          ("_telemetry", port_telemetry),
                          ("_reset_dump_rate_limit",
                           _reset_port_dump_rate_limit)):
            monkeypatch.setattr(R, attr, mod)
    ledger_mod.ledger.set("input.prefetch", 0)
    fn = getattr(R, case)
    avail = {"monkeypatch": monkeypatch, "tmp_path": tmp_path,
             "capsys": capsys, "fresh_ledger": ledger_mod.MemoryLedger()}
    fn(**{p: avail[p] for p in inspect.signature(fn).parameters})


# ---------------------------------------------------------------------------
# The planner: byte-identical JSON on a seeded grid
# ---------------------------------------------------------------------------

def _plan_args(seed):
    rng = np.random.RandomState(seed)
    pick = lambda xs: xs[rng.randint(len(xs))]  # noqa: E731
    cap = pick([None, 1, 1 << 20, 1 << 30, 80 << 30])
    kind = pick(["transformer_lm", "pipeline", "serving", "dataplane"])
    if kind == "transformer_lm":
        return kind, dict(
            vocab_size=pick([256, 32768, 50257]),
            d_model=pick([64, 128, 768]), n_heads=pick([4, 8, 12]),
            n_layers=int(rng.randint(1, 13)), d_ff=pick([256, 3072]),
            max_seq_len=pick([64, 1024]), batch_size=int(rng.randint(1, 65)),
            world=pick([1, 2, 4, 8]),
            optimizer=pick(["adam", "adamw", "sgd", "momentum", "none"]),
            prefetch_depth=int(rng.randint(1, 4)),
            dtype=pick(["float32", "bfloat16"]), capacity=cap)
    if kind == "pipeline":
        S = pick([2, 3, 4, 8, 14])
        return kind, dict(
            n_stages=S, num_microbatches=pick([1, 2, 4, 8, 16]),
            microbatch_rows=pick([1, 8, 32]), width=pick([16, 96, 768]),
            world=pick([1, 4]), schedule=pick([None, "1f1b", "gpipe"]),
            interleave=pick([None, 1, 2]), dtype=pick(["float32",
                                                       "bfloat16"]),
            stage_param_bytes=pick([None, 4096]), capacity=cap)
    if kind == "serving":
        return kind, dict(
            n_layers=pick([1, 2, 12]), n_heads=pick([4, 8, 12]),
            head_dim=pick([16, 64]), max_slots=pick([1, 8, 32]),
            pages_per_slot=pick([4, 8, 64]), page_size=pick([8, 16]),
            world=pick([1, 2]), dtype=pick(["float32", "bfloat16"]),
            param_bytes=pick([0, 12345]), prefix_pages=pick([0, 3, 16]),
            draft_layers=pick([0, 1, 6]), draft_d_ff=pick([None, 128]),
            vocab_size=pick([256, 32768]), capacity=cap)
    return kind, dict(
        tensors=int(rng.randint(1, 64)), elems=pick([1, 256, 65536]),
        world=pick([1, 2, 8]), dtype=pick(["float32", "bfloat16", "int8"]),
        fusion_threshold=pick([None, 1024, 64 << 20]), capacity=cap)


def _plan_json(planner, kind, kwargs):
    try:
        return planner.build_plan(kind, **kwargs).to_json()
    except ValueError as e:
        return f"ValueError: {e}"


@pytest.mark.parametrize("chunk", range(4))
def test_plans_are_byte_identical_on_a_seeded_grid(chunk):
    kinds = set()
    for seed in range(chunk * 40, chunk * 40 + 40):
        kind, kwargs = _plan_args(seed)
        kinds.add(kind)
        want = _plan_json(ref_planner, kind, kwargs)
        assert _plan_json(port_planner, kind, kwargs) == want, (seed, kind)
    assert len(kinds) >= 3


@pytest.mark.parametrize("shape", [(256, 128, 8, 2, 256, 64),
                                   (32768, 768, 12, 12, 3072, 1024),
                                   (50257, 64, 4, 3, 128, 32)])
def test_shared_byte_models_equal_the_references(shape):
    for dt in ("float32", "bfloat16"):
        assert port_planner._transformer_param_bytes(*shape, dtype=dt) == \
            ref_planner._transformer_param_bytes(*shape, dtype=dt)
    shapes = ((16,), (4, 4), ())
    for variant in ("sp_pr", "sp_rep", "mp"):
        assert port_planner.fusion_group_bytes(shapes, "float32", 4,
                                               variant) == \
            ref_planner.fusion_group_bytes(shapes, "float32", 4, variant)
    assert port_planner.fused_group_bytes((30, 8), 4) == \
        ref_planner.fused_group_bytes((30, 8), 4)
    for knob in ("fusion_threshold", "max_inflight", "spec_tokens",
                 "prefix_pages", "cycle_time"):
        knobs = {"spec_token_bytes": 7, "prefix_page_bytes": 11}
        assert port_planner.retune_delta_bytes(knob, 2, 5, knobs) == \
            ref_planner.retune_delta_bytes(knob, 2, 5, knobs)
    assert port_planner.manifest_section() == \
        ref_planner.manifest_section(None)
    assert port_planner.dtype_bytes(torch.bfloat16) == 2


ARGV = [["--plan"],
        ["--plan", "--model", "serving", "--kv-slots", "8", "--kv-pages",
         "64", "--layers", "12", "--heads", "12", "--head-dim", "64",
         "--dtype", "bfloat16", "--prefix-pages", "16"],
        ["--plan", "--model", "serving", "--draft-layers", "6",
         "--vocab-size", "32768"],
        ["--plan", "--model", "pipeline", "--stages", "4",
         "--microbatches", "8", "--schedule", "gpipe"],
        ["--plan", "--model", "dataplane", "--capacity-bytes", "1000"],
        ["--plan", "--model", "transformer_lm", "--vocab-size", "32768",
         "--d-model", "768", "--heads", "12", "--layers", "12", "--d-ff",
         "3072", "--seq-len", "1024", "--batch-size", "8"],
        ["--plan", "--model", "pipeline", "--stages", "3",
         "--interleave", "2"],
        []]


@pytest.mark.parametrize("argv", range(len(ARGV)))
def test_plan_cli_output_equals_the_references(argv, capsys):
    from horovod_tpu.memory.__main__ import main as ref_main
    from horovod_tpu_torch.memory.__main__ import main as port_main

    out = []
    for main in (ref_main, port_main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = main(list(ARGV[argv]))
        err = capsys.readouterr().err
        out.append((rc, buf.getvalue() if ARGV[argv] else "",
                    err.replace("horovod_tpu_torch", "horovod_tpu")))
    assert out[1] == out[0]


def test_plan_cli_as_a_module_prints_the_references_bytes():
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    argv = ARGV[1]
    runs = [subprocess.run([sys.executable, "-m", mod] + argv, cwd=REPO,
                           env=env, capture_output=True, text=True,
                           timeout=120)
            for mod in ("horovod_tpu.memory", "horovod_tpu_torch.memory")]
    assert runs[0].returncode == runs[1].returncode == 0, runs[1].stderr
    assert runs[1].stdout == runs[0].stdout
    plan = json.loads(runs[1].stdout)
    # The served configuration of chip_smoke.py's observe phase: 8 slots
    # of 64 pages of 16, 12 layers x 12 heads x 64, bf16: 513 pages.
    assert plan["framework"]["serving.kv_pages"] == 302_579_712
    assert plan["framework"]["serving.prefix_pages"] == \
        port_planner.prefix_pages_bytes(12, 12, 64, 16, 16, "bfloat16")


def test_plan_cli_fit_verdict_rc_port(capsys):
    from horovod_tpu_torch.memory.__main__ import main

    assert main(["--plan", "--model", "transformer_lm",
                 "--capacity-bytes", "1"]) == 3
    plan = json.loads(capsys.readouterr().out)
    assert plan["fits"] is False and plan["headroom_bytes"] < 0
    assert main(["--plan", "--capacity-bytes", str(64 << 30)]) == 0
    assert json.loads(capsys.readouterr().out)["fits"] is True
    assert main([]) == 2  # no --plan: the help


def test_transformer_param_bytes_equal_the_ports_gpt2_small_tree(
        monkeypatch):
    """Shapes only: the draws are made on the meta device, so the
    136,137,216-parameter tree costs no memory here."""
    from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                      init_transformer)

    def meta_randn(shape, generator=None, dtype=None):
        return torch.empty(shape, dtype=dtype, device="meta")

    monkeypatch.setattr(torch, "randn", meta_randn)
    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
        cfg = TransformerConfig(vocab_size=32768, d_model=768, n_heads=12,
                                n_layers=12, d_ff=3072, max_seq_len=1024,
                                dtype=dtype)
        tree = init_transformer(torch.Generator(), cfg)
        nbytes = port_ledger.tree_nbytes(tree)
        assert nbytes == port_planner._transformer_param_bytes(
            32768, 768, 12, 12, 3072, 1024, name)
    assert nbytes // 2 == 136_137_216


# ---------------------------------------------------------------------------
# Ledger, watch and OOM parity on seeded sequences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_ledger_sequences_equal_the_references(seed):
    rng = np.random.RandomState(seed)
    cats = ["megakernel.fusion", "serving.kv_pages", "input.prefetch",
            "pipeline.activations", "x"]
    ops = []
    for _ in range(300):
        c = cats[rng.randint(len(cats))]
        k = rng.randint(6)
        n = int(rng.randint(-5, 5000))
        key = None if rng.rand() < 0.6 else int(rng.randint(3))
        ops.append((k, c, n, key))
    got = []
    for _, ledger_mod, _, _ in PACKAGES.values():
        led = ledger_mod.MemoryLedger()
        trail = []
        for k, c, n, key in ops:
            if k == 0:
                led.alloc(c, n, key=key)
            elif k == 1:
                led.free(c, n if key is None else None, key=key)
            elif k == 2:
                led.set(c, n)
            elif k == 3:
                trail.append(led.note_step())
            elif k == 4:
                trail.append(led.top(3))
            else:
                trail.append(led.snapshot())
        got.append((trail, led.bytes_by_category(), led.peak_by_category(),
                    led.watermark(), led.step_watermark(), led.steps(),
                    led.total()))
    assert got[1] == got[0]


@pytest.mark.parametrize("seed", range(3))
def test_memory_watch_equals_the_references(seed, capsys):
    rng = np.random.RandomState(seed)
    sizes = []
    cur = {"a": 100, "b": 100, "c": 100}
    for _ in range(60):
        for c in list(cur):
            cur[c] += int(rng.randint(-20, 200))
        if rng.rand() < 0.1:
            cur.pop("c", None)
        sizes.append(dict(cur))
    got = []
    for M, _, _, _ in PACKAGES.values():
        w = M.MemoryWatch(patience=3, min_growth=100)
        got.append(([w.check(s) for s in sizes], w.warnings))
    err = capsys.readouterr().err
    assert got[1] == got[0]
    assert err.count("horovod_tpu_torch.memory --plan") == \
        sum(len(f or []) for f in got[1][0])


def test_simulated_oom_message_and_dump_tail_equal_the_references(
        tmp_path, monkeypatch):
    dumps = {}
    for which, (M, ledger_mod, oom_mod, _) in PACKAGES.items():
        R._reset_dump_rate_limit()
        _reset_port_dump_rate_limit()
        d = tmp_path / which
        d.mkdir()
        monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(d))
        monkeypatch.setenv(oom_mod.CAPACITY_ENV, str(1 << 20))
        led = ledger_mod.ledger
        led.reset()
        led.alloc("serving.kv_pages", 600_000)
        led.alloc("megakernel.residuals", 300_000)
        led.alloc("input.prefetch", 200_000)
        try:
            with pytest.raises(oom_mod.ResourceExhaustedError) as ei:
                with oom_mod.guard("serving/decode", predicted_bytes=10):
                    pass
            files = glob.glob(str(d / "*oom*"))
            payload = json.load(open(files[0]))
        finally:
            led.reset()
        extra = payload["extra"]
        dumps[which] = (str(ei.value), extra["executable"],
                        extra["top_categories"], extra["predicted_bytes"],
                        extra["ledger_total_bytes"],
                        extra["advertised_capacity_bytes"],
                        extra["device_memory_stats"],
                        {k: v for k, v in payload["metrics"].items()
                         if k.startswith("memory.bytes.")})
    assert dumps["port"] == dumps["reference"]


# ---------------------------------------------------------------------------
# The port's own answers on the CPU
# ---------------------------------------------------------------------------

def test_cpu_device_stats_are_none_and_capacity_unknown(monkeypatch):
    monkeypatch.delenv(port_oom.CAPACITY_ENV, raising=False)
    assert port_ledger.device_memory_stats("cpu") is None
    assert port_ledger.device_memory_stats() is None  # no card here
    assert ref_ledger.device_memory_stats() is None  # XLA:CPU alike
    assert port_oom.advertised_capacity() is None


def test_live_sweep_counts_each_storage_once():
    base = torch.zeros(1000)
    view = base[10:]  # noqa: F841  (shares base's storage)
    p = torch.nn.Parameter(torch.ones(64))
    p.grad = torch.zeros(64)
    rep = port_ledger.live_array_report(top_n=50, device="cpu")
    assert rep["live_bytes"] >= 4000 + 256 + 256
    tops = {(t["shape"], t["dtype"]) for t in rep["top"]}
    assert ("(1000,)", "float32") in tops
    assert ("(990,)", "float32") not in tops  # the view is base's storage
    again = port_ledger.live_array_report(top_n=50, device="cpu")
    del base, view
    assert again["arrays"] == rep["arrays"]


@pytest.mark.cuda
def test_cuda_stats_and_sweep_read_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.zeros(1 << 20, device="cuda")
    stats = port_ledger.device_memory_stats("cuda")
    assert stats["bytes_in_use"] >= x.nbytes
    assert stats["bytes_limit"] == torch.cuda.mem_get_info()[1]
    rep = port_ledger.live_array_report(device="cuda")
    assert x.nbytes <= rep["live_bytes"] <= torch.cuda.memory_allocated()


def test_guard_reraises_the_same_object(tmp_path, monkeypatch):
    _reset_port_dump_rate_limit()
    monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.delenv(port_oom.CAPACITY_ENV, raising=False)
    boom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                       "allocate 2.00 GiB")
    assert port_oom.is_resource_exhausted(boom)
    assert not port_oom.is_resource_exhausted(MemoryError("host"))
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        with port_oom.guard("oom_probe"):
            raise boom
    assert ei.value is boom
    payload = json.load(open(glob.glob(str(tmp_path / "*oom*"))[0]))
    assert payload["extra"]["executable"] == "oom_probe"
    assert "OutOfMemoryError" in payload["extra"]["error"]
    assert payload["extra"]["device_memory_stats"] is None  # the CPU
    assert payload["extra"]["live_arrays"]["live_bytes"] is not None


def test_preflight_warn_port(monkeypatch, capsys):
    monkeypatch.setenv(port_oom.CAPACITY_ENV, "1000")
    assert port_oom.preflight_warn(500, "test") is False
    assert port_oom.preflight_warn(2000, "test", "params + grads")
    err = capsys.readouterr().err
    assert "pre-flight" in err and "horovod_tpu_torch.memory --plan" in err
    monkeypatch.setenv(port_oom.CAPACITY_ENV, "lots")
    with pytest.raises(ValueError, match="HVD_TPU_MEM_CAPACITY"):
        thvd.init(device="cpu")


def _tiny_engine(**kw):
    from horovod_tpu_torch.models.transformer import (TransformerConfig,
                                                      init_transformer)
    from horovod_tpu_torch.serving import InferenceEngine

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                            n_layers=1, d_ff=64, max_seq_len=32)
    params = init_transformer(torch.Generator().manual_seed(0), cfg)
    return InferenceEngine(params, cfg, device="cpu", max_slots=2,
                           page_size=8, capacity=32, **kw), cfg


def test_kv_cache_feeds_ledger_port():
    import gc

    from horovod_tpu_torch.serving.kv_cache import PagedKVCache

    led = port_ledger.ledger
    led.reset()
    cache = PagedKVCache(n_layers=2, n_heads=4, head_dim=8, max_slots=2,
                         pages_per_slot=4, page_size=8, device="cpu",
                         prefix_cache=True, prefix_pages=3)
    assert led.bytes_by_category()["serving.kv_pages"] == \
        port_planner.kv_cache_bytes(2, 4, 8, 2, 4, 8)
    assert led.bytes_by_category()["serving.prefix_pages"] == \
        port_planner.prefix_pages_bytes(2, 4, 8, 3, 8)
    assert cache.k_pages.nbytes + cache.v_pages.nbytes == led.total()
    del cache
    gc.collect()
    assert led.total() == 0
    led.reset()


def test_engine_charges_its_weights_and_guards_its_dispatches(
        tmp_path, monkeypatch):
    import gc

    led = port_ledger.ledger
    led.reset()
    eng, cfg = _tiny_engine(prefix_cache=False)
    cats = led.bytes_by_category()
    assert cats["serving.kv_pages"] == \
        eng.cache.k_pages.nbytes + eng.cache.v_pages.nbytes
    assert cats["serving.params"] >= port_ledger.tree_nbytes(eng.params)
    ready, payload = eng.health()
    assert payload["kv_free_pages"] == eng.cache.free_pages()
    # A capacity a byte below the ledger: the next dispatch raises
    # through guard, named, with the top categories in the dump.
    _reset_port_dump_rate_limit()
    monkeypatch.setenv("HVD_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv(port_oom.CAPACITY_ENV, str(led.total() - 1))
    eng.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(port_oom.ResourceExhaustedError,
                       match="serving/prefill/4"):
        eng.step()
    payload = json.load(open(glob.glob(str(tmp_path / "*oom*"))[0]))
    top = [t["category"] for t in payload["extra"]["top_categories"]]
    assert top[0] in ("serving.params", "serving.kv_pages")
    del eng
    gc.collect()
    assert led.total() == 0
    led.reset()


def test_serving_iteration_spans(monkeypatch):
    from horovod_tpu_torch import trace

    eng, _ = _tiny_engine()
    trace.reset_run(rank=0)
    for prompt in ([1, 2, 3], [4, 5], [6]):
        eng.submit(prompt, max_new_tokens=3)
    ran = 0
    while eng.step():
        ran += 1
    spans = [e for e in trace.export_events() if e.get("cat") == "serving"]
    its = [e for e in spans if e["name"] == "serving.iteration"]
    reqs = [e for e in spans if e["name"] == "serving.request"]
    assert len(its) == ran and len(reqs) == 3
    trace.reset_run(rank=0)


def test_prefetch_charges_are_released():
    from horovod_tpu_torch.parallel.input import prefetch_to_device

    led = port_ledger.ledger
    thvd.init(device="cpu")
    try:
        led.reset()
        batches = [np.ones((8, 4), np.float32) * i for i in range(4)]
        with prefetch_to_device(iter(batches), depth=2) as it:
            assert float(next(it)[0, 0]) == 0.0
            assert led.peak_by_category()["input.prefetch"] >= \
                batches[0].nbytes
        assert led.bytes_by_category().get("input.prefetch", 0) == 0
        for trial in range(10):
            src = (np.full((16, 16), i, np.float32) for i in range(64))
            with prefetch_to_device(src, depth=2) as it:
                next(it)
            assert led.bytes_by_category().get("input.prefetch", 0) == 0, \
                trial
    finally:
        thvd.shutdown()
        led.reset()


def test_checkpoint_snapshot_accounting_port(tmp_path):
    from horovod_tpu_torch.utils.checkpoint import save_checkpoint

    led = port_ledger.ledger
    thvd.init(device="cpu")
    try:
        led.reset()
        tree = {"w": torch.ones(64, 64)}
        h = save_checkpoint(str(tmp_path / "ck.msgpack"), tree)
        assert h.wait(10.0)
        assert led.peak_by_category()["checkpoint.snapshots"] >= \
            tree["w"].nbytes
        assert led.bytes_by_category()["checkpoint.snapshots"] == 0
    finally:
        thvd.shutdown()
        led.reset()


def test_megakernel_launch_charges_the_plans_fusion_bytes():
    led = port_ledger.ledger
    thvd.init(device="cpu")
    try:
        led.reset()
        tensors, elems = 8, 128
        with thvd.quiesce():
            hs = [thvd.allreduce_async(torch.ones(elems) * j,
                                       name=f"mem.{j}")
                  for j in range(tensors)]
        for h in hs:
            thvd.synchronize(h)
        plan = port_planner.plan_dataplane(tensors, elems, 1)
        assert led.watermark() == plan.framework_bytes
        assert led.bytes_by_category()["megakernel.fusion"] == 0
    finally:
        thvd.shutdown()
        led.reset()


def test_residual_store_rides_ledger_port():
    from horovod_tpu_torch.ops import megakernel as mk

    led = port_ledger.ledger
    thvd.init(device="cpu")
    try:
        led.reset()
        thvd.set_compression(default="int8")
        for _ in range(2):
            thvd.allreduce(torch.ones(256), name="resid.t")
        assert mk.residual_count() == 1
        assert led.bytes_by_category()["megakernel.residuals"] == 256 * 4
        mk.flush("test")
        assert led.bytes_by_category()["megakernel.residuals"] == 0
    finally:
        thvd.set_compression()
        thvd.shutdown()
        led.reset()


def test_pipeline_carries_ride_the_ledger():
    from horovod_tpu_torch.parallel.pipeline import make_pipeline_train_step

    S, m, d = 3, 4, 16
    led = port_ledger.ledger
    thvd.init(device="cpu")
    try:
        g = torch.Generator().manual_seed(0)
        params = [{"w": (torch.randn(d, d, generator=g) * d ** -0.5)
                   .requires_grad_()} for _ in range(S)]

        def first(p, carry, b):
            return torch.tanh(b[0] @ p["w"])

        def mid(p, carry, b):
            return torch.tanh(carry @ p["w"])

        def last(p, carry, b):
            return ((carry @ p["w"] - b[1]) ** 2).mean()

        step = make_pipeline_train_step(
            [first, mid, last], lambda ps: torch.optim.SGD(ps, lr=0.1),
            num_microbatches=m)
        opt = step.init(params)
        batch = (torch.randn(m * 2, d, generator=g),
                 torch.randn(m * 2, d, generator=g))
        led.reset()
        steps0 = led.steps()
        step(params, opt, batch)
        measured = led.peak_by_category()["pipeline.activations"]
        assert measured == port_planner.pipeline_activation_bytes(
            S, m, microbatch_rows=2, width=d)
        assert led.bytes_by_category()["pipeline.activations"] == 0
        assert led.steps() == steps0 + 1
    finally:
        thvd.shutdown()
        led.reset()


def test_step_window_closes_per_train_step():
    from horovod_tpu_torch.parallel.training import make_train_step

    led = port_ledger.ledger
    thvd.init(device="cpu")
    try:
        w = torch.nn.Parameter(torch.ones(4, 4))
        step = make_train_step(lambda p, b: ((b @ p["w"]) ** 2).mean(),
                               torch.optim.SGD([w], lr=0.1))
        steps0 = led.steps()
        step({"w": w}, torch.ones(2, 4))
        step({"w": w}, torch.ones(2, 4))
        assert led.steps() == steps0 + 2
    finally:
        thvd.shutdown()


def test_hook_optimizer_releases_its_parameters():
    """The repair the card's live sweep led to: a dropped hook-driven
    DistributedOptimizer releases its parameters, gradients and state
    (its gradient hooks hold it weakly); the hooks still reduce while it
    lives."""
    import gc
    import weakref

    import horovod_tpu_torch.frontends.torch as fhvd

    thvd.init(device="cpu")
    try:
        def run():
            w = torch.nn.Parameter(torch.ones(1000))
            opt = fhvd.DistributedOptimizer(torch.optim.AdamW([w]),
                                            named_parameters=[("w", w)])
            for _ in range(2):
                opt.zero_grad()
                (w * 2).sum().backward()
                opt.step()
            assert opt.state[w]["exp_avg"].abs().sum() > 0
            return weakref.ref(w), weakref.ref(opt)

        w_ref, opt_ref = run()
        gc.collect()
        assert w_ref() is None and opt_ref() is None
    finally:
        thvd.shutdown()


def test_a_finalizer_inside_the_ledgers_lock_does_not_deadlock():
    """The port's finalizers (KV pages, serving weights, a prefetcher's
    __del__) queue their frees: the garbage collector may run them inside
    the ledger's own locked section, where the reference's ``free``
    would block on the non-reentrant lock."""
    import gc
    import threading
    import weakref

    led = port_ledger.MemoryLedger()
    led.alloc("serving.kv_pages", 4096, key="cache")
    led.alloc("input.prefetch", 100)

    class Holder:
        pass

    obj = Holder()
    obj.cycle = obj  # collected by gc.collect(), not by refcount
    weakref.finalize(obj, led.free_deferred, "serving.kv_pages",
                     key="cache")
    weakref.finalize(obj, led.free_deferred, "input.prefetch", 60)
    del obj
    done = threading.Event()

    def locked_section():
        with led._lock:
            gc.collect()
        done.set()

    t = threading.Thread(target=locked_section, daemon=True)
    t.start()
    t.join(30)
    assert done.is_set()
    assert led.bytes_by_category() == {"serving.kv_pages": 0,
                                       "input.prefetch": 40}
