"""Static memory planner: predict peak device bytes per rank before a
launch (hvd-mem piece 2; port of horovod_tpu/memory/planner.py:1-594).

Two inputs, one plan:

* **Analytic models** of every framework-owned allocation the ledger
  (memory/ledger.py) accounts at run time -- fusion buffers, EF
  residuals, KV pages, prefetch slots, pipeline carries, checkpoint
  snapshots -- PLUS the workload-owned big four (params, optimizer
  state, gradients, activations).  The byte formulas are shared with the
  run-time accounting sites (``fusion_group_bytes`` is the function
  ``ops/megakernel.launch`` charges the ledger with), so plan against
  ledger is a consistency check.  The formulas, and so every plan's
  JSON, are the reference's byte for byte; ``pipeline_activation_bytes``
  reads the port's own ``parallel/pipeline.schedule_plan``.
* **Harvested ``compiled.memory_analysis()``**: the reference records it
  per AOT executable.  The port compiles no executables (its kernels are
  nvcc builds and its programs eager PyTorch), so :func:`record_compiled`
  finds no analysis and :func:`harvest_section` and
  :func:`manifest_section` read as the reference's read on a backend that
  reports nothing.  They stay so that a plan keeps the reference's keys.

``python -m horovod_tpu_torch.memory --plan`` is the no-hardware dryrun:
"will this config fit", and its what-ifs (batch size, microbatch count,
KV pages, interleave).  Plan JSON is byte-identical for identical
configs (sorted keys, no clocks).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ..analysis import lockorder as _lockorder

PLAN_FORMAT = "hvd-mem-plan-v1"

_DTYPE_BYTES = {
    "float32": 4, "f32": 4, "float64": 8, "bfloat16": 2, "float16": 2,
    "int32": 4, "int8": 1, "uint8": 1, "int64": 8,
}


def dtype_bytes(dtype) -> int:
    """Item size without touching a device (the CLI must answer on a box
    with nothing initialized); numpy dtypes resolve via their itemsize,
    torch dtypes and strings via the table."""
    itemsize = getattr(dtype, "itemsize", None)
    if itemsize:
        return int(itemsize)
    name = str(getattr(dtype, "name", dtype)).lower()
    if name.startswith("torch."):
        name = name[len("torch."):]
    if name in _DTYPE_BYTES:
        return _DTYPE_BYTES[name]
    raise ValueError(f"unknown dtype {dtype!r}; expected one of "
                     f"{sorted(_DTYPE_BYTES)}")


# ---------------------------------------------------------------------------
# Shared byte models (the ledger's accounting sites use these too)
# ---------------------------------------------------------------------------

def fusion_group_bytes(shapes: Tuple[Tuple[int, ...], ...], dtype,
                       world: int, variant: str = "sp_pr") -> int:
    """Bytes one megakernel launch holds live: the group's input
    contributions plus its outputs (the packed intermediate aliases
    into them under XLA's donation).  Per-replica variants carry a
    ``world``-leading axis on both sides; replicated/mp payloads are
    single-copy.  This is the function ``ops/megakernel.launch``
    charges the ledger with — prediction and measurement share one
    model by construction."""
    item = dtype_bytes(dtype)
    payload = sum(int(math.prod(s)) if s else 1 for s in shapes) * item
    lead = world if variant in ("sp_pr", "mp") else 1
    return 2 * lead * payload


def fusion_group_device_bytes(shapes: Tuple[Tuple[int, ...], ...],
                              dtype) -> int:
    """PER-DEVICE footprint of one launch — what capacity checks
    compare against a per-device HBM figure.  Uniform across variants:
    a per-replica array holds one row per device, a replicated or mp
    payload one full copy, so each device carries one payload of
    inputs plus one of outputs.  (:func:`fusion_group_bytes` is the
    GLOBAL model the ledger/planner consistency contract shares — a
    2·world multiple of this on the per-replica variants.)"""
    item = dtype_bytes(dtype)
    return 2 * sum(int(math.prod(s)) if s else 1 for s in shapes) * item


def kv_cache_bytes(n_layers: int, n_heads: int, head_dim: int,
                   max_slots: int, pages_per_slot: int, page_size: int,
                   dtype="float32") -> int:
    """K + V page arrays of serving/kv_cache.PagedKVCache (the +1 is
    the reserved trash page; a dedicated prefix reserve is priced
    separately by :func:`prefix_pages_bytes` — the same partition the
    runtime ledger charges)."""
    n_pages = 1 + max_slots * pages_per_slot
    return (2 * n_layers * n_pages * page_size * n_heads * head_dim
            * dtype_bytes(dtype))


def prefix_pages_bytes(n_layers: int, n_heads: int, head_dim: int,
                       n_prefix_pages: int, page_size: int,
                       dtype="float32") -> int:
    """K + V bytes of a dedicated shared-prefix page reserve
    (``PagedKVCache(prefix_pages=N)``) — the ``--prefix-pages``
    what-if, and byte-for-byte the ``serving.prefix_pages`` ledger
    partition the runtime charges at cache construction."""
    return (2 * n_layers * n_prefix_pages * page_size * n_heads
            * head_dim * dtype_bytes(dtype))


def pipeline_activation_bytes(n_stages: int, num_microbatches: int,
                              microbatch_rows: int, width: int,
                              dtype="float32",
                              schedule: Optional[str] = None,
                              interleave: Optional[int] = None) -> int:
    """Peak stage-boundary carry bytes under the resolved schedule:
    ``schedule_plan(...).peak_activations`` (the event-simulated dryrun,
    parallel/pipeline.py) times one carry's GLOBAL bytes.  1F1B bounds
    this at the stage depth; GPipe grows it with the microbatch count —
    the what-if the CLI answers."""
    from ..parallel.pipeline import schedule_plan

    plan = schedule_plan(n_stages, num_microbatches, schedule=schedule,
                         interleave=interleave)
    carry = microbatch_rows * width * dtype_bytes(dtype)
    return plan.peak_activations * carry


def prefetch_bytes(depth: int, batch_bytes: int) -> int:
    """Staged device batches a prefetcher may hold at once
    (parallel/input.py: ``depth`` queued plus the one in flight on the
    stager thread)."""
    return (depth + 1) * batch_bytes


def retune_delta_bytes(knob: str, old, new, knobs) -> int:
    """hvd-tune candidate pricing (tuning/policy.py veto hook): the
    predicted change in per-device live bytes if ``knob`` moves
    ``old`` -> ``new``, from the same byte formulas the planner's
    what-ifs use.  Positive = the candidate costs memory; the tuner
    vetoes candidates whose cost exceeds the window's HBM headroom, so
    a retune can never land on an OOM.

    ``knobs`` is the current knob mapping (tuning.actuation
    ``current_knobs``); it supplies the fusion threshold that bounds
    both the fusion-buffer and the per-in-flight-step cost, and an
    optional ``spec_token_bytes`` advertised by the serving engine."""
    try:
        threshold = int(knobs.get("fusion_threshold", 64 * 1024 * 1024))
    except (TypeError, ValueError):
        threshold = 64 * 1024 * 1024
    try:
        old_i, new_i = int(old or 0), int(new)
    except (TypeError, ValueError):
        return 0
    if knob == "fusion_threshold":
        # In + out fusion buffers, each bounded by the threshold
        # (the same 2x model fusion_group_bytes charges).
        return 2 * (new_i - old_i)
    if knob == "max_inflight":
        # Each extra in-flight step pins up to one dispatched fusion
        # buffer of outputs (parallel/training._ThrottledStep holds the
        # step's tree until it leaves the window).
        return (new_i - old_i) * threshold
    if knob == "spec_tokens":
        # Per extra speculated token: the verify block's logits + draft
        # KV append — advertised by the live engine when one is
        # registered (serving/engine.py), else unpriceable (0).
        try:
            per_token = int(knobs.get("spec_token_bytes", 0) or 0)
        except (TypeError, ValueError):
            per_token = 0
        return (new_i - old_i) * per_token
    if knob == "prefix_pages":
        # Growing the shared-prefix reserve pins extra KV pages; the
        # per-page byte cost comes from the live cache
        # (``page_global_bytes``, advertised as ``prefix_page_bytes``
        # by tuning.actuation.current_knobs), the SAME byte model
        # prefix_pages_bytes prices at plan time — unpriceable (0)
        # without a live serving engine.
        try:
            per_page = int(knobs.get("prefix_page_bytes", 0) or 0)
        except (TypeError, ValueError):
            per_page = 0
        return (new_i - old_i) * per_page
    # Compression escalation narrows wire bytes and cycle_time is
    # host-side only — neither ever costs device memory.
    return 0


def fused_group_bytes(out_shape: Tuple[int, ...], chunks: int,
                      dtype="float32", chunk_axis: int = 0) -> int:
    """Bytes one fused computation-collective launch holds live beyond
    its inputs: the full output plus ONE chunk's partial product — the
    interleave buffer a chunk's collective leg reads while the next
    chunk computes (ops/fused.py).  This is the function
    :class:`~..ops.fused.FusedProgram` charges the ledger's
    ``fused.launch`` category with — prediction and measurement share
    one model by construction."""
    item = dtype_bytes(dtype)
    total = int(math.prod(out_shape)) if out_shape else 1
    rows = out_shape[chunk_axis] if out_shape else 1
    c = max(1, min(int(chunks), max(1, rows)))
    chunk_rows = -(-rows // c)  # ceil: the largest chunk in the plan
    chunk = total // max(1, rows) * chunk_rows
    return (total + chunk) * item


# ---------------------------------------------------------------------------
# Harvest: compiled.memory_analysis() per AOT executable
# ---------------------------------------------------------------------------

_harvest_lock = _lockorder.make_lock("memory.planner._harvest_lock")
_harvest: Dict[str, Dict[str, int]] = {}  # guarded_by: _harvest_lock

# The numeric fields jax's MemoryAnalysis exposes (names vary a little
# across jaxlib versions; we scan for the stable *_in_bytes suffix).
_ANALYSIS_SUFFIX = "_in_bytes"


def record_compiled(name: str, compiled) -> Optional[Dict[str, int]]:
    """Harvest ``compiled.memory_analysis()`` into the process-global
    table, keyed by executable name.  Returns the harvested dict, or
    None when the backend does not implement the query (XLA:CPU) — the
    plan's ``compiled`` section then reports coverage honestly instead
    of zeros.  Never raises: harvesting is observability."""
    try:
        analysis = compiled.memory_analysis()
    except Exception:  # noqa: BLE001 — Unimplemented on CPU, AttributeError
        return None    # on old jax: the planner works without it
    if analysis is None:
        return None
    out: Dict[str, int] = {}
    for attr in dir(analysis):
        if attr.endswith(_ANALYSIS_SUFFIX) and not attr.startswith("_"):
            try:
                out[attr] = int(getattr(analysis, attr))
            except (TypeError, ValueError):
                continue
    if not out:
        return None
    with _harvest_lock:
        _harvest[name] = out
    return out


def harvested() -> Dict[str, Dict[str, int]]:
    with _harvest_lock:
        return {k: dict(v) for k, v in _harvest.items()}


def clear_harvest() -> None:
    with _harvest_lock:
        _harvest.clear()


def harvest_section() -> Dict[str, Any]:
    """The plan's ``compiled`` section: per-executable
    ``memory_analysis`` numbers plus the peak over executables of
    (argument + output + temp) — the XLA-reported live-set bound for
    the single executable whose dispatch peaks."""
    table = harvested()
    peak = 0
    peak_name = None
    for name, fields in table.items():
        live = sum(fields.get(k, 0) for k in (
            "argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes"))
        if live > peak:
            peak, peak_name = live, name
    return {
        "executables": {k: dict(sorted(v.items()))
                        for k, v in sorted(table.items())},
        "peak_executable": peak_name,
        "peak_executable_bytes": peak,
        "coverage": len(table),
    }


def manifest_section(directory: Optional[str] = None) -> Dict[str, Any]:
    """The reference's static fusion-buffer predictions for the
    megakernels its persistent-cache manifest recorded.  The port keeps
    no compile manifest, so this reads as the reference's does with no
    manifest directory."""
    return {"entries": 0, "peak_group_bytes": 0,
            "peak_group_device_bytes": 0}


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@dataclass
class MemoryPlan:
    """One resolved memory plan.  ``sections`` maps workload components
    to byte figures; ``framework`` is the ledger-covered subset — the
    half the runtime measures, so ``framework_bytes`` vs the ledger's
    high watermark is the accuracy contract (±15 %, CI-gated).
    ``to_json()`` is deterministic: identical config ⇒ byte-identical
    output (sorted keys, no clocks, no environment echoes beyond the
    config itself)."""

    model: str
    config: Dict[str, Any]
    world: int
    sections: Dict[str, int] = field(default_factory=dict)
    framework: Dict[str, int] = field(default_factory=dict)
    facts: Dict[str, Any] = field(default_factory=dict)
    capacity_bytes: Optional[int] = None

    @property
    def framework_bytes(self) -> int:
        return sum(self.framework.values())

    @property
    def per_rank_bytes(self) -> int:
        return self.framework_bytes + sum(self.sections.values())

    def to_dict(self) -> Dict[str, Any]:
        fits = None
        headroom = None
        if self.capacity_bytes:
            headroom = self.capacity_bytes - self.per_rank_bytes
            fits = headroom >= 0
        return {
            "format": PLAN_FORMAT,
            "model": self.model,
            "config": dict(sorted(self.config.items())),
            "world": self.world,
            "sections": dict(sorted(self.sections.items())),
            "facts": dict(sorted(self.facts.items())),
            "framework": dict(sorted(self.framework.items())),
            "framework_bytes": self.framework_bytes,
            "per_rank_bytes": self.per_rank_bytes,
            "capacity_bytes": self.capacity_bytes,
            "headroom_bytes": headroom,
            "fits": fits,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=1)


def _transformer_param_bytes(vocab_size: int, d_model: int,
                             n_heads: int, n_layers: int, d_ff: int,
                             max_seq_len: int, dtype="float32") -> int:
    """Parameter bytes of models/transformer.init_transformer, computed
    from the layer shapes (embedding + positional, per layer QKV/out
    projections, two FFN matrices, two layernorm pairs, final norm +
    untied head) — pure arithmetic, no tracing, so the CLI stays
    hardware-free and deterministic."""
    item = dtype_bytes(dtype)
    per_layer = (4 * d_model * d_model                      # wq/wk/wv/wo
                 + 2 * d_model * d_ff + d_ff + d_model      # ffn + biases
                 + 4 * d_model)                             # 2 x ln
    total = (vocab_size * d_model                           # embedding
             + max_seq_len * d_model                        # positions
             + n_layers * per_layer
             + 2 * d_model                                  # final ln
             + d_model * vocab_size)                        # untied head
    return total * item


_OPTIMIZER_SLOTS = {"adam": 2, "adamw": 2, "sgd": 0, "momentum": 1,
                    "none": 0}


def plan_dataplane(tensors: int, elems: int, world: int,
                   dtype: str = "float32",
                   fusion_threshold: Optional[int] = None,
                   capacity: Optional[int] = None) -> MemoryPlan:
    """Plan for the dataplane steady state (``bench.py --mode
    dataplane``'s workload): a ``tensors``-wide allreduce program.  The
    framework peak is the largest fusion group's launch footprint under
    the threshold partition (groups are filled greedily in submission
    order — the coordinator's plan_fusion policy)."""
    item = dtype_bytes(dtype)
    thr = fusion_threshold if fusion_threshold is not None \
        else int(os.environ.get("HOROVOD_FUSION_THRESHOLD",
                                str(64 << 20)))
    per_tensor = elems * item
    groups: List[int] = []
    cur = 0
    for _ in range(tensors):
        if cur and cur + per_tensor > thr:
            groups.append(cur)
            cur = 0
        cur += per_tensor
    if cur:
        groups.append(cur)
    peak_group = max(groups) if groups else 0
    fusion = fusion_group_bytes(
        ((peak_group // item,),), dtype, world, "sp_pr")
    return MemoryPlan(
        model="dataplane",
        config={"tensors": tensors, "elems": elems, "dtype": dtype,
                "fusion_threshold": thr},
        world=world,
        sections={"tensors": tensors * world * per_tensor},
        facts={"fusion_groups": len(groups),
               "peak_group_payload_bytes": peak_group},
        framework={"megakernel.fusion": fusion},
        capacity_bytes=capacity)


def plan_pipeline(n_stages: int, num_microbatches: int,
                  microbatch_rows: int, width: int, world: int,
                  schedule: Optional[str] = None,
                  interleave: Optional[int] = None,
                  dtype: str = "float32",
                  stage_param_bytes: Optional[int] = None,
                  capacity: Optional[int] = None) -> MemoryPlan:
    """Plan for the MPMD pipeline step: carries from the event-simulated
    schedule plan (the 1F1B-vs-GPipe what-if), stage parameters /
    gradient accumulators, and the per-stage bucket reduction's fusion
    transient."""
    from ..parallel.pipeline import schedule_plan

    plan = schedule_plan(n_stages, num_microbatches, schedule=schedule,
                         interleave=interleave)
    item = dtype_bytes(dtype)
    sp = stage_param_bytes if stage_param_bytes is not None \
        else (width * width + width) * item
    carry = microbatch_rows * width * item
    activations = plan.peak_activations * carry
    fusion = 2 * world * sp  # largest stage bucket's launch footprint
    return MemoryPlan(
        model="pipeline",
        config={"n_stages": n_stages,
                "num_microbatches": num_microbatches,
                "microbatch_rows": microbatch_rows, "width": width,
                "schedule": plan.schedule,
                "interleave": plan.interleave, "dtype": dtype},
        world=world,
        sections={"params": n_stages * sp,
                  "gradient_accumulators": n_stages * world * sp},
        facts={"peak_activation_carries": plan.peak_activations,
               "bubble_fraction": round(plan.bubble_fraction, 4)},
        framework={"pipeline.activations": activations,
                   "megakernel.fusion": fusion},
        capacity_bytes=capacity)


def plan_serving(n_layers: int, n_heads: int, head_dim: int,
                 max_slots: int, pages_per_slot: int, page_size: int,
                 world: int = 1, dtype: str = "float32",
                 param_bytes: int = 0,
                 prefix_pages: int = 0,
                 draft_layers: int = 0,
                 draft_d_ff: Optional[int] = None,
                 vocab_size: int = 256,
                 capacity: Optional[int] = None) -> MemoryPlan:
    """Plan for the serving engine: the paged KV store (the dominant
    framework buffer) plus replicated params.  The KV what-ifs —
    slots, pages per slot, page size — are the router tier's capacity
    question (ROADMAP item 2).  hvd-spec what-ifs: ``--prefix-pages``
    prices a dedicated shared-prefix reserve
    (:func:`prefix_pages_bytes`, the runtime's ledger partition) and
    ``--draft-layers`` a speculative-decoding draft model over the
    same slots — its own KV store (:func:`kv_cache_bytes`, the same
    formula the draft ``PagedKVCache`` charges ``serving.draft_kv``
    with) plus its replicated parameters
    (:func:`_transformer_param_bytes`, exact for ``init_transformer``
    trees; draft ``d_model = n_heads * head_dim``, ``d_ff`` defaults
    to ``4 * d_model``, positions sized to the KV capacity)."""
    kv = kv_cache_bytes(n_layers, n_heads, head_dim, max_slots,
                        pages_per_slot, page_size, dtype)
    framework = {"serving.kv_pages": kv}
    facts = {"kv_capacity_tokens": max_slots * pages_per_slot
             * page_size}
    if prefix_pages:
        framework["serving.prefix_pages"] = prefix_pages_bytes(
            n_layers, n_heads, head_dim, prefix_pages, page_size,
            dtype)
        facts["prefix_pages"] = prefix_pages
    if draft_layers:
        d_model = n_heads * head_dim
        framework["serving.draft_kv"] = kv_cache_bytes(
            draft_layers, n_heads, head_dim, max_slots,
            pages_per_slot, page_size, dtype)
        framework["serving.draft_params"] = _transformer_param_bytes(
            vocab_size, d_model, n_heads, draft_layers,
            draft_d_ff if draft_d_ff is not None else 4 * d_model,
            pages_per_slot * page_size, dtype)
        facts["draft_layers"] = draft_layers
    return MemoryPlan(
        model="serving",
        config={"n_layers": n_layers, "n_heads": n_heads,
                "head_dim": head_dim, "max_slots": max_slots,
                "pages_per_slot": pages_per_slot,
                "page_size": page_size, "dtype": dtype,
                "prefix_pages": prefix_pages,
                "draft_layers": draft_layers},
        world=world,
        sections={"params": param_bytes},
        facts=facts,
        framework=framework,
        capacity_bytes=capacity)


def plan_transformer_lm(vocab_size: int = 256, d_model: int = 128,
                        n_heads: int = 8, n_layers: int = 2,
                        d_ff: int = 256, max_seq_len: int = 64,
                        batch_size: int = 32, world: int = 1,
                        optimizer: str = "adam",
                        prefetch_depth: int = 2,
                        dtype: str = "float32",
                        capacity: Optional[int] = None) -> MemoryPlan:
    """End-to-end training plan for the transformer LM example: params
    + optimizer slots + gradients + a coarse activation model
    (per-token residual-stream floats across the layer stack; remat
    halves it in practice — the figure is an upper bound, documented in
    docs/memory.md) + the framework buffers (fusion launch of the
    largest gradient group, prefetch staging, one checkpoint
    snapshot)."""
    if optimizer not in _OPTIMIZER_SLOTS:
        raise ValueError(f"unknown optimizer {optimizer!r}; expected "
                         f"one of {sorted(_OPTIMIZER_SLOTS)}")
    item = dtype_bytes(dtype)
    params = _transformer_param_bytes(vocab_size, d_model, n_heads,
                                      n_layers, d_ff, max_seq_len,
                                      dtype)
    opt = _OPTIMIZER_SLOTS[optimizer] * params
    grads = params
    per_rank_batch = max(1, batch_size // max(1, world))
    activations = (per_rank_batch * max_seq_len
                   * (2 * d_model + d_ff) * n_layers * item)
    batch_bytes = per_rank_batch * max_seq_len * 4 * 2  # tokens+targets
    fusion = fusion_group_bytes(((params // item,),), dtype, world,
                                "sp_pr")
    return MemoryPlan(
        model="transformer_lm",
        config={"vocab_size": vocab_size, "d_model": d_model,
                "n_heads": n_heads, "n_layers": n_layers,
                "d_ff": d_ff, "max_seq_len": max_seq_len,
                "batch_size": batch_size, "optimizer": optimizer,
                "prefetch_depth": prefetch_depth, "dtype": dtype},
        world=world,
        sections={"params": params, "optimizer_state": opt,
                  "gradients": grads, "activations": activations},
        framework={"megakernel.fusion": fusion,
                   "input.prefetch": prefetch_bytes(prefetch_depth,
                                                    batch_bytes),
                   "checkpoint.snapshots": params},
        capacity_bytes=capacity)


_MODELS = {
    "dataplane": plan_dataplane,
    "pipeline": plan_pipeline,
    "serving": plan_serving,
    "transformer_lm": plan_transformer_lm,
}


def model_names() -> Tuple[str, ...]:
    return tuple(sorted(_MODELS))


def build_plan(model: str, **kwargs) -> MemoryPlan:
    """Resolve one plan by model name (the CLI surface; a typo names
    every valid model, the ``hvd.init`` knob-validation convention)."""
    fn = _MODELS.get(model)
    if fn is None:
        raise ValueError(f"unknown plan model {model!r}; expected one "
                         f"of {', '.join(model_names())}")
    return fn(**kwargs)
