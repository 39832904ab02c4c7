"""``import horovod_tpu_torch as hvd`` binds every public top-level name of
``import horovod_tpu as hvd`` (ROADMAP.md C.5), except the names listed
below with their reasons: those that need no counterpart in a PyTorch
port (ROADMAP.md §A "No counterpart needed") and those of modules still
queued (none since §A.5.3).  Differences inside a bound name are listed
too, each with its reason (``DIFFERENCES``)."""

import pytest

import horovod_tpu as ref_hvd
import horovod_tpu_torch as port_hvd

NO_COUNTERPART = {
    # JAX's replica mesh inside one process: the reference holds many
    # devices per process and names them on an axis; the port runs one
    # rank a process (its meshes are core/topology.make_mesh).
    "REPLICA_AXIS": "the reference's in-process replica axis name",
    "mesh": "the reference's jax.sharding.Mesh of replicas",
    "replica_id": "a replica index inside shard_map",
    "shard": "per-replica JAX global arrays (ROADMAP.md §A)",
    # One process is one rank: rank() and size() are these.
    "process_index": "one process is one rank: hvd.rank()",
    "process_count": "one process is one rank: hvd.size()",
}

QUEUED = {}

PUBLIC = sorted(n for n in dir(ref_hvd) if not n.startswith("_"))

# Bound names whose port differs from the reference's, with the reason.
DIFFERENCES = {
    "analysis.analyze_sources": (
        "no post-donation-read pass: the reference's analysis/donation.py "
        "has no counterpart (torch has no buffer donation, ROADMAP.md §A "
        "'No counterpart needed'), so the port runs lint, thread-role and "
        "stale-waiver only"),
    "serving.InferenceEngine.set_spec_tokens": (
        "latched: a RETUNE marker is applied on the cycle's thread while "
        "the engine's thread may be inside an iteration, so the engine "
        "adopts the depth (and set_prefix_target's cap) at the start of "
        "its next step and rank 0's plan carries them to the followers; "
        "the reference sets both at once (ROADMAP.md §C.3)"),
}


@pytest.mark.parametrize("name", [n for n in PUBLIC
                                  if n not in NO_COUNTERPART
                                  and n not in QUEUED])
def test_port_binds_the_references_name(name):
    assert hasattr(port_hvd, name), name


def test_every_exclusion_is_a_reference_name_the_port_lacks():
    for name in list(NO_COUNTERPART) + list(QUEUED):
        assert name in PUBLIC, name
        assert not hasattr(port_hvd, name), (
            f"{name} is bound now: take it off the exclusions")


@pytest.mark.parametrize("name", ["broadcast_global_variables", "telemetry",
                                  "metrics", "cluster_metrics", "serving",
                                  "fused"])
def test_the_c5_names_are_bound_and_exported(name):
    assert hasattr(port_hvd, name) and name in port_hvd.__all__


def test_broadcast_global_variables_is_broadcast_parameters():
    assert port_hvd.broadcast_global_variables is \
        port_hvd.broadcast_parameters


def test_bound_modules_are_the_ports():
    assert port_hvd.telemetry.__name__ == "horovod_tpu_torch.telemetry"
    assert port_hvd.serving.InferenceEngine.__module__ == \
        "horovod_tpu_torch.serving.engine"
    assert port_hvd.fused.__name__ == "horovod_tpu_torch.ops.fused"
    assert port_hvd.metrics is port_hvd.telemetry.metrics


@pytest.mark.parametrize("name", ["analysis", "verify_program", "trace",
                                  "dump_fleet_trace", "StragglerWatch",
                                  "memory", "MemoryWatch"])
def test_the_a52_names_are_bound_and_exported(name):
    assert hasattr(port_hvd, name) and name in port_hvd.__all__


@pytest.mark.parametrize("name", ["elastic", "chaos"])
def test_the_a53_names_are_bound_and_exported(name):
    assert hasattr(port_hvd, name) and name in port_hvd.__all__


def test_bound_elastic_and_chaos_are_the_ports():
    assert port_hvd.elastic.__name__ == "horovod_tpu_torch.elastic"
    assert port_hvd.chaos.__name__ == "horovod_tpu_torch.chaos"
    assert port_hvd.elastic.EX_TEMPFAIL == 75
    assert port_hvd.chaos.VALID_SITES == ref_hvd.chaos.VALID_SITES


def test_analyze_sources_lacks_only_the_donation_pass():
    """DIFFERENCES["analysis.analyze_sources"]: the reference's CLI runs a
    post-donation-read pass the port has no counterpart for; every other
    pass is the same."""
    import horovod_tpu.analysis as ref_analysis

    assert "analysis.analyze_sources" in DIFFERENCES
    assert hasattr(ref_analysis, "donation")
    assert not hasattr(port_hvd.analysis, "donation")
    assert not hasattr(port_hvd.analysis, "guard_dispatch")
    src = {"m.py": "def f(x):\n    return x\n"}
    assert port_hvd.analysis.analyze_sources(src) == []
    assert ref_analysis.analyze_sources(src) == []


def test_set_spec_tokens_and_the_prefix_target_wait_for_the_next_step():
    """DIFFERENCES["serving.InferenceEngine.set_spec_tokens"]: the
    reference's engine takes the new depth at once, the port's at its next
    step; the prefix target likewise reaches the cache only then."""
    from torch_serving_cases import (CFG_R, DRAFT, DRAFT_CFG, DRAFT_CFG_R,
                                     DRAFT_R, PARAMS_R, make_engine)

    assert "serving.InferenceEngine.set_spec_tokens" in DIFFERENCES
    ref = ref_hvd.serving.InferenceEngine(
        PARAMS_R, CFG_R, max_slots=3, page_size=8, capacity=32,
        draft=(DRAFT_R, DRAFT_CFG_R), spec_tokens=3)
    ref.set_spec_tokens(2)
    assert ref.spec_tokens == 2
    port = make_engine(draft=(DRAFT, DRAFT_CFG), spec_tokens=3)
    port.set_spec_tokens(2)
    port.set_prefix_target(4)
    with pytest.raises(ValueError, match="spec_tokens must be >= 1"):
        port.set_spec_tokens(0)
    assert port.spec_tokens == 3 and port.cache._prefix_target is None
    assert port.step() is False  # an idle iteration adopts them
    assert port.spec_tokens == 2 and port.cache._prefix_target == 4


# ---------------------------------------------------------------------------
# The keras and tensorflow frontends (ROADMAP.md §A.5 item 7)
# ---------------------------------------------------------------------------

def _frontend_pairs():
    import horovod_tpu.frontends.keras as ref_keras
    import horovod_tpu.frontends.tensorflow as ref_tf
    import horovod_tpu_torch.frontends.keras as port_keras
    import horovod_tpu_torch.frontends.tensorflow as port_tf

    return {"keras": (ref_keras, port_keras), "tensorflow": (ref_tf, port_tf)}


def _public(module):
    """The module's own public names: what it defines or re-exports from
    its package, not the modules and typing helpers it imports."""
    import types

    return sorted(
        n for n, v in vars(module).items()
        if not n.startswith("_") and not isinstance(v, types.ModuleType)
        and getattr(v, "__module__", "").split(".")[0] == "horovod_tpu")


# Public names of the reference frontends the port leaves out, with the
# reason: none.
FRONTEND_NO_COUNTERPART = {"keras": {}, "tensorflow": {}}

# Bound names whose port differs from the reference's, with the reason
# (ROADMAP.md §C.3).
FRONTEND_DIFFERENCES = {
    "keras.callbacks.LearningRateScheduleCallback": (
        "the reference's rule as it stands: only Keras on JAX drops a "
        "per-batch ramp to epoch steps, so on torch the ramp runs per "
        "batch; and the momentum correction reaches torch's eager step "
        "where the reference's jitted JAX step never sees it"),
    "tensorflow.allreduce": (
        "float64 stays float64 on the wire (the reference rounds it to "
        "float32, x64 being off there); bfloat16 crosses by its bits"),
    "tensorflow.grouped_allreduce": (
        "a batch enqueues as one group (one cycle's batch): one fused "
        "response by construction, where the reference's fusion follows "
        "its tick"),
}


@pytest.mark.parametrize("frontend,name", [
    (f, n) for f in ("keras", "tensorflow")
    for n in _public(_frontend_pairs()[f][0])
    if n not in FRONTEND_NO_COUNTERPART[f]])
def test_port_frontend_binds_the_references_name(frontend, name):
    ref, port = _frontend_pairs()[frontend]
    assert hasattr(port, name), f"{port.__name__} lacks {name}"
    value = getattr(port, name)
    module = getattr(value, "__module__", "") or ""
    assert module.split(".")[0] == "horovod_tpu_torch", (name, module)


def test_frontend_public_names_are_many_and_the_exclusions_hold():
    for frontend, (ref, port) in _frontend_pairs().items():
        names = _public(ref)
        assert len(names) >= 25, (frontend, names)
        for name in FRONTEND_NO_COUNTERPART[frontend]:
            assert name in names and not hasattr(port, name)
    for key in FRONTEND_DIFFERENCES:
        frontend, name = key.split(".", 1)
        assert hasattr(_frontend_pairs()[frontend][1], name.split(".")[0])


@pytest.mark.parametrize("frontend", ["keras", "tensorflow"])
def test_frontend_object_collectives_are_the_ports(frontend):
    """≙ tests/test_objects.py:26-33 for the port's frontends."""
    from horovod_tpu_torch.ops import objects as port_objects

    ref, port = _frontend_pairs()[frontend]
    assert port.allgather_object is port_objects.allgather_object
    assert port.broadcast_object is port_objects.broadcast_object
    assert port.allgather_object is port_hvd.allgather_object
    assert port.broadcast_object is port_hvd.broadcast_object
    assert port.init is port_hvd.init and port.Sum is port_hvd.Sum
    assert port.Compression is port_hvd.Compression
