"""``import horovod_tpu_torch as hvd`` binds every public top-level name of
``import horovod_tpu as hvd`` (ROADMAP.md C.5), except the names listed
below with their reasons: those that need no counterpart in a PyTorch
port (ROADMAP.md §A "No counterpart needed") and those of modules still
queued (§A.5.3 and later).  Differences inside a bound name are listed
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

QUEUED = {
    "elastic": "A.5.3 elastic.py",
    "chaos": "A.5.4 chaos/",
}

PUBLIC = sorted(n for n in dir(ref_hvd) if not n.startswith("_"))

# Bound names whose port differs from the reference's, with the reason.
DIFFERENCES = {
    "analysis.analyze_sources": (
        "no post-donation-read pass: the reference's analysis/donation.py "
        "has no counterpart (torch has no buffer donation, ROADMAP.md §A "
        "'No counterpart needed'), so the port runs lint, thread-role and "
        "stale-waiver only"),
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
