"""Build and runtime feature queries (port of
horovod_tpu/core/features.py; ≙ the post-v0.13 Horovod API
``hvd.nccl_built()``, ``hvd.mpi_enabled()``, ...).

Scripts branch on these to pick launch and tuning paths, so each answer
is true of this port, not copied from the reference: the data plane is
``torch.distributed`` (NCCL on the GPU, gloo on the CPU), the control
plane a gloo group, and no MPI, CCL, DDL or XLA is used.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def mpi_built() -> bool:
    """torch.distributed was built with its MPI backend."""
    return dist.is_mpi_available()


def mpi_enabled() -> bool:
    """The port never runs on MPI, built or not."""
    return False


def nccl_built() -> bool:
    return dist.is_nccl_available()


def gloo_built() -> bool:
    return dist.is_gloo_available()


def gloo_enabled() -> bool:
    """The control channel (more than one rank) and the CPU data plane
    run on gloo whenever it is built."""
    return gloo_built()


def cuda_built() -> bool:
    return torch.backends.cuda.is_built()


def rocm_built() -> bool:
    return torch.version.hip is not None


def ccl_built() -> bool:
    return False


def ddl_built() -> bool:
    return False


def xla_built() -> bool:
    return False


def native_built() -> bool:
    """The native runtime (``native/``: the C++ coordinator, handle
    manager and timeline writer) is loaded, built at first use; False
    when ``HVD_TPU_DISABLE_NATIVE`` selects the Python twins.  A failed
    build raises."""
    from ..native import lib

    return lib.active() is not None
