"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu, for NVIDIA
Hopper GPUs.

``import horovod_tpu_torch as hvd`` gives the Horovod surface::

    hvd.init()                                    # NCCL on this rank's GPU
    params = hvd.broadcast_parameters(params, root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(leaves, lr=3e-4,
                                                     weight_decay=1e-4))
    step = hvd.make_train_step(loss_fn, opt)

The eager collectives are Horovod's: named, negotiated by rank 0's
coordinator each cycle of a background thread, fused, and executed in one
order on every rank (``ops/collective.py``); ``frontends.torch`` is the
``horovod.torch`` surface over them, with the hook-driven
``DistributedOptimizer``.  ``set_compression`` selects per-tensor wire
formats: bf16/fp16 casts, or int8/int4 block quantization with error
feedback (``compression_state`` saves its residuals).  Collectives run on ``torch.distributed`` (NCCL
on the GPU, gloo on the CPU).  The flash-attention kernels are CUDA C++
for ``sm_90a`` (``ops/csrc``), built by ``nvcc`` at first use.  The package imports
neither jax nor horovod_tpu; the tests hold it against horovod_tpu.
"""

from .core.features import (ccl_built, cuda_built, ddl_built, gloo_built,
                            gloo_enabled, mpi_built, mpi_enabled,
                            native_built, nccl_built, rocm_built, xla_built)
from .core.state import (NotInitializedError, cross_rank, cross_size,
                         device, init, is_initialized, local_rank,
                         local_size, mpi_threads_supported, rank, shutdown,
                         size, start_timeline, stop_timeline)
from .ops.collective import (HorovodError, add_process_set, allgather,
                             allgather_async, allreduce, allreduce_async,
                             alltoall, alltoall_async, barrier, broadcast,
                             broadcast_async, global_process_set,
                             grouped_allgather, grouped_allgather_async,
                             grouped_allreduce, grouped_allreduce_async,
                             grouped_reducescatter,
                             grouped_reducescatter_async, join, poll,
                             quiesce, reducescatter, reducescatter_async,
                             remove_process_set, synchronize)
from .ops.compression import Compression, get_compression, set_compression
from .ops.megakernel import compression_state, load_compression_state
from .ops.objects import allgather_object, broadcast_object
from .ops.process_set import ProcessSet
from .ops.sparse import IndexedSlices
from .ops.wire import ReduceOp
from .parallel.data import (DistributedOptimizer, allreduce_gradients,
                            broadcast_global_variables, broadcast_parameters,
                            partition_fusion_buckets)
from .parallel.input import prefetch_to_device
from .parallel.overlap import ChainedLoss
from .parallel.pipeline import (PipelinePlan, make_pipeline_train_step,
                                schedule_plan)
from .parallel.training import (barrier_fence, make_eval_step,
                                make_train_step, make_train_step_with_state,
                                shard_batch, shard_local_batch)
from .utils.tree import tree_leaves
from . import telemetry  # noqa: E402  (hvd.telemetry.flight & registry)
from .telemetry import cluster_metrics, metrics  # noqa: E402
from . import serving  # noqa: E402  (hvd.serving.InferenceEngine & co)
from .ops import fused  # noqa: E402  (hvd.fused: matmul_psum & co)
from . import analysis  # noqa: E402  (hvd.analysis.verify_program & co)
from .analysis.program import verify_program  # noqa: E402
from . import trace  # noqa: E402  (hvd.trace spans & clock alignment)
from .trace.merge import dump_fleet_trace  # noqa: E402
from .trace.watch import StragglerWatch  # noqa: E402
from . import memory  # noqa: E402  (hvd.memory: ledger/planner/oom)
from .memory import MemoryWatch  # noqa: E402

Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT

__all__ = [
    "Adasum", "Average", "ChainedLoss", "Compression",
    "DistributedOptimizer", "MemoryWatch", "StragglerWatch", "analysis",
    "dump_fleet_trace", "memory", "trace", "verify_program",
    "HorovodError", "IndexedSlices", "Max", "Min", "NotInitializedError",
    "ProcessSet", "Product", "ReduceOp", "Sum", "add_process_set",
    "allgather",
    "allgather_async", "allgather_object", "allreduce",
    "allreduce_async", "allreduce_gradients", "alltoall",
    "alltoall_async", "barrier", "barrier_fence", "broadcast",
    "broadcast_async", "broadcast_global_variables", "broadcast_object",
    "broadcast_parameters", "cluster_metrics",
    "ccl_built", "compression_state", "cross_rank", "cross_size",
    "cuda_built", "ddl_built", "device", "get_compression", "gloo_built", "gloo_enabled", "global_process_set",
    "grouped_allgather", "grouped_allgather_async", "grouped_allreduce",
    "grouped_allreduce_async", "grouped_reducescatter",
    "grouped_reducescatter_async", "fused", "init", "is_initialized", "join",
    "local_rank", "local_size", "make_eval_step", "metrics", "make_train_step",
    "load_compression_state", "make_train_step_with_state", "mpi_built",
    "mpi_enabled",
    "mpi_threads_supported", "native_built", "nccl_built",
    "make_pipeline_train_step", "partition_fusion_buckets",
    "PipelinePlan", "poll", "prefetch_to_device", "quiesce",
    "rank", "reducescatter", "reducescatter_async", "remove_process_set",
    "rocm_built", "schedule_plan", "serving", "set_compression", "shard_batch",
    "shard_local_batch",
    "shutdown", "size",
    "start_timeline", "stop_timeline", "synchronize", "telemetry",
    "tree_leaves",
    "xla_built",
]
