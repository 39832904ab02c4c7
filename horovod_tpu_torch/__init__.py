"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu, for NVIDIA
Hopper GPUs.

``import horovod_tpu_torch as hvd`` gives the Horovod surface::

    hvd.init()                                    # NCCL on this rank's GPU
    params = hvd.broadcast_parameters(params, root_rank=0)
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(leaves, lr=3e-4,
                                                     weight_decay=1e-4))
    step = hvd.make_train_step(loss_fn, opt)

Collectives run on ``torch.distributed`` (NCCL on the GPU, gloo on the
CPU).  The flash-attention kernels are CUDA C++ for ``sm_90a``
(``ops/csrc``), built by ``nvcc`` at first use.  The package imports
neither jax nor horovod_tpu; the tests hold it against horovod_tpu.
"""

from .core.state import (NotInitializedError, cross_rank, cross_size,
                         device, init, is_initialized, local_rank,
                         local_size, rank, shutdown, size)
from .ops.collective import (allgather, allgather_async, allreduce,
                             allreduce_async, barrier, broadcast,
                             broadcast_async, poll, synchronize)
from .ops.compression import Compression
from .ops.objects import allgather_object, broadcast_object
from .ops.wire import ReduceOp
from .parallel.data import (DistributedOptimizer, allreduce_gradients,
                            broadcast_parameters, partition_fusion_buckets)
from .parallel.input import prefetch_to_device
from .parallel.training import (barrier_fence, make_eval_step,
                                make_train_step, make_train_step_with_state,
                                shard_batch, shard_local_batch)
from .utils.tree import tree_leaves

Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM

__all__ = [
    "Adasum", "Average", "Compression", "DistributedOptimizer",
    "NotInitializedError", "ReduceOp", "Sum", "allgather",
    "allgather_async", "allgather_object", "allreduce",
    "allreduce_async", "allreduce_gradients", "barrier", "barrier_fence",
    "broadcast", "broadcast_async", "broadcast_object",
    "broadcast_parameters", "cross_rank", "cross_size", "device", "init",
    "is_initialized", "local_rank", "local_size", "make_eval_step",
    "make_train_step", "make_train_step_with_state",
    "partition_fusion_buckets", "poll", "prefetch_to_device", "rank",
    "shard_batch", "shard_local_batch", "shutdown", "size",
    "synchronize", "tree_leaves",
]
