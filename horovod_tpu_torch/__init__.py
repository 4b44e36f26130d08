"""horovod_tpu_torch: the PyTorch/CUDA port of horovod_tpu.

The second package of the repository, beside the JAX one it is held
against. It imports torch and numpy, never JAX or anything of
``horovod_tpu``, and keeps its own copies of what it needs. The data plane
is ``torch.distributed`` (NCCL on the card, gloo on the CPU); the kernels
that horovod_tpu wrote in Pallas for the TPU are hand-written CUDA for
Hopper (``ops/csrc``). Entry points run on CUDA unless the caller passes
``device="cpu"``.

Quick start (data-parallel)::

    import horovod_tpu_torch as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(torch.optim.AdamW(model.parameters()),
                                   named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
"""

__version__ = "0.1.0"

from .basics import (  # noqa: F401
    init, shutdown, is_initialized,
    rank, size, local_rank, local_size, cross_rank, cross_size,
    device_count, local_device_count, dp_size, is_homogeneous,
    process_set_mesh, hostname, device,
    xla_built, tpu_available, mpi_built, mpi_enabled, gloo_built,
    nccl_built, ccl_built, ddl_built, cuda_built, rocm_built,
    mpi_threads_supported,
)
from .collectives import (  # noqa: F401
    ReduceOp, Average, Sum, Adasum, Min, Max, Product,
    allreduce, allreduce_async, grouped_allreduce, grouped_allreduce_async,
    allgather, allgather_async,
    broadcast, broadcast_async, broadcast_,
    grouped_broadcast, grouped_broadcast_async,
    alltoall, alltoall_async,
    poll, synchronize, release, join, join_round, joined, barrier,
)
from .compression import Compression  # noqa: F401
from .exceptions import (  # noqa: F401
    HorovodInternalError, HostsUpdatedInterrupt, TensorValidationError,
    DuplicateNameError, NotInitializedError, StallError,
)
from .mesh import cross_local_mesh  # noqa: F401
from .functions import (  # noqa: F401
    broadcast_parameters, broadcast_optimizer_state,
    broadcast_object, allgather_object,
)
from .optimizer import DistributedOptimizer  # noqa: F401
from .sparse import (  # noqa: F401
    SparseGradient, allreduce_sparse, allreduce_sparse_as_dense,
    sparse_to_dense,
)
from .sync_batch_norm import SyncBatchNorm, sync_batch_norm_stats  # noqa: F401


def __getattr__(name):
    # the Estimator and these subpackages load on first use
    # (``hvd.Estimator``, ``hvd.elastic.run``, ``hvd.callbacks``,
    # ``hvd.compiled_autotune``), as in
    # the JAX package: importlib, not ``from . import x``, whose fromlist
    # lookup would re-enter this __getattr__
    if name == "Estimator":
        from .estimator import Estimator
        return Estimator
    if name in ("elastic", "runner", "callbacks", "data", "sdc",
                "checkpoint", "checkpointing", "serving",
                "compiled_autotune"):
        import importlib
        return importlib.import_module("." + name, __name__)
    raise AttributeError(
        f"module 'horovod_tpu_torch' has no attribute {name!r}")
