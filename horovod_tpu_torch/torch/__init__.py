"""The torch frontend: the port's core under the JAX package's module path
(counterpart of ``horovod_tpu/torch``).

In the JAX package this module bridges torch tensors into the XLA core
through DLPack and holds its own hook-based ``DistributedOptimizer``. In
the port the core already is torch: every name here is the core's own
(``allreduce_async_``, ``synchronize``, the hook-based
``DistributedOptimizer`` with its Adasum delta form,
``broadcast_optimizer_state``, ...), so a script written against
``horovod_tpu.torch`` runs on the card by changing its import.

Usage (the reference's 5-line recipe)::

    import horovod_tpu_torch.torch as hvd
    hvd.init()
    optimizer = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1 * hvd.size()),
        named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(optimizer, root_rank=0)

Inside the port ``import torch`` is absolute, so this package never
shadows the real ``torch``.
"""

from ..basics import (  # noqa: F401
    init, shutdown, is_initialized, rank, size, local_rank, local_size,
    cross_rank, cross_size,
)
from ..collectives import (  # noqa: F401
    Average, Sum, Adasum, poll, join, join_round,
    allreduce, allreduce_, allgather, broadcast, broadcast_, alltoall,
    allreduce_async, allreduce_async_, broadcast_async, broadcast_async_,
    allgather_async, alltoall_async, synchronize,
)
from ..compression import Compression  # noqa: F401
from ..functions import (  # noqa: F401
    broadcast_parameters, broadcast_optimizer_state,
)
from ..optimizer import DistributedOptimizer  # noqa: F401
from ..sync_batch_norm import SyncBatchNorm  # noqa: F401


def __getattr__(name):  # PEP 562, as the JAX package defers its elastic
    if name == "elastic":
        import importlib
        return importlib.import_module(".elastic", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
