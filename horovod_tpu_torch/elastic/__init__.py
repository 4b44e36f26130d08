"""Elastic (fault-tolerant, resizable) training for horovod_tpu_torch.

Counterpart of ``horovod_tpu/elastic/`` (reference:
horovod/runner/elastic/{driver,discovery,registration,worker}.py and
horovod/common/elastic.py):

* the **launcher side** is the JAX package's, copied: a driver with a
  1 Hz host-discovery thread, stable rank assignments, a worker-state
  registry with host blacklisting, heartbeats, preemption drains and a KV
  rendezvous the workers re-query on reset;
* the **worker side** is the reference's torch design: a reset is
  ``shutdown(); init()`` in the same process (``run.py`` states the steps),
  and :class:`TorchState` moves a module's and an optimizer's state
  between the card and host memory.

User API (mirrors ``hvd.elastic``)::

    import horovod_tpu_torch as hvd

    hvd.init()
    state = hvd.elastic.TorchState(model, optimizer, epoch=0)

    @hvd.elastic.run
    def train(state):
        for state.epoch in range(state.epoch, epochs):
            ...
            state.commit()

    train(state)

launched with ``python -m horovod_tpu_torch.runner -np 2 --min-np 1
--host-discovery-script ./hosts.sh python train.py``.
"""

from .state import State, ObjectState, TorchState  # noqa: F401
from .run import fetch_mesh_shape, run, run_fn  # noqa: F401
from .discovery import (  # noqa: F401
    HostDiscovery, HostDiscoveryScript, FixedHosts, HostManager,
    DiscoveredHosts,
)
from .registration import WorkerStateRegistry, READY, SUCCESS, FAILURE  # noqa: F401
from .driver import ElasticDriver  # noqa: F401
from .callbacks import (  # noqa: F401
    CommitStateCallback, UpdateBatchStateCallback, UpdateEpochStateCallback,
)
