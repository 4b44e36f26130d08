"""The port's launcher: ``python -m horovod_tpu_torch.runner``.

Counterpart of ``horovod_tpu/runner/`` (reference: horovod/runner/ — the
``horovodrun`` console script, launch.py:711 run_commandline;
programmatic ``horovod.run()``, runner/__init__.py:89; host/slot
assignment, common/util/hosts.py:106-155; HTTP KV rendezvous,
http/http_server.py; threaded ssh execution, gloo_run.py:112-261).

The host plane is the JAX package's, copied: the same flags, the same env
contract for each worker, the same HTTP KV rendezvous and wire format (a
port worker can be started by either package's launcher, and the two
packages' KV clients and servers interoperate). A worker runs on
``cuda:<local rank>``, so a host of N cards takes N slots; its
``basics.init()`` forms the process group through the TCP store at
``HVD_TPU_COORDINATOR_ADDR``, which the rank-0 worker listens on. The
mpirun (``mpi_run.py``) and IBM jsrun (``lsf.py``) routes start the same
workers through the scheduler's launcher, as the JAX package's do; a
worker then takes its rank from the scheduler's env
(``config.mpi_task_identity``).
"""

from .api import run, run_func_result_scope  # noqa: F401
from .hosts import (  # noqa: F401
    HostInfo, SlotInfo, parse_hosts, parse_hostfile, get_host_assignments,
)
from .launch import main, run_commandline  # noqa: F401
