"""Programmatic launch API: ``horovod_tpu_torch.runner.run(fn, ...)``
(counterpart of ``horovod_tpu/runner/api.py``; ``use_mpi=True`` raises
until the mpirun route is ported, ROADMAP A2).

Reference: horovod/runner/__init__.py:89 ``horovod.run()`` —
pickles a function, launches workers that fetch and execute it, and collects
per-rank results through the KV store (launch.py:549-570, run_task.py).
"""

import pickle
import sys
from types import SimpleNamespace
from typing import Any, List, Optional

from .exec_run import is_local_host, launch_workers
from .hosts import HostInfo, get_host_assignments, parse_hosts
from .launch import ROUTE_NOT_PORTED, check_ssh, free_port
from .rendezvous import RendezvousServer

run_func_result_scope = "run_result"


def _dumps(obj) -> bytes:
    try:
        import cloudpickle
        return cloudpickle.dumps(obj)
    except ImportError:
        return pickle.dumps(obj)


def run(fn, args=(), kwargs=None, np: int = 1,
        hosts: Optional[str] = None, use_mpi: bool = False,
        verbose: bool = False, disable_ssh_check: bool = False,
        env: Optional[dict] = None) -> List[Any]:
    """Execute ``fn(*args, **kwargs)`` on ``np`` workers; return the list of
    per-rank return values ordered by rank (reference horovod.run()).
    Each worker runs ``fn`` with the launcher's env contract set, so ``fn``
    calls ``horovod_tpu_torch.init()`` itself (on the card of its slot, or
    ``device="cpu"``).

    ``use_mpi`` (the reference's mpirun process launcher) is not ported
    yet and raises.
    """
    if use_mpi:
        raise RuntimeError(ROUTE_NOT_PORTED.format(route="mpirun",
                                                   module="mpi_run.py"))
    host_list = parse_hosts(hosts) if hosts else [HostInfo("localhost", np)]
    if not disable_ssh_check:
        bad = check_ssh([h.hostname for h in host_list])
        if bad:
            raise RuntimeError(
                f"hosts not reachable over passwordless ssh: {sorted(bad)}")
    slots, size = get_host_assignments(host_list, np)

    server = RendezvousServer(verbose=verbose)
    server.start()
    server.init(slots)
    server.put("run_func", "func", _dumps((fn, tuple(args), kwargs or {})))
    try:
        import socket as _socket
        all_local = all(is_local_host(s.hostname) for s in slots)
        coord_host = "127.0.0.1" if all_local else slots[0].hostname
        coordinator_addr = f"{coord_host}:{free_port()}"
        rdv_host = "127.0.0.1" if all_local else _socket.gethostname()
        command = [sys.executable, "-m",
                   "horovod_tpu_torch.runner.run_task"]
        codes = launch_workers(
            command, slots, coordinator_addr,
            rendezvous_addr=rdv_host,
            rendezvous_port=server.port,
            prefix_output=verbose, base_env=env)
        failed = [(r, c) for r, c in enumerate(codes) if c != 0]
        any_failed = bool(failed)
        results = []
        for r in range(size):
            blob = server.get(run_func_result_scope, str(r))
            payload = pickle.loads(blob) if blob is not None else None
            if payload and payload.get("error"):
                raise RuntimeError(f"rank {r} raised: {payload['error']}")
            if any_failed:
                continue
            if payload is None:
                raise RuntimeError(f"rank {r} produced no result")
            results.append(payload["value"])
        if failed:
            raise RuntimeError(f"run() workers failed: {failed}")
        return results
    finally:
        server.stop()


# convenience namespace mirroring `import horovod; horovod.run`
api = SimpleNamespace(run=run)
