"""Programmatic launch API: ``horovod_tpu_torch.runner.run(fn, ...)``
(counterpart of ``horovod_tpu/runner/api.py``).

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
from .launch import check_ssh, free_port
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

    ``use_mpi`` selects the mpirun process launcher (reference
    horovod.run(use_mpi=True)); workers launched by mpirun recover rank
    identity from the MPI env and fetch the function through the same KV
    rendezvous. Without a usable mpirun it raises.
    """
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
        if use_mpi:
            import os

            from .mpi_run import MPISettings, mpi_run
            hosts_str = ",".join(
                f"{h.hostname}:{h.slots}" for h in host_list)
            # same base-env contract as the ssh launcher: an explicit
            # ``env`` REPLACES the inherited environment
            worker_env = {**(env if env is not None else os.environ),
                          "HVD_TPU_RENDEZVOUS_ADDR": rdv_host,
                          "HVD_TPU_RENDEZVOUS_PORT": str(server.port)}
            if all_local:
                # the driver IS the coordinator host, so its free-port
                # probe is valid; on remote host lists mpi_run derives a
                # stable port on the first host instead
                worker_env["HVD_TPU_COORDINATOR_ADDR"] = coordinator_addr
            mpi_rc = mpi_run(
                MPISettings(num_proc=size, hosts=hosts_str,
                            verbose=verbose),
                worker_env, command)
            # mpirun yields ONE aggregate exit code for the whole gang;
            # the failing rank, if identifiable, surfaces from its KV
            # error payload below
            codes = []
        else:
            mpi_rc = None
            codes = launch_workers(
                command, slots, coordinator_addr,
                rendezvous_addr=rdv_host,
                rendezvous_port=server.port,
                prefix_output=verbose, base_env=env)
        failed = [(r, c) for r, c in enumerate(codes) if c != 0]
        any_failed = bool(failed) or (mpi_rc not in (None, 0))
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
        if mpi_rc not in (None, 0):
            raise RuntimeError(
                f"run() failed: mpirun exited with code {mpi_rc} (one "
                f"aggregate code for all {size} ranks; no per-rank error "
                f"was reported through the rendezvous)")
        return results
    finally:
        server.stop()


# convenience namespace mirroring `import horovod; horovod.run`
api = SimpleNamespace(run=run)
