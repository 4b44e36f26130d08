"""Worker stub for the programmatic ``run()`` API (a copy of
``horovod_tpu/runner/run_task.py``).

Reference: horovod/runner/run_task.py — fetches the pickled
function from the launcher's KV store, executes it, posts the result back.
"""

import os
import pickle
import sys
import traceback


def execute_from_store(rank: int):
    """Fetch the pickled function from the rendezvous KV store (address
    from the env contract), execute it, post the result, and return the
    value. Raises on function failure."""
    addr = os.environ["HVD_TPU_RENDEZVOUS_ADDR"]
    port = int(os.environ["HVD_TPU_RENDEZVOUS_PORT"])

    from .rendezvous import KVStoreClient
    client = KVStoreClient(addr, port)
    fn, args, kwargs = pickle.loads(client.wait("run_func", "func"))
    try:
        value = fn(*args, **kwargs)
        payload = {"value": value, "error": None}
    except BaseException:
        payload = {"value": None, "error": traceback.format_exc()}
        client.put("run_result", str(rank), pickle.dumps(payload))
        raise
    client.put("run_result", str(rank), pickle.dumps(payload))
    return value


def main() -> int:
    rank_env = os.environ.get("HVD_TPU_RANK")
    if rank_env is None:
        # mpirun-launched workers (run(use_mpi=True)) carry identity in
        # the MPI env family, not the launcher contract
        from ..config import mpi_task_identity
        rank = int(mpi_task_identity().get("RANK", 0))
    else:
        rank = int(rank_env)
    try:
        execute_from_store(rank)
        return 0
    except BaseException:
        # infrastructure failures (rendezvous down, env missing) must leave
        # a trace in the worker's launcher-prefixed stderr — the KV result
        # payload may never have been posted
        traceback.print_exc(file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
