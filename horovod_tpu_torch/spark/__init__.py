"""Spark integration of the port (counterpart of ``horovod_tpu/spark``;
reference: horovod/spark/runner.py:47-193 ``run(fn)`` and :303+
``run_elastic``).

Spark supplies worker placement only: each barrier task becomes one
horovod_tpu_torch process wired to the driver's rendezvous server through
the launcher's env contract (``HVD_TPU_RANK``, ``HVD_TPU_SIZE``,
``HVD_TPU_COORDINATOR_ADDR``, ...), and the data plane is the port's own
(NCCL on the executors' cards, gloo on their CPUs). The coordinator
address is one endpoint chosen on the driver, so no NIC intersection is
needed.

Import-gated: PySpark is optional, and ``run``/``run_elastic`` raise a
clear error without it. The estimators (:mod:`.torch`, :mod:`.keras`)
train from a pandas DataFrame without it.
"""

import os
import socket
import sys
from typing import Any, Callable, List, Optional


def _require_pyspark():
    try:
        import pyspark  # noqa: F401
        return pyspark
    except ImportError as e:
        raise ImportError(
            "horovod_tpu_torch.spark requires pyspark, which is not "
            "installed in this environment. Install pyspark, or use "
            "horovod_tpu_torch.runner.run() or python -m "
            "horovod_tpu_torch.runner for non-Spark clusters."
        ) from e


def _run_barrier_stage(fn: Callable, args, kwargs, num_proc: int,
                       extra_env: dict, verbose: bool) -> List[Any]:
    """One barrier-mode Spark stage running ``fn`` on ``num_proc`` workers
    (the body of ``run()``; also one elastic *generation* for
    ``run_elastic``)."""
    from pyspark import BarrierTaskContext
    from pyspark.sql import SparkSession

    from ..runner.api import _dumps
    from ..runner.launch import free_port
    from ..runner.rendezvous import RendezvousServer

    spark = SparkSession.builder.getOrCreate()
    sc = spark.sparkContext

    driver_host = socket.gethostname()
    server = RendezvousServer(verbose=verbose)
    port = server.start()
    # the process group's TCP store runs inside the rank-0 WORKER
    # (executor), whose host is unknown until the barrier stage runs;
    # tasks discover it from BarrierTaskContext.getTaskInfos(). The driver
    # only fixes the port number (a collision on the executor is retried
    # by Spark's stage retry).
    coordinator_port = free_port()
    payload = _dumps((fn, tuple(args), kwargs or {}))
    server.put("run_func", "func", payload)
    extra_env = dict(extra_env)

    def task(_):
        ctx = BarrierTaskContext.get()
        rank = ctx.partitionId()
        infos = ctx.getTaskInfos()  # ordered by partition id
        hosts = [i.address.rsplit(":", 1)[0] for i in infos]
        # local/cross topology from real co-location (reference:
        # hosts.py:106-155 computes the same from the host plan)
        my_host = hosts[rank]
        same_host = [i for i, h in enumerate(hosts) if h == my_host]
        local_rank = same_host.index(rank)
        cross_hosts = sorted(set(hosts))
        os.environ.update(extra_env)
        os.environ["HVD_TPU_RANK"] = str(rank)
        os.environ["HVD_TPU_SIZE"] = str(num_proc)
        os.environ["HVD_TPU_LOCAL_RANK"] = str(local_rank)
        os.environ["HVD_TPU_LOCAL_SIZE"] = str(len(same_host))
        os.environ["HVD_TPU_CROSS_RANK"] = str(cross_hosts.index(my_host))
        os.environ["HVD_TPU_CROSS_SIZE"] = str(len(cross_hosts))
        os.environ["HVD_TPU_HOSTNAME"] = my_host
        os.environ["HVD_TPU_COORDINATOR_ADDR"] = \
            f"{hosts[0]}:{coordinator_port}"
        os.environ["HVD_TPU_RENDEZVOUS_ADDR"] = driver_host
        os.environ["HVD_TPU_RENDEZVOUS_PORT"] = str(port)
        # barrier so every executor has the env before rank 0 opens the
        # coordinator
        ctx.barrier()
        from ..runner import run_task
        result = run_task.execute_from_store(rank)
        yield rank, result

    try:
        results = (
            sc.parallelize(range(num_proc), num_proc)
            .barrier()
            .mapPartitions(task)
            .collect())
    finally:
        server.stop()
    return [r for _, r in sorted(results)]


def run(fn: Callable, args=(), kwargs=None, num_proc: Optional[int] = None,
        env: Optional[dict] = None, verbose: bool = False) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` as a distributed horovod_tpu_torch job
    with one worker per Spark executor; returns per-rank results ordered by
    rank (reference: spark/runner.py:47-193). ``fn`` calls
    ``horovod_tpu_torch.init()`` itself.
    """
    _require_pyspark()
    if num_proc is None:
        from pyspark.sql import SparkSession
        sc = SparkSession.builder.getOrCreate().sparkContext
        num_proc = max(int(sc.defaultParallelism), 1)
    return _run_barrier_stage(fn, args, kwargs, num_proc, dict(env or {}),
                              verbose)


def _spark_available_parallelism() -> int:
    from pyspark.sql import SparkSession
    sc = SparkSession.builder.getOrCreate().sparkContext
    # live executor cores; defaultParallelism tracks registered executors
    # on dynamic-allocation clusters, so a dead executor shrinks the next
    # generation (the Spark analogue of the discovery script's host list)
    return max(int(sc.defaultParallelism), 1)


def run_elastic(fn: Callable, args=(), kwargs=None,
                num_proc: Optional[int] = None, min_np: Optional[int] = None,
                max_np: Optional[int] = None, reset_limit: int = 3,
                env: Optional[dict] = None, verbose: bool = False,
                state_dir: Optional[str] = None,
                _submit_attempt: Optional[Callable] = None,
                _available_parallelism: Optional[Callable] = None
                ) -> List[Any]:
    """Elastic training on Spark (reference: spark/runner.py:303+
    ``run_elastic``), redesigned around Spark's failure unit.

    Spark barrier stages are all-or-nothing: when one barrier task dies the
    whole stage is torn down. So a *stage attempt = one elastic
    generation*, and the elastic loop lives on the driver:

    1. every attempt sizes the world from current executor liveness,
       clamped to [min_np, max_np] (the reference's host-discovery role);
    2. workers run with the durable-commit contract of
       :mod:`horovod_tpu_torch.elastic` (``HVD_TPU_ELASTIC_STATE_DIR`` +
       job id): every ``state.commit()`` persists, and a retried
       generation's workers restore the last commit before
       ``state.sync()``, the rank-kill recovery path of the port's
       launcher with Spark's scheduler playing the respawner;
    3. a failed attempt (barrier task death, executor loss) is retried up
       to ``reset_limit`` times (reference: --reset-limit semantics).

    ``state_dir`` must point at storage reachable by re-scheduled tasks
    (any path in local mode; shared storage on a cluster). ``fn`` should
    drive its loop through an ``hvd.elastic.State`` and ``commit()``; a
    plain fn still works but restarts from scratch on retry.

    ``_submit_attempt(num_proc, attempt_env)``/``_available_parallelism()``
    are dependency-injection points for the pyspark-free unit tests (and
    would allow other barrier schedulers to reuse the loop).
    """
    if _submit_attempt is None:
        _require_pyspark()
        submit = lambda n, e: _run_barrier_stage(  # noqa: E731
            fn, args, kwargs, n, e, verbose)
        avail = _available_parallelism or _spark_available_parallelism
    else:
        submit = _submit_attempt
        avail = _available_parallelism or (lambda: num_proc or 1)

    import logging
    import tempfile
    import uuid
    log = logging.getLogger("horovod_tpu_torch.spark")

    min_np = int(min_np or 1)
    own_state_dir = None
    if state_dir is None:
        state_dir = own_state_dir = tempfile.mkdtemp(
            prefix="hvd_tpu_spark_elastic_")
    job_id = uuid.uuid4().hex[:12]
    base_env = dict(env or {})
    base_env["HVD_TPU_ELASTIC_STATE_DIR"] = state_dir
    base_env["HVD_TPU_ELASTIC_JOB_ID"] = job_id

    last_error: Optional[BaseException] = None
    try:
        for attempt in range(reset_limit + 1):
            live = int(avail())
            n = num_proc if attempt == 0 and num_proc else live
            if max_np:
                n = min(n, int(max_np))
            n = max(n, 1)
            if n < min_np:
                raise RuntimeError(
                    f"elastic job needs at least {min_np} workers but only "
                    f"{n} are available (attempt {attempt})")
            if attempt:
                log.warning(
                    "spark elastic: generation %d failed (%s); retrying "
                    "with %d workers", attempt - 1, last_error, n)
            try:
                return submit(n, dict(base_env))
            except Exception as e:  # noqa: BLE001 — stage/job abort
                last_error = e
        raise RuntimeError(
            f"spark elastic job failed after {reset_limit + 1} "
            f"generations") from last_error
    finally:
        if own_state_dir:
            import shutil
            shutil.rmtree(own_state_dir, ignore_errors=True)
