"""Worker-side elastic retry loop and world reset.

Counterpart of ``horovod_tpu/elastic/run.py`` (reference:
common/elastic.py run_fn:147-168, the sync -> train -> catch ->
restore/reset loop; torch/elastic.py:46-49, reset = ``hvd.shutdown();
hvd.init()``).

**The reset, in-process.** The JAX package re-execs its worker, because
XLA cannot initialise its distributed runtime twice in one process.
torch.distributed can, so the port takes the reference's design, and it is
the only path (there is no re-exec):

1. ``checkpointing.drain_all()``: async checkpoint saves land or fail
   visibly before the world goes away;
2. ``basics.shutdown()``: the dispatcher thread and the stall inspector
   stop (handles still pending fail with HorovodInternalError), the
   process group is destroyed, or on NCCL aborted when a wire call failed
   (its communicators may hold a call no peer will answer);
3. :func:`requery_assignment`: one blocking GET of
   ``rank_and_size/hostname:local_rank`` (the driver holds it until the
   next generation has formed) refreshes the rank env, and the
   ``coordinator`` scope gives the address of the new generation's TCP
   store, which the new rank 0 listens on;
4. ``basics.init()`` on the new world, on the same kind of device (the
   card of this slot, or the CPU when the old world ran there), with the
   old world's configuration overrides;
5. ``state.sync()``, at the top of the retry loop: rank 0's state reaches
   the survivors and the workers that just joined.

Exactly as in the JAX package: a worker whose host has no slot in the new
generation persists its last commit and exits 0; every ``commit()``
persists the committed snapshot to ``HVD_TPU_ELASTIC_STATE_DIR`` (the
durable commit), which :func:`maybe_load_persisted_state` reloads in a
worker the driver respawned after a hard kill; every reset counts
``hvd_tpu_worker_restarts_total``. Outside an elastic launch (no
rendezvous in the env) the reset is ``shutdown(); init()`` at the same
identity.

Anything not stored in the State object does not survive a reset, the
reference's contract too. A process that holds other process groups
(process sets, a training mesh) makes them again after the reset.

One consequence of the in-process design, the reference's too: a script
issues no collective between ``init()`` and the wrapped function (no
``broadcast_parameters`` at start-up). A worker that joins a running
job runs the script from the top, while the survivors re-enter at
``state.sync()``; the first collectives they issue must be the same ones.
``sync()`` is where rank 0's state reaches everyone. (The JAX package's
re-exec runs every worker from the top, so its scripts may.)
"""

import functools
import logging
import os
import pickle
import sys

from .. import config as _config
from .. import metrics as _metrics
from ..exceptions import HorovodInternalError, HostsUpdatedInterrupt
from .worker import notification_manager

log = logging.getLogger("horovod_tpu_torch.elastic")

_M_RESTARTS = _metrics.counter(
    "hvd_tpu_worker_restarts_total",
    "Elastic worker resets taken by this process (in-process "
    "shutdown + init into a new generation).")

RANK_ENV = ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_LOCAL_RANK",
            "HVD_TPU_LOCAL_SIZE", "HVD_TPU_CROSS_RANK", "HVD_TPU_CROSS_SIZE")
#: Job-scoped directory (set by the elastic launcher) where every commit()
#: persists the committed snapshot. A worker hard-killed (a crash, or
#: NCCL's watchdog ending a survivor of a peer's death) keeps no memory, so
#: durability is paid at commit time; the reference's survivors keep their
#: committed state in memory because the process survives
#: (common/elastic.py:60-101).
STATE_DIR_ENV = "HVD_TPU_ELASTIC_STATE_DIR"


def _rendezvous_client(timeout: float = 24 * 3600.0):
    from ..runner.rendezvous import KVStoreClient
    addr = os.environ.get("HVD_TPU_RENDEZVOUS_ADDR")
    if not addr:
        return None
    port = int(os.environ.get("HVD_TPU_RENDEZVOUS_PORT", 0))
    # The rank_and_size GET blocks server-side until the next generation
    # forms, so the client timeout must cover the elastic timeout.
    return KVStoreClient(addr, port, timeout=timeout)


def requery_assignment() -> bool:
    """Refresh this worker's rank env vars from the rendezvous.

    Returns False when this worker has no slot in the new generation (its
    host was removed) — the caller should exit cleanly. No-op (True) in
    non-elastic runs.
    """
    client = _rendezvous_client()
    if client is None:
        return True
    hostname = os.environ.get("HVD_TPU_HOSTNAME", "")
    local_rank = os.environ.get("HVD_TPU_LOCAL_RANK", "0")
    blob = client.get("rank_and_size", f"{hostname}:{local_rank}")
    if blob is None:
        raise HorovodInternalError(
            "rendezvous did not return a rank assignment")
    fields = [int(x) for x in blob.decode().split(",")]
    if fields[0] < 0:
        return False
    for env_name, value in zip(RANK_ENV, fields):
        os.environ[env_name] = str(value)
    coord = client.get("coordinator", "addr")
    if coord:
        os.environ["HVD_TPU_COORDINATOR_ADDR"] = coord.decode()
    return True


def fetch_mesh_shape() -> "dict | None":
    """The driver's published mesh plan (axis -> size), or None.

    Workers call this after :func:`requery_assignment` (or at startup)
    to learn the mesh the new generation should re-form — the driver's
    :meth:`ElasticDriver._replan_mesh` publishes it to the journaled
    ``mesh`` scope *before* the blocking rank_and_size GET returns, so
    a worker that has its new rank can always read the matching shape.
    None outside elastic launches, when the mesh plane is off
    (``HVD_TPU_MESH_SHAPE`` unset), or on any fetch failure — callers
    fall back to their local mesh construction.
    """
    client = _rendezvous_client(timeout=5.0)
    if client is None:
        return None
    try:
        blob = client.get("mesh", "shape")
    except Exception:
        return None
    if not blob:
        return None
    import json
    try:
        axes = json.loads(blob.decode()).get("axes")
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(axes, dict):
        return None
    try:
        return {str(a): int(v) for a, v in axes.items()}
    except (TypeError, ValueError):
        return None


def committed_state_path() -> "str | None":
    """This worker's durable commit file, or None outside elastic launches.

    The filename carries the launcher's job id so a reused (e.g. shared-
    storage) state dir can never hand a new job a previous job's final
    state.
    """
    d = os.environ.get(STATE_DIR_ENV)
    if not d:
        return None
    import socket
    hostname = os.environ.get("HVD_TPU_HOSTNAME") or socket.gethostname()
    local_rank = os.environ.get("HVD_TPU_LOCAL_RANK", "0")
    job = os.environ.get("HVD_TPU_ELASTIC_JOB_ID", "job")
    return os.path.join(d, f"state_{job}_{hostname}_{local_rank}.pkl")


def persist_committed_state(state) -> None:
    """Durably persist the committed snapshot (called from State.commit()).

    Atomic write+rename so a kill mid-commit leaves the previous commit
    intact. Strictly best-effort: persistence failures (unwritable dir,
    unpicklable user attribute, full disk) must never turn a commit that
    used to succeed into a training crash — recovery then degrades to the
    rank-0 broadcast, exactly the pre-durability behavior. No-op outside
    elastic launches (no STATE_DIR_ENV) or when
    HVD_TPU_ELASTIC_DURABLE_COMMITS=0 (opt-out for huge states committed
    every batch, where the synchronous pickle+write would dominate step
    time).
    """
    if not _config.Config().get(_config.ELASTIC_DURABLE_COMMITS):
        return
    path = committed_state_path()
    if not path:
        return
    saved = getattr(state, "_saved_state", None)
    if saved is None:
        return
    try:
        # Remote hosts may not have the launcher-created dir; best-effort
        # local persistence still covers same-host respawns. The
        # checkpointing layout helper gives tmp+fsync+rename, so a kill
        # mid-commit can never leave a torn state file (plain rename
        # without the fsync could surface an empty file after a host
        # crash — the exact window durable commits exist to close).
        from ..checkpointing.layout import atomic_write_bytes
        os.makedirs(os.path.dirname(path), exist_ok=True)
        atomic_write_bytes(path, pickle.dumps(saved))
    except Exception:  # noqa: BLE001 — durability is best-effort by contract
        log.warning("elastic: failed to persist committed state to %s",
                    path, exc_info=True)


def maybe_load_persisted_state(state) -> bool:
    """Reload this slot's durable commit file into ``state`` (a worker
    the driver respawned after its predecessor was hard-killed). A
    brand-new worker has none and gets state from the rank-0 broadcast in
    ``state.sync()``. (The JAX package reads its pre-exec snapshot first;
    the port does not re-exec.)"""
    commit_path = committed_state_path()
    if commit_path and os.path.exists(commit_path):
        try:
            with open(commit_path, "rb") as f:
                saved = pickle.load(f)
        except (OSError, pickle.UnpicklingError):
            log.warning("elastic: could not reload committed state from %s",
                        commit_path, exc_info=True)
            return False
        if hasattr(state, "_saved_state"):
            log.info("elastic: restored committed state from %s", commit_path)
            state._saved_state = saved
            state.restore()
            return True
    return False


def reset(state=None) -> None:
    """Tear down the world and come back up on the new membership, in
    this process (see the module docstring)."""
    from .. import basics
    from ..checkpointing import drain_all
    _M_RESTARTS.inc()
    old = basics.world()
    device = "cpu" if old.device.type == "cpu" else None
    overrides = dict(old.config._overrides)
    drain_all()
    basics.shutdown()
    if not requery_assignment():
        # No slot in the new generation: this host was removed (drained
        # after a preemption notice, or scaled away). Leave the last
        # commit durably on disk and retire the notification plane, so
        # the driver sees a clean exit.
        if state is not None:
            persist_committed_state(state)
        notification_manager.shutdown()
        log.info("elastic: this worker has no assignment in the new "
                 "generation; drain complete, exiting cleanly")
        sys.exit(0)
    log.info("elastic: re-initializing in-process for the new generation "
             "(rank=%s size=%s)", os.environ.get("HVD_TPU_RANK"),
             os.environ.get("HVD_TPU_SIZE"))
    notification_manager.set_rank(os.environ.get("HVD_TPU_RANK", "?"))
    basics.init(device=device, config_overrides=overrides)


def run_fn(func, reset_fn):
    """Wrap ``func(state, ...)`` in the elastic retry loop
    (reference common/elastic.py:147-168). ``reset_fn(state)`` re-forms
    the world between attempts."""

    @functools.wraps(func)
    def wrapper(state, *args, **kwargs):
        notification_manager.init()
        notification_manager.register_listener(state)
        maybe_load_persisted_state(state)
        try:
            while True:
                state.sync()
                try:
                    return func(state, *args, **kwargs)
                except HorovodInternalError:
                    log.warning("elastic: caught HorovodInternalError; "
                                "restoring committed state", exc_info=True)
                    state.restore()
                except HostsUpdatedInterrupt:
                    log.info("elastic: hosts updated; re-initializing")
                reset_fn(state)
                state.on_reset()
        finally:
            notification_manager.remove_listener(state)

    return wrapper


def run(func):
    """Decorator for elastic training functions::

        @hvd.elastic.run
        def train(state, ...):
            ...
    """
    return run_fn(func, reset)
