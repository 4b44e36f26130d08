"""World state: init/shutdown, rank and size, and the device the port runs
on (counterpart of ``horovod_tpu/basics.py``).

``init()`` always creates a ``torch.distributed`` process group, even for a
single process, so every collective goes through the real wire: NCCL on a
CUDA device, gloo on the CPU. Identity comes from arguments or the same env
contract as the JAX package — ``HVD_TPU_COORDINATOR_ADDR`` (host:port of
the rendezvous), ``HVD_TPU_RANK`` and ``HVD_TPU_SIZE``. Without them the
process is a world of one, rendezvousing with itself on a free localhost
port. ``init(process_sets=...)`` makes one process group per set
(:mod:`.mesh`); the host services — the collective dispatcher thread, the
stall inspector, and the telemetry (logging, the metrics endpoint, the
timeline) — start with the world and stop with ``shutdown()``.
With ``HVD_TPU_AUTOTUNE`` set, ``init()`` also makes the fusion-threshold
autotuner (:mod:`.parameter_manager`) that ``DistributedOptimizer``
feeds.

The port runs on CUDA unless the caller asks for the CPU
(``device="cpu"``); with no card and no such request, entry points raise.

Two bounds, from the JAX package's knobs: the rendezvous (every rank
reaching the TCP store rank 0 hosts) waits at most
``INIT_TIMEOUT_SECONDS``; every wire call of the process group waits at
most ``HEARTBEAT_TIMEOUT_SECONDS`` for its peers (:func:`wire_timeout`),
so a dead or wedged peer fails the survivors' next call instead of
blocking them for torch's default (30 min on gloo, 10 on NCCL). The
elastic reset (``elastic/run.py``) relies on both: it calls
:func:`shutdown` and :func:`init` again in the same process. A world
whose wire calls failed (:func:`mark_failed`) is aborted, not destroyed,
on NCCL: its communicators may still hold a call no peer will answer.

Rank semantics follow the reference's one-process-per-GPU model: a
process drives one device, so ``device_count()`` is the world size and
``local_device_count()`` is 1. ``init(comm=)`` (an mpi4py communicator)
is not ported.
"""

import dataclasses
import datetime
import socket
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from . import config as _config
from . import metrics as _metrics
from .exceptions import NotInitializedError

_M_INITS = _metrics.counter(
    "hvd_tpu_init_total",
    "hvd.init() completions (elastic resets re-init, so a climbing count "
    "on a long-lived process is a reset-rate signal).")
_M_SHUTDOWNS = _metrics.counter(
    "hvd_tpu_shutdown_total", "hvd.shutdown() completions.")
_M_WORLD_SIZE = _metrics.gauge(
    "hvd_tpu_world_size", "Process count of the current world.")


@dataclasses.dataclass
class World:
    config: _config.Config
    device: torch.device
    backend: str
    rank: int
    size: int
    #: the world's process group (mesh.WorldMesh) and the process sets
    #: made at init, by index
    world_mesh: Any = None
    process_sets: Dict[int, Any] = dataclasses.field(default_factory=dict)
    #: True once this process has join()ed: it contributes zeros
    joined: bool = False
    stall_inspector: Any = None
    #: the collective dispatcher thread (collectives.py), made on first use
    dispatcher: Any = None
    #: host-plane state of collectives.py: the named-tensor table, the
    #: response cache, the consistency exchange's lock and sequence
    #: number, the auto-name counter and Join's round logs
    tensor_table: Any = None
    response_cache: Any = None
    consistency_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock)
    consistency_seq: int = 0
    name_counter: int = 0
    join_round_log: List[tuple] = dataclasses.field(default_factory=list)
    join_last_round: List[tuple] = dataclasses.field(default_factory=list)
    join_active_rounds: int = 0
    #: the TCP store of the process group (rank 0 listens on it)
    store: Any = None
    #: True once a wire call failed (mark_failed): shutdown() aborts
    failed: bool = False
    #: the fusion-threshold autotuner (parameter_manager.py), made at init
    #: when HVD_TPU_AUTOTUNE is set
    parameter_manager: Any = None
    #: the chrome-tracing timeline (timeline.py; NULL_TIMELINE unless
    #: HVD_TPU_TIMELINE is set on process 0) and the metrics endpoint
    timeline: Any = None
    metrics_server: Any = None
    #: the compiled-plane reduction's groups (mesh.py): the ("cross",
    #: "local") DeviceMesh and the flattened groups, made once per world
    groups: Dict[Any, Any] = dataclasses.field(default_factory=dict)
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)


_world: Optional[World] = None
_lock = threading.Lock()


def _local_rank(cfg: _config.Config) -> int:
    v = cfg.get(_config.LOCAL_RANK)
    return v if v >= 0 else 0


def resolve_device(device=None, cfg: Optional[_config.Config] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda:<local_rank>`` when
    ``device`` is None, else ``device`` itself ("cpu", "cuda:1", "meta").
    Raises when CUDA is asked for, or defaulted to, and there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "horovod_tpu_torch runs on a CUDA device unless asked "
                "otherwise, and no CUDA device is available; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda", _local_rank(cfg or _config.Config()))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} asked for, but no CUDA device "
                               f"is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: listens tried on ports of our own choosing before init() gives up
_STORE_PORT_TRIES = 5


def _tcp_store(host, port, n, pid, timeout):
    """The world's TCPStore. With ``port`` None (a world of one), the
    port is chosen here, and one that another socket took between the
    choice and the store's listen (EADDRINUSE, seen on an elastic reset
    on the card) is chosen again, up to ``_STORE_PORT_TRIES`` times."""
    if port is not None:
        return dist.TCPStore(host, int(port), world_size=n,
                             is_master=pid == 0, timeout=timeout)
    for attempt in range(_STORE_PORT_TRIES):
        try:
            return dist.TCPStore(host, _free_port(), world_size=1,
                                 is_master=True, timeout=timeout)
        except dist.DistNetworkError as e:
            if "EADDRINUSE" not in str(e) \
                    or attempt == _STORE_PORT_TRIES - 1:
                raise


def init(process_sets: Optional[Sequence[Sequence[int]]] = None,
         device=None, coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         config_overrides: Optional[dict] = None) -> None:
    """Initialize horovod_tpu_torch: resolve identity, pick the device,
    create the process group and one group per entry of
    ``process_sets`` (lists of ranks; retrieve with
    :func:`process_set_mesh`), and start the stall inspector. A second
    call is a no-op until :func:`shutdown`."""
    global _world
    with _lock:
        if _world is not None:
            return
        cfg = _config.Config(config_overrides)
        # a malformed HVD_TPU_FAULT_SPEC fails here, not mid-training
        from . import faults
        faults.ensure_configured()
        dev = resolve_device(device, cfg)
        if dev.type == "meta":
            raise ValueError("init() needs a real device, not meta")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if dist.is_initialized():
            raise RuntimeError("torch.distributed is already initialized; "
                               "horovod_tpu_torch.init() creates its own "
                               "process group")
        addr = coordinator_address or cfg.get(_config.COORDINATOR_ADDR)
        n = num_processes if num_processes is not None \
            else cfg.get(_config.SIZE)
        pid = process_id if process_id is not None \
            else cfg.get(_config.RANK)
        if addr and n > 1:
            if not 0 <= pid < n:
                raise ValueError(f"rank {pid} out of range for world size "
                                 f"{n}: set HVD_TPU_RANK")
            host, _, port = addr.rpartition(":")
        else:
            n, pid = 1, 0
            host, port = "127.0.0.1", None
        store = _tcp_store(host, port, n, pid, datetime.timedelta(
            seconds=cfg.get(_config.INIT_TIMEOUT_SECONDS)))
        kwargs = {"device_id": dev} if dev.type == "cuda" else {}
        dist.init_process_group(
            backend, store=store, world_size=n, rank=pid,
            timeout=datetime.timedelta(seconds=wire_timeout(cfg)),
            **kwargs)
        from .mesh import WorldMesh
        from .response_cache import ResponseCache
        from .stall import StallInspector
        from .tensor_table import TensorTable
        w = World(config=cfg, device=dev, backend=backend, rank=pid, size=n,
                  store=store)
        w.tensor_table = TensorTable(w)
        w.response_cache = ResponseCache(cfg.get(_config.CACHE_CAPACITY))
        w.world_mesh = WorldMesh(range(n))
        # every process makes every set, in list order (dist.new_group is
        # collective over the whole world)
        for i, ranks in enumerate(process_sets or ()):
            w.process_sets[i] = w.world_mesh.subset(list(ranks))
        from .logging_setup import configure as _configure_logging
        _configure_logging(cfg)
        # the metrics gate and endpoint come up before the other host
        # services so that their own startup telemetry is captured
        w.metrics_server = _metrics.configure(w)
        _M_INITS.inc()
        _M_WORLD_SIZE.set(n)
        from .timeline import maybe_start_timeline
        w.timeline = maybe_start_timeline(w)
        w.stall_inspector = StallInspector(w)
        from .parameter_manager import maybe_create as _maybe_autotune
        w.parameter_manager = _maybe_autotune(w)
        _world = w


def wire_timeout(cfg: Optional[_config.Config] = None) -> float:
    """Seconds a wire call waits for its peers: HEARTBEAT_TIMEOUT_SECONDS,
    or when that is negative (auto) 60 under an elastic launch and 100
    otherwise (see the knob's help)."""
    cfg = cfg or _config.Config()
    t = cfg.get(_config.HEARTBEAT_TIMEOUT_SECONDS)
    if t < 0:
        t = 60.0 if cfg.get(_config.ELASTIC) else 100.0
    return float(t)


def mark_failed() -> None:
    """Record that a wire call of this world failed, so that
    :func:`shutdown` aborts the process group instead of destroying it."""
    w = _world
    if w is not None:
        w.failed = True


def shutdown() -> None:
    """Stop the dispatcher thread and the stall inspector and tear down
    the process groups: destroyed, or on NCCL aborted when a wire call
    failed, and drop torch.compile's compiled graphs. Safe to call twice;
    init() may be called again after it."""
    global _world
    with _lock:
        w = _world
        if w is None:
            return
        if w.dispatcher is not None:
            w.dispatcher.stop()
        w.timeline.close()
        w.stall_inspector.stop()
        # drop the collective schedule ledger so an elastic reset's next
        # generation restarts at sequence 0 on every rank
        from . import _schedule
        _schedule.reset()
        _metrics.stop_http_server(w.metrics_server)
        w.metrics_server = None
        _M_SHUTDOWNS.inc()
        _world = None
        # a compiled graph holds this world's group, size, rank and config
        # as constants (collectives' in-jit route), unguarded: drop every
        # compiled graph, so that a call after the next init() traces
        # again against that world
        if "torch._dynamo" in sys.modules:
            torch.compiler.reset()
        if w.failed and w.backend == "nccl":
            from torch.distributed import distributed_c10d
            distributed_c10d._abort_process_group()
        else:
            dist.destroy_process_group()
        w.store = None   # close rank 0's listening socket now, even if a
        #                  caller still holds the old World


def is_initialized() -> bool:
    return _world is not None


def world() -> World:
    w = _world
    if w is None:
        raise NotInitializedError()
    return w


def rank() -> int:
    return world().rank


def size() -> int:
    return world().size


def local_rank() -> int:
    return _local_rank(world().config)


def local_size() -> int:
    v = world().config.get(_config.LOCAL_SIZE)
    return v if v >= 0 else 1


def device() -> torch.device:
    """The device this process's collectives and training run on."""
    return world().device


def cross_rank() -> int:
    v = world().config.get(_config.CROSS_RANK)
    return v if v >= 0 else world().rank


def cross_size() -> int:
    v = world().config.get(_config.CROSS_SIZE)
    return v if v >= 0 else world().size


def device_count() -> int:
    """Devices across the world: one per process."""
    return world().size


def local_device_count() -> int:
    """Devices this process drives: one."""
    world()
    return 1


def dp_size() -> int:
    """Data-parallel width: one device per process, so the world size."""
    return world().size


def current_mesh():
    """The ``torch.distributed`` DeviceMesh entered last (``with
    mesh:``), or None. Read in a function that ``torch.compile`` traces,
    it becomes part of the compiled graph's guards, so the same function
    under another mesh compiles anew."""
    from torch.distributed.device_mesh import _mesh_resources
    stack = _mesh_resources.mesh_stack
    return stack[-1] if stack else None


def mapped_axis_sizes() -> dict:
    """``{dim name: size}`` of the DeviceMesh in scope (``with mesh:``)
    while ``torch.compile`` traces, outermost dim first: the counterpart
    of the JAX package's mapped axes of a ``shard_map`` trace, which the
    in-jit route of the collective verbs (collectives.py) lowers over.
    Empty when called eagerly or with no mesh in scope; dims without a
    name are left out."""
    if not torch.compiler.is_compiling():
        return {}
    mesh = current_mesh()
    if mesh is None:
        return {}
    return {name: mesh.size(i)
            for i, name in enumerate(mesh.mesh_dim_names or ())}


def mapped_axes() -> tuple:
    """Names of the mapped mesh dims in scope, outermost first (empty
    eagerly or with no mesh in scope)."""
    return tuple(mapped_axis_sizes())


def is_homogeneous() -> bool:
    """True when every process drives the same number of devices (one
    each, always, in this port)."""
    world()
    return True


def process_set_mesh(i: int):
    """The process set ``i`` registered at init() (a :class:`WorldMesh`
    to pass as ``process_set=`` to a collective)."""
    return world().process_sets[i]


def hostname() -> str:
    return world().config.get(_config.HOSTNAME) or socket.gethostname()


# -- capability queries (reference: basics.py:140-215) ------------------------
def xla_built() -> bool:
    return False


def tpu_available() -> bool:
    return False


def mpi_built() -> bool:
    return False


def mpi_enabled() -> bool:
    return False


def gloo_built() -> bool:
    return dist.is_gloo_available()


def nccl_built() -> bool:
    return dist.is_nccl_available()


def ccl_built() -> bool:
    return False


def ddl_built() -> bool:
    return False


def cuda_built() -> bool:
    return torch.backends.cuda.is_built()


def rocm_built() -> bool:
    return torch.version.hip is not None


def mpi_threads_supported() -> bool:
    return False
