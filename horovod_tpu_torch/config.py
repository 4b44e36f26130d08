"""Environment knobs read by horovod_tpu_torch.

The subset of ``horovod_tpu/config.py`` that the port reads, with the same
``HVD_TPU_*`` names, ``HOROVOD_*`` aliases and defaults, so one environment
drives both packages. Resolution order is the same: programmatic override,
then ``HVD_TPU_<NAME>``, then the alias, then the default (an unparsable
value falls back to the default).
"""

import dataclasses
import os
import re
from typing import Any, Callable, Dict, Optional


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str                       # HVD_TPU_<NAME>
    default: Any
    parser: Callable[[str], Any]
    alias: Optional[str] = None
    help: str = ""


_REGISTRY: Dict[str, Knob] = {}


def _register(name, default, parser, alias=None, help=""):
    _REGISTRY[name] = Knob(name, default, parser, alias, help)
    return name


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


FUSION_THRESHOLD = _register(
    "FUSION_THRESHOLD", 64 * 1024 * 1024, int, alias="HOROVOD_FUSION_THRESHOLD",
    help="Gradient-bucket fusion threshold in bytes (0 disables fusion).")
PACK_CUTOFF = _register(
    "PACK_CUTOFF", 256 * 1024, int,
    help="The JAX package's host-packing cutoff for grouped collectives. "
         "The port's grouped allreduce packs every member into one "
         "buffer, so nothing here reads it; the autotuner "
         "(parameter_manager.py) still tunes it as its second phase, so "
         "its schedule is the JAX package's.")
INJIT_PACKED_THRESHOLD = _register(
    "INJIT_PACKED_THRESHOLD", 64 * 1024 * 1024, int,
    help="Bucket cap in bytes for the packed buffers of the compiled-plane "
         "reduction (DistributedOptimizer(axis_name=..., "
         "packing='packed')): gradients are concatenated per dtype into "
         "flat buffers of at most this many bytes, one wire call per "
         "buffer. 0 packs each dtype into a single unbounded buffer.")
RANK = _register("RANK", -1, int, alias="HOROVOD_RANK")
SIZE = _register("SIZE", -1, int, alias="HOROVOD_SIZE")
LOCAL_RANK = _register("LOCAL_RANK", -1, int, alias="HOROVOD_LOCAL_RANK")
LOCAL_SIZE = _register("LOCAL_SIZE", -1, int, alias="HOROVOD_LOCAL_SIZE")
COORDINATOR_ADDR = _register(
    "COORDINATOR_ADDR", "", str, alias="HOROVOD_GLOO_RENDEZVOUS_ADDR",
    help="host:port of the rendezvous (the torch.distributed TCP store).")
CROSS_RANK = _register("CROSS_RANK", -1, int, alias="HOROVOD_CROSS_RANK")
CROSS_SIZE = _register("CROSS_SIZE", -1, int, alias="HOROVOD_CROSS_SIZE")
HOSTNAME = _register("HOSTNAME", "", str, alias="HOROVOD_HOSTNAME")
CACHE_CAPACITY = _register(
    "CACHE_CAPACITY", 1024, int, alias="HOROVOD_CACHE_CAPACITY",
    help="Capacity of the response cache (consistency-exchange "
         "fingerprints; 0 disables, reference HOROVOD_CACHE_CAPACITY).")
STALL_CHECK_DISABLE = _register(
    "STALL_CHECK_DISABLE", False, _parse_bool,
    alias="HOROVOD_STALL_CHECK_DISABLE")
STALL_CHECK_TIME_SECONDS = _register(
    "STALL_CHECK_TIME_SECONDS", 60.0, float,
    alias="HOROVOD_STALL_CHECK_TIME_SECONDS")
STALL_SHUTDOWN_TIME_SECONDS = _register(
    "STALL_SHUTDOWN_TIME_SECONDS", 0.0, float,
    alias="HOROVOD_STALL_SHUTDOWN_TIME_SECONDS")
CHECK_CONSISTENCY = _register(
    "CHECK_CONSISTENCY", True, _parse_bool,
    help="Cross-process validation of name/shape/dtype for eager "
         "collectives; the response cache makes the steady-state cost one "
         "cached lookup. Set HVD_TPU_CHECK_CONSISTENCY=0 to disable.")
LOCK_CHECK = _register(
    "LOCK_CHECK", False, _parse_bool,
    help="Enable the runtime lock-order sentinel (_locks.py).")
MESH_RESHAPE_POLICY = _register(
    "MESH_RESHAPE_POLICY", "shrink", str,
    help="How parallel.mesh_utils.plan_reshape re-forms the mesh when the "
         "survivor count changes: 'shrink' (default) shrinks dp first, then "
         "fsdp, never the inner pp/ep/sp/tp axes, and raises MeshShapeError "
         "when survivors don't divide into whole inner groups; 'degrade' "
         "additionally drops a remainder (whole dp replica groups' worth "
         "of capacity idles) instead of aborting; 'strict' refuses any "
         "shape change (a lost host fails the job).")

INIT_TIMEOUT_SECONDS = _register(
    "INIT_TIMEOUT_SECONDS", 300.0, float,
    alias="HOROVOD_GLOO_TIMEOUT_SECONDS",
    help="Timeout for distributed initialization / re-rendezvous.")
FAULT_SPEC = _register(
    "FAULT_SPEC", "", str,
    help="Deterministic fault-injection spec, ';'-separated "
         "site:kind[:param=value...] entries (e.g. "
         "'rendezvous.get:error:rate=0.3;worker.step:crash:step=12'). "
         "Empty (default) disables injection entirely; see "
         "docs/robustness.md for the grammar.")
FAULT_SEED = _register(
    "FAULT_SEED", 0, int,
    help="Seed for every probabilistic fault-injection decision. The same "
         "seed + spec + call sequence reproduces the same faults on every "
         "run and every process.")
CHECKPOINT_MAX_INFLIGHT = _register(
    "CHECKPOINT_MAX_INFLIGHT", 2, int,
    help="Bound on async checkpoint saves snapshotted but not yet "
         "persisted. A training loop that outruns storage blocks in "
         "save() once the queue is full (backpressure) instead of "
         "accumulating unbounded host-RAM copies of the model.")
CHECKPOINT_KEEP = _register(
    "CHECKPOINT_KEEP", 0, int,
    help="Retention GC: keep the last N completed checkpoint steps, "
         "deleting superseded ones from the background writer after "
         "each commit. 0 (default) keeps everything. Composes with "
         "HVD_TPU_CHECKPOINT_KEEP_PERIOD (a step survives if either "
         "rule wants it); the newest step always survives.")
CHECKPOINT_KEEP_PERIOD = _register(
    "CHECKPOINT_KEEP_PERIOD", 0, int,
    help="Retention GC: steps divisible by this period are kept forever "
         "(milestone checkpoints for offline eval), regardless of "
         "HVD_TPU_CHECKPOINT_KEEP. 0 (default) disables the rule.")


# -- The launcher and elastic training (runner/, elastic/): the same names,
#    aliases and defaults as horovod_tpu/config.py. The launcher writes the
#    first group from its flags (runner/config_parser.py). The AUTOTUNE*
#    knobs are read by parameter_manager.py; CYCLE_TIME, LOG_LEVEL and
#    TIMELINE* wait for the port's timeline (ROADMAP A4). ----------------
CYCLE_TIME = _register(
    "CYCLE_TIME", 1.0, float, alias="HOROVOD_CYCLE_TIME",
    help="Async-coordinator cycle time in milliseconds.")
LOG_LEVEL = _register(
    "LOG_LEVEL", "warning", str, alias="HOROVOD_LOG_LEVEL",
    help="trace/debug/info/warning/error/fatal.")
TIMELINE = _register(
    "TIMELINE", "", str, alias="HOROVOD_TIMELINE",
    help="Path for chrome://tracing JSON timeline (rank 0 only).")
TIMELINE_MARK_CYCLES = _register(
    "TIMELINE_MARK_CYCLES", False, _parse_bool,
    alias="HOROVOD_TIMELINE_MARK_CYCLES")
AUTOTUNE = _register(
    "AUTOTUNE", False, _parse_bool, alias="HOROVOD_AUTOTUNE")
AUTOTUNE_LOG = _register(
    "AUTOTUNE_LOG", "", str, alias="HOROVOD_AUTOTUNE_LOG")
AUTOTUNE_WARMUP_SAMPLES = _register(
    "AUTOTUNE_WARMUP_SAMPLES", 3, int, alias="HOROVOD_AUTOTUNE_WARMUP_SAMPLES")
AUTOTUNE_STEPS_PER_SAMPLE = _register(
    "AUTOTUNE_STEPS_PER_SAMPLE", 10, int,
    alias="HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE")
AUTOTUNE_BAYES_OPT_MAX_SAMPLES = _register(
    "AUTOTUNE_BAYES_OPT_MAX_SAMPLES", 20, int,
    alias="HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES")

# -- Rendezvous / world (reference env contract HOROVOD_RANK/SIZE/...,
#    gloo/gloo_context.cc:142-165, set by the launcher gloo_run.py:64-201) ---
RANK = _register("RANK", -1, int, alias="HOROVOD_RANK")
RENDEZVOUS_PORT = _register(
    "RENDEZVOUS_PORT", -1, int, alias="HOROVOD_GLOO_RENDEZVOUS_PORT",
    help="Port of the launcher's HTTP KV rendezvous server.")
RENDEZVOUS_ADDR = _register(
    "RENDEZVOUS_ADDR", "", str,
    help="Host of the launcher's HTTP KV rendezvous server.")
RENDEZVOUS_DIR = _register(
    "RENDEZVOUS_DIR", "", str,
    help="Directory for the KV rendezvous store's durable write-ahead "
         "journal + periodic snapshots. Empty (default) keeps the store "
         "in-memory only (the coordinator is then a single point of "
         "failure); set it to make the host plane crash-recoverable: a "
         "restarted coordinator replays snapshot+journal, bumps its "
         "epoch, and workers re-register instead of wedging on stale "
         "scoped keys (docs/robustness.md).")
RENDEZVOUS_SNAPSHOT_EVERY = _register(
    "RENDEZVOUS_SNAPSHOT_EVERY", 256, int,
    help="Journal appends between snapshot compactions of the rendezvous "
         "journal (HVD_TPU_RENDEZVOUS_DIR). Each compaction writes a full "
         "snapshot atomically and truncates the journal, bounding replay "
         "time after a coordinator crash. 0 disables compaction (the "
         "journal grows for the life of the job).")
ELASTIC = _register("ELASTIC", False, _parse_bool, alias="HOROVOD_ELASTIC")
ELASTIC_TIMEOUT = _register(
    "ELASTIC_TIMEOUT", 600.0, float, alias="HOROVOD_ELASTIC_TIMEOUT",
    help="Seconds the elastic driver waits for the minimum slot count "
         "before giving up (reference HOROVOD_ELASTIC_TIMEOUT).")
ELASTIC_DURABLE_COMMITS = _register(
    "ELASTIC_DURABLE_COMMITS", True, _parse_bool,
    help="Persist every elastic State.commit() to the job state dir so a "
         "hard-killed worker's respawn restores its last commit. Set 0 to "
         "skip the synchronous pickle+write for huge per-batch states "
         "(recovery then degrades to the rank-0 broadcast).")
HEARTBEAT_TIMEOUT_SECONDS = _register(
    "HEARTBEAT_TIMEOUT_SECONDS", -1.0, float,
    help="Bound on each wire call of the process group (the timeout= "
         "init() passes to torch.distributed): how long a surviving "
         "worker blocks on a dead or wedged peer before the call fails "
         "(gloo raises, which the verbs surface as HorovodInternalError; "
         "NCCL's watchdog aborts the communicator and, by default, ends "
         "the process). Default -1 = auto: 60 s under an elastic launch "
         "(a driver exists to respawn survivors; the bound still covers a "
         "healthy full-width step's skew between ranks: a first kernel "
         "build, a durable 1.3 GB commit) and 100 s otherwise, the JAX "
         "package's non-elastic value. The reference's analogous knob is "
         "HOROVOD_GLOO_TIMEOUT_SECONDS, gloo_context.cc:65-68, which here "
         "bounds the rendezvous (INIT_TIMEOUT_SECONDS).")
SHUTDOWN_TIMEOUT_SECONDS = _register(
    "SHUTDOWN_TIMEOUT_SECONDS", 60.0, float,
    help="Coordination-service shutdown barrier timeout of the JAX "
         "package; kept so one environment drives both packages (the "
         "port's shutdown has no barrier).")
HEARTBEAT_INTERVAL = _register(
    "HEARTBEAT_INTERVAL", 5.0, float,
    help="Seconds between host-plane heartbeat PUTs from each elastic "
         "worker to the rendezvous KV store (scope 'heartbeat'). 0 "
         "disables the heartbeat/liveness layer. Distinct from "
         "HVD_TPU_HEARTBEAT_TIMEOUT_SECONDS, which tunes the JAX "
         "data-plane coordination service: this layer lets the *launcher* "
         "detect a silently-hung worker (process alive, not "
         "participating) and blacklist its host without waiting for a "
         "stall deadline.")
HEARTBEAT_TIMEOUT = _register(
    "HEARTBEAT_TIMEOUT", 60.0, float,
    help="Seconds without a heartbeat after which the elastic driver "
         "declares a worker's host dead and triggers the existing "
         "blacklist -> re-rendezvous flow. Detection is bounded by "
         "timeout + one monitor poll (< 2x this value). Only armed once "
         "a worker's first beat arrives, and cleared per generation, so "
         "slow startups and re-execs are never misdeclared.")
ELASTIC_SCALE_UP_DELAY = _register(
    "ELASTIC_SCALE_UP_DELAY", 0.0, float,
    help="Seconds a grow-only membership delta must persist across "
         "discovery polls before the elastic driver interrupts the "
         "running generation to grow into the new capacity — the "
         "debounce that keeps one flapping discovery poll from "
         "triggering a resize. 0 (default) grows on the first poll "
         "(the pre-policy behavior). Shrinks (host lost or draining) "
         "always interrupt immediately.")
ELASTIC_SCALE_DOWN_POLICY = _register(
    "ELASTIC_SCALE_DOWN_POLICY", "drain", str,
    help="How the elastic driver handles a preemption notice: 'drain' "
         "(default) gracefully retires the host — final commit flushed, "
         "heartbeat tracking dropped, survivors re-rendezvous and "
         "restore its shards via resharding, host stays re-admittable — "
         "while 'immediate' fires the legacy kill path (host event -> "
         "worker exit -> FAILURE -> blacklist).")
MESH_SHAPE = _register(
    "MESH_SHAPE", "", str,
    help="Process-level parallelism mesh the elastic driver plans over, "
         "as an 'axis=size' comma list over (dp, fsdp, pp, ep, sp, tp) — "
         "e.g. 'dp=2,fsdp=2', or 'dp=-1,fsdp=2' to absorb the first "
         "generation's world size into dp. Empty (default) disables the "
         "driver's mesh plane: membership changes replan only the flat "
         "world size. When set, every generation the driver recomputes "
         "the mesh from the survivor count (MESH_RESHAPE_POLICY) and "
         "publishes it to the journaled 'mesh' rendezvous scope for "
         "workers to adopt on reset.")
RETRY_MAX_ATTEMPTS = _register(
    "RETRY_MAX_ATTEMPTS", 5, int,
    help="Total attempts (first call + retries) for transient host-plane "
         "failures (rendezvous KV ops, worker registration, dispatcher "
         "host-plane staging).")
RETRY_INITIAL_BACKOFF = _register(
    "RETRY_INITIAL_BACKOFF", 0.05, float,
    help="Base backoff in seconds; retry k sleeps uniform(0, "
         "min(RETRY_MAX_BACKOFF, RETRY_INITIAL_BACKOFF * 2**(k-1))) "
         "(capped exponential backoff with full jitter).")
RETRY_MAX_BACKOFF = _register(
    "RETRY_MAX_BACKOFF", 2.0, float,
    help="Upper bound in seconds on any single retry backoff.")
RETRY_DEADLINE = _register(
    "RETRY_DEADLINE", 60.0, float,
    help="Overall per-call retry budget in seconds; a retry that would "
         "overrun it surfaces the last error instead of sleeping.")

# -- Checkpointing (no reference equivalent — the reference delegates to
#    rank-0 framework checkpoints; checkpointing/ is the TPU-pod-scale
#    subsystem: async snapshot-then-persist, sharded writes, manifests) ------
CHECKPOINT_MAX_INFLIGHT = _register(
    "CHECKPOINT_MAX_INFLIGHT", 2, int,
    help="Bound on async checkpoint saves snapshotted but not yet "
         "persisted. A training loop that outruns storage blocks in "
         "save() once the queue is full (backpressure) instead of "
         "accumulating unbounded host-RAM copies of the model.")
# -- The silent-data-corruption plane (sdc/, estimator.py): the JAX
#    package's names and defaults. -----------------------------------------
SDC_GUARD = _register(
    "SDC_GUARD", False, _parse_bool,
    help="Enable the silent-data-corruption step guard: every optimizer "
         "step's gradients and loss pass an all-reduced finite check "
         "plus a loss-spike EWMA bound before the update is applied. A "
         "tripped guard skips the step (retried once, then dropped), "
         "counts hvd_tpu_sdc_detections_total, and feeds the rollback/"
         "quarantine policy. Off by default (zero overhead).")
SDC_LOSS_SPIKE_FACTOR = _register(
    "SDC_LOSS_SPIKE_FACTOR", 10.0, float,
    help="Loss-spike bound for the SDC step guard: a finite loss "
         "exceeding factor * EWMA(|loss|) counts as a loss_spike "
         "detection. <= 0 disables the spike bound (finite checks "
         "remain).")
SDC_FINGERPRINT_EVERY = _register(
    "SDC_FINGERPRINT_EVERY", 0, int,
    help="Compare cross-replica parameter fingerprints (per-leaf bit "
         "checksum folded into one scalar) every N guarded steps, "
         "publishing each rank's value to the schedule-ledger KV scope "
         "so a divergence names the offending rank. 0 (default) "
         "disables fingerprinting.")
SDC_CONFIRM_STEPS = _register(
    "SDC_CONFIRM_STEPS", 2, int,
    help="A checkpointed step is promoted to last-good (the SDC "
         "rollback target) only after the step guard has passed this "
         "many subsequent steps.")
SDC_STRIKES = _register(
    "SDC_STRIKES", 3, int,
    help="SDC detections charged to one host within the policy window "
         "before it is reported to the elastic driver and quarantined.")

HTTP_READ_TIMEOUT = _register(
    "HTTP_READ_TIMEOUT", 30.0, float,
    help="Per-connection socket read/write deadline (seconds) on the "
         "shared async HTTP front-end (rendezvous KV, metrics, serving, "
         "fleet router). Bounds how long a slow-loris client that starts "
         "a request and stalls can pin a worker thread, and how long a "
         "wedged client can stall a response write. 0 disables the "
         "deadline.")

#: External-scheduler task-identity families (reference: MPI env detection
#: that lets bare `mpirun/srun python train.py` work, docs/mpirun.rst), a
#: copy of the JAX package's table. Each row is (rank, size, local_rank,
#: local_size) env names. A family is adopted only when BOTH its rank AND
#: size variables resolve: partial hits are ignored rather than guessed
#: (PMIX_RANK appears without any size variable on some PMIx launchers,
#: and sbatch exports SLURM_PROCID=0 to the batch step itself, where the
#: per-step SLURM_STEP_NUM_TASKS gives size 1). Local entries are
#: best-effort within the adopted family.
_MPI_FAMILIES = (
    ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
     "OMPI_COMM_WORLD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_SIZE"),
    ("PMIX_RANK", "JSM_NAMESPACE_SIZE",
     "JSM_NAMESPACE_LOCAL_RANK", "JSM_NAMESPACE_LOCAL_SIZE"),
    ("SLURM_PROCID", "SLURM_STEP_NUM_TASKS",
     "SLURM_LOCALID", "SLURM_STEP_TASKS_PER_NODE"),
    # MPICH / Hydra (also Intel MPI): PMI_* identity plus MPICH's
    # per-node MPI_LOCAL* pair (runner/mpi_run.py drives this family)
    ("PMI_RANK", "PMI_SIZE", "MPI_LOCALRANKID", "MPI_LOCALNRANKS"),
)


def mpi_task_identity(environ=None, with_source: bool = False):
    """{"RANK": r, "SIZE": n, ...} from the first coherent scheduler
    family, or {} when none applies. Shared by Config.get's fallback and
    the jsrun shim (runner/lsf.py). ``with_source=True`` returns
    ``(mapping, rank_var)`` instead, naming the variable that matched."""
    env = os.environ if environ is None else environ

    def parse(v):
        # SLURM_STEP_TASKS_PER_NODE can be "4(x2)"; take the leading int
        return int(str(v).split("(", 1)[0])

    for rank_var, size_var, lrank_var, lsize_var in _MPI_FAMILIES:
        r, s = env.get(rank_var), env.get(size_var)
        if r is None or s is None:
            continue
        try:
            out = {"RANK": parse(r), "SIZE": parse(s)}
        except ValueError:
            continue
        for key, var in (("LOCAL_RANK", lrank_var),
                         ("LOCAL_SIZE", lsize_var)):
            v = env.get(var)
            if v is not None:
                try:
                    out[key] = parse(v)
                except ValueError:
                    pass
        # MPI launchers export no cross-host identity; with host-major
        # rank placement and uniform slots the cross pair is the host
        # index and host count. Non-uniform layouts (size % local_size !=
        # 0, or a SLURM per-node list such as "2,4") stay unset.
        ls = out.get("LOCAL_SIZE")
        raw_ls = env.get(lsize_var, "")
        uniform_form = re.fullmatch(r"\d+(\(x\d+\))?", str(raw_ls).strip())
        if ls and ls > 0 and uniform_form and out["SIZE"] % ls == 0:
            out.setdefault("CROSS_RANK", out["RANK"] // ls)
            out.setdefault("CROSS_SIZE", out["SIZE"] // ls)
        return (out, rank_var) if with_source else out
    return ({}, None) if with_source else {}


class Config:
    """Resolves knob values: programmatic override > env(HVD_TPU_) >
    env(alias) > the scheduler's task identity (rank and size knobs only)
    > default."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._overrides: Dict[str, Any] = dict(overrides or {})
        unknown = set(self._overrides) - set(_REGISTRY)
        if unknown:
            raise KeyError(f"unknown knob(s) {sorted(unknown)}")

    def set(self, name: str, value: Any) -> None:
        """Override one knob for this Config (the autotuner writes the
        values it adopts here)."""
        if name not in _REGISTRY:
            raise KeyError(f"unknown knob {name!r}")
        self._overrides[name] = value

    def get(self, name: str) -> Any:
        knob = _REGISTRY[name]
        if name in self._overrides:
            return self._overrides[name]
        raw = os.environ.get("HVD_TPU_" + knob.name)
        if raw is None and knob.alias is not None:
            raw = os.environ.get(knob.alias)
        if raw is None:
            if name in (RANK, SIZE, LOCAL_RANK, LOCAL_SIZE, CROSS_RANK,
                        CROSS_SIZE):
                ident = mpi_task_identity()
                if name in ident:
                    return ident[name]
            return knob.default
        try:
            return knob.parser(raw)
        except (TypeError, ValueError):
            return knob.default



def live_config() -> "Config":
    """The initialized world's Config (programmatic overrides included),
    falling back to an env-only view, so a subsystem reading knobs outside
    ``init()`` sees the same values as one inside it."""
    from . import basics
    if basics.is_initialized():
        return basics.world().config
    return Config()
