"""Environment knobs read by horovod_tpu_torch.

The subset of ``horovod_tpu/config.py`` that the port reads, with the same
``HVD_TPU_*`` names, ``HOROVOD_*`` aliases and defaults, so one environment
drives both packages. Resolution order is the same: programmatic override,
then ``HVD_TPU_<NAME>``, then the alias, then the default (an unparsable
value falls back to the default).
"""

import dataclasses
import os
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


class Config:
    """Resolves knob values: programmatic override > env(HVD_TPU_) >
    env(alias) > default."""

    def __init__(self, overrides: Optional[Dict[str, Any]] = None):
        self._overrides: Dict[str, Any] = dict(overrides or {})
        unknown = set(self._overrides) - set(_REGISTRY)
        if unknown:
            raise KeyError(f"unknown knob(s) {sorted(unknown)}")

    def get(self, name: str) -> Any:
        knob = _REGISTRY[name]
        if name in self._overrides:
            return self._overrides[name]
        raw = os.environ.get("HVD_TPU_" + knob.name)
        if raw is None and knob.alias is not None:
            raw = os.environ.get(knob.alias)
        if raw is None:
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
