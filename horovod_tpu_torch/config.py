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

