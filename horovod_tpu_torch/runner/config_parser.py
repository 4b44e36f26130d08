"""CLI-flag / YAML-config → env-var translation.

Reference: horovod/runner/common/util/config_parser.py
(``set_env_from_args`` writes HOROVOD_* env vars from horovodrun flags) and
launch.py:470-475 (--config-file YAML merged into args). A copy of
``horovod_tpu/runner/config_parser.py``: the same three layers — env < YAML
< CLI — against the port's knob registry (``horovod_tpu_torch.config``,
the JAX package's names), so flag names and env names can never drift.
"""

from typing import Dict

from .. import config as _config

# argparse dest -> knob name in horovod_tpu_torch.config
_ARG_TO_KNOB = {
    "fusion_threshold_mb": _config.FUSION_THRESHOLD,
    "cycle_time_ms": _config.CYCLE_TIME,
    "cache_capacity": _config.CACHE_CAPACITY,
    "timeline_filename": _config.TIMELINE,
    "timeline_mark_cycles": _config.TIMELINE_MARK_CYCLES,
    "no_stall_check": _config.STALL_CHECK_DISABLE,
    "stall_check_warning_time_seconds": _config.STALL_CHECK_TIME_SECONDS,
    "stall_check_shutdown_time_seconds": _config.STALL_SHUTDOWN_TIME_SECONDS,
    "autotune": _config.AUTOTUNE,
    "autotune_log_file": _config.AUTOTUNE_LOG,
    "autotune_warmup_samples": _config.AUTOTUNE_WARMUP_SAMPLES,
    "autotune_steps_per_sample": _config.AUTOTUNE_STEPS_PER_SAMPLE,
    "autotune_bayes_opt_max_samples": _config.AUTOTUNE_BAYES_OPT_MAX_SAMPLES,
    "verbose_log_level": _config.LOG_LEVEL,
    "check_consistency": _config.CHECK_CONSISTENCY,
    "start_timeout": _config.INIT_TIMEOUT_SECONDS,
    "rendezvous_dir": _config.RENDEZVOUS_DIR,
    "heartbeat_interval": _config.HEARTBEAT_INTERVAL,
    "heartbeat_timeout": _config.HEARTBEAT_TIMEOUT,
}

_MB_ARGS = {"fusion_threshold_mb"}


def _unset(value) -> bool:
    # NB: not `value in (None, "", False)` — 0 == False would drop an
    # explicitly-set zero (e.g. --cache-capacity 0 to disable the cache).
    return value is None or value is False or (
        isinstance(value, str) and value == "")


def set_env_from_args(env: Dict[str, str], args) -> Dict[str, str]:
    """Write HVD_TPU_* env vars for every CLI flag the user set
    (reference config_parser.set_env_from_args)."""
    for dest, knob in _ARG_TO_KNOB.items():
        value = getattr(args, dest, None)
        if _unset(value):
            continue
        if dest in _MB_ARGS:
            value = int(value) * 1024 * 1024
        if isinstance(value, bool):
            value = "1"
        env["HVD_TPU_" + knob] = str(value)
    return env


def load_config_file(path: str) -> dict:
    """Parse a YAML config file into a flat {arg_dest: value} dict
    (reference --config-file, launch.py:470-475; format mirrors
    test/data/config.test.yaml's nested sections)."""
    import yaml
    with open(path) as f:
        doc = yaml.safe_load(f) or {}
    flat = {}
    for section, values in doc.items():
        if isinstance(values, dict):
            for k, v in values.items():
                flat[f"{section}_{k}".replace("-", "_")] = v
        else:
            flat[section.replace("-", "_")] = values
    return flat


def apply_config_file(args, flat: dict):
    """Merge config-file values into args; CLI-set values win
    (reference config_parser._validate_arg_nonnull merge order)."""
    for k, v in flat.items():
        if hasattr(args, k) and _unset(getattr(args, k)):
            setattr(args, k, v)
    return args
