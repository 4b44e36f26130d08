"""Leveled logging configured from the env/config knobs (a copy of
``horovod_tpu/logging_setup.py``, configuring this package's logger).

Reference: the C++ leveled logger (horovod/common/logging.{h,cc}: LOG(level,
rank) macros, env HOROVOD_LOG_LEVEL, HOROVOD_LOG_HIDE_TIME). Here the
`horovod_tpu_torch` Python logger gets the same controls — level from
HVD_TPU_LOG_LEVEL (alias HOROVOD_LOG_LEVEL:
trace/debug/info/warning/error/fatal), timestamps suppressible with
HVD_TPU_LOG_HIDE_TIME, and a rank prefix once the world exists.
"""

import logging

_LEVELS = {
    "trace": logging.DEBUG,  # python has no TRACE; map to DEBUG
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

_configured = False


class _RankFilter(logging.Filter):
    def filter(self, record):
        from . import basics
        record.rank = basics.rank() if basics.is_initialized() else "-"
        return True


def configure(config) -> logging.Logger:
    """Idempotently configure the 'horovod_tpu_torch' logger from Config
    knobs. Called by init(); safe to call again after elastic re-init."""
    global _configured
    from . import config as _config
    log = logging.getLogger("horovod_tpu_torch")
    level = _LEVELS.get(str(config.get(_config.LOG_LEVEL)).lower(),
                        logging.WARNING)
    log.setLevel(level)
    if not _configured:
        handler = logging.StreamHandler()
        fmt = "[%(rank)s]<%(levelname)s> %(message)s" \
            if config.get(_config.LOG_HIDE_TIME) else \
            "%(asctime)s [%(rank)s]<%(levelname)s> %(message)s"
        handler.setFormatter(logging.Formatter(fmt))
        handler.addFilter(_RankFilter())
        log.addHandler(handler)
        log.propagate = False
        _configured = True
    return log
