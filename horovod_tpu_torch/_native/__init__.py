"""ctypes bindings of horovod_tpu_torch's native host runtime.

The port's copy of the JAX package's ``_native``: the host-plane
components the reference implements in C++ (horovod/common/): submission
table (tensor_queue), response cache, fusion planner (controller.cc
FuseResponses), stall inspector, timeline writer, wire format
(message.{h,cc}) and the autotuner's GP/Bayesian optimizer (optim/). The
sources are ``csrc/``; :mod:`.build` compiles them with ``g++`` into
``build/torch_native/`` at first use. ``get()`` returns the loaded
bindings or None: every consumer has a pure-Python path, the one
``HVD_TPU_NATIVE=0`` selects, so a machine without a C++ compiler keeps
every behaviour and loses host time only.

The library is loaded with ctypes' default ``RTLD_LOCAL``, so its symbols
(named as the JAX package's) never resolve against another library of the
same names in the process.
"""

import ctypes
import logging
import os
import threading
from typing import Optional

#: the C API version this module binds (csrc/lib.cc hvd_abi_version)
ABI_VERSION = 2

_lock = threading.Lock()
_lib = None
_tried = False
#: the library's path once loaded
path: Optional[str] = None


class _Bindings:
    def __init__(self, cdll: ctypes.CDLL):
        self.cdll = cdll
        c = cdll

        c.hvd_abi_version.restype = ctypes.c_int32

        # wire
        c.hvd_crc32.restype = ctypes.c_uint32
        c.hvd_crc32.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        c.hvd_wire_pack_request.restype = ctypes.c_int64
        c.hvd_wire_pack_request.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64]
        c.hvd_wire_unpack_request.restype = ctypes.c_int64
        c.hvd_wire_unpack_request.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32)]

        # table
        c.hvd_table_create.restype = ctypes.c_void_p
        c.hvd_table_destroy.argtypes = [ctypes.c_void_p]
        c.hvd_table_begin.restype = ctypes.c_int64
        c.hvd_table_begin.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        c.hvd_table_finish.restype = ctypes.c_int32
        c.hvd_table_finish.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        c.hvd_table_known.restype = ctypes.c_int32
        c.hvd_table_known.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        c.hvd_table_pending.restype = ctypes.c_int64
        c.hvd_table_pending.argtypes = [ctypes.c_void_p]

        # cache
        c.hvd_cache_create.restype = ctypes.c_void_p
        c.hvd_cache_create.argtypes = [ctypes.c_int64]
        c.hvd_cache_destroy.argtypes = [ctypes.c_void_p]
        c.hvd_cache_lookup.restype = ctypes.c_int32
        c.hvd_cache_lookup.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        c.hvd_cache_put.restype = ctypes.c_int32
        c.hvd_cache_put.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)]
        c.hvd_cache_erase.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        c.hvd_cache_size.restype = ctypes.c_int64
        c.hvd_cache_size.argtypes = [ctypes.c_void_p]
        c.hvd_cache_clear.argtypes = [ctypes.c_void_p]

        # fusion
        c.hvd_plan_buckets.restype = ctypes.c_int64
        c.hvd_plan_buckets.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32)]

        # stall
        c.hvd_stall_create.restype = ctypes.c_void_p
        c.hvd_stall_destroy.argtypes = [ctypes.c_void_p]
        c.hvd_stall_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        c.hvd_stall_done.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        c.hvd_stall_pending.restype = ctypes.c_int64
        c.hvd_stall_pending.argtypes = [ctypes.c_void_p]
        c.hvd_stall_check.restype = ctypes.c_int64
        c.hvd_stall_check.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int64]

        # timeline
        c.hvd_tl_create.restype = ctypes.c_void_p
        c.hvd_tl_create.argtypes = [ctypes.c_char_p]
        c.hvd_tl_tid.restype = ctypes.c_int32
        c.hvd_tl_tid.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        c.hvd_tl_now_us.restype = ctypes.c_double
        c.hvd_tl_now_us.argtypes = [ctypes.c_void_p]
        c.hvd_tl_emit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int32, ctypes.c_char_p]
        c.hvd_tl_close.argtypes = [ctypes.c_void_p]

        # metrics
        c.hvd_mtr_create.restype = ctypes.c_void_p
        c.hvd_mtr_destroy.argtypes = [ctypes.c_void_p]
        c.hvd_mtr_add.argtypes = [ctypes.c_void_p, ctypes.c_double]
        c.hvd_mtr_set.argtypes = [ctypes.c_void_p, ctypes.c_double]
        c.hvd_mtr_get.restype = ctypes.c_double
        c.hvd_mtr_get.argtypes = [ctypes.c_void_p]
        c.hvd_hist_create.restype = ctypes.c_void_p
        c.hvd_hist_create.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32]
        c.hvd_hist_destroy.argtypes = [ctypes.c_void_p]
        c.hvd_hist_observe.argtypes = [ctypes.c_void_p, ctypes.c_double]
        c.hvd_hist_read.restype = ctypes.c_int32
        c.hvd_hist_read.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint64)]

        # bayesian optimization
        c.hvd_bo_create.restype = ctypes.c_void_p
        c.hvd_bo_create.argtypes = [
            ctypes.c_int32, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.c_uint64]
        c.hvd_bo_destroy.argtypes = [ctypes.c_void_p]
        c.hvd_bo_observe.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_double]
        c.hvd_bo_num_obs.restype = ctypes.c_int64
        c.hvd_bo_num_obs.argtypes = [ctypes.c_void_p]
        c.hvd_bo_suggest.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_double)]


def get() -> Optional[_Bindings]:
    """The loaded native bindings, building the library on first call.
    Returns None when native is disabled (``HVD_TPU_NATIVE=0``) or the
    library cannot be built; a failed build is logged at WARNING."""
    global _lib, _tried, path
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("HVD_TPU_NATIVE", "1") in ("0", "false", "FALSE"):
            return None
        try:
            from . import build
            lib = build.build()
            b = _Bindings(ctypes.CDLL(lib))
            if b.cdll.hvd_abi_version() != ABI_VERSION:
                lib = build.build(force=True)
                b = _Bindings(ctypes.CDLL(lib))
            _lib, path = b, lib
        except Exception as e:  # no compiler, build error, bad library
            logging.getLogger("horovod_tpu_torch").warning(
                "native runtime unavailable (%s); using the pure-Python "
                "paths", e)
            _lib = None
        return _lib


def available() -> bool:
    return get() is not None
