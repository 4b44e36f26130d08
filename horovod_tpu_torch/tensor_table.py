"""Named-tensor table, async handles and the request wire format
(counterpart of ``horovod_tpu/tensor_table.py``).

* :class:`TensorTable` hands out integer handles and rejects a name that
  is already in flight (the reference's DUPLICATE_NAME_ERROR,
  tensor_queue.cc), registering each submission with the stall inspector;
* :func:`pack_request` serializes submission metadata in the JAX
  package's fixed little-endian layout, and :func:`metadata_fingerprint`
  is the CRC-32 of it, byte for byte the JAX package's for the same
  metadata: a torch dtype is written as the string numpy writes for the
  same type (``torch.bfloat16`` -> ``"bfloat16"``).

The name and handle bookkeeping, the parser and the CRC run in the
native runtime when it loads (``_native/csrc/table.cc`` and ``wire.cc``);
the packer is Python on both paths, as in the JAX package, and writes the
native packer's bytes, so a native rank and a pure-Python rank
(``HVD_TPU_NATIVE=0``) agree on every fingerprint.
"""

import ctypes
import struct
import threading
import zlib
from typing import Dict, Optional

import torch

from ._native import get as _native_get
from .exceptions import DuplicateNameError


class Handle:
    """An in-flight collective, resolved by ``synchronize()``/``poll()``."""

    __slots__ = ("id", "name", "result", "error", "event", "order",
                 "target")

    def __init__(self, hid: int, name: str):
        self.id = hid
        self.name = name
        self.result = None
        self.error: Optional[BaseException] = None
        #: set once the dispatcher thread has produced result or error
        self.event: Optional[threading.Event] = None
        #: the CUDA stream order of the call (collectives._StreamOrder),
        #: None on the CPU
        self.order = None
        #: the tensor an in-place verb writes its result into at
        #: synchronize, held strongly until then
        self.target = None


class TensorTable:
    """Duplicate-name detection and handle allocation. The Handle objects
    always live on the Python side; the name and handle bookkeeping lives
    in the native table when the library loads."""

    def __init__(self, world):
        self._world = world
        self._lock = threading.Lock()
        self._handles: Dict[int, Handle] = {}
        nat = _native_get()
        self._nat = nat
        self._nat_table = nat.cdll.hvd_table_create() if nat else None
        # pure-Python state
        self._in_flight: Dict[str, int] = {}
        self._next_handle = 0

    def __del__(self):
        # the one place the native table is freed: a thread still holding
        # this table keeps it alive, so no call can reach a freed table
        h, self._nat_table = getattr(self, "_nat_table", None), None
        if h:
            try:
                self._nat.cdll.hvd_table_destroy(h)
            except Exception:
                pass

    def begin(self, name: str, kind: str) -> Handle:
        """Register an in-flight named op; raises DuplicateNameError when
        the name is already pending."""
        if self._nat_table is not None:
            hid = self._nat.cdll.hvd_table_begin(
                self._nat_table, name.encode())
            if hid < 0:
                raise DuplicateNameError(self._dup_msg(kind, name))
            h = Handle(int(hid), name)
            with self._lock:
                self._handles[h.id] = h
        else:
            with self._lock:
                if name in self._in_flight:
                    raise DuplicateNameError(self._dup_msg(kind, name))
                hid = self._next_handle
                self._next_handle += 1
                h = Handle(hid, name)
                self._in_flight[name] = hid
                self._handles[hid] = h
        insp = self._world.stall_inspector
        if insp is not None:
            insp.record_submit(name)
        return h

    @staticmethod
    def _dup_msg(kind: str, name: str) -> str:
        return (f"Requested to {kind} a tensor with the same name as another "
                f"tensor that is currently being processed: {name!r}. If you "
                f"want to request another tensor, pass a different name.")

    def finish(self, handle: Handle):
        if self._nat_table is not None:
            self._nat.cdll.hvd_table_finish(self._nat_table, handle.id)
            with self._lock:
                self._handles.pop(handle.id, None)
        else:
            with self._lock:
                self._in_flight.pop(handle.name, None)
                self._handles.pop(handle.id, None)
        insp = self._world.stall_inspector
        if insp is not None:
            insp.record_done(handle.name)

    def get(self, hid: int) -> Handle:
        with self._lock:
            h = self._handles.get(hid)
        if h is None:
            raise ValueError(f"unknown or already-synchronized handle {hid}")
        return h

    def pending_count(self) -> int:
        if self._nat_table is not None:
            return int(self._nat.cdll.hvd_table_pending(self._nat_table))
        with self._lock:
            return len(self._in_flight)


def dtype_str(dtype) -> str:
    """The dtype as the JAX package writes it on the wire: numpy's name
    (``float32``, ``bfloat16``, ``bool``); torch dtypes map to the same
    strings; any other value (``"grouped"``) is written as it is."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(dtype)


# ---------------------------------------------------------------------------
# Request wire format (the JAX package's fixed little-endian layout):
#   u8 version=1 | i32 rank | u8 kind_len,kind | u16 name_len,name
#   | u8 dtype_len,dtype | u8 ndim, i64 dims[ndim] | u16 extra_len,extra
# ---------------------------------------------------------------------------

WIRE_VERSION = 1


def pack_request(name: str, shape, dtype, kind: str, extra: str = "",
                 rank: int = 0) -> bytes:
    """Serialize submission metadata, in Python on both paths as in the
    JAX package: byte for byte what the native packer
    (``wire.cc hvd_wire_pack_request``) writes, so CRCs agree across
    processes whichever runtime each one loaded."""
    nb = name.encode()
    db = dtype_str(dtype).encode()
    kb = kind.encode()
    eb = extra.encode()
    dims = tuple(int(d) for d in shape)
    if len(nb) > 0xFFFF or len(db) > 0xFF or len(kb) > 0xFF \
            or len(eb) > 0xFFFF or len(dims) > 0xFF:
        raise ValueError("request metadata field too large for wire format")
    parts = [struct.pack("<Bi", WIRE_VERSION, rank),
             struct.pack("<B", len(kb)), kb,
             struct.pack("<H", len(nb)), nb,
             struct.pack("<B", len(db)), db,
             struct.pack("<B", len(dims))]
    parts += [struct.pack("<q", d) for d in dims]
    parts += [struct.pack("<H", len(eb)), eb]
    return b"".join(parts)


def unpack_request(buf: bytes) -> dict:
    """Parse a wire message back into its fields (the native parser when
    the library loads); any malformed or truncated message raises
    ValueError."""
    nat = _native_get()
    if nat is not None:
        name = ctypes.create_string_buffer(65536)
        dtype = ctypes.create_string_buffer(256)
        kind = ctypes.create_string_buffer(256)
        extra = ctypes.create_string_buffer(65536)
        shape = (ctypes.c_int64 * 255)()
        ndim = ctypes.c_int32(255)
        rank = ctypes.c_int32(0)
        n = nat.cdll.hvd_wire_unpack_request(
            buf, len(buf), name, len(name), shape, ctypes.byref(ndim),
            dtype, len(dtype), kind, len(kind), extra, len(extra),
            ctypes.byref(rank))
        if n < 0:
            raise ValueError("malformed wire message")
        return {"name": name.value.decode(), "kind": kind.value.decode(),
                "dtype": dtype.value.decode(), "extra": extra.value.decode(),
                "shape": tuple(shape[i] for i in range(ndim.value)),
                "rank": int(rank.value)}
    off = 0

    def take(fmt):
        nonlocal off
        try:
            vals = struct.unpack_from(fmt, buf, off)
        except struct.error as e:
            raise ValueError("malformed wire message") from e
        off += struct.calcsize(fmt)
        return vals

    def take_str(n):
        nonlocal off
        if off + n > len(buf):
            raise ValueError("malformed wire message")
        s = buf[off:off + n].decode()
        off += n
        return s

    version, rank = take("<Bi")
    if version != WIRE_VERSION:
        raise ValueError("malformed wire message")
    kind = take_str(take("<B")[0])
    name = take_str(take("<H")[0])
    dtype = take_str(take("<B")[0])
    (ndim,) = take("<B")
    shape = tuple(take("<q")[0] for _ in range(ndim))
    extra = take_str(take("<H")[0])
    return {"name": name, "kind": kind, "dtype": dtype, "extra": extra,
            "shape": shape, "rank": rank}


def metadata_fingerprint(name: str, shape, dtype, kind: str,
                         extra: str = "") -> int:
    """32-bit fingerprint of a submission's metadata: CRC-32 of the wire
    message with the rank left out, so every rank computes the same one
    (``hvd_crc32`` when the library loads, zlib's otherwise: the same
    IEEE CRC-32)."""
    msg = pack_request(name, shape, dtype, kind, extra, rank=0)
    nat = _native_get()
    if nat is not None:
        return int(nat.cdll.hvd_crc32(msg, len(msg)))
    return zlib.crc32(msg)
