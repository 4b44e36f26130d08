"""Named-tensor table, async handles and the request wire format
(counterpart of ``horovod_tpu/tensor_table.py``, its pure-Python path).

* :class:`TensorTable` hands out integer handles and rejects a name that
  is already in flight (the reference's DUPLICATE_NAME_ERROR,
  tensor_queue.cc), registering each submission with the stall inspector;
* :func:`pack_request` serializes submission metadata in the JAX
  package's fixed little-endian layout, and :func:`metadata_fingerprint`
  is the CRC-32 of it, byte for byte the JAX package's for the same
  metadata: a torch dtype is written as the string numpy writes for the
  same type (``torch.bfloat16`` -> ``"bfloat16"``).
"""

import struct
import threading
import zlib
from typing import Dict, Optional

import torch

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
    """Duplicate-name detection and handle allocation."""

    def __init__(self, world):
        self._world = world
        self._lock = threading.Lock()
        self._handles: Dict[int, Handle] = {}
        self._in_flight: Dict[str, int] = {}
        self._next_handle = 0

    def begin(self, name: str, kind: str) -> Handle:
        """Register an in-flight named op; raises DuplicateNameError when
        the name is already pending."""
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
    """Serialize submission metadata."""
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
    """Parse a wire message back into its fields; any malformed or
    truncated message raises ValueError."""
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
    message with the rank left out, so every rank computes the same one."""
    return zlib.crc32(pack_request(name, shape, dtype, kind, extra, rank=0))
