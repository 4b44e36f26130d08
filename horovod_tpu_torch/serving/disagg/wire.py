"""The disagg KV-block wire format: content-addressed manifests and
packed block payloads (counterpart of
``horovod_tpu/serving/disagg/wire.py``; the format is byte for byte the
JAX package's, so a block packed by one package unpacks in the other and
mixed replicas exchange KV).

A manifest is the chain-hash list of a prompt's matchable full blocks
(:func:`prompt_manifest` — the same ``chain_hash`` chain every
replica's scheduler computes, so the prefill pool, the decode pool,
and the router all name blocks identically without exchanging tokens).
A payload (:func:`pack_blocks` / :func:`unpack_blocks`) carries the
actual K/V contents of a hash subset as base64 inside the JSON body of
``POST /v1/kv/fetch`` — self-describing (shape + dtypes ride along),
so a fetch can be answered and verified without out-of-band context.

``wire_dtype`` ``'native'`` ships the pool dtype bit-exactly (the
default — the disagg-vs-colocated bit-parity guarantee requires it
whenever the pools are wider than bf16), ``'bf16'`` halves fp32
transfer bytes by rounding to bfloat16 (lossless only when the pools
already are bf16). numpy has no bfloat16, so bf16 bytes are written and
read through torch's ``view(torch.int16)``: the same little-endian raw
bits the JAX package writes through ``ml_dtypes``.
"""

import base64
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..generation.kv_cache import chain_hash

#: wire dtypes the fetch endpoint accepts
WIRE_DTYPES = ("native", "bf16")


def prompt_manifest(tokens: Sequence[int], block_size: int) -> List[str]:
    """Chain hashes of ``tokens``' matchable full blocks — capped below
    the final token, exactly like the scheduler's admission hashes
    (prefill must keep at least one token to run, because the prefill
    program samples the first generated token)."""
    toks = [int(t) for t in tokens]
    bs = int(block_size)
    n = max(0, (len(toks) - 1) // bs)
    out: List[str] = []
    parent: Optional[str] = None
    for j in range(n):
        parent = chain_hash(parent, toks[j * bs:(j + 1) * bs])
        out.append(parent)
    return out


def _dtype_name(t: torch.Tensor) -> str:
    """The numpy-style name the JAX package writes ("float32",
    "bfloat16", ...)."""
    return str(t.dtype).replace("torch.", "")


def _tensor(arr) -> torch.Tensor:
    t = arr if isinstance(arr, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(arr))
    return t.detach().cpu().contiguous()


def _encode(arr, wire_dtype: str) -> Tuple[str, str]:
    """One pool-slice array (tensor or numpy) -> (base64 payload, wire
    dtype name)."""
    t = _tensor(arr)
    if wire_dtype == "bf16":
        t = t.to(torch.bfloat16)
    if t.dtype == torch.bfloat16:
        raw = t.view(torch.int16).numpy().tobytes()
    else:
        raw = t.numpy().tobytes()
    return base64.b64encode(raw).decode("ascii"), _dtype_name(t)


def _decode(b64: str, dtype_name: str, shape: Sequence[int]) -> torch.Tensor:
    raw = bytearray(base64.b64decode(b64.encode("ascii")))
    if dtype_name == "bfloat16":
        t = torch.frombuffer(raw, dtype=torch.int16).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dtype_name)))
    return t.reshape(tuple(shape))


def pack_blocks(hashes: Sequence[str], k, v,
                wire_dtype: str = "native") -> Dict:
    """The ``/v1/kv/fetch`` response document for ``hashes``' block
    contents (``k``/``v`` tensors or arrays shaped ``(layers, n, bs,
    heads, hd)``). Returns ``{"hashes", "shape", "dtype", "wire_dtype",
    "k", "v"}``; an empty ``hashes`` packs to ``{"hashes": []}``."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"HVD_TPU_DISAGG_WIRE_DTYPE={wire_dtype!r}: must be one of "
            f"{'|'.join(WIRE_DTYPES)}")
    hashes = [str(h) for h in hashes]
    if not hashes:
        return {"hashes": []}
    kt, vt = _tensor(k), _tensor(v)
    k_b64, wire_name = _encode(kt, wire_dtype)
    v_b64, _ = _encode(vt, wire_dtype)
    return {"hashes": hashes,
            "shape": list(kt.shape),
            "dtype": _dtype_name(kt),
            "wire_dtype": wire_name,
            "k": k_b64, "v": v_b64}


def unpack_blocks(doc: Dict) -> Tuple[List[str], Optional[torch.Tensor],
                                      Optional[torch.Tensor], int]:
    """Invert :func:`pack_blocks`: ``(hashes, k, v, wire_bytes)``, CPU
    tensors in the wire dtype (the importer's ``scatter_blocks`` casts
    to the pool dtype); ``wire_bytes`` is the payload size actually
    moved, the ``hvd_tpu_disagg_transfer_bytes_total`` increment."""
    hashes = [str(h) for h in doc.get("hashes", [])]
    if not hashes:
        return [], None, None, 0
    shape = doc["shape"]
    wire_name = doc.get("wire_dtype") or doc["dtype"]
    k = _decode(doc["k"], wire_name, shape)
    v = _decode(doc["v"], wire_name, shape)
    nbytes = (k.numel() * k.element_size() + v.numel() * v.element_size())
    return hashes, k, v, nbytes
