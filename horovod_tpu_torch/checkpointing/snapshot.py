"""Host snapshots of trees of tensors, and their reassembly (the torch
counterpart of ``horovod_tpu/checkpointing/snapshot.py``).

The training-thread half of snapshot-then-persist: :func:`snapshot_tree`
copies every leaf to host memory (one copy) and records, per leaf, the
*global* shape plus the pieces this process writes. It does no file I/O,
no checksumming and no serialization; those are the background writer's.

Trees are nested dicts (keys sorted, as ``jax.tree_util`` orders them),
lists and tuples; None is an empty node. A leaf is a ``torch.Tensor``, a
numpy array or scalar, a :class:`Shard`, or any other object (pickled).
Leaves are written in the JAX package's order with its ``path`` strings
(``jax.tree_util.keystr``: ``['params']['layer_0']['attn']['wq']``), so
either package restores the other's checkpoint of the same tree through
``target=``.

Ownership: a :class:`Shard` is one process's block of a global array;
the process holding replica 0 of a block (``owner``) writes it, so a
replicated block is written once and an N-way sharded leaf as N files. A
plain tensor has no ownership: every process holds it whole, and in a
sharded save only process 0 writes it (``local``).

Dtypes are written by their numpy names (``float32``, ``bfloat16``) and
bytes as raw little-endian element bytes, the JAX package's layout, so a
bf16 leaf crosses packages bit for bit without ml_dtypes: the reader
reassembles it through ``torch.frombuffer``.

The manifest's ``treedef`` field holds this package's structure encoding:
:data:`TREEDEF_PREFIX` followed by JSON, where a leaf is ``"*"``, None is
``null``, a dict ``{"dict": [[key, node], ...]}`` (keys in order, str or
int), a list ``{"list": [node, ...]}`` and a tuple ``{"tuple": [...]}``.
The JAX package writes a pickled ``PyTreeDef`` there, which this package
cannot read: such a checkpoint restores through ``target=``, or from its
``path`` strings when the tree is nested dicts and sequences
(:func:`tree_from_paths`: tuples come back as lists, None leaves are
dropped, and a None inside a sequence raises).
"""

import json
import pickle
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .layout import IntegrityError

#: leaf kinds in the manifest
ARRAY = "array"
OBJECT = "object"

TREEDEF_PREFIX = "hvd-torch-tree-v1:"

_DTYPES = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
    torch.complex64: "complex64", torch.complex128: "complex128",
}
_BY_NAME = {v: k for k, v in _DTYPES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype, as the manifest records it."""
    try:
        return _DTYPES[dtype]
    except KeyError:
        raise TypeError(f"dtype {dtype} cannot be checkpointed") from None


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise IntegrityError(f"unknown leaf dtype {name!r}") from None


class Shard:
    """One process's block of a global array: ``data`` (the block, any
    device), the array's global ``shape``, the block's global ``starts``,
    and ``owner``: this process writes the block (it holds replica 0 of
    it). A restore into a target holding Shards gives Shards of the same
    blocks."""

    __slots__ = ("data", "shape", "starts", "owner")

    def __init__(self, data: torch.Tensor, shape, starts, owner: bool):
        self.data = data
        self.shape = tuple(int(s) for s in shape)
        self.starts = tuple(int(s) for s in starts)
        self.owner = bool(owner)

    def index(self) -> Tuple[slice, ...]:
        return tuple(slice(b, b + n) for b, n in
                     zip(self.starts, self.data.shape))


class HostShard:
    """One contiguous piece of a leaf this process writes, on host."""

    __slots__ = ("starts", "data")

    def __init__(self, starts: Tuple[int, ...], data: torch.Tensor):
        self.starts = starts
        self.data = data


class LeafSnapshot:
    """Host copy of one leaf plus its global layout; ``local`` marks a
    leaf every process holds whole (only process 0 writes it in a sharded
    save)."""

    __slots__ = ("index", "path", "kind", "dtype", "shape", "shards",
                 "payload", "local")

    def __init__(self, index: int, path: str, kind: str,
                 dtype: Optional[str] = None,
                 shape: Optional[Tuple[int, ...]] = None,
                 shards: Optional[List[HostShard]] = None,
                 payload: Optional[bytes] = None, local: bool = True):
        self.index = index
        self.path = path
        self.kind = kind
        self.dtype = dtype
        self.shape = shape
        self.shards = shards or []
        self.payload = payload      # OBJECT leaves: pickled bytes
        self.local = local

    def nbytes(self) -> int:
        if self.kind == OBJECT:
            return len(self.payload or b"")
        return sum(s.data.numel() * s.data.element_size()
                   for s in self.shards)


class TreeSnapshot:
    """Everything save() captured on the training thread."""

    __slots__ = ("treedef", "leaves", "world_size")

    def __init__(self, treedef, leaves: List[LeafSnapshot],
                 world_size: int):
        self.treedef = treedef
        self.leaves = leaves
        self.world_size = world_size

    def nbytes(self) -> int:
        return sum(leaf.nbytes() for leaf in self.leaves)


# -- trees ------------------------------------------------------------------

def tree_flatten(tree: Any) -> Tuple[List[Tuple[str, Any]], Any]:
    """(path, leaf) pairs in the JAX package's order, and the structure."""
    flat: List[Tuple[str, Any]] = []

    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            keys = sorted(node)
            return {"dict": [[k, walk(node[k], f"{path}[{k!r}]")]
                             for k in keys]}
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return {kind: [walk(x, f"{path}[{i}]")
                           for i, x in enumerate(node)]}
        flat.append((path, node))
        return "*"
    return flat, walk(tree, "")


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if node == "*":
            return next(it)
        if "dict" in node:
            return {k: build(v) for k, v in node["dict"]}
        if "list" in node:
            return [build(v) for v in node["list"]]
        return tuple(build(v) for v in node["tuple"])
    return build(treedef)


def encode_treedef(treedef: Any) -> str:
    return TREEDEF_PREFIX + json.dumps(treedef)


def decode_treedef(text: str) -> Any:
    if not text.startswith(TREEDEF_PREFIX):
        raise ValueError("the checkpoint's structure was written by another "
                         "package (a pickled JAX PyTreeDef)")
    return json.loads(text[len(TREEDEF_PREFIX):])


_KEY = re.compile(r"\[('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"|-?\d+)\]")


def tree_from_paths(paths: List[str], leaves: List[Any]) -> Any:
    """Nested dicts from ``['a']['b']``-style paths, a list where a
    level's keys are exactly ``[0]`` .. ``[n-1]``.

    Paths record leaves only, so this is the saved tree only up to what
    they cannot tell: a tuple comes back as a list, and a None leaf (an
    empty node) is not there at all. A level whose int keys are not
    exactly 0..n-1 (a None inside a sequence) or that mixes int and str
    keys raises ValueError, as does any other path (attributes, boxes):
    restore with ``target=`` for the exact structure."""
    root: Dict[Any, Any] = {}
    for path, leaf in zip(paths, leaves):
        keys, pos = [], 0
        for m in _KEY.finditer(path):
            if m.start() != pos:
                break
            text = m.group(1)
            keys.append(int(text) if text[0] not in "'\"" else
                        text[1:-1].encode().decode("unicode_escape"))
            pos = m.end()
        if pos != len(path) or not keys:
            raise ValueError(f"cannot rebuild the tree from path {path!r}; "
                             f"restore with target=")
        node = root
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf

    def lists(node, path):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v, f"{path}[{k!r}]") for k, v in node.items()}
        ints = [k for k in out if isinstance(k, int)]
        if not ints:
            return out
        if len(ints) != len(out) or sorted(ints) != list(range(len(ints))):
            raise ValueError(
                f"cannot rebuild the sequence at {path or 'the root'} from "
                f"its paths (keys {sorted(out, key=str)}: a None or a "
                f"mapping inside it); restore with target=")
        return [out[i] for i in range(len(out))]
    return lists(root, "")


# -- snapshot ----------------------------------------------------------------

def _host_copy(t: torch.Tensor) -> torch.Tensor:
    # an owned contiguous host copy: the caller may step (and overwrite)
    # the tensor while the copy waits in the writer's queue
    return t.detach().to("cpu", copy=True,
                         memory_format=torch.contiguous_format)


def _snapshot_leaf(index: int, path: str, leaf) -> LeafSnapshot:
    if isinstance(leaf, Shard):
        shards = [HostShard(leaf.starts, _host_copy(leaf.data))] \
            if leaf.owner else []
        return LeafSnapshot(index, path, ARRAY,
                            dtype=dtype_name(leaf.data.dtype),
                            shape=leaf.shape, shards=shards, local=False)
    if isinstance(leaf, (np.ndarray, np.generic)):
        leaf = torch.from_numpy(np.array(leaf))
    return LeafSnapshot(index, path, ARRAY, dtype=dtype_name(leaf.dtype),
                        shape=tuple(leaf.shape),
                        shards=[HostShard((0,) * leaf.dim(),
                                          _host_copy(leaf))])


def is_sharded(tree: Any) -> bool:
    flat, _ = tree_flatten(tree)
    return any(isinstance(leaf, Shard) for _, leaf in flat)


def snapshot_tree(tree: Any, world_size: int = 1) -> TreeSnapshot:
    """Flatten ``tree`` and copy every leaf to host memory (the
    synchronous, on-thread part of an async save)."""
    flat, treedef = tree_flatten(tree)
    leaves: List[LeafSnapshot] = []
    for i, (path, leaf) in enumerate(flat):
        if isinstance(leaf, (torch.Tensor, Shard, np.ndarray, np.generic)):
            leaves.append(_snapshot_leaf(i, path, leaf))
        else:
            # non-array leaves round-trip through pickle with their types
            leaves.append(LeafSnapshot(i, path, OBJECT,
                                       payload=pickle.dumps(leaf)))
    return TreeSnapshot(treedef, leaves, world_size)


def payload(t: torch.Tensor) -> memoryview:
    """A host tensor's raw element bytes (native little-endian order)."""
    return memoryview(t.reshape(-1).view(torch.uint8).numpy())


# -- reassembly -------------------------------------------------------------

def assemble_array(leaf_manifest: Dict[str, Any],
                   read_shard: Callable[[Dict[str, Any]], bytes]
                   ) -> torch.Tensor:
    """Reassemble one ARRAY leaf (a CPU tensor) from its manifest entry.

    ``read_shard(shard_entry) -> bytes`` is the caller's (it owns checksum
    verification). Raises :class:`IntegrityError` when the pasted shards
    do not exactly cover the leaf."""
    dtype = torch_dtype(leaf_manifest["dtype"])
    shape = tuple(leaf_manifest["shape"])
    out = torch.empty(shape, dtype=dtype)
    itemsize = out.element_size()
    covered = 0
    for shard in leaf_manifest["shards"]:
        data = read_shard(shard)
        sshape = tuple(shard["shape"])
        n = int(np.prod(sshape, dtype=np.int64))
        if len(data) != n * itemsize:
            raise IntegrityError(
                f"shard {shard.get('file')!r} of leaf "
                f"{leaf_manifest.get('path')!r}: payload holds "
                f"{len(data) // itemsize} elements, manifest says shape "
                f"{sshape}")
        piece = (torch.frombuffer(bytearray(data), dtype=dtype) if n
                 else torch.empty(0, dtype=dtype)).reshape(sshape)
        starts = tuple(shard.get("starts") or ())
        if not shape:               # 0-d leaf
            out[()] = piece.reshape(-1)[0]
        else:
            out[tuple(slice(b, b + k) for b, k in zip(starts, sshape))] = \
                piece
        covered += n
    if covered != out.numel():
        raise IntegrityError(
            f"leaf {leaf_manifest.get('path')!r}: shards cover {covered} "
            f"of {out.numel()} elements")
    return out


def assemble_object(payload_bytes: bytes) -> Any:
    return pickle.loads(payload_bytes)
