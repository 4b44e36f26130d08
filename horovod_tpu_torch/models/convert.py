"""Carry weights from the JAX package's flax transformer into the port.

The port keeps the flax module's parameter names and shapes, so conversion
is a copy: the nested dict ``{"layer_0": {"attn": {"wq": ...}}}`` becomes
the ``state_dict`` key ``layer_0.attn.wq``. On a training mesh with tp or
fsdp (``mesh=``) each process takes its blocks of the global arrays, as
``parallel.mesh_utils.param_shardings`` lays them out, and
:func:`params_to_flax` gathers the blocks back into global arrays.
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .transformer import Transformer, TransformerConfig


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    flat = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(_flatten(val, name + "."))
        else:
            flat[name] = val
    return flat


def _infer_config(flat: Dict[str, Any]) -> TransformerConfig:
    def shape(name):
        if name not in flat:
            raise ValueError(f"flax tree is missing leaf {name!r}")
        return tuple(np.shape(flat[name]))

    vocab, d_model = shape("embedding")
    max_seq_len = shape("pos_embedding")[0]
    _, heads, head_dim = shape("layer_0.attn.wq")
    hidden = shape("layer_0.mlp.wi")[1]
    num_layers = len({n.split(".")[0] for n in flat
                      if n.startswith("layer_")})
    return TransformerConfig(
        vocab_size=vocab, num_layers=num_layers, d_model=d_model,
        num_heads=heads, head_dim=head_dim,
        mlp_ratio=max(hidden // d_model, 1), max_seq_len=max_seq_len)


def params_from_flax(tree: Mapping, mesh=None) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (fp32 CPU tensors) from the JAX
    transformer's parameter tree, given as nested dicts of numpy arrays
    (unboxed with ``flax.linen.meta.unbox``; a top-level ``{"params": ...}``
    is accepted). The model's size is read from the tree; every leaf's name
    and shape must then match that model exactly, and a leftover or
    missing leaf raises ValueError. With ``mesh`` (a training mesh), each
    tensor is this process's block, the state_dict of the model a sharded
    train step holds there."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    flat = _flatten(tree)
    cfg = _infer_config(flat)
    expected = {name: tuple(t.shape) for name, t in
                Transformer(cfg, device="meta").state_dict().items()}
    missing = sorted(set(expected) - set(flat))
    leftover = sorted(set(flat) - set(expected))
    if missing or leftover:
        raise ValueError(f"flax tree does not match the transformer: "
                         f"missing {missing}, leftover {leftover}")
    wrong = [f"{n}: {tuple(np.shape(flat[n]))} != {s}"
             for n, s in expected.items() if tuple(np.shape(flat[n])) != s]
    if wrong:
        raise ValueError("flax leaf shapes do not match: " + "; ".join(wrong))
    state = {name: torch.from_numpy(np.array(flat[name], dtype=np.float32))
             for name in expected}
    if mesh is None:
        return state
    from ..parallel.mesh_utils import param_shardings
    specs = param_shardings(mesh, expected)
    return {name: t[specs[name].index].clone(
        memory_format=torch.contiguous_format) for name, t in state.items()}


def params_to_flax(state: Mapping[str, torch.Tensor], mesh=None
                   ) -> Dict[str, Any]:
    """The inverse of :func:`params_from_flax`: the JAX transformer's
    parameter tree (nested dicts of fp32 numpy arrays) from the port's
    ``state_dict``. With ``mesh``, ``state`` holds this process's blocks
    and each is all-gathered over the mesh axes it shards over into the
    global array (collective over the world: every process calls it)."""
    arrays = {}
    for name, t in state.items():
        t = t.detach()
        if mesh is not None:
            from ..parallel.comm import all_gather
            from ..parallel.mesh_utils import axis_size, param_spec
            for dim, axis in enumerate(param_spec(name, t.dim())[0]):
                if axis is not None and axis_size(mesh, axis) > 1:
                    t = all_gather(t, dim, mesh.get_group(axis))
        arrays[name] = np.array(t.float().cpu().numpy())   # a copy
    return nest(arrays)


def nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"layer_0.attn.wq": x}`` -> ``{"layer_0": {"attn": {"wq": x}}}``:
    the flax module's tree from state_dict names."""
    tree: Dict[str, Any] = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def moe_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """``parallel.moe.MoEMlp`` parameters (fp32 CPU tensors) from the JAX
    package's ``MoEMlp.init`` dict of arrays: ``gate_w`` (D, E), ``w_in``
    (E, D, Hd), ``w_out`` (E, Hd, D). Names must match exactly and the
    shapes must agree on D, E and Hd, or ValueError is raised."""
    names = ("gate_w", "w_in", "w_out")
    if set(tree) != set(names):
        raise ValueError(f"MoE tree has leaves {sorted(tree)}, expected "
                         f"{list(names)}")
    shapes = {n: tuple(np.shape(tree[n])) for n in names}
    if len(shapes["gate_w"]) != 2:
        raise ValueError(f"gate_w must be (D, E), got {shapes['gate_w']}")
    D, E = shapes["gate_w"]
    if len(shapes["w_in"]) != 3:
        raise ValueError(f"w_in must be (E, D, Hd), got {shapes['w_in']}")
    Hd = shapes["w_in"][2]
    want = {"gate_w": (D, E), "w_in": (E, D, Hd), "w_out": (E, Hd, D)}
    wrong = [f"{n}: {shapes[n]} != {want[n]}" for n in names
             if shapes[n] != want[n]]
    if wrong:
        raise ValueError("MoE leaf shapes do not agree: " + "; ".join(wrong))
    return {n: torch.from_numpy(np.array(tree[n], dtype=np.float32))
            for n in names}
