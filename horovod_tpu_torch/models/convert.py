"""Carry weights from the JAX package's flax models into the port.

The port keeps the flax module's parameter names and shapes, so conversion
is a copy: the nested dict ``{"layer_0": {"attn": {"wq": ...}}}`` becomes
the ``state_dict`` key ``layer_0.attn.wq``. On a training mesh with tp or
fsdp (``mesh=``) each process takes its blocks of the global arrays, as
``parallel.mesh_utils.param_shardings`` lays them out, and
:func:`params_to_flax` gathers the blocks back into global arrays.

The CNN zoo (ResNet, VGG, Inception, MLP) converts the same way by name,
with the batch statistics as buffers and kernels moved to torch's layout:
:func:`cnn_params_from_flax` and :func:`cnn_params_to_flax`.

The int8 compressor's error-feedback residual (the JAX package's
``Int8ErrorFeedbackState.residual``, one fp32 array per parameter)
converts by name too: :func:`int8_residual_from_flax` and
:func:`int8_residual_to_flax`, so that both packages can continue from
one state.
"""

from typing import Any, Dict, Iterable, List, Mapping

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


_STATS = ("mean", "var")


def flax_order(names: Iterable[str]) -> List[str]:
    """``state_dict`` names in the order ``jax.tree_util`` flattens the
    flax module's nested dict: keys sorted at every level, i.e. names
    sorted by their dotted path (not the module's registration order).
    Leaf-indexed things that must agree with the JAX package, such as the
    SDC fingerprints' chain and the ``worker.grads`` drill's leaf choice,
    go in this order."""
    return sorted(names, key=lambda n: tuple(n.split(".")))


def flax_view(name: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` seen in the flax module's layout: a view, so writing to it
    writes ``t``. A ``kernel`` leaf of the CNN zoo is stored in torch's
    layout (conv OIHW, dense (out, in)) and is viewed as flax's (HWIO,
    (in, out)); every other leaf, the transformer's included, already has
    flax's shape."""
    if name.rsplit(".", 1)[-1] == "kernel" and t.dim() in (2, 4):
        return t.permute(2, 3, 1, 0) if t.dim() == 4 else t.t()
    return t


def _torch_layout(a: np.ndarray) -> np.ndarray:
    # conv HWIO -> OIHW, dense (in, out) -> (out, in)
    return a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T


def _flax_layout(a: np.ndarray) -> np.ndarray:
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T


def cnn_params_from_flax(model: torch.nn.Module, variables: Mapping
                         ) -> Dict[str, torch.Tensor]:
    """``model``'s ``state_dict`` (fp32 CPU tensors) from the JAX model's
    variables ``{"params": ..., "batch_stats": ...}`` (numpy or JAX
    arrays; VGG and the MLP have no batch_stats). ``kernel`` leaves are
    moved to torch's layout, BatchNorm's ``mean`` and ``var`` come from
    batch_stats, everything else is copied. Every leaf of the model must
    be in the tree with its shape and every leaf of the tree used, or
    ValueError is raised."""
    trees = {"params": _flatten(variables["params"]),
             "batch_stats": _flatten(variables.get("batch_stats", {}))}
    unknown = sorted(set(variables) - set(trees))
    if unknown:
        raise ValueError(f"unknown flax collections {unknown}")
    state, missing, wrong = {}, [], []
    used = {k: set() for k in trees}
    for name, t in model.state_dict().items():
        kind = "batch_stats" if name.rsplit(".", 1)[-1] in _STATS \
            else "params"
        if name not in trees[kind]:
            missing.append(f"{kind}/{name}")
            continue
        used[kind].add(name)
        a = np.array(trees[kind][name], dtype=np.float32)   # a copy
        if name.endswith(".kernel"):
            a = _torch_layout(a)
        if a.shape != tuple(t.shape):
            wrong.append(f"{name}: {a.shape} != {tuple(t.shape)}")
            continue
        state[name] = torch.from_numpy(np.ascontiguousarray(a))
    leftover = sorted(f"{k}/{n}" for k, tree in trees.items()
                      for n in tree if n not in used[k])
    if missing or leftover:
        raise ValueError(f"flax variables do not match the model: missing "
                         f"{sorted(missing)}, leftover {leftover}")
    if wrong:
        raise ValueError("flax leaf shapes do not match: " + "; ".join(wrong))
    return state


def cnn_params_to_flax(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`cnn_params_from_flax`: ``{"params": ...,
    "batch_stats": ...}`` (nested dicts of fp32 numpy arrays; no
    batch_stats for a model without BatchNorm) from a CNN's
    ``state_dict``."""
    out: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for name, t in state.items():
        a = np.array(t.detach().float().cpu().numpy())   # a copy
        if name.endswith(".kernel"):
            a = np.ascontiguousarray(_flax_layout(a))
        kind = "batch_stats" if name.rsplit(".", 1)[-1] in _STATS \
            else "params"
        out[kind][name] = a
    return {k: nest(v) for k, v in out.items() if v}


def int8_residual_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The compiled-plane optimizer's error-feedback residual, the value
    of its ``state_dict()["error_feedback_residual"]`` ({state_dict name:
    fp32 CPU tensor}), from the JAX package's
    ``Int8ErrorFeedbackState.residual`` given as nested dicts of numpy
    arrays keyed by flax path (a top-level ``{"params": ...}`` is
    accepted). ``kernel`` leaves of the CNN zoo move to torch's layout.
    Load it with ``opt.load_state_dict(dict(opt.state_dict(),
    error_feedback_residual=...))``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for name, a in _flatten(tree).items():
        a = np.array(a, dtype=np.float32)   # a copy
        if name.rsplit(".", 1)[-1] == "kernel" and a.ndim in (2, 4):
            a = np.ascontiguousarray(_torch_layout(a))
        out[name] = torch.from_numpy(a)
    return out


def int8_residual_to_flax(residual: Mapping[str, torch.Tensor]
                          ) -> Dict[str, Any]:
    """The inverse of :func:`int8_residual_from_flax`: the JAX package's
    residual tree (nested dicts of fp32 numpy arrays, in flax's layout)
    from the port's ``{name: tensor}``."""
    return nest({name: np.array(flax_view(name, t.detach()).float().cpu()
                                 .numpy())
                 for name, t in residual.items()})
