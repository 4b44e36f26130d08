"""Training step for the transformer (counterpart of
``horovod_tpu/parallel/train.py``'s ``make_transformer_train_step``).

Horovod's main path: the model's causal attention runs through the flash
kernel, the loss is the mean softmax cross-entropy on integer labels,
gradients are averaged across processes in fusion buckets while backward
runs, and the wrapped optimizer steps. Without a mesh each process trains
on its own batch (data parallelism), and the step injects flash attention
through ``attention_fn`` itself, as the JAX Ulysses adapter does around its
inner attention.

With a mesh (``mesh_utils.make_training_mesh``) the step takes the global
batch, the same on every process, and each process runs the model on its
block of it: the rows of its (dp, fsdp) block and the columns of its sp
block, with the positions of those columns. When sp > 1 the attention is
ring or Ulysses over the mesh's sp group, through the flash kernel
(:func:`sharded_attention`); at sp = 1 it stays plain flash. Gradients are
averaged over the whole world by the DistributedOptimizer: the ring's and
the all-to-all's backward carry each process's share of the K/V gradients
home, so with equal blocks the world mean is the gradient of the global
mean loss, as the JAX package's one SPMD program computes it. Processes
that differ only in pp or ep hold the same block and average as replicas.
Parameters are not sharded: tp > 1 and fsdp > 1 raise.
"""

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from .. import collectives as _c
from ..basics import resolve_device
from ..models.transformer import Transformer, TransformerConfig
from ..ops.flash_attention import flash_attention
from ..optimizer import DistributedOptimizer
from .mesh_utils import axis_size, batch_spec

ATTENTION_KINDS = ("ring", "ulysses")


def flash_attention_fn(q, k, v, mask, dtype):
    """``TransformerConfig.attention_fn`` running the flash kernel
    (causal masking happens inside it)."""
    del mask
    return flash_attention(q, k, v, causal=True, out_dtype=dtype)


def sharded_attention(mesh, kind: str = "ring", causal: bool = True):
    """A ``TransformerConfig.attention_fn`` running context-parallel over
    the mesh's 'sp' group: ring attention (``kind="ring"``) or Ulysses
    (``"ulysses"``), both through the flash kernel. None when sp == 1."""
    from .ring_attention import make_ring_attention
    from .ulysses import make_ulysses_attention

    if kind not in ATTENTION_KINDS:
        raise ValueError(f"attention_kind must be one of {ATTENTION_KINDS}, "
                         f"got {kind!r}")
    if axis_size(mesh, "sp") == 1:
        return None
    group = mesh.get_group("sp")
    if kind == "ring":
        return make_ring_attention(group, causal=causal)
    return make_ulysses_attention(group, causal=causal)


def default_optimizer(params) -> torch.optim.Optimizer:
    """The counterpart of ``optax.adamw(1e-3)``: optax's weight decay is
    1e-4 (torch's default is 1e-2)."""
    return torch.optim.AdamW(params, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


@dataclasses.dataclass
class TrainStepBundle:
    model: Transformer
    optimizer: DistributedOptimizer
    #: (tokens, targets) -> detached scalar loss of the step
    step: Callable


def _check_mesh(mesh, cfg: TransformerConfig, dev: torch.device) -> None:
    for axis in ("tp", "fsdp"):
        if axis_size(mesh, axis) > 1:
            raise NotImplementedError(
                f"{axis} > 1 shards parameters, which horovod_tpu_torch "
                f"does not do yet (ROADMAP A1: tp and fsdp parameter "
                f"sharding); use a mesh with tp = fsdp = 1")
    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type} but the model "
                         f"on {dev}")
    sp = axis_size(mesh, "sp")
    if cfg.max_seq_len % sp != 0:
        raise ValueError(f"seq len {cfg.max_seq_len} not divisible by "
                         f"sp={sp}")


def make_transformer_train_step(
        cfg: TransformerConfig, device=None,
        optimizer: Optional[Callable] = None, attention: str = "flash",
        generator: Optional[torch.Generator] = None, mesh=None,
        attention_kind: str = "ring") -> TrainStepBundle:
    """Build the model, its DistributedOptimizer and the step function.

    ``optimizer``: a callable taking the model's parameters and returning a
    ``torch.optim`` optimizer (default :func:`default_optimizer`).
    ``attention``: "flash" (the kernel) or "default" (the model's plain
    softmax attention, for comparison; not on a mesh with sp > 1). ``generator`` draws the initial
    weights (default: seed 0 on the device). ``mesh``: a training mesh
    (see the module docstring); then ``attention_kind`` ("ring" or
    "ulysses") picks the sequence-parallel attention when sp > 1, and the
    step takes the global batch and returns the global mean loss. Needs
    ``init()`` first."""
    dev = resolve_device(device)
    if attention not in ("flash", "default"):
        raise ValueError(f"attention must be 'flash' or 'default', "
                         f"got {attention!r}")
    attn = flash_attention_fn if attention == "flash" else None
    if mesh is not None:
        _check_mesh(mesh, cfg, dev)
        if attention != "flash" and axis_size(mesh, "sp") > 1:
            raise ValueError(f"attention={attention!r} cannot run on a "
                             f"sequence shard; sp > 1 takes attention="
                             f"'flash' and attention_kind 'ring' or "
                             f"'ulysses'")
        attn = sharded_attention(mesh, attention_kind) or attn
    cfg = dataclasses.replace(cfg, attention_fn=attn)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = Transformer(cfg, device=dev, generator=generator)
    opt = DistributedOptimizer((optimizer or default_optimizer)(
        model.parameters()), named_parameters=model.named_parameters())

    def step(tokens, targets):
        pos_offset = 0
        if mesh is not None:   # this rank's block of the global batch
            rows, cols = batch_spec(mesh, *tokens.shape[:2])
            tokens, targets = tokens[rows, cols], targets[rows, cols]
            pos_offset = cols.start
        opt.zero_grad(set_to_none=True)
        logits = model(tokens.to(dev), pos_offset)
        loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                               targets.to(dev).reshape(-1).long())
        loss.backward()
        opt.step()
        if mesh is None:
            return loss.detach()
        return _c.allreduce(loss.detach(), op=_c.Average, name="mesh.loss")

    return TrainStepBundle(model=model, optimizer=opt, step=step)
