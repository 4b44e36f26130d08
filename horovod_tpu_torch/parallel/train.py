"""Data-parallel training step for the transformer (counterpart of
``horovod_tpu/parallel/train.py``'s ``make_transformer_train_step`` on a
mesh with no sequence parallelism).

Horovod's main path: the model's causal attention runs through the flash
kernel, the loss is the mean softmax cross-entropy on integer labels,
gradients are averaged across processes in fusion buckets while backward
runs, and the wrapped optimizer steps. On one chip the JAX package's
``sharded_attention`` returns None (sp == 1) and the model keeps its
default attention; here the step injects flash attention through
``attention_fn`` itself, as the JAX Ulysses adapter does around its inner
attention.
"""

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..basics import resolve_device
from ..models.transformer import Transformer, TransformerConfig
from ..ops.flash_attention import flash_attention
from ..optimizer import DistributedOptimizer


def flash_attention_fn(q, k, v, mask, dtype):
    """``TransformerConfig.attention_fn`` running the flash kernel
    (causal masking happens inside it)."""
    del mask
    return flash_attention(q, k, v, causal=True, out_dtype=dtype)


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


def make_transformer_train_step(
        cfg: TransformerConfig, device=None,
        optimizer: Optional[Callable] = None, attention: str = "flash",
        generator: Optional[torch.Generator] = None) -> TrainStepBundle:
    """Build the model, its DistributedOptimizer and the step function.

    ``optimizer``: a callable taking the model's parameters and returning a
    ``torch.optim`` optimizer (default :func:`default_optimizer`).
    ``attention``: "flash" (the kernel) or "default" (the model's plain
    softmax attention, for comparison). ``generator`` draws the initial
    weights (default: seed 0 on the device). Needs ``init()`` first."""
    dev = resolve_device(device)
    if attention == "flash":
        cfg = dataclasses.replace(cfg, attention_fn=flash_attention_fn)
    elif attention == "default":
        cfg = dataclasses.replace(cfg, attention_fn=None)
    else:
        raise ValueError(f"attention must be 'flash' or 'default', "
                         f"got {attention!r}")
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    model = Transformer(cfg, device=dev, generator=generator)
    opt = DistributedOptimizer((optimizer or default_optimizer)(
        model.parameters()), named_parameters=model.named_parameters())

    def step(tokens, targets):
        opt.zero_grad(set_to_none=True)
        logits = model(tokens.to(dev))
        loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                               targets.to(dev).reshape(-1).long())
        loss.backward()
        opt.step()
        return loss.detach()

    return TrainStepBundle(model=model, optimizer=opt, step=step)
