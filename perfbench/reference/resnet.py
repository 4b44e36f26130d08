"""ResNet v1.5 in plain PyTorch (He et al., arXiv:1512.03385, Table 1,
with the stride of each downsampling bottleneck on its 3x3 convolution, as
MLPerf Training's image-classification reference has it).

Padding is flax's, written out: the 7x7 stride-2 stem pads (3, 3), every
other convolution pads by XLA's SAME rule (the total pad a dimension needs
split with the odd pixel at the high end, so a 3x3 stride-2 convolution on
an even input pads (0, 1)), and the 3x3 stride-2 max-pool pads (1, 1) with
-inf. BatchNorm normalises by the batch mean and *biased* variance and
moves its running statistics toward them by ``1 - momentum``. The
classifier reads the spatial mean.

Leaves (by the program's parameter names): ``conv_init.kernel``
(64, 3, 7, 7) and ``bn_init.scale``/``.bias``, per block
``BottleneckBlock_<k>.Conv_<i>.kernel`` (OIHW) and ``.BatchNorm_<i>.*``,
``conv_proj.kernel``/``norm_proj.*`` where the block changes shape, and
``Dense_0.kernel`` (classes, 2048) and ``Dense_0.bias``. The running
statistics are buffers ``<norm>.mean`` and ``<norm>.var``.
"""

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .precision import Precision


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv(x, kernel, stride: int, prec: Precision, pads=None):
    k = kernel.shape[2]
    if pads is None:
        pads = (same_pads(x.shape[2], k, stride),
                same_pads(x.shape[3], k, stride))
    (top, bottom), (left, right) = pads
    x = F.pad(x, (left, right, top, bottom))
    return prec.act(F.conv2d(prec.op(x), prec.op(kernel), stride=stride))


def batch_norm(x, w, name: str, eps: float, stats: dict, prec: Precision):
    mean = x.mean(dim=(0, 2, 3))
    centred = x - mean[None, :, None, None]
    var = centred.square().mean(dim=(0, 2, 3))
    stats[name] = (mean.detach(), var.detach())
    return prec.act(centred * torch.rsqrt(var + eps)[None, :, None, None]
                    * w[name + ".scale"][None, :, None, None]
                    + w[name + ".bias"][None, :, None, None])


def blocks(cfg: dict) -> List[Tuple[str, int, bool]]:
    """(name, stride, has projection) of every bottleneck block."""
    out, features = [], cfg["num_filters"]
    for i, count in enumerate(cfg["stage_sizes"]):
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            filters = cfg["num_filters"] * 2 ** i
            proj = features != filters * 4 or stride != 1
            out.append((f"BottleneckBlock_{len(out)}", stride, proj))
            features = filters * 4
    return out


def _block(x, w, name, stride, proj, eps, prec):
    stats = {}
    y = F.relu(batch_norm(conv(x, w[name + ".Conv_0.kernel"], 1, prec), w,
                          name + ".BatchNorm_0", eps, stats, prec))
    y = F.relu(batch_norm(conv(y, w[name + ".Conv_1.kernel"], stride, prec),
                          w, name + ".BatchNorm_1", eps, stats, prec))
    y = batch_norm(conv(y, w[name + ".Conv_2.kernel"], 1, prec), w,
                   name + ".BatchNorm_2", eps, stats, prec)
    if proj:
        x = batch_norm(conv(x, w[name + ".conv_proj.kernel"], stride, prec),
                       w, name + ".norm_proj", eps, stats, prec)
    return prec.act(F.relu(x + y)), stats


def loss_sum(w: Dict[str, torch.Tensor], images, labels, cfg: dict,
             prec: Precision, recompute: bool = True):
    """(summed cross-entropy, {norm: (batch mean, biased batch var)}).
    With ``recompute`` each block is recomputed in the backward
    (activation checkpointing) so that a batch of 256 fits in float32."""
    eps = cfg["bn_epsilon"]
    stats = {}
    x = conv(images, w["conv_init.kernel"], 2, prec, pads=((3, 3), (3, 3)))
    x = F.relu(batch_norm(x, w, "bn_init", eps, stats, prec))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for name, stride, proj in blocks(cfg):
        if recompute:
            x, s = checkpoint(_block, x, w, name, stride, proj, eps, prec,
                              use_reentrant=False)
        else:
            x, s = _block(x, w, name, stride, proj, eps, prec)
        stats.update(s)
    feats = x.mean(dim=(2, 3))
    logits = prec.op(feats) @ prec.op(w["Dense_0.kernel"]).t() \
        + w["Dense_0.bias"]
    picked = logits.gather(-1, labels[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - picked).sum(), stats


def loss_and_grads(w: Dict[str, torch.Tensor], batch, cfg: dict,
                   prec: Precision):
    """The mean loss of ``batch`` = (images, labels), its gradient, and
    the batch statistics of every BatchNorm. BatchNorm takes its
    statistics over the whole batch, so the batch is not split."""
    images, labels = batch
    leaves = {n: t.detach().requires_grad_(True) for n, t in w.items()}
    total, stats = loss_sum(leaves, images.float(), labels, cfg, prec)
    loss = total / images.shape[0]
    loss.backward()
    return loss.item(), {n: t.grad for n, t in leaves.items()}, stats


def update_running(buffers: Dict[str, torch.Tensor], stats: dict,
                   cfg: dict) -> None:
    """Move every running mean and variance toward its batch statistic by
    ``1 - bn_momentum``."""
    momentum = cfg["bn_momentum"]
    with torch.no_grad():
        for name, (mean, var) in stats.items():
            buffers[name + ".mean"].mul_(momentum).add_(
                mean, alpha=1 - momentum)
            buffers[name + ".var"].mul_(momentum).add_(
                var, alpha=1 - momentum)
