"""ResNet v1.5 in PyTorch (counterpart of ``horovod_tpu/models/resnet.py``).

Same modules, names and parameter shapes as the flax module, so weights
cross packages by name (:mod:`.convert`): ``conv_init``, ``bn_init``,
``BottleneckBlock_<k>`` / ``BasicBlock_<k>`` numbered through all stages,
each holding ``Conv_<i>``, ``BatchNorm_<i>`` and, where the block changes
shape, ``conv_proj`` and ``norm_proj``; then ``Dense_0``. Images are NCHW
(``channels_last`` memory is NHWC underneath, the layout the JAX package
computes in).

Mixed precision as in the JAX module: fp32 parameters, convs in ``dtype``
(bf16 by default), BatchNorm statistics in fp32, the last BatchNorm of
each block starting at scale 0, and the classifier in fp32 on the pooled
features cast to fp32. Every conv pads as flax's does: the 7x7 stem
(3, 3), the stride-2 3x3 convs XLA's SAME (0, 1) on even inputs, and the
max-pool (1, 1) with -inf.
"""

from functools import partial
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..basics import resolve_device
from .layers import BatchNorm, Conv, Dense, lecun_normal_


class SpaceToDepthStem(nn.Module):
    """The 7x7 stride-2 input conv computed as a 2x2 space-to-depth of the
    image (C -> 4C channels at half the size) and a 4x4 stride-1 conv
    whose kernel is the 7x7 kernel zero-padded to 8x8 and regrouped: the
    same function (the JAX package's TPU layout trick). ``kernel`` is the
    7x7 stem's own (features, C, 7, 7) parameter, regrouped on every call,
    so a ``state_dict`` serves either stem."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(features, in_features, 7, 7, device=device),
            in_features * 49, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape
        if h % 2 or w % 2:
            raise ValueError(f"space_to_depth stem needs even spatial dims, "
                             f"got {tuple(x.shape)}")
        f = self.kernel.shape[0]
        # 7x7 -> 8x8 with one leading zero row and column; tap q of parity
        # d reads original row 2q + d - 1, the rows the strided window reads
        k = F.pad(self.kernel, (1, 0, 1, 0)).reshape(f, c, 4, 2, 4, 2)
        k = k.permute(0, 3, 5, 1, 2, 4).reshape(f, 4 * c, 4, 4)
        z = x.reshape(n, c, h // 2, 2, w // 2, 2)
        z = z.permute(0, 3, 5, 1, 2, 4).reshape(n, 4 * c, h // 2, w // 2)
        # pads (2, 1): output row r reads taps r-2 .. r+1, the half-size
        # image of the pad-3 7x7 stride-2 window
        z = F.pad(z.to(self.dtype), (2, 1, 2, 1))
        return F.conv2d(z, k.to(self.dtype))


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, filters: int,
                 strides: Tuple[int, int], dtype, device, generator):
        super().__init__()
        conv = partial(Conv, use_bias=False, dtype=dtype, device=device,
                       generator=generator)
        norm = partial(BatchNorm, dtype=dtype, device=device)
        out = filters * 4
        self.Conv_0 = conv(in_features, filters, (1, 1))
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3), strides)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, out, (1, 1))
        self.BatchNorm_2 = norm(out, zero_scale=True)
        if in_features != out or tuple(strides) != (1, 1):
            self.conv_proj = conv(in_features, out, (1, 1), strides)
            self.norm_proj = norm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, filters: int,
                 strides: Tuple[int, int], dtype, device, generator):
        super().__init__()
        conv = partial(Conv, use_bias=False, dtype=dtype, device=device,
                       generator=generator)
        norm = partial(BatchNorm, dtype=dtype, device=device)
        self.Conv_0 = conv(in_features, filters, (3, 3), strides)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3))
        self.BatchNorm_1 = norm(filters, zero_scale=True)
        if in_features != filters or tuple(strides) != (1, 1):
            self.conv_proj = conv(in_features, filters, (1, 1), strides)
            self.norm_proj = norm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = x
        if hasattr(self, "conv_proj"):
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """NCHW RGB images -> fp32 logits. ``stem``: "conv" (the 7x7 stride-2
    conv) or "space_to_depth" (:class:`SpaceToDepthStem`, the same
    function and parameters). Parameters are made on ``device`` (cuda
    unless asked otherwise) with ``generator`` in the flax module's
    order: lecun-normal kernels, BatchNorm scales 1 (0 for each block's
    last), biases 0. ``module.train()`` / ``eval()`` is flax's
    ``train=True`` / ``False``."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, stem: str = "conv",
                 device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.stem = stem
        if stem == "space_to_depth":
            self.conv_init = SpaceToDepthStem(3, num_filters, dtype, dev,
                                              generator)
        elif stem == "conv":
            self.conv_init = Conv(3, num_filters, (7, 7), (2, 2),
                                  padding=((3, 3), (3, 3)), use_bias=False,
                                  dtype=dtype, device=dev,
                                  generator=generator)
        else:
            # a mistyped knob must fail, not measure the other stem
            raise ValueError(f"unknown stem {stem!r}; expected 'conv' or "
                             f"'space_to_depth'")
        self.bn_init = BatchNorm(num_filters, dtype=dtype, device=dev)
        self.block_names = []
        features = num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                filters = num_filters * 2 ** i
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                setattr(self, name, block_cls(features, filters, strides,
                                              dtype, dev, generator))
                self.block_names.append(name)
                features = filters * block_cls.expansion
        self.Dense_0 = Dense(features, num_classes, torch.float32, dev,
                             generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        # fp32 classifier, for a stable softmax and loss
        return self.Dense_0(x.mean(dim=(2, 3)).float())


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3],
                   block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3],
                    block_cls=BottleneckBlock)
