"""Inception V3 in PyTorch (counterpart of
``horovod_tpu/models/inception.py``).

The tf-slim topology of the JAX module with its names: the stem's
``ConvBN_0`` .. ``ConvBN_4``, ``InceptionA_0..2``, ``InceptionB_0``,
``InceptionC_0..3``, ``InceptionD_0``, ``InceptionE_0..1`` and
``Dense_0``; each ``ConvBN`` holds ``Conv_0`` and ``BatchNorm_0``
(epsilon 1e-3). The optional auxiliary head (``ConvBN_5``, ``ConvBN_6``,
``aux_head``) reads the 17x17 grid; its last conv spans the whole pooled
grid, whose size follows from ``image_size`` (flax reads it from the
input). bf16 convs on fp32 parameters, fp32 BatchNorm statistics, fp32
classifiers.
"""

from functools import partial
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..basics import resolve_device
from .layers import BatchNorm, Conv, Dense, nhwc_flatten


class ConvBN(nn.Module):
    """conv -> BatchNorm -> relu, the Inception unit."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int] = (1, 1),
                 strides: Tuple[int, int] = (1, 1), padding: str = "SAME",
                 dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel, strides, padding,
                           use_bias=False, dtype=dtype, device=device,
                           generator=generator)
        self.BatchNorm_0 = BatchNorm(features, epsilon=1e-3, dtype=dtype,
                                     device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


def _avg_pool_same(x):
    # flax avg_pool "SAME" counts the zero padding in the mean
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=True)


class _Block(nn.Module):
    """Numbers its ConvBN units ``ConvBN_<i>`` in creation order; the
    branches hold them in plain lists, so each is registered once."""

    def __init__(self, dtype, device, generator):
        super().__init__()
        self._cb = partial(ConvBN, dtype=dtype, device=device,
                           generator=generator)
        self._n = 0

    def cb(self, in_features: int, *args, **kwargs) -> ConvBN:
        unit = self._cb(in_features, *args, **kwargs)
        setattr(self, f"ConvBN_{self._n}", unit)
        self._n += 1
        return unit


class InceptionA(_Block):
    def __init__(self, in_features: int, pool_features: int, dtype,
                 device, generator):
        super().__init__(dtype, device, generator)
        self.b1 = [self.cb(in_features, 64)]
        self.b2 = [self.cb(in_features, 48), self.cb(48, 64, (5, 5))]
        self.b3 = [self.cb(in_features, 64), self.cb(64, 96, (3, 3)),
                   self.cb(96, 96, (3, 3))]
        self.b4 = [self.cb(in_features, pool_features)]
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b2, x),
                          _chain(self.b3, x),
                          _chain(self.b4, _avg_pool_same(x))],
                         dim=1)


class InceptionB(_Block):
    """Grid reduction 35x35 -> 17x17."""

    def __init__(self, in_features: int, dtype, device, generator):
        super().__init__(dtype, device, generator)
        self.b1 = [self.cb(in_features, 384, (3, 3), (2, 2), "VALID")]
        self.b2 = [self.cb(in_features, 64), self.cb(64, 96, (3, 3)),
                   self.cb(96, 96, (3, 3), (2, 2), "VALID")]
        self.out_features = 384 + 96 + in_features

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b2, x),
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionC(_Block):
    """Factorized 7x7 branches."""

    def __init__(self, in_features: int, channels_7x7: int, dtype, device,
                 generator):
        super().__init__(dtype, device, generator)
        c7 = channels_7x7
        self.b1 = [self.cb(in_features, 192)]
        self.b2 = [self.cb(in_features, c7), self.cb(c7, c7, (1, 7)),
                   self.cb(c7, 192, (7, 1))]
        self.b3 = [self.cb(in_features, c7), self.cb(c7, c7, (7, 1)),
                   self.cb(c7, c7, (1, 7)), self.cb(c7, c7, (7, 1)),
                   self.cb(c7, 192, (1, 7))]
        self.b4 = [self.cb(in_features, 192)]
        self.out_features = 4 * 192

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b2, x),
                          _chain(self.b3, x),
                          _chain(self.b4, _avg_pool_same(x))],
                         dim=1)


class InceptionD(_Block):
    """Grid reduction 17x17 -> 8x8."""

    def __init__(self, in_features: int, dtype, device, generator):
        super().__init__(dtype, device, generator)
        self.b1 = [self.cb(in_features, 192),
                   self.cb(192, 320, (3, 3), (2, 2), "VALID")]
        self.b2 = [self.cb(in_features, 192), self.cb(192, 192, (1, 7)),
                   self.cb(192, 192, (7, 1)),
                   self.cb(192, 192, (3, 3), (2, 2), "VALID")]
        self.out_features = 320 + 192 + in_features

    def forward(self, x):
        return torch.cat([_chain(self.b1, x), _chain(self.b2, x),
                          F.max_pool2d(x, 3, 2)], dim=1)


class InceptionE(_Block):
    """Expanded filter banks (split 3x3s concatenated)."""

    def __init__(self, in_features: int, dtype, device, generator):
        super().__init__(dtype, device, generator)
        self.b1 = [self.cb(in_features, 320)]
        self.b2 = [self.cb(in_features, 384)]
        self.b2_split = [self.cb(384, 384, (1, 3)), self.cb(384, 384, (3, 1))]
        self.b3 = [self.cb(in_features, 448), self.cb(448, 384, (3, 3))]
        self.b3_split = [self.cb(384, 384, (1, 3)), self.cb(384, 384, (3, 1))]
        self.b4 = [self.cb(in_features, 192)]
        self.out_features = 320 + 4 * 384 + 192

    def forward(self, x):
        b2 = _chain(self.b2, x)
        b3 = _chain(self.b3, x)
        return torch.cat([_chain(self.b1, x), *(u(b2) for u in self.b2_split),
                          *(u(b3) for u in self.b3_split),
                          _chain(self.b4, _avg_pool_same(x))], dim=1)


def _chain(units, x):
    for unit in units:
        x = unit(x)
    return x


def _grid_sizes(image_size: int) -> Tuple[int, int]:
    """(the 17x17 grid's size, the aux head's pooled size) for square
    images of ``image_size``."""
    s = (image_size - 3) // 2 + 1      # 3x3 stride 2 VALID
    s = s - 2                          # 3x3 VALID
    s = (s - 3) // 2 + 1               # max-pool 3 stride 2
    s = s - 2                          # 3x3 VALID
    s = (s - 3) // 2 + 1               # max-pool 3 stride 2
    s = (s - 3) // 2 + 1               # InceptionB
    return s, (s - 5) // 3 + 1         # aux: avg-pool 5 stride 3 VALID


class InceptionV3(nn.Module):
    """NCHW RGB images -> fp32 logits, or (logits, aux logits) with
    ``aux_logits``; dropout before the classifier in training mode."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16,
                 aux_logits: bool = False, dropout_rate: float = 0.5,
                 image_size: int = 299, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.aux_logits = aux_logits
        self.dropout_rate = dropout_rate
        cb = partial(ConvBN, dtype=dtype, device=dev, generator=generator)
        blk = dict(dtype=dtype, device=dev, generator=generator)
        # stem: 299x299x3 -> 35x35x192
        self.ConvBN_0 = cb(3, 32, (3, 3), (2, 2), "VALID")
        self.ConvBN_1 = cb(32, 32, (3, 3), padding="VALID")
        self.ConvBN_2 = cb(32, 64, (3, 3))
        self.ConvBN_3 = cb(64, 80, (1, 1), padding="VALID")
        self.ConvBN_4 = cb(80, 192, (3, 3), padding="VALID")
        f = 192
        for i, pool in enumerate((32, 64, 64)):
            setattr(self, f"InceptionA_{i}", InceptionA(f, pool, **blk))
            f = getattr(self, f"InceptionA_{i}").out_features
        self.InceptionB_0 = InceptionB(f, **blk)
        f = self.InceptionB_0.out_features
        for i, c7 in enumerate((128, 160, 160, 192)):
            setattr(self, f"InceptionC_{i}", InceptionC(f, c7, **blk))
        if aux_logits:
            _, pooled = _grid_sizes(image_size)
            if pooled < 1:
                raise ValueError(f"the aux head needs images of at least "
                                 f"107 px, got {image_size}")
            self.ConvBN_5 = cb(f, 128)
            self.ConvBN_6 = cb(128, 768, (pooled, pooled), padding="VALID")
            self.aux_head = Dense(768, num_classes, torch.float32, dev,
                                  generator)
        self.InceptionD_0 = InceptionD(f, **blk)
        f = self.InceptionD_0.out_features
        self.InceptionE_0 = InceptionE(f, **blk)
        self.InceptionE_1 = InceptionE(self.InceptionE_0.out_features, **blk)
        self.Dense_0 = Dense(self.InceptionE_1.out_features, num_classes,
                             torch.float32, dev, generator)

    def forward(self, x: torch.Tensor):
        for i in range(5):
            x = getattr(self, f"ConvBN_{i}")(x)
            if i in (2, 4):
                x = F.max_pool2d(x, 3, 2)
        for name in ("InceptionA_0", "InceptionA_1", "InceptionA_2",
                     "InceptionB_0", "InceptionC_0", "InceptionC_1",
                     "InceptionC_2", "InceptionC_3"):
            x = getattr(self, name)(x)
        aux = None
        if self.aux_logits:
            a = self.ConvBN_6(self.ConvBN_5(F.avg_pool2d(x, 5, 3)))
            aux = self.aux_head(nhwc_flatten(a).float())
        x = self.InceptionD_0(x)
        x = self.InceptionE_1(self.InceptionE_0(x))
        x = F.dropout(x.mean(dim=(2, 3)), self.dropout_rate, self.training)
        x = self.Dense_0(x.float())
        return (x, aux) if self.aux_logits else x
