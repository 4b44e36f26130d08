"""VGG in PyTorch (counterpart of ``horovod_tpu/models/vgg.py``).

Same names and shapes as the flax module (``Conv_<i>`` numbered through
all stages, ``Dense_0`` .. ``Dense_2``), bf16 convs and hidden dense
layers on fp32 parameters, no BatchNorm, and an fp32 classifier. The
features are flattened in flax's NHWC order (H, W, C), so ``Dense_0``'s
rows are the JAX module's; ``image_size`` fixes their number (flax infers
it at init).
"""

from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..basics import resolve_device
from .layers import Conv, Dense, nhwc_flatten

# 3x3 convs per stage (between max-pools), the classic configurations
_CFG = {
    "vgg11": (1, 1, 2, 2, 2),
    "vgg13": (2, 2, 2, 2, 2),
    "vgg16": (2, 2, 3, 3, 3),
    "vgg19": (2, 2, 4, 4, 4),
}
_WIDTHS = (64, 128, 256, 512, 512)


class VGG(nn.Module):
    """NCHW RGB images of ``image_size`` -> fp32 logits; dropout after each
    hidden dense layer in training mode."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16,
                 classifier_width: int = 4096, dropout_rate: float = 0.5,
                 image_size: int = 224, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.stage_sizes = tuple(stage_sizes)
        self.dropout_rate = dropout_rate
        convs = []
        features, size = 3, image_size
        for width, reps in zip(_WIDTHS, self.stage_sizes):
            for _ in range(reps):
                convs.append(Conv(features, width, (3, 3), dtype=dtype,
                                  device=dev, generator=generator))
                features = width
            size //= 2
        for i, conv in enumerate(convs):
            setattr(self, f"Conv_{i}", conv)
        self.Dense_0 = Dense(features * size * size, classifier_width,
                             dtype, dev, generator)
        self.Dense_1 = Dense(classifier_width, classifier_width, dtype, dev,
                             generator)
        self.Dense_2 = Dense(classifier_width, num_classes, torch.float32,
                             dev, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i = 0
        for reps in self.stage_sizes:
            for _ in range(reps):
                x = F.relu(getattr(self, f"Conv_{i}")(x))
                i += 1
            x = F.max_pool2d(x, 2, 2)
        x = nhwc_flatten(x)
        for dense in (self.Dense_0, self.Dense_1):
            x = F.dropout(F.relu(dense(x)), self.dropout_rate,
                          self.training)
        return self.Dense_2(x)


VGG11 = partial(VGG, stage_sizes=_CFG["vgg11"])
VGG13 = partial(VGG, stage_sizes=_CFG["vgg13"])
VGG16 = partial(VGG, stage_sizes=_CFG["vgg16"])
VGG19 = partial(VGG, stage_sizes=_CFG["vgg19"])
