"""Small MLP, the MNIST-class model (counterpart of
``horovod_tpu/models/mlp.py``): ``Dense_<i>`` hidden layers with ReLU in
``dtype`` and an fp32 classifier. Images are flattened in flax's NHWC
order, so the first kernel's rows are the JAX module's."""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..basics import resolve_device
from .layers import Dense, nhwc_flatten


class MLP(nn.Module):
    """``in_features`` inputs (28 x 28 x 1 by default; flax infers it)."""

    def __init__(self, features: Sequence[int] = (128, 128),
                 num_classes: int = 10, dtype: torch.dtype = torch.float32,
                 in_features: int = 784, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        widths = (in_features, *features)
        self.num_hidden = len(features)
        for i, (fan_in, f) in enumerate(zip(widths, features)):
            setattr(self, f"Dense_{i}", Dense(fan_in, f, dtype, dev,
                                              generator))
        setattr(self, f"Dense_{len(features)}",
                Dense(widths[-1], num_classes, torch.float32, dev, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_flatten(x) if x.dim() == 4 else x.reshape(x.shape[0], -1)
        for i in range(self.num_hidden):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.num_hidden}")(x.float())
