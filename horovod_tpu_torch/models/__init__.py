"""Models of horovod_tpu_torch (counterpart of ``horovod_tpu/models``):
the transformer trainer's model and the CNN zoo of the benchmark (ResNet,
VGG, Inception V3, MLP), under the JAX package's names."""

from .convert import (  # noqa: F401
    cnn_params_from_flax, cnn_params_to_flax, moe_params_from_jax,
    params_from_flax, params_to_flax)
from .inception import InceptionV3  # noqa: F401
from .mlp import MLP  # noqa: F401
from .resnet import (  # noqa: F401
    ResNet, ResNet18, ResNet34, ResNet50, ResNet101, ResNet152)
from .transformer import Transformer, TransformerConfig  # noqa: F401
from .vgg import VGG, VGG11, VGG13, VGG16, VGG19  # noqa: F401
