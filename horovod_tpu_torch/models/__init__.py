"""Models of horovod_tpu_torch (counterpart of ``horovod_tpu/models``)."""

from .convert import (  # noqa: F401
    moe_params_from_jax, params_from_flax, params_to_flax)
from .transformer import Transformer, TransformerConfig  # noqa: F401
