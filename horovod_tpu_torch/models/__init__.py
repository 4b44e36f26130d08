"""Models of horovod_tpu_torch (counterpart of ``horovod_tpu/models``)."""

from .convert import moe_params_from_jax, params_from_flax  # noqa: F401
from .transformer import Transformer, TransformerConfig  # noqa: F401
