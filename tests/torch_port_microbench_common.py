"""Shared helpers of the microbench parity tests
(``tests/test_torch_port_microbench*.py``): the JAX sweeps' own
transformer parameters (``PRNGKey(0)`` at each sweep's configuration)
carried into the port, and a recursive comparison of result keys."""

import numpy as np

import jax
import jax.numpy as jnp
from flax.linen import meta

from horovod_tpu.models import transformer as jtr
from horovod_tpu_torch.models.convert import params_from_flax

#: the configurations the JAX sweeps build (horovod_tpu/microbench.py)
GEN_CFG = dict(vocab_size=512, num_layers=4, d_model=128, num_heads=4,
               head_dim=32, max_seq_len=128)
SPEC_CFG = dict(vocab_size=512, num_layers=8, d_model=256, num_heads=4,
                head_dim=64, max_seq_len=256)


def resume_cfg(emitted: int, prompt_len: int = 8) -> dict:
    return dict(GEN_CFG, max_seq_len=prompt_len + emitted + 8)


def jax_params_for_port(cfg: dict):
    """The port's flat parameter dict of the JAX sweep's model."""
    model = jtr.Transformer(jtr.TransformerConfig(dtype=jnp.float32, **cfg))
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 4), jnp.int32))
    unboxed = meta.unbox(variables["params"])
    return params_from_flax(jax.tree_util.tree_map(np.asarray, unboxed))


def key_tree(obj):
    """The nested key structure of a result (lists by their first
    element), values dropped."""
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()}
    if isinstance(obj, list) and obj and isinstance(obj[0], dict):
        return [key_tree(obj[0])]
    return None
