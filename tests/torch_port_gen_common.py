"""Shared set-up of the generation-plane parity tests
(``tests/test_torch_port_generation*.py``, ``_speculative.py``,
``_disagg.py``): one tiny transformer built by the JAX package and carried
into the port, and engines of both packages over the same knobs.

The size is the tests' own: 2 layers, d_model 32, 2 heads of 16, vocab
97, blocks of 4 tokens, ``dtype=float32`` on both sides (bf16
activations keep the packages apart in the third significant digit).
"""

import functools

import numpy as np

import jax
import jax.numpy as jnp
from flax.linen import meta

import torch

from horovod_tpu.models import transformer as jtr
from horovod_tpu.serving.generation import GenerationEngine as JEngine
from horovod_tpu_torch.models import transformer as ttr
from horovod_tpu_torch.models.convert import params_from_flax
from horovod_tpu_torch.serving.generation import GenerationEngine as TEngine

VOCAB = 97
MAX_LEN = 64
BLOCK = 4

JCFG = jtr.TransformerConfig(vocab_size=VOCAB, num_layers=2, d_model=32,
                             num_heads=2, head_dim=16, max_seq_len=MAX_LEN,
                             dtype=jnp.float32)
TCFG = ttr.TransformerConfig(vocab_size=VOCAB, num_layers=2, d_model=32,
                             num_heads=2, head_dim=16, max_seq_len=MAX_LEN,
                             dtype=torch.float32)

#: the engines' shared knobs (each test may override)
ENGINE_KW = dict(block_size=BLOCK, num_blocks=41, max_seqs=4,
                 prefill_chunk=8, deadline_ms=0, reload_poll_seconds=0)


@functools.lru_cache(maxsize=1)
def models():
    """(JAX module, JAX variables, port module on meta, port params)."""
    jmodel = jtr.Transformer(JCFG)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))
    unboxed = meta.unbox(variables["params"])
    tparams = params_from_flax(jax.tree_util.tree_map(np.asarray, unboxed))
    return jmodel, variables, ttr.Transformer(TCFG, device="meta"), tparams


def jax_engine(**kw):
    jmodel, variables, _, _ = models()
    args = dict(ENGINE_KW, **kw)
    return JEngine(jmodel, params=variables, **args)


def port_engine(**kw):
    _, _, tmodel, tparams = models()
    args = dict(ENGINE_KW, **kw)
    args.setdefault("device", "cpu")
    return TEngine(tmodel, params=tparams, **args)


def prompts(seed: int, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (n,)).tolist() for n in lengths]


def run_all(engine, reqs, timeout=60.0):
    """Submit every request at once (dicts of submit kwargs); return
    [(tokens, logprobs)] in request order."""
    seqs = [engine.submit(**r) for r in reqs]
    out = []
    for s in seqs:
        toks = engine.result(s, timeout=timeout)
        out.append((toks, list(s.logprobs)))
    return out
