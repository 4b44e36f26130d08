"""Continuous-batching generation: the decode-native serving plane
(counterpart of ``horovod_tpu/serving/generation``).

* :mod:`.kv_cache` — paged KV cache: fixed-size block pools
  (``HVD_TPU_GEN_BLOCK_SIZE`` x ``HVD_TPU_GEN_NUM_BLOCKS``), a strict
  refcounting block allocator with automatic prefix caching
  (``HVD_TPU_GEN_PREFIX_CACHE``), and the prefill/decode/verify/beam
  programs, plain static-shape torch functions that **sample on the
  device** (greedy/temperature/top-k/top-p, seeded per request through
  the port's threefry, :mod:`._threefry`) and return ``(B,)`` token ids
  and logprobs, never logits;
* :mod:`.scheduler` — :class:`ContinuousBatcher`: iteration-level
  scheduling (admit / one prefill chunk / one decode step, every step),
  immediate retirement on EOS or ``max_tokens``, preempt-and-requeue on
  block exhaustion, per-token deadlines; decode state lives on the
  device (re-uploaded only on batch membership changes) and
  ``HVD_TPU_GEN_ASYNC_DEPTH=1`` overlaps host scheduling with the
  in-flight step;
* :mod:`.engine` — :class:`GenerationEngine`: the scheduler glued to
  the shared checkpoint restore + hot-reload lifecycle
  (:class:`~horovod_tpu_torch.serving.engine.ParamsLifecycle`);
* :mod:`.spec` — speculative decoding proposers
  (``HVD_TPU_GEN_SPEC_MODE``): n-gram self-drafting or a small draft
  model, verified k-at-a-time by :func:`build_verify_program` with
  output equal to plain decode; beam search (``num_beams`` at submit,
  capped by ``HVD_TPU_GEN_BEAMS``) rides the same paged cache via
  :func:`build_beam_program` with copy-on-extend block forking.

The paged path reads through the model's ``_default_attention``, as the
JAX package's does; it launches no hand-written kernel.

Quick start::

    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    import horovod_tpu_torch.serving as serving

    engine = serving.GenerationEngine(
        Transformer(cfg, device="meta"), checkpoint_dir="/ckpts/run1",
        eos_id=2)
    with serving.InferenceServer(engine=None, gen_engine=engine,
                                 port=8500):
        ...   # POST /v1/generate {"prompt": [...], "max_tokens": 32}
    for tok in engine.stream([1, 5, 9], max_tokens=64):
        ...   # in-process streaming
"""

from .engine import GenerationEngine                        # noqa: F401
from .kv_cache import (BlockAllocator, BlocksExhaustedError,  # noqa: F401
                       DecodeState, SampleParams, block_bytes,
                       build_beam_program, build_decode_program,
                       build_prefill_program, build_program,
                       build_verify_program, chain_hash, make_pools,
                       sample_tokens)
from .scheduler import ContinuousBatcher, GenSequence       # noqa: F401
from .spec import (DraftModelProposer, NGramProposer,       # noqa: F401
                   Proposer, make_proposer)
