"""The generation engine: params lifecycle + the continuous batcher
(counterpart of ``horovod_tpu/serving/generation/engine.py``).

:class:`GenerationEngine` is the decode-native sibling of
:class:`~horovod_tpu_torch.serving.engine.InferenceEngine`, glued from
the same parts:

* the shared :class:`~horovod_tpu_torch.serving.engine.ParamsLifecycle` —
  checkpoint restore onto the card plus zero-downtime
  hot-reload (the ``serving.reload`` fault site and
  ``hvd_tpu_serving_hot_swaps_total`` apply unchanged). The scheduler
  snapshots the params reference once per device call, so a hot-swap
  lands *between* prefill/decode steps, never inside one; a sequence
  spanning a swap continues greedily under the new params (documented
  behavior — decode caches are value-compatible, not step-pinned);
* a :class:`~horovod_tpu_torch.serving.generation.scheduler.ContinuousBatcher`
  over a paged KV cache
  (:mod:`~horovod_tpu_torch.serving.generation.kv_cache`), sized by
  ``HVD_TPU_GEN_NUM_BLOCKS`` x ``HVD_TPU_GEN_BLOCK_SIZE``, on the same
  device as the params.

The model must be a
:class:`~horovod_tpu_torch.models.transformer.Transformer` (typically
built on ``device="meta"``: the programs run it through
``torch.func.functional_call`` with the params, a flat dict of tensors
by state_dict name), or a module with the same paged ``forward(tokens,
cache=PagedCache, logits_at=...)`` and a ``cfg`` with
``num_layers/num_heads/head_dim/max_seq_len/vocab_size/dtype``. The
engine runs on the card unless ``device="cpu"`` is passed, and raises
without one. ``functional_call`` swaps the params into the module's
attributes for the length of a call, so the engine keeps a copy of the
module (and of a draft model) of its own: two engines that run at once
in one process, as two replicas of a fleet do, never share one. The copy
of a module on meta holds no memory.
"""

import copy
from typing import Any, List, Optional, Sequence

from ... import config as _config
from ..engine import ParamsLifecycle
from .kv_cache import (BlockAllocator, build_beam_program,
                       build_decode_program, build_prefill_program,
                       build_verify_program, make_pools)
from .scheduler import DECODE_WIDTH, ContinuousBatcher, GenSequence
from .spec import make_proposer


class GenerationEngine:
    """Serve autoregressive generation from ``model`` with continuous
    batching, paged KV cache, and checkpoint hot-reload.

    Args:
      model: the decode-capable model (see module docstring).
      checkpoint_dir / params / sharding / step / reload_poll_seconds:
        the :class:`ParamsLifecycle` contract — exactly one of
        ``params`` and ``checkpoint_dir``.
      eos_id: default EOS token id for submitted sequences (per-request
        override wins; None runs every sequence to its ``max_tokens``).
      async_depth: decode steps the scheduler keeps in flight past the
        one being consumed (0 = synchronous; see
        ``HVD_TPU_GEN_ASYNC_DEPTH``).
      prefix_cache: automatic prefix caching — full KV blocks are
        content-indexed and shared across sequences, retired blocks
        park in a cached-free LRU pool, and admitted prompts skip
        prefill over their longest cached prefix (None reads
        ``HVD_TPU_GEN_PREFIX_CACHE``, default on; cached-prefix decode
        is bit-identical to cold decode either way).
      spec_mode: speculative decoding proposer — ``off`` | ``ngram``
        (prompt-lookup self-drafting) | ``draft`` (requires
        ``draft_model``). None reads ``HVD_TPU_GEN_SPEC_MODE``. Spec
        output is bit-identical to plain decode (greedy AND seeded
        sampling, logprobs included) — the knob only buys throughput.
      spec_tokens: static draft width of the verify program
        (None reads ``HVD_TPU_GEN_SPEC_TOKENS``).
      max_beams: widest ``num_beams`` this engine accepts; the beam
        step program is built for this top-K. 1 disables beam
        search entirely (None reads ``HVD_TPU_GEN_BEAMS``).
      draft_model / draft_params / draft_checkpoint_dir: the small
        draft transformer for ``spec_mode='draft'`` and its params
        plumbing (restored through its own :class:`ParamsLifecycle`).
      on_step: optional scheduler observability hook
        (``on_step(phase, [seq_id, ...])``).
      role: the disagg operating mode (``HVD_TPU_DISAGG_ROLE``).
      device: where the params, the pools and the programs live (the
        card unless asked otherwise).

    Knob-backed arguments (``block_size``, ``num_blocks``, ``max_seqs``,
    ``prefill_chunk``, ``queue_depth``, ``deadline_ms``,
    ``async_depth``, ``prefix_cache``) default to their registered
    generation knobs (docs/configuration.md).
    """

    def __init__(self, model, checkpoint_dir: Optional[str] = None,
                 params: Any = None, sharding=None,
                 step: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 max_seqs: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 async_depth: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 reload_poll_seconds: Optional[float] = None,
                 spec_mode: Optional[str] = None,
                 spec_tokens: Optional[int] = None,
                 max_beams: Optional[int] = None,
                 draft_model=None, draft_params: Any = None,
                 draft_checkpoint_dir: Optional[str] = None,
                 on_step=None, role: Optional[str] = None,
                 device="cuda"):
        cfg = _config.live_config()
        block_size = int(cfg.get(_config.GEN_BLOCK_SIZE)
                         if block_size is None else block_size)
        num_blocks = int(cfg.get(_config.GEN_NUM_BLOCKS)
                         if num_blocks is None else num_blocks)
        spec_mode = str(cfg.get(_config.GEN_SPEC_MODE)
                        if spec_mode is None else spec_mode).strip().lower()
        spec_tokens = int(cfg.get(_config.GEN_SPEC_TOKENS)
                          if spec_tokens is None else spec_tokens)
        max_beams = int(cfg.get(_config.GEN_BEAMS)
                        if max_beams is None else max_beams)
        model = copy.deepcopy(model)
        draft_model = copy.deepcopy(draft_model)
        self.model = model
        self._lifecycle = ParamsLifecycle(
            checkpoint_dir=checkpoint_dir, params=params, sharding=sharding,
            step=step, reload_poll_seconds=reload_poll_seconds,
            plane="generation", device=device)
        self.allocator = BlockAllocator(num_blocks, block_size,
                                        prefix_cache=prefix_cache)
        pools = make_pools(model.cfg, num_blocks, block_size,
                           device=self._lifecycle.device)
        self._proposer = make_proposer(
            spec_mode, draft_model=draft_model, params=draft_params,
            checkpoint_dir=draft_checkpoint_dir,
            device=self._lifecycle.device) \
            if spec_mode not in ("", "off", "0", "false", "none") else None
        verify_prog = (build_verify_program(model, spec_tokens,
                                            DECODE_WIDTH)
                       if self._proposer is not None else None)
        beam_prog = (build_beam_program(model, max_beams, DECODE_WIDTH)
                     if max_beams > 1 else None)
        self.batcher = ContinuousBatcher(
            (build_prefill_program(model),
             build_decode_program(model, DECODE_WIDTH)),
            lambda: self._lifecycle.snapshot()[0],
            pools, self.allocator,
            max_seq_len=model.cfg.max_seq_len, max_seqs=max_seqs,
            prefill_chunk=prefill_chunk, queue_depth=queue_depth,
            deadline_ms=deadline_ms, eos_id=eos_id,
            vocab_size=model.cfg.vocab_size, async_depth=async_depth,
            verify_program=verify_prog, proposer=self._proposer,
            spec_mode=spec_mode, spec_tokens=spec_tokens,
            beam_program=beam_prog, max_beams=max_beams,
            on_step=on_step, role=role)
        self._lifecycle.start_poller()    # last: nothing can fail past here

    # -- generation ----------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_tokens: int = 16,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               seed: Optional[int] = None,
               request_id: Optional[str] = None,
               budget_ms: Optional[float] = None,
               sample_offset: int = 0,
               num_beams: Optional[int] = None) -> GenSequence:
        """Admit one request; returns the sequence handle for
        :meth:`result` / :meth:`stream`. Raises ``QueueFullError``
        (503) / ``DeadlineExceededError`` (429) / ``ValueError``
        (400) with the serving plane's admission semantics. Sampling
        runs on device: ``temperature`` (None/0 = greedy), ``top_k``,
        ``top_p``, and ``seed`` (deterministic continuations, also
        across a preemption-recompute) — see
        :meth:`ContinuousBatcher.submit`. ``request_id`` stamps the
        serving request id onto the sequence for preemption/deadline
        attribution and per-request tracing. ``budget_ms`` is the
        end-to-end latency budget (never resets, unlike
        ``deadline_ms``); ``sample_offset`` offsets the PRNG emission
        ordinal so a failover resume of ``prompt + emitted`` continues
        the original sampled stream bit-identically. ``num_beams`` > 1
        runs greedy beam search (requires an engine constructed with
        ``max_beams`` > 1); width 1 is plain decode."""
        return self.batcher.submit(prompt, max_tokens=max_tokens,
                                   eos_id=eos_id, deadline_ms=deadline_ms,
                                   temperature=temperature, top_k=top_k,
                                   top_p=top_p, seed=seed,
                                   request_id=request_id,
                                   budget_ms=budget_ms,
                                   sample_offset=sample_offset,
                                   num_beams=num_beams)

    def result(self, seq: GenSequence,
               timeout: Optional[float] = None) -> List[int]:
        return self.batcher.result(seq, timeout=timeout)

    def cancel(self, request_id: str) -> None:
        """Flag every sequence submitted under ``request_id`` for
        cancellation (``POST /v1/cancel``; hedging's loser-cancel
        path). Asynchronous and idempotent — see
        :meth:`ContinuousBatcher.cancel`."""
        self.batcher.cancel(request_id)

    def stream(self, prompt: Sequence[int], max_tokens: int = 16,
               eos_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               seed: Optional[int] = None,
               timeout: Optional[float] = None):
        """submit + yield tokens as the scheduler emits them."""
        seq = self.submit(prompt, max_tokens=max_tokens, eos_id=eos_id,
                          deadline_ms=deadline_ms, temperature=temperature,
                          top_k=top_k, top_p=top_p, seed=seed)
        return self.batcher.stream(seq, timeout=timeout)

    def generate(self, prompt: Sequence[int], max_tokens: int = 16,
                 eos_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 seed: Optional[int] = None,
                 timeout: Optional[float] = None) -> List[int]:
        """Blocking generation: prompt tokens in, generated tokens out."""
        return self.batcher.generate(prompt, max_tokens=max_tokens,
                                     eos_id=eos_id, deadline_ms=deadline_ms,
                                     temperature=temperature, top_k=top_k,
                                     top_p=top_p, seed=seed,
                                     timeout=timeout)

    # -- lifecycle -----------------------------------------------------------

    @property
    def checkpoint_dir(self):
        return self._lifecycle.checkpoint_dir

    @property
    def step(self) -> int:
        return self._lifecycle.step

    @property
    def params(self):
        return self._lifecycle.params

    @property
    def device(self):
        return self._lifecycle.device

    @property
    def prefix_cache(self) -> bool:
        """Whether automatic prefix caching is active on this engine."""
        return self.allocator.prefix_cache

    @property
    def role(self) -> str:
        """This engine's disagg operating mode
        (``HVD_TPU_DISAGG_ROLE``): prefill | decode | colocated."""
        return self.batcher.role

    @property
    def spec_mode(self) -> str:
        """The active speculative-decoding proposer: off|ngram|draft."""
        return self.batcher.spec_mode if self.batcher.spec else "off"

    @property
    def spec_tokens(self) -> int:
        """Static draft width of the verify program (meaningful when
        :attr:`spec_mode` != ``off``)."""
        return self.batcher.spec_tokens

    @property
    def max_beams(self) -> int:
        """Widest ``num_beams`` this engine accepts (1 = beam search
        disabled)."""
        return self.batcher.max_beams

    # -- disaggregated KV transfer surface -----------------------------------

    def kv_manifest(self, prompt: Sequence[int]) -> List[str]:
        """Content-addressed manifest for ``prompt``: chain hashes of
        its matchable full blocks (pure; identical on every replica
        sharing the block size)."""
        return self.batcher.manifest_hashes(prompt)

    def kv_probe(self, hashes: Sequence[str]) -> int:
        """Blocks of the ``hashes`` chain this engine already holds
        (longest indexed prefix; side-effect-free — the offer
        handler's zero-byte-transfer answer)."""
        return self.allocator.match_probe([str(h) for h in hashes])[0]

    def kv_export(self, hashes: Sequence[str], timeout: float = 30.0):
        """Serve ``POST /v1/kv/fetch``: read the requested blocks'
        contents off the pools (scheduler-thread control op). Returns
        ``(served_hashes, k, v)``, CPU tensors."""
        return self.batcher.execute(
            lambda: self.batcher.export_kv_blocks(hashes), timeout=timeout)

    def kv_import(self, hashes: Sequence[str],
                  payload_hashes: Sequence[str], k_data, v_data,
                  timeout: float = 30.0):
        """Serve ``POST /v1/kv/offer``'s admit step: write transferred
        payloads into pool blocks and register them (remote) in the
        prefix-cache index (scheduler-thread control op). Returns
        ``(already_held, imported)``."""
        return self.batcher.execute(
            lambda: self.batcher.import_kv_blocks(
                hashes, payload_hashes, k_data, v_data), timeout=timeout)

    def reload(self, step: Optional[int] = None) -> bool:
        """Force a checkpoint hot-reload now (see
        :meth:`ParamsLifecycle.reload`)."""
        return self._lifecycle.reload(step=step)

    def close(self, timeout: float = 10.0) -> None:
        """Idempotent: stop the reload poller and the scheduler thread
        (queued/running sequences fail; all KV blocks return)."""
        self._lifecycle.close(timeout=timeout)
        if self._proposer is not None and hasattr(self._proposer, "close"):
            self._proposer.close(timeout=timeout)
        self.batcher.stop(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
