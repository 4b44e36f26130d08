"""Speculative-decoding proposers: who drafts the tokens verify scores
(counterpart of ``horovod_tpu/serving/generation/spec.py``).

Speculative decoding (Leviathan et al., "Fast Inference from
Transformers via Speculative Decoding") splits each decode step in
two: a cheap *proposer* guesses the next ``HVD_TPU_GEN_SPEC_TOKENS``
tokens, and the target model scores all of them in ONE paged forward
(:func:`~.kv_cache.build_verify_program`). The accepted prefix is, by
construction, exactly what the plain decoder would have produced —
the verify program recomputes the deterministic ``fold_in(key,
emitted-ordinal)`` draw at every position — so the proposer affects
*throughput only*, never output. A bad draft costs one wasted chunk
position; it cannot corrupt the cache (rejected K/V writes are rolled
back through the null block) and cannot change a single emitted token
or logprob.

Two proposers ship:

* :class:`NGramProposer` (``HVD_TPU_GEN_SPEC_MODE=ngram``) — prompt
  lookup / self-drafting: the longest suffix of the sequence's own
  ``prompt + emitted`` history that recurs earlier in that history
  predicts the tokens that followed its previous occurrence. Zero
  extra model, zero device work; it shines on repetitive output
  (code, templated text, long extractive answers) and on decode loops
  a greedy model has fallen into, and degrades to plain decode (empty
  draft -> accept 0, emit 1) everywhere else.
* :class:`DraftModelProposer` (``HVD_TPU_GEN_SPEC_MODE=draft``) — a
  small draft transformer rolled forward greedily, one full forward a
  drafted token, restored through the same
  :class:`~horovod_tpu_torch.serving.engine.ParamsLifecycle` the serving
  engines use (checkpoint restore + hot-reload). Draft quality tracks
  how well the small model imitates the big one; the accept-rate
  metrics (``hvd_tpu_gen_spec_accepted_total`` /
  ``_drafted_total``) say whether it pays.

Proposers run on the scheduler thread between device steps, see the
sequence's host-visible history only, and must be fast relative to a
decode step — the contract is :meth:`Proposer.propose`.
"""

from typing import List, Optional, Sequence

import torch


class Proposer:
    """Drafting interface for speculative decoding.

    :meth:`propose` receives the token *context* — the sequence's
    prompt plus every token emitted so far (the last element is the
    next decode input) — and a cap, and returns at most ``cap`` drafted
    continuation tokens (possibly none). Called on the scheduler
    thread once per lane per verify step; implementations must not
    block on I/O or touch scheduler state."""

    def propose(self, context: Sequence[int], cap: int) -> List[int]:
        raise NotImplementedError


class NGramProposer(Proposer):
    """Prompt-lookup self-drafting: match the longest recent n-gram.

    For ``n`` from ``max_ngram`` down to 1, the context's final
    ``n``-gram is searched for a *previous* occurrence (most recent
    first); on a hit, the tokens that followed it become the draft.
    The intuition is vLLM/"prompt lookup decoding": autoregressive
    output quotes its own history constantly — retrieved spans,
    boilerplate, cycles — and when it does, the continuation after the
    previous occurrence is a near-perfect prediction. No model, no
    state, O(context) per call."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if max_ngram < 1 or min_ngram < 1 or min_ngram > max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"min_ngram={min_ngram} max_ngram={max_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, context: Sequence[int], cap: int) -> List[int]:
        ctx = list(context)
        cap = int(cap)
        if cap <= 0:
            return []
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if len(ctx) <= n:
                continue
            pattern = ctx[-n:]
            # most recent earlier occurrence wins: recency tracks the
            # current generation regime (a loop entered five tokens ago
            # beats the same bigram back in the prompt)
            for j in range(len(ctx) - n - 1, -1, -1):
                if ctx[j:j + n] == pattern:
                    return ctx[j + n:j + n + cap]
        return []


class DraftModelProposer(Proposer):
    """A small draft transformer rolled forward greedily.

    ``model`` is any
    :class:`~horovod_tpu_torch.models.transformer.Transformer`-shaped
    module (typically a fraction of the target's layers/width, on
    ``device="meta"``) sharing the target's vocabulary; its params (a
    flat dict by state_dict name) come through a
    :class:`~horovod_tpu_torch.serving.engine.ParamsLifecycle` on
    ``device`` — pass either ``params`` directly or ``checkpoint_dir``
    (+ optional ``step``) and the draft hot-reloads with the same
    machinery as the serving params. The rollout is full-context and
    cache-free: correctness of the *output* never depends on the draft
    (verify re-derives every token), so the draft path optimizes for
    simplicity over speed — use :class:`NGramProposer` when the
    workload self-predicts."""

    def __init__(self, model, params=None,
                 checkpoint_dir: Optional[str] = None,
                 step: Optional[int] = None, sharding=None,
                 reload_poll_seconds: Optional[float] = None,
                 device="cuda"):
        from ..engine import ParamsLifecycle
        self.model = model
        self._lifecycle = ParamsLifecycle(
            checkpoint_dir=checkpoint_dir, params=params,
            sharding=sharding, step=step,
            reload_poll_seconds=reload_poll_seconds, plane="generation",
            device=device)
        self._lifecycle.start_poller()

    @property
    def params(self):
        return self._lifecycle.snapshot()[0]

    def propose(self, context: Sequence[int], cap: int) -> List[int]:
        cap = int(cap)
        if cap <= 0:
            return []
        max_len = int(self.model.cfg.max_seq_len)
        vocab = int(self.model.cfg.vocab_size)
        ctx = [int(t) for t in context if 0 <= int(t) < vocab]
        params = self.params
        dev = self._lifecycle.device
        out: List[int] = []
        with torch.no_grad():
            for _ in range(cap):
                window = ctx[-(max_len - 1):]
                tokens = torch.tensor([window], dtype=torch.long,
                                      device=dev)
                logits = torch.func.functional_call(self.model, params,
                                                    (tokens,))
                tok = int(torch.argmax(logits[0, len(window) - 1]))
                out.append(tok)
                ctx.append(tok)
        return out

    def close(self, timeout: float = 10.0) -> None:
        self._lifecycle.close(timeout=timeout)


def make_proposer(mode: str, draft_model=None, **draft_kwargs) -> \
        Optional[Proposer]:
    """The ``HVD_TPU_GEN_SPEC_MODE`` dispatch: ``'off'`` -> None,
    ``'ngram'`` -> :class:`NGramProposer`, ``'draft'`` ->
    :class:`DraftModelProposer` over ``draft_model`` (required) and
    ``draft_kwargs`` (its params/checkpoint plumbing and ``device``)."""
    mode = str(mode).strip().lower()
    if mode in ("", "off", "0", "false", "none"):
        return None
    if mode == "ngram":
        return NGramProposer()
    if mode == "draft":
        if draft_model is None:
            raise ValueError(
                "HVD_TPU_GEN_SPEC_MODE=draft needs a draft_model (and "
                "draft params or checkpoint) on the GenerationEngine")
        return DraftModelProposer(draft_model, **draft_kwargs)
    raise ValueError(
        f"HVD_TPU_GEN_SPEC_MODE={mode!r}: must be off|ngram|draft")
