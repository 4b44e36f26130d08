"""Iteration-level scheduling: the device-resident continuous decode loop
(counterpart of ``horovod_tpu/serving/generation/scheduler.py``).

The micro-batcher (:mod:`..batcher`) forms a batch once and rides it to completion —
right for fixed-shape forwards, wrong for autoregressive decode, where
sequences finish at different lengths and a static batch strands both
throughput (dead lanes decode padding) and memory (max-length KV
reservations). :class:`ContinuousBatcher` is the Orca-style answer: the
running batch is **re-formed every decode step**.

Each scheduler iteration does three things, in order:

1. **admit** — move waiting sequences into the running set while batch
   slots (``HVD_TPU_GEN_MAX_SEQS``) and KV blocks are free, FIFO, shed
   on expired deadlines;
2. **prefill one chunk** — the oldest prefilling sequence advances by at
   most ``HVD_TPU_GEN_PREFILL_CHUNK`` prompt tokens, so a long prompt is
   chunked and in-flight decodes stall for at most one step;
3. **decode one step** — every decoding sequence contributes its last
   token to one fixed-shape batch; finished sequences (EOS /
   ``max_tokens``) retire *immediately*, freeing their slot and blocks
   for the next iteration's admissions.

The decode loop is **device-resident**. Token selection runs
inside the programs (:func:`~.kv_cache.sample_tokens` — greedy,
temperature, top-k, top-p, per-request PRNG seed), so a decode step
ships a ``(B,)`` token/logprob pair to the host, never ``(B, vocab)``
logits. The per-lane inputs — next tokens, cache lengths, live masks,
sampling state — live in a :class:`~.kv_cache.DecodeState` the
decode program advances; the host rebuilds and re-uploads it
only when batch **membership** changes (admit / host-side retire /
preempt), tracked by a batch epoch, and re-uploads the block-table
matrix only when a table actually changed. Retirement on EOS or
``max_tokens`` is decided *on device* (the program drops the lane's
``live`` flag), so with ``HVD_TPU_GEN_ASYNC_DEPTH=1`` the scheduler
enqueues decode step N+1 before blocking on step N's tokens (on the
card each step's ``(B,)`` tokens and logprobs are copied into pinned
host buffers behind a recorded CUDA event, which the host waits on
only when it consumes that step; torch launches asynchronously): a lane
step N retired already routes step N+1's speculative writes to the
null block, and the host reconciles when it drains the pipeline — it
always drains fully before any membership change touches device state
(``hvd_tpu_gen_step_seconds{component=host|device}`` measures the
resulting overlap; depth 0 restores the synchronous loop).

When growth hits block exhaustion the scheduler **preempts** the
youngest block-holding sequence instead of deadlocking: its blocks are
freed and it requeues at the *front* of the waiting line in recompute
mode (prompt + tokens generated so far re-prefill on readmission).
Greedy decode makes the continuation deterministic, and sampled decode
is just as deterministic: each emission's PRNG key is
``fold_in(request seed, emitted ordinal)``, a pure function of the
request, so the recompute replays the identical continuation. Admission
bounds (a sequence that could never fit is rejected at submit) make the
loop preemption-safe: the oldest sequence can always grow.

Deadlines extend the micro-batcher's semantics **per token**: the budget
(``HVD_TPU_GEN_DEADLINE_MS`` or the request's ``deadline_ms``) is the
allowed gap to the *next* token and resets on every emission, so a
sequence parked in the waiting line — at admission or after a
preemption — times out with the same
:class:`~horovod_tpu.serving.batcher.DeadlineExceededError` (HTTP 429)
a stale inference request gets, while a healthy decode never expires
mid-stream. The bounded submit queue (``HVD_TPU_GEN_QUEUE_DEPTH``)
rejects overload with :class:`~horovod_tpu.serving.batcher.QueueFullError`
(HTTP 503), unchanged.

**Prefix caching** (``HVD_TPU_GEN_PREFIX_CACHE``, default on) makes
admission content-aware: each prompt's full blocks are chain-hashed
(:func:`~.kv_cache.chain_hash`) and matched against the allocator's
content index, the longest cached prefix is attached to the new block
table with refcounts bumped, and chunked prefill starts at the first
uncached token (``hvd_tpu_gen_prefix_cache_hit_tokens_total`` /
``_miss_tokens_total`` split every admission). Matching is full-block
-only and capped below the last prompt token, so prefill always has at
least one token to run — the prefill program is what samples the first
generated token — and the partial tail block stays private: decode
never writes into a shared block, which is why cached-prefix decode is
bit-identical to cold decode. Retirement and preemption are refcount
decrements (full blocks park in the allocator's cached-free pool), and
preemption-recompute re-matches the cache so a preempted sequence's
resume prefill is nearly free while its cached chain survives.
Admissibility is cache-aware — a prompt that fits only by evicting
cached blocks is admissible, because ``allocate`` always evicts cached
blocks before the scheduler would consider preempting anyone — and
with a cold cache the check degrades to exactly the plain free-blocks
rule. Refcount mutations obey the pipeline's flush rules: they happen on
the scheduler thread inside the same admit/retire/preempt paths whose
membership changes already drain the in-flight pipeline first, so
speculation never observes a half-updated block table.

**Speculative decoding** (``HVD_TPU_GEN_SPEC_MODE``) replaces the
one-token decode step with a draft-and-verify step: a host-side
proposer (:mod:`.spec`) guesses up to ``HVD_TPU_GEN_SPEC_TOKENS``
continuation tokens per lane, and the verify program scores
all of them in ONE paged forward, accepting the longest prefix equal
to what the plain decoder would have produced (the deterministic
``fold_in(key, emitted)`` draw is recomputed at every position, so
speculative output is bit-identical to plain decode for greedy AND
seeded sampling, logprobs included). The spec loop runs synchronously
— drafting needs the host-visible emitted history, so there is no
step to overlap — and multi-token emission is what pays: each
accepted draft saves a whole decode-step weight read. Rejected draft
positions are rolled back through the null block inside the program;
the cache is never corrupted by an unaccepted token.

**Beam search** (``num_beams > 1`` at submit; greedy only) runs as a
synchronous sub-loop the moment the request enters decode: width-W
hypothesis sets advance together through the beam step
(top-k logprobs per lane), children of a fork share their parent's
full prefix blocks through the refcounted allocator
(:meth:`~.kv_cache.BlockAllocator.share`) and copy only the partial
tail block at divergence. ``num_beams=1`` is bit-identical to plain
greedy decode.

Fault sites: ``serving.prefill`` (each prefill chunk — an ``error``
fails only that sequence), ``serving.decode`` (each decode-step
enqueue — an ``error`` fails only the sequences in that step's batch;
an in-flight speculative step is drained first, so already-produced
tokens are delivered and waiting sequences serve next),
``serving.verify`` (each speculative verify step — an ``error`` fails
that step's batch, the spec-plane analogue of ``serving.decode``),
and ``serving.evict`` (each preemption — an ``error`` fails the
evicted sequence instead of requeueing it). See docs/robustness.md.
"""

import collections
import itertools
import queue
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import _locks
from ... import config as _config
from ... import faults as _faults
from ... import metrics as _metrics
from ... import tracing as _tracing
from ...models.transformer import PagedCache
from ..batcher import DeadlineExceededError, QueueFullError
from .kv_cache import (BlockAllocator, BlocksExhaustedError, DecodeState,
                       SampleParams, chain_hash, gather_blocks,
                       scatter_blocks)

_M_TOKENS = _metrics.counter(
    "hvd_tpu_gen_tokens_total",
    "Generation tokens processed by phase: 'prefill' counts prompt "
    "tokens written into the paged KV cache (recomputed tokens after a "
    "preemption count again — they are real work), 'decode' counts "
    "generated tokens emitted to callers.",
    labels=("phase",))
_M_RUNNING = _metrics.gauge(
    "hvd_tpu_gen_running_seqs",
    "Sequences currently in the running set (prefilling or decoding). "
    "Pinned at HVD_TPU_GEN_MAX_SEQS with a deep waiting line means the "
    "slot count, not KV blocks, bounds throughput.")
_M_WAITING = _metrics.gauge(
    "hvd_tpu_gen_waiting_seqs",
    "Sequences admitted to the bounded queue but not yet running "
    "(including preempted sequences awaiting re-prefill).")
_M_PREFIX_HIT = _metrics.counter(
    "hvd_tpu_gen_prefix_cache_hit_tokens_total",
    "Prompt tokens whose KV was served from the prefix cache at "
    "admission (full cached blocks attached to the sequence's table "
    "instead of being prefilled), split by where the block contents "
    "came from: source='local' (computed by this replica's own "
    "prefill) or source='transfer' (imported over the disagg KV wire "
    "by a /v1/kv/offer). Re-admissions after a preemption count "
    "again, mirroring hvd_tpu_gen_tokens_total{phase='prefill'}.",
    labels=("source",))
_M_PREFIX_MISS = _metrics.counter(
    "hvd_tpu_gen_prefix_cache_miss_tokens_total",
    "Prompt tokens the prefix cache could not serve at admission — "
    "they go through chunked prefill. hit/(hit+miss) is the cache's "
    "token hit rate; only emitted with HVD_TPU_GEN_PREFIX_CACHE on.")
_M_PREEMPTIONS = _metrics.counter(
    "hvd_tpu_gen_preemptions_total",
    "Sequences preempted on KV-block exhaustion: blocks freed, sequence "
    "requeued at the front of the waiting line for recompute. A steady "
    "nonzero rate means HVD_TPU_GEN_NUM_BLOCKS is undersized for the "
    "offered length mix.")
_M_OCCUPANCY = _metrics.histogram(
    "hvd_tpu_gen_batch_occupancy",
    "Live sequences per decode step (the re-formed batch, not the "
    "padded width). Mass well below HVD_TPU_GEN_MAX_SEQS under load "
    "means admission is starved — usually by KV blocks.",
    buckets=(1, 2, 4, 8, 16, 32, 64))
_M_STEP = _metrics.histogram(
    "hvd_tpu_gen_step_seconds",
    "Per scheduler iteration, the wall time split between waiting on "
    "the device ('device': blocked in token-vector/prefill transfers) "
    "and everything else ('host': admission, stream delivery, state "
    "bookkeeping, enqueue). With HVD_TPU_GEN_ASYNC_DEPTH=1 the host "
    "share overlaps the in-flight device step; a host share rivaling "
    "the device share at depth 0 is the signal that async stepping "
    "pays. With speculative decoding on, 'verify' is the wait on the "
    "draft-verify program specifically (a subset of the device "
    "share): compare its per-observation cost against the plain "
    "decode step times the accept length to see what speculation "
    "buys.",
    labels=("component",),
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 1.0))
_M_SPEC_DRAFTED = _metrics.counter(
    "hvd_tpu_gen_spec_drafted_total",
    "Tokens proposed by the speculative-decoding drafter "
    "(HVD_TPU_GEN_SPEC_MODE), summed over lanes and verify steps. "
    "accepted/drafted is the fleet accept rate — the single number "
    "that says whether speculation pays on this workload.")
_M_SPEC_ACCEPTED = _metrics.counter(
    "hvd_tpu_gen_spec_accepted_total",
    "Drafted tokens the verify step accepted (they equalled what the "
    "plain decoder would have produced at their position). Every "
    "accepted token is a decode-step weight read saved; the bonus "
    "token each verify step emits past the accepted prefix is not "
    "counted here — it is not a draft.")
_M_SPEC_ACCEPT_LEN = _metrics.histogram(
    "hvd_tpu_gen_spec_accept_length",
    "Accepted drafted tokens per lane per verify step (0 = the draft "
    "missed immediately and the step degraded to plain decode's one "
    "token). Mass pinned at HVD_TPU_GEN_SPEC_TOKENS means the draft "
    "width, not the proposer, is the binding constraint — raising it "
    "may pay; mass at 0 means speculation is pure overhead on this "
    "workload.",
    buckets=(0, 1, 2, 3, 4, 6, 8, 16))

class RequestCancelledError(RuntimeError):
    """The request was cancelled via :meth:`ContinuousBatcher.cancel`
    (``POST /v1/cancel`` — e.g. the losing arm of a hedged request).
    The front-end answers 499; the router that issued the cancel has
    already relayed the winning response, so no client observes it."""


_FP_PREFILL = _faults.FaultPoint("serving.prefill")
_FP_DECODE = _faults.FaultPoint("serving.decode")
# the speculative verify step's own site: an ``error`` fails exactly
# the sequences in that verify batch (the spec-plane analogue of
# serving.decode), waiting sequences serve next iteration
_FP_VERIFY = _faults.FaultPoint("serving.verify")
_FP_EVICT = _faults.FaultPoint("serving.evict")
# SDC drill for the generation plane: a ``nan`` rule poisons ONE live
# lane's logprob after the device step — the blast-radius contract
# (docs/robustness.md, SDC section) is that exactly that sequence
# fails; its batchmates keep decoding.
_FP_LOGPROB = _faults.FaultPoint("serving.logprob")


def _corrupt_logprobs(logp: np.ndarray, lanes) -> np.ndarray:
    """Fire the ``serving.logprob`` site; a matched ``nan``/``bitflip``
    rule returns a copy with ONE live decode lane's logprob poisoned
    (seeded pick), otherwise ``logp`` unchanged."""
    box = [logp]

    def handler(kind: str, rng) -> None:
        live = [i for i, s in enumerate(lanes)
                if s is not None and s.state == "decode"]
        if not live:
            return
        out = np.array(box[0], copy=True)
        out[live[rng.randrange(len(live))]] = np.nan
        box[0] = out

    _FP_LOGPROB.fire(corrupt=handler)
    return box[0]

#: chunk width of the decode program: one live token plus one pad
#: column, the JAX package's width (there it keeps XLA out of its
#: matrix-vector specializations), so both packages run the same
#: shapes.
DECODE_WIDTH = 2

_DONE = object()
_STOP = object()
_UNSET = object()


class _ControlOp:
    """A callable smuggled through the submission queue to run ON the
    scheduler thread, between loop iterations. The disagg KV
    export/import paths need this: the K/V pools are device buffers only
    the scheduler thread may read or write, so an HTTP handler enqueues
    the work and blocks on ``done``. A stopped scheduler fails the op
    instead of running it."""

    __slots__ = ("fn", "done", "result", "error")

    def __init__(self, fn: Callable):
        self.fn = fn
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self.result = self.fn()
        except BaseException as e:  # noqa: BLE001 — re-raised at execute()
            self.error = e
        finally:
            self.done.set()

    def fail(self, err: BaseException) -> None:
        self.error = err
        self.done.set()


def _seed_key(seed: int) -> np.ndarray:
    """The (2,) threefry key words for ``seed`` (the JAX package's key:
    the seed's 64 bits as high and low words), as int64 without
    touching the device from the caller's thread."""
    s = int(seed) % (1 << 64)
    return np.array([s >> 32, s & 0xFFFFFFFF], np.int64)


class _Flight:
    """One enqueued decode step's ``(B,)`` tokens and logprobs on their
    way to the host. On the card the copies go into pinned host buffers
    behind a CUDA event recorded on the launching stream, so the host
    waits only when it consumes the step (:meth:`read`); on the CPU the
    program's outputs are the host arrays."""

    __slots__ = ("tensors", "event", "lanes")

    def __init__(self, tensors, lanes):
        self.lanes = lanes
        self.event = None
        if tensors[0].is_cuda:
            host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                host.append(h)
            self.event = torch.cuda.Event()
            self.event.record()
            tensors = host
        self.tensors = tensors

    def read(self):
        """The step's arrays as numpy, waiting for the device first."""
        if self.event is not None:
            self.event.synchronize()
        return [t.numpy() for t in self.tensors]


def _host(*tensors):
    """Blocking device->host read of ``tensors`` as numpy arrays."""
    return _Flight(list(tensors), None).read()


class GenSequence:
    """One generation request, submission to retirement. Also the
    caller's handle: :meth:`ContinuousBatcher.result` /
    :meth:`ContinuousBatcher.stream` consume it."""

    __slots__ = ("id", "prompt", "max_tokens", "eos_id", "deadline_s",
                 "deadline", "budget", "generated", "logprobs", "blocks",
                 "prefill_tokens", "prefilled", "cache_len", "next_input",
                 "resume_decode", "state", "error", "stream_q",
                 "done_event", "arrived_at", "temperature", "top_k",
                 "top_p", "seed", "key", "sample_offset", "prefix_hashes",
                 "block_hashes", "cache_gen", "request_id", "trace",
                 "num_beams")

    def __init__(self, seq_id: int, prompt: List[int], max_tokens: int,
                 eos_id: Optional[int], deadline_s: float,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: Optional[int] = None,
                 request_id: Optional[str] = None,
                 budget_s: float = 0.0, sample_offset: int = 0,
                 num_beams: int = 1):
        self.id = seq_id
        self.prompt = list(prompt)
        self.max_tokens = int(max_tokens)
        self.eos_id = eos_id
        self.deadline_s = deadline_s
        self.deadline = (time.monotonic() + deadline_s
                         if deadline_s > 0 else float("inf"))
        #: the END-TO-END budget (X-HVD-TPU-Deadline-Ms): unlike the
        #: per-token ``deadline`` it never resets on emission, so a
        #: request that can no longer finish is shed at whichever stage
        #: (queue / prefill / decode) notices first
        self.budget = (time.monotonic() + budget_s
                       if budget_s > 0 else float("inf"))
        #: PRNG emission ordinal the FIRST sampled token uses — the
        #: cross-replica resume contract: a failover re-submission of
        #: ``prompt + emitted`` with the original seed and
        #: ``sample_offset=len(emitted)`` continues the fold_in(key,
        #: emitted-ordinal) chain exactly where the dead replica
        #: stopped, making the resumed continuation bit-identical
        self.sample_offset = int(sample_offset)
        #: beam width (1 = plain decode). Beam requests prefill
        #: prompt[:-1] only — the beam loop's first step feeds the last
        #: prompt token through the beam program, so the FIRST generated
        #: token branches into the top-W hypotheses too
        self.num_beams = int(num_beams)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        #: the effective seed. Defaulting to the sequence id (assigned
        #: at submit, never reused) keeps UNSEEDED sampled requests
        #: deterministic across a preemption-recompute too: the replay
        #: reuses this GenSequence, so it reuses this key.
        self.seed = seq_id if seed is None else int(seed)
        self.key = _seed_key(self.seed)
        self.generated: List[int] = []
        self.logprobs: List[float] = []
        self.blocks: List[int] = []
        #: tokens whose K/V must be in the cache before decoding resumes
        #: (the prompt; after a preemption, prompt + regenerated history)
        self.prefill_tokens: List[int] = list(prompt)
        self.prefilled = 0
        #: tokens actually written to the cache so far
        self.cache_len = 0
        #: the next decode step's input token (the newest generated one)
        self.next_input: Optional[int] = None
        #: True when re-prefilling after a preemption: the final chunk's
        #: sampled token was already emitted before eviction — skip it
        self.resume_decode = False
        #: content chain hashes of prefill_tokens' matchable full blocks
        #: (capped below the last token), recomputed when prefill_tokens
        #: changes; the admission match consumes a prefix of this
        self.prefix_hashes: List[str] = []
        #: chain hashes of this sequence's *filled* full blocks —
        #: block_hashes[j] describes blocks[j]; grows as cache_len
        #: crosses block boundaries
        self.block_hashes: List[str] = []
        #: allocator cache generation the blocks were filled under; a
        #: mismatch (params swap / device reset since) vetoes
        #: registration of stale contents
        self.cache_gen = -1
        self.state = "waiting"      # waiting | prefill | decode | done
        self.error: Optional[BaseException] = None
        self.stream_q: "queue.Queue" = queue.Queue()
        self.done_event = threading.Event()
        self.arrived_at = time.monotonic()
        #: serving request id, stamped into preemption/deadline
        #: diagnostics whether or not the request is traced
        self.request_id = request_id
        #: the submitting request's TraceContext when it is sampled
        #: (tracing.py); the scheduler thread emits prefill/decode/
        #: preempt spans against it
        self.trace = _tracing.current()


def _as_tensor(data) -> torch.Tensor:
    return data if isinstance(data, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(data))


class ContinuousBatcher:
    """The generation scheduler thread plus its submission surface.

    Args:
      programs: the ``(prefill, decode)`` program pair from
        :func:`~.kv_cache.build_prefill_program` /
        :func:`~.kv_cache.build_decode_program` — both sample on
        device and return token ids + logprobs, never logits.
      params_fn: zero-arg callable returning the params to use for the
        next device call — the engine passes its hot-reload snapshot, so
        a checkpoint swap lands between steps, never inside one.
      pools: the ``(k, v)`` pools from :func:`~.kv_cache.make_pools`;
        the programs run on their device.
      allocator: the :class:`~.kv_cache.BlockAllocator` over the same
        pool.
      max_seq_len: hard cap on ``len(prompt) + max_tokens`` (the model's
        position table bounds it).
      eos_id: default EOS token id (per-request override wins; None
        means sequences run to ``max_tokens``).
      async_depth: decode steps to keep in flight past the one being
        consumed (defaults to ``HVD_TPU_GEN_ASYNC_DEPTH``; clamped to
        0..1 — depth-1 reconciliation is what the loop implements).
      on_step: optional test/observability hook, called after every
        scheduler phase as ``on_step(phase, [seq_id, ...])`` with phase
        ``'prefill'`` or ``'decode'``.

    Knob-backed arguments (``max_seqs``, ``prefill_chunk``,
    ``queue_depth``, ``deadline_ms``, ``async_depth``) default to their
    registered generation knobs (docs/configuration.md).
    """

    def __init__(self, programs: Tuple[Callable, Callable],
                 params_fn: Callable, pools,
                 allocator: BlockAllocator, max_seq_len: int,
                 max_seqs: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 queue_depth: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 vocab_size: Optional[int] = None,
                 async_depth: Optional[int] = None,
                 on_step: Optional[Callable] = None,
                 role: Optional[str] = None,
                 verify_program: Optional[Callable] = None,
                 proposer=None,
                 spec_mode: Optional[str] = None,
                 spec_tokens: Optional[int] = None,
                 beam_program: Optional[Callable] = None,
                 max_beams: Optional[int] = None):
        cfg = _config.live_config()
        #: disaggregated operating mode (HVD_TPU_DISAGG_ROLE):
        #: 'colocated' runs prefill + decode as always; 'prefill'
        #: retires every sequence the moment its prompt is resident
        #: (blocks registered and parked for export, sampled token
        #: discarded); 'decode' behaves like colocated — its difference
        #: is fed transferred blocks via import_kv_blocks
        self.role = str(cfg.get(_config.DISAGG_ROLE)
                        if role is None else role).strip().lower()
        if self.role not in ("prefill", "decode", "colocated"):
            raise ValueError(
                f"HVD_TPU_DISAGG_ROLE={self.role!r}: must be one of "
                f"prefill|decode|colocated")
        self._prefill_prog, self._decode_prog = programs
        self._params_fn = params_fn
        self._k, self._v = pools
        #: shape/dtype/device for rebuilding the pools after a genuine
        #: device failure: a program that dies mid-step leaves them
        #: half-written
        self._pool_shape = tuple(self._k.shape)
        self._pool_dtype = self._k.dtype
        self._device = self._k.device
        self._alloc = allocator
        self._prefix_cache = bool(getattr(allocator, "prefix_cache", False))
        #: identity of the params object the last device call used —
        #: a hot-swap means cached K/V no longer matches what a cold
        #: prefill would compute, so the prefix cache resets on change
        self._last_params = _UNSET
        self.max_seq_len = int(max_seq_len)
        self.max_seqs = int(cfg.get(_config.GEN_MAX_SEQS)
                            if max_seqs is None else max_seqs)
        self.prefill_chunk = int(cfg.get(_config.GEN_PREFILL_CHUNK)
                                 if prefill_chunk is None else prefill_chunk)
        depth = int(cfg.get(_config.GEN_QUEUE_DEPTH)
                    if queue_depth is None else queue_depth)
        self.default_deadline_s = float(
            cfg.get(_config.GEN_DEADLINE_MS)
            if deadline_ms is None else deadline_ms) / 1e3
        self.async_depth = min(1, max(0, int(
            cfg.get(_config.GEN_ASYNC_DEPTH)
            if async_depth is None else async_depth)))
        self.eos_id = eos_id
        self.vocab_size = vocab_size
        self.on_step = on_step
        #: speculative decoding: both halves (the verify step
        #: and a host-side proposer) must be present for the spec loop
        #: to replace the plain decode loop
        self._verify_prog = verify_program
        self._proposer = proposer
        self.spec_tokens = int(cfg.get(_config.GEN_SPEC_TOKENS)
                               if spec_tokens is None else spec_tokens)
        self.spec_mode = str(
            ("off" if proposer is None else "ngram")
            if spec_mode is None else spec_mode).strip().lower()
        self.spec = (self._verify_prog is not None
                     and self._proposer is not None)
        #: beam search: the top-k beam step; requests with
        #: num_beams > 1 are rejected at submit when absent
        self._beam_prog = beam_program
        self.max_beams = (int(cfg.get(_config.GEN_BEAMS)
                              if max_beams is None else max_beams)
                          if beam_program is not None else 1)
        #: table width: every sequence's block table is padded to the
        #: worst-case block count, so the programs' shapes never move
        self.max_blocks = allocator.blocks_for(self.max_seq_len)
        self._ids = itertools.count()
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        # scheduler-thread-private state (never touched off-thread):
        self._waiting: List[GenSequence] = []
        self._running: List[GenSequence] = []
        #: device-resident decode state; lane i of _dstate belongs to
        #: _lanes[i] (None = free/retired lane). Rebuilt only when
        #: _epoch (bumped on membership changes the device hasn't seen)
        #: outruns _state_epoch.
        self._dstate: Optional[DecodeState] = None
        self._dtables = None
        self._tables_dirty = True
        self._lanes: List[Optional[GenSequence]] = [None] * self.max_seqs
        self._epoch = 0
        self._state_epoch = -1
        #: decode steps enqueued but not yet consumed (:class:`_Flight`)
        self._inflight: "collections.deque" = collections.deque()
        self._blocked_s = 0.0
        self._lock = _locks.lock(
            "serving.generation.ContinuousBatcher._lock")
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        #: request ids flagged for cancellation (request_id ->
        #: monotonic registration time); the scheduler loop applies
        #: them each iteration, unmatched ids expire after
        #: _CANCEL_TTL_S so a cancel racing a request that never
        #: arrives cannot leak
        self._cancels: dict = {}

    # -- submission surface --------------------------------------------------

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
        """Admit one generation request. Raises
        :class:`~horovod_tpu.serving.batcher.QueueFullError` on a full
        queue (HTTP 503), ``ValueError`` for a request that could never
        be served (empty prompt, non-positive ``max_tokens``, a total
        length beyond ``max_seq_len`` or beyond the whole block pool,
        invalid sampling parameters).

        Sampling (all on device): ``temperature`` <= 0 or None is
        greedy; ``top_k`` > 0 and ``top_p`` < 1 restrict the sampled
        distribution; ``seed`` pins the continuation (same seed + same
        prompt + same params => same tokens, including across a
        preemption-recompute). Unseeded sampled requests draw from a
        per-request key derived from the sequence id.

        ``budget_ms`` is the request's remaining END-TO-END budget
        (the X-HVD-TPU-Deadline-Ms hop contract): unlike the per-token
        ``deadline_ms`` it never resets on emission — when it dies the
        sequence is shed with a stage-attributed
        :class:`~horovod_tpu.serving.batcher.DeadlineExceededError`
        (queue / prefill / decode). ``sample_offset`` starts the
        on-device PRNG emission ordinal past ``sample_offset`` already-
        emitted tokens, so a failover resume of ``prompt + emitted``
        with the original seed replays the uninterrupted continuation
        bit-identically.

        ``num_beams`` > 1 runs beam search (greedy scoring only —
        sampled beams are rejected): W hypotheses advance together,
        sharing prefix KV blocks, and the single highest-cumulative-
        logprob finished hypothesis is delivered. ``num_beams=1`` (the
        default) is bit-identical to plain greedy decode.
        """
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("prompt needs at least one token")
        if self.vocab_size is not None and any(
                t < 0 or t >= self.vocab_size for t in prompt):
            # reject HERE: inside the device gather an out-of-range id
            # would fault the whole step, not just this request
            raise ValueError(
                f"prompt token out of range for vocab_size="
                f"{self.vocab_size}")
        if max_tokens < 1:
            raise ValueError(f"max_tokens={max_tokens}: must be >= 1")
        temperature = 0.0 if temperature is None else float(temperature)
        if not 0.0 <= temperature < float("inf"):
            raise ValueError(
                f"temperature={temperature}: must be finite and >= 0 "
                f"(0 = greedy)")
        top_k = 0 if top_k is None else int(top_k)
        if top_k < 0:
            raise ValueError(f"top_k={top_k}: must be >= 0 (0 disables)")
        top_p = 1.0 if top_p is None else float(top_p)
        if not 0.0 < top_p <= 1.0:
            raise ValueError(
                f"top_p={top_p}: must be in (0, 1] (1 disables)")
        num_beams = 1 if num_beams is None else int(num_beams)
        if num_beams < 1:
            raise ValueError(f"num_beams={num_beams}: must be >= 1")
        if num_beams > 1:
            if self._beam_prog is None:
                raise ValueError(
                    "beam search is disabled on this engine (no beam "
                    "program compiled; construct the GenerationEngine "
                    "with max_beams > 1 / HVD_TPU_GEN_BEAMS)")
            cap = min(self.max_beams, self.max_seqs)
            if num_beams > cap:
                raise ValueError(
                    f"num_beams={num_beams} exceeds this engine's beam "
                    f"cap {cap} (min of HVD_TPU_GEN_BEAMS and "
                    f"HVD_TPU_GEN_MAX_SEQS)")
            if temperature > 0.0:
                raise ValueError(
                    "num_beams > 1 requires greedy decoding "
                    "(temperature 0): beam search maximizes cumulative "
                    "logprob, which sampling contradicts")
        total = len(prompt) + int(max_tokens)
        if total > self.max_seq_len:
            raise ValueError(
                f"len(prompt) + max_tokens = {total} exceeds "
                f"max_seq_len={self.max_seq_len}")
        if self._alloc.blocks_for(total) > self._alloc.capacity:
            # cache-independent bound: within ONE block table every
            # entry is a distinct pool block even when shared with
            # other sequences, so a table wider than the pool can never
            # materialize — no amount of prefix caching changes that
            raise ValueError(
                f"request needs {self._alloc.blocks_for(total)} KV "
                f"blocks, more than the whole pool "
                f"({self._alloc.capacity} usable); raise "
                f"HVD_TPU_GEN_NUM_BLOCKS or shorten the request")
        ddl_s = (self.default_deadline_s if deadline_ms is None
                 else float(deadline_ms) / 1e3)
        if deadline_ms is not None and ddl_s < 0:
            # same admission rule as the micro-batcher: an explicitly
            # negative budget is already spent — shed it now
            raise DeadlineExceededError(
                f"request deadline_ms={deadline_ms} is negative: "
                f"budget already spent before admission", stage="queue")
        sample_offset = int(sample_offset)
        if sample_offset < 0:
            raise ValueError(
                f"sample_offset={sample_offset}: must be >= 0")
        budget_s = 0.0 if budget_ms is None else float(budget_ms) / 1e3
        if budget_ms is not None and budget_s <= 0:
            # an explicit end-to-end budget that is already <= 0 can
            # never produce a token: reject at admission, before the
            # request consumes a queue slot or a prefill chunk
            raise DeadlineExceededError(
                f"request budget_ms={budget_ms}: end-to-end budget "
                f"already spent before admission", stage="queue")
        seq = GenSequence(next(self._ids), prompt, max_tokens,
                          self.eos_id if eos_id is None else eos_id,
                          ddl_s, temperature=temperature, top_k=top_k,
                          top_p=top_p, seed=seed, request_id=request_id,
                          budget_s=budget_s, sample_offset=sample_offset,
                          num_beams=num_beams)
        _tracing.note_request(request_id)
        if num_beams > 1:
            # beam requests hold back the prompt's last token from
            # prefill so the FIRST generated position also branches
            # into the top-W continuations (prefilling it would commit
            # a single greedy path one step early)
            seq.prefill_tokens = seq.prompt[:-1]
        if self._prefix_cache:
            # hashed on the submitter's thread (pure computation on a
            # sequence the scheduler can't see yet) so the hot loop
            # only pays for the index probe
            seq.prefix_hashes = self._prefix_hashes_for(seq.prefill_tokens)
        self._ensure_thread()
        try:
            self._q.put_nowait(seq)
        except queue.Full:
            raise QueueFullError(
                f"generation queue at capacity ({self._q.maxsize}); "
                f"back off and retry") from None
        # the scheduler loop owns the waiting gauge: publishing
        # q.qsize() + len(_waiting) from this thread would race its
        # _publish_gauges and read scheduler-private state off-thread
        if self._stopped:
            # stop() raced this submit past its drain
            self._drain_failed(RuntimeError("generation scheduler stopped"))
        return seq

    def result(self, seq: GenSequence,
               timeout: Optional[float] = None) -> List[int]:
        """Block until ``seq`` retires; return its generated tokens or
        raise its error. Composable with :meth:`stream` — this waits on
        the retirement event, not the token queue. Per-token logprobs
        accumulate on ``seq.logprobs``, index-aligned with the return."""
        if not seq.done_event.wait(timeout):
            raise TimeoutError("generation result not ready in time")
        if seq.error is not None:
            raise seq.error
        return list(seq.generated)

    def stream(self, seq: GenSequence, timeout: Optional[float] = None):
        """Yield ``seq``'s tokens as the scheduler emits them; raises
        the sequence's error at the point of failure. ``timeout`` bounds
        the wait for each *next* token."""
        while True:
            try:
                tok = seq.stream_q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    "next generation token not ready in time") from None
            if tok is _DONE:
                if seq.error is not None:
                    raise seq.error
                return
            yield tok

    def cancel(self, request_id: str) -> None:
        """Flag the sequence submitted under ``request_id`` for
        cancellation (best-effort, asynchronous): the scheduler loop
        fails it with :class:`RequestCancelledError` at its next
        iteration, freeing its batch slot and KV blocks. The hedge
        protocol's loser-cancellation path (``POST /v1/cancel``) — a
        cancel for an unknown/completed id is a no-op that expires
        after a grace period."""
        if not request_id:
            return
        with self._lock:
            self._cancels[str(request_id)] = time.monotonic()

    def generate(self, prompt: Sequence[int], max_tokens: int = 16,
                 eos_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 seed: Optional[int] = None,
                 timeout: Optional[float] = None) -> List[int]:
        """submit + result in one call (the HTTP route's path)."""
        return self.result(
            self.submit(prompt, max_tokens, eos_id, deadline_ms,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        seed=seed),
            timeout)

    # -- disaggregated KV export/import --------------------------------------

    def execute(self, fn: Callable, timeout: float = 30.0):
        """Run ``fn`` on the scheduler thread between loop iterations
        and return its result (re-raising its exception). The K/V pools
        are device buffers with scheduler-thread affinity — every
        disagg export/import goes through here so an HTTP worker never
        races the decode pipeline for them."""
        op = _ControlOp(fn)
        self._ensure_thread()
        self._q.put(op, timeout=timeout)
        if self._stopped:
            self._drain_failed(RuntimeError("generation scheduler stopped"))
        if not op.done.wait(timeout):
            raise TimeoutError(
                "scheduler control op not serviced in time")
        if op.error is not None:
            raise op.error
        return op.result

    def manifest_hashes(self, tokens: Sequence[int]) -> List[str]:
        """The content-addressed manifest for ``tokens``: chain hashes
        of its matchable full blocks (pure computation — identical on
        every replica with the same block size)."""
        return self._prefix_hashes_for([int(t) for t in tokens])

    def export_kv_blocks(self, hashes: Sequence[str]):
        """Scheduler-thread body of ``POST /v1/kv/fetch`` (call via
        :meth:`execute`): pin the longest indexed prefix of ``hashes``,
        read those blocks' contents off the pools, release. Returns
        ``(served_hashes, k, v)``, CPU tensors — a prefix of the request
        (the
        tail may have evicted since the manifest was minted; the decode
        side re-prefills whatever is missing)."""
        hashes = [str(h) for h in hashes]
        if not self._prefix_cache:
            return [], None, None
        held = self._alloc.match(hashes)
        if not held:
            return [], None, None
        try:
            k_np, v_np = gather_blocks(self._k, self._v, held)
        finally:
            self._alloc.free(held)
        return hashes[:len(held)], k_np, v_np

    def import_kv_blocks(self, hashes: Sequence[str],
                         payload_hashes: Sequence[str],
                         k_data, v_data) -> Tuple[int, int]:
        """Scheduler-thread body of ``POST /v1/kv/offer`` (call via
        :meth:`execute`): register transferred block payloads into the
        local prefix cache so the next admission of the matching prompt
        attaches them with zero full-block prefill debt. ``hashes`` is
        the full chain manifest; ``payload_hashes``/``k_data``/
        ``v_data`` cover the blocks the source shipped (any order,
        matched by hash). Returns ``(already_held, imported)`` block
        counts. The already-held chain prefix is pinned across the
        allocation so eviction can never tear a hole in it; imported
        blocks are registered ``remote=True`` and parked cached —
        a double-import of the same hash dedups via first-registration-
        wins and the duplicate simply recycles."""
        hashes = [str(h) for h in hashes]
        if not self._prefix_cache or not hashes:
            return 0, 0
        held = self._alloc.match(hashes)
        m = len(held)
        pos = {str(h): i for i, h in enumerate(payload_hashes or [])}
        want: List[Tuple[str, int]] = []
        for j in range(m, len(hashes)):
            i = pos.get(hashes[j])
            if i is None:
                break       # chain broken: a gap is un-attachable
            want.append((hashes[j], i))
        fresh: List[int] = []
        if want:
            try:
                fresh = self._alloc.allocate(len(want))
            except BlocksExhaustedError:
                # pool pressure beats the transfer: the admission path
                # re-prefills instead — never preempt running work for
                # speculative cache warmth
                self._alloc.free(held)
                return m, 0
            idx = [i for _, i in want]
            self._k, self._v = scatter_blocks(
                self._k, self._v, fresh,
                _as_tensor(k_data)[:, idx], _as_tensor(v_data)[:, idx])
            for b, (h, _) in zip(fresh, want):
                self._alloc.register(b, h, remote=True)
        self._alloc.free(held + fresh)
        return m, len(fresh)

    # -- lifecycle -----------------------------------------------------------

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._stopped:
                raise RuntimeError("ContinuousBatcher is stopped")
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name="hvd-tpu-gen-scheduler",
                    daemon=True)
                self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        """Idempotent: stop the scheduler thread; queued and running
        sequences are failed and every KV block returns to the pool."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            thread, self._thread = self._thread, None
        err = RuntimeError("generation scheduler stopped")
        while True:
            try:
                self._q.put_nowait(_STOP)
                break
            except queue.Full:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    continue
                if item is not _STOP:
                    self._deliver_error(item, err)
        if thread is not None:
            thread.join(timeout=timeout)
        self._drain_failed(err)

    def _drain_failed(self, err: BaseException) -> None:
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                self._deliver_error(item, err)
        _M_WAITING.set(0)

    # -- the scheduler loop --------------------------------------------------

    def _loop(self) -> None:
        err = RuntimeError("generation scheduler stopped")
        if self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        while True:
            # block only when fully idle; otherwise drain without waiting
            if not self._running and not self._waiting \
                    and not self._inflight:
                item = self._q.get()
                if item is _STOP or self._stopped:
                    if item is not _STOP and item is not None:
                        self._deliver_error(item, err)
                    break
                if isinstance(item, _ControlOp):
                    item.run()
                else:
                    self._waiting.append(item)
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item is _STOP:
                    self._shutdown(err)
                    return
                if isinstance(item, _ControlOp):
                    item.run()
                    continue
                self._waiting.append(item)
            if self._stopped:
                self._shutdown(err)
                return
            # one wall clock per iteration: admission, expiry, and
            # emission deadlines all read the same instant
            now = time.monotonic()
            if self._prefix_cache:
                # notice a params hot-swap BEFORE admission: matching
                # must never attach blocks computed under the previous
                # checkpoint (the device calls below would re-check, but
                # only after this iteration's match already committed)
                self._params()
            busy = bool(self._running or self._inflight)
            t0 = time.perf_counter()
            self._blocked_s = 0.0
            self._apply_cancels(now)
            self._admit(now)
            self._prefill_step(now)
            self._decode_step(now)
            if busy:
                wall = time.perf_counter() - t0
                dev = min(self._blocked_s, wall)
                _M_STEP.labels(component="device").observe(dev)
                _M_STEP.labels(component="host").observe(
                    max(0.0, wall - dev))
            self._publish_gauges()
        self._shutdown(err)

    def _shutdown(self, err: BaseException) -> None:
        # tokens still in flight belong to sequences this shutdown is
        # about to fail — drop them rather than race delivery with the
        # error
        self._inflight.clear()
        self._dstate = None
        self._lanes = [None] * self.max_seqs
        for s in list(self._running) + list(self._waiting):
            self._deliver_error(s, err)
        self._running = []
        self._waiting = []
        self._publish_gauges()

    def _publish_gauges(self) -> None:
        _M_RUNNING.set(len(self._running))
        _M_WAITING.set(len(self._waiting) + self._q.qsize())

    #: seconds an unmatched cancellation id survives before it is
    #: dropped (covers a cancel racing a submit in flight)
    _CANCEL_TTL_S = 30.0

    def _apply_cancels(self, now: float) -> None:
        """Fail every waiting/running sequence whose request id was
        :meth:`cancel`-flagged. In-flight decode steps drain first:
        their tokens are legitimate work for the surviving lanes, and
        the membership change must not race the pipeline."""
        with self._lock:
            if not self._cancels:
                return
            cancels = dict(self._cancels)
        hit = [s for s in self._running + self._waiting
               if s.request_id is not None and s.request_id in cancels]
        if hit:
            self._flush_inflight()
        applied = set()
        for s in hit:
            if s.state == "done":
                continue
            if s in self._waiting:
                self._waiting.remove(s)
            applied.add(s.request_id)
            self._deliver_error(s, RequestCancelledError(
                f"request {s.request_id} cancelled (sequence {s.id})"))
        with self._lock:
            for rid in [r for r, t in self._cancels.items()
                        if r in applied
                        or now - t > self._CANCEL_TTL_S]:
                del self._cancels[rid]

    # -- admission -----------------------------------------------------------

    def _admit(self, now: float) -> None:
        """FIFO admission: the head of the waiting line enters when a
        batch slot is free and the pool can cover its prefill.
        Admission never preempts (only growth of already-running
        sequences does) — an arrival that could steal blocks from the
        sequence that just preempted FOR it would ping-pong the pool
        forever. No head-of-line skipping either: a preempted sequence
        parked at the front must regain its blocks before anything
        younger runs. Expired waiters are shed wherever they stand
        (HTTP 429 shape) — a dead deadline is dead at any queue
        position.

        The block check is cache-aware: matched prefix blocks need no
        allocation, and the remainder may come from truly-free blocks
        or by evicting cached-free blocks that are NOT part of the
        match. With a cold (or disabled) cache nothing matches and
        nothing is cached, so the gate degrades to the conservative
        plain rule — enough *free* blocks for the whole prefill. The
        gate is per-sequence instantaneous state, not a reservation;
        the prefill/decode growth path still backstops any shortfall
        with preemption, exactly as before."""
        for s in [x for x in self._waiting
                  if now > x.deadline or now > x.budget]:
            self._waiting.remove(s)
            which = ("end-to-end budget" if now > s.budget else "deadline")
            self._deliver_error(s, DeadlineExceededError(
                f"{which} expired before sequence {s.id} could "
                f"{'resume' if s.resume_decode else 'start'}"
                + (f" (request {s.request_id})" if s.request_id else ""),
                stage="queue"))
        while self._waiting:
            s = self._waiting[0]
            if len(self._running) >= self.max_seqs:
                break
            need_total = self._alloc.blocks_for(len(s.prefill_tokens) + 1)
            matched = matched_cached = 0
            if self._prefix_cache and s.prefix_hashes:
                matched, matched_cached = \
                    self._alloc.match_probe(s.prefix_hashes)
            # matched cached blocks leave the evictable pool the moment
            # they attach, so they must not double-count as evictable
            evictable = self._alloc.cached_blocks - matched_cached
            if need_total - matched > self._alloc.free_blocks + evictable:
                break
            self._waiting.pop(0)
            s.state = "prefill"
            s.prefilled = 0
            s.cache_len = 0
            s.blocks = []
            s.block_hashes = []
            if self._prefix_cache:
                s.blocks = self._alloc.match(s.prefix_hashes)
                s.block_hashes = list(s.prefix_hashes[:len(s.blocks)])
                s.prefilled = len(s.blocks) * self._alloc.block_size
                s.cache_len = s.prefilled
                # hit attribution: a block whose contents arrived over
                # the disagg KV wire counts source=transfer until it
                # recycles; everything else was local prefill work
                bs = self._alloc.block_size
                transfer = sum(bs for b in s.blocks
                               if self._alloc.is_remote(b))
                if transfer:
                    _M_PREFIX_HIT.labels(source="transfer").inc(transfer)
                _M_PREFIX_HIT.labels(source="local").inc(
                    s.prefilled - transfer)
                _M_PREFIX_MISS.inc(len(s.prefill_tokens) - s.prefilled)
            s.cache_gen = self._alloc.cache_gen
            self._running.append(s)

    # -- prefill -------------------------------------------------------------

    def _expire_running(self, now: float) -> None:
        """The per-token contract holds for *admitted* sequences too: a
        running sequence whose budget to the next token lapsed — a slow
        multi-chunk prefill, or a decode iteration stretched past the
        budget — is shed instead of holding a batch slot and burning
        device time for a client that already gave up. Any in-flight
        step is drained first: a token it delivers resets that
        sequence's deadline, so only genuinely starved sequences shed."""
        if not any(now > x.deadline or now > x.budget
                   for x in self._running):
            return
        self._flush_inflight()
        for s in [x for x in self._running
                  if now > x.deadline or now > x.budget]:
            if s.state != "done":
                which = ("end-to-end budget" if now > s.budget
                         else "deadline")
                self._deliver_error(s, DeadlineExceededError(
                    f"{which} expired before sequence {s.id}'s next "
                    f"token"
                    + (f" (request {s.request_id})" if s.request_id else ""),
                    stage="prefill" if s.state == "prefill" else "decode"))

    def _prefill_step(self, now: float) -> None:
        self._expire_running(now)
        s = next((x for x in self._running if x.state == "prefill"), None)
        if s is None:
            return
        # drain pending decode steps first: their emissions precede this
        # prefill in device order, and the log/stream order should say so
        # (it also makes preemption decisions below see current state)
        self._flush_inflight()
        if s.state != "prefill":
            return                # a device failure during the drain
        total = len(s.prefill_tokens)
        chunk = s.prefill_tokens[s.prefilled:s.prefilled + self.prefill_chunk]
        live = len(chunk)
        need = self._alloc.blocks_for(s.prefilled + live) - len(s.blocks)
        if need > 0 and not self._grow(s, need):
            return          # s itself was preempted; nothing to run
        tokens = np.zeros((1, self.prefill_chunk), np.int32)
        tokens[0, :live] = chunk
        # the resume path discards the sampled token (it was emitted
        # before the eviction): force the cheap greedy branch
        temp = 0.0 if s.resume_decode else s.temperature
        sample = SampleParams(
            temperature=self._dev(np.asarray([temp], np.float32)),
            top_k=self._dev(np.asarray([s.top_k], np.int32)),
            top_p=self._dev(np.asarray([s.top_p], np.float32)),
            key=self._dev(s.key[None, :]),
            emitted=self._dev(np.asarray([s.sample_offset], np.int32)),
            sampled=temp > 0.0)
        if s.request_id:
            _tracing.note_request(s.request_id)
        try:
            # the span installs the request's context on the scheduler
            # thread, so collectives submitted inside the prefill program
            # bind under this chunk
            with _tracing.span_for(s.trace, "gen.prefill",
                                   args={"seq": s.id, "chunk": live,
                                         "prefilled": s.prefilled,
                                         "total": total}):
                _FP_PREFILL.fire()
                tok, logp = self._run_prefill(s, tokens, live, sample)
        except Exception as e:  # noqa: BLE001 — fails only this sequence
            self._deliver_error(s, e)
            return
        _M_TOKENS.labels(phase="prefill").inc(live)
        s.prefilled += live
        s.cache_len = s.prefilled
        self._register_full_blocks(s)
        if s.prefilled == total and self.role == "prefill":
            # prefill-only operating mode: the prompt's KV is resident
            # and its full blocks are registered — retiring now parks
            # them (contents intact, content-indexed) in the cached-free
            # pool, which IS the export staging area for /v1/kv/fetch.
            # The final chunk's sampled token is deliberately discarded:
            # the decode pool samples it itself from the identical
            # cache state, which is what keeps disaggregated output
            # bit-identical to colocated.
            self._retire(s, device_synced=True)
            if self.on_step is not None:
                self.on_step("prefill", [s.id])
            return
        if s.prefilled == total:
            s.state = "decode"
            self._epoch += 1        # a new lane joins the decode batch
            if s.num_beams > 1:
                # beam requests held the prompt's last token back from
                # prefill: it is the beam loop's first input, so the
                # first generated position branches into the top-W
                # hypotheses too. The chunk's sampled token is
                # discarded — the beam program re-scores the same
                # position from the identical cache state.
                s.next_input = s.prompt[-1]
            elif s.resume_decode:
                # recompute path: the cache now holds prompt + all but
                # the newest generated token; the next decode input is
                # that newest token, already emitted before preemption
                s.resume_decode = False
                s.next_input = s.generated[-1]
            else:
                # the final chunk's sampled token IS the first generated
                # token — a decode-phase token by accounting, even
                # though the prefill program produced it. (Intermediate
                # chunks never reach this sync: their sampled token is
                # simply not consumed.)
                _M_TOKENS.labels(phase="decode").inc()
                t0 = time.perf_counter()
                tok_v, logp_v = _host(tok, logp)
                self._blocked_s += time.perf_counter() - t0
                logp_v = _corrupt_logprobs(logp_v, [s])
                if not np.isfinite(logp_v[0]):
                    self._deliver_error(s, RuntimeError(
                        f"non-finite logprob for sequence {s.id}: "
                        f"silent data corruption in the prefill step"))
                    return
                self._emit(s, int(tok_v[0]), float(logp_v[0]), now)
        if self.on_step is not None:
            self.on_step("prefill", [s.id])

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the pools' device."""
        return torch.from_numpy(arr).to(self._device)

    def _run_prefill(self, s: GenSequence, tokens, live: int, sample):
        row = np.zeros((1, self.max_blocks), np.int32)
        row[0, :len(s.blocks)] = s.blocks
        cache = PagedCache(self._k, self._v, self._dev(row),
                           self._dev(np.asarray([s.prefilled], np.int32)),
                           self._dev(np.asarray([live], np.int32)))
        try:
            tok, logp, cache = self._prefill_prog(
                self._params(), cache, self._dev(tokens), sample)
        except Exception:
            # the pools may be half-written by the failed call. Widen
            # the blast radius to the whole running set (their cache
            # state lived in those pools) and rebuild them zeroed on the
            # same device: waiting sequences still serve next iteration.
            self._reset_device()
            raise
        self._k, self._v = cache.k, cache.v
        return tok, logp

    # -- decode --------------------------------------------------------------

    def _decode_step(self, now: float) -> None:
        for s in [x for x in self._running
                  if x.state == "decode" and x.num_beams > 1]:
            # beam requests run their whole search synchronously —
            # they never join the lane-batched decode state below
            self._run_beam(s, now)
        if self.spec:
            self._spec_decode_step(now)
            return
        if not self._inflight \
                and not any(x.state == "decode" and x.num_beams == 1
                            for x in self._running):
            return
        # membership drifted (admit/host-retire/preempt) since the device
        # state was built: drain the pipeline before touching it
        if self._dstate is None or self._state_epoch != self._epoch:
            self._flush_inflight()
        while True:
            batch = self._ensure_decode_blocks()
            if batch is not None:
                break
        batch = [x for x in batch if x.state == "decode"]
        if batch:
            if self._dstate is None or self._state_epoch != self._epoch:
                self._build_dstate(batch)
            try:
                _FP_DECODE.fire()
            except Exception as e:  # noqa: BLE001 — fails only this batch
                # the in-flight speculative step is legitimate work:
                # deliver its tokens, then fail this step's lanes (same
                # blast radius as the synchronous loop)
                self._flush_inflight()
                for s in batch:
                    if s.state == "decode":
                        self._deliver_error(s, e)
                return
            if self._tables_dirty:
                self._upload_tables()
            try:
                out = self._decode_prog(self._params(), self._k,
                                        self._v, self._dtables,
                                        self._dstate)
            except Exception:  # noqa: BLE001
                self._reset_device()
                return
            self._k, self._v, self._dstate, tok, logp = out
            self._inflight.append(_Flight([tok, logp], list(self._lanes)))
        # consume down to the configured pipeline depth — everything,
        # when nothing was enqueued this iteration
        limit = self.async_depth if batch else 0
        while len(self._inflight) > limit:
            self._process_flight(now)

    def _ensure_decode_blocks(self):
        """Guarantee every decoding sequence owns blocks covering its
        next write position — including the positions of steps already
        in flight plus the one about to be enqueued. Returns the (one)
        sorted decode list on success, or None after a flush/preemption
        changed the projections and the caller must recompute."""
        batch = sorted((x for x in self._running
                        if x.state == "decode" and x.num_beams == 1),
                       key=lambda x: x.id)
        for s in batch:
            if s.state != "decode":
                continue    # preempted while growing an older peer
            pending = len(self._inflight) if s in self._lanes else 0
            # a speculative step may commit up to 1 + spec_tokens
            # positions at once; reserving the full chunk up front is
            # at worst a few blocks of slack, never a correctness risk
            width = 1 if not self.spec else 1 + max(0, min(
                self.spec_tokens, s.max_tokens - len(s.generated) - 1))
            need = self._alloc.blocks_for(s.cache_len + pending + width) \
                - len(s.blocks)
            if need <= 0:
                continue
            # available counts evictable cached blocks too: allocate
            # sacrifices those before the scheduler considers preempting
            if need <= self._alloc.available_blocks:
                s.blocks.extend(self._alloc.allocate(need))
                self._tables_dirty = True
                continue
            # exhaustion. Preemption frees blocks of lanes the device
            # still counts live, and recompute needs exact host mirrors
            # — both require an empty pipeline.
            if self._inflight:
                self._flush_inflight()
                return None     # lengths/membership moved: re-project
            if self._grow(s, need):
                self._tables_dirty = True
            return None         # membership changed either way
        return batch

    def _build_dstate(self, batch: List[GenSequence]) -> None:
        self._flush_inflight()      # invariant, not just optimization
        B = self.max_seqs
        self._lanes = list(batch) + [None] * (B - len(batch))
        tokens = np.zeros((B,), np.int32)
        lengths = np.zeros((B,), np.int32)
        live = np.zeros((B,), np.int32)
        remaining = np.ones((B,), np.int32)
        eos = np.full((B,), -1, np.int32)
        temp = np.zeros((B,), np.float32)
        top_k = np.zeros((B,), np.int32)
        top_p = np.ones((B,), np.float32)
        key = np.zeros((B, 2), np.int64)
        emitted = np.zeros((B,), np.int32)
        for i, s in enumerate(batch):
            tokens[i] = s.next_input
            lengths[i] = s.cache_len
            live[i] = 1
            remaining[i] = s.max_tokens - len(s.generated)
            eos[i] = -1 if s.eos_id is None else s.eos_id
            temp[i] = s.temperature
            top_k[i] = s.top_k
            top_p[i] = s.top_p
            key[i] = s.key
            emitted[i] = s.sample_offset + len(s.generated)
        d = self._dev
        self._dstate = DecodeState(
            tokens=d(tokens), lengths=d(lengths), live=d(live),
            remaining=d(remaining), eos=d(eos),
            sample=SampleParams(
                temperature=d(temp), top_k=d(top_k), top_p=d(top_p),
                key=d(key), emitted=d(emitted),
                sampled=bool((temp > 0).any())))
        self._state_epoch = self._epoch
        self._tables_dirty = True

    def _upload_tables(self) -> None:
        tables = np.zeros((self.max_seqs, self.max_blocks), np.int32)
        for i, s in enumerate(self._lanes):
            if s is not None and s.state == "decode":
                tables[i, :len(s.blocks)] = s.blocks
        self._dtables = self._dev(tables)
        self._tables_dirty = False

    def _flush_inflight(self) -> None:
        if not self._inflight:
            return
        now = time.monotonic()
        while self._inflight:
            self._process_flight(now)

    def _process_flight(self, now: float) -> None:
        flight = self._inflight.popleft()
        lanes = flight.lanes
        t0 = time.perf_counter()
        try:
            tok, logp = flight.read()
        except Exception:  # noqa: BLE001 — the device step itself died
            self._reset_device()
            return
        self._blocked_s += time.perf_counter() - t0
        logp = _corrupt_logprobs(logp, lanes)   # serving.logprob drill
        emitted = []
        for i, s in enumerate(lanes):
            # a lane retired by an earlier flight had live=0 on device
            # for this one: no token was produced, nothing to mirror
            if s is None or s.state != "decode":
                continue
            if not np.isfinite(logp[i]):
                # silent-data-corruption blast radius: exactly this
                # sequence fails; its batchmates keep their tokens
                self._deliver_error(s, RuntimeError(
                    f"non-finite logprob for sequence {s.id}: silent "
                    f"data corruption in the decode step"))
                continue
            s.cache_len += 1
            if s.cache_len % self._alloc.block_size == 0:
                # this write completed a block: index it so multi-turn
                # prompts can reuse generated history too
                self._register_full_blocks(s)
            _M_TOKENS.labels(phase="decode").inc()
            emitted.append(s.id)
            self._emit(s, int(tok[i]), float(logp[i]), now)
        if emitted:
            _M_OCCUPANCY.observe(len(emitted))
            if self.on_step is not None:
                self.on_step("decode", emitted)

    # -- speculative decode --------------------------------------------------

    def _spec_decode_step(self, now: float) -> None:
        """One speculative step: draft on the host, verify the whole
        chunk in one paged forward, emit the accepted prefix plus the
        verifier's own next token. Output is bit-identical to the plain
        loop — the verify program recomputes the deterministic sample
        at every position — so drafting only ever changes throughput.
        The loop is synchronous (no async pipeline): the proposer needs
        host-visible history, so every step round-trips anyway."""
        self._flush_inflight()  # leftover plain-path flights, if any
        if not any(x.state == "decode" and x.num_beams == 1
                   for x in self._running):
            return
        while True:
            batch = self._ensure_decode_blocks()
            if batch is not None:
                break
        batch = [x for x in batch if x.state == "decode"]
        if not batch:
            return
        if self._dstate is None or self._state_epoch != self._epoch:
            self._build_dstate(batch)
        S = self.spec_tokens
        B = self.max_seqs
        draft = np.zeros((B, S), np.int32)
        dlen = np.zeros((B,), np.int32)
        drafted = 0
        for i, s in enumerate(self._lanes):
            if s is None or s.state != "decode":
                continue
            # never draft into the final position: the verifier's own
            # sample always takes the last slot, so a full-length
            # accept still retires exactly where plain decode would
            cap = min(S, s.max_tokens - len(s.generated) - 1)
            if cap <= 0:
                continue
            d = self._proposer.propose(s.prompt + s.generated, cap)[:cap]
            draft[i, :len(d)] = d
            dlen[i] = len(d)
            drafted += len(d)
        if drafted:
            _M_SPEC_DRAFTED.inc(drafted)
        try:
            _FP_VERIFY.fire()
        except Exception as e:  # noqa: BLE001 — fails only this batch
            for s in batch:
                if s.state == "decode":
                    self._deliver_error(s, e)
            return
        if self._tables_dirty:
            self._upload_tables()
        try:
            out = self._verify_prog(self._params(), self._k, self._v,
                                    self._dtables, self._dstate,
                                    self._dev(draft), self._dev(dlen))
        except Exception:  # noqa: BLE001
            self._reset_device()
            return
        self._k, self._v, self._dstate, pred_d, logp_d, n_emit_d = out
        t0 = time.perf_counter()
        try:
            pred, logp, n_emit = _host(pred_d, logp_d, n_emit_d)
        except Exception:  # noqa: BLE001 — the device step itself died
            self._reset_device()
            return
        dt = time.perf_counter() - t0
        self._blocked_s += dt
        # the verify transfer wait is the spec loop's device-blocked
        # share of the step — published both as the aggregate device
        # component (above) and under its own label for accept-rate
        # tuning
        _M_STEP.labels(component="verify").observe(dt)
        logp = _corrupt_logprobs(logp, self._lanes)  # serving.logprob
        emitted = []
        for i, s in enumerate(list(self._lanes)):
            if s is None or s.state != "decode":
                continue
            n = int(n_emit[i])
            _M_SPEC_ACCEPTED.inc(max(0, n - 1))
            _M_SPEC_ACCEPT_LEN.observe(max(0, n - 1))
            for j in range(n):
                if not np.isfinite(logp[i, j]):
                    # same blast radius as the plain loop: exactly this
                    # sequence fails, batchmates keep their tokens
                    self._deliver_error(s, RuntimeError(
                        f"non-finite logprob for sequence {s.id}: "
                        f"silent data corruption in the verify step"))
                    break
                s.cache_len += 1
                if s.cache_len % self._alloc.block_size == 0:
                    self._register_full_blocks(s)
                _M_TOKENS.labels(phase="decode").inc()
                self._emit(s, int(pred[i, j]), float(logp[i, j]), now)
                if s.state != "decode":
                    break       # retired on EOS/max_tokens mid-chunk
            if n:
                emitted.append(s.id)
        if emitted:
            _M_OCCUPANCY.observe(len(emitted))
            if self.on_step is not None:
                self.on_step("decode", emitted)

    # -- beam search ---------------------------------------------------------

    def _run_beam(self, s: GenSequence, now: float) -> None:
        """Run ``s``'s whole width-W beam search synchronously and
        deliver the highest-logprob finished hypothesis. Hypotheses are
        host-side dicts; their K/V lives in per-hypothesis block lists
        that fork copy-on-extend — full blocks are refcount-shared
        through the allocator, only the partial tail block is
        device-copied at divergence. Beam lanes never touch the plain
        loop's decode state (``_lanes``/``_dstate``)."""
        self._flush_inflight()
        if s.state != "decode":
            return
        W = s.num_beams
        bs = self._alloc.block_size
        root = {"tokens": [], "logprobs": [], "score": 0.0,
                "next_input": s.next_input, "cache_len": s.cache_len,
                "blocks": s.blocks}
        s.blocks = []       # ownership moved to the root hypothesis
        active = [root]
        finished: List[dict] = []

        def _free_hyps(hyps) -> None:
            for h in hyps:
                if h["blocks"]:
                    self._alloc.free(h["blocks"])
                    h["blocks"] = []

        def _take(n: int):
            """Allocate ``n`` blocks, preempting younger peers on
            exhaustion exactly like :meth:`_grow`; None when even that
            cannot cover it (the caller fails ``s``)."""
            while True:
                try:
                    return self._alloc.allocate(n)
                except BlocksExhaustedError:
                    victims = [x for x in self._running
                               if x.id > s.id and x.blocks]
                    if not victims:
                        return None
                    self._preempt(max(victims, key=lambda x: x.id))

        while active:
            now = time.monotonic()
            if now > s.deadline or now > s.budget:
                _free_hyps(active)
                which = ("end-to-end budget" if now > s.budget
                         else "deadline")
                self._deliver_error(s, DeadlineExceededError(
                    f"{which} expired during beam search for sequence "
                    f"{s.id}"
                    + (f" (request {s.request_id})" if s.request_id
                       else ""), stage="decode"))
                return
            for h in active:
                need = self._alloc.blocks_for(h["cache_len"] + 1) \
                    - len(h["blocks"])
                if need > 0:
                    got = _take(need)
                    if got is None:
                        _free_hyps(active)
                        self._deliver_error(s, BlocksExhaustedError(
                            f"beam search (width {W}) for sequence "
                            f"{s.id} exhausted the KV block pool with "
                            f"no younger sequence left to preempt"))
                        return
                    h["blocks"].extend(got)
            B = self.max_seqs
            tables = np.zeros((B, self.max_blocks), np.int32)
            tokens = np.zeros((B,), np.int32)
            lengths = np.zeros((B,), np.int32)
            live = np.zeros((B,), np.int32)
            for i, h in enumerate(active):
                tables[i, :len(h["blocks"])] = h["blocks"]
                tokens[i] = h["next_input"]
                lengths[i] = h["cache_len"]
                live[i] = 1
            try:
                _FP_DECODE.fire()
            except Exception as e:  # noqa: BLE001 — fails only s
                _free_hyps(active)
                self._deliver_error(s, e)
                return
            try:
                out = self._beam_prog(
                    self._params(), self._k, self._v,
                    self._dev(tables), self._dev(tokens),
                    self._dev(lengths), self._dev(live))
            except Exception:  # noqa: BLE001
                # beam blocks are invisible to _reset_device (s.blocks
                # is empty): free them first or they leak forever
                _free_hyps(active)
                self._reset_device()
                return
            self._k, self._v, top_tok_d, top_lp_d = out
            t0 = time.perf_counter()
            try:
                top_tok, top_lp = _host(top_tok_d, top_lp_d)
            except Exception:  # noqa: BLE001
                _free_hyps(active)
                self._reset_device()
                return
            self._blocked_s += time.perf_counter() - t0
            # candidate selection, best cumulative logprob first. Ties
            # break toward the older hypothesis and the lower-ranked
            # candidate — for W=1 that is exactly argmax, which is what
            # makes width-1 bit-identical to greedy decode.
            cands = []
            for i in range(len(active)):
                for j in range(top_tok.shape[1]):
                    cands.append(
                        (active[i]["score"] + float(top_lp[i, j]), i, j))
            cands.sort(key=lambda c: (-c[0], c[1], c[2]))
            sel = []        # (parent_idx, token, logprob, score)
            for score, i, j in cands:
                if len(sel) >= W:
                    break
                t = int(top_tok[i, j])
                lp = float(top_lp[i, j])
                h = active[i]
                done_now = ((s.eos_id is not None and t == s.eos_id)
                            or len(h["tokens"]) + 1 >= s.max_tokens)
                if done_now:
                    if len(finished) < W:
                        finished.append(
                            {"tokens": h["tokens"] + [t],
                             "logprobs": h["logprobs"] + [lp],
                             "score": score, "blocks": []})
                    continue
                sel.append((i, t, lp, score))
            # fork: the first child of each parent inherits its block
            # list wholesale; siblings share() the full blocks and
            # device-copy the partial tail at the divergence point
            snapshots = [list(h["blocks"]) for h in active]
            claimed = set()
            new_active: List[dict] = []
            failed = False
            for i, t, lp, score in sel:
                L = active[i]["cache_len"] + 1   # resident after write
                if i not in claimed:
                    claimed.add(i)
                    blocks = active[i]["blocks"]
                    active[i]["blocks"] = []
                else:
                    pblocks = snapshots[i]
                    full = L // bs
                    blocks = []
                    if full:
                        self._alloc.share(pblocks[:full])
                        blocks.extend(pblocks[:full])
                    if L % bs:
                        got = _take(1)
                        if got is None:
                            self._alloc.free(blocks)
                            failed = True
                            break
                        blocks.extend(got)
                        src = pblocks[full]
                        self._k[:, got[0]] = self._k[:, src]
                        self._v[:, got[0]] = self._v[:, src]
                new_active.append(
                    {"tokens": active[i]["tokens"] + [t],
                     "logprobs": active[i]["logprobs"] + [lp],
                     "score": score, "next_input": t,
                     "cache_len": L, "blocks": blocks})
            if failed:
                _free_hyps(new_active)
                _free_hyps(active)
                self._deliver_error(s, BlocksExhaustedError(
                    f"beam search (width {W}) for sequence {s.id} "
                    f"could not fork a hypothesis: KV block pool "
                    f"exhausted with no younger sequence to preempt"))
                return
            _free_hyps([h for i, h in enumerate(active)
                        if i not in claimed])
            active = new_active
            if self.on_step is not None:
                self.on_step("decode", [s.id])
            if finished:
                best_fin = max(f["score"] for f in finished)
                # scores only fall as beams extend (logprobs <= 0), so
                # a finished hypothesis at least as good as every
                # survivor can never be overtaken
                if len(finished) >= W or not active or best_fin >= max(
                        h["score"] for h in active):
                    break
        pool = finished if finished else active
        win = max(pool, key=lambda h: h["score"])
        _free_hyps(active)
        _M_TOKENS.labels(phase="decode").inc(len(win["tokens"]))
        for t, lp in zip(win["tokens"], win["logprobs"]):
            if s.state != "decode":
                break
            self._emit(s, int(t), float(lp), now)
        if s.state != "done":
            self._retire(s, device_synced=True)

    # -- shared machinery ----------------------------------------------------

    def _params(self):
        """The params for the next device call, watching for hot-swaps:
        cached K/V was computed under the *previous* checkpoint, so a
        new params object drops the whole prefix-cache index (live
        sequences keep decoding on their own blocks, per the
        hot-reload doctrine — only cross-sequence reuse is severed)."""
        p = self._params_fn()
        if p is not self._last_params:
            if self._last_params is not _UNSET and self._prefix_cache:
                self._alloc.reset_cache()
            self._last_params = p
        return p

    def _prefix_hashes_for(self, tokens: List[int]) -> List[str]:
        """Chain hashes of ``tokens``' matchable full blocks, capped
        below the final token: prefill must always have at least one
        token to run, because the prefill program is what samples the
        first generated token."""
        bs = self._alloc.block_size
        n = max(0, (len(tokens) - 1) // bs)
        out: List[str] = []
        parent: Optional[str] = None
        for j in range(n):
            parent = chain_hash(parent, tokens[j * bs:(j + 1) * bs])
            out.append(parent)
        return out

    def _register_full_blocks(self, s: GenSequence) -> None:
        """Index every newly *completed* block of ``s`` under its
        content chain hash. Skipped when the allocator's cache
        generation moved since admission — the blocks were filled under
        contents (params / pools) that no longer exist."""
        if not self._prefix_cache or s.cache_gen != self._alloc.cache_gen:
            return
        bs = self._alloc.block_size
        target = s.cache_len // bs
        if target <= len(s.block_hashes):
            return
        full = s.prompt + s.generated
        while len(s.block_hashes) < target:
            j = len(s.block_hashes)
            if j < len(s.prefix_hashes):
                h = s.prefix_hashes[j]
            else:
                h = chain_hash(s.block_hashes[-1] if j else None,
                               full[j * bs:(j + 1) * bs])
            self._alloc.register(s.blocks[j], h)
            s.block_hashes.append(h)

    def _reset_device(self) -> None:
        """After a genuine device failure: the pools and the decode state
        are suspect, so drop them all, fail the whole running set, and
        rebuild zeroed pools on the same device — waiting sequences serve
        next iteration."""
        err = RuntimeError(
            "generation device step failed; the paged KV pools were "
            "rebuilt and every running sequence was failed")
        self._inflight.clear()
        self._dstate = None
        self._dtables = None
        self._tables_dirty = True
        self._state_epoch = -1
        self._epoch += 1
        self._lanes = [None] * self.max_seqs
        for s in list(self._running):
            self._deliver_error(s, err)
        self._k = torch.zeros(self._pool_shape, dtype=self._pool_dtype,
                              device=self._device)
        self._v = torch.zeros(self._pool_shape, dtype=self._pool_dtype,
                              device=self._device)
        # the rebuilt pools are zeroed: every indexed block's contents
        # are gone, so the content index must go with them
        self._alloc.reset_cache()

    def _grow(self, s: GenSequence, need: int) -> bool:
        """Allocate ``need`` blocks for ``s``, preempting the youngest
        block-holding *younger* peer on exhaustion; with none left,
        ``s`` preempts itself. Returns False when ``s`` was preempted.
        Callers guarantee the pipeline is drained before a preempting
        grow (``_ensure_decode_blocks`` / ``_prefill_step`` flush
        first).

        Only-younger matters: if a grower could evict an *older*
        sequence, two sequences could evict each other forever. This
        way age strictly wins, the oldest sequence always progresses,
        and a self-preempted sequence is only readmitted once the block
        it was missing is genuinely free (its re-prefill need equals
        the allocation that just failed) — no recompute churn."""
        while True:
            try:
                s.blocks.extend(self._alloc.allocate(need))
                return True
            except BlocksExhaustedError:
                victims = [x for x in self._running
                           if x.id > s.id and x.blocks]
                if not victims:
                    self._preempt(s)
                    return False
                self._preempt(max(victims, key=lambda x: x.id))

    def _preempt(self, s: GenSequence) -> None:
        """Free ``s``'s blocks and requeue it (front of the line) in
        recompute mode. An injected ``serving.evict`` error fails the
        evicted sequence instead — the eviction drill's failure shape."""
        try:
            _FP_EVICT.fire()
        except Exception as e:  # noqa: BLE001
            self._deliver_error(s, e)
            return
        self._alloc.free(s.blocks)
        s.blocks = []
        s.block_hashes = []
        if s.state == "decode" and s.generated:
            # cache must be rebuilt up to (but not including) the newest
            # generated token — it is the resumed decode's input
            s.prefill_tokens = s.prompt + s.generated[:-1]
            s.resume_decode = True
            if self._prefix_cache:
                # re-match on readmission: the full blocks just freed
                # parked in the cached pool, so unless pressure evicts
                # them first the resume prefill is nearly free
                s.prefix_hashes = self._prefix_hashes_for(s.prefill_tokens)
        s.prefilled = 0
        s.cache_len = 0
        s.state = "waiting"
        if s in self._running:
            self._running.remove(s)
        for i, x in enumerate(self._lanes):
            if x is s:
                # the device still counts this lane live: rebuild
                # before the next enqueue
                self._lanes[i] = None
                self._epoch += 1
        self._waiting.insert(0, s)
        _M_PREEMPTIONS.inc()
        if s.trace is not None:
            t = time.monotonic()
            _tracing.emit_span(s.trace, "gen.preempt", t, t,
                               args={"seq": s.id,
                                     "generated": len(s.generated)})
        import logging
        logging.getLogger("horovod_tpu_torch").info(
            "preempted sequence %s%s: KV blocks freed, requeued at the "
            "front of the waiting line in recompute mode", s.id,
            f" (request {s.request_id})" if s.request_id else "")

    def _emit(self, s: GenSequence, token: int, logprob: float,
              now: float) -> None:
        s.generated.append(token)
        s.logprobs.append(logprob)
        s.next_input = token
        if s.trace is not None:
            # one instant span per emitted token — the decode-step
            # analogue of the per-chunk prefill span (the guard is a
            # single is-None test for untraced sequences)
            t = time.monotonic()
            _tracing.emit_span(s.trace, "gen.decode", t, t,
                               args={"seq": s.id,
                                     "token_index": len(s.generated)})
        if s.deadline_s > 0:
            s.deadline = now + s.deadline_s
        s.stream_q.put(token)
        if (s.eos_id is not None and token == s.eos_id) \
                or len(s.generated) >= s.max_tokens:
            # the decode program applied the SAME rule on device and
            # already dropped the lane's live flag — no epoch bump
            self._retire(s, device_synced=True)

    def _retire(self, s: GenSequence, device_synced: bool = True) -> None:
        if s.blocks:
            self._alloc.free(s.blocks)
            s.blocks = []
        if s in self._running:
            self._running.remove(s)
        for i, x in enumerate(self._lanes):
            if x is s:
                self._lanes[i] = None
                if not device_synced:
                    # the device thinks the lane is live: force a state
                    # rebuild before the next decode enqueue
                    self._epoch += 1
        s.state = "done"
        s.stream_q.put(_DONE)
        s.done_event.set()

    def _deliver_error(self, s, err: BaseException) -> None:
        if isinstance(s, _ControlOp):
            # a control op drained by stop()/shutdown: fail its waiter
            s.fail(err)
            return
        if s.state == "done":
            # completed (or already failed) while the error was brewing
            # — e.g. retired by a drained in-flight step; its outcome
            # stands
            return
        s.error = err
        self._retire(s, device_synced=False)
