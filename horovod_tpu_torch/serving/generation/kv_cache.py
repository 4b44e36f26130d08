"""Paged KV cache: fixed-size block pools + the block allocator
(counterpart of ``horovod_tpu/serving/generation/kv_cache.py``).

vLLM's PagedAttention observation, applied to this stack: a dense KV
cache reserves ``max_len x batch`` per layer, but at any instant only
the *live* tokens matter. So the cache is a pool of fixed-size blocks
(``HVD_TPU_GEN_BLOCK_SIZE`` tokens each, ``HVD_TPU_GEN_NUM_BLOCKS`` of
them) and every sequence owns an ordered *block table* mapping its
logical block index to a pool block. Blocks are allocated on growth
(one at a time as decode crosses a block boundary, a run at once for a
prefill chunk) and freed the moment a sequence finishes or is
preempted — live KV memory tracks live tokens.

**Block 0 is the null block.** It is never handed out: the model routes
every padded-token and dead-lane write there
(:class:`horovod_tpu_torch.models.transformer.PagedCache`), which is
what lets the prefill/decode programs keep fully static shapes while
batch composition changes every step.

The allocator is strict by design: allocation is all-or-nothing
(:class:`BlocksExhaustedError` is the scheduler's preemption trigger,
never a partial grant) and :meth:`BlockAllocator.free` rejects
double-frees and foreign ids — a leak or a tangle fails the test that
caused it, instead of surfacing as silent cache corruption under load.
``hvd_tpu_gen_kv_blocks_in_use`` tracks the live block count;
:attr:`BlockAllocator.peak_in_use` is the high-water mark the
microbench compares against a dense reservation.

**Automatic prefix caching** (``HVD_TPU_GEN_PREFIX_CACHE``, default
on) adds SGLang/vLLM-style block reuse on top. Every *full* block can
be registered under a content chain hash ``h(parent_hash,
block_tokens)`` — the hash commits to the whole token prefix, so two
blocks share a hash iff the cache contents feeding them were computed
from identical prefixes. Blocks become refcounted: a prompt that
matches a chain of indexed blocks attaches them with refcounts bumped
(:meth:`BlockAllocator.match`) and prefill starts at the first
uncached token. When the last reference drops, an indexed block parks
in a **cached-free LRU pool** with contents intact instead of being
recycled; allocation takes truly-free blocks first and only then
evicts cached blocks, least-recently-used first. Within one release
the blocks of a sequence are parked tail-first, so eviction consumes
a cached chain from its tail and the head prefix stays matchable.
Sharing is full-block-only — the partial tail block is always private
to one sequence — so no write ever lands in a shared block and
cached-prefix decode is bit-identical to cold decode.

The allocator and :func:`chain_hash` are the JAX module's host logic,
line for line, so both packages hand out the same blocks and name them
with the same hashes. The five programs (:func:`build_program`, prefill,
decode, verify, beam) are plain functions on tensors with static shapes,
run eagerly under ``torch.no_grad()``: each takes the pools and returns
them, written in place (``index_put_``), where the JAX programs take and
return donated buffers. :func:`sample_tokens` draws through the port's
threefry (:mod:`._threefry`), so a seeded request samples the JAX
package's tokens.
"""

import collections
import dataclasses
import functools
import hashlib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import _locks
from ... import config as _config
from ... import metrics as _metrics
from ...models.transformer import PagedCache
from . import _threefry

_M_BLOCKS = _metrics.gauge(
    "hvd_tpu_gen_kv_blocks_in_use",
    "KV-cache blocks currently allocated to live generation sequences "
    "(the null block excluded). Live KV memory is this times the "
    "per-block byte size; pinning near HVD_TPU_GEN_NUM_BLOCKS means "
    "admission is block-bound and preemptions are imminent.")
_M_BLOCK_STATE = _metrics.gauge(
    "hvd_tpu_gen_kv_blocks",
    "KV-cache block pool split by state (the null block excluded): "
    "free=never-written or recycled, cached=contents intact in the "
    "prefix-cache LRU pool awaiting reuse or eviction, private=held by "
    "exactly one live sequence, shared=prefix blocks referenced by two "
    "or more live sequences. The four states always sum to the pool "
    "capacity.",
    labels=("state",))
_M_EVICTIONS = _metrics.counter(
    "hvd_tpu_gen_prefix_cache_evictions_total",
    "Cached-free KV blocks whose contents were discarded to satisfy an "
    "allocation (free list empty, LRU cached block recycled). A high "
    "rate relative to hits means the pool is too small for the working "
    "set of shared prefixes.")


def chain_hash(parent: Optional[str], tokens: Sequence[int]) -> str:
    """Content key for one full KV block: commits to the parent block's
    hash (hence the entire token prefix) plus this block's tokens, so
    equal hashes imply bit-equal cache contents for the whole chain."""
    h = hashlib.sha1()
    h.update((parent or "").encode("ascii"))
    h.update(b"|")
    h.update(",".join(str(int(t)) for t in tokens).encode("ascii"))
    return h.hexdigest()


class BlocksExhaustedError(RuntimeError):
    """Not enough free KV blocks for an allocation. Internal to the
    generation plane: the scheduler answers it by preempting the
    youngest running sequence, never by wedging."""


class BlockAllocator:
    """Refcounting allocator over the KV block pool (block 0 reserved).

    Set-based accounting keeps every per-block operation O(1):
    ``_free_set`` mirrors the free stack, ``_ref`` maps each live block
    to its reference count (doubling as the owned set for double-free
    and foreign-id rejection), and ``_cached`` is an insertion-ordered
    dict whose order *is* the LRU eviction order of the cached-free
    pool. ``prefix_cache=None`` reads ``HVD_TPU_GEN_PREFIX_CACHE``;
    with the feature off, ``free`` recycles immediately and the index
    stays empty — a plain allocator, with refcounts of 1.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 prefix_cache: Optional[bool] = None):
        if num_blocks < 2:
            raise ValueError(
                f"HVD_TPU_GEN_NUM_BLOCKS={num_blocks}: need at least 2 "
                f"(block 0 is the reserved null block)")
        if block_size < 1:
            raise ValueError(
                f"HVD_TPU_GEN_BLOCK_SIZE={block_size}: must be >= 1")
        if prefix_cache is None:
            prefix_cache = bool(
                _config.live_config().get(_config.GEN_PREFIX_CACHE))
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        #: usable blocks (block 0 excluded)
        self.capacity = self.num_blocks - 1
        self.prefix_cache = bool(prefix_cache)
        self._lock = _locks.lock("serving.generation.BlockAllocator._lock")
        # pop() hands out ascending ids — deterministic schedules make
        # the chaos drills replayable
        self._free_list = list(range(self.num_blocks - 1, 0, -1))
        self._free_set = set(self._free_list)
        self._ref: Dict[int, int] = {}
        # cached-free pool: block -> None, oldest-inserted first (LRU)
        self._cached: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self._index: Dict[str, int] = {}    # content hash -> block
        self._hash_of: Dict[int, str] = {}  # indexed block -> its hash
        self._n_shared = 0                  # blocks with refcount >= 2
        #: blocks whose contents arrived over the disagg KV wire
        #: (register(..., remote=True)) rather than from local prefill;
        #: membership is sticky until the block recycles or evicts, so
        #: admission can attribute prefix-cache hits source=transfer
        self._remote: set = set()
        #: bumped by :meth:`reset_cache`; sequences record it so a block
        #: filled before a reset (stale params / zeroed pools) is never
        #: registered after one
        self.cache_gen = 0
        self.peak_in_use = 0

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` cache slots."""
        return max(1, math.ceil(tokens / self.block_size))

    @property
    def free_blocks(self) -> int:
        """Truly-free blocks (cached-free blocks not included)."""
        with self._lock:
            return len(self._free_list)

    @property
    def cached_blocks(self) -> int:
        """Blocks parked in the cached-free pool (refcount 0, contents
        intact, evictable)."""
        with self._lock:
            return len(self._cached)

    @property
    def available_blocks(self) -> int:
        """Blocks an allocation could obtain right now: truly free plus
        evictable cached. The scheduler's admissibility checks use this
        so a prompt that fits only by evicting cached blocks is still
        admitted."""
        with self._lock:
            return len(self._free_list) + len(self._cached)

    @property
    def in_use(self) -> int:
        """Blocks referenced by at least one live sequence. Cached-free
        blocks are *not* in use — the leak checks throughout the tests
        and microbench rely on this returning 0 once every sequence has
        retired, cache or no cache."""
        with self._lock:
            return len(self._ref)

    def refcount(self, block: int) -> int:
        """Live references to ``block`` (0 for free or cached-free)."""
        with self._lock:
            return self._ref.get(block, 0)

    def stats(self) -> Dict[str, int]:
        """The ``{state: count}`` pool split published on the
        ``hvd_tpu_gen_kv_blocks`` gauge; the four states sum to
        :attr:`capacity`."""
        with self._lock:
            return self._stats_locked()

    def _stats_locked(self) -> Dict[str, int]:
        return {
            "free": len(self._free_list),
            "cached": len(self._cached),
            "private": len(self._ref) - self._n_shared,
            "shared": self._n_shared,
        }

    def _publish(self, in_use: int, stats: Dict[str, int]) -> None:
        # metric publication happens outside the lock: counts are
        # computed under it, cells are atomic
        _M_BLOCKS.set(in_use)
        for state, count in stats.items():
            _M_BLOCK_STATE.labels(state=state).set(count)

    def allocate(self, n: int) -> List[int]:
        """Hand out ``n`` blocks, all-or-nothing. Truly-free blocks are
        taken first; when the free list runs dry, cached-free blocks
        are evicted least-recently-used first (their index entries are
        dropped and ``hvd_tpu_gen_prefix_cache_evictions_total`` ticks).
        Raises :class:`BlocksExhaustedError` when free + cached cannot
        cover ``n`` — cached blocks are always sacrificed before the
        scheduler ever considers preempting a running sequence."""
        if n <= 0:
            return []
        evicted = 0
        with self._lock:
            if n > len(self._free_list) + len(self._cached):
                raise BlocksExhaustedError(
                    f"need {n} KV blocks, {len(self._free_list)} free + "
                    f"{len(self._cached)} cached "
                    f"(of {self.capacity} usable)")
            out = []
            for _ in range(n):
                if self._free_list:
                    b = self._free_list.pop()
                    self._free_set.discard(b)
                else:
                    b, _ = self._cached.popitem(last=False)
                    h = self._hash_of.pop(b)
                    if self._index.get(h) == b:
                        del self._index[h]
                    self._remote.discard(b)
                    evicted += 1
                self._ref[b] = 1
                out.append(b)
            in_use = len(self._ref)
            if in_use > self.peak_in_use:
                self.peak_in_use = in_use
            stats = self._stats_locked()
        if evicted:
            _M_EVICTIONS.inc(evicted)
        self._publish(in_use, stats)
        return out

    def free(self, blocks: List[int]) -> None:
        """Drop one reference per listed block. A block whose refcount
        reaches 0 parks in the cached-free pool if it is indexed (the
        sequence's blocks are parked tail-first, so LRU eviction eats a
        chain from its tail and the head prefix stays matchable) and is
        recycled otherwise. Releasing a free/cached block, the null
        block, or an id outside the pool raises — accounting bugs must
        fail the caller, not corrupt a stranger's cache."""
        with self._lock:
            counts = collections.Counter()
            for b in blocks:
                if not 1 <= b < self.num_blocks:
                    raise ValueError(
                        f"free of invalid KV block id {b} (pool is "
                        f"1..{self.num_blocks - 1})")
                counts[b] += 1
                if counts[b] > self._ref.get(b, 0):
                    raise ValueError(f"double free of KV block {b}")
            to_park = []
            for b in blocks:
                r = self._ref[b] - 1
                if r == 0:
                    del self._ref[b]
                    h = self._hash_of.get(b)
                    if h is not None and self._index.get(h) == b:
                        to_park.append(b)
                    else:
                        if h is not None:
                            del self._hash_of[b]
                        self._remote.discard(b)
                        self._free_list.append(b)
                        self._free_set.add(b)
                else:
                    self._ref[b] = r
                    if r == 1:
                        self._n_shared -= 1
            for b in reversed(to_park):
                self._cached[b] = None
            in_use = len(self._ref)
            stats = self._stats_locked()
        self._publish(in_use, stats)

    # -- prefix-cache surface -----------------------------------------

    def register(self, block: int, content_hash: str,
                 remote: bool = False) -> None:
        """Index a live *full* block under its content chain hash so
        future prompts can match it. First registration wins: a hash
        already indexed (or a block already hashed) is left alone, and
        the duplicate block simply recycles on release. No-op with the
        prefix cache off.

        ``remote=True`` marks the block as transfer-imported (its
        contents arrived over the disagg KV wire instead of local
        prefill); the flag sticks until the block recycles or evicts
        and drives the ``source=transfer`` split of the prefix-cache
        hit metric. A double-import of an already-indexed hash dedups
        exactly like a local duplicate — first registration wins, the
        second block recycles."""
        if not self.prefix_cache:
            return
        with self._lock:
            if block not in self._ref:
                raise ValueError(
                    f"register of KV block {block} with no live owner")
            if content_hash not in self._index and \
                    block not in self._hash_of:
                self._index[content_hash] = block
                self._hash_of[block] = content_hash
                if remote:
                    self._remote.add(block)

    def is_remote(self, block: int) -> bool:
        """True when ``block``'s contents arrived via KV transfer
        (``register(..., remote=True)``) and it has not recycled or
        evicted since."""
        with self._lock:
            return block in self._remote

    @property
    def remote_blocks(self) -> int:
        """Blocks currently carrying the transfer-imported mark (live
        or cached)."""
        with self._lock:
            return len(self._remote)

    def match_probe(self, hashes: Sequence[str]) -> Tuple[int, int]:
        """Side-effect-free length of the longest indexed prefix of
        ``hashes``: ``(matched_blocks, matched_cached)`` where the
        second count is how many of the matched blocks currently sit in
        the cached-free pool (they would leave it on a real
        :meth:`match`, so admissibility math must not double-count them
        as evictable)."""
        matched = cached = 0
        with self._lock:
            for h in hashes:
                b = self._index.get(h)
                if b is None:
                    break
                matched += 1
                if b in self._cached:
                    cached += 1
        return matched, cached

    def match(self, hashes: Sequence[str]) -> List[int]:
        """Attach the longest indexed prefix of ``hashes``: cached-free
        blocks revive with refcount 1, live blocks bump their refcount
        (becoming shared). Returns the matched block ids in chain
        order; the caller owns one reference to each."""
        out: List[int] = []
        if not self.prefix_cache:
            return out
        with self._lock:
            for h in hashes:
                b = self._index.get(h)
                if b is None:
                    break
                if b in self._cached:
                    del self._cached[b]
                    self._ref[b] = 1
                else:
                    r = self._ref[b] + 1
                    self._ref[b] = r
                    if r == 2:
                        self._n_shared += 1
                out.append(b)
            in_use = len(self._ref)
            if in_use > self.peak_in_use:
                self.peak_in_use = in_use
            stats = self._stats_locked()
        if out:
            self._publish(in_use, stats)
        return out

    def share(self, blocks: Sequence[int]) -> None:
        """Bump the refcount of already-live blocks — the beam-search
        fork path: a child beam attaches its parent's full prefix
        blocks instead of copying them, exactly like a prefix-cache
        :meth:`match` except the blocks are named directly (beams of
        one request share blocks whether or not the content index is
        enabled). Sharing a free, cached, or null block raises — only a
        live owner can be forked from."""
        bl = list(blocks)
        with self._lock:
            for b in bl:
                if b not in self._ref:
                    raise ValueError(
                        f"share of KV block {b} with no live owner")
            for b in bl:
                r = self._ref[b] + 1
                self._ref[b] = r
                if r == 2:
                    self._n_shared += 1
            in_use = len(self._ref)
            if in_use > self.peak_in_use:
                self.peak_in_use = in_use
            stats = self._stats_locked()
        self._publish(in_use, stats)

    def reset_cache(self) -> None:
        """Drop the whole content index and recycle every cached-free
        block. Called when cache *contents* stop being trustworthy —
        a params hot-swap or a device-pool rebuild — and bumps
        :attr:`cache_gen` so blocks filled under the old contents are
        never registered under the new ones."""
        with self._lock:
            for b in self._cached:
                self._free_list.append(b)
                self._free_set.add(b)
            self._cached.clear()
            self._index.clear()
            self._hash_of.clear()
            self._remote.clear()
            self.cache_gen += 1
            in_use = len(self._ref)
            stats = self._stats_locked()
        self._publish(in_use, stats)


def make_pools(model_cfg, num_blocks: int, block_size: int, device=None):
    """Zeroed K/V pools for ``model_cfg`` (a
    :class:`~horovod_tpu_torch.models.transformer.TransformerConfig`):
    ``(num_layers, num_blocks, block_size, heads, head_dim)`` each, in
    the model's activation dtype, on ``device`` (the card unless asked
    otherwise)."""
    from ...basics import resolve_device
    dev = resolve_device(device)
    shape = (model_cfg.num_layers, num_blocks, block_size,
             model_cfg.num_heads, model_cfg.head_dim)
    return (torch.zeros(shape, dtype=model_cfg.dtype, device=dev),
            torch.zeros(shape, dtype=model_cfg.dtype, device=dev))


def block_bytes(model_cfg, block_size: int) -> int:
    """Bytes of KV cache one block holds (K and V, all layers)."""
    itemsize = torch.empty((), dtype=model_cfg.dtype).element_size()
    return (2 * model_cfg.num_layers * block_size * model_cfg.num_heads
            * model_cfg.head_dim * itemsize)


def gather_blocks(k, v, blocks: Sequence[int]):
    """Copy the contents of pool ``blocks`` to the host for the disagg KV
    wire: ``(k_host, v_host)``, CPU tensors each ``(num_layers,
    len(blocks), block_size, heads, head_dim)`` in the pool dtype (numpy
    has no bfloat16). Runs on the scheduler thread, which owns the
    pools."""
    idx = torch.as_tensor(list(blocks), dtype=torch.long, device=k.device)
    return k[:, idx].cpu(), v[:, idx].cpu()


def scatter_blocks(k, v, blocks: Sequence[int], k_data, v_data):
    """Write transferred block contents into pool slots ``blocks`` (in
    place); returns the ``(k, v)`` pools. Scheduler-thread only, like
    :func:`gather_blocks`. ``k_data``/``v_data`` are tensors or numpy
    arrays, cast to the pool dtype."""
    idx = torch.as_tensor(list(blocks), dtype=torch.long, device=k.device)
    for pool, data in ((k, k_data), (v, v_data)):
        t = data if isinstance(data, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(data))
        pool[:, idx] = t.to(device=pool.device, dtype=pool.dtype)
    return k, v


def _apply(model, params, tokens, cache, logits_at=None, step_width=None):
    """The model's paged forward with ``params`` (a flat dict of tensors
    by state_dict name) in place of its own."""
    kwargs = {"cache": cache, "logits_at": logits_at}
    if step_width is not None:
        kwargs["step_width"] = step_width
    return torch.func.functional_call(model, params, (tokens,), kwargs)


@functools.lru_cache(maxsize=8)
def build_program(model):
    """The raw-logits incremental forward:
    ``(params, PagedCache, tokens) -> (logits, PagedCache)``, the pools
    written in place. Called with ``tokens`` of shape ``(1,
    prefill_chunk)`` it is the prefill program; with ``(max_seqs,
    DECODE_WIDTH)`` the decode program. Memoized on the model.

    The scheduler's hot path does not run this program: it drives
    :func:`build_prefill_program` / :func:`build_decode_program`, which
    sample on the device and never ship logits to the host. This one is
    the reference surface: the tests (and ``chip_smoke.py``) pin the
    sampling programs' greedy tokens against its host-side ``argmax``.
    """

    @torch.no_grad()
    def _paged_forward(params, cache, tokens):
        return _apply(model, params, tokens, cache)

    return _paged_forward


# -- on-device sampling ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SampleParams:
    """Per-lane sampling controls, resident on device.

    ``temperature`` ``(B,)`` float32 — ``<= 0`` selects greedy argmax
    (bit-identical to host ``np.argmax`` of the raw logits).
    ``top_k`` ``(B,)`` int32 — keep the k highest-scoring tokens
    (``<= 0`` disables). ``top_p`` ``(B,)`` float32 — nucleus mass
    (``>= 1`` disables; the top token always survives). ``key``
    ``(B, 2)`` int64 holding the per-request threefry key's two uint32
    words; every emission folds the emitted-token ordinal into it
    (:func:`._threefry.fold_in`), so a continuation is a pure function of
    (seed, position) and the preemption-recompute path replays the
    identical tokens. ``emitted`` ``(B,)`` int32 — that ordinal (==
    tokens generated so far). ``sampled``: whether any lane samples
    (temperature > 0), known on the host where the state is built; an
    all-greedy batch skips the two vocab sorts and the draw without a
    device sync (None: read it off ``temperature``).
    """

    temperature: Any
    top_k: Any
    top_p: Any
    key: Any
    emitted: Any
    sampled: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class DecodeState:
    """The device-resident decode loop state, one row per batch lane.

    The decode program consumes it and returns its successor, feeding
    each lane's sampled token back as the next input: ``tokens`` ``(B,)``
    int32 next-input ids, ``lengths`` ``(B,)`` int32 cache lengths,
    ``live`` ``(B,)`` int32 lane-occupied mask, ``remaining`` ``(B,)``
    int32 tokens still to emit, ``eos`` ``(B,)`` int32 EOS id (-1 =
    none), and the :class:`SampleParams`. Retirement (EOS or
    ``max_tokens``) is decided *inside* the program — a retired lane's
    ``live`` drops to 0 on device, so a speculatively enqueued next
    step routes its writes to the null block with no host round-trip.
    The host only rebuilds and re-uploads this state when batch
    membership changes (admit/retire/preempt), keyed by a batch epoch.
    """

    tokens: Any
    lengths: Any
    live: Any
    remaining: Any
    eos: Any
    sample: SampleParams


def sample_tokens(logits, sample: SampleParams):
    """Select one token per row from ``(B, vocab)`` float32 logits, on
    device.

    Greedy rows (``temperature <= 0``) take ``argmax``; sampled rows
    scale by temperature, apply top-k then top-p restriction, and draw
    categorically under the row's folded threefry key. Returns
    ``(token (B,) int32, logprob (B,) float32)`` — the logprob is under
    the *unmodified* distribution, so observability reads the model's
    actual confidence, not the truncated one.
    """
    vocab = logits.shape[-1]
    greedy = sample.temperature <= 0.0
    argmax_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled = sample.sampled
    if sampled is None:
        sampled = bool((~greedy).any())
    if sampled:
        one = torch.ones_like(sample.temperature)
        scaled = logits / torch.where(greedy, one,
                                      sample.temperature)[:, None]
        # top-k: threshold at the k-th highest score (k <= 0 keeps all)
        srt = torch.sort(scaled, dim=-1, descending=True).values
        k_eff = torch.where(sample.top_k <= 0,
                            torch.full_like(sample.top_k, vocab),
                            sample.top_k).clamp(1, vocab)
        kth = torch.gather(srt, 1, (k_eff - 1).long()[:, None])
        neg_inf = torch.tensor(float("-inf"), dtype=logits.dtype,
                               device=logits.device)
        limited = torch.where(scaled < kth, neg_inf, scaled)
        # top-p: smallest prefix of the sorted survivors holding >= p
        # mass; the exclusive cumsum always keeps the top token
        probs = torch.softmax(limited, dim=-1)
        psort = torch.sort(probs, dim=-1, descending=True).values
        csum = torch.cumsum(psort, dim=-1)
        keep = ((csum - psort) < sample.top_p[:, None]).sum(dim=-1)
        thresh = torch.gather(psort, 1, (keep.clamp(min=1) - 1)[:, None])
        limited = torch.where(
            (sample.top_p < 1.0)[:, None] & (probs < thresh), neg_inf,
            limited)
        keys = _threefry.fold_in(sample.key, sample.emitted)
        drawn = _threefry.categorical(keys, limited).to(torch.int32)
        token = torch.where(greedy, argmax_tok, drawn)
    else:
        token = argmax_tok
    logprob = torch.gather(torch.log_softmax(logits, dim=-1), 1,
                           token.long()[:, None])[:, 0]
    return token, logprob


@functools.lru_cache(maxsize=8)
def build_prefill_program(model):
    """The sampling prefill program:
    ``(params, PagedCache, tokens, SampleParams) ->
    (token (B,), logprob (B,), PagedCache)``.

    One chunk of prompt K/V lands in the cache and the *final* live
    position's next token is sampled on device — the host never sees
    chunk logits, so intermediate chunks don't even synchronize.
    ``tokens`` is ``(1, prefill_chunk)``.
    """

    @torch.no_grad()
    def _prefill(params, cache, tokens, sample):
        at = (cache.live - 1).clamp(min=0)
        logits, cache = _apply(model, params, tokens, cache, logits_at=at)
        token, logprob = sample_tokens(logits, sample)
        return token, logprob, cache

    return _prefill


@functools.lru_cache(maxsize=8)
def build_decode_program(model, decode_width: int = 2):
    """The device-resident decode step:
    ``(params, k, v, tables, DecodeState) ->
    (k, v, DecodeState, token (B,), logprob (B,))``.

    One fixed-shape step over every lane: write K/V at each live lane's
    cache position (dead lanes route to the null block), sample the
    next token, and advance the state — sampled tokens feed back as the
    next inputs, lengths/remaining/emitted tick forward, and lanes
    hitting EOS or ``max_tokens`` drop their own ``live`` flag so a
    speculatively enqueued next step is already harmless. ``tables`` is
    re-uploaded by the host only when a block table actually changed.
    The per-step device->host transfer is the ``(B,)`` token and
    logprob vectors — never logits.
    """

    @torch.no_grad()
    def _decode(params, k, v, tables, state):
        B = state.tokens.shape[0]
        tokens = torch.zeros((B, decode_width), dtype=torch.int32,
                             device=state.tokens.device)
        tokens[:, 0] = state.tokens
        live = state.live.clamp(max=1)
        cache = PagedCache(k, v, tables, state.lengths, live)
        logits, cache = _apply(model, params, tokens, cache,
                               logits_at=torch.zeros_like(live))
        sampled, logprob = sample_tokens(logits, state.sample)
        alive = live > 0
        token = torch.where(alive, sampled, state.tokens)
        retired = alive & (((state.eos >= 0) & (token == state.eos))
                           | (state.remaining <= 1))
        new_state = DecodeState(
            tokens=token,
            lengths=state.lengths + live,
            live=torch.where(retired, torch.zeros_like(live), live),
            remaining=state.remaining - live,
            eos=state.eos,
            sample=dataclasses.replace(
                state.sample, emitted=state.sample.emitted + live))
        return cache.k, cache.v, new_state, token, logprob

    return _decode


@functools.lru_cache(maxsize=8)
def build_verify_program(model, spec_tokens: int, decode_width: int = 2):
    """The speculative-decoding verify step:
    ``(params, k, v, tables, DecodeState, draft (B, S), draft_len (B,))
    -> (k, v, DecodeState, pred (B, S+1), logprob (B, S+1),
    n_emit (B,))``.

    One paged forward scores a lane's current input token plus up to
    ``S = spec_tokens`` drafted continuations in a single chunk of
    static width ``S+1``. Per position ``i`` the program recomputes
    exactly the token the plain decoder would have produced there
    (:func:`sample_tokens` under the deterministic ``fold_in(key,
    emitted + i)`` draw — greedy AND seeded sampling), accepts the
    longest drafted prefix matching those tokens, and emits one bonus
    token past it (the correction at the first mismatch, or the free
    extra token when every draft held). Output is therefore equal to
    non-speculative decode's tokens; the draft only decides how many
    steps it took. For that to hold bit for bit on the card, the chunk
    (padded to a multiple of ``decode_width``) runs with the model's
    ``step_width=decode_width``: every position's products at a decode
    step's shapes, which cuBLAS rounds as the decode step does.

    Cache discipline: the forward writes K/V for every chunk position,
    because position ``i``'s logits must attend to drafts ``< i``.
    Rejected positions are then *rolled back* — their slots' original
    contents (snapshotted before the forward) are written back, with
    the restore writes of *committed* positions routed to the null
    block — so the pools end the step exactly as if only the accepted
    tokens had ever been written. A lane with ``draft_len == 0``
    degrades to precisely the plain decode step (accept 0 drafts, emit
    1 token).
    """
    S = int(spec_tokens)
    if S < 1:
        raise ValueError(f"spec_tokens={spec_tokens}: must be >= 1")
    C = S + 1
    pad = -C % decode_width     # pad columns write to the null block

    @torch.no_grad()
    def _verify(params, k, v, tables, state, draft, draft_len):
        dev = state.tokens.device
        block_size = k.shape[2]
        live = state.live.clamp(max=1)
        alive = live > 0
        zero = torch.zeros_like(live)
        # a draft may never reach past the lane's budget: emitting n
        # tokens writes n-1 draft positions, so draft_len is capped at
        # remaining-1 and the chunk never writes beyond the sequence's
        # admitted total (whose blocks the scheduler guarantees)
        dl = torch.minimum(draft_len.clamp(min=0),
                           (state.remaining - 1).clamp(min=0))
        chunk = torch.cat([state.tokens[:, None], draft.to(torch.int32),
                           torch.zeros((draft.shape[0], pad),
                                       dtype=torch.int32, device=dev)],
                          dim=1)
        width = torch.where(alive, 1 + dl, zero)

        # snapshot the chunk's slots BEFORE the forward so rejected
        # writes can be rolled back afterwards. Positions past a lane's
        # table clamp inside the lookup; their restore writes put back
        # the very values just read — a no-op, not corruption.
        positions = state.lengths.long()[:, None] \
            + torch.arange(C, device=dev)[None, :]
        blocks = torch.gather(
            tables.long(), 1,
            (positions // block_size).clamp(max=tables.shape[1] - 1))
        offsets = positions % block_size
        orig_k = k[:, blocks, offsets]
        orig_v = v[:, blocks, offsets]

        cache = PagedCache(k, v, tables, state.lengths, width)
        logits, cache = _apply(model, params, chunk, cache,
                               step_width=decode_width)

        # per-position resample: position i's draw is the plain
        # decoder's emission `emitted + i` — same ops, same fold_in,
        # same logprob, so acceptance == equality with plain decode
        preds, logps = [], []
        for i in range(C):
            t_i, lp_i = sample_tokens(
                logits[:, i],
                dataclasses.replace(state.sample,
                                    emitted=state.sample.emitted + i))
            preds.append(t_i)
            logps.append(lp_i)
        pred = torch.stack(preds, dim=1)
        logp = torch.stack(logps, dim=1)

        # longest accepted prefix: draft[i] must equal what the plain
        # decoder produced at position i, for every earlier i too
        ar = torch.arange(S, device=dev)[None, :]
        match = (pred[:, :S] == draft) & (ar < dl[:, None])
        accept = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
        # the plain decoder stops at its first EOS: clip the emission
        # to one past the first predicted EOS, and to the budget
        is_eos = (state.eos[:, None] >= 0) & (pred == state.eos[:, None])
        no_eos = torch.cumprod(1 - is_eos.to(torch.int32), dim=1)
        lead = no_eos.sum(dim=1)                 # positions before 1st EOS
        eos_limit = torch.where(lead < C, lead + 1,
                                torch.full_like(lead, C + 1))
        n_emit = torch.minimum(accept + 1,
                               torch.minimum(eos_limit, state.remaining))
        n_emit = torch.where(alive, n_emit, torch.zeros_like(n_emit)) \
            .to(torch.int32)

        # roll back rejected slots: restore originals everywhere except
        # the committed prefix, whose restore writes go to block 0
        committed = torch.arange(C, device=dev)[None, :] < n_emit[:, None]
        rb = torch.where(committed, torch.zeros_like(blocks), blocks)
        cache.k[:, rb, offsets] = orig_k
        cache.v[:, rb, offsets] = orig_v

        retired = alive & ((lead < n_emit) | (state.remaining <= n_emit))
        last = torch.gather(pred, 1,
                            (n_emit - 1).clamp(min=0).long()[:, None])[:, 0]
        token = torch.where(alive & (n_emit > 0), last, state.tokens)
        new_state = DecodeState(
            tokens=token,
            lengths=state.lengths + n_emit,
            live=torch.where(retired, zero, live),
            remaining=state.remaining - n_emit,
            eos=state.eos,
            sample=dataclasses.replace(
                state.sample, emitted=state.sample.emitted + n_emit))
        return cache.k, cache.v, new_state, pred, logp, n_emit

    return _verify


@functools.lru_cache(maxsize=8)
def build_beam_program(model, beam_k: int, decode_width: int = 2):
    """The beam-search step:
    ``(params, k, v, tables, tokens (B,), lengths (B,), live (B,)) ->
    (k, v, top_tok (B, beam_k), top_lp (B, beam_k))``.

    The decode program's forward — identical chunk shape, identical
    K/V write path — returning the ``beam_k`` highest-logprob
    continuations per lane instead of one sampled token, so the host
    can run hypothesis selection. ``top_lp`` is the full-distribution
    ``log_softmax`` value (the same quantity :func:`sample_tokens`
    reports); a stable descending sort breaks ties toward the lowest
    index exactly like ``argmax`` (as ``lax.top_k`` does), which is why
    a width-1 beam equals plain greedy decode, logprobs included."""
    K = int(beam_k)
    if K < 1:
        raise ValueError(f"beam_k={beam_k}: must be >= 1")

    @torch.no_grad()
    def _beam_step(params, k, v, tables, tokens, lengths, live):
        B = tokens.shape[0]
        chunk = torch.zeros((B, decode_width), dtype=torch.int32,
                            device=tokens.device)
        chunk[:, 0] = tokens
        live = live.clamp(max=1)
        cache = PagedCache(k, v, tables, lengths, live)
        logits, cache = _apply(model, params, chunk, cache,
                               logits_at=torch.zeros_like(live))
        lp = torch.log_softmax(logits, dim=-1)
        top_lp, top_tok = torch.sort(lp, dim=-1, descending=True,
                                     stable=True)
        return (cache.k, cache.v, top_tok[:, :K].to(torch.int32),
                top_lp[:, :K])

    return _beam_step
