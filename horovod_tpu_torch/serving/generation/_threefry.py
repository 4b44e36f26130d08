"""Threefry-2x32 counter-based random numbers in torch, bit for bit as
JAX draws them, so that a seeded generation samples the same tokens in
both packages (and replays them after a preemption within the port).

The JAX package's sampler draws with ``jax.vmap(jax.random.fold_in)``
and ``jax.random.categorical`` over a ``(2,)`` uint32 threefry key
(``horovod_tpu/serving/generation/kv_cache.py:606-607``). This module is
the same arithmetic, held to JAX 0.9.0 with ``jax_threefry_partitionable``
on (its default):

* :func:`threefry2x32`: the 20-round hash (``jax/_src/prng.py``,
  ``_threefry2x32_lowering``);
* :func:`fold_in`: ``threefry_2x32(key, threefry_seed(data))``, the seed
  of a uint32 ``data`` being ``(0, data)`` (``threefry_fold_in``);
* :func:`random_bits`: 32-bit draws over a shape, each element hashing
  its flat index split into (high, low) words, the two outputs xor-ed
  (``_threefry_random_bits_partitionable``);
* :func:`uniform`: the top 23 bits as the mantissa of a float32 in
  [1, 2), minus 1, scaled into [minval, maxval) (``random._uniform``);
* :func:`gumbel` ("low" mode, ``-log(-log(u))`` with u from
  ``uniform(tiny, 1)``) and :func:`categorical` (argmax of gumbel noise
  plus logits, ``random.categorical``).

torch has no full unsigned 32-bit arithmetic, so every word is held in
an int64 tensor and masked to 32 bits after each addition and shift.
Keys are int64 tensors of shape ``(..., 2)`` holding uint32 values.
"""

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of the counter words ``(x1, x2)`` under the
    key words ``(k1, k2)`` (int64 tensors of uint32 values, broadcast
    together); returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def seed_key(seed: int, device=None) -> torch.Tensor:
    """The (2,) key of ``jax.random.PRNGKey(seed)``: the seed's 64 bits
    as (high word, low word)."""
    s = int(seed) % (1 << 64)
    return torch.tensor([s >> 32, s & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(key, data):
    """``jax.random.fold_in`` over a batch: ``key`` (..., 2), ``data``
    (...) non-negative integers below 2**32; returns the (..., 2) keys."""
    data = data.to(torch.int64) & _MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key, n: int):
    """32-bit random words ``(B, n)`` for each of the ``(B, 2)`` keys, as
    ``jax.random.bits(key, (n,), uint32)`` draws them per row (n below
    2**32, so each index's high word is 0)."""
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[:, 0:1], key[:, 1:2],
                          torch.zeros_like(counts), counts)
    return b1 ^ b2


def uniform(key, n: int, minval: float, maxval: float):
    """float32 draws ``(B, n)`` in [minval, maxval), as
    ``jax.random.uniform(key, (n,), float32, minval, maxval)`` per row."""
    bits = random_bits(key, n)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key, n: int):
    """Standard Gumbel draws ``(B, n)`` float32, JAX's "low" mode."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, n, tiny, 1.0)))


def categorical(key, logits):
    """One draw per row of ``(B, vocab)`` float32 ``logits`` under the
    row's key: ``jax.vmap(jax.random.categorical)(keys, logits)``."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)
