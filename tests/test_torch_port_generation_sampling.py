"""Seeded sampling of the port held to the JAX package's: threefry keys
and bits bit for bit against the installed ``jax.random``
(``jax_threefry_partitionable`` on, its default), the float32 uniforms
bit for bit, Gumbel noise within 4e-6 (``log`` is not bit-identical
between XLA and torch), and the sampled tokens equal JAX's on the same
float32 logits, through ``sample_tokens`` and through the engines: same
seed, same tokens, in both packages, across runs and across a
preemption replay. Logprobs at 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from horovod_tpu.serving.generation import kv_cache as jkv
from horovod_tpu.serving.generation import scheduler as jsched
from horovod_tpu_torch.serving.generation import _threefry as tf
from horovod_tpu_torch.serving.generation import kv_cache as tkv
from horovod_tpu_torch.serving.generation import scheduler as tsched

from torch_port_gen_common import (jax_engine, port_engine, prompts,
                                   run_all)

TOL = 1e-5
KEYS = np.array([[0, 0], [0, 1], [1, 2], [0xDEADBEEF, 0x12345678],
                 [0xFFFFFFFF, 0xFFFFFFFF], [7, 0x80000000]], np.uint32)


def _tkeys(keys):
    return torch.from_numpy(np.asarray(keys).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 + 3, 2 ** 40 + 7,
                                  2 ** 64 - 1])
def test_seed_key_matches_the_scheduler_key(seed):
    """The engines' per-request key (``scheduler._seed_key``) and
    ``_threefry.seed_key`` give the JAX package's words."""
    want = jsched._seed_key(seed).astype(np.int64)
    assert tsched._seed_key(seed).tolist() == want.tolist()
    assert tf.seed_key(seed).tolist() == want.tolist()
    if seed < 2 ** 31:
        assert want.tolist() == np.asarray(
            jax.random.PRNGKey(seed)).astype(np.int64).tolist()


@pytest.mark.parametrize("ordinals", [[0, 0, 0, 0, 0, 0],
                                      [1, 5, 7, 123456, 2 ** 31 - 1, 64]])
def test_fold_in_bit_exact(ordinals):
    em = np.asarray(ordinals, np.int32)
    want = np.asarray(jax.vmap(jax.random.fold_in)(jnp.asarray(KEYS),
                                                   jnp.asarray(em)))
    got = tf.fold_in(_tkeys(KEYS), torch.from_numpy(em))
    assert got.tolist() == want.astype(np.int64).tolist()


@pytest.mark.parametrize("n", [1, 2, 97, 1000, 32000])
def test_random_bits_bit_exact(n):
    """Including the (B, 32000) draw of the default vocabulary."""
    want = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (n,), jnp.uint32))(jnp.asarray(KEYS)))
    got = tf.random_bits(_tkeys(KEYS), n)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("n", [97, 32000])
def test_uniform_bit_exact(n):
    tiny = float(np.finfo(np.float32).tiny)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (n,), jnp.float32, minval=tiny, maxval=1.0))(jnp.asarray(KEYS)))
    got = tf.uniform(_tkeys(KEYS), n, tiny, 1.0).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_threefry_hash_against_jax_prng():
    """The raw hash against ``jax._src.prng.threefry_2x32`` on a counter
    array."""
    from jax._src import prng
    counts = np.arange(10, dtype=np.uint32) * 977
    for key in KEYS:
        want = np.asarray(prng.threefry_2x32(jnp.asarray(key),
                                             jnp.asarray(counts)))
        x1, x2 = np.split(counts.astype(np.int64), 2)
        y1, y2 = tf.threefry2x32(torch.tensor(int(key[0])),
                                 torch.tensor(int(key[1])),
                                 torch.from_numpy(x1), torch.from_numpy(x2))
        assert torch.cat([y1, y2]).tolist() == want.astype(np.int64).tolist()


def test_gumbel_within_tolerance():
    """Absolute 4e-6 (the noise runs about -2.5 to 17; XLA's and torch's
    float32 ``log`` differ in the last bit)."""
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (32000,), jnp.float32))(jnp.asarray(KEYS)))
    got = tf.gumbel(_tkeys(KEYS), 32000).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-6)


@pytest.mark.parametrize("vocab", [97, 32000])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_categorical_matches_jax(vocab, seed):
    logits = np.random.RandomState(seed).randn(len(KEYS), vocab) \
        .astype(np.float32) * 3
    want = np.asarray(jax.vmap(jax.random.categorical)(jnp.asarray(KEYS),
                                                       jnp.asarray(logits)))
    got = tf.categorical(_tkeys(KEYS), torch.from_numpy(logits))
    assert got.tolist() == want.tolist()


def _params(mod, B, temp, top_k, top_p, emitted, rng):
    keys = rng.randint(0, 2 ** 32, (B, 2), dtype=np.uint64).astype(np.uint32)
    t = np.where(np.arange(B) % 3 == 0, 0.0, temp).astype(np.float32)
    if mod is jkv:
        return jkv.SampleParams(
            temperature=jnp.asarray(t),
            top_k=jnp.full((B,), top_k, jnp.int32),
            top_p=jnp.full((B,), top_p, jnp.float32),
            key=jnp.asarray(keys), emitted=jnp.asarray(emitted, jnp.int32))
    return tkv.SampleParams(
        temperature=torch.from_numpy(t),
        top_k=torch.full((B,), top_k, dtype=torch.int32),
        top_p=torch.full((B,), top_p), key=_tkeys(keys),
        emitted=torch.tensor(emitted, dtype=torch.int32))


@pytest.mark.parametrize("temp,top_k,top_p", [
    (1.0, 0, 1.0), (0.8, 50, 0.95), (0.7, 5, 1.0), (1.3, 0, 0.5),
    (0.0, 0, 1.0)])
@pytest.mark.parametrize("vocab", [97, 32000])
def test_sample_tokens_match_jax(temp, top_k, top_p, vocab):
    """Every third lane greedy; the rest drawn. Tokens equal, logprobs at
    1e-5."""
    rng = np.random.RandomState(vocab + int(temp * 10) + top_k)
    B = 6
    logits = (rng.randn(B, vocab) * 2).astype(np.float32)
    emitted = rng.randint(0, 500, (B,)).tolist()
    jt, jl = jkv.sample_tokens(
        jnp.asarray(logits),
        _params(jkv, B, temp, top_k, top_p, emitted,
                np.random.RandomState(9)))
    tt, tl = tkv.sample_tokens(
        torch.from_numpy(logits),
        _params(tkv, B, temp, top_k, top_p, emitted,
                np.random.RandomState(9)))
    assert tt.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)


def test_sampled_flag_skips_nothing_a_lane_needs():
    """``sampled`` given on the host or read off the tensor: same draw."""
    rng = np.random.RandomState(3)
    logits = torch.from_numpy(rng.randn(6, 97).astype(np.float32))
    sp = _params(tkv, 6, 0.9, 10, 0.9, [1] * 6, np.random.RandomState(1))
    import dataclasses
    a = tkv.sample_tokens(logits, sp)
    b = tkv.sample_tokens(logits, dataclasses.replace(sp, sampled=True))
    assert a[0].tolist() == b[0].tolist()
    greedy = dataclasses.replace(sp, temperature=torch.zeros(6),
                                 sampled=False)
    assert tkv.sample_tokens(logits, greedy)[0].tolist() == \
        logits.argmax(-1).tolist()


SEEDED = [dict(prompt=p, max_tokens=12, temperature=0.8, top_k=50,
               top_p=0.95, seed=s)
          for s, p in enumerate(prompts(30, [5, 9, 14, 3, 7, 11, 6, 4]))]


@pytest.fixture(scope="module")
def jax_seeded():
    with jax_engine() as eng:
        return run_all(eng, SEEDED)


def test_seeded_generations_match_jax_and_repeat(jax_seeded):
    with port_engine() as eng:
        first = run_all(eng, SEEDED)
        second = run_all(eng, SEEDED)
    assert [t for t, _ in first] == [t for t, _ in second]
    assert [t for t, _ in first] == [t for t, _ in jax_seeded]
    for (_, lp), (_, jlp) in zip(first, jax_seeded):
        assert np.isfinite(lp).all()
        np.testing.assert_allclose(lp, jlp, atol=TOL)


def test_seeded_generation_survives_preemption(jax_seeded):
    """A pool small enough to preempt replays the same draws."""
    from horovod_tpu_torch import metrics as tmetrics
    key = "hvd_tpu_gen_preemptions_total"
    before = tmetrics.snapshot().get(key, 0)
    with port_engine(num_blocks=14) as eng:
        got = run_all(eng, SEEDED)
    assert tmetrics.snapshot().get(key, 0) > before
    assert [t for t, _ in got] == [t for t, _ in jax_seeded]


def test_sample_offset_resumes_the_stream(jax_seeded):
    """prompt + emitted with sample_offset continues the seeded stream
    bit for bit (the failover resume contract)."""
    req, (toks, _) = SEEDED[2], jax_seeded[2]
    with port_engine() as eng:
        tail = eng.result(eng.submit(
            prompt=req["prompt"] + toks[:5], max_tokens=7,
            temperature=0.8, top_k=50, top_p=0.95, seed=req["seed"],
            sample_offset=5), timeout=30)
    assert tail == toks[5:]
