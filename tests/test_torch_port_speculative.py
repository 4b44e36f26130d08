"""Speculative and beam decode of the port, held to plain decode and to
the JAX package (2 layers, d_model 32, 2 x 16 heads, vocab 97, blocks of
4, float32 on both sides):

* ``NGramProposer`` drafts and ``make_proposer``'s dispatch equal the
  JAX module's (host logic);
* the verify program against the JAX verify program: predictions,
  accept counts and the advanced state equal, logprobs at 1e-5, and the
  pools rolled back to exactly the accepted writes;
* an engine with ``spec_mode="ngram"`` (and ``"draft"``) emits exactly
  plain decode's tokens, greedy and seeded, logprobs at 1e-5 of them
  (equal within the port), and the JAX spec engine's;
* ``num_beams=1`` equals greedy, logprobs included; wider beams equal
  the JAX engine's choice.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu.serving.generation import kv_cache as jkv
from horovod_tpu.serving.generation import spec as jspec
from horovod_tpu_torch import faults as tfaults
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch.serving.generation import kv_cache as tkv
from horovod_tpu_torch.serving.generation import spec as tspec

from torch_port_gen_common import (JCFG, TCFG, VOCAB, jax_engine, models,
                                   port_engine, prompts, run_all)

TOL = 1e-5


def _contexts():
    rng = np.random.RandomState(0)
    out = [[1, 2, 3, 1, 2, 3, 1, 2], [5, 6, 7, 8], [4, 4, 4, 4, 4],
           [9, 1, 9, 2, 9, 1, 9]]
    for _ in range(12):
        base = rng.randint(0, 6, (rng.randint(2, 20),)).tolist()
        out.append(base + base[:rng.randint(0, len(base))])
    return out


@pytest.mark.parametrize("ngram", [(3, 1), (2, 2), (4, 1)])
@pytest.mark.parametrize("cap", [0, 1, 3, 5])
def test_ngram_drafts_match_jax(ngram, cap):
    j = jspec.NGramProposer(*ngram)
    t = tspec.NGramProposer(*ngram)
    for ctx in _contexts():
        assert t.propose(ctx, cap) == j.propose(ctx, cap)


@pytest.mark.parametrize("mode", ["off", "", "none", "ngram", "bogus",
                                  "draft"])
def test_make_proposer_dispatch_matches_jax(mode):
    def outcome(mod):
        try:
            p = mod.make_proposer(mode)
        except ValueError as e:
            return f"ValueError: {e}"
        return type(p).__name__
    assert outcome(tspec) == outcome(jspec)


def test_ngram_rejects_bad_sizes():
    with pytest.raises(ValueError):
        tspec.NGramProposer(0)
    with pytest.raises(ValueError):
        tspec.NGramProposer(1, 2)


def _verify_case(mod, S, draft, dlen, temp):
    """One verify step over 3 lanes (one dead) after a prefill of each
    live lane; returns every output as numpy."""
    jmodel, variables, tmodel, tparams = models()
    B = 3
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    lengths = np.array([6, 9, 0], np.int32)
    live = np.array([1, 1, 0], np.int32)
    start = np.array([11, 12, 0], np.int32)
    remaining = np.array([8, 3, 1], np.int32)
    eos = np.array([-1, 40, -1], np.int32)
    temps = np.array([0.0, temp, 0.0], np.float32)
    keys = np.array([[0, 3], [0, 4], [0, 5]], np.int64)
    if mod is jkv:
        k, v = jkv.make_pools(JCFG, 12, 4)
        for lane in (0, 1):
            buf = np.zeros((1, 16), np.int32)
            buf[0, :lengths[lane]] = prompts(50 + lane, [lengths[lane]])[0]
            c = jkv.PagedCache(k, v, jnp.asarray(tables[lane:lane + 1]),
                               jnp.zeros((1,), jnp.int32),
                               jnp.asarray(lengths[lane:lane + 1]))
            _, c = jkv.build_program(jmodel)(variables, c, jnp.asarray(buf))
            k, v = c.k, c.v
        st = jkv.DecodeState(
            jnp.asarray(start), jnp.asarray(lengths), jnp.asarray(live),
            jnp.asarray(remaining), jnp.asarray(eos),
            jkv.SampleParams(jnp.asarray(temps),
                             jnp.zeros((B,), jnp.int32),
                             jnp.ones((B,), jnp.float32),
                             jnp.asarray(keys.astype(np.uint32)),
                             jnp.asarray([2, 0, 0], jnp.int32)))
        k, v, st, pred, logp, n = jkv.build_verify_program(jmodel, S)(
            variables, k, v, jnp.asarray(tables), st, jnp.asarray(draft),
            jnp.asarray(dlen))
        return [np.asarray(x) for x in (k, v, st.tokens, st.lengths,
                                        st.live, st.remaining,
                                        st.sample.emitted, pred, logp, n)]
    k, v = tkv.make_pools(TCFG, 12, 4, device="cpu")
    for lane in (0, 1):
        buf = np.zeros((1, 16), np.int32)
        buf[0, :lengths[lane]] = prompts(50 + lane, [lengths[lane]])[0]
        c = tkv.PagedCache(k, v, torch.from_numpy(tables[lane:lane + 1]),
                           torch.zeros(1, dtype=torch.int32),
                           torch.from_numpy(lengths[lane:lane + 1]))
        tkv.build_program(tmodel)(tparams, c, torch.from_numpy(buf))
    T = torch.from_numpy
    st = tkv.DecodeState(
        T(start), T(lengths), T(live), T(remaining), T(eos),
        tkv.SampleParams(T(temps), torch.zeros(B, dtype=torch.int32),
                         torch.ones(B), T(keys),
                         torch.tensor([2, 0, 0], dtype=torch.int32)))
    k, v, st, pred, logp, n = tkv.build_verify_program(tmodel, S)(
        tparams, k, v, T(tables), st, T(draft), T(dlen))
    return [x.numpy() for x in (k, v, st.tokens, st.lengths, st.live,
                                st.remaining, st.sample.emitted, pred, logp,
                                n)]


@pytest.mark.parametrize("temp", [0.0, 0.9])
@pytest.mark.parametrize("S", [1, 3])
def test_verify_program_matches_jax(S, temp):
    draft = np.random.RandomState(S).randint(0, VOCAB, (3, S)).astype(
        np.int32)
    dlen = np.array([S, S, 0], np.int32)
    j = _verify_case(jkv, S, draft, dlen, temp)
    t = _verify_case(tkv, S, draft, dlen, temp)
    for a, b in zip(t[2:8], j[2:8]):
        assert a.tolist() == b.tolist()
    assert t[9].tolist() == j[9].tolist()
    np.testing.assert_allclose(t[8][:2], j[8][:2], atol=TOL)
    # pools: every written slot outside the null block agrees
    np.testing.assert_allclose(t[0][:, 1:], j[0][:, 1:], atol=TOL)
    np.testing.assert_allclose(t[1][:, 1:], j[1][:, 1:], atol=TOL)


def test_verify_accepting_the_plain_tokens_emits_them_all():
    """A draft equal to what plain decode predicts is accepted whole."""
    S = 3
    draft = np.zeros((3, S), np.int32)
    first = _verify_case(tkv, S, draft, np.array([0, 0, 0], np.int32), 0.0)
    # lane 0's plain next tokens, found one verify step at a time
    want = [int(first[7][0, 0])]
    toks = _verify_case(tkv, S, np.array([want + [0, 0]] * 3, np.int32),
                        np.array([1, 0, 0], np.int32), 0.0)
    assert int(toks[9][0]) == 2 and toks[7][0, 0] == want[0]


PROMPTS = prompts(60, [7, 12, 5]) + [[3, 4, 5, 3, 4, 5, 3, 4], [9] * 6]


@pytest.fixture(scope="module")
def plain_and_jax():
    reqs = [dict(prompt=p, max_tokens=14) for p in PROMPTS]
    seeded = [dict(prompt=p, max_tokens=10, temperature=0.9, seed=i)
              for i, p in enumerate(PROMPTS[:3])]
    with port_engine() as eng:
        plain = run_all(eng, reqs)
        plain_seeded = run_all(eng, seeded)
    with jax_engine(spec_mode="ngram", spec_tokens=3) as eng:
        jspec_out = run_all(eng, reqs)
    return reqs, seeded, plain, plain_seeded, jspec_out


@pytest.mark.parametrize("spec_tokens", [1, 3])
def test_ngram_spec_equals_plain_decode(plain_and_jax, spec_tokens):
    reqs, seeded, plain, plain_seeded, jspec_out = plain_and_jax
    acc = "hvd_tpu_gen_spec_accepted_total"
    before = tmetrics.snapshot().get(acc, 0)
    with port_engine(spec_mode="ngram", spec_tokens=spec_tokens) as eng:
        assert eng.spec_mode == "ngram"
        got = run_all(eng, reqs)
        got_seeded = run_all(eng, seeded)
        assert eng.allocator.in_use == 0
    assert tmetrics.snapshot().get(acc, 0) > before
    assert [t for t, _ in got] == [t for t, _ in plain]
    assert [t for t, _ in got_seeded] == [t for t, _ in plain_seeded]
    for (_, a), (_, b) in zip(got + got_seeded, plain + plain_seeded):
        np.testing.assert_allclose(a, b, atol=TOL)
    if spec_tokens == 3:
        assert [t for t, _ in got] == [t for t, _ in jspec_out]
        for (_, a), (_, b) in zip(got, jspec_out):
            np.testing.assert_allclose(a, b, atol=TOL)


def test_eos_inside_the_verify_window_stops_exactly(plain_and_jax):
    reqs, _, plain, _, _ = plain_and_jax
    toks = plain[3][0]
    eos = toks[4]
    with port_engine(spec_mode="ngram", spec_tokens=3) as eng:
        out = eng.generate(reqs[3]["prompt"], max_tokens=14, eos_id=eos,
                           timeout=30)
    assert out == toks[:toks.index(eos) + 1]


def test_verify_fault_fails_the_batch_and_recovers():
    tfaults.configure("serving.verify:error:once", seed=0)
    try:
        with port_engine(spec_mode="ngram") as eng:
            s = eng.submit(PROMPTS[0], max_tokens=5)
            with pytest.raises(Exception, match="injected"):
                eng.result(s, timeout=30)
            assert len(eng.generate(PROMPTS[0], max_tokens=5,
                                    timeout=30)) == 5
    finally:
        tfaults.configure("", seed=0)


def test_draft_model_spec_equals_plain_decode(plain_and_jax):
    """The draft is the target model itself (so drafts are mostly
    accepted); the output is plain decode's either way."""
    reqs, _, plain, _, _ = plain_and_jax
    _, _, tmodel, tparams = models()
    with port_engine(spec_mode="draft", spec_tokens=2, draft_model=tmodel,
                     draft_params=tparams) as eng:
        got = run_all(eng, reqs[:3])
    assert [t for t, _ in got] == [t for t, _ in plain[:3]]


@pytest.fixture(scope="module")
def jax_beams():
    reqs = [dict(prompt=p, max_tokens=8, num_beams=w)
            for p in PROMPTS[:3] for w in (1, 2, 3)]
    with jax_engine(max_beams=3) as eng:
        return reqs, run_all(eng, reqs)


def test_beam_width_one_equals_greedy(plain_and_jax):
    reqs, _, _, _, _ = plain_and_jax
    with port_engine(max_beams=2) as eng:
        greedy = run_all(eng, [dict(r, max_tokens=8) for r in reqs])
        beam = run_all(eng, [dict(r, max_tokens=8, num_beams=1)
                             for r in reqs])
    assert beam == greedy          # tokens and logprobs, exactly


def test_beams_match_jax(jax_beams):
    reqs, want = jax_beams
    with port_engine(max_beams=3) as eng:
        got = run_all(eng, reqs)
        assert eng.allocator.in_use == 0
    for (t, lp), (jt, jlp) in zip(got, want):
        assert t == jt
        np.testing.assert_allclose(lp, jlp, atol=TOL)


def test_beam_program_top_k_matches_jax():
    jmodel, variables, tmodel, tparams = models()
    tables = np.array([[1, 2], [3, 4]], np.int32)
    tokens = np.array([5, 6], np.int32)
    lengths = np.array([0, 0], np.int32)
    live = np.array([1, 1], np.int32)
    jk, jv = jkv.make_pools(JCFG, 6, 4)
    _, _, jt, jl = jkv.build_beam_program(jmodel, 4, 2)(
        variables, jk, jv, jnp.asarray(tables), jnp.asarray(tokens),
        jnp.asarray(lengths), jnp.asarray(live))
    tk, tv = tkv.make_pools(TCFG, 6, 4, device="cpu")
    T = torch.from_numpy
    _, _, tt, tl = tkv.build_beam_program(tmodel, 4, 2)(
        tparams, tk, tv, T(tables), T(tokens), T(lengths), T(live))
    assert tt.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)
    with pytest.raises(ValueError):
        tkv.build_beam_program(tmodel, 0)
    with pytest.raises(ValueError):
        tkv.build_verify_program(tmodel, 0)
