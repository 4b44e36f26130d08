"""The generation plane of the port held to the JAX package's, on the
same numpy-seeded inputs and carried-over parameters (2 layers, d_model
32, 2 x 16 heads, vocab 97, blocks of 4, float32 on both sides):

* ``BlockAllocator`` and ``chain_hash`` bit for bit over a scripted
  alloc/free/share/match/register sequence;
* the paged incremental forward (``build_program``) against the JAX
  paged program at 1e-5, logits and pools, and against the port's own
  full-sequence forward at 1e-5;
* the prefill and decode programs' tokens equal JAX's, logprobs at 1e-5;
* ``ContinuousBatcher`` greedy generations (through ``GenerationEngine``)
  equal to the JAX engine's: chunked prefill, EOS, preemption, prefix
  reuse, both async depths; logprobs at 1e-5;
* the scheduler's lifecycle as the JAX one behaves: admission errors,
  queue full, deadlines, cancel, stop, stream, KV export/import, hot
  reload, the serving fault sites.

The JAX references are computed once per module (each JAX engine shape
compiles its programs once).
"""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from horovod_tpu import faults as jfaults
from horovod_tpu.models.transformer import PagedCache as JPagedCache
from horovod_tpu.serving.generation import kv_cache as jkv
from horovod_tpu_torch import faults as tfaults
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch.models.transformer import PagedCache
from horovod_tpu_torch.serving import DeadlineExceededError, QueueFullError
from horovod_tpu_torch.serving.generation import kv_cache as tkv
from horovod_tpu_torch.serving.generation.scheduler import (
    DECODE_WIDTH, RequestCancelledError)

from torch_port_gen_common import (JCFG, TCFG, VOCAB, jax_engine, models,
                                   port_engine, prompts, run_all)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_faults():
    yield
    tfaults.configure("", seed=0)
    jfaults.configure("", seed=0)


# ---------------------------------------------------------------------------
# BlockAllocator and chain_hash: host logic, bit for bit
# ---------------------------------------------------------------------------

def _script(mod, prefix_cache):
    """A scripted alloc/free/share/match/register sequence; every
    observable after every step."""
    a = mod.BlockAllocator(num_blocks=9, block_size=4,
                           prefix_cache=prefix_cache)
    h = []
    parent = None
    for j in range(4):
        parent = mod.chain_hash(parent, list(range(4 * j, 4 * j + 4)))
        h.append(parent)
    log = []

    def obs(tag, value=None):
        log.append((tag, value, a.stats(), a.in_use, a.free_blocks,
                    a.cached_blocks, a.available_blocks, a.peak_in_use,
                    a.cache_gen, a.remote_blocks))

    def attempt(tag, fn):
        try:
            obs(tag, fn())
        except (ValueError, mod.BlocksExhaustedError) as e:
            obs(tag, f"{type(e).__name__}: {e}")

    x = a.allocate(3)
    obs("alloc3", x)
    for b, hh in zip(x, h):
        a.register(b, hh)
    obs("registered")
    y = a.allocate(2)
    obs("alloc2", y)
    a.share(x[:2])
    obs("share", [a.refcount(b) for b in x])
    a.free(x)
    obs("free_x", [a.refcount(b) for b in x])
    a.free(x[:2])
    obs("free_shared")
    obs("probe", a.match_probe(h))
    m = a.match(h)
    obs("match", m)
    attempt("alloc_too_many", lambda: a.allocate(9))
    a.free(m)
    obs("free_m")
    z = a.allocate(4)
    obs("alloc4_evicts", z)
    attempt("double_free", lambda: a.free([z[0], z[0]]))
    attempt("null_free", lambda: a.free([0]))
    attempt("foreign_share", lambda: a.share(
        [b for b in range(1, 9) if b not in z + y][:1]))
    a.register(z[0], "remote-hash", remote=True)
    obs("remote", a.is_remote(z[0]))
    a.free(z + y)
    obs("free_all")
    a.reset_cache()
    obs("reset")
    obs("blocks_for", [a.blocks_for(n) for n in (0, 1, 4, 5, 17)])
    return log


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_block_allocator_script_matches_jax(prefix_cache):
    assert _script(tkv, prefix_cache) == _script(jkv, prefix_cache)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_hash_matches_jax(seed):
    rng = np.random.RandomState(seed)
    parent_j = parent_t = None
    for _ in range(6):
        toks = rng.randint(0, 50000, (16,)).tolist()
        parent_j = jkv.chain_hash(parent_j, toks)
        parent_t = tkv.chain_hash(parent_t, np.asarray(toks, np.int64))
        assert parent_t == parent_j


def test_allocator_rejects_bad_sizes_as_jax():
    for args in ((1, 4), (4, 0)):
        with pytest.raises(ValueError) as je:
            jkv.BlockAllocator(*args, prefix_cache=True)
        with pytest.raises(ValueError) as te:
            tkv.BlockAllocator(*args, prefix_cache=True)
        assert str(te.value) == str(je.value)


def test_block_gauges_published():
    a = tkv.BlockAllocator(num_blocks=9, block_size=4, prefix_cache=True)
    got = a.allocate(3)
    snap = tmetrics.snapshot()
    assert snap["hvd_tpu_gen_kv_blocks_in_use"] == 3
    assert snap['hvd_tpu_gen_kv_blocks{state="private"}'] == 3
    a.free(got)
    assert tmetrics.snapshot()["hvd_tpu_gen_kv_blocks_in_use"] == 0


# ---------------------------------------------------------------------------
# the paged forward
# ---------------------------------------------------------------------------

def _paged_chunks(seed=7):
    """The chunk plan of the JAX package's paged-parity pin: a 16-token
    sequence, 12 prompt tokens in chunks of 8 (the tail padded), then 4
    single-token decode steps at DECODE_WIDTH."""
    toks = np.asarray(prompts(seed, [16])[0], np.int32)
    table = np.zeros((1, 16), np.int32)
    table[0, :4] = [1, 2, 3, 4]
    plan = []
    for start, chunk in ((0, toks[:8]), (8, toks[8:12])):
        buf = np.zeros((1, 8), np.int32)
        buf[0, :len(chunk)] = chunk
        plan.append((buf, start, len(chunk)))
    for i in range(12, 16):
        buf = np.zeros((1, DECODE_WIDTH), np.int32)
        buf[0, 0] = toks[i]
        plan.append((buf, i, 1))
    return toks, table, plan


@pytest.fixture(scope="module")
def paged_runs():
    """The chunk plan through both packages' raw paged program."""
    jmodel, variables, tmodel, tparams = models()
    toks, table, plan = _paged_chunks()
    jprog, tprog = jkv.build_program(jmodel), tkv.build_program(tmodel)
    jk, jv = jkv.make_pools(JCFG, num_blocks=17, block_size=4)
    tk, tv = tkv.make_pools(TCFG, num_blocks=17, block_size=4,
                            device="cpu")
    jout, tout = [], []
    for buf, start, live in plan:
        jc = JPagedCache(jk, jv, jnp.asarray(table),
                         jnp.asarray([start], jnp.int32),
                         jnp.asarray([live], jnp.int32))
        jl, jc = jprog(variables, jc, jnp.asarray(buf))
        jk, jv = jc.k, jc.v
        jout.append(np.asarray(jl)[0, :live])
        tc = PagedCache(tk, tv, torch.from_numpy(table),
                        torch.tensor([start], dtype=torch.int32),
                        torch.tensor([live], dtype=torch.int32))
        tl, tc = tprog(tparams, tc, torch.from_numpy(buf))
        assert tc.k is tk and tc.v is tv          # written in place
        tout.append(tl.numpy()[0, :live])
    return toks, jout, tout, (np.asarray(jk), np.asarray(jv)), \
        (tk.numpy(), tv.numpy())


def test_paged_logits_match_jax_paged_program(paged_runs):
    """Tolerance 1e-5 (float32 both sides)."""
    _, jout, tout, _, _ = paged_runs
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t, j, rtol=0, atol=TOL)


def test_paged_pools_match_jax(paged_runs):
    """The K/V written through the block tables, pad tokens in block 0
    excluded (both packages send them there, in no fixed order)."""
    _, _, _, (jk, jv), (tk, tv) = paged_runs
    np.testing.assert_allclose(tk[:, 1:], jk[:, 1:], rtol=0, atol=TOL)
    np.testing.assert_allclose(tv[:, 1:], jv[:, 1:], rtol=0, atol=TOL)
    assert np.abs(tk[:, 5:]).max() == 0


def test_paged_logits_match_port_full_forward(paged_runs):
    """The chunked paged path against the port's own full-sequence
    forward at the same positions, within 1e-5 (the JAX package's
    bit-for-bit pin of this, TestPagedParity, does not hold either)."""
    _, _, tmodel, tparams = models()
    toks, _, tout, _, _ = paged_runs
    with torch.no_grad():
        full = torch.func.functional_call(
            tmodel, tparams, (torch.from_numpy(toks[None]).long(),)).numpy()
    got = np.concatenate(tout, axis=0)
    np.testing.assert_allclose(got, full[0], rtol=0, atol=TOL)


def test_logits_at_selects_the_full_projection_row():
    _, _, tmodel, tparams = models()
    prog = tkv.build_program(tmodel)
    toks = np.asarray(prompts(11, [2 * 6])[0], np.int32).reshape(2, 6)
    table = np.array([[1, 2], [3, 4]], np.int32)
    outs = []
    for at in (None, torch.tensor([5, 2])):
        k, v = tkv.make_pools(TCFG, 9, 4, device="cpu")
        cache = PagedCache(k, v, torch.from_numpy(table),
                           torch.zeros(2, dtype=torch.int32),
                           torch.tensor([6, 3], dtype=torch.int32))
        with torch.no_grad():
            out, _ = torch.func.functional_call(
                tmodel, tparams, (torch.from_numpy(toks),),
                {"cache": cache, "logits_at": at})
        outs.append(out)
    full, sel = outs
    assert sel.shape == (2, VOCAB)
    np.testing.assert_allclose(sel[0].numpy(), full[0, 5].numpy(), atol=TOL)
    np.testing.assert_allclose(sel[1].numpy(), full[1, 2].numpy(), atol=TOL)


def test_paged_path_never_consults_attention_fn(monkeypatch):
    """The paged read goes through _default_attention, as the JAX
    module's does; an injected attention_fn (the flash kernel in
    training) is not called."""
    import dataclasses
    from horovod_tpu_torch.models import transformer as ttr

    def boom(*a):
        raise AssertionError("attention_fn called on the paged path")
    cfg = dataclasses.replace(TCFG, attention_fn=boom)
    model = ttr.Transformer(cfg, device="meta")
    _, _, _, tparams = models()
    k, v = tkv.make_pools(cfg, 9, 4, device="cpu")
    cache = PagedCache(k, v, torch.tensor([[1, 2]], dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32),
                       torch.tensor([3], dtype=torch.int32))
    with torch.no_grad():
        logits, _ = torch.func.functional_call(
            model, tparams, (torch.tensor([[1, 2, 3, 0]]),),
            {"cache": cache})
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# the sampling prefill and decode programs
# ---------------------------------------------------------------------------

def _jsample(B, temp=0.0, top_k=0, top_p=1.0, seed=5, emitted=0):
    return jkv.SampleParams(
        temperature=jnp.full((B,), temp, jnp.float32),
        top_k=jnp.full((B,), top_k, jnp.int32),
        top_p=jnp.full((B,), top_p, jnp.float32),
        key=jnp.asarray(np.tile(np.array([[0, seed]], np.uint32), (B, 1))
                        + np.arange(B, dtype=np.uint32)[:, None]),
        emitted=jnp.full((B,), emitted, jnp.int32))


def _tsample(B, temp=0.0, top_k=0, top_p=1.0, seed=5, emitted=0):
    key = np.tile(np.array([[0, seed]], np.int64), (B, 1)) \
        + np.arange(B)[:, None]
    return tkv.SampleParams(
        temperature=torch.full((B,), temp), top_k=torch.full(
            (B,), top_k, dtype=torch.int32),
        top_p=torch.full((B,), top_p), key=torch.from_numpy(key),
        emitted=torch.full((B,), emitted, dtype=torch.int32))


@pytest.mark.parametrize("temp,top_k,top_p", [(0.0, 0, 1.0),
                                              (0.8, 20, 0.9)])
def test_prefill_program_matches_jax(temp, top_k, top_p):
    jmodel, variables, tmodel, tparams = models()
    toks = np.zeros((1, 8), np.int32)
    toks[0, :6] = prompts(21, [6])[0]
    table = np.array([[1, 2, 0, 0]], np.int32)
    jk, jv = jkv.make_pools(JCFG, 9, 4)
    jt, jl, _ = jkv.build_prefill_program(jmodel)(
        variables, JPagedCache(jk, jv, jnp.asarray(table),
                               jnp.zeros((1,), jnp.int32),
                               jnp.asarray([6], jnp.int32)),
        jnp.asarray(toks), _jsample(1, temp, top_k, top_p))
    tk, tv = tkv.make_pools(TCFG, 9, 4, device="cpu")
    tt, tl, _ = tkv.build_prefill_program(tmodel)(
        tparams, PagedCache(tk, tv, torch.from_numpy(table),
                            torch.zeros(1, dtype=torch.int32),
                            torch.tensor([6], dtype=torch.int32)),
        torch.from_numpy(toks), _tsample(1, temp, top_k, top_p))
    assert tt.tolist() == np.asarray(jt).tolist()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL)


@pytest.mark.parametrize("temp", [0.0, 1.0])
def test_decode_program_steps_match_jax(temp):
    """Four lanes (one dead, one with EOS, one with 2 tokens left), six
    steps of the device-resident loop: tokens, retirement and the state
    equal, logprobs at 1e-5."""
    jmodel, variables, tmodel, tparams = models()
    B = 4
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 0], [0, 0, 0, 0],
                       [7, 8, 9, 0]], np.int32)
    lengths = np.array([3, 5, 0, 2], np.int32)
    live = np.array([1, 1, 0, 1], np.int32)
    remaining = np.array([6, 6, 1, 2], np.int32)
    start = np.array(prompts(3, [4])[0], np.int32)
    jk, jv = jkv.make_pools(JCFG, 11, 4)
    tk, tv = tkv.make_pools(TCFG, 11, 4, device="cpu")
    # lanes' caches from one prefill each, through both raw programs
    for lane in (0, 1, 3):
        buf = np.zeros((1, 8), np.int32)
        buf[0, :lengths[lane]] = prompts(40 + lane, [lengths[lane]])[0]
        jc = JPagedCache(jk, jv, jnp.asarray(tables[lane:lane + 1]),
                         jnp.zeros((1,), jnp.int32),
                         jnp.asarray(lengths[lane:lane + 1]))
        _, jc = jkv.build_program(jmodel)(variables, jc, jnp.asarray(buf))
        jk, jv = jc.k, jc.v
        tkv.build_program(tmodel)(
            tparams, PagedCache(tk, tv, torch.from_numpy(tables[lane:lane + 1]),
                                torch.zeros(1, dtype=torch.int32),
                                torch.from_numpy(lengths[lane:lane + 1])),
            torch.from_numpy(buf))
    eos = np.array([-1, -1, -1, -1], np.int32)
    js = jkv.DecodeState(jnp.asarray(start), jnp.asarray(lengths),
                         jnp.asarray(live), jnp.asarray(remaining),
                         jnp.asarray(eos), _jsample(B, temp))
    ts = tkv.DecodeState(torch.from_numpy(start), torch.from_numpy(lengths),
                         torch.from_numpy(live), torch.from_numpy(remaining),
                         torch.from_numpy(eos), _tsample(B, temp))
    jdec = jkv.build_decode_program(jmodel, DECODE_WIDTH)
    tdec = tkv.build_decode_program(tmodel, DECODE_WIDTH)
    jt_all, tt_all = [], []
    for _ in range(6):
        jk, jv, js, jt, jl = jdec(variables, jk, jv, jnp.asarray(tables), js)
        tk, tv, ts, tt, tl = tdec(tparams, tk, tv, torch.from_numpy(tables),
                                  ts)
        jt_all.append(np.asarray(jt).tolist())
        tt_all.append(tt.tolist())
        np.testing.assert_allclose(tl.numpy()[live > 0],
                                   np.asarray(jl)[live > 0], atol=TOL)
        assert ts.live.tolist() == np.asarray(js.live).tolist()
        assert ts.lengths.tolist() == np.asarray(js.lengths).tolist()
        assert ts.sample.emitted.tolist() == \
            np.asarray(js.sample.emitted).tolist()
    assert tt_all == jt_all
    assert ts.live.tolist()[3] == 0          # budget of 2 ran out


def test_greedy_programs_equal_the_raw_program_argmax():
    """The sampling programs' greedy tokens are the raw program's host
    argmax, step for step (the chip_smoke check, at the tests' size)."""
    _, _, tmodel, tparams = models()
    B, steps = 3, 10
    ps = prompts(8, [5, 9, 7])
    tables = np.zeros((B, 8), np.int32)
    for i in range(B):
        tables[i, :6] = np.arange(1, 7) + 6 * i
    k1, v1 = tkv.make_pools(TCFG, 20, 4, device="cpu")
    k2, v2 = tkv.make_pools(TCFG, 20, 4, device="cpu")
    raw, pre = tkv.build_program(tmodel), tkv.build_prefill_program(tmodel)
    first = []
    for i, p in enumerate(ps):
        buf = np.zeros((1, 16), np.int32)
        buf[0, :len(p)] = p
        c = PagedCache(k1, v1, torch.from_numpy(tables[i:i + 1]),
                       torch.zeros(1, dtype=torch.int32),
                       torch.tensor([len(p)], dtype=torch.int32))
        logits, _ = raw(tparams, c, torch.from_numpy(buf))
        c2 = PagedCache(k2, v2, torch.from_numpy(tables[i:i + 1]),
                        torch.zeros(1, dtype=torch.int32),
                        torch.tensor([len(p)], dtype=torch.int32))
        tok, _, _ = pre(tparams, c2, torch.from_numpy(buf), _tsample(1))
        assert int(tok[0]) == int(np.argmax(logits[0, len(p) - 1].numpy()))
        first.append(int(tok[0]))
    state = tkv.DecodeState(
        torch.tensor(first, dtype=torch.int32),
        torch.tensor([len(p) for p in ps], dtype=torch.int32),
        torch.ones(B, dtype=torch.int32),
        torch.full((B,), 100, dtype=torch.int32),
        torch.full((B,), -1, dtype=torch.int32), _tsample(B))
    dec = tkv.build_decode_program(tmodel, DECODE_WIDTH)
    nxt = list(first)
    lengths = [len(p) for p in ps]
    for _ in range(steps):
        buf = np.zeros((B, DECODE_WIDTH), np.int32)
        buf[:, 0] = nxt
        c = PagedCache(k1, v1, torch.from_numpy(tables),
                       torch.tensor(lengths, dtype=torch.int32),
                       torch.ones(B, dtype=torch.int32))
        logits, _ = raw(tparams, c, torch.from_numpy(buf))
        want = logits[:, 0].numpy().argmax(-1).tolist()
        k2, v2, state, tok, _ = dec(tparams, k2, v2,
                                    torch.from_numpy(tables), state)
        assert tok.tolist() == want
        nxt = want
        lengths = [n + 1 for n in lengths]


# ---------------------------------------------------------------------------
# ContinuousBatcher through the engines, against the JAX engine
# ---------------------------------------------------------------------------

WAVES = {
    # (engine knobs, request list)
    "mixed": (dict(), [dict(prompt=p, max_tokens=n) for p, n in zip(
        prompts(0, [5, 13, 20, 3, 9, 30]), [12, 7, 9, 1, 15, 6])]),
    "eos": (dict(), [dict(prompt=p, max_tokens=12, eos_id=e) for p, e in
                     zip(prompts(1, [6, 11, 4]), [17, 3, 60])]),
    "preempt": (dict(num_blocks=14, max_seqs=4), [
        dict(prompt=p, max_tokens=14) for p in prompts(2, [9, 10, 11, 8])]),
    "prefix": (dict(), [dict(prompt=prompts(3, [17])[0] + p, max_tokens=8)
                        for p in prompts(4, [2, 5, 9])]),
    "sync": (dict(async_depth=0), [dict(prompt=p, max_tokens=10)
                                   for p in prompts(5, [7, 12])]),
    "sampled": (dict(), [dict(prompt=p, max_tokens=10, temperature=0.9,
                              top_k=30, top_p=0.95, seed=s)
                         for s, p in enumerate(prompts(6, [5, 8, 14]))]),
}


@pytest.fixture(scope="module")
def jax_waves():
    out = {}
    for name, (knobs, reqs) in WAVES.items():
        with jax_engine(**knobs) as eng:
            out[name] = run_all(eng, reqs)
            out[name + ".leak"] = eng.allocator.in_use
    return out


@pytest.mark.parametrize("wave", sorted(WAVES))
def test_engine_wave_matches_jax(jax_waves, wave):
    """Tokens equal, logprobs within 1e-5, no block leaked."""
    knobs, reqs = WAVES[wave]
    with port_engine(**knobs) as eng:
        got = run_all(eng, reqs)
        assert eng.allocator.in_use == 0
    assert jax_waves[wave + ".leak"] == 0
    for (t, lp), (jt, jlp) in zip(got, jax_waves[wave]):
        assert t == jt
        np.testing.assert_allclose(lp, jlp, rtol=0, atol=TOL)


def test_preemption_happens_and_changes_no_token(jax_waves):
    knobs, reqs = WAVES["preempt"]
    key = "hvd_tpu_gen_preemptions_total"
    before = tmetrics.snapshot().get(key, 0)
    with port_engine(**knobs) as eng:
        got = run_all(eng, reqs)
    assert tmetrics.snapshot().get(key, 0) > before
    assert [t for t, _ in got] == [t for t, _ in jax_waves["preempt"]]


def test_prefix_cache_hits_and_changes_no_token(jax_waves):
    knobs, reqs = WAVES["prefix"]
    hit = 'hvd_tpu_gen_prefix_cache_hit_tokens_total{source="local"}'
    before = tmetrics.snapshot().get(hit, 0)
    with port_engine(**knobs) as eng:
        # one at a time, so later prompts find the first one's blocks
        got = [run_all(eng, [r])[0] for r in reqs]
    assert tmetrics.snapshot().get(hit, 0) > before
    with port_engine(prefix_cache=False, **knobs) as eng:
        cold = run_all(eng, reqs)
    assert [t for t, _ in got] == [t for t, _ in cold] \
        == [t for t, _ in jax_waves["prefix"]]


def test_engine_defaults_to_the_card():
    _, _, tmodel, tparams = models()
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from horovod_tpu_torch.serving.generation import GenerationEngine
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(tmodel, params=tparams, num_blocks=9,
                         block_size=4)


def test_stream_yields_the_generated_tokens():
    p = prompts(9, [6])[0]
    with port_engine() as eng:
        want = eng.generate(p, max_tokens=9, timeout=30)
        streamed = list(eng.stream(p, max_tokens=9, timeout=30))
    assert streamed == want and len(want) == 9


ADMISSION = [
    dict(prompt=[], max_tokens=4),
    dict(prompt=[1, 2], max_tokens=0),
    dict(prompt=[1, VOCAB], max_tokens=2),
    dict(prompt=[1, 2], max_tokens=2, temperature=-1.0),
    dict(prompt=[1, 2], max_tokens=2, top_k=-1),
    dict(prompt=[1, 2], max_tokens=2, top_p=0.0),
    dict(prompt=[1] * 60, max_tokens=10),
    dict(prompt=[1, 2], max_tokens=2, num_beams=0),
    dict(prompt=[1, 2], max_tokens=2, num_beams=3, temperature=0.5),
    dict(prompt=[1, 2], max_tokens=2, sample_offset=-1),
    dict(prompt=[1, 2], max_tokens=2, deadline_ms=-5),
    dict(prompt=[1, 2], max_tokens=2, budget_ms=0),
]


@pytest.fixture(scope="module")
def admission_pair():
    j = jax_engine(num_blocks=9, max_beams=2)
    t = port_engine(num_blocks=9, max_beams=2)
    yield j, t
    j.close()
    t.close()


@pytest.mark.parametrize("req", range(len(ADMISSION)))
def test_admission_errors_match_jax(admission_pair, req):
    j, t = admission_pair
    with pytest.raises(Exception) as je:
        j.submit(**ADMISSION[req])
    with pytest.raises(Exception) as te:
        t.submit(**ADMISSION[req])
    assert type(te.value).__name__ == type(je.value).__name__
    assert str(te.value) == str(je.value)


def test_queue_full_rejects_fast():
    with port_engine(queue_depth=1) as eng:
        eng.batcher._ensure_thread = lambda: None   # nobody drains
        eng.submit([1, 2], max_tokens=2)
        with pytest.raises(QueueFullError):
            eng.submit([1, 2], max_tokens=2)


def test_deadline_sheds_a_waiting_sequence():
    with port_engine(max_seqs=1, deadline_ms=0) as eng:
        long = eng.submit(prompts(12, [30])[0], max_tokens=30)
        late = eng.submit([1, 2, 3], max_tokens=2, deadline_ms=1)
        with pytest.raises(DeadlineExceededError) as e:
            eng.result(late, timeout=30)
        assert e.value.stage == "queue"
        assert len(eng.result(long, timeout=30)) == 30


def test_cancel_fails_the_sequence_and_frees_its_blocks():
    with port_engine(max_seqs=1) as eng:
        # paced, so the cancel lands long before the 40th token
        eng.batcher.on_step = lambda phase, ids: time.sleep(0.02)
        s = eng.submit(prompts(13, [10])[0], max_tokens=40,
                       request_id="rid-cancel")
        next(eng.batcher.stream(s, timeout=30))
        eng.cancel("rid-cancel")
        with pytest.raises(RequestCancelledError):
            eng.result(s, timeout=30)
        deadline = time.monotonic() + 10
        while eng.allocator.in_use and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng.allocator.in_use == 0


def test_stop_fails_waiting_sequences_and_returns_blocks():
    eng = port_engine(max_seqs=1)
    seqs = [eng.submit(p, max_tokens=30) for p in prompts(14, [8, 8, 8])]
    eng.close()
    errors = 0
    for s in seqs:
        try:
            eng.result(s, timeout=10)
        except RuntimeError:
            errors += 1
    assert errors >= 1 and eng.allocator.in_use == 0


def test_decode_fault_fails_only_that_step():
    """serving.decode:error once: the sequences of that step fail, the
    next request is served (the JAX package's chaos drill)."""
    tfaults.configure("serving.decode:error:once", seed=0)
    with port_engine() as eng:
        s = eng.submit(prompts(15, [5])[0], max_tokens=6)
        with pytest.raises(Exception, match="injected"):
            eng.result(s, timeout=30)
        ok = eng.generate(prompts(15, [5])[0], max_tokens=6, timeout=30)
        assert len(ok) == 6 and eng.allocator.in_use == 0


def test_logprob_corruption_fails_exactly_one_sequence():
    tfaults.configure("serving.logprob:nan:once", seed=0)
    with port_engine() as eng:
        seqs = [eng.submit(p, max_tokens=5) for p in prompts(16, [4, 6])]
        failed = 0
        for s in seqs:
            try:
                eng.result(s, timeout=30)
            except RuntimeError as e:
                assert "non-finite logprob" in str(e)
                failed += 1
        assert failed == 1


def test_kv_export_import_round_trip():
    """Blocks exported by one engine and imported by another let the
    second admit the prompt with the prefix cache hit; the continuation
    is unchanged."""
    p = prompts(17, [21])[0]
    with port_engine() as a, port_engine() as b:
        want = a.generate(p, max_tokens=6, timeout=30)
        hashes = a.kv_manifest(p)
        assert len(hashes) == 5
        served, k, v = a.kv_export(hashes)
        assert served == hashes and tuple(k.shape)[1] == 5
        assert b.kv_probe(hashes) == 0
        held, imported = b.kv_import(hashes, served, k, v)
        assert (held, imported) == (0, 5) and b.kv_probe(hashes) == 5
        assert b.generate(p, max_tokens=6, timeout=30) == want


def test_checkpoint_restore_and_hot_reload(tmp_path):
    from horovod_tpu_torch.checkpointing import CheckpointManager
    from horovod_tpu_torch.serving.generation import GenerationEngine
    _, _, tmodel, tparams = models()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, dict(tparams))
    mgr.wait_until_finished()
    p = prompts(18, [7])[0]
    with GenerationEngine(tmodel, checkpoint_dir=str(tmp_path),
                          block_size=4, num_blocks=41, max_seqs=2,
                          prefill_chunk=8, reload_poll_seconds=0,
                          device="cpu") as eng:
        assert eng.step == 1
        a = eng.generate(p, max_tokens=5, timeout=30)
        scaled = {n: t * (1.5 if n == "embedding" else 1.0)
                  for n, t in tparams.items()}
        mgr.save(2, scaled)
        mgr.wait_until_finished()
        assert eng.reload() is True and eng.step == 2
        b = eng.generate(p, max_tokens=5, timeout=30)
    with port_engine() as ref:
        assert ref.generate(p, max_tokens=5, timeout=30) == a
    assert len(b) == 5
