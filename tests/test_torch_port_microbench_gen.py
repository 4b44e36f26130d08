"""The port's generation microbenchmarks (continuous against static
batching, sampling modes, the prefix cache, ngram speculation and the
failover resume) against the JAX package's sections at tiny sizes on the
CPU, each on the JAX sweep's own model (``PRNGKey(0)`` at the sweep's
configuration, carried across by ``models/convert.py``; float32).

Every section must return the JAX section's keys and assert what the JAX
section asserts (outputs identical across modes, no KV block leaked).
The counts that do not depend on thread timing must be equal: the static
baseline's decode steps and peak KV, the prefix cache's prefilled, hit,
miss and evicted tokens, the speculative decoder's drafted and accepted
tokens and verify steps, and the bit-identity flags. The continuous
mode's decode steps and peak KV, and the scheduler's iteration counts,
depend on when each client thread's request reaches the scheduler, in
either package, and are held to their invariants only. Timings are not
compared.
"""

import pytest

from horovod_tpu import microbench as jmb
from horovod_tpu_torch import microbench as tmb

from torch_port_microbench_common import (GEN_CFG, SPEC_CFG,
                                          jax_params_for_port, key_tree,
                                          resume_cfg)

GEN = dict(num_requests=4, batch_slots=2)
EMITTED = 8
SPEC = dict(max_tokens=16, repeats=1)


@pytest.fixture(scope="module")
def rows():
    gen_params = jax_params_for_port(GEN_CFG)
    jax = {"generation": jmb.generation_sweep(**GEN),
           "sampling": jmb.sampling_sweep(**GEN),
           "prefix": jmb.prefix_sweep(**GEN),
           "spec": jmb.spec_sweep(**SPEC),
           "resume": jmb.resume_sweep(emitted=EMITTED)}
    port = {"generation": tmb.generation_sweep(params=gen_params,
                                               device="cpu", **GEN),
            "sampling": tmb.sampling_sweep(params=gen_params, device="cpu",
                                           **GEN),
            "prefix": tmb.prefix_sweep(params=gen_params, device="cpu",
                                       **GEN),
            "spec": tmb.spec_sweep(params=jax_params_for_port(SPEC_CFG),
                                   device="cpu", **SPEC),
            "resume": tmb.resume_sweep(
                emitted=EMITTED, params=jax_params_for_port(
                    resume_cfg(EMITTED)), device="cpu")}
    return jax, port


@pytest.mark.parametrize("section", ["generation", "sampling", "prefix",
                                     "spec", "resume"])
def test_section_keys_match_jax(section, rows):
    jax, port = rows
    assert key_tree(port[section]) == key_tree(jax[section])


def test_generation_counts_match_jax(rows):
    jax, port = rows
    t, j = port["generation"], jax["generation"]
    for k in ("scenario", "num_requests", "batch_slots", "block_size",
              "num_blocks", "model", "total_prompt_tokens",
              "total_new_tokens"):
        assert t[k] == j[k], k
    for k in ("decode_steps", "peak_kv_blocks", "peak_kv_bytes"):
        assert t["static"][k] == j["static"][k], k
    c = t["continuous"]
    # every request's new tokens took at least one decode step after its
    # first (prefill) token; the allocator never held more than the
    # static reservation's worst case
    assert c["decode_steps"] >= max((32, 4, 4, 4)) - 1
    assert 0 < c["peak_kv_blocks"] <= t["num_blocks"] - 1
    assert c["preemptions"] == j["continuous"]["preemptions"] == 0


def test_sampling_counts_match_jax(rows):
    jax, port = rows
    for k in ("scenario", "num_requests", "num_blocks", "total_new_tokens",
              "sampled_params"):
        assert port["sampling"][k] == jax["sampling"][k], k


def test_prefix_counts_match_jax(rows):
    jax, port = rows
    t, j = port["prefix"], jax["prefix"]
    for k in ("system_prompt_tokens", "total_prompt_tokens",
              "total_new_tokens", "num_blocks"):
        assert t[k] == j[k], k
    for mode in ("cache_off", "cache_on"):
        for k in ("prefill_tokens", "hit_tokens", "miss_tokens",
                  "evictions"):
            assert t[mode][k] == j[mode][k], (mode, k)
    assert t["prefill_reduction"] == j["prefill_reduction"]
    assert t["cache_on"]["hit_tokens"] > 0


def test_spec_counts_match_jax(rows):
    jax, port = rows
    t, j = port["spec"], jax["spec"]
    assert t["bit_identical"] is j["bit_identical"] is True
    for mode in ("repetitive_spec", "random_spec"):
        for k in ("drafted", "accepted", "accept_rate", "verify_steps"):
            assert t["modes"][mode][k] == j["modes"][mode][k], (mode, k)


def test_resume_is_bit_identical_as_jax(rows):
    jax, port = rows
    assert port["resume"]["bit_identical"] is True
    assert jax["resume"]["bit_identical"] is True
    assert port["resume"]["emitted_tokens"] == EMITTED
