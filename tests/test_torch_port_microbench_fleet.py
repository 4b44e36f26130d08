"""The port's fleet and scaling microbenchmarks against the JAX
package's sections at tiny sizes on the CPU: the router's hedge race
against latency-scripted stubs, the pooled prefill/decode fleet against
a colocated one (on the JAX sweep's own model, carried across by
``models/convert.py``), and one scaling point of the CNN rig.

Keys must be the JAX sections'. Equal where no thread timing enters: the
pooled fleet's transfer bytes and transferred prefix hits (the same
blocks in the same wire format), its zero-byte warm repeat and the
bit-identity flag; the scaling point's batch and platform. The hedge
counts depend on the latency sample and are held to at least one hedge
launched and won. The JAX world here spans conftest's 8 forced CPU
devices, so the scaling point's device count differs (8 against 1).
"""

import pytest

import horovod_tpu as jhvd
import horovod_tpu_torch as thvd
from horovod_tpu import microbench as jmb
from horovod_tpu_torch import microbench as tmb

from torch_port_microbench_common import (GEN_CFG, jax_params_for_port,
                                          key_tree)

# every 5th request of a stub stalls 400 ms; the hedge fires at the
# latency sample's median, so a loaded test host (whose fast answers take
# tens of ms) still hedges every stall and the other stub still wins
HEDGE = dict(requests=20, slow_every=5, slow_ms=400.0, fast_ms=4.0,
             hedge_quantile=0.5)
DISAGG = dict(num_requests=4, batch_slots=2)
SCALE = dict(batch_per_device=2, image_size=32, num_iters=1,
             num_batches_per_iter=1)


@pytest.fixture(scope="module")
def rows():
    if jhvd.is_initialized():
        jhvd.shutdown()
    jhvd.init()
    try:
        jax = {"hedging": jmb.hedging_sweep(**HEDGE),
               "disagg": jmb.disagg_sweep(**DISAGG),
               "scaling": jmb.scaling_sweep_point(**SCALE)}
    finally:
        jhvd.shutdown()
    port = {"hedging": tmb.hedging_sweep(**HEDGE),
            "disagg": tmb.disagg_sweep(params=jax_params_for_port(GEN_CFG),
                                       device="cpu", **DISAGG)}
    thvd.init(device="cpu")
    try:
        port["scaling"] = tmb.scaling_sweep_point(device="cpu", **SCALE)
    finally:
        thvd.shutdown()
    return jax, port


@pytest.mark.parametrize("section", ["hedging", "disagg", "scaling"])
def test_section_keys_match_jax(section, rows):
    jax, port = rows
    assert key_tree(port[section]) == key_tree(jax[section])


def test_hedges_launched_and_won(rows):
    for side in rows:
        h = side["hedging"]
        assert h["on"]["hedges_launched"] >= 1
        assert h["on"]["hedges_won"] >= 1
        assert h["requests"] == HEDGE["requests"]


def test_disagg_counts_match_jax(rows):
    jax, port = rows
    t, j = port["disagg"], jax["disagg"]
    assert t["bit_identical"] is j["bit_identical"] is True
    for k in ("num_blocks", "system_prompt_tokens", "total_new_tokens"):
        assert t[k] == j[k], k
    for k in ("transfer_bytes", "transfer_hit_tokens",
              "warm_repeat_transfer_bytes"):
        assert t["pooled"][k] == j["pooled"][k], k
    assert t["pooled"]["warm_repeat_transfer_bytes"] == 0
    assert t["pooled"]["transfer_bytes"] > 0


def test_scaling_point_matches_jax(rows):
    jax, port = rows
    t, j = port["scaling"], jax["scaling"]
    assert (t["batch_per_device"], t["platform"]) == \
        (j["batch_per_device"], j["platform"]) == (2, "cpu")
    assert t["num_devices"] == 1 and t["images_per_sec_total"] > 0
