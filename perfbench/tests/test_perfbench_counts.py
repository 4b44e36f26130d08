"""The yardstick's counts against numbers worked out by hand."""

import json
import os

import pytest

from perfbench import counts, spec
from perfbench.families import gpt2, resnet


def _config(name):
    with open(os.path.join(spec.HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_gpt2_medium_flops_per_step():
    cfg = _config("gpt2-medium")
    # dense: 24 x (4 x 1024^2 + 8 x 1024^2) + 50257 x 1024 matmul
    # parameters, 6 FLOPs each per token, 8 x 1024 tokens
    dense = 6.0 * 353_453_056 * 8 * 1024
    # attention: 3 x 24 layers x 4 x 8 rows x 16 heads x 64 x the
    # 1024 x 1025 / 2 causal pairs
    attention = 3 * 24 * 4 * 8 * 16 * 64 * 524_800
    assert dense == pytest.approx(1.7373e13, rel=1e-4)
    assert attention == pytest.approx(1.2382e12, rel=1e-4)
    assert counts.gpt2_flops_per_step(cfg, 8) == dense + attention
    assert counts.gpt2_flops_per_step(cfg, 8) == pytest.approx(1.861e13,
                                                               rel=1e-3)


def test_flash_bound_at_the_training_shape():
    nbytes, flops, least = counts.flash_bound(128, 1024, 64, True)
    assert flops == 4 * 64 * 128 * 524_800 == 17_196_646_400
    assert nbytes == 4 * 128 * 1024 * 64 * 2 + 128 * 1024 * 4 == 67_633_152
    # bytes bound it: 20.2 us against 17.4 us of operations
    assert least == pytest.approx(nbytes / 3.35e12)
    assert least == pytest.approx(20.19e-6, rel=1e-3)


@pytest.mark.parametrize("sq,sk,causal,q_off,k_off,want", [
    (4, 4, False, 0, 0, 16),
    (4, 4, True, 0, 0, 10),
    (4, 4, True, 4, 0, 16),     # a later query shard sees every key
    (4, 4, True, 0, 4, 0),      # a later key shard is all masked
    (1024, 1024, True, 0, 0, 524_800),
])
def test_visible_pairs(sq, sk, causal, q_off, k_off, want):
    assert counts.visible_pairs(sq, sk, causal, q_off, k_off) == want


def test_peak_table():
    row = counts.peaks("NVIDIA H100 80GB HBM3")
    assert row == {"bf16_flops": 989e12, "bytes": 3.35e12}
    assert counts.peaks("NVIDIA A100-SXM4-80GB") is None


def test_gpt2_medium_leaves_hold_the_stated_parameters():
    cfg = _config("gpt2-medium")
    n = 0
    for _, shape, _ in gpt2.leaves(cfg):
        size = 1
        for s in shape:
            size *= s
        n += size
    assert n == cfg["parameters"] == 354_601_984
    assert cfg["published"]["parameters"] - n == 221_184


def test_resnet50_flops_against_the_published_constant():
    """The reference's count on the meta device against 3 x 8.2 GFLOP an
    image (``horovod_tpu_torch.benchmark``'s cross-check constant, 4.1
    GMAC forward): the stem's input gradient is not computed, so a little
    under."""
    cfg = _config("resnet50-v1.5")
    per_image = resnet.flops_per_step(cfg, {"batch_per_chip": 2,
                                            "image_size": 224}) / 2
    assert per_image == pytest.approx(3 * 8.2e9, rel=0.03)
