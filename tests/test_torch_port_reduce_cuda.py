"""The compiled-plane reductions over NCCL, held to the same reductions
over gloo on the CPU: ``tests/torch_port_reduce_worker.py`` (every
(strategy, packing, op), the oracle's integer gradients, bf16 and fp16 on
the wire, int8 for 3 steps with its residual, a training mesh's dim and
Adasum) run once on the card and once on the CPU, its arrays compared
key by key.

Marked ``cuda``: every test skips on a machine without an NVIDIA GPU; the
four-card drill skips with fewer than 4. On the card, from the root of a
checkout:

    python -m pytest --noconftest -m cuda tests/test_torch_port_reduce_cuda.py

Tolerances: on one card every reduction is over groups of one, so the two
paths do the same elementwise fp32 (and fp64 for int8's residual) IEEE
operations: equal bit for bit. On four cards as 2 x 2 (cross 2, local 2;
rank r on cuda:r): every sum of two values is order-free, so
``hierarchical``, int8 (a MAX and an exact integer sum) and the
oracle's integer gradients are exact; a sum of four values
(``flat``, the training mesh's dp = 4) differs by NCCL's order against
gloo's, within 2 (n - 1) 2^-24 sum |x| (each partial sum rounds once);
Adasum's dot products within rtol 1e-4, atol 1e-5, the JAX package's
Adasum tolerance (tests/test_adasum.py).
"""

import numpy as np
import pytest
import torch

from torch_port_reduce_worker import make_grads, run_world

pytestmark = pytest.mark.cuda


def _cards(n):
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < n:
        pytest.skip(f"needs {n} NVIDIA GPU(s), found {cards}")


def _rows(arrays, key):
    return np.stack([a[key] for a in arrays])


def test_one_card_reductions_equal_the_cpu_path(tmp_path):
    _cards(1)
    (tmp_path / "gpu").mkdir()
    (tmp_path / "cpu").mkdir()
    gpu, ginfo = run_world(tmp_path / "gpu", 1, 1, device="cuda")
    cpu, cinfo = run_world(tmp_path / "cpu", 1, 1, device="cpu")
    assert ginfo[0]["device"] == "cuda:0"
    assert set(gpu[0]) == set(cpu[0])
    for key in cpu[0]:
        np.testing.assert_array_equal(gpu[0][key], cpu[0][key],
                                      err_msg=key)
    assert ginfo[0]["adasum_route_equal"]


def test_four_card_drill_equals_the_cpu_path(tmp_path):
    _cards(4)
    (tmp_path / "gpu").mkdir()
    (tmp_path / "cpu").mkdir()
    gpu, ginfo = run_world(tmp_path / "gpu", 2, 2, device="cuda")
    cpu, _ = run_world(tmp_path / "cpu", 2, 2, device="cpu")
    assert [i["device"] for i in ginfo] == [f"cuda:{r}" for r in range(4)]
    assert all(i["mesh"] == [2, 2] for i in ginfo)
    assert all(i["adasum_route_equal"] for i in ginfo)
    grads = make_grads(4)
    for key in cpu[0]:
        got, want = _rows(gpu, key), _rows(cpu, key)
        leaf = key.rsplit(".", 1)[-1]
        four_sum = key.startswith("dp.") or (
            ".flat." in key and not key.startswith(("int8.", "oracle.")))
        if key == "adasum":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        elif not four_sum:
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            divisor = 2 if ".Sum." in key else 4
            rows = grads[leaf]
            bound = 2 * 3 * 2.0 ** -24 * np.abs(rows).sum(0) / divisor
            assert np.all(np.abs(got - want) <= bound), key
