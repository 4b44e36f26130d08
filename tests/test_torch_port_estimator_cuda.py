"""The Estimator slice's device paths on the card: the prefetcher's
pinned, side-stream copies, the step guard's reductions and the
fingerprint fold (``horovod_tpu_torch.data``, ``sdc.guard``,
``sdc.fingerprint``).

Marked ``cuda``: every test skips on a machine without an NVIDIA GPU. On
the card, from the root of a checkout:

    python -m pytest --noconftest -m cuda tests/test_torch_port_estimator_cuda.py

Everything here is exact: the prefetched batches equal the host arrays
bit for bit, the guard on CUDA tensors flags exactly the cases the host
check (numpy) flags, and the fold on the card equals the fold on the host
and the JAX package's algorithm written out in numpy.
"""

import numpy as np
import pytest
import torch

from horovod_tpu_torch import data, sdc

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def test_prefetched_batches_equal_the_host_arrays(cuda):
    rng = np.random.RandomState(0)
    x = rng.randn(96, 33, 7).astype(np.float32)
    y = rng.randint(0, 1000, (96, 2048)).astype(np.int32)
    want = list(data.batches((x, y), 8, seed=3, pad_remainder=True))
    feed = data.prefetch_to_device(
        data.batches((x, y), 8, seed=3, pad_remainder=True), buffer_size=3,
        device=cuda)
    got = []
    for bx, by, mask in feed:
        assert bx.is_cuda and by.is_cuda and mask.is_cuda
        # work on the consumer's stream right away: it must see the whole
        # batch (the event wait), and the memory must stay the batch's
        # (record_stream) while this work is queued behind later copies
        got.append((torch.cat([bx.reshape(8, -1) * 1.0,
                               by.float()], 1), bx, by, mask))
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for (_, bx, by, mask), (hx, hy, hm) in zip(got, want):
        np.testing.assert_array_equal(bx.cpu().numpy(), hx)
        np.testing.assert_array_equal(by.cpu().numpy(), hy)
        np.testing.assert_array_equal(mask.cpu().numpy(), hm)


def test_prefetch_close_mid_epoch_on_the_card(cuda):
    src = (np.full((1024, 1024), i, np.float32) for i in range(100))
    feed = data.PrefetchIterator(src, buffer_size=2, device=cuda)
    first = next(feed)
    feed.close()
    assert not feed._thread.is_alive()
    assert float(first[0, 0]) == 0.0
    with pytest.raises(StopIteration):
        next(feed)


def _host_verdict(leaves, loss) -> bool:
    """The JAX guard's host check (numpy): a poisoned step?"""
    if not np.isfinite(loss):
        return True
    for a in leaves:
        if not np.issubdtype(a.dtype, np.floating):
            continue
        if not np.all(np.isfinite(a)) or (
                a.size and float(np.max(np.abs(a.astype(np.float32))))
                > sdc.guard.GRAD_ABS_LIMIT):
            return True
    return False


def _cases():
    rng = np.random.RandomState(1)
    base = [rng.randn(3072, 768).astype(np.float32),
            rng.randn(768).astype(np.float32),
            rng.randn(12, 64, 768).astype(np.float32)]
    out = [("clean", base, 1.0)]
    for name, leaf, idx, value in (
            ("nan", 0, 12345, np.nan), ("inf", 2, 7, np.inf),
            ("-inf", 1, 0, -np.inf), ("big", 0, 99, 2e12),
            ("limit", 0, 5, 1e12)):
        leaves = [a.copy() for a in base]
        leaves[leaf].reshape(-1)[idx] = value
        out.append((name, leaves, 1.0))
    flipped = [a.copy() for a in base]
    flipped[2].view(np.uint32).reshape(-1)[4242] ^= np.uint32(1 << 30)
    out.append(("bitflip", flipped, 1.0))
    out.append(("loss", base, float("nan")))
    return out


@pytest.mark.parametrize("case", range(8))
def test_device_guard_flags_exactly_where_the_host_check_does(cuda, case):
    name, leaves, loss = _cases()[case]
    want = _host_verdict(leaves, loss)
    on_card = [torch.from_numpy(a).to(cuda) for a in leaves]
    det = sdc.StepGuard(sync=lambda c: c, loss_spike_factor=0).check(
        on_card, torch.tensor(loss, device=cuda))
    assert (det is not None) == want, name
    code, _ = sdc.guard_update(on_card, torch.tensor(loss, device=cuda),
                               factor=0)
    assert code.is_cuda and (int(code) == 2) == want, name
    assert name in ("clean", "limit") or want


def _numpy_fold(leaves) -> int:
    """The JAX package's fold (sdc/fingerprint.py), in numpy."""
    acc = np.uint32(2166136261)
    with np.errstate(over="ignore"):
        for i, a in enumerate(leaves):
            if not np.issubdtype(a.dtype, np.floating) or a.size == 0:
                continue
            bits = np.ascontiguousarray(a.astype(np.float32)).view(
                np.uint32)
            s = np.uint32(np.sum(bits, dtype=np.uint64) & 0xFFFFFFFF)
            acc = np.uint32((acc ^ s) * np.uint32(16777619) + np.uint32(i))
    return int(acc)


def test_fingerprint_on_the_card_equals_the_host_fold(cuda):
    rng = np.random.RandomState(2)
    leaves = [rng.randn(32000, 768).astype(np.float32),
              rng.randn(768).astype(np.float32),
              np.arange(5, dtype=np.int32),
              rng.randn(2048, 768).astype(np.float16)]
    want = _numpy_fold(leaves)
    host = [torch.from_numpy(a) for a in leaves]
    card = [t.to(cuda) for t in host]
    assert sdc.fold_fingerprint(card) == sdc.fold_fingerprint(host) == want
    assert sdc.fold_leaf_fingerprints(card) == \
        sdc.fold_leaf_fingerprints(host)
    card[0].view(torch.int32)[7, 7] ^= 1
    assert sdc.fold_fingerprint(card) != want
