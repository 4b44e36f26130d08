"""Autograd through the port's verbs, the in-place verbs, ``allreduce(
compression=)``, ``DistributedOptimizer(fusion_threshold_bytes=)`` and the
config surface (``knobs``, ``describe``, ``resolve``, ``snapshot``), held
to the JAX package.

``allreduce``, ``allgather`` and ``broadcast`` are differentiable, with
the reference's backward (Horovod's ``torch/mpi_ops.py`` autograd
Functions, as the JAX package's torch frontend has them): an allreduce of
the gradient with the same op and scales; a sum-allreduce narrowed to
this rank's rows; a sum-allreduce kept at the root and zero elsewhere.
At size 1 the gradients are checked in this process; on a gloo world of
2 this file is also its own worker (``python
tests/test_torch_port_autograd.py world jax|port`` with the
``HVD_TPU_COORDINATOR_ADDR/SIZE/RANK`` env): one world of each package
runs the same scenarios on integer-valued float inputs, and the
gradients must be equal (tolerance 0).
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scenarios(hvd, torch):
    """The gradients of every scenario, as lists, on this rank."""
    r = hvd.rank()
    out = {}
    x = (torch.arange(4, dtype=torch.float32) + 10 * r).requires_grad_()
    y = hvd.allreduce(x, op=hvd.Sum, name="ag.sum")
    assert y.requires_grad and y.grad_fn is not None
    (y * (torch.arange(4, dtype=torch.float32) + 1 + r)).sum().backward()
    out["allreduce_sum"] = x.grad.tolist()

    x = (torch.arange(6, dtype=torch.float32).reshape(2, 3) * (r + 1)) \
        .requires_grad_()
    y = hvd.allreduce(x, op=hvd.Average, name="ag.avg")
    (y * (2.0 + r)).sum().backward()
    out["allreduce_average"] = x.grad.tolist()

    x = (torch.ones(2 + r, 3) * (r + 1)).requires_grad_()
    g = hvd.allgather(x, name="ag.gather")
    assert g.grad_fn is not None and tuple(g.shape) == (5, 3)
    w = torch.arange(15, dtype=torch.float32).reshape(5, 3) + r
    (g * w).sum().backward()
    out["allgather_ragged"] = x.grad.tolist()

    x = torch.full((2,), float(r + 1)).requires_grad_()
    b = hvd.broadcast(x, root_rank=1, name="ag.bcast")
    assert b.grad_fn is not None
    (b * (r + 2.0)).sum().backward()
    out["broadcast_root1"] = x.grad.tolist()

    p = torch.nn.Parameter(torch.zeros(4))
    p.grad = torch.full((4,), 2.0 + r)
    h = hvd.allreduce_async_(p.grad.data, op=hvd.Sum, name="ag.inplace",
                             prescale_factor=10.0)
    import gc
    gc.collect()   # the temporary wrapper goes; the storage stays
    hvd.synchronize(h)
    out["inplace_async"] = p.grad.tolist()
    return out


def _world_main(which):
    import torch
    if which == "jax":
        import horovod_tpu.torch as hvd
        hvd.init()
    else:
        import horovod_tpu_torch as hvd
        hvd.init(device="cpu")
    try:
        res = _scenarios(hvd, torch)
    finally:
        hvd.shutdown()
    print("RESULT " + json.dumps(res), flush=True)


if __name__ == "__main__" and len(sys.argv) > 2 and sys.argv[1] == "world":
    _world_main(sys.argv[2])
    sys.exit(0)


import pytest  # noqa: E402
import torch  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import config as tconfig  # noqa: E402


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(which, n=2):
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, HVD_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   HVD_TPU_SIZE=str(n), HVD_TPU_RANK=str(rank),
                   HVD_TPU_LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   JAX_PLATFORMS="cpu",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "world", which],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def _collect(procs, timeout):
    deadline = time.monotonic() + timeout
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, e[-4000:]
            line = [ln for ln in o.splitlines() if ln.startswith("RESULT ")]
            assert line, (o[-2000:], e[-2000:])
            out.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            p.kill()
    return out


@pytest.fixture(scope="module")
def worlds():
    """A gloo world of 2 of each package, run concurrently."""
    jax_procs = _spawn("jax")
    port_procs = _spawn("port")
    return _collect(jax_procs, 120), _collect(port_procs, 120)


SCENARIOS = ("allreduce_sum", "allreduce_average", "allgather_ragged",
             "broadcast_root1", "inplace_async")


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_world_of_two_gradients_equal_jax(worlds, scenario, rank):
    """Tolerance 0: every input and weight is integer-valued."""
    jax_res, port_res = worlds
    assert port_res[rank][scenario] == jax_res[rank][scenario]


def test_world_of_two_gradients_by_hand(worlds):
    """The reference's backward rules, written out for rank 0 and 1."""
    _, port = worlds
    # allreduce Sum: sum over ranks of each rank's weights (1.. and 2..)
    assert port[0]["allreduce_sum"] == [3.0, 5.0, 7.0, 9.0]
    # allgather: rank 0 owns rows 0-1, rank 1 rows 2-4; weights summed
    w = np.arange(15, dtype=np.float32).reshape(5, 3)
    assert port[1]["allgather_ragged"] == (2 * w + 1)[2:].tolist()
    # broadcast from 1: sum of both ranks' 2 + r, kept at the root only
    assert port[1]["broadcast_root1"] == [5.0, 5.0]
    assert port[0]["broadcast_root1"] == [0.0, 0.0]
    assert port[0]["inplace_async"] == [50.0] * 4


@pytest.fixture
def world1():
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def test_size_one_gradients_are_identities(world1):
    """As the JAX frontend's single-process pin
    (tests/test_torch_depth.py::test_differentiable_collectives_single_process)."""
    x = torch.arange(4, dtype=torch.float32, requires_grad=True)
    y = hvd.allreduce(x, op=hvd.Sum)
    assert y.requires_grad and y.grad_fn is not None
    (y * torch.tensor([1.0, 2.0, 3.0, 4.0])).sum().backward()
    assert x.grad.tolist() == [1, 2, 3, 4]

    x2 = torch.ones(3, 2, requires_grad=True)
    g = hvd.allgather(x2)
    assert g.grad_fn is not None
    g.sum().backward()
    assert torch.equal(x2.grad, torch.ones(3, 2))

    x3 = torch.ones(2, requires_grad=True)
    b = hvd.broadcast(x3, root_rank=0)
    assert b.grad_fn is not None
    (b * 3.0).sum().backward()
    assert x3.grad.tolist() == [3.0, 3.0]

    x4 = torch.tensor(2.0, requires_grad=True)
    g4 = hvd.allgather(x4)
    (g4 * 5.0).sum().backward()
    assert x4.grad.item() == 5.0


def test_no_graph_without_grad(world1):
    x = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        assert hvd.allreduce(x).grad_fn is None
    assert hvd.allreduce(torch.ones(3)).requires_grad is False


def test_average_gradient_keeps_the_scales(world1):
    x = torch.ones(3, requires_grad=True)
    y = hvd.allreduce(x, op=hvd.Average, prescale_factor=2.0,
                      postscale_factor=3.0)
    assert y.tolist() == [6.0] * 3
    y.sum().backward()
    assert x.grad.tolist() == [6.0] * 3


def test_inplace_verbs_return_the_same_object(world1):
    """As tests/test_torch_depth.py::test_inplace_collectives_single_process
    and ::test_inplace_async_through_temporary_wrapper."""
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert hvd.allreduce_(t, op=hvd.Sum) is t
    assert torch.equal(t, torch.arange(6, dtype=torch.float32).reshape(2, 3))
    t2 = torch.ones(4)
    h = hvd.allreduce_async_(t2, op=hvd.Sum, name="inplace_async")
    assert hvd.synchronize(h) is t2
    b = torch.full((3,), 5.0)
    h = hvd.broadcast_async_(b, root_rank=0)
    assert hvd.synchronize(h) is b and b.tolist() == [5.0] * 3
    import gc
    p = torch.nn.Parameter(torch.zeros(4))
    p.grad = torch.full((4,), 2.0)
    h = hvd.allreduce_async_(p.grad.data, op=hvd.Sum, prescale_factor=10.0)
    gc.collect()
    hvd.synchronize(h)
    assert p.grad.tolist() == [20.0] * 4


@pytest.mark.parametrize("name", ["none", "fp16", "bf16"])
def test_allreduce_compression_matches_jax(world1, name):
    """The JAX frontend compresses at its numpy boundary; at size 1 both
    round the input to the wire dtype and back."""
    import horovod_tpu.torch as jhvd
    x = torch.tensor([1.0, 1.0 / 3.0, 1e-3, 70000.0 if name == "bf16"
                      else 700.0])
    got = hvd.allreduce(x, op=hvd.Sum,
                        compression=getattr(hvd.Compression, name))
    comp = getattr(jhvd.Compression, name)
    want, ctx = comp.compress(x.numpy())
    want = comp.decompress(np.asarray(want), ctx)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
    xg = x.clone().requires_grad_()
    hvd.allreduce(xg, op=hvd.Sum, compression=getattr(hvd.Compression, name)
                  ).sum().backward()
    assert xg.grad.tolist() == [1.0] * 4


def test_fusion_threshold_bytes_plans_the_buckets(world1):
    params = [torch.nn.Parameter(torch.zeros(256)) for _ in range(4)]
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(params, lr=0.1),
        named_parameters=[(f"p{i}", p) for i, p in enumerate(params)],
        fusion_threshold_bytes=2048)
    assert opt.plans[-1][0] == 2048
    assert len(opt.plans[-1][1]) == 2
    with pytest.raises(ValueError, match="eager plane"):
        hvd.DistributedOptimizer(torch.optim.SGD(params, lr=0.1),
                                 axis_name="cross",
                                 fusion_threshold_bytes=2048)


OVERRIDES = {"GEN_BLOCK_SIZE": 4, "GEN_NUM_BLOCKS": 64, "GEN_MAX_SEQS": 3,
             "GEN_PREFILL_CHUNK": 8, "GEN_QUEUE_DEPTH": 5,
             "GEN_DEADLINE_MS": 0.0, "GEN_ASYNC_DEPTH": 0,
             "GEN_PREFIX_CACHE": False, "GEN_SPEC_MODE": "ngram",
             "GEN_SPEC_TOKENS": 3, "GEN_BEAMS": 2,
             "DISAGG_ROLE": "prefill", "DISAGG_WIRE_DTYPE": "bf16",
             "DISAGG_FETCH_TIMEOUT_S": 2.0, "NUM_STREAMS": 2,
             "BATCH_D2D_MEMCOPIES": False, "ADASUM_MODE": "flat"}


def test_one_override_dict_drives_both_packages(monkeypatch):
    from horovod_tpu import config as jconfig
    monkeypatch.setenv("HVD_TPU_FUSION_THRESHOLD", "1048576")
    monkeypatch.setenv("HOROVOD_CACHE_CAPACITY", "7")
    monkeypatch.setenv("HVD_TPU_GEN_BEAMS", "3")
    jc, tc = jconfig.Config(dict(OVERRIDES)), tconfig.Config(dict(OVERRIDES))
    for name in OVERRIDES:
        assert tc.resolve(name) == jc.resolve(name) == (OVERRIDES[name],
                                                        "override")
    for name in ("FUSION_THRESHOLD", "CACHE_CAPACITY", "CYCLE_TIME"):
        assert tc.resolve(name) == jc.resolve(name)
    jc2, tc2 = jconfig.Config(), tconfig.Config()
    assert tc2.resolve("GEN_BEAMS") == jc2.resolve("GEN_BEAMS") \
        == (3, "env HVD_TPU_GEN_BEAMS")
    shared = set(tconfig.knobs()) & set(jconfig.knobs())
    assert set(OVERRIDES) <= shared
    for name in set(OVERRIDES) | {"GEN_BLOCK_SIZE"}:
        assert tconfig.knobs()[name].default == jconfig.knobs()[name].default
    snap = tc.snapshot()
    assert set(snap) == set(tconfig.knobs())
    assert all(snap[n] == OVERRIDES[n] for n in OVERRIDES)


def test_describe_provenance_as_jax(monkeypatch):
    """As tests/test_basics.py::test_config_describe_provenance, and the
    shared knobs' lines equal the JAX package's."""
    from horovod_tpu import config as jconfig
    monkeypatch.setenv("HVD_TPU_FUSION_THRESHOLD", "1048576")
    monkeypatch.setenv("HOROVOD_CACHE_CAPACITY", "7")
    out = tconfig.Config()
    text = tconfig.describe(out)
    lines = {ln.split()[0]: ln for ln in text.splitlines()}
    assert "[env HVD_TPU_FUSION_THRESHOLD]" in lines["HVD_TPU_FUSION_THRESHOLD"]
    assert "1048576" in lines["HVD_TPU_FUSION_THRESHOLD"]
    assert "[env HOROVOD_CACHE_CAPACITY]" in lines["HVD_TPU_CACHE_CAPACITY"]
    out.set("CYCLE_TIME", 9.5)
    lines2 = {ln.split()[0]: ln for ln in tconfig.describe(out).splitlines()}
    assert "[override]" in lines2["HVD_TPU_CYCLE_TIME"]
    assert len(text.splitlines()) == len(tconfig.knobs())
    jout = jconfig.Config()
    jout.set("CYCLE_TIME", 9.5)
    jlines = {ln.split()[0]: ln for ln in jconfig.describe(jout).splitlines()}
    for key in lines2:
        if key in jlines and ("GEN_" in key or "DISAGG_" in key):
            assert lines2[key] == jlines[key]
    assert lines2["HVD_TPU_CYCLE_TIME"] == jlines["HVD_TPU_CYCLE_TIME"]
