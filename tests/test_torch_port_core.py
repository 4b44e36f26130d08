"""The port's host plane (horovod_tpu_torch) against the JAX package:
bucket planning, scale folding, compression, the size-1 gloo world,
DistributedOptimizer, and a 2-process gloo run spawned with the
HVD_TPU_* env contract.

Host-side logic (bucket plans, scales, half rounding) must match the JAX
package exactly. At size 1 the allreduce is an identity, so the wrapped
optimizer must match a bare AdamW bit for bit; sums across 2 processes
are exact for the small integers used here.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu import collectives as jcoll
from horovod_tpu import compression as jcomp
from horovod_tpu import fusion as jfusion
from horovod_tpu_torch import collectives as tcoll
from horovod_tpu_torch import compression as tcomp
from horovod_tpu_torch import fusion as tfusion

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def world():
    hvd.init(device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


@pytest.fixture
def small_buckets_world():
    hvd.init(device="cpu", config_overrides={"FUSION_THRESHOLD": 200})
    try:
        yield
    finally:
        hvd.shutdown()


# -- bucket planning ---------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("threshold", [0, 1, 64, 1000, 4096, 64 << 20])
def test_plan_buckets_matches_jax(seed, threshold):
    rng = np.random.RandomState(seed)
    dtypes = [np.float32, np.float16, np.int32, np.float64, np.int8]
    metas = [(tuple(int(d) for d in rng.randint(1, 12, rng.randint(0, 4))),
              np.dtype(dtypes[rng.randint(len(dtypes))]))
             for _ in range(rng.randint(1, 40))]
    assert tfusion.plan_buckets(metas, threshold) == \
        jfusion.plan_buckets(metas, threshold)


def test_plan_buckets_takes_torch_dtypes():
    metas = [((4, 4), torch.float32), ((8,), torch.bfloat16),
             ((3,), torch.int64)]
    np_metas = [((4, 4), np.float32), ((8,), np.float16), ((3,), np.int64)]
    for threshold in (0, 64, 90, 1 << 20):
        assert tfusion.plan_buckets(metas, threshold) == \
            jfusion.plan_buckets(np_metas, threshold)


def test_bucketed_apply_reassembles_in_order():
    values = [torch.full((n,), float(n)) for n in (3, 5, 2, 7)]
    calls, jcalls = [], []

    def fused(vals, names):
        calls.append(names)
        return [v * 2 for v in vals]

    def jfused(vals, names):
        jcalls.append(names)
        return vals
    out = tfusion.bucketed_apply(values, 40, fused)
    jfusion.bucketed_apply([v.numpy() for v in values], 40, jfused)
    assert [v.tolist() for v in out] == [(v * 2).tolist() for v in values]
    assert calls == jcalls == [["tensor.0", "tensor.1", "tensor.2"],
                               ["tensor.3"]]


# -- scale folding -----------------------------------------------------------

_OPS = {"average": (tcoll.Average, jcoll.Average),
        "sum": (tcoll.Sum, jcoll.Sum)}


@pytest.mark.parametrize("op,nproc,pre,post,dtype", [
    ("average", 4, 1.0, 1.0, np.float32),
    ("average", 3, 2.0, 0.5, np.float16),
    ("sum", 4, 2.0, 3.0, np.float32),
    ("sum", 8, 1.0, 1.0, np.int32),
    ("average", 1, 1.0, 1.0, np.int64),
])
def test_combined_scale_matches_jax(op, nproc, pre, post, dtype):
    t_op, j_op = _OPS[op]
    want = jcoll._combined_scale(j_op, nproc, pre, post, dtype)
    assert tcoll._combined_scale(t_op, nproc, pre, post, dtype) == want
    tdt = getattr(torch, np.dtype(dtype).name)
    assert tcoll._combined_scale(t_op, nproc, pre, post, tdt) == want


@pytest.mark.parametrize("op,nproc,pre,post,dtype", [
    ("average", 2, 1.0, 1.0, np.int32),
    ("sum", 2, 2.0, 1.0, np.int64),
    ("sum", 1, 1.0, 0.5, np.int8),
])
def test_combined_scale_errors_match_jax(op, nproc, pre, post, dtype):
    t_op, j_op = _OPS[op]
    with pytest.raises(ValueError):
        jcoll._combined_scale(j_op, nproc, pre, post, dtype)
    with pytest.raises(ValueError):
        tcoll._combined_scale(t_op, nproc, pre, post, dtype)
    with pytest.raises(ValueError):
        tcoll._combined_scale(t_op, nproc, pre, post,
                              getattr(torch, np.dtype(dtype).name))


def test_resolve_op_errors():
    with pytest.raises(ValueError):
        tcoll._resolve_op(True, tcoll.Sum)
    with pytest.raises(TypeError):
        tcoll._resolve_op(None, "sum")
    assert tcoll._resolve_op(False, None) == tcoll.Sum
    assert tcoll._resolve_op(None, None) == tcoll.Average


# -- compression -------------------------------------------------------------

@pytest.mark.parametrize("name", ["fp16", "fp16_strict", "bf16"])
def test_half_compression_round_trip_matches_jax(name):
    x = np.random.RandomState(7).randn(64).astype(np.float32) * 1e3
    tc = getattr(tcomp.Compression, name)
    jc = getattr(jcomp.Compression, name)
    wire, ctx = tc.compress(torch.from_numpy(x))
    assert wire.dtype == {"fp16": torch.bfloat16, "bf16": torch.bfloat16,
                          "fp16_strict": torch.float16}[name]
    back = tc.decompress(wire, ctx)
    assert back.dtype == torch.float32
    jwire, jctx = jc.compress(x)
    jback = np.asarray(jc.decompress(jwire, jctx))
    np.testing.assert_array_equal(back.numpy(), jback)
    ints = torch.arange(5, dtype=torch.int32)
    iw, ictx = tc.compress(ints)
    assert iw.dtype == torch.int32 and torch.equal(tc.decompress(iw, ictx),
                                                   ints)


def test_none_compression_is_identity():
    x = torch.randn(4)
    wire, ctx = tcomp.Compression.none.compress(x)
    assert wire is x and tcomp.Compression.none.decompress(wire, ctx) is x


# -- size-1 world (gloo) -----------------------------------------------------

def test_size_one_world(world):
    assert hvd.is_initialized()
    assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size()) \
        == (0, 1, 0, 1)
    assert hvd.device() == torch.device("cpu")
    before = tcoll.COUNTS["allreduce"]
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert torch.equal(hvd.allreduce(x), x)
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum, prescale_factor=2.0,
                                     postscale_factor=3.0), 6 * x)
    assert tcoll.COUNTS["allreduce"] == before + 2
    h = hvd.grouped_allreduce_async(
        [x, x.to(torch.bfloat16), torch.arange(3)], op=hvd.Sum)
    outs = hvd.synchronize(h)
    assert [o.dtype for o in outs] == [torch.float32, torch.bfloat16,
                                       torch.int64]
    assert torch.equal(outs[2], torch.arange(3))
    with pytest.raises(ValueError):
        hvd.synchronize(h)
    h = hvd.allreduce_async(x)
    assert isinstance(hvd.poll(h), bool)
    assert torch.equal(hvd.synchronize(h), x)
    with pytest.raises(ValueError):
        hvd.poll(h)
    with pytest.raises(ValueError):
        hvd.allreduce(torch.arange(3), op=hvd.Average,
                      prescale_factor=2.0)
    assert torch.equal(hvd.broadcast(x, root_rank=0), x)
    with pytest.raises(ValueError):
        hvd.broadcast(x, root_rank=1)
    hvd.barrier()


def test_init_twice_and_shutdown_twice():
    hvd.init(device="cpu")
    hvd.init(device="cpu")
    hvd.shutdown()
    hvd.shutdown()
    with pytest.raises(hvd.NotInitializedError):
        hvd.rank()


def test_init_refuses_a_foreign_process_group():
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            hvd.init(device="cpu")
        assert not hvd.is_initialized()
    finally:
        dist.destroy_process_group()


def test_unknown_knob_override_raises():
    with pytest.raises(KeyError):
        hvd.init(device="cpu", config_overrides={"NO_SUCH_KNOB": 1})
    assert not hvd.is_initialized()


# -- DistributedOptimizer ----------------------------------------------------

def _model(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(),
                               torch.nn.Linear(8, 3))


def _data(n, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 6, generator=g), torch.randn(n, 3, generator=g)


def _adamw(model):
    return torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=1e-4)


def _loss(model, x, y):
    return ((model(x) - y) ** 2).mean()


@pytest.mark.parametrize("buckets", ["one_bucket", "small_buckets"])
def test_distributed_optimizer_size_one_equals_adamw(buckets, request):
    request.getfixturevalue("world" if buckets == "one_bucket"
                            else "small_buckets_world")
    ref, dist_model = _model(), _model()
    ref_opt = _adamw(ref)
    opt = hvd.DistributedOptimizer(
        _adamw(dist_model), named_parameters=dist_model.named_parameters())
    n_buckets = len(opt._bucket_members)
    assert n_buckets == (1 if buckets == "one_bucket" else 2)
    before = tcoll.COUNTS["allreduce"]
    for step in range(3):
        x, y = _data(16, seed=step)
        for m, o in ((ref, ref_opt), (dist_model, opt)):
            o.zero_grad()
            _loss(m, x, y).backward()
            o.step()
    assert tcoll.COUNTS["allreduce"] == before + 3 * n_buckets
    for a, b in zip(ref.parameters(), dist_model.parameters()):
        assert torch.equal(a, b)
    opt.remove_hooks()


def test_backward_passes_per_step_accumulates(world):
    ref, dist_model = _model(), _model()
    ref_opt = _adamw(ref)
    opt = hvd.DistributedOptimizer(
        _adamw(dist_model), named_parameters=dist_model.named_parameters(),
        backward_passes_per_step=2)
    x, y = _data(16)
    # reference: the mean of the two half-batch gradients
    ref_opt.zero_grad()
    (0.5 * (_loss(ref, x[:8], y[:8]) + _loss(ref, x[8:], y[8:]))).backward()
    ref_opt.step()
    opt.zero_grad()
    _loss(dist_model, x[:8], y[:8]).backward()
    _loss(dist_model, x[8:], y[8:]).backward()
    opt.step()
    for a, b in zip(ref.parameters(), dist_model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
    # a further two passes fire again; two more before step() must raise
    opt.zero_grad()
    for _ in range(3):
        _loss(dist_model, x, y).backward()
    with pytest.raises(AssertionError, match="backward_passes_per_step"):
        _loss(dist_model, x, y).backward()
    opt.remove_hooks()


def test_unnamed_and_duplicate_parameters_raise(world):
    m = _model()
    named = list(m.named_parameters())
    with pytest.raises(ValueError, match="not named"):
        hvd.DistributedOptimizer(_adamw(m), named_parameters=named[:-1])
    with pytest.raises(ValueError, match="duplicate"):
        hvd.DistributedOptimizer(
            _adamw(m), named_parameters=[("w", p) for _, p in named])
    with pytest.raises(ValueError):
        hvd.DistributedOptimizer(_adamw(m), op=hvd.Sum,
                                 gradient_predivide_factor=2.0)


def test_broadcast_parameters_and_optimizer_state(world):
    m = _model()
    opt = _adamw(m)
    _loss(m, *_data(4)).backward()
    opt.step()
    before = {k: v.clone() for k, v in m.state_dict().items()}
    hvd.broadcast_parameters(m.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k])
    with pytest.raises(ValueError):
        hvd.broadcast_parameters(m.state_dict(), root_rank=3)


# -- two processes, env contract ---------------------------------------------

_WORKER = textwrap.dedent("""
    import json, torch
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    r = hvd.rank()
    x = torch.tensor([r + 1.0, 2.0 * (r + 1)])
    out = {"rank": r, "size": hvd.size(),
           "avg": hvd.allreduce(x).tolist(),
           "sum": hvd.allreduce(x, op=hvd.Sum).tolist()}
    g = hvd.grouped_allreduce([x.to(torch.bfloat16), torch.tensor([r + 1])],
                              op=hvd.Sum)
    out["grouped"] = [g[0].float().tolist(), g[1].tolist()]
    out["bcast"] = hvd.broadcast(torch.tensor([10.0 * r]), root_rank=1).tolist()
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 2)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.5),
        named_parameters=model.named_parameters())
    gen = torch.Generator().manual_seed(100 + r)
    xb, yb = torch.randn(5, 4, generator=gen), torch.randn(5, 2, generator=gen)
    ((model(xb) - yb) ** 2).mean().backward()
    opt.step()
    out["params"] = [p.tolist() for p in model.parameters()]
    hvd.barrier()
    hvd.shutdown()
    print(json.dumps(out))
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_average_and_sum():
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, HVD_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   HVD_TPU_SIZE="2", HVD_TPU_RANK=str(rank),
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        finally:
            p.kill()
        assert p.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    results.sort(key=lambda r: r["rank"])
    for r in results:
        assert r["size"] == 2
        assert r["avg"] == [1.5, 3.0]
        assert r["sum"] == [3.0, 6.0]
        assert r["grouped"] == [[3.0, 6.0], [3]]
        assert r["bcast"] == [10.0]
    assert results[0]["params"] == results[1]["params"]

    # the same step in one process, on the mean of both ranks' gradients
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 2)
    grads = []
    for rank in range(2):
        model.zero_grad()
        gen = torch.Generator().manual_seed(100 + rank)
        xb, yb = torch.randn(5, 4, generator=gen), torch.randn(
            5, 2, generator=gen)
        ((model(xb) - yb) ** 2).mean().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
    with torch.no_grad():
        want = [p - 0.5 * (g0 + g1) / 2 for p, g0, g1 in
                zip(model.parameters(), *grads)]
    for got, w in zip(results[0]["params"], want):
        np.testing.assert_allclose(np.array(got), w.numpy(), rtol=0,
                                   atol=1e-6)
