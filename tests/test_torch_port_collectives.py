"""The port's collective API and host plane (horovod_tpu_torch) against the
JAX package.

In one process: the request wire format and its fingerprint byte for byte,
the response cache's eviction order, the error messages, Adasum's pairwise
rule and tree, the size-1 verbs against the JAX package's own size-1
eager verbs, the exported surface, SyncBatchNorm and sparse reduction.

Across processes: this file is also the worker. Run as a script it joins
a gloo world through the ``HVD_TPU_*`` env contract and checks every verb
against numpy (every rank builds every rank's seeded inputs), then prints
one ``RESULT`` line; the tests below spawn it at n = 2, 3 and 4 and hold
its Adasum outputs against the JAX package's ``adasum_tree`` on the
stacked per-rank inputs. Tolerances: integer-valued data makes every sum,
min, max and product exact; Adasum fp32 within rtol 1e-6 (plus 1e-6
absolute, for elements that cancel), bf16 within 1 ulp; SyncBatchNorm
within 1e-5 of nn.BatchNorm on the global batch (E[x²] - E[x]² against
the two-pass variance).
"""

import json
import os
import select
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import adasum as tadasum  # noqa: E402
from horovod_tpu_torch import collectives as tcoll  # noqa: E402
from horovod_tpu_torch import response_cache as tcache  # noqa: E402
from horovod_tpu_torch import stall as tstall  # noqa: E402
from horovod_tpu_torch import tensor_table as ttable  # noqa: E402
from horovod_tpu_torch.exceptions import (  # noqa: E402
    DuplicateNameError, StallError, TensorValidationError)

# ---------------------------------------------------------------------------
# seeded per-rank inputs, shared by the workers and the tests
# ---------------------------------------------------------------------------


def _ints(seed, shape, lo=-4, hi=5, dtype=torch.float32):
    a = np.random.RandomState(seed).randint(lo, hi, size=shape)
    return torch.from_numpy(a).to(dtype)


def _normal(seed, shape, dtype=torch.float32):
    a = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(a).to(dtype)


def _adasum_inputs(rank):
    return [_normal(100 + rank, (5, 3)),
            _normal(200 + rank, (7,), torch.bfloat16)]


def _splits(rank, n):
    return [(rank + j) % 3 for j in range(n)]


def _a2a_rows(rank, n):
    """Rank ``rank``'s alltoall input: rows valued 100·rank + destination."""
    return torch.cat([torch.full((s, 2), 100.0 * rank + j)
                      for j, s in enumerate(_splits(rank, n))])


def _join_steps(rank):
    return 2 + rank


def _join_batch(rank, step):
    g = torch.Generator().manual_seed(1000 * rank + step)
    return torch.randn(6, 4, generator=g), torch.randn(6, 2, generator=g)


def _join_model():
    torch.manual_seed(5)
    return torch.nn.Linear(4, 2)


# ---------------------------------------------------------------------------
# the worker (run as a script, one process per rank)
# ---------------------------------------------------------------------------

def _check_verbs(r, n):
    """Every verb against numpy; raises AssertionError on a mismatch."""
    stack = [_ints(r2, (3, 4)) for r2 in range(n)]
    x = stack[r]
    s = torch.stack(stack)
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum), s.sum(0))
    assert torch.equal(hvd.allreduce(x), s.sum(0) * (1.0 / n))
    assert torch.equal(hvd.allreduce(x, op=hvd.Min), s.min(0).values)
    assert torch.equal(hvd.allreduce(x, op=hvd.Max), s.max(0).values)
    assert torch.equal(hvd.allreduce(x, op=hvd.Product), s.prod(0))
    # halves accumulate in fp32 for every op; ints reduce exactly
    xb = x.to(torch.bfloat16)
    xi = _ints(50 + r, (6,), 0, 9, torch.int32)
    si = torch.stack([_ints(50 + r2, (6,), 0, 9, torch.int32)
                      for r2 in range(n)])
    g = hvd.grouped_allreduce([x, xb, xi], op=hvd.Sum, name="grouped.sum")
    assert torch.equal(g[0], s.sum(0))
    assert g[1].dtype == torch.bfloat16
    assert torch.equal(g[1], s.sum(0).to(torch.bfloat16))
    assert g[2].dtype == torch.int32 and torch.equal(g[2], si.sum(0))
    g = hvd.grouped_allreduce([x, xb], op=hvd.Average, prescale_factor=0.5,
                              postscale_factor=4.0)
    want = s.sum(0) * (2.0 / n)
    assert torch.equal(g[0], want) and torch.equal(g[1], want.bfloat16())
    assert torch.equal(hvd.grouped_allreduce([xb], op=hvd.Product)[0],
                       s.prod(0).bfloat16())

    # ragged allgather: rank k gives k rows (rank 0 none), and a 0-d value
    rows = [_ints(300 + r2, (r2, 3)) for r2 in range(n)]
    assert torch.equal(hvd.allgather(rows[r]), torch.cat(rows))
    assert torch.equal(hvd.allgather(rows[r].to(torch.bfloat16)),
                       torch.cat(rows).bfloat16())
    assert torch.equal(hvd.allgather(torch.tensor(float(r))),
                       torch.arange(n, dtype=torch.float32))

    root = n - 1
    assert torch.equal(hvd.broadcast(x, root_rank=root), stack[root])
    y = x.clone()
    assert hvd.broadcast_(y, root_rank=root) is y and torch.equal(
        y, stack[root])
    gb = hvd.grouped_broadcast([x, xi, xb], root_rank=1)
    assert torch.equal(gb[0], stack[1]) and torch.equal(gb[2],
                                                        stack[1].bfloat16())
    assert torch.equal(gb[1], si[1])

    # alltoall with uneven splits, then the default even split
    got = hvd.alltoall(_a2a_rows(r, n), splits=_splits(r, n))
    want = torch.cat([torch.full((_splits(src, n)[r], 2), 100.0 * src + r)
                      for src in range(n)])
    assert torch.equal(got, want)
    even = torch.arange(2 * n, dtype=torch.float32) + 10 * r
    want = torch.cat([torch.arange(2 * r, 2 * r + 2,
                                   dtype=torch.float32) + 10 * src
                      for src in range(n)])
    assert torch.equal(hvd.alltoall(even), want)

    # async handles: several in flight, resolved out of order
    hs = [hvd.allreduce_async(x * k, op=hvd.Sum, name=f"async.{k}")
          for k in range(3)]
    for k in reversed(range(3)):
        assert torch.equal(hvd.synchronize(hs[k]), s.sum(0) * k)
    h = hvd.broadcast_async(x, root_rank=0, name="released")
    deadline = time.monotonic() + 30
    while not hvd.poll(h):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    hvd.release(h)
    try:
        hvd.synchronize(h)
        raise AssertionError("a released handle synchronized")
    except ValueError:
        pass

    # objects
    obj = {"rank": r, "payload": list(range(r + 1))}
    assert hvd.broadcast_object(obj, root_rank=root)["rank"] == root
    assert [o["rank"] for o in hvd.allgather_object(obj)] == list(range(n))

    # sparse: rank k gives rows k and k+1 of an (n+1, 2) dense tensor
    idx = torch.tensor([r, r + 1])
    vals = torch.full((2, 2), float(r + 1))
    sp = hvd.allreduce_sparse(hvd.SparseGradient(idx, vals, (n + 1, 2)),
                              average=False)
    dense = torch.zeros(n + 1, 2)
    for r2 in range(n):
        dense[r2:r2 + 2] += r2 + 1
    assert torch.equal(hvd.sparse_to_dense(sp), dense)
    assert torch.equal(hvd.allreduce_sparse_as_dense(
        hvd.SparseGradient(idx, vals, (n + 1, 2)), average=False), dense)

    mean, var = hvd.sync_batch_norm_stats(x)
    assert torch.allclose(mean, s.reshape(-1, 4).mean(0), atol=1e-6)
    assert torch.allclose(var, s.reshape(-1, 4).var(0, unbiased=False),
                          atol=1e-5)


def _check_cuda_inputs(r, n):
    """On NCCL: the ragged allgather, uneven alltoall and a mixed-dtype
    fused reduction on CUDA tensors."""
    dev = hvd.device()
    rows = [_ints(300 + r2, (r2, 3)) for r2 in range(n)]
    got = hvd.allgather(rows[r].to(dev))
    assert got.is_cuda and torch.equal(got.cpu(), torch.cat(rows))
    got = hvd.alltoall(_a2a_rows(r, n).to(dev), splits=_splits(r, n))
    want = torch.cat([torch.full((_splits(src, n)[r], 2), 100.0 * src + r)
                      for src in range(n)])
    assert got.is_cuda and torch.equal(got.cpu(), want)
    stack = torch.stack([_ints(r2, (3, 4)) for r2 in range(n)])
    g = hvd.grouped_allreduce([stack[r].to(dev), stack[r].to(dev).half()],
                              op=hvd.Max)
    assert torch.equal(g[0].cpu(), stack.max(0).values)
    assert torch.equal(g[1].cpu(), stack.max(0).values.half())


def _check_sync_batch_norm(r, n):
    xs = [_normal(400 + r2, (4, 3, 5)) for r2 in range(n)]
    gs = [_normal(500 + r2, (4, 3, 5)) for r2 in range(n)]
    bn = hvd.SyncBatchNorm(3)
    x = xs[r].clone().requires_grad_()
    y = bn(x)
    (y * gs[r]).sum().backward()
    # nn.BatchNorm on the global batch, under the sum of every rank's loss
    ref = torch.nn.BatchNorm1d(3)
    xa = torch.cat(xs).requires_grad_()
    out = ref(xa)
    (out * torch.cat(gs)).sum().backward()
    rows = slice(4 * r, 4 * r + 4)
    assert (y - out[rows]).abs().max().item() <= 1e-5
    assert (x.grad - xa.grad[rows]).abs().max().item() <= 1e-5
    assert (bn.running_mean - ref.running_mean).abs().max().item() <= 1e-6
    assert (bn.running_var - ref.running_var).abs().max().item() <= 1e-5


def _check_failures(r, n):
    """Misuse raises on every rank and leaves the world usable."""
    x = _ints(r, (3, 4))
    try:
        hvd.allreduce(torch.ones(2 + r), name="mismatch")
        raise AssertionError("a shape mismatch went through")
    except TensorValidationError as e:
        assert "Mismatched metadata" in str(e), e
    h = hvd.allreduce_async(x, name="dup")
    try:
        hvd.allreduce_async(x, name="dup")
        raise AssertionError("a duplicate name went through")
    except DuplicateNameError:
        pass
    hvd.synchronize(h)
    try:
        hvd.allreduce(x, op=hvd.Min, prescale_factor=2.0)
        raise AssertionError("a scaled Min went through")
    except ValueError:
        pass
    # the world still agrees after the failures
    want = sum(_ints(r2, (3, 4)) for r2 in range(n))
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum, name="after"), want)


def _check_process_sets(r):
    """n = 4, sets [[0, 1], [2, 3]]: every verb stays inside its set."""
    mine, other = (0, 1) if r < 2 else (1, 0)
    ps = hvd.process_set_mesh(mine)
    members = [0, 1] if r < 2 else [2, 3]
    x = torch.full((3,), float(r + 1))
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum, process_set=ps),
                       torch.full((3,), float(sum(m + 1 for m in members))))
    assert torch.equal(hvd.broadcast(x, root_rank=1, process_set=ps),
                       torch.full((3,), float(members[1] + 1)))
    assert torch.equal(hvd.allgather(x[:1], process_set=ps),
                       torch.tensor([m + 1.0 for m in members]))
    try:
        hvd.allreduce(x, process_set=hvd.process_set_mesh(other))
        raise AssertionError("a non-member reduced over a set")
    except ValueError:
        pass


def _train_with_join(r, n):
    """Uneven data: rank k trains 2 + k steps, then joins; the last rank's
    parameters are broadcast to all."""
    model = _join_model()
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    for step in range(_join_steps(r)):
        xb, yb = _join_batch(r, step)
        opt.zero_grad()
        ((model(xb) - yb) ** 2).mean().backward()
        opt.step()
    last = hvd.join()
    assert hvd.joined()
    hvd.broadcast_parameters(model.state_dict(), root_rank=last)
    opt.remove_hooks()
    return last, [p.detach().reshape(-1).tolist()
                  for p in model.parameters()]


def _train_adasum(r):
    """op=Adasum in a world of more than one process: the delta
    optimizer, two SGD steps on each rank's own data."""
    model = _join_model()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), op=hvd.Adasum)
    assert type(opt).__name__ == "_DistributedAdasumDeltaOptimizer"
    for step in range(2):
        xb, yb = _join_batch(r, step)
        opt.zero_grad()
        ((model(xb) - yb) ** 2).mean().backward()
        refused = False
        try:
            opt.zero_grad()
        except AssertionError as e:
            refused = "races with the in-flight delta" in str(e)
        assert refused, "zero_grad between backward and step went through"
        opt.step()
    opt.remove_hooks()
    return [p.detach().reshape(-1).tolist() for p in model.parameters()]


def _worker(mode: str) -> int:
    n = int(os.environ["HVD_TPU_SIZE"])
    if mode == "stall":
        hvd.init(process_sets=[list(range(n))], device="cpu")
        r = hvd.rank()
        hvd.allreduce(torch.ones(3), name="warm")
        t0 = time.monotonic()
        try:
            if r == n - 1:
                # this rank skips "a": its next collective runs over the
                # process set (another communicator), which the others,
                # waiting in "a" over the world, never join
                hvd.allreduce(torch.ones(3), name="b",
                              process_set=hvd.process_set_mesh(0))
            else:
                hvd.allreduce(torch.ones(3), name="a")
            result = "completed"
        except StallError:
            result = "stall"
        print("RESULT " + json.dumps(
            {"rank": r, "result": result,
             "seconds": time.monotonic() - t0}), flush=True)
        # the world is wedged by design: wait for the test to kill every
        # rank once all have reported (a rank that left early would take
        # the rendezvous store and its gloo pairs down under its peers)
        time.sleep(120)
        return 1
    # "verbs": gloo on the CPU; "verbs-nccl": one card per rank (the
    # CPU inputs below are staged to the card, plus _check_cuda_inputs)
    hvd.init(process_sets=[[0, 1], [2, 3]] if n == 4 else None,
             device=None if mode == "verbs-nccl" else "cpu")
    r = hvd.rank()
    assert hvd.size() == n and hvd.cross_size() == n
    if mode == "verbs-nccl":
        _check_cuda_inputs(r, n)
    _check_verbs(r, n)
    _check_sync_batch_norm(r, n)
    _check_failures(r, n)
    if n == 4:
        _check_process_sets(r)
    out = {"rank": r}
    xs = _adasum_inputs(r)
    try:
        a = hvd.grouped_allreduce(xs, op=hvd.Adasum, prescale_factor=0.5,
                                  postscale_factor=2.0, name="adasum")
        out["adasum"] = [t.float().tolist() for t in a]
    except ValueError as e:
        out["adasum_error"] = str(e)
    else:
        out["adasum_params"] = _train_adasum(r)
    out["join_last"], out["join_params"] = _train_with_join(r, n)
    hvd.barrier()
    hvd.shutdown()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _result_line(p, deadline):
    """The worker's RESULT line, read as soon as it is printed (the worker
    prints nothing else on stdout)."""
    while True:
        left = deadline - time.monotonic()
        assert left > 0, "no RESULT line before the time limit"
        ready, _, _ = select.select([p.stdout], [], [], left)
        if not ready:
            continue
        line = p.stdout.readline()
        if not line:
            p.kill()
            raise AssertionError(p.stderr.read()[-4000:])
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])


def _spawn(n, mode, timeout, extra_env=None):
    """Run the worker as ``n`` ranks; returns their results by rank. A
    "verbs" world must also exit cleanly; a "stall" world is wedged by
    design and is killed once every rank has reported."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, HVD_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   HVD_TPU_SIZE=str(n), HVD_TPU_RANK=str(rank),
                   HVD_TPU_LOCAL_RANK=str(rank),
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""), **(extra_env or {}))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    deadline = time.monotonic() + timeout
    try:
        results = [_result_line(p, deadline) for p in procs]
        if mode != "stall":
            for p in procs:
                _, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
                assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    return sorted(results, key=lambda r: r["rank"])


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    _, e = np.frexp(np.maximum(np.abs(x), np.float32(2.0 ** -126)))
    return np.ldexp(np.float32(1.0), e - 8)


def _replay_join(n):
    """The uneven-data run in one process: each step averages (over n)
    the gradients of the ranks that still have data."""
    model = _join_model()
    for step in range(max(_join_steps(r) for r in range(n))):
        grads = []
        for r in range(n):
            if step >= _join_steps(r):
                continue
            model.zero_grad()
            xb, yb = _join_batch(r, step)
            ((model(xb) - yb) ** 2).mean().backward()
            grads.append([p.grad.clone() for p in model.parameters()])
        with torch.no_grad():
            for i, p in enumerate(model.parameters()):
                p -= 0.1 * (sum(g[i] for g in grads) * (1.0 / n))
    return [p.detach().reshape(-1).numpy() for p in model.parameters()]


def _replay_adasum(n, adasum_tree):
    """The delta optimizer's two steps in one process: every rank's SGD
    delta, Adasum-combined by ``adasum_tree`` (numpy in, array out)."""
    model = _join_model()
    for step in range(2):
        deltas = []
        for r in range(n):
            model.zero_grad()
            xb, yb = _join_batch(r, step)
            ((model(xb) - yb) ** 2).mean().backward()
            deltas.append([-0.1 * p.grad for p in model.parameters()])
        with torch.no_grad():
            for i, p in enumerate(model.parameters()):
                stacked = np.stack([d[i].numpy() for d in deltas])
                p += torch.from_numpy(np.array(adasum_tree(stacked)))
    return [p.detach().reshape(-1).numpy() for p in model.parameters()]


@pytest.mark.parametrize("n", [2, 3, 4])
def test_gloo_world_every_verb(n):
    import jax.numpy as jnp
    from horovod_tpu.adasum import adasum_tree
    results = _spawn(n, "verbs", timeout=150)
    assert [r["rank"] for r in results] == list(range(n))
    if n & (n - 1):
        # n = 3: Adasum raises ValueError on every rank
        for r in results:
            assert "power-of-two" in r["adasum_error"]
        _check_replays(results, n, None)
    else:
        inputs = [_adasum_inputs(r) for r in range(n)]
        for i, dt in enumerate([np.float32, jnp.bfloat16]):
            stacked = np.stack([inputs[r][i].float().numpy()
                                for r in range(n)]).astype(dt)
            want = np.asarray(adasum_tree((stacked * 0.5).astype(dt))
                              * 2.0).astype(dt).astype(np.float32)
            for r in results:
                got = np.asarray(r["adasum"][i], np.float32)
                if dt == np.float32:
                    np.testing.assert_allclose(got, want, rtol=1e-6,
                                               atol=1e-6)
                else:
                    assert (np.abs(got - want) <= _bf16_ulp(want)).all()
        _check_replays(results, n, adasum_tree)


def _check_replays(results, n, adasum_tree):
    """The Adasum delta optimizer (when ``adasum_tree`` is given) and Join:
    every rank lands on the one-process replay's parameters; for Join the
    last to join is the rank with the most data and every rank agrees."""
    if adasum_tree is not None:
        want = _replay_adasum(n, adasum_tree)
        for r in results:
            for got, w in zip(r["adasum_params"], want):
                np.testing.assert_allclose(np.asarray(got, np.float32), w,
                                           rtol=0, atol=1e-6)
    want = _replay_join(n)
    for r in results:
        assert r["join_last"] == n - 1
        for got, w in zip(r["join_params"], want):
            np.testing.assert_allclose(np.asarray(got, np.float32), w,
                                       rtol=0, atol=1e-6)
        assert r["join_params"] == results[0]["join_params"]


@pytest.mark.cuda
def test_nccl_world_every_verb():
    """The same worker on NCCL, one card per rank: the gloo checks with
    CPU inputs staged to each card, plus CUDA inputs. Needs two or more
    GPUs (run it on a 4-card machine); Adasum is held to the port's own
    tree here (the card's machine has no JAX)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    n = 4 if cards >= 4 else 2
    results = _spawn(n, "verbs-nccl", timeout=300)
    inputs = [_adasum_inputs(r) for r in range(n)]
    for i in range(2):
        stacked = torch.stack([inputs[r][i] for r in range(n)])
        dt = stacked.dtype
        want = (tadasum.adasum_tree((stacked * 0.5).to(dt)) * 2.0).to(
            dt).float().numpy()
        for r in results:
            got = np.asarray(r["adasum"][i], np.float32)
            if dt == torch.float32:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            else:
                assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    _check_replays(results, n, lambda s: tadasum.adasum_tree(
        torch.from_numpy(s)).numpy())


@pytest.mark.parametrize("n", [2, 4])
def test_gloo_stall_raises_on_every_rank(n):
    results = _spawn(n, "stall", timeout=90, extra_env={
        "HVD_TPU_STALL_CHECK_TIME_SECONDS": "1",
        "HVD_TPU_STALL_SHUTDOWN_TIME_SECONDS": "2"})
    for r in results:
        assert r["result"] == "stall", r
        assert 2.0 <= r["seconds"] < 30.0, r


# ---------------------------------------------------------------------------
# one process: host logic against the JAX package
# ---------------------------------------------------------------------------

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16, "int32": torch.int32,
                 "int64": torch.int64, "bool": torch.bool}


def _jax_dtype(name):
    import jax.numpy as jnp
    return np.dtype(jnp.bfloat16) if name == "bfloat16" else np.dtype(name)


@pytest.mark.parametrize("dtype", sorted(_TORCH_DTYPES))
def test_wire_format_and_fingerprint_match_jax(dtype):
    from horovod_tpu import tensor_table as jtable
    rng = np.random.RandomState(sorted(_TORCH_DTYPES).index(dtype))
    kinds = ["allreduce", "allgather", "broadcast", "alltoall",
             "grouped_allreduce", "grouped_broadcast"]
    for i in range(40):
        name = "".join(rng.choice(list("abcxyz._0189é"), rng.randint(0, 30)))
        shape = tuple(int(d) for d in rng.randint(0, 5000,
                                                  rng.randint(0, 6)))
        kind = kinds[rng.randint(len(kinds))]
        extra = ["", "average", "sum", "3", f"{shape}|('{dtype}',)|min"][
            rng.randint(5)]
        rank = int(rng.randint(0, 64))
        tb = ttable.pack_request(name, shape, _TORCH_DTYPES[dtype], kind,
                                 extra, rank=rank)
        jb = jtable.pack_request(name, shape, _jax_dtype(dtype), kind,
                                 extra, rank=rank)
        assert tb == jb
        assert ttable.metadata_fingerprint(
            name, shape, _TORCH_DTYPES[dtype], kind, extra) == \
            jtable.metadata_fingerprint(name, shape, _jax_dtype(dtype),
                                        kind, extra)
        assert ttable.unpack_request(jb) == jtable.unpack_request(tb)
    # a grouped request carries the word "grouped" where a dtype would be
    assert ttable.pack_request("g", (3,), "grouped", "grouped_allreduce") \
        == jtable.pack_request("g", (3,), "grouped", "grouped_allreduce")


def test_unpack_request_rejects_truncated_messages():
    msg = ttable.pack_request("name", (2, 3), torch.float32, "allreduce")
    for cut in (0, 3, len(msg) - 1):
        with pytest.raises(ValueError, match="malformed"):
            ttable.unpack_request(msg[:cut])


@pytest.mark.parametrize("capacity", [0, 1, 3, 8])
def test_response_cache_evicts_as_jax(capacity):
    from horovod_tpu import response_cache as jcache
    t, j = tcache.ResponseCache(capacity), jcache.ResponseCache(capacity)
    rng = np.random.RandomState(capacity)
    for _ in range(400):
        key = int(rng.randint(0, 12)) << 32 | int(rng.randint(0, 3))
        if rng.rand() < 0.5:
            assert t.lookup(key) == j.lookup(key)
        else:
            assert t.put(key) == j.put(key)
        assert len(t) == len(j)


def test_duplicate_name_message_matches_jax():
    from horovod_tpu import tensor_table as jtable

    class _W:
        stall_inspector = None
    tt = ttable.TensorTable(_W())
    h = tt.begin("grad.0", "allreduce")
    with pytest.raises(DuplicateNameError) as te:
        tt.begin("grad.0", "allreduce")
    assert str(te.value) == jtable.TensorTable._dup_msg("allreduce",
                                                         "grad.0")
    tt.finish(h)
    assert tt.pending_count() == 0
    tt.finish(tt.begin("grad.0", "allreduce"))


@pytest.mark.parametrize("op", ["min", "max", "product"])
@pytest.mark.parametrize("pre,post", [(2.0, 1.0), (1.0, 0.5)])
def test_scaled_min_max_product_error_matches_jax(op, pre, post):
    from horovod_tpu import collectives as jcoll
    with pytest.raises(ValueError) as je:
        jcoll._combined_scale(jcoll.ReduceOp(op), 2, pre, post, np.float32)
    with pytest.raises(ValueError) as te:
        tcoll._combined_scale(tcoll.ReduceOp(op), 2, pre, post,
                              torch.float32)
    assert str(te.value) == str(je.value)
    assert tcoll._combined_scale(tcoll.ReduceOp(op), 2, 1.0, 1.0,
                                 torch.int32) == 1.0


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adasum_pair_and_tree_match_jax(n, dtype):
    from horovod_tpu import adasum as jadasum
    rng = np.random.RandomState(n)
    stacked = rng.randn(n, 33, 5).astype(np.float32)
    stacked[:, 0] = 0.0                  # rows that are zero everywhere
    if n > 1:
        stacked[1] = 0.0                 # a zero contribution: ‖b‖ = 0
    ts = torch.from_numpy(stacked).to(_TORCH_DTYPES[dtype])
    js = stacked.astype(_jax_dtype(dtype))
    got = tadasum.adasum_tree(ts).float().numpy()
    want = np.asarray(jadasum.adasum_tree(js)).astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all()
    if n >= 2:
        pair = tadasum.adasum_pair(ts[0], ts[1]).float().numpy()
        jpair = np.asarray(jadasum.adasum_pair(js[0], js[1])).astype(
            np.float32)
        tol = 1e-6 if dtype == "float32" else _bf16_ulp(jpair)
        assert (np.abs(pair - jpair) <= tol + 1e-6 * np.abs(jpair)).all()


def test_adasum_tree_refuses_three():
    with pytest.raises(ValueError, match="power-of-two"):
        tadasum.adasum_tree(torch.ones(3, 2))


def test_exports_cover_the_jax_collective_surface():
    import ast
    tree = ast.parse(open(os.path.join(ROOT, "horovod_tpu",
                                       "__init__.py")).read())
    names = [a.name for node in tree.body
             if isinstance(node, ast.ImportFrom)
             and node.module in ("basics", "collectives")
             for a in node.names]
    assert len(names) > 40
    assert [n for n in names if not hasattr(hvd, n)] == []
    for extra in ("broadcast_object", "allgather_object", "SyncBatchNorm",
                  "sync_batch_norm_stats", "SparseGradient",
                  "allreduce_sparse", "allreduce_sparse_as_dense",
                  "sparse_to_dense", "DistributedOptimizer"):
        assert hasattr(hvd, extra), extra


@pytest.fixture
def world():
    hvd.init(process_sets=[[0]], device="cpu")
    try:
        yield
    finally:
        hvd.shutdown()


def test_size_one_queries(world):
    assert (hvd.cross_rank(), hvd.cross_size()) == (0, 1)
    assert (hvd.device_count(), hvd.local_device_count(), hvd.dp_size()) \
        == (1, 1, 1)
    assert hvd.is_homogeneous() and hvd.hostname()
    assert hvd.gloo_built() and not hvd.mpi_built() and not hvd.xla_built()
    assert not hvd.tpu_available() and not hvd.mpi_enabled()
    assert hvd.nccl_built() == torch.distributed.is_nccl_available()
    assert hvd.cuda_built() == torch.backends.cuda.is_built()
    ps = hvd.process_set_mesh(0)
    assert ps.ranks == (0,) and ps.is_member and ps.my_index == 0


def _pair(seed, shape, dtype):
    t = _ints(seed, shape, dtype=_TORCH_DTYPES[dtype])
    return t, t.float().numpy().astype(_jax_dtype(dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_size_one_verbs_match_jax(world, hvd_world, dtype):
    jhvd = hvd_world
    x, jx = _pair(1, (5, 3), dtype)
    y, jy = _pair(2, (4,), dtype)
    np.testing.assert_array_equal(_np(hvd.allgather(x)),
                                  _np(jhvd.allgather(jx)))
    np.testing.assert_array_equal(_np(hvd.alltoall(x, splits=[5])),
                                  _np(jhvd.alltoall(jx, splits=[5])))
    np.testing.assert_array_equal(_np(hvd.broadcast(x, 0)),
                                  _np(jhvd.broadcast(jx, 0)))
    for got, want in zip(hvd.grouped_broadcast([x, y], 0),
                         jhvd.grouped_broadcast([jx, jy], 0)):
        np.testing.assert_array_equal(_np(got), _np(want))
    for op in ("min", "max", "product"):
        got = hvd.grouped_allreduce([x, y], op=tcoll.ReduceOp(op))
        want = jhvd.grouped_allreduce([jx, jy], op=jhvd.ReduceOp(op))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), _np(w))
    for op in ("adasum", "sum", "average"):
        got = hvd.grouped_allreduce([x, y], op=tcoll.ReduceOp(op),
                                    prescale_factor=0.5,
                                    postscale_factor=4.0)
        want = jhvd.grouped_allreduce([jx, jy], op=jhvd.ReduceOp(op),
                                      prescale_factor=0.5,
                                      postscale_factor=4.0)
        for g, w in zip(got, want):
            assert g.dtype == x.dtype
            np.testing.assert_array_equal(_np(g), _np(w))
    ps = hvd.process_set_mesh(0)
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum, process_set=ps), x)


def test_size_one_join_and_handles(world):
    x = torch.arange(4.0)
    assert hvd.join_round() == 1 and not hvd.joined()
    h = hvd.allreduce_async(x, op=hvd.Sum, name="before.join")
    assert hvd.join() == 0 and hvd.joined()
    assert hvd.join_round() == 0
    # submitted before join(): real data; after: zeros
    assert torch.equal(hvd.synchronize(h), x)
    assert torch.equal(hvd.allreduce(x, op=hvd.Sum), torch.zeros(4))
    assert torch.equal(hvd.allgather(x), x)
    with pytest.raises(ValueError):
        hvd.poll(h)
    hvd.release(h)       # unknown handle: nothing to do


def test_size_one_misuse(world):
    x = torch.ones(3)
    h = hvd.allgather_async(x, name="dup")
    with pytest.raises(DuplicateNameError):
        hvd.allgather_async(x, name="dup")
    hvd.synchronize(h)
    with pytest.raises(ValueError, match="splits"):
        hvd.alltoall(x, splits=[2])
    with pytest.raises(ValueError, match="root_rank"):
        hvd.grouped_broadcast([x], root_rank=1)
    with pytest.raises(ValueError, match="only supported"):
        hvd.grouped_allreduce([x], op=hvd.Max, postscale_factor=2.0)
    with pytest.raises(ValueError, match="integer"):
        hvd.allreduce(torch.arange(3), op=hvd.Adasum, prescale_factor=2.0)
    # the table is empty again: the names are free
    assert hvd.basics.world().tensor_table.pending_count() == 0


def test_dispatcher_keeps_one_order_across_threads(world):
    import threading
    outs, errs = {}, []

    def submit(k):
        try:
            outs[k] = hvd.allreduce(torch.full((2,), float(k)), op=hvd.Sum,
                                    name=f"thread.{k}")
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(e)
    threads = [threading.Thread(target=submit, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert errs == []
    assert all(torch.equal(outs[k], torch.full((2,), float(k)))
               for k in range(8))
    w = hvd.basics.world()
    hvd.shutdown()
    assert not w.dispatcher._thread.is_alive()
    hvd.init(device="cpu")


def test_shutdown_fails_queued_work_instead_of_hanging():
    hvd.init(device="cpu")
    d = tcoll._dispatcher(hvd.basics.world())
    hvd.shutdown()
    h = ttable.Handle(0, "late")
    d.submit(h, lambda: 1)
    assert h.event.is_set() and isinstance(h.error,
                                           hvd.HorovodInternalError)


def test_stall_inspector_deadline_and_stop():
    from horovod_tpu_torch import config as C

    class _W:
        config = C.Config({C.STALL_CHECK_TIME_SECONDS: 0.1,
                           C.STALL_SHUTDOWN_TIME_SECONDS: 0.2})
    insp = tstall.StallInspector(_W())
    try:
        insp.record_submit("late")
        deadline = time.monotonic() + 10
        while not insp._shutdown_deadline_hit:
            assert time.monotonic() < deadline, "deadline never hit"
            time.sleep(0.02)
        with pytest.raises(StallError):
            insp.check_shutdown()
    finally:
        insp.stop()
    assert insp._thread is None and not insp._pending
    insp.check_shutdown()     # cleared by stop()
    insp.stop()


@pytest.mark.parametrize("affine", [True, False])
def test_sync_batch_norm_size_one_matches_batch_norm(world, affine):
    x = _normal(7, (6, 4, 5))
    g = _normal(8, (6, 4, 5))
    bn = hvd.SyncBatchNorm(4, affine=affine)
    ref = torch.nn.BatchNorm1d(4, affine=affine)
    if affine:
        with torch.no_grad():
            for m in (bn, ref):
                m.weight.copy_(torch.linspace(0.5, 2.0, 4))
                m.bias.copy_(torch.linspace(-1.0, 1.0, 4))
    xs, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
    ys, yr = bn(xs), ref(xr)
    (ys * g).sum().backward()
    (yr * g).sum().backward()
    assert (ys - yr).abs().max().item() <= 1e-5
    assert (xs.grad - xr.grad).abs().max().item() <= 1e-5
    if affine:
        assert (bn.weight.grad - ref.weight.grad).abs().max() <= 1e-4
        assert (bn.bias.grad - ref.bias.grad).abs().max() <= 1e-4
    assert (bn.running_mean - ref.running_mean).abs().max() <= 1e-6
    assert (bn.running_var - ref.running_var).abs().max() <= 1e-5
    bn.eval()
    ref.eval()
    assert (bn(x) - ref(x)).abs().max().item() <= 1e-5


def test_sync_batch_norm_stats_and_sparse_match_jax(world, hvd_world):
    jhvd = hvd_world
    from horovod_tpu import sparse as jsparse
    from horovod_tpu import sync_batch_norm as jsbn
    x = _normal(9, (8, 5))
    for got, want in zip(hvd.sync_batch_norm_stats(x),
                         jsbn.sync_batch_norm_stats(x.numpy())):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    idx = np.array([0, 2, 2, 5])
    vals = _ints(3, (4, 3)).numpy()
    tsp = hvd.SparseGradient(torch.from_numpy(idx), torch.from_numpy(vals),
                             (6, 3))
    jsp = jsparse.SparseGradient(idx, vals, (6, 3))
    for average in (True, False):
        t = hvd.allreduce_sparse(tsp, average=average)
        j = jsparse.allreduce_sparse(jsp, average=average)
        np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
        np.testing.assert_array_equal(t.indices.numpy(),
                                      np.asarray(j.indices))
        np.testing.assert_array_equal(
            hvd.allreduce_sparse_as_dense(tsp, average=average).numpy(),
            np.asarray(jsparse.allreduce_sparse_as_dense(jsp,
                                                         average=average)))
    np.testing.assert_array_equal(hvd.sparse_to_dense(tsp).numpy(),
                                  np.asarray(jsparse.sparse_to_dense(jsp)))
    assert jhvd.size() == 1


def test_object_verbs_round_trip(world):
    state = {"step": 3, "t": torch.arange(5.0), "nested": [1, "two"]}
    got = hvd.broadcast_object(state, root_rank=0)
    assert got["step"] == 3 and torch.equal(got["t"], state["t"])
    (only,) = hvd.allgather_object(state)
    assert only["nested"] == [1, "two"]


def test_adasum_optimizer_at_size_one_is_the_plain_optimizer(world):
    torch.manual_seed(0)
    a, b = torch.nn.Linear(3, 2), torch.nn.Linear(3, 2)
    b.load_state_dict(a.state_dict())
    opt_a = torch.optim.SGD(a.parameters(), lr=0.1)
    opt_b = hvd.DistributedOptimizer(torch.optim.SGD(b.parameters(), lr=0.1),
                                     named_parameters=b.named_parameters(),
                                     op=hvd.Adasum)
    assert type(opt_b) is hvd.DistributedOptimizer
    x = torch.randn(4, 3)
    for m, o in ((a, opt_a), (b, opt_b)):
        o.zero_grad()
        m(x).pow(2).sum().backward()
        o.step()
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    opt_b.remove_hooks()


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))
