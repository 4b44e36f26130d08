"""The worker of ``tests/test_torch_port_injit.py``: one rank of a gloo
world that runs the port's in-jit route under ``torch.compile(fullgraph=
True, backend="aot_eager")``. It imports torch, numpy and the port only.

``python tests/torch_port_injit_worker.py world <out_dir>`` with the
``HVD_TPU_*`` identity env (:func:`run_world` starts a world of 2, laid
out cross 2 x local 1). Each rank takes its row of seeded inputs
(:func:`inputs`), runs every case and writes
``rank<r>.npz`` (the outputs, by case) and ``rank<r>.json`` (the metric
movements, the graphs' collective counts, the errors) to ``out_dir``.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
N = 2
BACKEND = "aot_eager"
#: the compiled plane's gradients (tests/test_injit.py's leaves, one more)
PLANE_SHAPES = {"w": (100,), "b": (7,), "k": (33,), "m": (5, 6)}
PLANE_VARIANTS = [(s, p, op) for s in ("hierarchical", "flat")
                  for p in ("per_leaf", "packed") for op in ("Average", "Sum")]


def inputs(n=N):
    """Every case's input, one row per rank."""
    rng = np.random.RandomState(7)
    return {
        "x": rng.standard_normal((n, 8, 4)).astype(np.float32),
        "a": rng.standard_normal((n, 3, 5)).astype(np.float32),
        "b": rng.standard_normal((n, 7)).astype(np.float32),
        "h": rng.standard_normal((n, 6)).astype(np.float32),   # as bf16
        "i": rng.randint(-50, 50, (n, 5)).astype(np.int32),
        "p": (rng.uniform(0.5, 1.5, (n, 4))).astype(np.float32),
        "s": rng.standard_normal((n,)).astype(np.float32),     # 0-d rows
        "t": rng.standard_normal((n, 4, 6)).astype(np.float32),
    }


def gather_weights(n=N):
    """Each rank's loss weights of the gathers' gradient cases: (n * 8, 4)
    rows, against x's (8, 4)."""
    rng = np.random.RandomState(13)
    return rng.standard_normal((n, n * 8, 4)).astype(np.float32)


def plane_grads(n=N, seed=0):
    rng = np.random.RandomState(seed)
    return {k: np.stack([rng.standard_normal(s).astype(np.float32)
                         * (d + 1) for d in range(n)])
            for k, s in PLANE_SHAPES.items()}


def _series(snapshot, family):
    return {k: v for k, v in snapshot.items() if k.startswith(family)}


def world_main(out_dir: str) -> int:
    sys.path.insert(0, REPO)
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics, collectives as C, metrics
    from horovod_tpu_torch.compression import Compression
    from horovod_tpu_torch.parallel.train import _recording_backend

    hvd.init(device="cpu")
    r = hvd.rank()
    mesh = init_device_mesh("cpu", (N,), mesh_dim_names=("dp",))
    mesh_1x2 = init_device_mesh("cpu", (1, N), mesh_dim_names=("cross",
                                                                "local"))
    data = {k: torch.from_numpy(np.array(v[r])) for k, v in inputs().items()}
    data["h"] = data["h"].to(torch.bfloat16)
    out, info = {}, {"graphs": {}, "errors": {}}

    def compiled(name, fn):
        log = []
        info["graphs"][name] = log
        return torch.compile(fn, fullgraph=True,
                             backend=_recording_backend(BACKEND, name, log))

    def keep(prefix, value):
        if isinstance(value, (list, tuple)):
            for i, v in enumerate(value):
                keep(f"{prefix}.{i}", v)
        else:
            t = value.detach().float() if value.dtype == torch.bfloat16 \
                else value.detach()
            out[prefix] = t.numpy().copy()

    def error(name, fn):
        try:
            fn()
            info["errors"][name] = None
        except (TypeError, ValueError, NameError, NotImplementedError) as e:
            # the JAX package's kinds, through torch.compile as themselves
            kinds = [k.__name__ for k in (TypeError, ValueError, NameError,
                                          NotImplementedError)
                     if isinstance(e, k)]
            info["errors"][name] = [kinds[0], str(e)]

    x, a, b, h, i, p, s, t = (data[k] for k in "xabhipst")

    # -- the verbs under the mesh, every op; the counters around them
    snap0 = metrics.snapshot()
    counts0 = dict(C.COUNTS)

    def verbs(x, a, b, h, i, p, s):
        hd = C.allreduce_async(x, op=hvd.Max)
        ready = C.poll(hd)
        gb = hvd.grouped_broadcast([a, b], root_rank=1)
        y = x.clone()
        hvd.allreduce_(y, op=hvd.Sum)
        z = b.clone()
        hvd.broadcast_(z, 0)
        return {
            "sum": hvd.allreduce(x, op=hvd.Sum),
            "average": hvd.allreduce(x, op=hvd.Average),
            "min": hvd.allreduce(x, op=hvd.Min),
            "max": C.synchronize(hd),
            "product": hvd.allreduce(p, op=hvd.Product),
            "scaled": hvd.allreduce(x, op=hvd.Sum, prescale_factor=0.5,
                                    postscale_factor=3.0),
            "bf16_avg": hvd.allreduce(h, op=hvd.Average),
            "int_sum": hvd.allreduce(i, op=hvd.Sum),
            "grouped": hvd.grouped_allreduce([a, b, h], op=hvd.Sum),
            "per_leaf": [hvd.allreduce(a, op=hvd.Sum),
                         hvd.allreduce(b, op=hvd.Sum),
                         hvd.allreduce(h, op=hvd.Sum)],
            "allgather": hvd.allgather(a),
            "allgather0": hvd.allgather(s),
            "broadcast": hvd.broadcast(x, root_rank=1),
            "grouped_broadcast": gb,
            "alltoall": hvd.alltoall(x),
            "alltoall_splits": hvd.alltoall(x, splits=[4, 4]),
            "inplace_sum": y,
            "inplace_broadcast": z,
            "ready": torch.tensor(bool(ready)),
            "sizes": torch.tensor(list(basics.mapped_axis_sizes().values())),
        }
    f = compiled("verbs", verbs)
    with mesh:
        for _ in range(3):   # one compilation, three runs
            res = f(x, a, b, h, i, p, s)
    snap1 = metrics.snapshot()
    info["verbs_ops"] = [_series(snap0, "hvd_tpu_collective_ops_total"),
                         _series(snap1, "hvd_tpu_collective_ops_total")]
    info["verbs_injit"] = [_series(snap0, "hvd_tpu_injit_lowerings_total"),
                           _series(snap1, "hvd_tpu_injit_lowerings_total")]
    info["verbs_counts"] = [counts0, dict(C.COUNTS)]
    info["eager_sizes"] = basics.mapped_axis_sizes()
    for k, v in res.items():
        keep("verbs." + k, v)

    # -- an async handle out of the compiled function, landed eagerly
    g = compiled("handle_out", lambda x: C.allreduce_async(x, op=hvd.Sum))
    with mesh:
        keep("handle_out", C.synchronize(g(x)))

    # -- no mesh in scope: the world, equal to the eager verbs
    def unmapped(x, a):
        return [hvd.allreduce(x, op=hvd.Sum), hvd.allreduce(x),
                hvd.allgather(a), hvd.broadcast(a, root_rank=1)]
    keep("unmapped", compiled("unmapped", unmapped)(x, a))
    keep("unmapped_eager", unmapped(x, a))

    # -- the eager path untouched
    e0 = metrics.snapshot()
    keep("eager_sum", hvd.allreduce(x, op=hvd.Sum, name="eager_still_eager"))
    e1 = metrics.snapshot()
    info["eager_ops"] = [_series(e0, "hvd_tpu_collective_ops_total"),
                         _series(e1, "hvd_tpu_collective_ops_total")]
    info["eager_injit"] = [_series(e0, "hvd_tpu_injit_lowerings_total"),
                           _series(e1, "hvd_tpu_injit_lowerings_total")]

    # -- the errors
    os.environ["HVD_TPU_INJIT_FASTPATH"] = "0"
    error("fastpath_disabled", lambda: compiled(
        "fastpath", lambda x: hvd.allreduce(x, op=hvd.Sum))(x))
    del os.environ["HVD_TPU_INJIT_FASTPATH"]
    pset = basics.world().world_mesh
    error("process_set", lambda: compiled(
        "pset", lambda x: hvd.allreduce(x, process_set=pset))(x))
    error("ragged_alltoall", lambda: compiled(
        "ragged", lambda x: hvd.alltoall(x, splits=[3, 5]))(x))
    error("root_range", lambda: compiled(
        "root", lambda x: hvd.broadcast(x, root_rank=N))(x))
    with mesh_1x2:
        error("adasum_several_dims", lambda: compiled(
            "adasum_several", lambda x: hvd.allreduce(x, op=hvd.Adasum))(x))
    error("unbound_axis", lambda: compiled(
        "unbound", lambda x: C.psum(x, "dp"))(x))
    xg = x.clone().requires_grad_()

    # Adasum over the mesh's dim, in the graph and eagerly
    with mesh:
        keep("adasum_mesh", compiled("adasum_mesh", lambda x: hvd.allreduce(
            x, op=hvd.Adasum))(x))
    keep("adasum_eager", hvd.allreduce(x, op=hvd.Adasum))

    # allgather's and broadcast's gradients in the graph: each rank's
    # loss weights its gathered (or broadcast) rows by its row of w
    w = torch.from_numpy(np.array(gather_weights()[r]))
    for verb, fn, wv in (("allgather", hvd.allgather, w),
                         ("broadcast", lambda v: hvd.broadcast(v, 1),
                          w[:x.shape[0]])):
        xv = x.clone().requires_grad_()
        with mesh:
            compiled(f"{verb}_grad", lambda v, wv: (fn(v) * wv).sum())(
                xv, wv).backward()
        keep(f"{verb}_grad", xv.grad)

    # allreduce keeps its gradient in the graph: the same allreduce of
    # the upstream gradient, as eagerly
    with mesh:
        y = compiled("allreduce_grad", lambda x: hvd.allreduce(
            x * 2.0, op=hvd.Average))(xg)
    (y * torch.arange(y.numel()).reshape(y.shape)).sum().backward()
    keep("allreduce_grad", xg.grad)

    # -- the packed plan: buckets of the threshold, one collective each
    def grouped(a, b, h):
        return hvd.grouped_allreduce([a, b, h], op=hvd.Sum)
    os.environ["HVD_TPU_INJIT_PACKED_THRESHOLD"] = "64"
    with mesh:
        keep("grouped_64", compiled("grouped_64", grouped)(a, b, h))
    del os.environ["HVD_TPU_INJIT_PACKED_THRESHOLD"]
    with mesh:
        keep("grouped_default", compiled("grouped_default", grouped)(a, b, h))

    # -- the named in-graph collectives over "dp"
    def named(x, t):
        return {
            "psum": C.psum(x, "dp"),
            "pmean": C.pmean(x, "dp"),
            "all_gather": C.all_gather_in_jit(x, "dp"),
            "all_gather_stack1": C.all_gather_in_jit(x, "dp", axis=1,
                                                     tiled=False),
            "all_gather_axis1": C.all_gather_in_jit(t, "dp", axis=1),
            "reduce_scatter": C.reduce_scatter_in_jit(x, "dp"),
            "reduce_scatter1": C.reduce_scatter_in_jit(t, "dp",
                                                       scatter_dimension=1),
            "all_to_all": C.all_to_all_in_jit(t, "dp", 1, 0),
            "all_to_all00": C.all_to_all_in_jit(x, "dp", 0, 0),
            "ppermute_swap": C.ppermute(x, "dp", [(0, 1), (1, 0)]),
            "ppermute_one": C.ppermute(t, "dp", [(0, 1)]),
        }
    with mesh:
        for k, v in compiled("named", named)(x, t).items():
            keep("named." + k, v)
        for k, v in named(x, t).items():     # the same, eagerly
            keep("named_eager." + k, v)

    # -- DistributedOptimizer (eager plane) reducing in the graph
    shapes = {"w": (4, 3), "v": (5,)}
    gr = np.random.RandomState(11)
    grads = {k: gr.standard_normal((N,) + s).astype(np.float32)
             for k, s in shapes.items()}
    ps = {k: torch.nn.Parameter(torch.zeros(s)) for k, s in shapes.items()}
    opt = hvd.DistributedOptimizer(torch.optim.SGD(list(ps.values()), lr=1.0),
                                   named_parameters=list(ps.items()))

    def set_grads(params, grads):
        for k, q in params.items():
            q.grad = torch.from_numpy(grads[k][r].copy())
    set_grads(ps, grads)
    error("hooks_on", lambda: compiled("hooks", opt.synchronize)())
    opt.remove_hooks()
    o0 = metrics.snapshot()
    sync = compiled("optimizer_sync", opt.synchronize)
    sync()
    info["optimizer_ops"] = [_series(o0, "hvd_tpu_collective_ops_total"),
                             _series(metrics.snapshot(),
                                     "hvd_tpu_collective_ops_total")]
    for k, q in ps.items():
        keep("optimizer." + k, q.grad)

    # -- the compiled plane in the graph: cross 2 x local 1 (the world's
    #    mesh) and 1 x 2 (mesh=), every variant, bf16 on the wire
    pg = plane_grads()
    for layout, pmesh in (("2x1", None), ("1x2", mesh_1x2)):
        for strategy, packing, op in PLANE_VARIANTS + [
                ("hierarchical", "packed", "bf16"), ("flat", "packed",
                                                     "bf16")]:
            qs = {k: torch.nn.Parameter(torch.zeros(s))
                  for k, s in PLANE_SHAPES.items()}
            kw = dict(compression=Compression.bf16) if op == "bf16" else {}
            popt = hvd.DistributedOptimizer(
                torch.optim.SGD(list(qs.values()), lr=1.0),
                named_parameters=list(qs.items()), axis_name="cross",
                inner_axis="local", mesh=pmesh, reduce_strategy=strategy,
                packing=packing,
                op=hvd.Sum if op == "Sum" else hvd.Average, **kw)
            set_grads(qs, pg)
            name = f"plane.{layout}.{strategy}.{packing}.{op}"
            # every optimizer compiles synchronize() anew: past Dynamo's
            # recompile limit of one code object, fullgraph fails
            torch._dynamo.reset()
            compiled(name, popt.synchronize)()
            for k, q in qs.items():
                keep(f"{name}.{k}", q.grad)
    qs = {k: torch.nn.Parameter(torch.zeros(s))
          for k, s in PLANE_SHAPES.items()}
    iopt = hvd.DistributedOptimizer(
        torch.optim.SGD(list(qs.values()), lr=1.0),
        named_parameters=list(qs.items()), axis_name="cross",
        inner_axis="local", packing="packed", compression=Compression.int8)
    set_grads(qs, pg)
    error("int8", lambda: compiled("int8", iopt.synchronize)())

    # -- "v" has a gradient on rank 0 only: rank 1 reduces zeros for it,
    #    so both ranks trace the same collectives (both planes)
    for plane, kw in (("eager", {}), ("compiled", dict(
            axis_name="cross", inner_axis="local"))):
        ms = {k: torch.nn.Parameter(torch.zeros(s))
              for k, s in shapes.items()}
        mopt = hvd.DistributedOptimizer(
            torch.optim.SGD(list(ms.values()), lr=1.0),
            named_parameters=list(ms.items()), **kw)
        mopt.remove_hooks()
        set_grads(ms, grads)
        if r != 0:
            ms["v"].grad = None
        torch._dynamo.reset()
        compiled(f"missing.{plane}", mopt.synchronize)()
        for k, q in ms.items():
            keep(f"missing.{plane}.{k}", q.grad)

    # -- a compiled Average traced in this world of 2 and called again
    #    after the world is made anew at size 1 (an elastic reset's
    #    shutdown and init, on rank 0): it traces again, against the new
    #    world, and equals the eager verb there
    avg = compiled("reset", lambda x: hvd.allreduce(x, op=hvd.Average))
    keep("reset.before", avg(x))
    hvd.shutdown()
    if r == 0:
        hvd.init(device="cpu", num_processes=1)
        keep("reset.after", avg(x))
        keep("reset.after_eager", hvd.allreduce(x, op=hvd.Average))
        hvd.shutdown()

    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as fh:
        json.dump(info, fh)
    return 0


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def run_world(tmp, n=N, timeout=240):
    """A gloo world of ``n`` of this worker (cross n x local 1); returns
    (per-rank npz dicts, per-rank info dicts)."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, HVD_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   HVD_TPU_SIZE=str(n), HVD_TPU_RANK=str(rank),
                   HVD_TPU_LOCAL_RANK="0", HVD_TPU_LOCAL_SIZE="1",
                   HVD_TPU_CROSS_RANK=str(rank), HVD_TPU_CROSS_SIZE=str(n),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        for knob in ("HVD_TPU_INJIT_PACKED_THRESHOLD",
                     "HVD_TPU_INJIT_FASTPATH"):
            env.pop(knob, None)
        procs.append(subprocess.Popen(
            [sys.executable, HERE, "world", str(tmp)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + timeout
    try:
        for proc in procs:
            _, err = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert proc.returncode == 0, err[-4000:]
    finally:
        for proc in procs:
            proc.kill()
            proc.communicate()
    arrays = [dict(np.load(os.path.join(tmp, f"rank{k}.npz")))
              for k in range(n)]
    infos = [json.load(open(os.path.join(tmp, f"rank{k}.json")))
             for k in range(n)]
    return arrays, infos


if __name__ == "__main__" and sys.argv[1:2] == ["world"]:
    sys.exit(world_main(sys.argv[2]))
