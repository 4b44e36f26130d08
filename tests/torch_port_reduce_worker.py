"""The worker of the compiled-plane reduction tests
(``tests/test_torch_port_reduce.py`` on gloo, ``tests/
test_torch_port_reduce_cuda.py`` on NCCL). It imports torch, numpy and
the port only, so that it runs on the card's machine too.

``python tests/torch_port_reduce_worker.py world <out_dir> [cpu|cuda]``
with the ``HVD_TPU_*`` identity env (the ranks laid out host by host;
:func:`run_world` starts such a world): each rank reduces seeded
gradients through ``DistributedOptimizer(axis_name='cross',
inner_axis='local')`` under every (strategy, packing, op) at the default
packed threshold and at 64 bytes, the integer gradients of the JAX
package's oracle, bf16 and fp16 on the wire, int8 for 3 SGD steps with
its residual carried, a training mesh's ``dp`` dim, and Adasum (the
function and the optimizer's route to it); in a world of 2 also the
other layout of two (a 1 x 2 mesh through ``mesh=``), the int8
convergence run and a mid-run ``state_dict`` resume. It writes
``rank<r>.npz`` (the arrays) and ``rank<r>.json`` (the checks) to
``out_dir``. On CUDA rank r drives ``cuda:r``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
SHAPES = {"w": (100,), "b": (7,), "k": (33,), "m": (5, 6)}
VARIANTS = [(s, p, op) for s in ("hierarchical", "flat")
            for p in ("per_leaf", "packed") for op in ("Average", "Sum")]
INT8_STEPS = 3


def make_grads(n, seed=0, scale=1.0):
    """Per-rank gradients: {leaf: (n, *shape)}, row d scaled by d + 1."""
    rng = np.random.RandomState(seed)
    return {k: np.stack([rng.standard_normal(s).astype(np.float32)
                         * (d + 1) * scale for d in range(n)])
            for k, s in SHAPES.items()}


def oracle_grads(n):
    """tests/test_autotune.py::test_compiled_reduction_variants_
    numerically_equal's gradients for n devices (integers: every order of
    summation gives the same bits)."""
    return {"w": np.arange(n * 3, dtype=np.float32).reshape(n, 3),
            "b": np.arange(n, dtype=np.float32).reshape(n, 1)}


def _params(torch, dev, shapes=SHAPES):
    return {k: torch.nn.Parameter(torch.zeros(s, device=dev))
            for k, s in shapes.items()}


def _optimizer(hvd, torch, ps, lr=1.0, momentum=0.0, **kw):
    return hvd.DistributedOptimizer(
        torch.optim.SGD(list(ps.values()), lr=lr, momentum=momentum),
        named_parameters=list(ps.items()), **kw)


def _set_grads(torch, ps, grads, rank):
    for k, p in ps.items():
        p.grad = torch.from_numpy(grads[k][rank].copy()).to(p.device)


def _host(t):
    return t.detach().cpu().numpy().copy()


def world_main(out_dir: str, device: str = "cpu") -> int:
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import adasum
    from horovod_tpu_torch.parallel.mesh_utils import (MeshConfig,
                                                        make_training_mesh)
    rank = int(os.environ.get("HVD_TPU_RANK", "0"))
    dev = torch.device("cpu") if device == "cpu" \
        else torch.device("cuda", rank)
    hvd.init(device=dev)
    n = hvd.size()
    out, info = {}, {"rank": rank, "device": str(dev)}
    base = hvd.cross_local_mesh()
    info["mesh"] = list(base.mesh.shape)
    meshes = {"base": base}
    if n == 2:   # the other layout of two, through mesh=
        meshes["1x2"] = init_device_mesh(dev.type, (1, 2),
                                         mesh_dim_names=("cross", "local"))

    def reduce_once(grads, mesh, **kw):
        ps = _params(torch, dev, {k: v.shape[1:] for k, v in grads.items()})
        opt = _optimizer(hvd, torch, ps, axis_name="cross",
                         inner_axis="local", mesh=mesh, **kw)
        _set_grads(torch, ps, grads, rank)
        opt.synchronize()
        return {k: _host(p.grad) for k, p in ps.items()}

    grads = make_grads(n)
    for mname, mesh in meshes.items():
        for thr in ("default", "64"):
            if thr == "64":
                os.environ["HVD_TPU_INJIT_PACKED_THRESHOLD"] = "64"
            for s, p, op in VARIANTS:
                if thr == "64" and op == "Sum":
                    continue
                red = reduce_once(grads, mesh, reduce_strategy=s, packing=p,
                                  op=getattr(hvd, op))
                for k, v in red.items():
                    out[f"{mname}.{s}.{p}.{op}.{thr}.{k}"] = v
            os.environ.pop("HVD_TPU_INJIT_PACKED_THRESHOLD", None)
        for s, p, op in VARIANTS:
            red = reduce_once(oracle_grads(n), mesh, reduce_strategy=s,
                              packing=p, op=getattr(hvd, op))
            for k, v in red.items():
                out[f"oracle.{mname}.{s}.{p}.{op}.{k}"] = v

    # a training mesh's dim serves as the axis too
    tmesh = make_training_mesh(MeshConfig(dp=n), device=dev)
    ps = _params(torch, dev)
    opt = _optimizer(hvd, torch, ps, axis_name="dp", mesh=tmesh,
                     packing="packed")
    _set_grads(torch, ps, grads, rank)
    opt.synchronize()
    for k, p in ps.items():
        out[f"dp.{k}"] = _host(p.grad)

    # wire compression
    for comp in ("bf16", "fp16_strict"):
        red = reduce_once(grads, base, packing="packed",
                          compression=getattr(hvd.Compression, comp))
        for k, v in red.items():
            out[f"{comp}.{k}"] = v

    # int8: INT8_STEPS SGD steps, the residual carried
    for s in ("hierarchical", "flat"):
        ps = _params(torch, dev)
        opt = _optimizer(hvd, torch, ps, axis_name="cross",
                         inner_axis="local", reduce_strategy=s,
                         packing="packed", compression=hvd.Compression.int8)
        for t in range(INT8_STEPS):
            opt.zero_grad()
            _set_grads(torch, ps, make_grads(n, seed=10 + t), rank)
            opt.step()
            res = opt.state_dict()["error_feedback_residual"]
            for k, p in ps.items():
                out[f"int8.{s}.{t}.grad.{k}"] = _host(p.grad)
                out[f"int8.{s}.{t}.param.{k}"] = _host(p)
                out[f"int8.{s}.{t}.res.{k}"] = _host(res[k])

    # Adasum: the function, and the optimizer's route to it
    inner = base.get_group("local") if base.mesh.shape[1] > 1 else None
    rows = make_grads(n, seed=3)["w"]
    got = adasum.adasum_grads(torch.from_numpy(rows[rank].copy()).to(dev),
                              base.get_group("cross"), inner)
    out["adasum"] = _host(got)
    ps = _params(torch, dev)
    opt = _optimizer(hvd, torch, ps, op=hvd.Adasum, axis_name="cross",
                     inner_axis="local" if inner is not None else None)
    _set_grads(torch, ps, make_grads(n, seed=3), rank)
    opt.synchronize()
    info["adasum_route_equal"] = bool(torch.equal(ps["w"].grad, got))
    info["adasum_compiled_type"] = type(opt).__name__
    info["adasum_eager_type"] = type(_optimizer(
        hvd, torch, _params(torch, dev), op=hvd.Adasum)).__name__

    if n == 2:
        info.update(_convergence(hvd, torch, dev, rank, n))
        info.update(_resume(hvd, torch, dev, rank, n))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    dist.barrier()
    hvd.shutdown()
    return 0


def _convergence(hvd, torch, dev, rank, n, steps=30):
    """tests/test_injit.py::test_int8_error_feedback_convergence over the
    world: per-rank targets, Average -> w - mean(targets)."""
    dim = 32
    targets = np.stack([np.linspace(-1.0, 1.0, dim) * (d + 1)
                        for d in range(n)]).astype(np.float32)
    target_mean = targets.mean(axis=0)

    def run(compression):
        w = torch.nn.Parameter(torch.zeros(dim, device=dev))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([w], lr=0.4), named_parameters=[("w", w)],
            axis_name="cross", packing="packed", compression=compression)
        t = torch.from_numpy(targets[rank]).to(dev)
        losses = []
        for _ in range(steps):
            opt.zero_grad()
            w.grad = w.detach() - t
            opt.step()
            losses.append(float(np.mean((_host(w) - target_mean) ** 2)))
        return _host(w).tolist(), losses

    w32, l32 = run(hvd.Compression.none)
    w8, l8 = run(hvd.Compression.int8)
    return {"conv_w32": w32, "conv_l32": l32, "conv_w8": w8, "conv_l8": l8}


def _resume(hvd, torch, dev, rank, n, steps=4, cut=2):
    """An int8 run with SGD momentum: uninterrupted, and saved after
    ``cut`` steps, restored into a fresh model and optimizer, continued."""
    import copy

    def fresh():
        ps = _params(torch, dev)
        return ps, _optimizer(hvd, torch, ps, lr=0.1, momentum=0.9,
                              axis_name="cross", packing="packed",
                              compression=hvd.Compression.int8)

    def advance(ps, opt, ts):
        for t in ts:
            opt.zero_grad()
            _set_grads(torch, ps, make_grads(n, seed=20 + t), rank)
            opt.step()

    ps, opt = fresh()
    advance(ps, opt, range(steps))
    ps2, opt2 = fresh()
    advance(ps2, opt2, range(cut))
    saved_params = {k: p.detach().clone() for k, p in ps2.items()}
    saved = copy.deepcopy(opt2.state_dict())
    ps3, opt3 = fresh()
    with torch.no_grad():
        for k, p in ps3.items():
            p.copy_(saved_params[k])
    opt3.load_state_dict(saved)
    advance(ps3, opt3, range(cut, steps))
    same = all(torch.equal(ps[k], ps3[k]) for k in ps)
    r1 = opt.state_dict()["error_feedback_residual"]
    r3 = opt3.state_dict()["error_feedback_residual"]
    same_res = all(torch.equal(r1[k], r3[k]) for k in r1)
    moved = any(not torch.equal(ps[k], ps2[k]) for k in ps)
    return {"resume_params_equal": same, "resume_residual_equal": same_res,
            "resume_moved": moved}


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(tmp, cross, local, device="cpu", timeout=240, script=HERE):
    """A world of cross x local processes of this worker, or of another
    ``script`` taking the same ``world <dir> <device>`` arguments (gloo
    on the CPU, NCCL on ``cross * local`` cards); returns (per-rank npz
    dicts, per-rank info dicts)."""
    port, n = _free_port(), cross * local
    procs = []
    for rank in range(n):
        env = dict(os.environ, HVD_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   HVD_TPU_SIZE=str(n), HVD_TPU_RANK=str(rank),
                   HVD_TPU_LOCAL_RANK=str(rank % local),
                   HVD_TPU_LOCAL_SIZE=str(local),
                   HVD_TPU_CROSS_RANK=str(rank // local),
                   HVD_TPU_CROSS_SIZE=str(cross), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        env.pop("HVD_TPU_INJIT_PACKED_THRESHOLD", None)
        procs.append(subprocess.Popen(
            [sys.executable, script, "world", str(tmp), device], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            _, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    arrays = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
              for r in range(n)]
    infos = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
             for r in range(n)]
    return arrays, infos


if __name__ == "__main__" and sys.argv[1:2] == ["world"]:
    sys.exit(world_main(sys.argv[2], *sys.argv[3:4]))
