"""The training mesh over NCCL, one card a rank: the full-width default
TransformerConfig (111,121,920 parameters, bf16 activations) at batch
8 x 2048, trained 3 steps on sequence-parallel and parameter-sharded
meshes, its losses held to the one-card flash step's from the same
weights and data.

Marked ``cuda``; needs 2 cards (sp = 2 ring, sp = 2 Ulysses, dp = 2, tp =
2, fsdp = 2) or 4 (sp = 4 ring, sp = 4 Ulysses with 12 heads / 4, dp = 2
x sp = 2 ring, tp = 4, fsdp = 4, fsdp = 2 x tp = 2, sp = 2 x tp = 2 ring)
and skips with fewer. At 4 cards the world also saves its fsdp = 4 train
state (parameters and AdamW state, block by block) and restores it onto
dp = 4 and onto fsdp = 2 x tp = 2, every block held bit for bit to the
saved global arrays. On a 4-card machine, from the root of a checkout:

    python -m pytest --noconftest -m cuda tests/test_torch_port_parallel*.py

This file is also the worker: the tests spawn it with the ``HVD_TPU_*``
env contract, once as a world of one (the reference: no mesh, the flash
step) and once as a world of n. Every rank prints one RESULT line with its
losses, step times, flash launches, the last step's phases on the
device's clock with the host time its wire calls spent on the
dispatcher, and the times of the mesh's own communication at the
training shapes (the ring's K/V shift, Ulysses' all-to-all).

``test_ring_wire_calls_keep_one_order`` trains sp = n ring for more
steps, each under its own time limit: the ring's send/recv and the
gradient buckets reach NCCL from one thread (``run_in_order``). Run as a
script with ``order-probe`` (``python tests/test_torch_port_parallel_cuda.py
order-probe [out_dir]``), the file trains the same world twice, once with
the ring's wire calls made on the calling thread (the backward's, beside
the dispatcher's buckets) and once through ``run_in_order``, and prints
one JSON line per world: the steps each rank finished, whether it hung,
and the stacks a hung rank dumped.

Tolerances are chip_smoke.py's for the full-width bf16 losses of two
attention paths from the same weights and data: 1e-3 over steps 1-2 (the
ring rounds each step's partial output to bf16 before its merge, tp sums
bf16 partial products, Ulysses, dp and fsdp only reorder sums), 0.1 at
step 3, where AdamW at lr 1e-3 has amplified the rounding differences.
Per rank the RESULT line also carries the peak device memory of each
mesh's steps and the bytes of this rank's parameters and AdamW state: at
fsdp = 4 they must be at most 0.26 of the whole (a quarter, and the
replicated LayerNorm parameters).
"""

import faulthandler
import json
import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch.models import TransformerConfig  # noqa: E402
from horovod_tpu_torch.ops import flash_attention as fa  # noqa: E402
from horovod_tpu_torch.parallel import (  # noqa: E402
    MeshConfig, make_training_mesh, make_transformer_train_step)

STEPS = 3
BATCH = 8
TOL_LOSS = (1e-3, 1e-3, 0.1)
#: each world's time limit (the worlds take about a minute each)
WORKER_SECONDS = {"reference": 240, "mesh": 720, "order": 150}
#: the share of the whole train state one rank may hold at fsdp = 4
FSDP4_STATE_SHARE = 0.26
#: the order worlds' steps, and each step's limit (a step takes < 0.4 s)
ORDER_STEPS = 20
ORDER_STEP_SECONDS = 30

pytestmark = pytest.mark.cuda


def _meshes(n):
    """(label, mesh config, attention kind) trained in a world of n."""
    meshes = [(f"sp{n}_ring", MeshConfig(sp=n), "ring"),
              (f"sp{n}_ulysses", MeshConfig(sp=n), "ulysses"),
              (f"dp2_sp{n // 2}_ring", MeshConfig(dp=2, sp=n // 2), "ring"),
              (f"tp{n}", MeshConfig(dp=1, tp=n), "ring"),
              (f"fsdp{n}", MeshConfig(dp=1, fsdp=n), "ring")]
    if n == 4:
        meshes += [("fsdp2_tp2", MeshConfig(dp=1, fsdp=2, tp=2), "ring"),
                   ("sp2_tp2_ring", MeshConfig(dp=1, sp=2, tp=2), "ring")]
    return meshes


def _data(cfg):
    gen = torch.Generator().manual_seed(1)
    d = torch.randint(0, cfg.vocab_size, (BATCH, cfg.max_seq_len + 1),
                      generator=gen)
    return d[:, :-1].cuda(), d[:, 1:].cuda()


def _state_bytes(bundle):
    """Bytes of this rank's parameters and AdamW state."""
    state = bundle.optimizer.state
    return sum(t.numel() * t.element_size()
               for p in bundle.model.parameters()
               for t in [p] + [v for v in state.get(p, {}).values()
                               if v.dim() > 0])


def _train(cfg, tokens, targets, mesh=None, kind="ring", keep=False):
    bundle = make_transformer_train_step(
        cfg, mesh=mesh, attention_kind=kind,
        generator=torch.Generator(device="cuda").manual_seed(0))
    if bundle.sharding is None:   # sharded blocks come from one seed
        hvd.broadcast_parameters(bundle.model.state_dict(), root_rank=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES["flash_fwd"] = 0
    losses, seconds = [], []
    for i in range(STEPS):
        timer = _StepTimer(bundle) if i == STEPS - 1 else None
        t0 = time.perf_counter()
        losses.append(bundle.step(tokens, targets).item())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        _log("step", len(losses), losses[-1], seconds[-1])
    launches = fa.LAUNCHES["flash_fwd"]
    breakdown = timer.read()
    out = {"losses": losses, "step_seconds": seconds,
           "flash_launches": launches, "last_step_ms": breakdown,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "state_bytes": _state_bytes(bundle)}
    if keep:
        return out, bundle
    bundle.optimizer.remove_hooks()
    del bundle
    torch.cuda.empty_cache()
    return out


def _checkpoint_across_meshes(cfg, bundle, out_dir):
    """Save ``bundle`` (trained on fsdp = 4) and restore it onto dp = 4 and
    fsdp = 2 x tp = 2; every rank holds each block it has to the saved
    global arrays, bit for bit (``torch.equal``)."""
    import shutil

    from horovod_tpu_torch import checkpointing as cp
    from horovod_tpu_torch.checkpointing.snapshot import tree_flatten
    from horovod_tpu_torch.parallel import (
        restore_mesh_train_state, save_mesh_train_state, train_state_tree)
    root = os.path.join(out_dir, "ckpt_4card")
    if hvd.rank() == 0:
        shutil.rmtree(root, ignore_errors=True)
    hvd.barrier()
    mgr = cp.CheckpointManager(root)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_mesh_train_state(mgr, 3, bundle)
    save_s = time.perf_counter() - t0
    whole = mgr.restore(step=3)            # global CPU arrays

    def matches(b):
        ok = True
        for (_, got), (_, want) in zip(tree_flatten(train_state_tree(b))[0],
                                       tree_flatten(whole)[0]):
            if isinstance(got, cp.Shard):
                got, want = got.data, want[got.index()]
            ok = ok and torch.equal(got.cpu(), want)
        return ok
    out = {"save_ms": save_s * 1e3, "saved_blocks_exact": matches(bundle)}
    bundle.optimizer.remove_hooks()
    for label, mc in (("dp4", MeshConfig(dp=4)),
                      ("fsdp2_tp2", MeshConfig(dp=1, fsdp=2, tp=2))):
        b = make_transformer_train_step(
            cfg, mesh=make_training_mesh(mc),
            generator=torch.Generator(device="cuda").manual_seed(1))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = restore_mesh_train_state(mgr, b)
        torch.cuda.synchronize()
        out[f"restore_{label}_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"restored_{label}_exact"] = step == 3 and matches(b)
        b.optimizer.remove_hooks()
        del b
        torch.cuda.empty_cache()
    hvd.barrier()
    if hvd.rank() == 0:
        shutil.rmtree(root, ignore_errors=True)
    return out



class _StepTimer:
    """The phases of one step on the device's clock (CUDA events at the
    model's forward, the optimizer's step and their ends), and the host
    seconds that the parallel package's wire calls spent waiting for the
    dispatcher thread and on it."""

    def __init__(self, bundle):
        import importlib
        self.comm = importlib.import_module("horovod_tpu_torch.parallel.comm")
        self.ev = {k: torch.cuda.Event(enable_timing=True) for k in
                   ("start", "forward", "backward", "step", "end")}
        self.ev["start"].record()
        self.wire_s = 0.0
        self.wire_calls = 0
        model, opt = bundle.model, bundle.optimizer
        self.hook = model.register_forward_hook(
            lambda *a: self.ev["forward"].record())
        self.opt, step = opt, opt.step
        in_order = self.comm.run_in_order

        def timed_step(*args, **kwargs):
            self.ev["backward"].record()
            out = step(*args, **kwargs)
            self.ev["step"].record()
            return out

        def timed_in_order(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return in_order(*args, **kwargs)
            finally:
                self.wire_s += time.perf_counter() - t0
                self.wire_calls += 1
        opt.step = timed_step
        self.comm.run_in_order = timed_in_order
        self.restore = lambda: (setattr(self.comm, "run_in_order", in_order),
                                delattr(opt, "step"))

    def read(self):
        self.ev["end"].record()
        torch.cuda.synchronize()
        self.hook.remove()
        self.restore()
        e = self.ev
        return {"forward": e["start"].elapsed_time(e["forward"]),
                "loss_and_backward": e["forward"].elapsed_time(
                    e["backward"]),
                "drain_and_adamw": e["backward"].elapsed_time(e["step"]),
                "loss_allreduce": e["step"].elapsed_time(e["end"]),
                "wire_calls": self.wire_calls,
                "wire_host_ms": self.wire_s * 1e3}


def _comm_ms(mesh, cfg, reps=20):
    """CUDA-event ms of the sp group's own traffic at the training shape:
    the ring's (k, v) shift and one Ulysses all-to-all of a (B, S/sp, H,
    D) bf16 activation."""
    import importlib
    comm = importlib.import_module("horovod_tpu_torch.parallel.comm")
    uly = importlib.import_module("horovod_tpu_torch.parallel.ulysses")
    g = mesh.get_group("sp")
    sp = g.size()
    x = torch.randn(BATCH, cfg.max_seq_len // sp, cfg.num_heads,
                    cfg.head_dim, device="cuda").to(torch.bfloat16)
    out = {"bytes_per_tensor": x.numel() * x.element_size()}
    for name, fn in (("ring_shift_kv_ms", lambda: comm.ring_shift((x, x), g)),
                     ("ulysses_all_to_all_ms",
                      lambda: uly._seq_to_heads(x, g))):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out[name] = start.elapsed_time(end) / reps
    return out


def _log(*parts):
    print(f"[rank {os.environ['HVD_TPU_RANK']} {time.strftime('%X')}]",
          *parts, file=sys.stderr, flush=True)


def _order_worker(variant: str) -> dict:
    """sp = n ring, ORDER_STEPS steps, each under ORDER_STEP_SECONDS (a
    rank that hangs dumps every thread's stack and exits). ``variant``
    "caller" makes the ring's wire calls on the calling thread instead of
    the dispatcher's, as the parallel package did before
    ``run_in_order``."""
    import importlib
    comm = importlib.import_module("horovod_tpu_torch.parallel.comm")
    if variant == "caller":
        comm.run_in_order = lambda fn, inputs=(), outputs=(): fn()
    elif variant != "dispatcher":
        raise ValueError(f"unknown order variant {variant!r}")
    cfg = TransformerConfig()
    tokens, targets = _data(cfg)
    mesh = make_training_mesh(MeshConfig(sp=hvd.size()))
    bundle = make_transformer_train_step(
        cfg, mesh=mesh, attention_kind="ring",
        generator=torch.Generator(device="cuda").manual_seed(0))
    hvd.broadcast_parameters(bundle.model.state_dict(), root_rank=0)
    losses = []
    for i in range(ORDER_STEPS):
        faulthandler.dump_traceback_later(ORDER_STEP_SECONDS, exit=True)
        losses.append(bundle.step(tokens, targets).item())
        _log(variant, "step", i + 1, losses[-1])
    faulthandler.cancel_dump_traceback_later()
    bundle.optimizer.remove_hooks()
    return {"variant": variant, "losses": losses}


def _worker(mode: str, *args) -> int:
    n = int(os.environ["HVD_TPU_SIZE"])
    # a rank that hangs prints every thread's stack and exits before the
    # test's time limit, so the test reports where it stood
    faulthandler.dump_traceback_later(WORKER_SECONDS[mode] - 30, exit=True)
    hvd.init()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TransformerConfig()
    tokens, targets = _data(cfg)
    out = {"rank": hvd.rank(), "card": torch.cuda.get_device_name(),
           "device": str(torch.cuda.current_device())}
    if mode == "reference":
        out["reference"] = _train(cfg, tokens, targets)
    elif mode == "order":
        out["order"] = _order_worker(*args)
    else:
        for label, mc, kind in _meshes(n):
            mesh = make_training_mesh(mc)
            _log(label, "mesh made")
            keep = n == 4 and label == "fsdp4"
            out[label] = _train(cfg, tokens, targets, mesh, kind, keep)
            if keep:
                out[label], bundle = out[label]
                out["checkpoint"] = _checkpoint_across_meshes(
                    cfg, bundle, args[0] if args else os.path.join(
                        ROOT, "build"))
                del bundle
                torch.cuda.empty_cache()
                _log("checkpoint", out["checkpoint"])
            _log(label, "trained", out[label]["losses"])
            if mc.sp > 1:
                out[label]["comm"] = _comm_ms(mesh, cfg)
    hvd.barrier()
    hvd.shutdown()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


@pytest.mark.parametrize("n", [2, 4])
def test_nccl_mesh_training_matches_one_card(n):
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < n:
        pytest.skip(f"needs {n} NVIDIA GPUs")
    from horovod_tpu_torch.ops import _build
    from test_torch_port_parallel import _finish, _start
    _build.build()   # once, before the ranks load it
    me = os.path.abspath(__file__)
    ref = _finish(_start(1, ["reference"], me),
                  timeout=WORKER_SECONDS["reference"])[0]["reference"]
    results = _finish(_start(n, ["mesh"], me),
                      timeout=WORKER_SECONDS["mesh"])
    print(json.dumps({"n": n, "card": results[0]["card"],
                      "reference": ref, "ranks": results}))
    cfg = TransformerConfig()
    for label, mc, kind in _meshes(n):
        per_rank = [r[label] for r in results]
        # every rank reports the same (world-averaged) loss
        assert all(r["losses"] == per_rank[0]["losses"] for r in per_rank)
        for got, want, tol in zip(per_rank[0]["losses"], ref["losses"],
                                  TOL_LOSS):
            assert abs(got - want) <= tol, (label, per_rank[0], ref)
        # flash launches per rank: ring = sp forward + sp recomputed per
        # layer and step; Ulysses and sp = 1 one per layer and step
        per_call = 2 * mc.sp if kind == "ring" and mc.sp > 1 else 1
        for r in per_rank:
            assert r["flash_launches"] == \
                per_call * cfg.num_layers * STEPS, (label, r)
        if label == f"fsdp{n}" and n == 4:
            for r in per_rank:
                assert r["state_bytes"] <= \
                    FSDP4_STATE_SHARE * ref["state_bytes"], (label, r)
    assert ref["flash_launches"] == cfg.num_layers * STEPS
    if n == 4:
        for r in results:
            ck = r["checkpoint"]
            assert ck["saved_blocks_exact"], ck
            assert ck["restored_dp4_exact"], ck
            assert ck["restored_fsdp2_tp2_exact"], ck


@pytest.mark.parametrize("n", [2, 4])
def test_ring_wire_calls_keep_one_order(n):
    """ORDER_STEPS ring steps at sp = n, every rank within each step's
    limit, the same losses on every rank."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < n:
        pytest.skip(f"needs {n} NVIDIA GPUs")
    from horovod_tpu_torch.ops import _build
    from test_torch_port_parallel import _finish, _start
    _build.build()
    results = _finish(_start(n, ["order", "dispatcher"],
                             os.path.abspath(__file__)),
                      timeout=WORKER_SECONDS["order"])
    losses = [r["order"]["losses"] for r in results]
    assert len(losses[0]) == ORDER_STEPS
    assert all(x == losses[0] for x in losses)


def _order_probe(out_dir: str) -> int:
    """Both variants of the order world at n = 2 and 4 (as the cards
    allow), each rank's output in ``out_dir``; one JSON line per world.
    Exits 1 if the dispatcher variant does not finish."""
    import subprocess
    os.makedirs(out_dir, exist_ok=True)
    from horovod_tpu_torch.ops import _build
    from test_torch_port_parallel import _free_port
    _build.build()
    failed = False
    for n in (2, 4):
        if torch.cuda.device_count() < n:
            continue
        for variant in ("caller", "dispatcher"):
            port, procs, t0 = _free_port(), [], time.monotonic()
            for rank in range(n):
                env = dict(os.environ, HVD_TPU_SIZE=str(n),
                           HVD_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                           HVD_TPU_RANK=str(rank),
                           HVD_TPU_LOCAL_RANK=str(rank),
                           PYTHONPATH=ROOT + os.pathsep
                           + os.environ.get("PYTHONPATH", ""))
                stem = os.path.join(out_dir, f"n{n}_{variant}_rank{rank}")
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "order",
                     variant], env=env, cwd=ROOT,
                    stdout=open(stem + ".out", "w"),
                    stderr=open(stem + ".err", "w")))
            codes = []
            for p in procs:
                try:
                    codes.append(p.wait(timeout=max(
                        1.0, WORKER_SECONDS["order"] - (time.monotonic()
                                                        - t0))))
                except subprocess.TimeoutExpired:
                    p.kill()
                    codes.append(p.wait())
            ranks = []
            for rank in range(n):
                stem = os.path.join(out_dir, f"n{n}_{variant}_rank{rank}")
                err = open(stem + ".err").read()
                hung = "Timeout (" in err
                # a hung rank's dumped stacks, thread by thread, or the
                # end of a failed rank's output
                tail = ([ln.strip() for ln in err.splitlines()
                         if ln.startswith(("Thread 0x", "Current thread 0x"))
                         or "File " in ln][:40] if hung else
                        err.splitlines()[-6:] if codes[rank] else [])
                ranks.append({"rank": rank, "exit": codes[rank],
                              "steps": err.count(f"{variant} step "),
                              "hung": hung, "stacks": tail})
            ok = all(r["exit"] == 0 and r["steps"] == ORDER_STEPS
                     for r in ranks)
            failed |= variant == "dispatcher" and not ok
            print(json.dumps({"n": n, "variant": variant, "finished": ok,
                              "seconds": time.monotonic() - t0,
                              "ranks": ranks}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1] == "order-probe":
        sys.exit(_order_probe(sys.argv[2] if len(sys.argv) > 2 else
                              os.path.join(ROOT, "build", "order_probe")))
    sys.exit(_worker(*sys.argv[1:]))
