"""The port's synthetic benchmark (horovod_tpu_torch.benchmark and the
``python -m horovod_tpu_torch.bench`` entry point) on the CPU, against
the JAX rig's math.

* the rig's step and the ladder's rules (rigs shared by batch size and
  stem, a bad stage yielded as ``(None, exc)`` and the ladder going on);
* ``peak_flops_per_chip``'s H100 row;
* one step of the port's rig, ResNet-18 at 64 px with 2 images a
  process, against one step of the JAX rig's math (flax ResNet-18,
  optax.sgd(0.01 * n, momentum=0.9), mean softmax cross-entropy) from the
  same weights and batch: at size 1, and in a gloo world of 2 that splits
  the batch (each rank's BatchNorm takes the global batch's statistics
  and the gradients are averaged) against the full-batch JAX step. Both
  sides run in fp32 (the rig's ``dtype``): in bf16 either package's
  update is several percent (relative L2) from the fp32 update at this
  size, so a
  bf16 comparison could not tell a fault from rounding. Tolerances,
  relative: ``TOL_LOSS`` and ``TOL_STATS`` 1e-5, ``TOL_UPDATE`` 1e-4
  (fp32 sums in other orders, through every layer's gradient);
* the bench script exits non-zero without a CUDA device.

Run as a script, this file is the worker of the gloo world.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import benchmark as bm  # noqa: E402
from horovod_tpu_torch.models import cnn_params_to_flax  # noqa: E402

TOL_LOSS = 1e-5
TOL_STATS = 1e-5
TOL_UPDATE = 1e-4
SIZE, BATCH = 64, 2


@pytest.fixture
def cpu_world():
    if hvd.is_initialized():
        hvd.shutdown()
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _flat(tree):
    import jax
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in jax.tree_util.tree_leaves(tree)])


def _one_step():
    """One fp32 step of a resnet18 rig. Returns this process's images
    (NHWC) and labels, the state before and after the step, and the
    loss."""
    rig = bm._Rig(BATCH, SIZE, "resnet18", "sgd", device="cpu",
                  dtype=torch.float32)
    try:
        before = {k: v.clone() for k, v in rig.model.state_dict().items()}
        loss = rig.step().item()
        after = {k: v.clone() for k, v in rig.model.state_dict().items()}
    finally:
        rig.close()
    images = rig.images.float().permute(0, 2, 3, 1).numpy()
    return images, rig.labels.numpy(), before, after, loss


def _jax_step(before, images, labels, n):
    """One step of the JAX rig's math on the full batch."""
    import jax
    import jax.numpy as jnp
    import optax

    from horovod_tpu.models import ResNet18
    model = ResNet18(num_classes=bm.NUM_CLASSES, dtype=jnp.float32)
    tx = optax.sgd(0.01 * n, momentum=0.9)
    v = cnn_params_to_flax(before)

    @jax.jit
    def step(p, bs, x, y):
        def loss_fn(p):
            logits, upd = model.apply({"params": p, "batch_stats": bs}, x,
                                      train=True, mutable=["batch_stats"])
            loss = optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()
            return loss, upd["batch_stats"]
        (loss, bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return optax.apply_updates(p, updates), bs, loss
    params, stats, loss = step(v["params"], v["batch_stats"],
                               jnp.asarray(images, jnp.float32),
                               jnp.asarray(labels))
    return v, params, stats, float(loss)


def _check_step(before, after, loss, jax_result):
    v0, params, stats, jax_loss = jax_result
    got = cnn_params_to_flax(after)
    assert abs(loss - jax_loss) / jax_loss <= TOL_LOSS
    assert _rel(_flat(got["batch_stats"]), _flat(stats)) <= TOL_STATS
    base = _flat(v0["params"])
    assert _rel(_flat(got["params"]) - base, _flat(params) - base) \
        <= TOL_UPDATE


def test_peak_flops_per_chip():
    assert bm.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    assert bm.peak_flops_per_chip("TPU v5 lite") == 197e12
    assert bm.peak_flops_per_chip("NVIDIA GeForce RTX 2080") is None
    assert bm.peak_flops_per_chip("cpu") is None


def test_benchmark_runs_on_cpu(cpu_world):
    r = bm.synthetic_resnet50_benchmark(
        batch_per_chip=BATCH, num_warmup_batches=1, num_batches_per_iter=1,
        num_iters=1, image_size=SIZE, model_name="resnet18", device="cpu")
    assert r.images_per_sec_per_chip > 0 and r.images_per_sec_total > 0
    assert (r.num_chips, r.batch_per_chip, r.stem) == (1, BATCH, "conv")
    assert r.platform == "cpu" and r.mfu is None
    assert r.peak_memory_gib is None
    # 3 x the forward's convolution and dense FLOPs at 32 px
    assert r.flops_per_step == bm._step_flops("resnet18", "conv", SIZE,
                                              BATCH) > 0


def test_ladder_shares_rigs_and_survives_a_bad_stage(cpu_world,
                                                     monkeypatch):
    built = []
    rig_cls = bm._Rig

    def counting(*args, **kwargs):
        built.append(kwargs.get("stem"))
        return rig_cls(*args, **kwargs)
    monkeypatch.setattr(bm, "_Rig", counting)
    stage = dict(batch_per_chip=BATCH, num_warmup_batches=1,
                 num_batches_per_iter=2, num_iters=1)
    stages = [stage, dict(stage, scanned=True, num_warmup_batches=2),
              dict(stage, stem="s2d"), dict(stage, stem="space_to_depth")]
    results = list(bm.synthetic_resnet50_ladder(
        stages, image_size=SIZE, model_name="resnet18", device="cpu"))
    assert [err is None for _, err in results] == [True, True, False, True]
    assert isinstance(results[2][1], ValueError)
    assert "unknown stem" in str(results[2][1])
    # the scanned stage reused the first stage's rig
    assert built == ["conv", "s2d", "space_to_depth"]
    assert results[3][0].stem == "space_to_depth"
    for r, _ in (results[0], results[1], results[3]):
        assert r.images_per_sec_per_chip > 0 and r.batch_per_chip == BATCH


def test_rig_step_matches_jax_step(cpu_world):
    images, labels, before, after, loss = _one_step()
    _check_step(before, after, loss, _jax_step(before, images, labels, 1))


def _world_worker(out_dir) -> int:
    hvd.init(device="cpu")
    images, labels, before, after, loss = _one_step()
    r = hvd.rank()
    hvd.shutdown()
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), images=images,
             labels=labels, loss=loss,
             **{f"before.{k}": v.numpy() for k, v in before.items()},
             **{f"after.{k}": v.numpy() for k, v in after.items()})
    print("RESULT " + json.dumps({"rank": r}), flush=True)
    return 0


def test_gloo_world_of_2_matches_the_full_batch_jax_step(tmp_path):
    from test_torch_port_parallel import _finish, _start
    n = 2
    _finish(_start(n, ["world", str(tmp_path)],
                   script=os.path.abspath(__file__)), timeout=240)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(n)]

    def state(res, when):
        return {k.split(".", 1)[1]: torch.from_numpy(v)
                for k, v in res.items() if k.startswith(when + ".")}
    before, after = state(ranks[0], "before"), state(ranks[0], "after")
    for res in ranks[1:]:
        for k, v in state(res, "before").items():
            assert torch.equal(v, before[k])
        # averaged gradients and global statistics: the same step
        for k, v in state(res, "after").items():
            assert torch.equal(v, after[k]), k
    images = np.concatenate([res["images"] for res in ranks])
    labels = np.concatenate([res["labels"] for res in ranks])
    assert images.shape == (n * BATCH, SIZE, SIZE, 3)
    loss = float(np.mean([res["loss"] for res in ranks]))
    _check_step(before, after, loss, _jax_step(before, images, labels, n))


def test_bench_script_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.bench"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert r.stdout == ""


if __name__ == "__main__":
    if sys.argv[1:2] == ["world"]:
        sys.exit(_world_worker(sys.argv[2]))
    sys.exit(f"unknown mode {sys.argv[1:]}")
