"""The port's compiled-plane autotuner (``horovod_tpu_torch.
compiled_autotune``) against the JAX package's
(``horovod_tpu/compiled_autotune.py``; oracle: the compiled half of
tests/test_autotune.py).

In one process (gloo at size 1): ``autotune_variants`` picks the fast
variant of a slow/fast pair, counts both metrics and writes the JAX
package's ``compiled[key] chose ...`` line. In a gloo world of 2 (this
file is its own worker: ``python tests/test_torch_port_compiled_autotune.py
world <out_dir>``, the two ranks on one host, cross 1 x local 2) where
rank 1 times the variants the other way round: both ranks adopt rank 0's
choice, only rank 0 logs it; and ``tune_distributed_step`` over the four
(strategy, packing) variants returns a step whose output equals
``hierarchical/per_leaf``'s and the JAX package's on a 1 x 2 mesh within
the oracle's 1e-6.
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))


def oracle_rows(n):
    """tests/test_autotune.py::test_tune_distributed_step_end_to_end's
    gradient, one row of two per device."""
    return np.arange(2 * n, dtype=np.float32).reshape(n, 2)


def _world_main(out_dir: str) -> int:
    sys.path.insert(0, REPO)
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.compiled_autotune import (autotune_variants,
                                                     tune_distributed_step)
    hvd.init(device="cpu", config_overrides={
        "AUTOTUNE_LOG": os.path.join(out_dir, "autotune.log")})
    rank = hvd.rank()

    def slow_on(who):
        def fn():
            if rank == who:
                time.sleep(0.05)
            return rank
        return fn
    # rank 0 measures "b" slow, rank 1 measures "a" slow
    chosen, fn, times = autotune_variants(
        {"a": slow_on(1), "b": slow_on(0)}, warmup=0, iters=2,
        key="t.adopt")
    local_best = min(times, key=times.get)

    def make_step(reduce_strategy, packing):
        w = torch.nn.Parameter(torch.zeros(2))
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([w], lr=1.0), named_parameters=[("w", w)],
            axis_name="cross", inner_axis="local",
            reduce_strategy=reduce_strategy, packing=packing)

        def step(g):
            w.grad = g.clone()
            opt.synchronize()
            return w.grad.clone()
        return step

    g = torch.from_numpy(oracle_rows(hvd.size())[rank].copy())
    options, step = tune_distributed_step(make_step, (g,), warmup=1,
                                          iters=2, key="t.step")
    out = step(g)
    expect = make_step("hierarchical", "per_leaf")(g)
    snap = metrics.snapshot()
    info = {"rank": rank, "chosen": chosen, "local_best": local_best,
            "adopted_fn_is_chosen": fn() == rank,
            "options": options, "out": out.tolist(),
            "expect": expect.tolist(),
            "variants": snap["hvd_tpu_autotune_compiled_variants_total"],
            "tunes": snap["hvd_tpu_autotune_compiled_tunes_total"]}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    hvd.shutdown()
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["world"]:
    sys.exit(_world_main(sys.argv[2]))

# -- the tests (both packages) ----------------------------------------------

import re  # noqa: E402
import subprocess  # noqa: E402

import pytest  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import metrics as tmetrics  # noqa: E402
from horovod_tpu_torch.compiled_autotune import autotune_variants  # noqa: E402


def _strip_time(log: str):
    return [re.sub(r"^\S+ \S+ ", "", line) for line in log.splitlines()]


def test_autotune_variants_picks_fastest(tmp_path):
    """tests/test_autotune.py::test_autotune_variants_picks_fastest, plus
    the counters and the log line."""
    log = tmp_path / "autotune.log"
    hvd.init(device="cpu", config_overrides={"AUTOTUNE_LOG": str(log)})
    try:
        before = tmetrics.snapshot()

        def slow():
            time.sleep(0.03)
            return np.zeros(2)

        def fast():
            return np.zeros(2)

        chosen, fn, times = autotune_variants(
            {"slow": slow, "fast": fast}, warmup=0, iters=2, key="t.pick")
        assert chosen == "fast"
        assert times["slow"] > times["fast"]
        assert fn is fast
        after = tmetrics.snapshot()
        name = "hvd_tpu_autotune_compiled_%s_total"
        assert after[name % "variants"] - before[name % "variants"] == 2
        assert after[name % "tunes"] - before[name % "tunes"] == 1
        line, = _strip_time(log.read_text())
        assert re.fullmatch(r"compiled\[t\.pick\] chose fast; "
                            r"times=fast=\d+\.\d{6}s, slow=\d+\.\d{6}s", line)
        with pytest.raises(ValueError, match="no variants"):
            autotune_variants({})
    finally:
        hvd.shutdown()


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ctune2")
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, HVD_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   HVD_TPU_SIZE="2", HVD_TPU_RANK=str(rank),
                   HVD_TPU_LOCAL_RANK=str(rank), HVD_TPU_LOCAL_SIZE="2",
                   HVD_TPU_CROSS_RANK="0", HVD_TPU_CROSS_SIZE="1",
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, HERE, "world", str(tmp)], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
    infos = [json.load(open(tmp / f"rank{r}.json")) for r in range(2)]
    return infos, (tmp / "autotune.log").read_text()


def test_autotune_cross_process_adoption(world2):
    """Rank 1 alone would pick the other variant; both adopt rank 0's,
    and only rank 0 writes the log."""
    infos, log = world2
    assert infos[0]["local_best"] == "a" and infos[1]["local_best"] == "b"
    assert [i["chosen"] for i in infos] == ["a", "a"]
    assert all(i["adopted_fn_is_chosen"] for i in infos)
    lines = _strip_time(log)
    assert len([x for x in lines if x.startswith("compiled[t.adopt] "
                                                 "chose a;")]) == 1
    assert len([x for x in lines if x.startswith("compiled[t.step] "
                                                 "chose ")]) == 1
    for i in infos:
        assert i["variants"] == 2 + 4 and i["tunes"] == 2


def test_tune_distributed_step_end_to_end(world2):
    """tests/test_autotune.py::test_tune_distributed_step_end_to_end over
    the world: one adopted option everywhere, and its step's output equal
    to hierarchical/per_leaf's and to the JAX package's on a 1 x 2 mesh."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    import optax
    import horovod_tpu as jhvd
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map
    infos, _ = world2
    assert infos[0]["options"] == infos[1]["options"]
    assert infos[0]["options"]["reduce_strategy"] in ("hierarchical", "flat")
    assert infos[0]["options"]["packing"] in ("per_leaf", "packed")
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("dp", "ici"))
    opt = jhvd.DistributedOptimizer(optax.sgd(1.0), axis_name="dp",
                                    inner_axis="ici")
    want = np.asarray(jax.jit(shard_map(
        opt.reduce_gradients, mesh=mesh, in_specs=P(("dp", "ici")),
        out_specs=P(("dp", "ici"))))(oracle_rows(2)))
    for i in infos:
        np.testing.assert_allclose(i["out"], i["expect"], rtol=1e-6)
        np.testing.assert_allclose(i["out"], want[i["rank"]], rtol=1e-6)
