"""The port's fusion-threshold autotuner (``horovod_tpu_torch.
parameter_manager``, fed by ``DistributedOptimizer``) against the JAX
package's ``ParameterManager`` on its Python-optimizer path (the JAX
package at ``HVD_TPU_NATIVE=0``; the port has no native optimizer).

Bit for bit: the schedule (warmup, samples, the knob lock, the
``PACK_CUTOFF`` phase, the end) and every threshold the two propose for
the same ``record()`` sequence; the fallback optimizer's suggestions.
Then through the optimizer at size 1 on gloo: the autotuner changes the
threshold, the buckets are re-planned at step boundaries, and the
parameters stay bit-identical to an untuned run's. In a gloo world of 2
with rank-dependent timings, both ranks adopt rank 0's thresholds and
end with identical bucket plans.

This file is also its own worker: ``python tests/test_torch_port_autotune.py
world <out_dir>`` with the ``HVD_TPU_COORDINATOR_ADDR/SIZE/RANK`` env.
"""

import json
import os
import socket
import subprocess
import sys

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
TUNE = {"AUTOTUNE": True, "AUTOTUNE_WARMUP_SAMPLES": 1,
        "AUTOTUNE_STEPS_PER_SAMPLE": 2, "AUTOTUNE_BAYES_OPT_MAX_SAMPLES": 4}


def _train(hvd, steps, perturb=None):
    """``steps`` SGD steps of an MLP through DistributedOptimizer;
    returns (optimizer, final parameters). Its 10.4 MB of gradients span
    several buckets at the tuner's first proposal (4 MB) and one at the
    larger ones."""
    import torch
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(32, 256), torch.nn.ReLU(),
                                torch.nn.Linear(256, 2048), torch.nn.ReLU(),
                                torch.nn.Linear(2048, 1024), torch.nn.ReLU(),
                                torch.nn.Linear(1024, 4))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    pm = hvd.basics.world().parameter_manager
    if pm is not None and perturb is not None:
        record = pm.record
        pm.record = lambda nbytes, seconds: record(
            nbytes, perturb(len(opt.plans), seconds))
    gen = torch.Generator().manual_seed(1)
    for _ in range(steps):
        x = torch.randn(8, 32, generator=gen)
        y = torch.randint(0, 4, (8,), generator=gen)
        opt.zero_grad()
        torch.nn.functional.cross_entropy(model(x), y).backward()
        opt.step()
    return opt, {k: v.clone() for k, v in model.state_dict().items()}


def _world_main(out_dir: str) -> int:
    sys.path.insert(0, REPO)
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu", config_overrides=dict(
        TUNE, AUTOTUNE_LOG=os.path.join(out_dir, "autotune.log")))
    rank = hvd.rank()
    # rank-dependent measurements: each rank alone would rank the samples
    # (and so pick the thresholds) differently
    opt, params = _train(hvd, 24, perturb=lambda k, s: 1e-3 * (
        1 + ((k * 7 + rank * 3) % 5)))
    pm = hvd.basics.world().parameter_manager
    out = {"rank": rank, "active": pm.active, "plans": opt.plans,
           "threshold": pm.fusion_threshold,
           "params": {k: v.tolist() for k, v in params.items()}}
    with open(os.path.join(out_dir, f"world.{rank}.json"), "w") as f:
        json.dump(out, f)
    hvd.shutdown()
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["world"]:
    sys.exit(_world_main(sys.argv[2]))

# -- the tests (both packages) ----------------------------------------------

import re  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import horovod_tpu as jhvd  # noqa: E402
import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu import basics as jbasics  # noqa: E402
from horovod_tpu import config as jconfig  # noqa: E402
from horovod_tpu import parameter_manager as jpm  # noqa: E402
from horovod_tpu_torch import config as tconfig  # noqa: E402
from horovod_tpu_torch import parameter_manager as tpm  # noqa: E402


def _strip_time(log: str):
    return [re.sub(r"^\S+ \S+ ", "", line) for line in log.splitlines()]


@pytest.fixture
def tuned_worlds(tmp_path, monkeypatch):
    """A JAX world on its Python optimizer and a port world (gloo), both
    autotuning with the same small sample settings."""
    monkeypatch.setenv("HVD_TPU_NATIVE", "0")
    monkeypatch.setattr(jpm, "_native_get", lambda: None)
    if jhvd.is_initialized():
        jhvd.shutdown()
    jhvd.init(config_overrides=dict(
        TUNE, AUTOTUNE_LOG=str(tmp_path / "jax.log")))
    hvd.init(device="cpu", config_overrides=dict(
        TUNE, AUTOTUNE_LOG=str(tmp_path / "torch.log")))
    try:
        yield tmp_path
    finally:
        hvd.shutdown()
        jhvd.shutdown()


@pytest.mark.parametrize("scores", ["rising", "falling", "zigzag"])
def test_schedule_and_thresholds_match_jax(tuned_worlds, scores):
    jm = jbasics.world().parameter_manager
    tm = hvd.basics.world().parameter_manager
    assert isinstance(jm._opt, jpm._PythonFallbackOptimizer)
    seconds = {"rising": lambda i: 0.02 - 0.0005 * i,
               "falling": lambda i: 0.01 + 0.0005 * i,
               "zigzag": lambda i: 0.01 + 0.003 * (i % 3)}[scores]
    trace = {"jax": [], "torch": []}
    for i in range(26):
        for name, m in (("jax", jm), ("torch", tm)):
            m.record(1 << 20, seconds(i))
            trace[name].append((m.active, m.fusion_threshold, m._phase,
                                m._values["PACK_CUTOFF"]))
    assert trace["torch"] == trace["jax"]
    assert not tm.active
    assert len({t[1] for t in trace["torch"]}) > 1   # the threshold moved
    w = hvd.basics.world()
    assert w.config.get(tconfig.FUSION_THRESHOLD) == \
        jbasics.world().config.get(jconfig.FUSION_THRESHOLD)
    assert w.config.get(tconfig.PACK_CUTOFF) == \
        jbasics.world().config.get(jconfig.PACK_CUTOFF)
    jlog = _strip_time((tuned_worlds / "jax.log").read_text())
    tlog = _strip_time((tuned_worlds / "torch.log").read_text())
    assert tlog == jlog and any("tuning complete" in x for x in tlog)


def test_fallback_optimizer_matches_jax():
    rng = np.random.RandomState(0)
    for lo, hi in ((20.0, 28.0), (12.0, 22.0)):
        a, b = jpm._PythonFallbackOptimizer(lo, hi), \
            tpm._PythonFallbackOptimizer(lo, hi)
        for _ in range(12):
            assert a.suggest() == b.suggest()
            x, y = a.suggest(), float(rng.rand())
            a.observe(x, y)
            b.observe(x, y)


def test_no_parameter_manager_without_knob():
    hvd.init(device="cpu")
    try:
        assert hvd.basics.world().parameter_manager is None
    finally:
        hvd.shutdown()


def test_autotune_replans_and_keeps_the_run_bit_identical():
    hvd.init(device="cpu")
    try:
        plain_opt, plain = _train(hvd, 24)
    finally:
        hvd.shutdown()
    assert len(plain_opt.plans) == 1
    hvd.init(device="cpu", config_overrides=TUNE)
    try:
        pm = hvd.basics.world().parameter_manager
        opt, tuned = _train(hvd, 24)
        assert not pm.active                      # both phases ran
        assert len(opt.plans) > 1                 # re-planned
        thresholds = [t for t, _ in opt.plans]
        assert thresholds[0] == 64 * 1024 * 1024
        assert thresholds[-1] == hvd.basics.world().config.get(
            tconfig.FUSION_THRESHOLD) == pm.fusion_threshold
        assert all(t & (t - 1) == 0 for t in thresholds)
        assert len({len(p) for _, p in opt.plans}) > 1   # other buckets
        # every plan covers every parameter once, in readiness order
        names = [n for b in opt.plans[0][1] for n in b]
        assert all([n for b in p for n in b] == names for _, p in opt.plans)
    finally:
        hvd.shutdown()
    for k, v in plain.items():
        assert torch.equal(tuned[k], v)


def test_autotune_flag_reaches_a_parameter_manager():
    """``--autotune`` and its sample flags become the env the workers'
    init() reads, and that env makes a ParameterManager."""
    from horovod_tpu_torch.runner import config_parser, launch
    args = launch.parse_args(["--autotune", "--autotune-warmup-samples",
                              "2", "--autotune-steps-per-sample", "3",
                              "python", "x.py"])
    env = config_parser.set_env_from_args({}, args)
    assert env["HVD_TPU_AUTOTUNE"] == "1"
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        hvd.init(device="cpu")
        pm = hvd.basics.world().parameter_manager
        assert isinstance(pm, tpm.ParameterManager) and pm.active
        assert pm._warmup_samples == 2 and pm._steps_per_sample == 3
    finally:
        hvd.shutdown()
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cross_process_adoption_in_a_gloo_world(tmp_path):
    env = dict(os.environ)
    env.update(HVD_TPU_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               HVD_TPU_SIZE="2",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, HERE, "world", str(tmp_path)],
        env=dict(env, HVD_TPU_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    logs = [p.communicate(timeout=120)[0].decode(errors="replace")
            for p in procs]
    assert [p.returncode for p in procs] == [0, 0], "\n===\n".join(logs)
    res = [json.load(open(tmp_path / f"world.{r}.json")) for r in range(2)]
    assert not res[0]["active"] and not res[1]["active"]
    assert len({len(p) for _, p in res[0]["plans"]}) > 1
    # one sequence of thresholds and bucket plans on every rank
    assert res[0]["plans"] == res[1]["plans"]
    assert res[0]["threshold"] == res[1]["threshold"]
    assert res[0]["params"] == res[1]["params"]
    # the log (rank 0's) names the sequence the ranks adopted
    log = (tmp_path / "autotune.log").read_text()
    assert "knob locked: FUSION_THRESHOLD=" in log
