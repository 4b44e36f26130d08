"""The port's microbenchmarks (horovod_tpu_torch.microbench) against the
JAX package's sections at tiny sizes on the CPU: the collective plane
(eager sweep, bucketed and compiled-plane ResNet-50 gradients), the SDC
guard and the tracer, plus the command line.

Each section must return the JAX section's keys, and every count the
two share must be equal: gradients, megabytes, buckets, the analytic
``wire_mb`` and collectives a step of each compiled-plane variant, steps
and payload sizes. Timings are not compared. The JAX world here spans
conftest's 8 forced CPU devices and the port's one process, so the
compiled plane's ``num_devices`` differs (8 against 1) and is the one
count left out. The generation and fleet sections are in
``test_torch_port_microbench_gen.py`` and ``_fleet.py``.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import horovod_tpu as jhvd
import horovod_tpu_torch as thvd
from horovod_tpu import microbench as jmb
from horovod_tpu_torch import microbench as tmb

from torch_port_microbench_common import key_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_rows():
    if jhvd.is_initialized():
        jhvd.shutdown()
    jhvd.init()
    try:
        return {
            "eager": jmb.eager_sweep(sizes=(1 << 10, 1 << 14), iters=1),
            "bucketed": jmb.bucketed_optimizer_sweep(iters=1),
            "injit": jmb.injit_optimizer_sweep(iters=1),
            "sdc": jmb.sdc_guard_sweep(steps=2, rounds=1,
                                       fingerprint_every=1),
            "tracing": jmb.tracing_overhead_sweep(requests=200, rounds=1),
        }
    finally:
        jhvd.shutdown()


@pytest.fixture(scope="module")
def port_rows():
    thvd.init(device="cpu")
    try:
        return {
            "eager": tmb.eager_sweep(sizes=(1 << 10, 1 << 14), iters=1,
                                     compile_backend="aot_eager"),
            "bucketed": tmb.bucketed_optimizer_sweep(iters=1),
            "injit": tmb.injit_optimizer_sweep(iters=1),
            "sdc": tmb.sdc_guard_sweep(steps=2, rounds=1,
                                       fingerprint_every=1, device="cpu"),
            "tracing": tmb.tracing_overhead_sweep(requests=200, rounds=1),
        }
    finally:
        thvd.shutdown()


def test_resnet50_grad_shapes_match_jax():
    got, want = tmb.resnet50_grad_shapes(), jmb.resnet50_grad_shapes()
    assert len(got) == len(want) == 161
    sizes = [int(np.prod(s)) for s in got]
    assert sum(sizes) == sum(int(np.prod(s)) for s in want) == 25_557_032
    assert sorted(sizes) == sorted(int(np.prod(s)) for s in want)
    # torch's layout: a convolution (kh, kw, in, out) is (out, in, kh, kw)
    assert got[0] == (64, 3, 7, 7) and want[0] == (7, 7, 3, 64)


@pytest.mark.parametrize("section", ["eager", "bucketed", "injit", "sdc",
                                     "tracing"])
def test_section_keys_match_jax(section, jax_rows, port_rows):
    assert key_tree(port_rows[section]) == key_tree(jax_rows[section])


def test_eager_sweep_counts_match_jax(jax_rows, port_rows):
    for t, j in zip(port_rows["eager"], jax_rows["eager"]):
        assert (t["payload_bytes"], t["nproc"]) == \
            (j["payload_bytes"], j["nproc"])
        assert t["eager_allreduce_s"] > 0 and t["injit_reduce_s"] > 0
    assert len(port_rows["eager"]) == len(jax_rows["eager"]) == 2


def test_bucketed_counts_match_jax(jax_rows, port_rows):
    keys = ("scenario", "num_grads", "total_mb", "threshold_mb",
            "num_buckets")
    assert {k: port_rows["bucketed"][k] for k in keys} == \
        {k: jax_rows["bucketed"][k] for k in keys}


def test_compiled_plane_counts_match_jax(jax_rows, port_rows):
    t, j = port_rows["injit"], jax_rows["injit"]
    for k in ("scenario", "num_grads", "total_mb", "threshold_mb",
              "num_buckets"):
        assert t[k] == j[k], k
    for name, row in j["variants"].items():
        for k in ("wire_mb", "collectives_per_step"):
            assert t["variants"][name][k] == row[k], (name, k)
    assert t["num_devices"] == 1
    # one process: the fp32 reductions are the identity, bit for bit
    assert t["variants"]["packed"]["max_abs_err_vs_fp32"] == 0.0


def test_sdc_and_tracing_counts_match_jax(jax_rows, port_rows):
    for k in ("scenario", "platform", "num_grads", "total_mb",
              "steps_timed", "fingerprint_every", "target_pct"):
        assert port_rows["sdc"][k] == jax_rows["sdc"][k], k
    for k in ("scenario", "requests_timed", "call_sites_per_request",
              "spans_per_request_on"):
        assert port_rows["tracing"][k] == jax_rows["tracing"][k], k


def _cli(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m",
                           "horovod_tpu_torch.microbench", *args],
                          capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=ROOT)


def test_command_line_prints_one_line_per_section_and_writes_out(
        tmp_path, monkeypatch, capsys):
    """``main`` in this process, its in-jit reduction compiled with
    aot_eager (inductor's first C++ build on the CPU takes tens of
    seconds); the CLI's argument errors are checked in a subprocess
    below."""
    monkeypatch.setattr(tmb, "eager_sweep", functools.partial(
        tmb.eager_sweep, compile_backend="aot_eager"))
    out = tmp_path / "mb.json"
    rc = tmb.main(["--quick", "--device", "cpu", "--sections",
                   "tracing,eager_1proc", "--out", str(out)])
    stdout = capsys.readouterr().out
    assert rc == 0, stdout[-2000:]
    lines = [json.loads(ln) for ln in stdout.splitlines()
             if ln.startswith("{")]
    assert [ln["section"] for ln in lines] == ["tracing", "eager_1proc"]
    assert lines[1]["device"] == "cpu" and lines[1]["backend"] == "gloo"
    rows = lines[1]["result"]["rows"]
    assert [r["payload_bytes"] for r in rows] == list(tmb.DEFAULT_SIZES[:4])
    assert lines[1]["result"]["bucketed"]["num_grads"] == 161
    doc = json.loads(out.read_text())
    assert doc["quick"] is True and set(doc) >= {"tracing", "eager_1proc"}
    assert not os.path.exists(os.path.join(tmp_path, "MICROBENCH.json"))


def test_command_line_rejects_unknown_sections():
    r = _cli("--device", "cpu", "--sections", "tracing,bogus")
    assert r.returncode == 2 and "bogus" in r.stderr


def test_scaling_section_leaves_out_the_cpu_worlds_on_request(monkeypatch):
    """``cpu_worlds=False`` (what the card's smoke run asks for) keeps
    scaling's one in-process point and spawns no gloo world; the
    default spawns the worlds beside it. The rig is stubbed: this checks
    the section's assembly, not the rig."""
    point = {"num_devices": 1, "images_per_sec_total": 10.0}
    spawned = []
    monkeypatch.setattr(tmb, "scaling_sweep_point",
                        lambda **kw: dict(point))
    monkeypatch.setattr(tmb, "_in_world", lambda dev, fn: fn())

    def spawn(n, args, timeout):
        spawned.append(n)
        return [{"num_devices": n, "images_per_sec_total": 10.0 * n}]
    monkeypatch.setattr(tmb, "_spawn_world", spawn)
    line = tmb.run_section("scaling", True, "cpu", cpu_worlds=False)
    assert spawned == []
    assert line["device"] == "cpu"
    assert [p["num_devices"] for p in line["result"]] == [1]
    assert line["result"][0]["efficiency_vs_1dev"] == 1.0
    line = tmb.run_section("scaling", True, "cpu")
    assert spawned == [2]
    assert [p["num_devices"] for p in line["result"]] == [1, 2]
