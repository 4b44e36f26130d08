"""Reading a traced window from a Chrome trace, on a trace written by
hand."""

import json

import pytest

from perfbench import counts
from perfbench.spec import load_metric
from perfbench.trace import Trace, TracedRun


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


@pytest.fixture
def trace(tmp_path):
    events = [
        _ev("user_annotation", "perfbench.window", 0, 1000),
        _ev("cpu_op", "aten::mm", 10, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 2, correlation=1),
        _ev("kernel", "gemm", 40, 200, tid=7, correlation=1),
        _ev("cpu_op", "autograd::engine::evaluate_function: "
            "FlashAttentionFunctionBackward", 300, 100, tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 310, 2, tid=2,
            correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 390, 2, tid=2,
            correlation=3),
        _ev("kernel", "bwd_a", 400, 100, tid=7, correlation=2),
        _ev("kernel", "bwd_b", 450, 100, tid=8, correlation=3),
        _ev("cpu_op", "aten::item", 560, 300),
        _ev("kernel", "flash_fwd_kernel<bf16>", 900, 50, tid=7,
            correlation=9),
        _ev("kernel", "outside", 2000, 50, tid=7, correlation=10),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace.load(str(path))


def test_busy_and_window(trace):
    assert trace.window_s == pytest.approx(1e-3)
    # [40, 240] + [400, 550] (two streams overlapping) + [900, 950]
    assert trace.busy_s == pytest.approx(400e-6)


def test_idle_gaps_name_the_host_operation(trace):
    gaps = trace.idle_gaps()
    assert gaps[0] == ["aten::item", pytest.approx(350e-6)]
    assert [g[1] for g in gaps] == sorted([g[1] for g in gaps],
                                          reverse=True)
    assert len(gaps) == 4     # before, between twice, after


def test_device_time_under_an_operation(trace):
    assert trace.device_seconds_under("FlashAttentionFunctionBackward") \
        == pytest.approx(200e-6)
    assert trace.device_seconds_under("NoSuchNode") is None
    assert trace.kernel_durations("flash_fwd") == [pytest.approx(50e-6)]
    assert trace.top_device_ops(2) == [["gemm", pytest.approx(200e-6)],
                                       ["bwd_a", pytest.approx(100e-6)]]


def _run(trace, step_ms=(1.0, 3.0)):
    cfg = {"n_head": 16, "n_embd": 1024}
    traffic = {"batch_per_chip": 8, "seq_len": 1024}
    return TracedRun(trace=trace, host_trace=trace, steps=2,
                     phases=[{"forward": 1.0, "backward": 3.0, "drain": 0.5},
                             {"forward": 3.0, "backward": 5.0, "drain": 0.5}],
                     window_s=1.6e-3, step_ms=list(step_ms), config=cfg,
                     traffic=traffic, chips=1, flops_per_step=1e9,
                     peaks=counts.PEAKS["h100"])


def test_metric_readers(trace):
    run = _run(trace)
    read = {n: load_metric(n).read(run) for n in
            ("forward_ms", "backward_ms", "drain_ms", "device_idle_pct",
             "attn_bwd_ms", "flash_fwd_roofline", "step_mfu",
             "train_step_ms_p90.dp4", "comm_exposed_pct.dp4")}
    assert read["forward_ms"] == 2.0 and read["backward_ms"] == 4.0
    assert read["drain_ms"] == 0.5
    # 400 us busy in a window of 1000 us
    assert read["device_idle_pct"] == pytest.approx(60.0)
    assert read["attn_bwd_ms"] == pytest.approx(0.1)
    least = counts.flash_bound(128, 1024, 64, True)[2]
    assert read["flash_fwd_roofline"] == pytest.approx(100 * least / 50e-6)
    # 1.6 ms over two steps
    assert read["step_mfu"] == pytest.approx(100 * 1e9 / 0.8e-3 / 989e12)
    assert read["train_step_ms_p90.dp4"] == pytest.approx(2.8)
    # no NCCL kernel in the window: nothing to read
    assert read["comm_exposed_pct.dp4"] is None


def test_nccl_time_is_idle_for_compute_and_exposed_where_alone(tmp_path):
    events = [
        _ev("user_annotation", "perfbench.window", 0, 1000),
        _ev("kernel", "gemm", 100, 200, tid=7, correlation=1),
        # NCCL spinning beside the gemm, then alone
        _ev("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 250, 250,
            tid=9, correlation=2),
        _ev("kernel", "gemm", 600, 100, tid=7, correlation=3),
        _ev("cpu_op", "Optimizer.step#AdamW.step", 300, 300),
    ]
    path = tmp_path / "n.json"
    path.write_text(json.dumps({"traceEvents": events}))
    trace = Trace.load(str(path))
    assert trace.busy_s == pytest.approx(500e-6)
    assert trace.compute_busy_s == pytest.approx(300e-6)
    assert trace.comm_only_s == pytest.approx(200e-6)
    run = _run(trace)
    assert load_metric("comm_exposed_pct.dp4").read(run) == \
        pytest.approx(20.0)
    assert load_metric("device_idle_pct").read(run) == pytest.approx(70.0)
    # the gap under the optimizer's step is named by it, NCCL or not
    assert ["Optimizer.step#AdamW.step", pytest.approx(300e-6)] in \
        trace.idle_gaps()
    assert trace.top_device_ops(1)[0][0].startswith("gemm")


@pytest.fixture
def card():
    """Skip unless this machine has a CUDA card (decided when the test
    runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
def test_a_traced_run_reports_every_metric_on_the_card(card, tmp_path):
    import time
    from perfbench import spec, worker
    from perfbench.tests import tiny
    root = tiny.make(str(tmp_path))
    r = worker.run_rank("tiny_lm", 2**31 + 3, 1.0, True, time.time(),
                        root=root)
    names = {m["name"] for m in spec.cell("tiny_lm", root).per_layer}
    # one chip: no NCCL kernel, so the exchange's share reads nothing
    assert set(r["per_rank_metrics"][0]) == names
    assert 0 < r["busy_s"][0] <= r["window_s"][0]


def test_the_card_sampler_summarises_its_samples():
    from perfbench import card
    s = card.Sampler(0)
    s.out = "1980, 650.5, 60\n1755, 700.0, 62\n[N/A], 1, 2\n"
    got = s.summary()
    assert got["samples"] == 2
    assert got["clocks.sm"] == [1755.0, pytest.approx(1867.5), 1980.0]
    assert got["power.draw"][2] == 700.0
    s.out = ""
    assert s.summary() is None
