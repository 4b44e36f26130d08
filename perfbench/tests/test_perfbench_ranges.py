"""The readers of the program's ``hvd.`` ranges (``ranges.py``,
``metrics/reduction_device_ms.py``, ``metrics/idle_in_reduction_pct.py``)
on a trace written by hand, and where a run opens them: in the profiled
windows only, never with the tracer on."""

import json
import time

import pytest

from perfbench import counts, ranges, worker
from perfbench.spec import load_metric
from perfbench.tests import tiny
from perfbench.trace import Trace, TracedRun


def _ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _load(tmp_path, events) -> Trace:
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return Trace.load(str(path))


def _run(trace) -> TracedRun:
    return TracedRun(trace=trace, host_trace=trace, steps=2, phases=[],
                     window_s=1e-3, step_ms=[0.5, 0.5], config={},
                     traffic={}, chips=1, flops_per_step=1.0,
                     peaks=counts.PEAKS["h100"])


@pytest.fixture
def trace(tmp_path):
    """Main thread 1, autograd thread 2, the dispatcher 9 (no host
    operation recorded, only its launches)."""
    return _load(tmp_path, [
        _ev("user_annotation", "perfbench.window", 0, 1000),
        # the backward: a bucket's submission on the autograd thread
        _ev("cpu_op", "aten::mm", 0, 100, tid=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 2, tid=2, correlation=1),
        _ev("kernel", "gemm", 20, 180, tid=7, correlation=1),
        _ev("user_annotation",
            "hvd.collective:grouped_allreduce:grad.bucket.0.2of2.ab", 250,
            50, tid=2),
        # the dispatcher: cat and scale of the bucket
        _ev("cuda_runtime", "cudaLaunchKernel", 310, 2, tid=9,
            correlation=2),
        _ev("kernel", "CatArrayBatchedCopy", 320, 30, tid=7, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 320, 2, tid=9,
            correlation=3),
        _ev("kernel", "vectorized_elementwise_kernel", 400, 20, tid=7,
            correlation=3),
        # step(): the drain (a wait, the write-back), then the update
        _ev("user_annotation", "hvd.opt.drain", 500, 300),
        _ev("user_annotation", "hvd.opt.wait", 510, 90),
        _ev("cuda_runtime", "cudaLaunchKernel", 700, 2, correlation=4),
        _ev("kernel", "direct_copy_kernel", 720, 40, tid=7, correlation=4),
        _ev("user_annotation", "hvd.opt.update", 800, 150),
        _ev("cuda_runtime", "cudaLaunchKernel", 810, 2, correlation=5),
        _ev("kernel", "multi_tensor_apply_kernel", 820, 100, tid=7,
            correlation=5),
        # a launch outside the window
        _ev("cuda_runtime", "cudaLaunchKernel", 1500, 2, tid=9,
            correlation=6),
        _ev("kernel", "late", 1510, 10, tid=7, correlation=6),
    ])


def test_intervals():
    assert ranges.merged([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert ranges.overlap_us([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert ranges.overlap_us([], [(0, 1)]) == 0


def test_launches_by_range_and_by_thread(trace):
    assert ranges.launches_under(
        trace, ranges.ranges(trace, ("hvd.opt.drain",))) == {4}
    assert ranges.unfollowed_launches(trace) == {2, 3}
    assert ranges.device_us(trace, {2, 3, 4}) == 90


def test_reduction_device_ms(trace):
    # the dispatcher's cat and scale (50 us) and the write-back (40 us),
    # over two steps; neither the backward's gemm nor the update counts
    got = load_metric("reduction_device_ms").read(_run(trace))
    assert got == pytest.approx(0.045)


def test_idle_in_reduction_pct(trace):
    # busy [20, 200] [320, 350] [400, 420] [720, 760] [820, 920]: idle
    # 20 + 120 + 50 + 300 + 60 + 80 = 630 us; inside a range: [250, 300],
    # [500, 720], [760, 820], [920, 950], 360 us
    got = load_metric("idle_in_reduction_pct").read(_run(trace))
    assert got == pytest.approx(100 * 360 / 630)


def test_a_program_without_the_ranges_reads_nothing(tmp_path):
    trace = _load(tmp_path, [
        _ev("user_annotation", "perfbench.window", 0, 1000),
        _ev("cpu_op", "Optimizer.step#AdamW.step", 500, 300),
        _ev("cuda_runtime", "cudaLaunchKernel", 310, 2, tid=9,
            correlation=2),
        _ev("kernel", "CatArrayBatchedCopy", 320, 30, tid=7, correlation=2),
    ])
    for name in ("reduction_device_ms", "idle_in_reduction_pct"):
        assert load_metric(name).read(_run(trace)) is None


@pytest.mark.parametrize("trace_flag", [False, True])
def test_step_traces_only_under_the_profiler(tmp_path, monkeypatch,
                                             trace_flag):
    """The tracer stays off through a run (``--trace 0`` and ``1``); a
    step opens ranges only while a profiler records, so the window and
    the phases window run as without them."""
    import torch
    from torch.autograd import profiler as P
    from horovod_tpu_torch import tracing
    torch.set_num_threads(4)
    monkeypatch.delenv("HVD_TPU_TRACE_SAMPLE", raising=False)
    made, tracers = [], []
    step_trace = tracing.step_trace

    def spy(n, t0):
        tracers.append(tracing.tracer())
        tr = step_trace(n, t0)
        if tr is not None:
            made.append(P._is_profiler_enabled)
        return tr
    monkeypatch.setattr(tracing, "step_trace", spy)
    root = tiny.make(str(tmp_path))
    r = worker.run_rank("tiny_lm", 2**31 + 21, 0.2, trace_flag, time.time(),
                        device="cpu", root=root, check_chip=False)
    assert tracers and all(t is None for t in tracers)
    assert tracing.tracer() is None
    # two profiled passes of trace_steps + 1 steps each, every step traced
    profiled = 2 * (2 + 1) if trace_flag else 0
    assert made == [True] * profiled
    if trace_flag:
        got = r["per_rank_metrics"][0]
        assert got["idle_in_reduction_pct"] >= 0
        assert got["reduction_device_ms"] == 0   # no device on the CPU
