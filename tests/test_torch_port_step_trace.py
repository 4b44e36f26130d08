"""The training step's trace in horovod_tpu_torch (``tracing.py``'s step
spans, emitted by ``optimizer.py`` and ``collectives.py``), on the CPU.

A gloo world of 2 (this file is its own worker: ``python
tests/test_torch_port_step_trace.py world``) takes two DistributedOptimizer
steps with the tracer on and reads the second step's trace: one root
``opt.step``, a collective span per bucket with ``dispatch.queue`` and
``dispatch.run`` under it, ``opt.drain`` with the join marker's
``host.sync`` and a ``opt.wait`` per bucket, and ``opt.update``; then one
step under a CPU ``torch.profiler`` session, whose ``hvd.`` ranges hold
the operations their parts launch; then one step with the tracer off,
which makes no span. A world of one, the compiled plane and an unsampled
step under a profiler run in this process.
"""

import json
import os
import select
import socket
import subprocess
import sys
import tempfile
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import collectives as tcoll  # noqa: E402
from horovod_tpu_torch import config as tconfig  # noqa: E402
from horovod_tpu_torch import tracing as ttr  # noqa: E402

#: slack of a span's clock against its parent's, in microseconds (the
#: epoch start of a span read after the fact maps a monotonic reading)
SLACK_US = 500.0
#: a bucket cap that splits the model's gradients into three buckets
BUCKET_BYTES = 700


def _model(seed: int) -> torch.nn.Module:
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(12, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 8), torch.nn.Tanh(),
                               torch.nn.Linear(8, 4))


def _optimizer(model, **kw):
    return hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters(), **kw)


def _step(model, opt, rank: int, k: int) -> None:
    g = torch.Generator().manual_seed(100 * rank + k)
    opt.zero_grad()
    model(torch.randn(6, 12, generator=g)).square().mean().backward()
    opt.step()


def _tracer(on: bool):
    hvd.basics.world().config.set(tconfig.TRACE_SAMPLE, 1.0 if on else 0.0)
    ttr.reset()
    return ttr.tracer()


def _profiled_ranges(fn) -> dict:
    """Run ``fn`` under a CPU profiler; each ``hvd.`` range's name (its
    bucket or tensor name cut) with the operations inside it on its
    thread."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and "dur" in e]
    finally:
        os.remove(path)
    out = {}
    for r in events:
        if not r["name"].startswith("hvd."):
            continue
        lo, hi = float(r["ts"]), float(r["ts"]) + float(r["dur"])
        ops = out.setdefault(r["name"].split(":")[0], set())
        ops.update(e["name"] for e in events
                   if e.get("tid") == r.get("tid") and e is not r
                   and lo <= float(e["ts"]) <= hi)
    return {k: sorted(v) for k, v in out.items()}


def _count_spans(fn) -> int:
    """Spans and step traces constructed while ``fn`` runs."""
    made = []
    span_init, step_init = ttr.Span.__init__, ttr.StepTrace.__init__

    def count(orig):
        def init(self, *a, **k):
            made.append(type(self).__name__)
            orig(self, *a, **k)
        return init
    ttr.Span.__init__, ttr.StepTrace.__init__ = \
        count(span_init), count(step_init)
    try:
        fn()
    finally:
        ttr.Span.__init__, ttr.StepTrace.__init__ = span_init, step_init
    return len(made)


def _worker(mode: str) -> int:
    assert mode == "world"
    hvd.init(device="cpu")
    rank = hvd.rank()
    model = _model(7)
    opt = _optimizer(model, fusion_threshold_bytes=BUCKET_BYTES)
    tr = _tracer(True)
    _step(model, opt, rank, 0)
    wire0 = tcoll.COUNTS["allreduce"]
    _step(model, opt, rank, 1)
    wire = tcoll.COUNTS["allreduce"] - wire0
    spans = tr.spans("step-1")
    ranges = _profiled_ranges(lambda: _step(model, opt, rank, 2))
    _tracer(False)
    off = _count_spans(lambda: _step(model, opt, rank, 3))
    print("RESULT " + json.dumps(
        {"rank": rank, "spans": spans, "wire_calls": wire,
         "buckets": len(opt.plans[-1][1]), "ranges": ranges,
         "spans_made_off": off, "tracer_off": ttr.tracer() is None}),
        flush=True)
    hvd.shutdown()
    return 0


# ---------------------------------------------------------------------------
# spawning
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _result_line(p, deadline):
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


def _spawn(n: int, timeout: float) -> list:
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, HVD_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   HVD_TPU_SIZE=str(n), HVD_TPU_RANK=str(rank),
                   HVD_TPU_LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        env.pop("HVD_TPU_TRACE_SAMPLE", None)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "world"], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    deadline = time.monotonic() + timeout
    try:
        results = [_result_line(p, deadline) for p in procs]
        for p in procs:
            _, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    return sorted(results, key=lambda r: r["rank"])


# ---------------------------------------------------------------------------
# reading a step's trace
# ---------------------------------------------------------------------------

def _tree(spans: list):
    """(root, children by parent span id, spans by id) of one trace."""
    assert len({s["trace"] for s in spans}) == 1
    roots = [s for s in spans if s["parent"] is None]
    assert [r["name"] for r in roots] == ["opt.step"]
    by_id = {s["span"]: s for s in spans}
    kids = {}
    for s in spans:
        if s["parent"] is not None:
            assert s["parent"] in by_id, s
            kids.setdefault(s["parent"], []).append(s)
    return roots[0], kids, by_id


def _named(kids, parent, name):
    return [s for s in kids.get(parent["span"], [])
            if s["name"].startswith(name)]


def _inside(child, parent):
    return (child["ts"] >= parent["ts"] - SLACK_US
            and child["ts"] + child["dur"]
            <= parent["ts"] + parent["dur"] + SLACK_US)


def _check_step(spans, buckets: int, size: int, consistency: str) -> dict:
    """The trace of one eager step of ``buckets`` buckets in a world of
    ``size``; returns the root's args."""
    root, kids, _ = _tree(spans)
    assert all(_inside(s, root) for s in spans)
    grads = _named(kids, root, "collective:grouped_allreduce:grad.bucket.")
    assert len(grads) == buckets
    (drain,) = _named(kids, root, "opt.drain")
    (update,) = _named(kids, root, "opt.update")
    assert _inside(drain, root) and _inside(update, root)
    assert drain["ts"] + drain["dur"] <= update["ts"] + SLACK_US
    waits = _named(kids, drain, "opt.wait")
    assert sorted(w["args"]["bucket"] for w in waits) == list(range(buckets))
    syncs = _named(kids, drain, "host.sync")
    joins = _named(kids, drain, "collective:allreduce:hvd.join.round")
    assert len(syncs) == len(joins) == (1 if size > 1 else 0)
    for s in syncs:
        assert s["args"] == {"what": "join marker"}
    collectives = grads + joins
    for c in collectives:
        assert c["args"]["tensors"] >= 1 and c["args"]["bytes"] > 0
        (queue,) = _named(kids, c, "dispatch.queue")
        (run,) = _named(kids, c, "dispatch.run")
        # queued at the submission, taken after it, run after the wait
        assert c["ts"] - SLACK_US <= queue["ts"] <= c["ts"] + c["dur"] \
            + SLACK_US
        assert run["ts"] >= queue["ts"] + queue["dur"] - SLACK_US
        assert run["args"] == {"consistency": consistency}
    for s in waits + syncs + joins:
        assert _inside(s, drain)
    assert root["args"]["buckets"] == buckets
    assert root["args"]["bytes"] == sum(c["args"]["bytes"] for c in grads)
    assert root["args"]["host_syncs"] == len(syncs)
    assert len(spans) == 1 + 3 * len(collectives) + 2 + len(waits) \
        + len(syncs)
    return root["args"]


def test_gloo_world_of_two_traces_each_step():
    for r in _spawn(2, 60):
        assert r["tracer_off"] and r["spans_made_off"] == 0
        args = _check_step(r["spans"], r["buckets"], 2, "cached")
        assert r["buckets"] == 3
        # the buckets' wire calls and the join marker's, as COUNTS saw them
        assert args["wire_calls"] == r["wire_calls"] == r["buckets"] + 1
        got = r["ranges"]
        assert {"hvd.collective", "hvd.opt.drain", "hvd.opt.wait",
                "hvd.host.sync", "hvd.opt.update"} <= set(got)
        assert "hvd.opt.step" not in got and "hvd.dispatch.queue" not in got
        assert "aten::_local_scalar_dense" in got["hvd.host.sync"]
        assert "aten::copy_" in got["hvd.opt.drain"]      # the write-back
        assert any("SGD.step" in op for op in got["hvd.opt.update"])
        assert not any("FlashAttentionFunctionBackward" in n
                       for n in list(got) + [s["name"] for s in r["spans"]])


@pytest.fixture
def world():
    hvd.init(device="cpu")
    try:
        yield
    finally:
        _tracer(False)
        hvd.shutdown()
        ttr.reset()


def test_world_of_one_traces_each_step(world):
    model = _model(3)
    opt = _optimizer(model, fusion_threshold_bytes=BUCKET_BYTES)
    tr = _tracer(True)
    for k in range(2):
        _step(model, opt, 0, k)
    args = _check_step(tr.spans("step-1"), 3, 1, "skipped")
    assert args["wire_calls"] == 3 and args["host_syncs"] == 0
    assert {s["trace"] for s in tr.spans()} == {"step-0", "step-1"}


def test_tracer_off_makes_no_span(world):
    model = _model(3)
    opt = _optimizer(model, fusion_threshold_bytes=BUCKET_BYTES)
    assert _tracer(False) is None
    assert _count_spans(lambda: _step(model, opt, 0, 0)) == 0
    assert opt._trace is None and ttr.current() is None


def test_unsampled_step_opens_ranges_under_a_profiler(world):
    model = _model(3)
    opt = _optimizer(model, fusion_threshold_bytes=BUCKET_BYTES)
    assert _tracer(False) is None
    got = _profiled_ranges(lambda: _step(model, opt, 0, 0))
    assert {"hvd.collective", "hvd.opt.drain", "hvd.opt.wait",
            "hvd.opt.update"} <= set(got)
    assert "aten::cat" not in got["hvd.collective"]   # the dispatcher's
    assert ttr.current() is None


def test_compiled_plane_traces_step_and_update(world):
    model = _model(5)
    opt = _optimizer(model, axis_name="cross", packing="packed")
    tr = _tracer(True)
    _step(model, opt, 0, 0)
    spans = tr.spans("step-0")
    root, kids, _ = _tree(spans)
    assert sorted(s["name"] for s in spans) == ["opt.step", "opt.update"]
    (update,) = _named(kids, root, "opt.update")
    assert _inside(update, root)


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))
