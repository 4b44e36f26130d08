"""The port's telemetry (horovod_tpu_torch: metrics, timeline, tracing,
schedule ledger, and their wiring into the dispatch path) against the JAX
package's, which is the oracle, on the CPU.

Host logic is held bit for bit against the JAX modules fed the same
inputs: registry text, snapshot and ``aggregate``; the metric series and
their help text that one sequence of verbs leaves behind (histogram
values aside: those are wall times); sampling decisions and trace-context
encoding; ledger digests and ``diff_ledgers`` messages. The timeline of a
fixed verb sequence has the JAX one's events apart from timestamps and the
wire activity's name; the port's span file merges through
``tools/trace.merge``. A gloo world of 2 (``torch_port_telemetry_worker
.py``) checks ``metrics_allgather_summary`` and a seeded schedule
divergence, as ``tests/metrics_worker.py`` and
``schedule_divergence_worker.py`` do for the JAX package. No tolerance:
every comparison here is exact.
"""

import json
import os
import queue
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import horovod_tpu as jhvd
import horovod_tpu_torch as hvd
from horovod_tpu import _schedule as jsched
from horovod_tpu import metrics as jmetrics
from horovod_tpu import response_cache as _jrc  # noqa: F401 — its families
from horovod_tpu import stall as _jstall  # noqa: F401
from horovod_tpu import timeline as jtl
from horovod_tpu import tracing as jtr
from horovod_tpu_torch import _schedule as tsched
from horovod_tpu_torch import config as tconfig
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch import stall as tstall
from horovod_tpu_torch import timeline as ttl
from horovod_tpu_torch import tracing as ttr
from horovod_tpu_torch.exceptions import StallError
from tools import trace as trace_tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_port_telemetry_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the registry: text, snapshot, aggregate
# ---------------------------------------------------------------------------

def _drive_registry(reg, seed: int) -> None:
    """One seeded sequence of registrations and writes."""
    rng = np.random.RandomState(seed)
    ops = reg.counter("t_ops_total", "Ops by verb.", labels=("op",))
    depth = reg.gauge("t_depth", "Queue depth.")
    lat = reg.histogram("t_latency_seconds", "Latency by verb.",
                        labels=("op",))
    sizes = reg.histogram("t_batch_size", "", buckets=(1, 2, 4, 8, 16))
    odd = reg.counter("t_labels_total", "Escaped label values.",
                      labels=("path",))
    for _ in range(40):
        op = ["allreduce", "allgather", "broadcast"][rng.randint(3)]
        ops.labels(op=op).inc(float(rng.randint(1, 5)))
        depth.set(float(rng.randint(0, 9)))
        lat.labels(op=op).observe(float(rng.exponential(0.01)))
        sizes.observe(float(rng.randint(1, 20)))
    depth.dec(0.5)
    for value in ('a"quoted"', "back\\slash", "new\nline"):
        odd.labels(path=value).inc()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_text_and_snapshot_match_jax(seed):
    jreg, treg = jmetrics.Registry(), tmetrics.Registry()
    _drive_registry(jreg, seed)
    _drive_registry(treg, seed)
    assert treg.render_prometheus() == jreg.render_prometheus()
    assert treg.snapshot() == jreg.snapshot()


@pytest.mark.parametrize("seeds", [(0, 1), (3, 4, 5)])
def test_aggregate_matches_jax(seeds):
    snaps = []
    for seed in seeds:
        reg = tmetrics.Registry()
        _drive_registry(reg, seed)
        snaps.append(reg.snapshot())
    assert tmetrics.aggregate(snaps) == jmetrics.aggregate(snaps)
    h = "t_batch_size"
    assert tmetrics._merge_hist(snaps[0][h], snaps[1][h]) \
        == jmetrics._merge_hist(snaps[0][h], snaps[1][h])


def test_dump_and_lazy_exports(tmp_path):
    assert hvd.metrics_snapshot is tmetrics.snapshot
    assert hvd.metrics_allgather_summary is tmetrics.metrics_allgather_summary
    path = str(tmp_path / "m.json")
    tmetrics.dump(path)
    with open(path) as f:
        assert json.load(f).keys() == tmetrics.snapshot().keys()


def test_configure_binds_rank_zero_and_survives_a_taken_port(monkeypatch):
    class _W:
        rank = 0
        config = tconfig.Config({"METRICS_PORT": _free_port(),
                                 "METRICS_ADDR": "127.0.0.1"})
    server = tmetrics.configure(_W())
    try:
        port = server.server_address[1]
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10).read().decode()
        assert "# TYPE hvd_tpu_collective_ops_total counter" in text
        # a second endpoint on the same port: logged, not raised
        _W.config = tconfig.Config({"METRICS_PORT": port,
                                    "METRICS_ADDR": "127.0.0.1"})
        assert tmetrics.configure(_W()) is None
        # rank 1 serves nothing without METRICS_ALL_RANKS
        _W.rank = 1
        _W.config = tconfig.Config({"METRICS_PORT": _free_port()})
        assert tmetrics.configure(_W()) is None
    finally:
        tmetrics.stop_http_server(server)


# ---------------------------------------------------------------------------
# the dispatch path's series, one verb sequence through both packages
# ---------------------------------------------------------------------------

PATH_FAMILIES = (
    "hvd_tpu_collective_ops_total", "hvd_tpu_collective_bytes_total",
    "hvd_tpu_collective_dispatch_seconds", "hvd_tpu_dispatcher_queue_depth",
    "hvd_tpu_consistency_checks_total", "hvd_tpu_response_cache_hits_total",
    "hvd_tpu_response_cache_misses_total",
    "hvd_tpu_response_cache_evictions_total", "hvd_tpu_init_total",
    "hvd_tpu_shutdown_total", "hvd_tpu_world_size",
    "hvd_tpu_timeline_events_total", "hvd_tpu_timeline_dropped_total",
    "hvd_tpu_stall_warnings_total", "hvd_tpu_stall_shutdowns_total",
    "hvd_tpu_schedule_divergences_total")


def _verbs_jax(names=("v.ar", "v.gar", "v.bc", "v.gbc", "v.ag", "v.at")):
    a, g, b, gb, ag, at = names
    jhvd.allreduce(np.ones(8, np.float32), op=jhvd.Sum, name=a)
    jhvd.grouped_allreduce([np.ones(2, np.float32), np.ones(3, np.float32)],
                           op=jhvd.Sum, name=g)
    jhvd.broadcast(np.arange(4, dtype=np.float32), root_rank=0, name=b)
    jhvd.grouped_broadcast([np.ones(2, np.float32)], root_rank=0, name=gb)
    jhvd.allgather(np.ones((2, 3), np.float32), name=ag)
    jhvd.alltoall(np.ones((2, 3), np.float32), name=at)


def _verbs_port(names=("v.ar", "v.gar", "v.bc", "v.gbc", "v.ag", "v.at")):
    a, g, b, gb, ag, at = names
    hvd.allreduce(torch.ones(8), op=hvd.Sum, name=a)
    hvd.grouped_allreduce([torch.ones(2), torch.ones(3)], op=hvd.Sum, name=g)
    hvd.broadcast(torch.arange(4, dtype=torch.float32), root_rank=0, name=b)
    hvd.grouped_broadcast([torch.ones(2)], root_rank=0, name=gb)
    hvd.allgather(torch.ones(2, 3), name=ag)
    hvd.alltoall(torch.ones(2, 3), name=at)


def _path_series(snap):
    return {k: v for k, v in snap.items()
            if k.split("{")[0] in PATH_FAMILIES}


GAUGES = ("hvd_tpu_world_size", "hvd_tpu_dispatcher_queue_depth")


def _delta(before, after):
    """Counters and histogram counts as the change (histogram values are
    times), gauges as they stand."""
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            out[k] = v["count"] - before.get(k, {"count": 0})["count"]
        elif k in GAUGES:
            out[k] = v
        else:
            out[k] = v - before.get(k, 0.0)
    return out


def _help_and_type(text):
    return [line for line in text.splitlines() if line.startswith("#")
            and line.split()[2] in PATH_FAMILIES]


def _run_jax(verbs=_verbs_jax):
    if jhvd.is_initialized():
        jhvd.shutdown()
    jhvd.init()
    try:
        verbs()
    finally:
        jhvd.shutdown()


def _run_port(verbs=_verbs_port):
    hvd.init(device="cpu")
    try:
        verbs()
    finally:
        hvd.shutdown()


def test_dispatch_path_series_match_jax(monkeypatch):
    monkeypatch.delenv("HVD_TPU_TIMELINE", raising=False)
    before = _path_series(jmetrics.snapshot())
    _run_jax()
    jax_delta = _delta(before, _path_series(jmetrics.snapshot()))
    before = _path_series(tmetrics.snapshot())
    _run_port()
    port_delta = _delta(before, _path_series(tmetrics.snapshot()))
    assert port_delta == jax_delta
    assert port_delta['hvd_tpu_collective_ops_total{op="alltoall"}'] == 1
    assert port_delta['hvd_tpu_collective_bytes_total{op="grouped_allreduce"}'] \
        == 20
    assert port_delta["hvd_tpu_init_total"] == 1
    assert _help_and_type(tmetrics.render_prometheus()) \
        == _help_and_type(jmetrics.render_prometheus())
    # the JAX package's in-jit series has no port counterpart
    assert "hvd_tpu_injit_lowerings_total" not in tmetrics.render_prometheus()


# ---------------------------------------------------------------------------
# timeline
# ---------------------------------------------------------------------------

def _structure(events, wire_prefix):
    """(lane name, event name, phase) per event, in order, the wire
    activity's backend prefix written as the JAX package's XLA_."""
    lanes = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "thread_name"}
    out = []
    for e in events:
        name = e["name"]
        if name.startswith(wire_prefix):
            name = "XLA_" + name[len(wire_prefix):]
        out.append((lanes[e["tid"]], name, e["ph"]))
    return out


def _read_timeline(path):
    with open(path) as f:
        return [e for e in json.load(f) if e]


def test_timeline_structure_matches_jax(tmp_path, monkeypatch):
    """allreduce and grouped allreduce leave the JAX package's events;
    broadcast, grouped broadcast, allgather and alltoall leave them plus
    one wire activity each, because in a world of one the JAX package
    moves nothing for them and the port still makes its gloo call
    (NCCL's device copy on the card). Every collective then ends with
    one more ``E`` in the port: it closes the verb's own span, opened at
    submit, which the JAX package never closes (a fault of the
    reference, repaired in the port only)."""
    monkeypatch.setenv("HVD_TPU_TIMELINE", str(tmp_path / "jax.json"))
    _run_jax()
    monkeypatch.setenv("HVD_TPU_TIMELINE", str(tmp_path / "port.json"))
    _run_port()
    jax_ev = _structure(_read_timeline(tmp_path / "jax.json"), "XLA_")
    port_ev = _structure(_read_timeline(tmp_path / "port.json"), "GLOO_")
    extra = {"v.bc": "XLA_BROADCAST", "v.gbc": "XLA_BROADCAST",
             "v.ag": "XLA_ALLGATHER", "v.at": "XLA_ALLTOALL"}
    want = []
    for i, (lane, name, ph) in enumerate(jax_ev):
        want.append((lane, name, ph))
        if ph == "B" and lane in extra:
            want += [(lane, extra[lane], "B"), (lane, "", "E")]
        if i + 1 == len(jax_ev) or jax_ev[i + 1][0] != lane:
            want.append((lane, "", "E"))    # the verb's span closes
    assert port_ev == want
    raw = _read_timeline(tmp_path / "port.json")
    assert {e["name"] for e in raw if e["ph"] == "B"} >= {
        "ALLREDUCE", "GLOO_ALLREDUCE", "GROUPED_ALLREDUCE", "GLOO_ALLGATHER",
        "GLOO_BROADCAST", "GLOO_ALLTOALL"}


def test_wire_activity_names():
    assert ttl.wire_activity("nccl", "grouped_allreduce") == "NCCL_ALLREDUCE"
    assert ttl.wire_activity("gloo", "grouped_broadcast") == "GLOO_BROADCAST"
    assert ttl.wire_activity("nccl", "alltoall") == "NCCL_ALLTOALL"
    for name in ("QUEUE", "FUSE", "DISPATCH", "WAIT_FOR_DATA",
                 "MEMCPY_IN_FUSION_BUFFER", "MEMCPY_OUT_FUSION_BUFFER",
                 "NEGOTIATE"):
        assert getattr(ttl, name) == getattr(jtl, name) == name
    assert ttl.DEVICE_PID_OFFSET == jtl.DEVICE_PID_OFFSET


def test_timeline_splices_profiler_trace_on_host_clock(tmp_path):
    """A torch.profiler session inside the timeline lands in the same file
    at pid + DEVICE_PID_OFFSET, shifted so that the sync marker sits at
    the host time it was entered (as the JAX package's test of
    splice_jax_trace checks its XLA session)."""
    _splice_and_check(tmp_path)


def _splice_and_check(tmp_path):
    path = str(tmp_path / "tl.json")
    tl = ttl.Timeline(path)
    tl.start("t0", "allreduce")
    tl.start_torch_trace(str(tmp_path / "dev"))
    x = torch.randn(64, 64)
    (x @ x).sum().item()
    tl.stop_torch_trace()
    tl.activity_start("t0", "GLOO_ALLREDUCE")
    tl.activity_end("t0")
    tl.close()
    events = _read_timeline(path)
    host = [e for e in events if e.get("pid", 0) < ttl.DEVICE_PID_OFFSET]
    dev = [e for e in events if e.get("pid", 0) >= ttl.DEVICE_PID_OFFSET]
    assert [e["name"] for e in host if e["ph"] == "B"] == [
        "ALLREDUCE", "GLOO_ALLREDUCE"]
    assert any(e.get("ph") == "X" and "mm" in e["name"] for e in dev)
    marker = [e for e in dev if e["name"] == ttl.SYNC_MARKER]
    assert len(marker) == 1
    b0 = [e["ts"] for e in host if e["ph"] == "B"]
    # the marker was entered between the two host events
    assert b0[0] <= marker[0]["ts"] <= b0[1]
    assert max(e["ts"] for e in dev if "ts" in e) <= b0[1]


@pytest.mark.parametrize("run", range(5))
def test_timeline_splice_holds_under_cpu_load(tmp_path, run):
    """The same splice and checks beside two CPU-bound threads of this
    process. Their hold on the interpreter lock delays the profiler's
    stamp of a sync marker behind the host's clock read by up to a switch
    interval; a shift taken from the midpoint of two reads around the
    marker then placed the session's last events after the next host
    event in most runs."""
    stop = threading.Event()

    def spin():
        n = 0
        while not stop.is_set():
            n += 1
    threads = [threading.Thread(target=spin, daemon=True) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        _splice_and_check(tmp_path)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)


def test_splice_shift_is_the_largest_lower_bound(tmp_path):
    """Each marker bounds the profiler-to-host shift from below; the
    splice takes the largest bound, and a marker missing from the trace
    bounds nothing."""
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"name": ttl.SYNC_MARKER, "ph": "X", "ts": 100.0, "dur": 1,
         "pid": 1, "tid": 1},
        {"name": "op", "ph": "X", "ts": 150.0, "dur": 1, "pid": 1,
         "tid": 1},
        {"name": ttl.SYNC_END_MARKER, "ph": "X", "ts": 200.0, "dur": 1,
         "pid": 1, "tid": 1}]}))
    for markers, shift in (({ttl.SYNC_MARKER: 1000.0,
                             ttl.SYNC_END_MARKER: 1130.0}, 930.0),
                           ({ttl.SYNC_MARKER: 1000.0,
                             ttl.SYNC_END_MARKER: 1090.0}, 900.0),
                           ({ttl.SYNC_MARKER: 1000.0,
                             "not_in_the_trace": 5000.0}, 900.0)):
        tl = tmp_path / f"tl{shift}.json"
        tl.write_text("[\n")
        assert ttl.splice_torch_trace(str(tl), str(trace), markers) == 3
        op = [e for e in ttl._read_events(str(tl)) if e.get("name") == "op"]
        assert op[0]["ts"] == 150.0 + shift


def test_standalone_profiler_session_exports_a_chrome_trace(tmp_path):
    """start_torch_profiler/stop_torch_profiler, the counterparts of the
    JAX package's start_jax_profiler/stop_jax_profiler, leave a Chrome
    trace of the session in the logdir."""
    ttl.start_torch_profiler(str(tmp_path / "prof"))
    x = torch.randn(32, 32)
    (x @ x).sum().item()
    path = ttl.stop_torch_profiler()
    assert os.path.dirname(path) == str(tmp_path / "prof")
    names = {e.get("name") for e in ttl._read_events(path)}
    assert "aten::mm" in names


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_record_writer_drops_past_its_bound(tmp_path, pkg):
    mod, met = (jtl, jmetrics) if pkg == "jax" else (ttl, tmetrics)
    w = mod.RecordWriter(str(tmp_path / "r.jsonl"), mode="jsonl", maxsize=4)
    before = met.snapshot()["hvd_tpu_timeline_dropped_total"]
    full = queue.Queue(maxsize=1)
    full.put({"a": 1})
    real, w._q = w._q, full
    assert w.put({"b": 2}) is False
    w._q = real
    assert met.snapshot()["hvd_tpu_timeline_dropped_total"] == before + 1
    assert w.put({"c": 3}) is True
    assert w.close()
    with open(tmp_path / "r.jsonl") as f:
        assert [json.loads(line) for line in f] == [{"c": 3}]


# ---------------------------------------------------------------------------
# request tracing
# ---------------------------------------------------------------------------

def test_sampling_decisions_match_jax():
    rng = np.random.RandomState(7)
    ids = ["%016x" % rng.randint(0, 2**62) for _ in range(3000)] + ["", "x"]
    for rate in (-1.0, 0.0, 0.001, 0.1, 0.5, 0.999, 1.0, 2.0):
        assert [ttr.sampled(i, rate) for i in ids] \
            == [jtr.sampled(i, rate) for i in ids]


def test_trace_context_encoding_matches_jax():
    raws = ["abc:def", "abc:", ":def", "abc", "", None, 7, "a:b:c",
            "0123456789abcdef:fedcba9876543210"]
    for raw in raws:
        got, want = ttr.TraceContext.decode(raw), jtr.TraceContext.decode(raw)
        assert (got is None) == (want is None), raw
        if got is not None:
            assert (got.trace_id, got.span_id, got.encode()) \
                == (want.trace_id, want.span_id, want.encode())
    assert ttr.TraceContext("t", "s").encode() \
        == jtr.TraceContext("t", "s").encode()
    for name in ("TRACE_PARENT_HEADER", "ATTEMPT_HEADER", "KV_SCOPE"):
        assert getattr(ttr, name) == getattr(jtr, name)


def _trace_one_request(tr_mod, rid):
    with tr_mod.request_span("server.infer", rid, args={"rows": 1}) as root:
        t0 = time.monotonic()
        ctx = tr_mod.current()
        with tr_mod.span("engine.child", args={"k": 1}):
            tr_mod.collective(("allreduce", "grad.0"))
        tr_mod.emit_span(ctx, "batch.queue", t0, args={"rows": 1})
        with tr_mod.span_for(ctx, "batch.forward", args={"rows": 1}):
            pass
    return root


def _shape(spans):
    by_id = {s["span"]: s for s in spans}
    return sorted((s["name"], by_id[s["parent"]]["name"]
                   if s["parent"] in by_id else None,
                   json.dumps(s.get("args"), sort_keys=True))
                  for s in spans)


def test_span_files_match_jax_and_merge(tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_TPU_TRACE_SAMPLE", "1")
    shapes = {}
    for name, mod in (("jax", jtr), ("port", ttr)):
        monkeypatch.setenv("HVD_TPU_TRACE_DIR", str(tmp_path / name))
        mod.reset()
        rid = "feedfacecafebeef"
        _trace_one_request(mod, rid)
        path = mod.tracer().span_path
        mod.reset()                 # closes the span writer
        spans = trace_tool.load_span_file(path)
        assert len(spans) == 5 and {s["trace"] for s in spans} == {rid}
        shapes[name] = _shape(spans)
        doc = trace_tool.merge(rid, spans)
        assert set(trace_tool.span_names(doc)) == {
            "server.infer", "engine.child", "collective:allreduce:grad.0",
            "batch.queue", "batch.forward"}
    assert shapes["port"] == shapes["jax"]
    assert ("batch.forward", "server.infer", '{"rows": 1}') \
        in shapes["port"]
    monkeypatch.delenv("HVD_TPU_TRACE_SAMPLE")
    jtr.reset()
    ttr.reset()


def test_unsampled_requests_cost_nothing_but_are_noted(monkeypatch):
    monkeypatch.delenv("HVD_TPU_TRACE_SAMPLE", raising=False)
    ttr.reset()
    assert ttr.tracer() is None
    with ttr.request_span("server.infer", "r-1") as sp:
        assert sp.sampled is False
    assert ttr.last_request_id() == "r-1"
    ttr.reset()
    assert ttr.last_request_id() is None


# ---------------------------------------------------------------------------
# schedule ledger
# ---------------------------------------------------------------------------

class _PSet:
    def __init__(self, key):
        self.cache_key = key


LEDGER_ENTRIES = [
    ("allreduce", "grad.0", (4, 3), "float32", "average", 1.0, 1.0),
    ("grouped_allreduce", "bucket.0", ((2,), (3, 4)), ("float32", "bfloat16"),
     "sum", 1.0, 0.5),
    ("allgather", "feat", (5, 7), "float32"),
    ("alltoall", "tok", (6, 2), "int64", (1, 2, 3)),
    ("broadcast", "w", (3,), "float32", 0),
    ("grouped_broadcast", "ws", ((2,), (1,)), ("float32", "float32"), 1),
    ("allreduce", "hvd.join.round", (1,), "float32", "sum", 1.0, 1.0),
]


@pytest.mark.parametrize("pset", [None, _PSet((0, 1))])
def test_ledger_digests_match_jax(pset):
    jl, tl = jsched.ScheduleLedger(), tsched.ScheduleLedger()
    for e in LEDGER_ENTRIES:
        jl.record(e, pset)
        tl.record(e, pset)
    assert tl.snapshot() == jl.snapshot()
    # a ragged first dim and alltoall's splits are per-rank data
    a, b = tsched.ScheduleLedger(), tsched.ScheduleLedger()
    a.record(("allgather", "feat", (5, 7), "float32"))
    b.record(("allgather", "feat", (9, 7), "float32"))
    a.record(("alltoall", "t", (6, 2), "int64", (1, 2, 3)))
    b.record(("alltoall", "t", (2, 2), "int64", (0, 2, 0)))
    assert a.snapshot()["hash"] == b.snapshot()["hash"]


def _ledger(entries):
    led = tsched.ScheduleLedger()
    for e in entries:
        led.record(e)
    return led.snapshot()


def _ar(name, shape=(3,)):
    return ("allreduce", name, shape, "float32", "average", 1.0, 1.0)


DIFF_CASES = {
    "agree": {0: [_ar("a"), _ar("b")], 1: [_ar("a"), _ar("b")]},
    "name": {0: [_ar("warm"), _ar("dense_1"), _ar("dense_2")],
             1: [_ar("warm"), _ar("dense_2")]},
    "metadata": {0: [_ar("a"), _ar("b", (3,))], 1: [_ar("a"), _ar("b", (4,))]},
    "stopped": {0: [_ar("a"), _ar("b"), _ar("c")], 1: [_ar("a"), _ar("b")],
                2: [_ar("a"), _ar("b"), _ar("c")]},
    "one_rank": {0: [_ar("a")]},
}


@pytest.mark.parametrize("case", sorted(DIFF_CASES))
def test_diff_ledgers_messages_match_jax(case):
    ledgers = {r: _ledger(es) for r, es in DIFF_CASES[case].items()}
    got = tsched.diff_ledgers(ledgers)
    assert got == jsched.diff_ledgers(ledgers)
    assert (got is None) == (case in ("agree", "one_rank"))


def test_diff_ledgers_before_the_window_matches_jax():
    a = _ledger([_ar("x")] + [_ar(f"s{i}") for i in range(tsched._DEPTH)])
    b = _ledger([_ar("y")] + [_ar(f"s{i}") for i in range(tsched._DEPTH)])
    ledgers = {0: a, 1: b}
    assert tsched.diff_ledgers(ledgers) == jsched.diff_ledgers(ledgers)
    assert "before the retained ledger window" in tsched.diff_ledgers(ledgers)


def test_verb_sequence_ledgers_match_jax(monkeypatch):
    """The same verbs through both packages (HVD_TPU_SCHEDULE_CHECK on)
    leave the same ledger, digest for digest."""
    monkeypatch.setenv("HVD_TPU_SCHEDULE_CHECK", "1")
    monkeypatch.delenv("HVD_TPU_TIMELINE", raising=False)
    snaps = {}
    for name, pkg, sched, verbs in (("jax", jhvd, jsched, _verbs_jax),
                                    ("port", hvd, tsched, _verbs_port)):
        if pkg.is_initialized():
            pkg.shutdown()
        pkg.init() if name == "jax" else pkg.init(device="cpu")
        try:
            verbs()
            snaps[name] = sched.ledger().snapshot()
        finally:
            pkg.shutdown()
    assert snaps["port"]["n"] == 6
    assert snaps["port"] == snaps["jax"]
    # shutdown drops the ledger: the next generation starts at sequence 0
    assert not tsched._RESOLVED


def test_stall_error_names_divergence_and_request(monkeypatch):
    hint = ("collective schedule divergence at collective #2: rank 1 "
            "submitted allreduce('dense_2') where rank 0 submitted "
            "allreduce('dense_1')")
    monkeypatch.setattr(tstall._schedule, "divergence_hint",
                        lambda world=None: hint)
    snap0 = tmetrics.snapshot()

    class _W:
        config = tconfig.Config({"STALL_CHECK_TIME_SECONDS": 0.1,
                                 "STALL_SHUTDOWN_TIME_SECONDS": 0.2})
    ttr.note_request("req-42")
    insp = tstall.StallInspector(_W())
    try:
        insp.record_submit("dense_2")
        deadline = time.monotonic() + 10
        while not insp._shutdown_deadline_hit:
            assert time.monotonic() < deadline, "deadline never hit"
            time.sleep(0.02)
        with pytest.raises(StallError) as e:
            insp.check_shutdown()
        assert hint in str(e.value) and "(request req-42 in flight)" \
            in str(e.value)
    finally:
        insp.stop()
        ttr.reset()
    assert insp._divergence_hint == ""
    snap = tmetrics.snapshot()
    for key in ("hvd_tpu_stall_warnings_total",
                "hvd_tpu_stall_shutdowns_total",
                "hvd_tpu_schedule_divergences_total"):
        assert snap[key] == snap0[key] + 1, key


def test_response_cache_counts_hits_misses_evictions():
    from horovod_tpu_torch.response_cache import ResponseCache
    s0 = tmetrics.snapshot()
    c = ResponseCache(2)
    assert not c.lookup(1)
    c.put(1)
    assert c.lookup(1)
    c.put(2)
    assert c.put(3) == 1
    s = tmetrics.snapshot()
    assert s["hvd_tpu_response_cache_hits_total"] \
        == s0["hvd_tpu_response_cache_hits_total"] + 1
    assert s["hvd_tpu_response_cache_misses_total"] \
        == s0["hvd_tpu_response_cache_misses_total"] + 1
    assert s["hvd_tpu_response_cache_evictions_total"] \
        == s0["hvd_tpu_response_cache_evictions_total"] + 1


def test_collective_fault_sites_retry_neterror_and_surface_error(
        monkeypatch):
    """At a verb's fault site, as in the JAX package (test_chaos.py): a
    connection-shaped ``neterror`` is retried by the dispatcher's policy
    and the verb completes; an ``error`` is fatal and surfaces as
    HorovodInternalError, and the next verb is clean."""
    from horovod_tpu_torch import faults
    from horovod_tpu_torch.exceptions import HorovodInternalError
    monkeypatch.setenv("HVD_TPU_RETRY_INITIAL_BACKOFF", "0.001")
    key = 'hvd_tpu_retry_attempts_total{site="collective.dispatch"}'
    s0 = tmetrics.snapshot()
    hvd.init(device="cpu")
    try:
        faults.configure("collective.allreduce:neterror:times=2", seed=0)
        out = hvd.allreduce(torch.ones(3), op=hvd.Sum, name="retried")
        assert torch.equal(out, torch.ones(3))
        assert tmetrics.snapshot()[key] == s0.get(key, 0) + 2
        faults.configure("collective.allreduce:error:once", seed=0)
        with pytest.raises(HorovodInternalError, match="injected fault"):
            hvd.allreduce(torch.ones(3), op=hvd.Sum, name="faulted")
        out = hvd.allreduce(torch.ones(3), op=hvd.Sum, name="clean")
        assert torch.equal(out, torch.ones(3))
    finally:
        faults.configure("", seed=0)
        hvd.shutdown()


# ---------------------------------------------------------------------------
# a gloo world of 2: the cross-rank summary and a seeded divergence
# ---------------------------------------------------------------------------

def test_world_summary_scrape_and_seeded_divergence(tmp_path):
    from horovod_tpu_torch.runner.rendezvous import KVStoreServer
    kv = KVStoreServer(port=0)
    kv_port = kv.start()
    port, metrics_port = _free_port(), _free_port()
    procs = []
    try:
        for rank in range(2):
            env = dict(os.environ, HVD_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                       HVD_TPU_SIZE="2", HVD_TPU_RANK=str(rank),
                       HVD_TPU_RENDEZVOUS_ADDR="127.0.0.1",
                       HVD_TPU_RENDEZVOUS_PORT=str(kv_port),
                       HVD_TPU_SCHEDULE_CHECK="1",
                       HVD_TPU_STALL_CHECK_TIME_SECONDS="1",
                       HVD_TPU_STALL_SHUTDOWN_TIME_SECONDS="3",
                       HVD_TPU_FAULT_SPEC="drill.schedule.skip:error:rank=1",
                       HVD_TPU_METRICS_PORT=str(metrics_port),
                       HVD_TPU_METRICS_ADDR="127.0.0.1",
                       OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(tmp_path)], env=env, cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=120)[0] for p in procs]
        assert [p.returncode for p in procs] == [0, 0], outs
    finally:
        for p in procs:
            p.kill()
        kv.stop()
    res = []
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            res.append(json.load(f))

    # the summary: one snapshot per rank, the skew visible everywhere
    for r in res:
        summary = r["summary"]
        assert len(summary["per_rank"]) == 2
        for rank, snap in enumerate(summary["per_rank"]):
            assert snap["test_rank_skew_total"] == rank
            assert snap['hvd_tpu_collective_ops_total{op="allreduce"}'] >= 3
        skew = summary["aggregate"]["test_rank_skew_total"]
        assert skew == {"sum": 1.0, "min": 0.0, "max": 1.0}
        assert summary["aggregate"] == jmetrics.aggregate(
            summary["per_rank"])
        snap = r["snapshot"]
        assert snap['hvd_tpu_collective_bytes_total{op="allreduce"}'] >= 48
        assert snap['hvd_tpu_consistency_checks_total{result="cached"}'] \
            >= 2
        assert snap["hvd_tpu_response_cache_hits_total"] >= 2
    scrape = res[0]["scrape"]
    assert 'hvd_tpu_collective_ops_total{op="allreduce"}' in scrape
    assert "# TYPE hvd_tpu_collective_dispatch_seconds histogram" in scrape
    assert "scrape" not in res[1]

    # the divergence: rank 1 skipped dense_1, rank 0 stalled in dense_2
    assert [r["skipped"] for r in res] == [False, True]
    assert "stall" in res[0] and "stall" not in res[1]
    ledgers = {r["rank"]: r["ledger"] for r in res}
    diag = tsched.diff_ledgers(ledgers)
    assert diag == jsched.diff_ledgers(ledgers)
    assert "rank 1 submitted allreduce('dense_2') where rank 0 submitted " \
           "allreduce('dense_1')" in diag
    assert diag in res[0]["stall"]


def test_telemetry_and_serving_import_with_jax_blocked():
    """The modules of this slice import with jax and the JAX package
    blocked, and load none of them."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'horovod_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import horovod_tpu_torch as hvd\n"
        "from horovod_tpu_torch import (timeline, tracing, _schedule,\n"
        "                               logging_setup, metrics)\n"
        "import horovod_tpu_torch.serving as s\n"
        "assert s.InferenceServer and s.InferenceEngine and s.MicroBatcher\n"
        "assert hvd.metrics_snapshot is metrics.snapshot\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'optax', 'horovod_tpu') and sys.modules[m]]\n"
        "print('clean' if not bad else bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"
