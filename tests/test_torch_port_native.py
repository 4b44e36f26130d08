"""The port's native host runtime (``horovod_tpu_torch._native``) against
the JAX package's (``horovod_tpu._native``), on the CPU with ``g++``.

Every component goes through the port's bindings and the JAX package's,
on the same inputs drawn from a numpy seed, and must agree exactly: CRC32
(and zlib), the wire packer and parser, the submission table, the
response-cache LRU, the bucket planner, the stall tracker, the timeline
writer (files equal but for ``ts``), the metric cells and the GP/BO (its
suggestions bit for bit). Then the port's consumers (TensorTable,
ResponseCache, StallInspector, the metrics registry, Timeline,
ParameterManager) on the native path and on the pure-Python one (the
path of ``HVD_TPU_NATIVE=0``), each held to the JAX package's. A gloo
world of 2 runs one rank native and the other not, and the ranks agree on
every fingerprint and bucket. Several processes building the library at
once all load one whole library. The tests that need the library skip,
with a reason, where no C++ compiler exists, as ``tests/test_native.py``
does.

This file is also its own worker: ``python tests/test_torch_port_native.py
world <out_dir>`` with the ``HVD_TPU_COORDINATOR_ADDR/SIZE/RANK`` env.
"""

import json
import os
import socket
import subprocess
import sys

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))

#: (name, shape, dtype, kind, extra) of the fingerprinted submissions
METAS = [("grad/layer1.weight", (128, 1024), "float32", "allreduce",
          "average"),
         ("t/x.y", (3, 5, 7), "bfloat16", "allgather", "e"),
         ("s", (), "bool", "broadcast", ""),
         ("ünïcode.名前", (0, 4), "int64", "alltoall", "splits=0"),
         ("big", tuple(range(1, 9)), "float16", "grouped_allreduce",
          "x" * 300)]
THRESHOLDS = [-1, 0, 1, 100, 4096, 1 << 20, 1 << 26]


def _world_main(out_dir: str) -> int:
    """One rank of a gloo world of 2: fingerprints, bucket plans and a
    consistency-checked grouped allreduce and optimizer step."""
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _native, fusion, tensor_table
    hvd.init(device="cpu", config_overrides={"CHECK_CONSISTENCY": True,
                                             "FUSION_THRESHOLD": 4096})
    rank = hvd.rank()
    w = hvd.basics.world()
    rng = np.random.RandomState(0)
    shapes = [((int(rng.randint(1, 300)),), torch.float32)
              for _ in range(40)]
    info = {"rank": rank, "native": _native.available(),
            "table_native": w.tensor_table._nat_table is not None,
            "fps": [tensor_table.metadata_fingerprint(*m) for m in METAS],
            "plans": [fusion.plan_buckets(shapes, t) for t in THRESHOLDS]}
    tensors = [torch.full(s, float(rank + 1)) for s, _ in shapes]
    for _ in range(2):    # the second call hits the response cache
        outs = hvd.grouped_allreduce(tensors, op=hvd.Sum,
                                     name="native.world")
    info["sums_ok"] = all(torch.equal(o, torch.full_like(o, 3.0))
                          for o in outs)
    torch.manual_seed(0)
    model = torch.nn.Sequential(*[torch.nn.Linear(16, 16)
                                  for _ in range(6)])
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    for _ in range(2):
        opt.zero_grad()
        model(torch.ones(2, 16) * (rank + 1)).sum().backward()
        opt.step()
    info["opt_plans"] = opt.plans
    info["cache_len"] = len(w.response_cache)
    with open("/proc/self/maps") as f:
        info["libs"] = sorted({line.split()[-1] for line in f
                               if "_libhvdtpu" in line})
    gathered = hvd.allgather_object(info)
    with open(os.path.join(out_dir, f"world.{rank}.json"), "w") as f:
        json.dump(gathered, f)
    hvd.shutdown()
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["world"]:
    sys.exit(_world_main(sys.argv[2]))

# -- the tests (both packages) ----------------------------------------------

import ctypes  # noqa: E402
import struct  # noqa: E402
import threading  # noqa: E402
import types  # noqa: E402
import zlib  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from horovod_tpu import _native as jnative  # noqa: E402
from horovod_tpu import config as jconfig  # noqa: E402
from horovod_tpu import fusion as jfusion  # noqa: E402
from horovod_tpu import metrics as jmetrics  # noqa: E402
from horovod_tpu import parameter_manager as jpm  # noqa: E402
from horovod_tpu import response_cache as jrc  # noqa: E402
from horovod_tpu import stall as jstall  # noqa: E402
from horovod_tpu import tensor_table as jtt  # noqa: E402
from horovod_tpu import timeline as jtl  # noqa: E402
import horovod_tpu_torch as hvd  # noqa: E402
from horovod_tpu_torch import _native as tnative  # noqa: E402
from horovod_tpu_torch import config as tconfig  # noqa: E402
from horovod_tpu_torch import fusion as tfusion  # noqa: E402
from horovod_tpu_torch import metrics as tmetrics  # noqa: E402
from horovod_tpu_torch import parameter_manager as tpm  # noqa: E402
from horovod_tpu_torch import response_cache as trc  # noqa: E402
from horovod_tpu_torch import stall as tstall  # noqa: E402
from horovod_tpu_torch import tensor_table as ttt  # noqa: E402
from horovod_tpu_torch import timeline as ttl  # noqa: E402
from horovod_tpu_torch.exceptions import DuplicateNameError  # noqa: E402

tnat = tnative.get()
jnat = jnative.get()
needs_native = pytest.mark.skipif(
    tnat is None or jnat is None,
    reason="no C++ compiler: neither native runtime builds")
BOTH = pytest.mark.parametrize("path", ["native", "python"])


def _on_path(monkeypatch, path, *modules):
    """Put ``modules`` (consumers of either package) on ``path``: native
    (the default, skipped without a compiler) or the pure-Python path of
    ``HVD_TPU_NATIVE=0`` (their ``_native_get`` answers None)."""
    if path == "python":
        for m in modules:
            monkeypatch.setattr(m, "_native_get", lambda: None)
    elif tnat is None or jnat is None:
        pytest.skip("no C++ compiler: neither native runtime builds")


# ---------------------------------------------------------------------------
# the library
# ---------------------------------------------------------------------------

@needs_native
def test_library_is_the_ports_own_build():
    assert tnat.cdll.hvd_abi_version() == tnative.ABI_VERSION == 2
    assert jnat.cdll.hvd_abi_version() == 1
    assert os.path.dirname(tnative.path) == os.path.join(
        REPO, "build", "torch_native")
    assert tnat.cdll is not jnat.cdll
    # same symbol names, two libraries: RTLD_LOCAL keeps them apart
    assert ctypes.cast(tnat.cdll.hvd_crc32, ctypes.c_void_p).value != \
        ctypes.cast(jnat.cdll.hvd_crc32, ctypes.c_void_p).value
    from horovod_tpu_torch._native import build
    assert build.content_hash() == os.path.basename(
        tnative.path)[len("_libhvdtpu_torch-"):-len(".so")]


def test_native_zero_selects_the_python_paths():
    """``HVD_TPU_NATIVE=0`` in a fresh process: no library is loaded and
    the fingerprint is zlib's, equal to the native one of this process."""
    code = (
        "import sys, zlib\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from horovod_tpu_torch import _native, tensor_table\n"
        "assert _native.get() is None and not _native.available()\n"
        f"print(tensor_table.metadata_fingerprint(*{METAS[0]!r}))\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert '_libhvdtpu' not in maps\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, HVD_TPU_NATIVE="0"))
    assert r.returncode == 0, r.stderr
    assert int(r.stdout) == jtt.metadata_fingerprint(*METAS[0]) \
        == ttt.metadata_fingerprint(*METAS[0])


def test_concurrent_builds_load_one_whole_library(tmp_path):
    """Four processes call get() at once on an empty build directory:
    each loads a library that works, and the directory ends with one
    library and no temporary file."""
    code = (
        "import sys, zlib\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from horovod_tpu_torch._native import build\n"
        "build.BUILD_DIR = sys.argv[1]\n"
        "from horovod_tpu_torch import _native\n"
        "b = _native.get()\n"
        "assert b is not None\n"
        "assert b.cdll.hvd_crc32(b'horovod', 7) == zlib.crc32(b'horovod')\n"
        "print(_native.path, b.cdll.hvd_abi_version())\n")
    if tnat is None:
        pytest.skip("no C++ compiler: nothing to build")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    lines = {o.strip() for o, _ in outs}
    assert len(lines) == 1
    lib, abi = lines.pop().split()
    assert abi == "2" and os.path.dirname(lib) == str(tmp_path)
    assert os.listdir(tmp_path) == [os.path.basename(lib)]


# ---------------------------------------------------------------------------
# wire and CRC32
# ---------------------------------------------------------------------------

@needs_native
def test_crc32_matches_zlib_and_the_jax_library():
    rng = np.random.RandomState(0)
    blobs = [b"", b"x"] + [rng.bytes(int(n)) for n in
                           rng.randint(1, 5000, size=40)]
    for data in blobs:
        want = zlib.crc32(data)
        assert tnat.cdll.hvd_crc32(data, len(data)) == want
        assert jnat.cdll.hvd_crc32(data, len(data)) == want


def _native_pack(nat, name, shape, dtype, kind, extra, rank):
    buf = ctypes.create_string_buffer(4096)
    dims = (ctypes.c_int64 * max(1, len(shape)))(*shape)
    n = nat.cdll.hvd_wire_pack_request(
        name.encode(), dims, len(shape), dtype.encode(), kind.encode(),
        extra.encode(), rank, buf, len(buf))
    assert n > 0
    return buf.raw[:n]


@needs_native
@pytest.mark.parametrize("i", range(len(METAS)))
def test_pack_and_unpack_agree_across_packages_and_paths(i, monkeypatch):
    name, shape, dtype, kind, extra = METAS[i]
    rank = 3 + i
    want = jtt.pack_request(name, shape, dtype, kind, extra, rank)
    assert _native_pack(jnat, name, shape, dtype, kind, extra, rank) == want
    assert _native_pack(tnat, name, shape, dtype, kind, extra, rank) == want
    assert ttt.pack_request(name, shape, dtype, kind, extra, rank) == want
    fields = {"name": name, "shape": shape, "dtype": dtype, "kind": kind,
              "extra": extra, "rank": rank}
    assert ttt.unpack_request(want) == jtt.unpack_request(want) == fields
    fp = jtt.metadata_fingerprint(name, shape, dtype, kind, extra)
    assert ttt.metadata_fingerprint(name, shape, dtype, kind, extra) == fp
    monkeypatch.setattr(ttt, "_native_get", lambda: None)
    monkeypatch.setattr(jtt, "_native_get", lambda: None)
    assert ttt.pack_request(name, shape, dtype, kind, extra, rank) == want
    assert ttt.unpack_request(want) == jtt.unpack_request(want) == fields
    assert ttt.metadata_fingerprint(name, shape, dtype, kind, extra) == fp
    assert jtt.metadata_fingerprint(name, shape, dtype, kind, extra) == fp


@BOTH
def test_torch_dtypes_pack_as_the_jax_package_writes_numpy(path,
                                                            monkeypatch):
    _on_path(monkeypatch, path, ttt)
    for td, nd in ((torch.float32, np.float32), (torch.int8, np.int8),
                   (torch.bool, np.bool_), (torch.float64, np.float64)):
        assert ttt.pack_request("n", (2, 3), td, "allreduce") == \
            jtt.pack_request("n", (2, 3), np.dtype(nd), "allreduce")
    assert ttt.pack_request("n", (2,), torch.bfloat16, "allreduce") == \
        jtt.pack_request("n", (2,), "bfloat16", "allreduce")


@BOTH
def test_nul_in_a_field_packs_whole(path, monkeypatch):
    """A NUL inside a field is packed whole on both paths (the packer is
    Python on both, as in the JAX package), so its bytes and fingerprint
    stay the JAX package's."""
    _on_path(monkeypatch, path, ttt)
    args = ("a\0b", (2,), "float32", "allreduce", "x\0")
    assert ttt.pack_request(*args, rank=1) == jtt.pack_request(*args,
                                                               rank=1)
    assert ttt.metadata_fingerprint(*args) == jtt.metadata_fingerprint(*args)


@BOTH
def test_malformed_and_oversized_messages_raise(path, monkeypatch):
    _on_path(monkeypatch, path, ttt)
    good = ttt.pack_request("a", (2,), "float32", "allreduce")
    for bad in (b"", b"\x07garbage", good[:-1], good[:7]):
        with pytest.raises(ValueError):
            ttt.unpack_request(bad)
    with pytest.raises(ValueError):
        ttt.pack_request("a" * 70000, (1,), "float32", "allreduce")
    with pytest.raises(ValueError):
        ttt.pack_request("a", (1,) * 256, "float32", "allreduce")


# ---------------------------------------------------------------------------
# submission table
# ---------------------------------------------------------------------------

def _table_script(nat):
    """A seeded sequence of begin/finish/known/pending on a native table;
    returns every answer."""
    rng = np.random.RandomState(1)
    t = nat.cdll.hvd_table_create()
    out, live = [], []
    try:
        for _ in range(300):
            op = rng.randint(4)
            if op <= 1:
                name = f"t{rng.randint(12)}".encode()
                h = nat.cdll.hvd_table_begin(t, name)
                out.append(("begin", name, h))
                if h >= 0:
                    live.append(h)
            elif op == 2:
                h = int(live.pop(rng.randint(len(live)))) if live and \
                    rng.rand() < 0.8 else int(rng.randint(-2, 400))
                out.append(("finish", h, nat.cdll.hvd_table_finish(t, h)))
            else:
                h = int(rng.randint(-1, 300))
                out.append(("known", h, nat.cdll.hvd_table_known(t, h),
                            nat.cdll.hvd_table_pending(t)))
    finally:
        nat.cdll.hvd_table_destroy(t)
    return out


@needs_native
def test_table_duplicate_and_lifecycle_agree():
    got = _table_script(tnat)
    assert got == _table_script(jnat)
    assert any(h == -1 for op, _, h in
               [e[:3] for e in got if e[0] == "begin"])   # duplicates met


@BOTH
def test_tensor_table_matches_jax(path, monkeypatch):
    _on_path(monkeypatch, path, ttt, jtt)
    world = types.SimpleNamespace(stall_inspector=None)
    tables = {"jax": jtt.TensorTable(world), "port": ttt.TensorTable(world)}
    assert (tables["port"]._nat_table is not None) == (path == "native")
    rng = np.random.RandomState(2)
    trace = {k: [] for k in tables}
    handles = {k: [] for k in tables}
    for _ in range(200):
        name = f"g{rng.randint(8)}"
        finish = rng.rand() < 0.5
        for k, t in tables.items():
            if finish and handles[k]:
                h = handles[k].pop(0)
                t.finish(h)
                trace[k].append(("finish", h.id, t.pending_count()))
                continue
            try:
                h = t.begin(name, "allreduce")
                handles[k].append(h)
                assert t.get(h.id) is h
                trace[k].append(("begin", h.id, h.name, t.pending_count()))
            except Exception as e:   # each package's DuplicateNameError
                trace[k].append(("dup", type(e).__name__, str(e)))
    assert trace["port"] == trace["jax"]
    assert ("dup", "DuplicateNameError") in {e[:2] for e in trace["port"]}
    with pytest.raises(DuplicateNameError):
        name = handles["port"][0].name
        tables["port"].begin(name, "allreduce")
    with pytest.raises(ValueError):
        tables["port"].get(10 ** 6)


# ---------------------------------------------------------------------------
# response cache
# ---------------------------------------------------------------------------

def _cache_ops(seed, n=400):
    rng = np.random.RandomState(seed)
    return [(["lookup", "put", "put", "len"][rng.randint(4)],
             int(rng.randint(0, 24)) | (int(rng.randint(0, 4)) << 62))
            for _ in range(n)]


def _run_cache(cache, ops):
    out = []
    for op, key in ops:
        if op == "len":
            out.append(len(cache))
        else:
            out.append(getattr(cache, op)(key))
    return out


@pytest.mark.parametrize("capacity", [0, 1, 3, 16])
@BOTH
def test_response_cache_matches_jax(path, capacity, monkeypatch):
    """Hits, misses, victims and sizes of one seeded op sequence: the
    port's LRU equals the JAX package's on the same path, and the native
    and Python paths equal each other (the counters agree too)."""
    _on_path(monkeypatch, path, trc, jrc)
    ops = _cache_ops(capacity)
    port = trc.ResponseCache(capacity)
    assert (port._h is not None) == (path == "native")
    before = {k: tmetrics.snapshot()[k] for k in (
        "hvd_tpu_response_cache_hits_total",
        "hvd_tpu_response_cache_misses_total",
        "hvd_tpu_response_cache_evictions_total")}
    got = _run_cache(port, ops)
    after = tmetrics.snapshot()
    jbefore = {k: jmetrics.snapshot()[k] for k in before}
    assert got == _run_cache(jrc.ResponseCache(capacity), ops)
    for k in before:
        assert after[k] - before[k] == jmetrics.snapshot()[k] - jbefore[k]
    if path == "native":
        py = trc.ResponseCache(capacity)
        py._h = None
        assert _run_cache(py, ops) == got
    if capacity == 3:     # the sequence evicts
        assert any(v is not None for (op, _), v in zip(ops, got)
                   if op == "put")


# ---------------------------------------------------------------------------
# fusion planner
# ---------------------------------------------------------------------------

def _metas(seed):
    rng = np.random.RandomState(seed)
    metas = [((int(rng.randint(1, 200)),), np.float32) for _ in range(50)]
    metas += [((int(rng.randint(1, 50)), 33), np.float64)
              for _ in range(20)]
    metas += [((int(rng.randint(0, 9)), 7, 3), np.float16)
              for _ in range(10)]
    return [metas[i] for i in rng.permutation(len(metas))]


@pytest.mark.parametrize("threshold", THRESHOLDS + [3000, 1 << 40])
def test_plan_buckets_agree_everywhere(threshold, monkeypatch):
    metas = _metas(threshold & 0xFFFF)
    torch_metas = [(s, getattr(torch, np.dtype(d).name)) for s, d in metas]
    plans = {"jax": jfusion.plan_buckets(metas, threshold),
             "port": tfusion.plan_buckets(metas, threshold),
             "port_torch": tfusion.plan_buckets(torch_metas, threshold)}
    monkeypatch.setattr(tfusion, "_native_get", lambda: None)
    monkeypatch.setattr(jfusion, "_native_get", lambda: None)
    plans["jax_python"] = jfusion.plan_buckets(metas, threshold)
    plans["port_python"] = tfusion.plan_buckets(torch_metas, threshold)
    assert all(p == plans["jax"] for p in plans.values()), plans
    assert tfusion.plan_buckets([], threshold) == []


@needs_native
@pytest.mark.parametrize("threshold", [-5, 0, 1, 64, 1 << 12])
def test_native_planner_entry_points_agree(threshold):
    rng = np.random.RandomState(5)
    sizes = [int(s) for s in rng.randint(0, 300, size=64)]
    outs = []
    for nat in (tnat, jnat):
        out = (ctypes.c_int32 * len(sizes))()
        nb = nat.cdll.hvd_plan_buckets((ctypes.c_int64 * len(sizes))(*sizes),
                                       len(sizes), threshold, out)
        outs.append((nb, list(out)))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# stall inspector
# ---------------------------------------------------------------------------

def _stall_script(nat):
    h = nat.cdll.hvd_stall_create()
    buf = ctypes.create_string_buffer(4096)
    hit = ctypes.c_int32(0)
    out = []

    def check(warn, shut):
        hit.value = 0
        n = nat.cdll.hvd_stall_check(h, warn, shut, ctypes.byref(hit), buf,
                                     len(buf))
        out.append((n, sorted(buf.value.split(b"\n")) if n else [],
                    hit.value, nat.cdll.hvd_stall_pending(h)))
    try:
        for name in (b"slow.a", b"slow.b", b"slow.a"):
            nat.cdll.hvd_stall_submit(h, name)
        check(1e9, -1.0)        # nothing past the warn deadline
        check(-1.0, -1.0)       # both reported once
        check(-1.0, -1.0)       # not again
        check(1e9, 1e-9)        # the shutdown deadline
        nat.cdll.hvd_stall_done(h, b"slow.a")
        nat.cdll.hvd_stall_submit(h, b"slow.c")
        check(-1.0, 0.0)
        nat.cdll.hvd_stall_done(h, b"slow.b")
        nat.cdll.hvd_stall_done(h, b"slow.c")
        check(-1.0, -1.0)
    finally:
        nat.cdll.hvd_stall_destroy(h)
    return out


@needs_native
def test_stall_check_reports_once_in_both_libraries():
    got = _stall_script(tnat)
    assert got == _stall_script(jnat)
    assert got[1][:2] == (2, [b"slow.a", b"slow.b"]) and got[2][0] == 0
    assert got[3][2] == 1 and got[-1][3] == 0


@BOTH
def test_stall_inspector_matches_jax(path, monkeypatch):
    _on_path(monkeypatch, path, tstall, jstall)
    insps = {
        "jax": jstall.StallInspector(types.SimpleNamespace(
            config=jconfig.Config({"STALL_CHECK_DISABLE": True}))),
        "port": tstall.StallInspector(types.SimpleNamespace(
            config=tconfig.Config({"STALL_CHECK_DISABLE": True})))}
    assert (insps["port"]._h is not None) == (path == "native")
    trace = {k: [] for k in insps}
    for k, insp in insps.items():
        insp.record_submit("x")
        insp.record_submit("y")
        trace[k].append(sorted(insp._scan(-1.0, -1.0)))
        trace[k].append(insp._scan(-1.0, -1.0))
        insp.record_done("x")
        insp.record_submit("z")
        trace[k].append(insp._scan(1e9, 1e-9))
        trace[k].append(insp._shutdown_deadline_hit)
        insp.stop()
        trace[k].append((insp._shutdown_deadline_hit, insp._scan(-1., -1.)))
        insp.record_submit("after.stop")      # a no-op once stopped
    assert trace["port"] == trace["jax"] == [
        ["x", "y"], [], [], True, (False, [])]


# ---------------------------------------------------------------------------
# timeline
# ---------------------------------------------------------------------------

def _drive_timeline(tl):
    tl.negotiate_start("g1", "allreduce")
    tl.negotiate_rank_ready("g1", 0)
    tl.negotiate_end("g1")
    tl.start("g1", "allreduce", nbytes=4096)
    tl.activity_start("g1", "XLA_ALLREDUCE")
    tl.activity_end("g1")
    tl.start("g2 \"quoted\"\n", "allgather")
    tl.activity_start("g2 \"quoted\"\n", "QUEUE")
    tl.mark_cycle()
    tl.activity_end("g2 \"quoted\"\n")
    tl.end("g1")
    tl.close()


def _without_ts(path):
    with open(path) as f:
        events = [e for e in json.load(f) if e]
    ts = [e.pop("ts") for e in events if "ts" in e]
    return events, ts


@BOTH
def test_timeline_files_equal_but_for_ts(path, tmp_path, monkeypatch):
    _on_path(monkeypatch, path, ttl, jtl)
    files = {}
    for name, mod in (("jax", jtl), ("port", ttl)):
        files[name] = str(tmp_path / f"{name}.json")
        tl = mod.Timeline(files[name], mark_cycles=True)
        assert (tl._h is not None) == (path == "native")
        _drive_timeline(tl)
    port, port_ts = _without_ts(files["port"])
    jax, _ = _without_ts(files["jax"])
    assert port == jax
    assert len(port) == 13 and port_ts == sorted(port_ts)
    assert {"thread_name", "NEGOTIATE_ALLREDUCE", "RANK_READY", "CYCLE",
            "XLA_ALLREDUCE", "QUEUE"} <= {e["name"] for e in port}


@needs_native
def test_native_timeline_clock_is_the_writers(tmp_path):
    """The Timeline reads the native writer's own clock: an event emitted
    between two reads of it is stamped between them."""
    path = str(tmp_path / "tl.json")
    tl = ttl.Timeline(path)
    assert tl._h is not None
    a = tl._now_us()
    tl.start("t", "allreduce")
    b = tl._now_us()
    tl.close()
    (ev,) = [e for e in ttl._read_events(path) if e.get("ph") == "B"]
    assert ev["name"] == "ALLREDUCE"
    # the file stamps with "%.3f"
    assert round(a, 3) <= ev["ts"] <= round(b, 3)
    assert tl._now_us() >= 0.0     # closed: still answers


def _splice_and_check(tmp_path, native):
    path = str(tmp_path / "tl.json")
    tl = ttl.Timeline(path)
    assert (tl._h is not None) == native
    tl.start("t0", "allreduce")
    tl.start_torch_trace(str(tmp_path / "dev"))
    x = torch.randn(64, 64)
    (x @ x).sum().item()
    tl.stop_torch_trace()
    tl.activity_start("t0", "GLOO_ALLREDUCE")
    tl.activity_end("t0")
    tl.close()
    events = [e for e in ttl._read_events(path)]
    host = [e for e in events if e.get("pid", 0) < ttl.DEVICE_PID_OFFSET]
    dev = [e for e in events if e.get("pid", 0) >= ttl.DEVICE_PID_OFFSET]
    marker = [e for e in dev if e["name"] == ttl.SYNC_MARKER]
    assert len(marker) == 1
    b0 = [e["ts"] for e in host if e["ph"] == "B"]
    assert b0[0] <= marker[0]["ts"] <= b0[1]
    assert max(e["ts"] for e in dev if "ts" in e) <= b0[1]


@BOTH
def test_splice_lands_on_the_host_clock_on_both_writers(path, tmp_path,
                                                        monkeypatch):
    """The splice's checks with the process idle (this also pays the
    profiler's first start-up outside the loaded runs below)."""
    _on_path(monkeypatch, path, ttl)
    _splice_and_check(tmp_path, native=path == "native")


@pytest.mark.parametrize("run", range(3))
@BOTH
def test_splice_holds_under_cpu_load_on_both_writers(path, run, tmp_path,
                                                     monkeypatch):
    """The splice beside two CPU-bound threads, on the native writer
    (whose clock the markers are read on) and on RecordWriter."""
    _on_path(monkeypatch, path, ttl)
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            pass
    threads = [threading.Thread(target=spin, daemon=True) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        _splice_and_check(tmp_path, native=path == "native")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)


@needs_native
def test_timeline_emit_races_close(tmp_path):
    """Emitters racing close() never reach the freed writer: every thread
    ends, and the file is whole."""
    path = str(tmp_path / "race.json")
    tl = ttl.Timeline(path)
    go = threading.Event()

    def emit(i):
        go.wait()
        for _ in range(300):
            tl.start(f"t{i}", "allreduce")
            tl.activity_end(f"t{i}")
    threads = [threading.Thread(target=emit, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    go.set()
    tl.close()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert isinstance(json.load(open(path)), list)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _drive_registry(mod, seed):
    reg = mod.Registry()
    rng = np.random.RandomState(seed)
    c = reg.counter("t_ops_total", "ops", ("verb",))
    g = reg.gauge("t_depth", "depth")
    h = reg.histogram("t_lat_seconds", "latency")
    h2 = reg.histogram("t_bytes", "bytes", buckets=(1, 10, 100))
    for _ in range(500):
        op = rng.randint(5)
        v = float(rng.exponential(0.01))
        if op == 0:
            c.labels(verb=["a", "b", "c"][rng.randint(3)]).inc(
                float(rng.randint(1, 4)))
        elif op == 1:
            g.set(v)
        elif op == 2:
            g.inc(v) if rng.rand() < 0.5 else g.dec(v)
        elif op == 3:
            h.observe(v)
        else:
            h2.observe(float(rng.randint(0, 200)))
    cells = [c.labels(verb="a")._cell, g._children[()]._cell]
    return reg, cells, h._children[()]


@pytest.mark.parametrize("seed", range(3))
@BOTH
def test_metric_cells_and_exposition_match_jax(path, seed, monkeypatch):
    _on_path(monkeypatch, path, tmetrics, jmetrics)
    treg, tcells, thist = _drive_registry(tmetrics, seed)
    jreg, jcells, jhist = _drive_registry(jmetrics, seed)
    assert all((c._h is not None) == (path == "native") for c in tcells)
    assert (thist._h is not None) == (path == "native")
    assert [c.get() for c in tcells] == [c.get() for c in jcells]
    assert thist.read() == jhist.read() and thist.read()[2] > 0
    assert treg.snapshot() == jreg.snapshot()
    assert treg.render_prometheus() == jreg.render_prometheus()


@needs_native
def test_native_and_python_cells_read_the_same():
    regs = {}
    for path in ("native", "python"):
        mp = pytest.MonkeyPatch()
        try:
            if path == "python":
                mp.setattr(tmetrics, "_native_get", lambda: None)
            regs[path] = _drive_registry(tmetrics, 7)[0]
        finally:
            mp.undo()
    assert regs["native"].snapshot() == regs["python"].snapshot()
    assert regs["native"].render_prometheus() == \
        regs["python"].render_prometheus()


def test_import_builds_nothing():
    """Importing the port (its metric families register at import) builds
    and loads no native library: cells resolve at first use."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import horovod_tpu_torch, horovod_tpu_torch.metrics\n"
        "import horovod_tpu_torch.response_cache, horovod_tpu_torch.stall\n"
        "from horovod_tpu_torch import _native\n"
        "assert not _native._tried\n"
        "assert '_libhvdtpu' not in open('/proc/self/maps').read()\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr


# ---------------------------------------------------------------------------
# GP/BO autotuner
# ---------------------------------------------------------------------------

def _bo_sequence(nat, dim, seed, n, n_cand):
    rng = np.random.RandomState(seed)
    lo = (ctypes.c_double * dim)(*([0.0] * dim))
    hi = (ctypes.c_double * dim)(*[float(h) for h in range(10, 10 + dim)])
    b = nat.cdll.hvd_bo_create(dim, lo, hi, seed)
    x = (ctypes.c_double * dim)()
    out = []
    try:
        for i in range(n):
            nat.cdll.hvd_bo_suggest(b, n_cand, x)
            out.append(tuple(struct.pack("<d", x[k]) for k in range(dim)))
            y = float(-sum((x[k] - 3.3) ** 2 for k in range(dim))
                      + rng.normal(0, 0.1))
            nat.cdll.hvd_bo_observe(b, x, y)
            if i == 5:     # a duplicate point: the degenerate branch
                nat.cdll.hvd_bo_observe(b, x, y)
        out.append(nat.cdll.hvd_bo_num_obs(b))
    finally:
        nat.cdll.hvd_bo_destroy(b)
    return out


@needs_native
@pytest.mark.parametrize("dim,seed,n_cand", [(1, 1234, 512), (1, 0, 0),
                                             (2, 7, 128), (3, 42, 64)])
def test_bo_suggestions_are_bit_identical(dim, seed, n_cand):
    got = _bo_sequence(tnat, dim, seed, 14, n_cand)
    assert got == _bo_sequence(jnat, dim, seed, 14, n_cand)
    assert len(set(got[:-1])) > 3


@needs_native
def test_native_optimizer_matches_jax():
    rng = np.random.RandomState(0)
    for lo, hi in tpm._KNOBS[0][1:], tpm._KNOBS[1][1:]:
        a = jpm._NativeOptimizer(jnat, lo, hi)
        b = tpm._NativeOptimizer(tnat, lo, hi)
        for _ in range(10):
            s = b.suggest()
            assert struct.pack("<d", s) == struct.pack("<d", a.suggest())
            assert lo <= s <= hi
            y = float(rng.rand())
            a.observe(s, y)
            b.observe(s, y)


@needs_native
def test_autotune_proposals_are_the_jax_gp_bo_proposals():
    """With the library loaded, the tuner is the GP/BO, and with the step
    times fixed its proposals, which re-plan the buckets, are those the
    JAX package's GP/BO makes for the same scores."""
    hvd.init(device="cpu", config_overrides=dict(
        AUTOTUNE=True, AUTOTUNE_WARMUP_SAMPLES=0,
        AUTOTUNE_STEPS_PER_SAMPLE=1))
    try:
        pm = hvd.basics.world().parameter_manager
        assert isinstance(pm._opt, tpm._NativeOptimizer)
        seen = []
        record = pm.record
        pm.record = lambda nbytes, seconds: (seen.append(nbytes),
                                             record(nbytes, 0.01))
        model = torch.nn.Linear(4, 2)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=0.1))
        got = []
        for _ in range(6):
            model(torch.ones(1, 4)).sum().backward()
            opt.step()
            got.append(pm.fusion_threshold)
        ref = jpm._NativeOptimizer(jnat, *jpm._KNOBS[0][1:])
        value, want = 64 << 20, []
        for nbytes in seen:
            ref.observe(float(np.log2(value)), nbytes / 0.01)
            value = 1 << int(round(ref.suggest()))
            want.append(value)
        assert got == want and len(set(want)) > 1
        planned = [t for t, _ in opt.plans]
        assert planned[0] == 64 << 20 and set(planned) <= {64 << 20, *want}
        assert len(planned) > 1
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# concurrency and lifetimes
# ---------------------------------------------------------------------------

@needs_native
def test_native_cells_and_table_lose_no_update_under_threads():
    """16 threads on a short switch interval: every counter increment and
    histogram observation lands in the native cells, and the native
    table hands out no handle twice."""
    reg = tmetrics.Registry()
    counter = reg.counter("stress_total")
    hist = reg.histogram("stress_seconds", buckets=(0.5, 1.0))
    table = ttt.TensorTable(types.SimpleNamespace(stall_inspector=None))
    assert table._nat_table is not None
    ids, lock = [], threading.Lock()

    def work(i):
        mine = []
        for k in range(500):
            counter.inc()
            hist.observe(0.25 if k % 2 else 0.75)
            h = table.begin(f"w{i}.{k}", "allreduce")
            mine.append(h.id)
            table.finish(h)
        with lock:
            ids.extend(mine)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counter._children[()].get() == 16 * 500
    assert hist._children[()].read() == ((4000, 4000, 0), 16 * 500 * 0.5,
                                         8000)
    assert len(set(ids)) == len(ids) == 8000
    assert table.pending_count() == 0


@needs_native
def test_reset_cycles_free_every_native_object_once():
    """init()/shutdown() cycles, as an elastic reset makes them: a
    submitter that still holds the previous world's table and inspector
    keeps using them safely after the reset, and once the last reference
    drops each one is finalized (its __del__ frees its native object;
    a second free would crash the process)."""
    import gc
    import weakref
    freed = []
    for cycle in range(3):
        hvd.init(device="cpu")
        hvd.allreduce(torch.ones(4), name=f"reset.{cycle}")
        w = hvd.basics.world()
        table, insp, cache = w.tensor_table, w.stall_inspector, \
            w.response_cache
        assert None not in (table._nat_table, insp._h, cache._h)
        hvd.shutdown()
        h = table.begin("late", "allreduce")   # after the reset: safe
        table.finish(h)
        insp.record_submit("late")            # stopped: a no-op
        assert insp._scan(-1.0, -1.0) == []
        for obj in (table, insp, cache):
            weakref.finalize(obj, freed.append, type(obj).__name__)
        del table, insp, cache, w, h, obj
    gc.collect()
    assert sorted(freed) == sorted(
        ["TensorTable", "StallInspector", "ResponseCache"] * 3)


# ---------------------------------------------------------------------------
# a gloo world of 2: one rank native, one not
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@needs_native
def test_native_and_python_ranks_agree_in_a_gloo_world(tmp_path):
    env = dict(os.environ)
    env.update(HVD_TPU_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               HVD_TPU_SIZE="2", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, HERE, "world", str(tmp_path)],
        env=dict(env, HVD_TPU_RANK=str(r),
                 **({"HVD_TPU_NATIVE": "0"} if r == 1 else {})),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    try:
        logs = [p.communicate(timeout=180)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n===\n".join(logs)
    views = [json.load(open(tmp_path / f"world.{r}.json")) for r in range(2)]
    assert views[0] == views[1]
    native, python = views[0]
    assert (native["native"], native["table_native"]) == (True, True)
    assert (python["native"], python["table_native"]) == (False, False)
    assert python["libs"] == [] and len(native["libs"]) == 1
    assert os.path.dirname(native["libs"][0]).endswith(
        os.path.join("build", "torch_native"))
    for key in ("fps", "plans", "opt_plans", "cache_len"):
        assert native[key] == python[key], key
    assert native["fps"] == [jtt.metadata_fingerprint(*m) for m in METAS]
    assert native["sums_ok"] and python["sums_ok"]
    assert native["cache_len"] > 0
    assert len(native["opt_plans"][0][1]) > 1      # several buckets
