"""The port's elastic package (``horovod_tpu_torch.elastic``) against the
JAX package's (``horovod_tpu.elastic``).

The scripted driver scenarios of ``tests/test_elastic.py`` run through
both drivers with ``FixedHosts``, a recording rendezvous and scripted
``create_worker`` functions: spawn lists, blacklists, results, published
assignments and mesh plans must be identical. Both packages' rendezvous
handlers give the same ``rank_and_size`` payloads and ``requery`` the
same env. Then the worker side: the notification service, the heartbeat
monitor on an injected clock, preemption and SDC reports (the same
bytes), ``ObjectState`` and the retry loop, ``TorchState`` against
``JaxState`` (the same weights, carried across by the port's converters),
``TorchState.restore`` writing into the live tensors, a durable commit
that persists and reloads, and, in gloo worlds of 2, ``TorchState.sync``
and the bound on a dead or wedged peer (``basics.wire_timeout``).

This file is also its own worker: ``python tests/test_torch_port_elastic.py
world <mode> <out_dir>`` with the ``HVD_TPU_COORDINATOR_ADDR/SIZE/RANK``
env joins a gloo world of 2 on the CPU.
"""

import copy
import dataclasses
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
#: the wire-call bound the worlds below run with (HEARTBEAT_TIMEOUT_SECONDS)
WIRE_TIMEOUT = 3.0


def _world_main(mode: str, out_dir: str) -> None:
    sys.path.insert(0, REPO)
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.exceptions import HorovodInternalError

    hvd.init(device="cpu")
    rank = hvd.rank()
    result = {"rank": rank}
    if mode == "sync":
        # rank 0 has trained a step (momentum state); rank 1 is a fresh
        # worker with other weights and no optimizer state
        torch.manual_seed(rank)
        model = torch.nn.Linear(6, 3)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        if rank == 0:
            model(torch.ones(2, 6)).sum().backward()
            opt.step()
        state = hvd.elastic.TorchState(model, opt, epoch=7 if rank == 0
                                       else 0)
        state.sync()
        buf = [opt.state[p]["momentum_buffer"] for p in model.parameters()]
        np.savez(os.path.join(out_dir, f"sync.{rank}.npz"),
                 *[p.detach().numpy() for p in model.parameters()],
                 *[b.numpy() for b in buf])
        result["epoch"] = state.epoch
        mode = "dead"          # the same world then loses rank 1
    if mode in ("dead", "wedged"):
        hvd.barrier()
        if rank == 1:
            if mode == "dead":
                os._exit(0)
            os.kill(os.getpid(), signal.SIGSTOP)
        time.sleep(0.5)        # rank 1 is gone or stopped by now
        t0 = time.monotonic()
        try:
            hvd.allreduce(torch.ones(4), name="after_peer_loss")
            result["error"] = None
        except HorovodInternalError as e:
            result["error"] = type(e).__name__
        result["seconds"] = time.monotonic() - t0
        result["wire_timeout"] = hvd.basics.wire_timeout()
    with open(os.path.join(out_dir, f"{mode}.{rank}.json"), "w") as f:
        json.dump(result, f)
    os._exit(0)


if __name__ == "__main__" and sys.argv[1:2] == ["world"]:
    _world_main(sys.argv[2], sys.argv[3])


import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import horovod_tpu.elastic.discovery as j_discovery  # noqa: E402
import horovod_tpu.elastic.driver as j_driver  # noqa: E402
import horovod_tpu.elastic.heartbeat as j_heartbeat  # noqa: E402
import horovod_tpu.elastic.preemption as j_preemption  # noqa: E402
import horovod_tpu.elastic.rendezvous as j_erdv  # noqa: E402
import horovod_tpu.runner.hosts as j_hosts  # noqa: E402
import horovod_tpu.runner.rendezvous as j_rdv  # noqa: E402
import horovod_tpu.sdc.report as j_report  # noqa: E402
from horovod_tpu.elastic.state import JaxState  # noqa: E402

import horovod_tpu_torch as hvd  # noqa: E402
import horovod_tpu_torch.elastic.discovery as discovery  # noqa: E402
import horovod_tpu_torch.elastic.driver as driver_mod  # noqa: E402
import horovod_tpu_torch.elastic.heartbeat as heartbeat  # noqa: E402
import horovod_tpu_torch.elastic.preemption as preemption  # noqa: E402
import horovod_tpu_torch.elastic.rendezvous as erdv  # noqa: E402
import horovod_tpu_torch.runner.hosts as hosts  # noqa: E402
import horovod_tpu_torch.runner.rendezvous as rdv  # noqa: E402
import horovod_tpu_torch.sdc.report as report  # noqa: E402
from horovod_tpu_torch.elastic.state import ObjectState, TorchState  # noqa: E402
from horovod_tpu_torch.exceptions import (  # noqa: E402
    HorovodInternalError, HostsUpdatedInterrupt)

# the packages export a function named run, which hides the module
j_run = importlib.import_module("horovod_tpu.elastic.run")
run_mod = importlib.import_module("horovod_tpu_torch.elastic.run")
PORT = dict(driver=driver_mod, discovery=discovery, hosts=hosts)
JAX = dict(driver=j_driver, discovery=j_discovery, hosts=j_hosts)


class RecordingRendezvous:
    """What a driver publishes: assignment lists and scoped puts."""

    def __init__(self):
        self.published = []
        self.data = {}

    def init(self, assignment_list):
        self.published.append([dataclasses.astuple(s)
                               for s in assignment_list])

    def put(self, scope, key, value):
        self.data.setdefault(scope, {})[key] = bytes(value)

    def delete(self, scope, key):
        self.data.get(scope, {}).pop(key, None)

    def items(self, scope):
        return dict(self.data.get(scope, {}))

    def stop(self):
        pass


def _wait_until(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


# ---------------------------------------------------------------------------
# the driver scenarios of tests/test_elastic.py, through both drivers
# ---------------------------------------------------------------------------

def _scenario_assigns(pkg, rdv_, spawn):
    d = pkg["driver"].ElasticDriver(
        rdv_, pkg["discovery"].FixedHosts({"h1": 2, "h2": 2}), min_np=4,
        timeout=10)
    d.start(4, lambda s, ev: spawn(s, 0))
    return d


def _scenario_failed_host(pkg, rdv_, spawn):
    holder = {}

    def create(s, ev):
        if s.hostname == "h2":
            return spawn(s, 1)
        holder["d"].record_ready("h1", 0)
        return spawn(s, 0)
    d = holder["d"] = pkg["driver"].ElasticDriver(
        rdv_, pkg["discovery"].FixedHosts({"h1": 1, "h2": 1}), min_np=1,
        max_np=2, timeout=10)
    d.start(2, create)
    return d


def _scenario_grows(pkg, rdv_, spawn):
    fixed = pkg["discovery"].FixedHosts({"h1": 1})
    go = threading.Event()
    holder = {"restarted": False}

    def create(s, ev):
        if s.hostname == "h1" and not holder["restarted"]:
            holder["restarted"] = True
            go.wait(10)
            holder["d"].record_ready("h1", 0)
        return spawn(s, 0)
    d = holder["d"] = pkg["driver"].ElasticDriver(
        rdv_, fixed, min_np=1, max_np=2, timeout=10)
    d.start(1, create)
    fixed.set({"h1": 1, "h2": 1})
    assert _wait_until(lambda: d._host_manager.current_hosts
                       .count_available_slots() == 2)
    go.set()
    return d


def _scenario_all_fail(pkg, rdv_, spawn):
    d = pkg["driver"].ElasticDriver(
        rdv_, pkg["discovery"].FixedHosts({"h1": 2}), min_np=2, timeout=10)
    d.start(2, lambda s, ev: spawn(s, 7))
    return d


def _scenario_reset_limit(pkg, rdv_, spawn):
    holder = {}

    def create(s, ev):
        holder["d"].record_ready("h1", 0)
        return spawn(s, 0)
    d = holder["d"] = pkg["driver"].ElasticDriver(
        rdv_, pkg["discovery"].FixedHosts({"h1": 1}), min_np=1, timeout=10,
        reset_limit=0)
    d.start(1, create)
    return d


def _scenario_cascade(pkg, rdv_, spawn):
    count = {"n": 0}
    lock = threading.Lock()

    def create(s, ev):
        with lock:
            count["n"] += 1
            first_gen = count["n"] <= 2
        if first_gen:
            if s.hostname == "h2":
                return spawn(s, 17)
            time.sleep(0.2)
            return spawn(s, 1)
        return spawn(s, 0)
    d = pkg["driver"].ElasticDriver(
        rdv_, pkg["discovery"].FixedHosts({"h1": 1, "h2": 1}), min_np=1,
        max_np=2, timeout=10)
    d.start(2, create)
    return d


def _scenario_cascade_single_host(pkg, rdv_, spawn):
    return _scenario_all_fail(pkg, rdv_, spawn)


def _scenario_mesh_replan(pkg, rdv_, spawn):
    """The mesh plane (HVD_TPU_MESH_SHAPE dp=2,fsdp=2): h2's two workers
    fail, the survivors' generation of 2 is planned dp=1 x fsdp=2."""
    holder = {}

    def create(s, ev):
        if s.hostname == "h2":
            return spawn(s, 1)
        holder["d"].record_ready(s.hostname, s.local_rank)
        return spawn(s, 0)
    d = holder["d"] = pkg["driver"].ElasticDriver(
        rdv_, pkg["discovery"].FixedHosts({"h1": 2, "h2": 2}), min_np=2,
        max_np=4, timeout=10)
    d.start(4, create)
    return d


SCENARIOS = {
    "assigns_ranks_and_collects_results": _scenario_assigns,
    "blacklists_failed_host_and_survivor_continues": _scenario_failed_host,
    "grows_when_host_added": _scenario_grows,
    "all_failures_stops_job": _scenario_all_fail,
    "reset_limit": _scenario_reset_limit,
    "cascade_total_failure_respawns_survivors": _scenario_cascade,
    "cascade_single_host_still_stops": _scenario_cascade_single_host,
    "mesh_replan_after_host_loss": _scenario_mesh_replan,
}


def _run_scenario(pkg, name):
    rdv_ = RecordingRendezvous()
    spawns = []
    lock = threading.Lock()

    def spawn(slot, code):
        with lock:
            spawns.append((len(rdv_.published),)
                          + dataclasses.astuple(slot))
        return code, time.time()
    d = SCENARIOS[name](pkg, rdv_, spawn)
    try:
        results = d.get_results()
        hosts_seen = sorted({s[1] for s in spawns})
        return {
            "spawns": sorted(spawns),
            "published": rdv_.published,
            "scopes": {k: v for k, v in rdv_.data.items()},
            "blacklisted": [h for h in hosts_seen
                            if d._host_manager.is_blacklisted(h)],
            "results": sorted((k, code) for k, (code, _) in
                              results.worker_results.items()),
            "error": results.error_message,
            "world_size": d.world_size(),
            "finished": d.finished(),
            "mesh": d.mesh_shape(),
        }
    finally:
        d.stop()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_driver_scenarios_match_jax(name, monkeypatch):
    if name == "mesh_replan_after_host_loss":
        monkeypatch.setenv("HVD_TPU_MESH_SHAPE", "dp=2,fsdp=2")
    want = _run_scenario(JAX, name)
    got = _run_scenario(PORT, name)
    assert got == want
    if name == "mesh_replan_after_host_loss":
        axes = json.loads(got["scopes"][driver_mod.MESH_SCOPE]["shape"])
        assert axes["axes"]["dp"] == 1 and axes["axes"]["fsdp"] == 2
        assert got["scopes"][driver_mod.BLACKLIST_SCOPE] == {"h2": b"failure"}
    if name == "cascade_total_failure_respawns_survivors":
        assert [s[1] for s in got["spawns"] if s[0] == 2] == ["h1"]


def test_wait_for_slots_timeout_like_jax():
    msgs = []
    for pkg in (JAX, PORT):
        d = pkg["driver"].ElasticDriver(
            RecordingRendezvous(), pkg["discovery"].FixedHosts({}),
            min_np=1, timeout=0.3)
        try:
            with pytest.raises(TimeoutError) as e:
                d.wait_for_available_slots(1)
            msgs.append(str(e.value))
        finally:
            d.stop()
    assert msgs[0] == msgs[1]


def test_host_manager_and_discovery_script_like_jax(tmp_path):
    script = tmp_path / "discover.sh"
    script.write_text("#!/bin/sh\necho host-1:2\necho host-2\n")
    script.chmod(0o755)
    for pkg in (JAX, PORT):
        disc = pkg["discovery"]
        assert disc.HostDiscoveryScript(
            str(script), default_slots=4).find_available_hosts_and_slots() \
            == {"host-1": 2, "host-2": 4}
        fixed = disc.FixedHosts({"a": 2, "b": 2})
        hm = disc.HostManager(fixed)
        assert hm.update_available_hosts()
        fixed.set({"c": 2, "a": 2, "b": 2})
        assert hm.update_available_hosts()
        hm.blacklist("b")
        assert hm.current_hosts.host_assignment_order == ["a", "c"]
        assert not hm.update_available_hosts()


# ---------------------------------------------------------------------------
# rank_and_size and the requery
# ---------------------------------------------------------------------------

class _StubDriver:
    def __init__(self, hosts_mod, driver_module):
        slots, _ = hosts_mod.get_host_assignments(
            [hosts_mod.HostInfo("wa", 2), hosts_mod.HostInfo("wb", 1)], 3)
        self.slots = {(s.hostname, s.local_rank): s for s in slots}
        self.invalid = driver_module.INVALID_SLOT_INFO
        self.ready = []

    def record_ready(self, host, slot):
        self.ready.append((host, slot))

    def get_slot_info(self, host, slot):
        return self.slots.get((host, slot), self.invalid)

    def register_worker_server(self, host, slot, addresses, key):
        pass


RANK_ENV = ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_LOCAL_RANK",
            "HVD_TPU_LOCAL_SIZE", "HVD_TPU_CROSS_RANK", "HVD_TPU_CROSS_SIZE",
            "HVD_TPU_COORDINATOR_ADDR")


def _requery(server_mod, erdv_mod, hosts_mod, drv_mod, run_module,
             monkeypatch):
    server = server_mod.RendezvousServer()
    server.start()
    try:
        stub = _StubDriver(hosts_mod, drv_mod)
        erdv_mod.attach_elastic_handlers(server, stub)
        server.put("coordinator", "addr", b"10.0.0.9:4321")
        client = rdv.KVStoreClient("127.0.0.1", server.port)
        payloads = {k: client.get("rank_and_size", f"{k[0]}:{k[1]}")
                    for k in (("wa", 0), ("wa", 1), ("wb", 0), ("gone", 0))}
        for var in RANK_ENV:
            monkeypatch.setenv(var, "")
        monkeypatch.setenv("HVD_TPU_RENDEZVOUS_ADDR", "127.0.0.1")
        monkeypatch.setenv("HVD_TPU_RENDEZVOUS_PORT", str(server.port))
        monkeypatch.setenv("HVD_TPU_HOSTNAME", "wa")
        monkeypatch.setenv("HVD_TPU_LOCAL_RANK", "1")
        assert run_module.requery_assignment()
        env = {v: os.environ[v] for v in RANK_ENV}
        monkeypatch.setenv("HVD_TPU_HOSTNAME", "gone")
        monkeypatch.setenv("HVD_TPU_LOCAL_RANK", "0")
        no_slot = run_module.requery_assignment()
        return payloads, env, no_slot, stub.ready
    finally:
        server.stop()


def test_rank_and_size_and_requery_match_jax(monkeypatch):
    want = _requery(j_rdv, j_erdv, j_hosts, j_driver, j_run, monkeypatch)
    got = _requery(rdv, erdv, hosts, driver_mod, run_mod, monkeypatch)
    assert got == want
    payloads, env, no_slot, _ = got
    assert payloads[("wa", 1)] == b"1,3,1,2,0,1"
    assert payloads[("gone", 0)] == b"-1,-1,-1,-1,-1,-1"
    assert env["HVD_TPU_RANK"] == "1"
    assert env["HVD_TPU_COORDINATOR_ADDR"] == "10.0.0.9:4321"
    assert no_slot is False


# ---------------------------------------------------------------------------
# notification service, heartbeats, preemption and SDC reports
# ---------------------------------------------------------------------------

def test_notification_service_round_trip_and_bad_key():
    from horovod_tpu_torch.elastic.worker import (WorkerNotificationClient,
                                                  WorkerNotificationService)
    from horovod_tpu_torch.runner.network import make_secret_key
    received = []

    class Manager:
        def handle_hosts_updated(self, ts):
            received.append(ts)

    key = make_secret_key()
    svc = WorkerNotificationService(key, Manager())
    try:
        addrs = {"lo": [("127.0.0.1", svc.port)]}
        WorkerNotificationClient(addrs, key).notify_hosts_updated(123.0)
        assert _wait_until(lambda: received == [123.0], 5)
        bad = WorkerNotificationClient(addrs, make_secret_key())
        with pytest.raises(ConnectionError):
            bad.notify_hosts_updated(1.0)
        assert received == [123.0]
    finally:
        svc.shutdown()


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


def _heartbeat_trace(mod, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    dead = []
    mon = mod.HeartbeatMonitor(
        on_dead=lambda h, s, r: dead.append((h, s, r, clock.now)),
        timeout=3.0, poll_interval=1.0)
    trace = [mon.timeout]
    mon.observe("h1:0", b"0")
    mon.observe("h2:0", b"1")
    for step in range(10):
        clock.now += 1.0
        if step < 5:
            mon.observe("h1:0", b"0")      # h1 keeps beating for 5 s
        if step == 1:
            mon.forget("h2", 0)            # h2's worker exited cleanly
            mon.observe("h3:1", b"2")      # h3 arms, then goes silent
        mon.check_now()
        trace.append((mon.last_beat_age("h1", 0),
                      mon.last_beat_age("h3", 1), list(dead)))
    return trace, dead


def test_heartbeat_monitor_on_injected_clock_matches_jax(monkeypatch):
    want, _ = _heartbeat_trace(j_heartbeat, monkeypatch)
    got, dead = _heartbeat_trace(heartbeat, monkeypatch)
    assert got == want
    # h3 armed at t+2 and silent: declared past 3 s; h1 silent from t+5
    assert [(h, s, r) for h, s, r, _ in dead] == [("h3", 1, "2"),
                                                  ("h1", 0, "0")]


def test_preemption_and_sdc_reports_encode_to_the_same_bytes():
    for grace, ts in ((0.0, 1.5), (30.0, 1700000000.25)):
        assert preemption.encode_notice(grace, ts) == \
            j_preemption.encode_notice(grace, ts)
    for kind, strikes, ts in (("nonfinite", 1, 2.0),
                              ("fingerprint", 3, 1700000000.5)):
        assert report.encode_report(kind, strikes, ts) == \
            j_report.encode_report(kind, strikes, ts)
    for blob in (b'{"grace": 12, "ts": 5}', b"7", b"", b"{bad"):
        got, want = preemption.decode_notice(blob), \
            j_preemption.decode_notice(blob)
        assert got[0] == want[0]
    for blob in (b'{"kind": "loss_spike", "strikes": 2, "ts": 9}',
                 b'"fingerprint"', b""):
        assert report.decode_report(blob)[:2] == \
            j_report.decode_report(blob)[:2]


# ---------------------------------------------------------------------------
# state and the retry loop
# ---------------------------------------------------------------------------

def _identity_bcast(obj, root_rank=0, name=None):
    return obj


def test_object_state_commit_restore_and_interrupt():
    s = ObjectState(bcast_object=_identity_bcast, get_rank=lambda: 0,
                    batch=0, epoch=0)
    s.batch, s.epoch = 5, 1
    s.commit()
    s.batch = 99
    s.restore()
    assert s.batch == 5 and s.epoch == 1
    s.on_hosts_updated(time.time())
    with pytest.raises(HostsUpdatedInterrupt):
        s.commit()
    s.commit()       # the timestamp was consumed


def test_run_fn_retry_loop():
    s = ObjectState(bcast_object=_identity_bcast, get_rank=lambda: 0, n=0)
    resets, attempts = [], []

    def train(state):
        attempts.append(1)
        if len(attempts) == 1:
            raise HorovodInternalError("boom")
        if len(attempts) == 2:
            raise HostsUpdatedInterrupt()
        return "done"

    wrapped = run_mod.run_fn(train, lambda state: resets.append(1))
    assert wrapped(s) == "done"
    assert len(attempts) == 3 and len(resets) == 2


TINY = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4,
            head_dim=8, max_seq_len=16)


def test_torch_state_matches_jax_state():
    """The same weights in both packages: save, modify, restore, equal.
    JaxState rebinds its attribute to the snapshot; TorchState writes it
    into the live parameters, which stay the same objects."""
    import jax
    from flax.core import meta
    from horovod_tpu.models import transformer as jtr
    from horovod_tpu_torch.models import (Transformer, TransformerConfig,
                                          params_from_flax)
    jmodel = jtr.Transformer(jtr.TransformerConfig(**TINY))
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, TINY["max_seq_len"]), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray,
                                    meta.unbox(variables["params"]))
    model = Transformer(TransformerConfig(**TINY), device="cpu")
    model.load_state_dict(params_from_flax(params))
    live = dict(model.named_parameters())

    js = JaxState(bcast_object=_identity_bcast, get_rank=lambda: 0,
                  params=params, step=0)
    ts = TorchState(model, None, bcast_object=_identity_bcast,
                    get_rank=lambda: 0, step=0)
    js.params = jax.tree_util.tree_map(lambda x: x * 2.0 + 0.5, js.params)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(2.0).add_(0.5)
    js.step = ts.step = 10
    js.commit()
    ts.commit()
    js.params = jax.tree_util.tree_map(lambda x: x * 100.0, js.params)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(100.0)
    js.step = ts.step = 11
    js.restore()
    ts.restore()
    assert js.step == ts.step == 10
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, js.params))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert all(p is live[n] for n, p in model.named_parameters())


def _linear_and_adamw(seed=0):
    torch.manual_seed(seed)
    model = torch.nn.Linear(5, 3)
    return model, torch.optim.AdamW(model.parameters(), lr=0.01)


def _step(model, opt, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(4, 5, generator=g)
    opt.zero_grad()
    model(x).pow(2).sum().backward()
    opt.step()


def test_torch_state_restore_writes_into_live_tensors():
    """After restore() the optimizer steps the restored values: the
    parameters are the same objects the optimizer and its hooks hold, and
    a further step matches a fresh model and optimizer built from the
    committed state."""
    model, opt = _linear_and_adamw()
    weight, bias = model.weight, model.bias
    state = TorchState(model, opt, bcast_object=_identity_bcast,
                       get_rank=lambda: 0, epoch=0)
    _step(model, opt, 1)
    state.epoch = 1
    state.commit()
    committed = {k: v.clone() for k, v in model.state_dict().items()}
    ref_model, ref_opt = _linear_and_adamw()
    ref_model.load_state_dict(committed)
    # load_state_dict keeps the tensors it is given: a copy, or the
    # reference would move with opt's next steps
    ref_opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    _step(model, opt, 2)
    _step(model, opt, 3)
    state.epoch = 3
    state.restore()
    assert state.epoch == 1
    assert model.weight is weight and model.bias is bias
    assert opt.param_groups[0]["params"][0] is weight
    for k, v in model.state_dict().items():
        assert torch.equal(v, committed[k]), k
    _step(model, opt, 2)
    _step(ref_model, ref_opt, 2)
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref_model.state_dict()[k]), k
    # the snapshot did not move with the step
    assert torch.equal(state._saved_state["model"]["weight"],
                       committed["weight"])


def test_torch_state_with_distributed_optimizer_after_reset():
    """A DistributedOptimizer keeps working across restore(): the hooks
    still fire on the restored parameters, and the buckets a reset left
    half staged are dropped rather than tripping the next step."""
    hvd.init(device="cpu")
    try:
        model, base = _linear_and_adamw()
        opt = hvd.DistributedOptimizer(
            base, named_parameters=model.named_parameters())
        state = TorchState(model, opt, bcast_object=_identity_bcast,
                           get_rank=lambda: 0)
        _step(model, opt, 1)
        state.commit()
        ref_model, ref_opt = _linear_and_adamw()
        ref_model.load_state_dict(model.state_dict())
        ref_opt.load_state_dict(copy.deepcopy(base.state_dict()))
        x = torch.randn(4, 5)
        model(x).pow(2).sum().backward()      # a step the reset abandons
        assert opt._handles
        # the retry loop after a HorovodInternalError: restore, the
        # in-process reset (shutdown + init), on_reset
        state.restore()
        run_mod.reset(state)
        state.on_reset()
        assert not opt._handles and not opt._fired_ids
        _step(model, opt, 2)
        _step(ref_model, ref_opt, 2)
        for k, v in model.state_dict().items():
            assert torch.equal(v, ref_model.state_dict()[k]), k
    finally:
        hvd.shutdown()


def test_commit_persists_and_reloads(tmp_path, monkeypatch):
    monkeypatch.setenv("HVD_TPU_ELASTIC_STATE_DIR", str(tmp_path))
    monkeypatch.setenv("HVD_TPU_HOSTNAME", "hostA")
    monkeypatch.setenv("HVD_TPU_LOCAL_RANK", "0")
    s1 = ObjectState(bcast_object=_identity_bcast, get_rank=lambda: 0,
                     epoch=0, total=0.0)
    s1.epoch, s1.total = 3, 12.5
    s1.commit()
    assert [f.name for f in tmp_path.iterdir()] == ["state_job_hostA_0.pkl"]
    s2 = ObjectState(bcast_object=_identity_bcast, get_rank=lambda: 0,
                     epoch=0, total=0.0)
    assert run_mod.maybe_load_persisted_state(s2)
    assert (s2.epoch, s2.total) == (3, 12.5)
    # a TorchState commit persists its host snapshot; a respawned worker
    # (fresh model, fresh optimizer) reloads it into its live tensors
    model, opt = _linear_and_adamw()
    ts = TorchState(model, opt, bcast_object=_identity_bcast,
                    get_rank=lambda: 0, epoch=0)
    _step(model, opt, 5)
    ts.epoch = 4
    ts.commit()
    model2, opt2 = _linear_and_adamw(seed=1)
    ts2 = TorchState(model2, opt2, bcast_object=_identity_bcast,
                     get_rank=lambda: 0, epoch=0)
    assert run_mod.maybe_load_persisted_state(ts2)
    assert ts2.epoch == 4
    for k, v in model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v), k
    _step(model, opt, 6)
    _step(model2, opt2, 6)
    for k, v in model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v), k
    monkeypatch.setenv("HVD_TPU_LOCAL_RANK", "1")
    s3 = ObjectState(bcast_object=_identity_bcast, get_rank=lambda: 0,
                     epoch=0)
    assert not run_mod.maybe_load_persisted_state(s3)


def test_reset_in_process_reforms_the_world():
    """Outside a launch the reset is shutdown + init at the same identity
    (device, overrides): a new process group, the counter ticked."""
    from horovod_tpu_torch import basics, metrics
    hvd.init(device="cpu",
             config_overrides={"HEARTBEAT_TIMEOUT_SECONDS": 7.0})
    try:
        before = basics.world()
        key = "hvd_tpu_worker_restarts_total"
        n = metrics.snapshot().get(key, 0)
        run_mod.reset(None)
        after = basics.world()
        assert after is not before and after.device.type == "cpu"
        assert basics.wire_timeout(after.config) == 7.0
        assert metrics.snapshot()[key] == n + 1
        assert float(hvd.allreduce(torch.ones(1))[0]) == 1.0
    finally:
        hvd.shutdown()


# ---------------------------------------------------------------------------
# gloo worlds of 2: TorchState.sync, and the bound on a dead or wedged peer
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_world(mode, out_dir):
    env = dict(os.environ)
    env.update(HVD_TPU_COORDINATOR_ADDR=f"127.0.0.1:{_free_port()}",
               HVD_TPU_SIZE="2", HVD_TPU_HEARTBEAT_TIMEOUT_SECONDS=str(
                   WIRE_TIMEOUT),
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, HERE, "world", mode, str(out_dir)],
        env=dict(env, HVD_TPU_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        out = procs[0].communicate(timeout=120)[0].decode(errors="replace")
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGCONT)
                p.kill()
            p.wait()
    return out


def test_torch_state_sync_and_dead_peer_in_a_gloo_world(tmp_path):
    """sync(): rank 1 (other weights, no optimizer state yet) ends with
    rank 0's parameters, momentum buffers and attribute values. Then rank
    1 dies: rank 0's next call raises HorovodInternalError well inside the
    wire-call bound (gloo sees the closed connection)."""
    out = _spawn_world("sync", tmp_path)
    assert (tmp_path / "sync.1.npz").exists(), out
    a, b = np.load(tmp_path / "sync.0.npz"), np.load(tmp_path / "sync.1.npz")
    assert len(a.files) == 4
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    assert np.abs(a["arr_2"]).sum() > 0     # momentum was rank 0's
    res = json.load(open(tmp_path / "dead.0.json"))
    assert res["error"] == "HorovodInternalError", (res, out)
    assert res["wire_timeout"] == WIRE_TIMEOUT
    assert res["seconds"] < WIRE_TIMEOUT, res
    print(f"dead gloo peer surfaced after {res['seconds']:.3f}s "
          f"(bound {WIRE_TIMEOUT}s)")


def test_wedged_peer_fails_at_the_wire_bound(tmp_path):
    """Rank 1 is stopped (alive, silent): rank 0's call fails with
    HorovodInternalError once the bound basics.init passed to the process
    group runs out, not after torch's default of 30 minutes."""
    out = _spawn_world("wedged", tmp_path)
    res = json.load(open(tmp_path / "wedged.0.json"))
    assert res["error"] == "HorovodInternalError", (res, out)
    assert WIRE_TIMEOUT * 0.9 <= res["seconds"] < WIRE_TIMEOUT + 10, res
    print(f"wedged gloo peer surfaced after {res['seconds']:.3f}s "
          f"(bound {WIRE_TIMEOUT}s)")
