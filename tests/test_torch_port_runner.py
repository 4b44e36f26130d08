"""The port's launcher (``horovod_tpu_torch.runner``) against the JAX
package's (``horovod_tpu.runner``).

Host logic is compared bit for bit: the same inputs go through both
packages' host parsing, slot assignment, per-slot env contract, CLI-flag
translation and config-file merge. The two packages' HTTP KV rendezvous
interoperate: each client against the other's server. Then the port's own
launcher: safe_exec, a static launch of a port worker on gloo at -np 2
through both packages' launchers (same env contract), failure propagation,
``runner.run``, the routes that wait and ``--check-build``.

This file is also its own worker: ``python tests/test_torch_port_runner.py
worker <out_dir>`` joins the world the launcher's env describes on the
CPU, allreduces its rank and writes what it saw.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))


def _worker(out_dir: str) -> None:
    sys.path.insert(0, REPO)
    import torch
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    total = hvd.allreduce(torch.tensor([float(hvd.rank() + 1)]),
                          op=hvd.Sum, name="ranks")
    keys = ("RANK", "SIZE", "LOCAL_RANK", "LOCAL_SIZE", "CROSS_RANK",
            "CROSS_SIZE", "HOSTNAME")
    seen = {"rank": hvd.rank(), "size": hvd.size(), "sum": float(total[0]),
            "env": {k: os.environ.get("HVD_TPU_" + k) for k in keys}}
    with open(os.path.join(out_dir, f"seen.{hvd.rank()}.json"), "w") as f:
        json.dump(seen, f)
    hvd.shutdown()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(sys.argv[2])
    sys.exit(0)


from horovod_tpu.runner import config_parser as j_config_parser  # noqa: E402
from horovod_tpu.runner import exec_run as j_exec_run  # noqa: E402
from horovod_tpu.runner import hosts as j_hosts  # noqa: E402
from horovod_tpu.runner import launch as j_launch  # noqa: E402
from horovod_tpu.runner import rendezvous as j_rdv  # noqa: E402

from horovod_tpu_torch.runner import config_parser, exec_run, hosts  # noqa: E402
from horovod_tpu_torch.runner import launch  # noqa: E402
from horovod_tpu_torch.runner import rendezvous as rdv  # noqa: E402
from horovod_tpu_torch.runner.safe_exec import safe_exec  # noqa: E402


def _slots(mod, host_list, np_, max_np=None):
    slots, size = mod.get_host_assignments(
        [mod.HostInfo(h, n) for h, n in host_list], np_, max_np)
    return [dataclasses.astuple(s) for s in slots], size


# -- host parsing and assignment ---------------------------------------------
@pytest.mark.parametrize("spec", [
    "h1:4,h2:2,h3", "localhost", "a:1,b:1,c:1,d:1", "h1:2, h2:3",
    "10.0.0.1:8,10.0.0.2:8"])
def test_parse_hosts_matches_jax(spec):
    assert hosts.parse_hosts(spec) == [
        hosts.HostInfo(h.hostname, h.slots)
        for h in j_hosts.parse_hosts(spec)]


@pytest.mark.parametrize("spec", ["h1:four", "h1:", ":2", " h1 : 2 "])
def test_parse_hosts_rejects_what_jax_rejects(spec):
    try:
        j_hosts.parse_hosts(spec)
        jax_error = None
    except ValueError as e:
        jax_error = str(e)
    if jax_error is None:
        assert hosts.parse_hosts(spec) == [
            hosts.HostInfo(h.hostname, h.slots)
            for h in j_hosts.parse_hosts(spec)]
    else:
        with pytest.raises(ValueError) as e:
            hosts.parse_hosts(spec)
        assert str(e.value) == jax_error


def test_parse_hostfile_matches_jax(tmp_path):
    p = tmp_path / "hostfile"
    p.write_text("# comment\nh1 slots=4\nh2:2\nh3\n\n  h4 slots=1  \n")
    assert [dataclasses.astuple(h) for h in hosts.parse_hostfile(str(p))] \
        == [dataclasses.astuple(h) for h in j_hosts.parse_hostfile(str(p))]


@pytest.mark.parametrize("host_list,np_,max_np", [
    ([("a", 2), ("b", 2)], 4, None),          # ranks and cross ranks
    ([("a", 2), ("b", 1)], 3, None),          # ragged local ranks
    ([("a", 4), ("b", 4)], 2, 6),             # max_np above np
    ([("localhost", 1), ("127.0.0.1", 1)], 1, 2),
    ([("h0", 8)], 8, None),
    ([("h0", 3), ("h1", 1), ("h2", 2)], 5, None),
    ([("h0", 4), ("h1", 4), ("h2", 4), ("h3", 4)], 16, 16),
])
def test_host_assignments_match_jax(host_list, np_, max_np):
    assert _slots(hosts, host_list, np_, max_np) == \
        _slots(j_hosts, host_list, np_, max_np)


def test_host_assignments_insufficient_slots_like_jax():
    with pytest.raises(ValueError) as want:
        j_hosts.get_host_assignments([j_hosts.HostInfo("a", 1)], 2)
    with pytest.raises(ValueError) as got:
        hosts.get_host_assignments([hosts.HostInfo("a", 1)], 2)
    assert str(got.value) == str(want.value)


# -- the env contract ----------------------------------------------------------
@pytest.mark.parametrize("elastic", [False, True])
def test_slot_env_matches_jax(elastic):
    for host_list, np_ in (([("localhost", 2)], 2),
                           ([("a", 2), ("b", 1)], 3)):
        slots, _ = hosts.get_host_assignments(
            [hosts.HostInfo(h, n) for h, n in host_list], np_)
        j_slots, _ = j_hosts.get_host_assignments(
            [j_hosts.HostInfo(h, n) for h, n in host_list], np_)
        for s, js in zip(slots, j_slots):
            base = {"PATH": "/bin", "HVD_TPU_FUSION_THRESHOLD": "1"}
            got = exec_run.slot_env(s, "127.0.0.1:7777", "10.0.0.5", 8888,
                                    elastic=elastic, base_env=dict(base))
            want = j_exec_run.slot_env(js, "127.0.0.1:7777", "10.0.0.5",
                                       8888, elastic=elastic,
                                       base_env=dict(base))
            assert got == want


def test_remote_command_forwards_cuda_visible_devices():
    env = {"HVD_TPU_RANK": "1", "PATH": "/bin", "CUDA_VISIBLE_DEVICES": "2",
           "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "x", "SECRET": "no"}
    got = exec_run._remote_command(["python", "t.py"], env, "node7",
                                   exec_run.FORWARD_ENV)
    want = j_exec_run._remote_command(
        ["python", "t.py"], env, "node7",
        ("PATH", "PYTHONPATH", "CUDA_VISIBLE_DEVICES"))
    assert got == want
    assert "CUDA_VISIBLE_DEVICES=2" in got[-1]
    assert "JAX_PLATFORMS" not in got[-1] and "SECRET" not in got[-1]
    for name in ("localhost", "127.0.0.1", "127.0.0.2", "node7.example.com"):
        assert exec_run.is_local_host(name) == j_exec_run.is_local_host(name)


# -- CLI flags and the config file ---------------------------------------------
@pytest.mark.parametrize("argv", [
    ["--fusion-threshold-mb", "32", "--timeline-filename", "/tmp/t.json",
     "--autotune", "--check-consistency", "--", "python", "x.py"],
    ["--cache-capacity", "0", "--no-stall-check", "--start-timeout", "42",
     "--rendezvous-dir", "/tmp/rdv", "--heartbeat-interval", "2",
     "--heartbeat-timeout", "9", "python", "x.py"],
    ["--cycle-time-ms", "3.5", "--autotune-log-file", "/tmp/a.csv",
     "--autotune-warmup-samples", "2", "--autotune-steps-per-sample", "7",
     "--autotune-bayes-opt-max-samples", "11", "--verbose-log-level",
     "debug", "--stall-check-warning-time-seconds", "5",
     "--stall-check-shutdown-time-seconds", "15", "--timeline-mark-cycles",
     "-np", "2", "python", "x.py"],
])
def test_set_env_from_args_matches_jax(argv):
    got = config_parser.set_env_from_args({}, launch.parse_args(argv))
    want = j_config_parser.set_env_from_args({}, j_launch.parse_args(argv))
    assert got == want and got
    assert launch.parse_args(argv).command == j_launch.parse_args(argv).command


def test_config_file_merge_matches_jax(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(textwrap.dedent("""
        autotune: true
        fusion_threshold_mb: 16
        timeline:
          filename: /tmp/tl.json
        stall_check:
          warning_time_seconds: 10
    """))
    argv = ["--config-file", str(cfg), "--fusion-threshold-mb", "8",
            "python", "x.py"]
    got, want = launch.parse_args(argv), j_launch.parse_args(argv)
    assert vars(got) == vars(want)
    assert got.fusion_threshold_mb == 8          # the flag wins
    assert got.timeline_filename == "/tmp/tl.json"
    assert config_parser.set_env_from_args({}, got) == \
        j_config_parser.set_env_from_args({}, want)


# -- the KV rendezvous: each package's client against the other's server ------
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_kvstore_clients_and_servers_interoperate(server_pkg):
    server_mod, client_mod = (rdv, j_rdv) if server_pkg == "port" \
        else (j_rdv, rdv)
    host_mod = hosts if server_pkg == "port" else j_hosts
    slots, _ = host_mod.get_host_assignments([host_mod.HostInfo("nodeA", 2)],
                                             2)
    server = server_mod.RendezvousServer()
    port = server.start()
    try:
        server.init(slots)
        client = client_mod.KVStoreClient("127.0.0.1", port)
        assert client.get("s", "missing") is None
        client.put("s", "k", b"hello")
        assert client.get("s", "k") == b"hello"
        assert server.get("s", "k") == b"hello"

        def delayed_put():
            time.sleep(0.3)
            client.put("s", "later", b"arrived")
        t = threading.Thread(target=delayed_put)
        t.start()
        assert client.wait("s", "later", timeout=5) == b"arrived"
        t.join()
        client.delete("s", "k")
        assert client.get("s", "k") is None
        with pytest.raises(TimeoutError):
            client.wait("s", "never", timeout=0.3)
        for slot in (0, 1):
            blob = client.get("rank_and_size", f"nodeA:{slot}")
            assert tuple(map(int, blob.decode().split(","))) == \
                (slot, 2, slot, 2, 0, 1)
        assert client.epoch_seen == server.epoch > 0
    finally:
        server.stop()


# -- safe_exec -------------------------------------------------------------------
def test_safe_exec_captures_output(capfd):
    code = safe_exec([sys.executable, "-c", "print('marker-xyz')"],
                     stdout_prefix="[0]<stdout> ")
    assert code == 0
    assert "[0]<stdout> marker-xyz" in capfd.readouterr().out


def test_safe_exec_kills_process_tree(tmp_path):
    stop = threading.Event()
    pidfile = tmp_path / "grandchild.pid"
    script = ("import subprocess,sys,time;"
              "p=subprocess.Popen([sys.executable,'-c','import time;"
              "time.sleep(60)']);"
              f"open({str(pidfile)!r},'w').write(str(p.pid));"
              "time.sleep(60)")
    result = {}

    def target():
        result["code"] = safe_exec([sys.executable, "-c", script],
                                   stop_event=stop)
    t = threading.Thread(target=target)
    t.start()
    deadline = time.time() + 20
    while not pidfile.exists() or not pidfile.read_text():
        assert time.time() < deadline
        time.sleep(0.05)
    stop.set()
    t.join(timeout=15)
    assert not t.is_alive()
    assert result["code"] != 0
    grandchild = int(pidfile.read_text())
    deadline = time.time() + 5
    while os.path.exists(f"/proc/{grandchild}") and time.time() < deadline:
        with open(f"/proc/{grandchild}/stat") as f:
            if f.read().split()[2] == "Z":
                break
        time.sleep(0.05)
    if os.path.exists(f"/proc/{grandchild}"):
        with open(f"/proc/{grandchild}/stat") as f:
            assert f.read().split()[2] == "Z"


# -- launches ----------------------------------------------------------------------
def _env():
    """The test's env, with the repo and this directory importable (the
    run() workers unpickle this module's functions by reference)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, os.path.dirname(HERE), env.get("PYTHONPATH", "")])
    return env


@pytest.mark.parametrize("launcher", ["horovod_tpu_torch.runner",
                                      "horovod_tpu.runner"])
def test_static_launch_of_port_workers_on_gloo(tmp_path, launcher):
    """-np 2 through either package's launcher: the same env contract, and
    the port's workers form a gloo world of 2 from it."""
    logs = tmp_path / "logs"
    r = subprocess.run(
        [sys.executable, "-m", launcher, "-np", "2", "--output-filename",
         str(logs), "--", sys.executable, HERE, "worker", str(tmp_path)],
        env=_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert sorted(p.name for p in logs.iterdir()) == \
        ["rank.0.log", "rank.1.log"]
    for rank in (0, 1):
        seen = json.load(open(tmp_path / f"seen.{rank}.json"))
        assert (seen["rank"], seen["size"], seen["sum"]) == (rank, 2, 3.0)
        assert seen["env"] == {
            "RANK": str(rank), "SIZE": "2", "LOCAL_RANK": str(rank),
            "LOCAL_SIZE": "2", "CROSS_RANK": "0", "CROSS_SIZE": "1",
            "HOSTNAME": "localhost"}


def test_cli_propagates_failure():
    rc = launch.run_commandline(
        ["-np", "2", "--", sys.executable, "-c", "import sys; sys.exit(3)"])
    assert rc == 3


def _run_fn(mult):
    import os
    return int(os.environ["HVD_TPU_RANK"]) * mult


def _allreduce_fn():
    import torch
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    out = hvd.allreduce(torch.tensor([hvd.rank() + 1.0]), op=hvd.Sum)
    hvd.shutdown()
    return float(out[0])


def _raising_fn():
    raise ValueError("boom-unique")


def test_programmatic_run():
    from horovod_tpu_torch.runner import run
    env = _env()
    assert run(_run_fn, args=(10,), np=2, env=env) == [0, 10]
    assert run(_allreduce_fn, np=2, env=env) == [3.0, 3.0]
    with pytest.raises(RuntimeError, match="boom-unique"):
        run(_raising_fn, np=2, env=env)


def test_routes_that_wait_raise_and_elastic_dispatches(monkeypatch):
    """The mpirun and jsrun routes are routed as the JAX launcher routes
    them: on a machine without mpirun (or outside an LSF job) they raise
    the JAX package's errors, and none falls back to the built-in
    launcher; contradictory flags raise; elastic flags dispatch."""
    from horovod_tpu_torch.runner import mpi_run
    monkeypatch.setattr(mpi_run, "_default_exec",
                        lambda cmd: ("mpirun: command not found", 127))
    monkeypatch.delenv("LSB_JOBID", raising=False)
    for argv in (["--mpi", "-np", "2", "python", "x.py"],
                 ["--launcher", "mpi", "python", "x.py"]):
        with pytest.raises(RuntimeError, match="could not find a usable"):
            launch.run_commandline(argv)
    with pytest.raises(RuntimeError, match="requires an LSF job"):
        launch.run_commandline(["--launcher", "jsrun", "python", "x.py"])
    from horovod_tpu_torch.runner import run
    with pytest.raises(RuntimeError, match="could not find a usable"):
        run(_run_fn, args=(1,), np=1, use_mpi=True)
    with pytest.raises(RuntimeError, match="contradictory"):
        launch.run_commandline(["--gloo", "--mpi", "python", "x.py"])
    called = {}
    monkeypatch.setattr(launch, "_run_elastic",
                        lambda args: called.setdefault("elastic", 0))
    assert launch.run_commandline(
        ["--host-discovery-script", "/bin/discover", "python", "x.py"]) == 0
    assert "elastic" in called


def test_check_build_names_torch_and_cuda(capsys):
    assert launch.run_commandline(["--check-build"]) == 0
    out = capsys.readouterr().out
    assert "horovod_tpu_torch v" in out
    import torch
    assert f"PyTorch {torch.__version__}" in out
    assert f"CUDA {torch.version.cuda}" in out
    assert "gloo" in out and "NCCL" in out
