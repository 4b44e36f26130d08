"""The port's mpirun and jsrun routes (``horovod_tpu_torch.runner.mpi_run``,
``runner.lsf``, ``config.mpi_task_identity``, the launcher's routing and
``run_task``'s MPI branch) against the JAX package's, on the CPU.

The routes are checked without an MPI installation, through an injected
implementation probe and spawn (as the JAX package's
``tests/test_mpi_run.py`` does): for every implementation and setting,
the port assembles the JAX package's mpirun argv, bit for bit, and hands
the workers the same environment; the jsrun command line and the jsrun rank
shim's environment are the same; ``mpi_task_identity`` resolves every
scheduler family the same way, and ``Config.get`` falls back to it. A
machine without mpirun raises the JAX package's error.
"""

import os
import subprocess
import sys

import pytest

from horovod_tpu import config as jconfig
from horovod_tpu.runner import launch as jlaunch
from horovod_tpu.runner import lsf as jlsf
from horovod_tpu.runner import mpi_run as jmpi
from horovod_tpu.runner import run_task as jrun_task
from horovod_tpu_torch import config as tconfig
from horovod_tpu_torch.runner import launch as tlaunch
from horovod_tpu_torch.runner import lsf as tlsf
from horovod_tpu_torch.runner import mpi_run as tmpi
from horovod_tpu_torch.runner import run_task as trun_task

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = {"Open MPI": "mpirun (Open MPI) 4.1.4\n",
           "OpenRTE": "mpirun (OpenRTE) 3.0.0\n",
           "Spectrum": "mpirun (IBM Spectrum MPI) 10.3.0.0\n",
           "MPICH": "HYDRA build details:\n    Version: MPICH 4.0\n",
           "unknown": "some other launcher 1.0\n"}


def _exec(out, code=0):
    return lambda cmd: (out, code)


@pytest.mark.parametrize("out,code", [
    (OUTPUTS["Open MPI"], 0), (OUTPUTS["OpenRTE"], 0),
    (OUTPUTS["Spectrum"], 0), (OUTPUTS["MPICH"], 0),
    (OUTPUTS["unknown"], 0), ("", 127)])
def test_implementation_detection_matches_jax(out, code):
    assert tmpi.get_mpi_implementation(_exec(out, code)) == \
        jmpi.get_mpi_implementation(_exec(out, code))
    assert tmpi.mpi_available(_exec(out, code)) == \
        jmpi.mpi_available(_exec(out, code))


@pytest.mark.parametrize("name", ["PATH", "HVD_TPU_X", "OMPI_COMM_WORLD_RANK",
                                  "PMI_RANK", "SLURM_JOBID", "BASH_FUNC_x%%",
                                  "PWD", "MPI_LOCALRANKID", "A=B", ""])
def test_exportable_matches_jax(name):
    assert tmpi.is_exportable(name) == jmpi.is_exportable(name)


SETTINGS = [
    dict(num_proc=4, hosts="a:2,b:2"),
    dict(num_proc=2, hosts="a:1,b:1", ssh_port=2222),
    dict(num_proc=2, hosts="a:1,b:1", nics=("eth0", "ib0")),
    dict(num_proc=2, hosts="a:1,b:1", output_filename="/tmp/logs"),
    dict(num_proc=2, hosts="a:1,b:1", extra_mpi_args="-mca foo 'bar baz'"),
    dict(num_proc=2, hosts="a:1,b:1", binding_args="-bind-to core"),
    dict(num_proc=2, hosts="a:1,b:1", tcp_flag=True),
    dict(num_proc=64, hosts=",".join(f"h{i}:1" for i in range(64))),
]


@pytest.mark.parametrize("impl", [jmpi.OPENMPI_IMPL, jmpi.SPECTRUM_IMPL,
                                  jmpi.MPICH_IMPL])
@pytest.mark.parametrize("settings", SETTINGS)
def test_mpirun_command_matches_jax(impl, settings, capsys):
    env = {"HVD_TPU_SIZE": "4", "PATH": "/bin", "OMPI_X": "1",
           "MYVAR": "v", "BASH_FUNC_f%%": "()"}
    cmd = ["python", "train.py", "--flag"]
    want = jmpi.mpi_run_command(jmpi.MPISettings(**settings), env, cmd,
                                impl=impl)
    jerr = capsys.readouterr().err
    got = tmpi.mpi_run_command(tmpi.MPISettings(**settings), env, cmd,
                               impl=impl)
    assert got == want
    assert capsys.readouterr().err == jerr      # the same warnings


@pytest.mark.parametrize("out", [OUTPUTS["unknown"], ""])
def test_missing_or_unknown_mpi_raises_the_jax_error(out):
    with pytest.raises(RuntimeError) as want:
        jmpi.mpi_run_command(jmpi.MPISettings(2, "a:1"), {}, ["c"],
                             exec_fn=_exec(out, 0 if out else 127))
    with pytest.raises(RuntimeError) as got:
        tmpi.mpi_run_command(tmpi.MPISettings(2, "a:1"), {}, ["c"],
                             exec_fn=_exec(out, 0 if out else 127))
    assert str(got.value) == str(want.value) == tmpi.MPI_NOT_FOUND_MSG


def test_coordinator_address_matches_jax():
    for hosts in ("a:2,b:2", "node7:4"):
        for seed in ("job1", "j2", None):
            assert tmpi.coordinator_addr_for(hosts, seed) == \
                jmpi.coordinator_addr_for(hosts, seed)
    assert tmpi.stable_coordinator_port("x") == \
        jmpi.stable_coordinator_port("x")


def test_mpi_run_hands_workers_the_jax_environment():
    env = {"HVD_TPU_SIZE": "8", "HVD_TPU_RANK": "0", "HOROVOD_RANK": "1",
           "SLURM_PROCID": "0", "PMI_RANK": "3", "OMPI_COMM_WORLD_RANK": "1",
           "MYVAR": "v"}
    seen = {}
    for name, mod in (("jax", jmpi), ("torch", tmpi)):
        def spawn(argv, launcher_env, name=name):
            seen[name] = (argv, launcher_env)
            return 3
        rc = mod.mpi_run(mod.MPISettings(num_proc=4, hosts="a:2,b:2"),
                         dict(env), ["python", "t.py"],
                         exec_fn=_exec(OUTPUTS["Open MPI"]), spawn_fn=spawn)
        assert rc == 3                        # the exit code propagates
    assert seen["torch"] == seen["jax"]
    argv, launcher_env = seen["torch"]
    assert launcher_env["HVD_TPU_SIZE"] == "4"
    assert "HVD_TPU_RANK" not in launcher_env
    assert "SLURM_PROCID" not in launcher_env


FAMILIES = [
    {"OMPI_COMM_WORLD_RANK": "3", "OMPI_COMM_WORLD_SIZE": "4",
     "OMPI_COMM_WORLD_LOCAL_RANK": "1", "OMPI_COMM_WORLD_LOCAL_SIZE": "2"},
    {"OMPI_COMM_WORLD_RANK": "3", "OMPI_COMM_WORLD_SIZE": "5",
     "OMPI_COMM_WORLD_LOCAL_RANK": "1", "OMPI_COMM_WORLD_LOCAL_SIZE": "2"},
    {"PMIX_RANK": "5", "JSM_NAMESPACE_SIZE": "8",
     "JSM_NAMESPACE_LOCAL_RANK": "1", "JSM_NAMESPACE_LOCAL_SIZE": "4"},
    {"PMIX_RANK": "5"},
    {"SLURM_PROCID": "3", "SLURM_STEP_NUM_TASKS": "8",
     "SLURM_LOCALID": "1", "SLURM_STEP_TASKS_PER_NODE": "4(x2)"},
    {"SLURM_PROCID": "3", "SLURM_STEP_NUM_TASKS": "6",
     "SLURM_LOCALID": "1", "SLURM_STEP_TASKS_PER_NODE": "2,4"},
    {"SLURM_PROCID": "0"},
    {"PMI_RANK": "3", "PMI_SIZE": "4", "MPI_LOCALRANKID": "1",
     "MPI_LOCALNRANKS": "2"},
    {"PMI_RANK": "x", "PMI_SIZE": "4"},
    {},
]


@pytest.mark.parametrize("env", FAMILIES)
def test_mpi_task_identity_matches_jax(env):
    assert tconfig.mpi_task_identity(env) == jconfig.mpi_task_identity(env)
    assert tconfig.mpi_task_identity(env, with_source=True) == \
        jconfig.mpi_task_identity(env, with_source=True)
    assert tlsf.jsrun_rank_env(env) == jlsf.jsrun_rank_env(env)


def test_config_falls_back_to_the_scheduler_identity(monkeypatch):
    for k in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_LOCAL_RANK",
              "HVD_TPU_LOCAL_SIZE", "HVD_TPU_CROSS_RANK",
              "HVD_TPU_CROSS_SIZE", "HOROVOD_RANK", "HOROVOD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in FAMILIES[0].items():
        monkeypatch.setenv(k, v)
    cfg, jcfg = tconfig.Config(), jconfig.Config()
    for knob in ("RANK", "SIZE", "LOCAL_RANK", "LOCAL_SIZE", "CROSS_RANK",
                 "CROSS_SIZE"):
        assert cfg.get(knob) == jcfg.get(knob)
    assert (cfg.get("RANK"), cfg.get("SIZE"), cfg.get("CROSS_RANK")) == \
        (3, 4, 1)
    monkeypatch.setenv("HVD_TPU_RANK", "0")          # explicit wins
    assert tconfig.Config().get("RANK") == 0


def test_world_of_one_from_the_mpi_env(monkeypatch):
    """A worker as mpirun starts it at -np 1 resolves its identity."""
    import horovod_tpu_torch as hvd
    for k, v in (("OMPI_COMM_WORLD_RANK", "0"), ("OMPI_COMM_WORLD_SIZE", "1"),
                 ("OMPI_COMM_WORLD_LOCAL_RANK", "0"),
                 ("OMPI_COMM_WORLD_LOCAL_SIZE", "1")):
        monkeypatch.setenv(k, v)
    for k in ("HVD_TPU_RANK", "HVD_TPU_SIZE", "HVD_TPU_LOCAL_RANK",
              "HVD_TPU_LOCAL_SIZE", "HVD_TPU_CROSS_RANK",
              "HVD_TPU_CROSS_SIZE"):
        monkeypatch.delenv(k, raising=False)
    hvd.init(device="cpu")
    try:
        assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
                hvd.cross_rank(), hvd.cross_size()) == (0, 1, 0, 1, 0, 1)
    finally:
        hvd.shutdown()


def test_run_task_takes_its_rank_from_the_mpi_env(monkeypatch):
    monkeypatch.delenv("HVD_TPU_RANK", raising=False)
    monkeypatch.setenv("PMI_RANK", "2")
    monkeypatch.setenv("PMI_SIZE", "4")
    seen = []
    for mod in (jrun_task, trun_task):
        monkeypatch.setattr(mod, "execute_from_store",
                            lambda rank: seen.append(rank))
        assert mod.main() == 0
    assert seen == [2, 2]


def _lsf_env(monkeypatch, tmp_path):
    hostfile = tmp_path / "hosts"
    hostfile.write_text("batch\nn1\nn1\nn2\nn2\n")
    monkeypatch.setenv("LSB_JOBID", "4242")
    monkeypatch.setenv("LSB_DJOB_HOSTFILE", str(hostfile))
    monkeypatch.setenv("LSB_SUBCPUNUM", "3")


def test_jsrun_command_and_lsf_hosts_match_jax(monkeypatch, tmp_path):
    _lsf_env(monkeypatch, tmp_path)
    assert tlsf.LSFUtils.get_compute_hosts() == \
        jlsf.LSFUtils.get_compute_hosts() == [("n1", 2), ("n2", 2)]
    env = {"HVD_TPU_SIZE": "4", "HOROVOD_X": "1", "PATH": "/bin",
           "OTHER": "no"}
    for kw in ({}, {"num_proc": 4, "num_hosts": 2},
               {"num_proc": 2, "num_hosts": 2, "launcher_args": ["-a", "b"]},
               {"cpu_per_rs": "7"}):
        assert tlsf.make_jsrun_command(["c", "d"], env, **kw) == \
            jlsf.make_jsrun_command(["c", "d"], env, **kw)
    monkeypatch.delenv("LSB_DJOB_HOSTFILE")
    monkeypatch.setenv("LSB_MCPU_HOSTS", "batch 1 a 4 b 4")
    assert tlsf.LSFUtils.get_compute_hosts() == \
        jlsf.LSFUtils.get_compute_hosts()


def test_lsf_shim_execs_with_the_rank_env(tmp_path):
    env = dict(os.environ, PMIX_RANK="5", JSM_NAMESPACE_SIZE="8",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    for k in ("HVD_TPU_RANK", "HVD_TPU_SIZE"):
        env.pop(k, None)
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner.lsf", "--",
         sys.executable, "-c",
         "import os; print(os.environ['HVD_TPU_RANK'], "
         "os.environ['HVD_TPU_SIZE'])"],
        env=env, capture_output=True, text=True, timeout=60, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["5", "8"]


# ---------------------------------------------------------------------------
# the launcher's routing
# ---------------------------------------------------------------------------

def _cli(mod, mpi_mod, argv, monkeypatch, impl_out=OUTPUTS["Open MPI"]):
    captured = {}
    monkeypatch.setattr(mpi_mod, "_default_exec", _exec(impl_out))

    def fake_run(cmd, env=None, **kw):
        captured["argv"] = list(cmd)
        captured["env"] = dict(env or {})

        class R:
            returncode = 0
        return R()
    monkeypatch.setattr(subprocess, "run", fake_run)
    rc = mod.run_commandline(argv)
    return rc, captured


@pytest.mark.parametrize("argv", [
    ["--mpi", "-np", "4", "-H", "a:2,b:2", "python", "train.py"],
    ["--launcher", "mpi", "-np", "2", "-H", "a:1,b:1", "cmd"],
    ["--mpi", "-np", "2", "-H", "a:1,b:1", "--mpi-args", "-mca foo bar",
     "--fusion-threshold-mb", "32", "--autotune", "cmd"],
    ["-np", "2", "-H", "remote-a:1,remote-b:1", "cmd"],     # auto: remote
])
def test_cli_mpirun_command_matches_jax(argv, monkeypatch):
    argv = ["--disable-ssh-check"] + argv
    monkeypatch.setenv("HVD_TPU_JOB_SEED", "fixed")
    rc_j, want = _cli(jlaunch, jmpi, argv, monkeypatch)
    rc_t, got = _cli(tlaunch, tmpi, argv, monkeypatch)
    assert rc_j == rc_t == 0
    assert got["argv"][0] == "mpirun"
    assert got["argv"] == want["argv"]
    assert got["env"] == want["env"]


def test_cli_jsrun_command_matches_jax(monkeypatch, tmp_path):
    _lsf_env(monkeypatch, tmp_path)
    argv = ["--launcher", "jsrun", "python", "train.py"]
    _, want = _cli(jlaunch, jmpi, argv, monkeypatch)
    _, got = _cli(tlaunch, tmpi, argv, monkeypatch)

    def normal(cap):
        # the rendezvous servers listen on ports of their own, and the
        # shim is each package's
        argv = [a.replace("horovod_tpu_torch.", "horovod_tpu.")
                for a in cap["argv"]]
        argv = [a.split("=")[0] + "=<port>"
                if a.startswith("HVD_TPU_RENDEZVOUS_PORT=") else a
                for a in argv]
        env = dict(cap["env"], HVD_TPU_RENDEZVOUS_PORT="<port>")
        return argv, env
    assert normal(got) == normal(want)
    assert got["argv"][0] == "jsrun"
    assert "horovod_tpu_torch.runner.lsf" in got["argv"]


def test_routes_refuse_as_the_jax_launcher_does(monkeypatch):
    monkeypatch.setattr(tmpi, "_default_exec", _exec("", 127))
    monkeypatch.delenv("LSB_JOBID", raising=False)
    with pytest.raises(RuntimeError, match="could not find a usable"):
        tlaunch.run_commandline(["--mpi", "-np", "2", "cmd"])
    with pytest.raises(RuntimeError, match="requires an LSF job"):
        tlaunch.run_commandline(["--launcher", "jsrun", "cmd"])
    with pytest.raises(RuntimeError, match="elastic"):
        tlaunch.run_commandline(
            ["--mpi", "--min-np", "2", "-np", "2", "-H", "a:1,b:1",
             "--host-discovery-script", "/bin/true", "cmd"])
    seen = {}

    def fake_check_ssh(hostnames, timeout=10.0, port=None):
        seen.update(hosts=sorted(hostnames), port=port)
        return ["unreachable-host"]
    monkeypatch.setattr(tmpi, "_default_exec", _exec(OUTPUTS["Open MPI"]))
    monkeypatch.setattr(tlaunch, "check_ssh", fake_check_ssh)
    with pytest.raises(RuntimeError, match="ssh"):
        tlaunch.run_commandline(["--mpi", "-np", "2", "-H", "a:1,b:1",
                                 "--ssh-port", "2222", "cmd"])
    assert seen == {"hosts": ["a", "b"], "port": 2222}
    # auto on local hosts stays on the built-in launcher
    called = {}
    monkeypatch.setattr(tlaunch, "_run_static",
                        lambda args: called.setdefault("static", 0))
    assert tlaunch.run_commandline(["-np", "1", "cmd"]) == 0
    assert "static" in called


def test_run_use_mpi_spawns_run_task_through_mpirun(monkeypatch):
    """runner.run(use_mpi=True): the workers are the port's run_task,
    launched by mpirun with the rendezvous in their env; mpirun's
    aggregate exit code surfaces."""
    from horovod_tpu_torch.runner import run
    captured = {}

    def fake_mpi_run(settings, env, command, **kw):
        captured.update(settings=settings, env=env, command=command)
        return 5
    monkeypatch.setattr(tmpi, "mpi_run", fake_mpi_run)
    with pytest.raises(RuntimeError, match="mpirun exited with code 5"):
        run(len, args=([1],), np=2, use_mpi=True, env={"A": "1"})
    assert captured["command"][-1] == "horovod_tpu_torch.runner.run_task"
    assert captured["settings"].num_proc == 2
    assert captured["env"]["A"] == "1"
    assert captured["env"]["HVD_TPU_RENDEZVOUS_ADDR"] == "127.0.0.1"
    assert "HVD_TPU_COORDINATOR_ADDR" in captured["env"]
