"""mpirun launch backend of ``python -m horovod_tpu_torch.runner`` (a copy of
``horovod_tpu/runner/mpi_run.py``, its imports re-pointed; the command lines
and the worker environment are the JAX package's, bit for bit).

Drives an MPI-scheduled cluster: ``--mpi -np 4 -H a:2,b:2 cmd`` assembles and
executes an ``mpirun`` command line that starts one worker per slot. Workers
then recover their rank identity from the MPI-set environment
(``OMPI_COMM_WORLD_RANK`` etc., see ``horovod_tpu_torch.config``) and join the
``torch.distributed`` rendezvous at ``HVD_TPU_COORDINATOR_ADDR`` — MPI is used
purely as a *process launcher*; the data plane stays NCCL (or gloo).

Reference behavior being matched (not copied): implementation detection via
``mpirun --version`` and per-implementation flag selection
(horovod/runner/mpi_run.py:57-121), command assembly with
``-H``, binding args, env passthrough and large-cluster workarounds
(mpi_run.py:140-210), and backend selection in ``run_controller``
(horovod/runner/launch.py:629-659).

Deliberate departures from the reference:

- The command is built as an argv **list** (no shell), so worker commands and
  env values never pass through ``/bin/sh`` quoting.
- Env passthrough is per-implementation: OpenMPI / Spectrum MPI take repeated
  ``-x KEY``; MPICH's Hydra launcher does not support ``-x`` and gets a single
  ``-genvlist K1,K2,...`` instead (the reference emits ``-x`` unconditionally,
  which MPICH rejects).
- No NCCL socket plumbing (``-x NCCL_SOCKET_IFNAME``): NIC selection only
  constrains MPI's own TCP transports; NCCL's environment passes through
  with the rest of the exportable variables.
"""

import copy
import dataclasses
import os
import re
import shlex
import subprocess
import sys
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .hosts import parse_hosts

OPENMPI_IMPL = "OpenMPI"
SPECTRUM_IMPL = "SpectrumMPI"
MPICH_IMPL = "MPICH"
UNKNOWN_IMPL = "Unknown"
MISSING_IMPL = "Missing"

#: Hosts at or above this count get the OpenMPI tree-spawn workaround the
#: reference applies for Summit-scale jobs (mpi_run.py:157-160).
LARGE_CLUSTER_THRESHOLD = 64

MPI_NOT_FOUND_MSG = (
    "horovodrun-tpu could not find a usable `mpirun`.\n"
    "Install Open MPI 4+, IBM Spectrum MPI, or MPICH, or drop --mpi to use\n"
    "the built-in ssh/local launcher."
)

#: Env vars that must never be forwarded into workers: launcher internals,
#: shell functions, and per-process identity that mpirun itself will set.
_NONEXPORTABLE = re.compile(
    r"^(BASH_FUNC_.*|OLDPWD|PWD|SHLVL|_|LS_COLORS|PS1|PROMPT_COMMAND|"
    r"OMPI_.*|PMIX_.*|PMI_.*|HYDRA_.*|SLURM_.*|MPI_LOCAL.*)$")


def is_exportable(name: str) -> bool:
    """Whether an env var may be forwarded to workers via -x/-genvlist."""
    return bool(name) and not _NONEXPORTABLE.match(name) and "=" not in name


ExecFn = Callable[[List[str]], Tuple[str, int]]


def _default_exec(cmd: List[str]) -> Tuple[str, int]:
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return (str(e), 127)
    return (r.stdout + r.stderr, r.returncode)


def get_mpi_implementation(exec_fn: Optional[ExecFn] = None) -> str:
    """Classify the installed MPI by running ``mpirun --version``.

    ``exec_fn`` is injectable for tests: it takes an argv list and returns
    ``(combined_output, exit_code)``.
    """
    exec_fn = exec_fn or _default_exec
    output, code = exec_fn(["mpirun", "--version"])
    if code != 0:
        return MISSING_IMPL
    if "Open MPI" in output or "OpenRTE" in output:
        return OPENMPI_IMPL
    if "IBM Spectrum MPI" in output:
        return SPECTRUM_IMPL
    if "MPICH" in output or "HYDRA" in output:
        return MPICH_IMPL
    return UNKNOWN_IMPL


def mpi_available(exec_fn: Optional[ExecFn] = None) -> bool:
    return get_mpi_implementation(exec_fn) in (
        OPENMPI_IMPL, SPECTRUM_IMPL, MPICH_IMPL)


@dataclasses.dataclass
class MPISettings:
    """Launch parameters for the mpirun backend (the subset of the CLI that
    shapes the command line)."""
    num_proc: int
    hosts: str                       # "h1:2,h2:2"
    ssh_port: Optional[int] = None
    nics: Sequence[str] = ()
    extra_mpi_args: str = ""         # raw user string, shlex-split
    binding_args: str = ""           # override default binding
    output_filename: Optional[str] = None
    tcp_flag: bool = False           # Spectrum MPI: force TCP
    verbose: bool = False


def _impl_flags(impl: str, settings: MPISettings) -> List[str]:
    """Per-implementation stability flags + process binding defaults."""
    if impl == OPENMPI_IMPL:
        flags = ["-mca", "pml", "ob1", "-mca", "btl", "^openib"]
        host_names = {h.hostname for h in parse_hosts(settings.hosts)}
        if len(host_names) >= LARGE_CLUSTER_THRESHOLD:
            flags += ["-mca", "plm_rsh_no_tree_spawn", "true",
                      "-mca", "plm_rsh_num_concurrent", str(len(host_names))]
        binding = ["-bind-to", "none", "-map-by", "slot"]
    elif impl == SPECTRUM_IMPL:
        flags = ["-tcp"] if settings.tcp_flag else []
        binding = ["-bind-to", "socket", "-map-by", "socket",
                   "-rank-by", "core"]
    else:  # MPICH / Unknown: stick to the portable core
        flags, binding = [], []
    if settings.binding_args:
        binding = shlex.split(settings.binding_args)
    return flags + binding


def _env_passthrough(impl: str, env: Dict[str, str]) -> List[str]:
    keys = sorted(k for k in env if is_exportable(k))
    if not keys:
        return []
    if impl == MPICH_IMPL:
        return ["-genvlist", ",".join(keys)]
    out: List[str] = []
    for k in keys:
        out += ["-x", k]
    return out


def mpi_run_command(settings: MPISettings, env: Dict[str, str],
                    command: Sequence[str],
                    impl: Optional[str] = None,
                    exec_fn: Optional[ExecFn] = None) -> List[str]:
    """Assemble the full mpirun argv.

    Raises ``RuntimeError`` when no MPI implementation is installed.
    """
    impl = impl or get_mpi_implementation(exec_fn)
    if impl in (MISSING_IMPL, UNKNOWN_IMPL):
        raise RuntimeError(MPI_NOT_FOUND_MSG)

    cmd: List[str] = ["mpirun"]
    if impl in (OPENMPI_IMPL, SPECTRUM_IMPL):
        cmd += ["--allow-run-as-root", "--tag-output"]
    else:
        cmd += ["-prepend-rank"]
    cmd += ["-np", str(settings.num_proc)]
    if impl == MPICH_IMPL:
        cmd += ["-hosts", settings.hosts]
    else:
        cmd += ["-H", settings.hosts]
    cmd += _impl_flags(impl, settings)
    mca_capable = impl in (OPENMPI_IMPL, SPECTRUM_IMPL)
    if settings.ssh_port:
        if mca_capable:
            cmd += ["-mca", "plm_rsh_args", f"-p {settings.ssh_port}"]
        else:
            sys.stderr.write(
                f"horovodrun-tpu: warning: --ssh-port has no {impl} "
                "mapping; configure the port in ~/.ssh/config instead\n")
    if settings.nics:
        if mca_capable:
            cmd += ["-mca", "btl_tcp_if_include", ",".join(settings.nics),
                    "-mca", "oob_tcp_if_include", ",".join(settings.nics)]
        else:
            if len(settings.nics) > 1:
                sys.stderr.write(
                    "horovodrun-tpu: warning: Hydra takes a single -iface; "
                    f"using {settings.nics[0]!r}, dropping "
                    f"{list(settings.nics[1:])}\n")
            cmd += ["-iface", settings.nics[0]]
    if settings.output_filename:
        if mca_capable:
            cmd += ["--output-filename", settings.output_filename]
        else:
            cmd += ["-outfile-pattern",
                    os.path.join(settings.output_filename, "rank-%r.out")]
    cmd += _env_passthrough(impl, env)
    if settings.extra_mpi_args:
        cmd += shlex.split(settings.extra_mpi_args)
    cmd += list(command)
    return cmd


def stable_coordinator_port(seed: str) -> int:
    """Deterministic coordinator port ABOVE Linux's default ephemeral
    outgoing range (32768-60999), so a random outgoing connection on the
    coordinator host cannot squat it — only another long-lived listener
    can. A stable crc32 of the job seed de-conflicts concurrent jobs
    sharing a node (builtin hash() is salted per interpreter and would
    not be stable). Shared by the jsrun and mpirun launch paths."""
    return 61000 + (zlib.crc32(seed.encode()) % 4500)


def coordinator_addr_for(hosts: str, seed: Optional[str] = None) -> str:
    """Deterministic coordinator (TCP store) address on the first MPI host.

    Rank 0 lands on the first slot of the first host, so the coordinator must
    bind there — a local free-port probe would test the wrong machine.
    """
    first = parse_hosts(hosts)[0].hostname
    seed = seed or os.environ.get("HVD_TPU_JOB_SEED", str(os.getpid()))
    return f"{first}:{stable_coordinator_port(f'hvd-tpu-mpi-coord-{seed}')}"


def mpi_run(settings: MPISettings, env: Dict[str, str],
            command: Sequence[str],
            exec_fn: Optional[ExecFn] = None,
            impl: Optional[str] = None,
            spawn_fn: Optional[Callable[[List[str], Dict[str, str]], int]]
            = None) -> int:
    """Launch ``command`` across the cluster under mpirun and wait.

    ``env`` is the worker environment contract; the coordinator address and
    world size are injected here so every rank can call
    ``horovod_tpu_torch.init()`` with no arguments. The size assignment is
    unconditional — ``-np`` must win over any stale ``HVD_TPU_SIZE``
    inherited from the driver's shell (same rule as the static and jsrun
    paths). ``spawn_fn`` is injectable for tests and receives
    ``(argv, launcher_env)``.
    """
    env = copy.copy(env)
    # Per-process identity must come from the MPI-set env on each worker
    # (explicit HVD_TPU_RANK would win over the family fallback and give
    # every rank the same identity), so strip any stale driver-shell values.
    for stale in ("RANK", "LOCAL_RANK", "LOCAL_SIZE",
                  "CROSS_RANK", "CROSS_SIZE"):
        env.pop(f"HVD_TPU_{stale}", None)
        env.pop(f"HOROVOD_{stale}", None)
    # ... and the raw scheduler identity families the DRIVER may be
    # running under (e.g. a SLURM batch step): locally spawned workers
    # inherit the mpirun process env, and a driver-side SLURM_PROCID=0
    # would out-rank the MPICH PMI family in config._MPI_FAMILIES, giving
    # every worker rank 0. mpirun sets its own family on each worker.
    from ..config import _MPI_FAMILIES
    for fam in _MPI_FAMILIES:
        for var in fam:
            env.pop(var, None)
    env["HVD_TPU_SIZE"] = str(settings.num_proc)
    env.setdefault("HVD_TPU_COORDINATOR_ADDR",
                   coordinator_addr_for(settings.hosts))
    impl = impl or get_mpi_implementation(exec_fn)
    argv = mpi_run_command(settings, env, command, impl=impl)
    if settings.verbose:
        sys.stderr.write("horovodrun-tpu: " + " ".join(argv) + "\n")
    # mpirun itself needs PATH/PYTHONPATH from the driver even when the
    # worker env contract omits them (reference mpi_run.py:196-203).
    launcher_env = {**env}
    for var in ("PATH", "PYTHONPATH"):
        if var not in launcher_env and var in os.environ:
            launcher_env[var] = os.environ[var]
    if spawn_fn is not None:
        return spawn_fn(argv, launcher_env)
    return subprocess.run(argv, env=launcher_env).returncode
