"""The port's launcher: ``python -m horovod_tpu_torch.runner``.

Counterpart of ``horovod_tpu/runner/launch.py`` (``horovodrun-tpu``), with
its flags, env contract and static and elastic dispatch (reference:
runner/launch.py — arg groups that write env vars, launch.py:216-482; ssh
reachability precheck, launch.py:55-108; static vs elastic dispatch,
launch.py:484-708). It starts one worker per slot (``-np``, ``-H
host:slots``); a worker drives ``cuda:<local rank>``, so a host of N
cards takes N slots. ``--check-build`` probes torch and CUDA in a
killable subprocess.

The route is chosen as the JAX launcher chooses it (:func:`run_controller`):
``--mpi`` / ``--launcher mpi`` starts the workers through mpirun
(``runner/mpi_run.py``), ``--launcher jsrun`` through IBM jsrun resource
sets (``runner/lsf.py``), ``--gloo`` / ``--launcher local`` through the
built-in ssh/local launcher; ``--launcher auto`` (the default) picks jsrun
inside an LSF job with jsrun installed, then mpirun when one is installed
and the job spans remote hosts, then the built-in launcher. An explicit
route that cannot run raises; none falls back to another.
"""

import argparse
import os
import random
import shutil
import socket
import subprocess
import sys
from typing import List

from . import config_parser
from .exec_run import is_local_host, launch_workers
from .hosts import HostInfo, get_host_assignments, parse_hostfile, parse_hosts
from .rendezvous import RendezvousServer


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("0.0.0.0", 0))
        return s.getsockname()[1]


def check_ssh(hostnames: List[str], timeout: float = 10.0,
              port: int = None) -> List[str]:
    """Return the subset of non-local hosts unreachable over passwordless ssh,
    probed concurrently (reference launch.py:55-108
    _check_all_hosts_ssh_successful uses a thread per host)."""
    import concurrent.futures

    def probe(h: str) -> bool:
        try:
            port_args = ["-p", str(port)] if port else []
            r = subprocess.run(
                ["ssh", "-o", "BatchMode=yes", "-o", "StrictHostKeyChecking=no",
                 "-o", f"ConnectTimeout={int(timeout)}", *port_args, h, "true"],
                capture_output=True, timeout=timeout + 5)
            return r.returncode == 0
        except (subprocess.TimeoutExpired, FileNotFoundError):
            return False

    remote = [h for h in set(hostnames) if not is_local_host(h)]
    if not remote:
        return []
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(32, len(remote))) as ex:
        ok = list(ex.map(probe, remote))
    return [h for h, good in zip(remote, ok) if not good]


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.runner",
        description="Launch a horovod_tpu_torch distributed job.")
    p.add_argument("-v", "--version", action="store_true")
    p.add_argument("-cb", "--check-build", action="store_true",
                   dest="check_build",
                   help="Print the availability matrix (torch, CUDA, "
                        "the data plane's backends) and exit — reference "
                        "`horovodrun --check-build` (launch.py:110).")
    p.add_argument("-np", "--num-proc", type=int, dest="np", default=None,
                   help="Total number of worker processes, one per card "
                        "(default: the hosts' slots).")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--config-file", dest="config_file", default=None)

    g = p.add_argument_group("host arguments")
    g.add_argument("-H", "--hosts", dest="hosts", default=None,
                   help='Comma-separated host:slots list, e.g. "h1:1,h2:1".')
    g.add_argument("--hostfile", dest="hostfile", default=None)
    g.add_argument("--start-timeout", dest="start_timeout", type=float,
                   default=None)
    g.add_argument("--output-filename", dest="output_filename", default=None,
                   help="Directory for per-rank log files instead of "
                        "interleaved stdout.")
    g.add_argument("--launcher", choices=("auto", "local", "jsrun", "mpi"),
                   default="auto",
                   help="Worker spawn mechanism: 'local' = ssh/local exec, "
                        "'jsrun' = IBM LSF resource sets (reference "
                        "js_run.py), 'mpi' = mpirun (reference mpi_run.py), "
                        "'auto' picks jsrun inside an LSF job when jsrun is "
                        "installed, else mpirun when installed and the host "
                        "list spans remote hosts, else local.")
    g.add_argument("--mpi", action="store_true", dest="use_mpi",
                   help="Shorthand for --launcher mpi (reference --mpi).")
    g.add_argument("--gloo", action="store_true", dest="use_gloo",
                   help="Force the built-in ssh/local launcher. "
                        "Shorthand for --launcher local.")
    g.add_argument("--mpi-args", dest="mpi_args", default="",
                   help="Extra arguments appended to the mpirun command "
                        "line (reference --mpi-args).")
    g.add_argument("--ssh-port", dest="ssh_port", type=int, default=None,
                   help="SSH port for remote workers (mpirun rsh agent and "
                        "the ssh precheck).")
    g.add_argument("--network-interfaces", dest="nics", default=None,
                   help="Comma-separated NICs MPI's TCP transports may use "
                        "(reference --network-interfaces).")
    g.add_argument("--tcp", action="store_true", dest="tcp_flag",
                   help="Spectrum MPI only: force TCP transport.")
    g.add_argument("--binding-args", dest="binding_args", default="",
                   help="Override the per-implementation process binding "
                        "defaults, e.g. '-bind-to core'.")
    g.add_argument("--disable-ssh-check", action="store_true",
                   dest="disable_ssh_check")

    g = p.add_argument_group("tuning arguments")
    g.add_argument("--fusion-threshold-mb", type=int, default=None,
                   dest="fusion_threshold_mb")
    g.add_argument("--cycle-time-ms", type=float, default=None,
                   dest="cycle_time_ms")
    g.add_argument("--cache-capacity", type=int, default=None,
                   dest="cache_capacity")
    g.add_argument("--check-consistency", action="store_true",
                   dest="check_consistency",
                   help="Cross-process name/shape/dtype validation of eager "
                        "collectives (reference controller.cc:378-611).")

    g = p.add_argument_group("timeline arguments")
    g.add_argument("--timeline-filename", default=None,
                   dest="timeline_filename")
    g.add_argument("--timeline-mark-cycles", action="store_true",
                   dest="timeline_mark_cycles")

    g = p.add_argument_group("stall check arguments")
    g.add_argument("--no-stall-check", action="store_true",
                   dest="no_stall_check")
    g.add_argument("--stall-check-warning-time-seconds", type=float,
                   default=None, dest="stall_check_warning_time_seconds")
    g.add_argument("--stall-check-shutdown-time-seconds", type=float,
                   default=None, dest="stall_check_shutdown_time_seconds")

    g = p.add_argument_group("autotune arguments")
    g.add_argument("--autotune", action="store_true", dest="autotune")
    g.add_argument("--autotune-log-file", default=None,
                   dest="autotune_log_file")
    g.add_argument("--autotune-warmup-samples", type=int, default=None,
                   dest="autotune_warmup_samples")
    g.add_argument("--autotune-steps-per-sample", type=int, default=None,
                   dest="autotune_steps_per_sample")
    g.add_argument("--autotune-bayes-opt-max-samples", type=int, default=None,
                   dest="autotune_bayes_opt_max_samples")

    g = p.add_argument_group("elastic arguments")
    g.add_argument("--min-np", type=int, default=None, dest="min_np")
    g.add_argument("--max-np", type=int, default=None, dest="max_np")
    g.add_argument("--host-discovery-script", default=None,
                   dest="host_discovery_script")
    g.add_argument("--slots", type=int, default=None, dest="slots",
                   help="Slots per discovered host in elastic mode.")
    g.add_argument("--elastic-timeout", type=float, default=None,
                   dest="elastic_timeout")
    g.add_argument("--reset-limit", type=int, default=None, dest="reset_limit")
    g.add_argument("--rendezvous-dir", default=None, dest="rendezvous_dir",
                   help="Directory for the rendezvous KV store's durable "
                        "journal + snapshots (HVD_TPU_RENDEZVOUS_DIR). A "
                        "coordinator restarted against the same directory "
                        "replays its state and bumps the epoch so workers "
                        "re-register instead of wedging; unset keeps the "
                        "store memory-only.")
    g.add_argument("--heartbeat-interval", type=float, default=None,
                   dest="heartbeat_interval",
                   help="Seconds between worker liveness beats to the "
                        "rendezvous (HVD_TPU_HEARTBEAT_INTERVAL; 0 "
                        "disables the liveness layer).")
    g.add_argument("--heartbeat-timeout", type=float, default=None,
                   dest="heartbeat_timeout",
                   help="Seconds of heartbeat silence after which the "
                        "driver declares a worker dead and blacklists its "
                        "host (HVD_TPU_HEARTBEAT_TIMEOUT).")

    p.add_argument("--verbose-log-level", default=None,
                   dest="verbose_log_level")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="Command to run on every worker.")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    args = make_parser().parse_args(argv)
    if args.config_file:
        config_parser.apply_config_file(
            args, config_parser.load_config_file(args.config_file))
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    return args


def check_build() -> str:
    """Availability matrix (reference: launch.py:110 check_build): torch,
    its CUDA build and the cards it sees, and the data plane's backends.
    The device query runs in a killable subprocess, so a wedged driver
    cannot hang a diagnostics command."""
    from .. import __version__
    from ..ops import _build
    try:
        nvcc_path, nvcc = _build.nvcc(), "X"
    except RuntimeError:
        nvcc_path, nvcc = "not found", " "
    try:
        r = subprocess.run(
            [sys.executable, "-c",
             "import torch, torch.distributed as d; "
             "n = torch.cuda.device_count() if torch.cuda.is_available() "
             "else 0; print(torch.__version__, torch.version.cuda, n, "
             "'/'.join(torch.cuda.get_device_name(i) for i in range(n)) "
             "or '-', int(d.is_nccl_available()), "
             "int(d.is_gloo_available()), sep='|')"],
            capture_output=True, text=True, timeout=60)
        fields = r.stdout.strip().split("|") if r.returncode == 0 else []
    except subprocess.TimeoutExpired:
        fields = []
    if len(fields) == 6:
        version, cuda, count, names, nccl, gloo = fields
        torch_line = f"[X] PyTorch {version}"
        cuda_line = (f"[{'X' if cuda != 'None' else ' '}] CUDA {cuda}   "
                     f"cards: {count} ({names})")
        nccl, gloo = ("X" if nccl == "1" else " ",
                      "X" if gloo == "1" else " ")
    else:
        torch_line = "[ ] PyTorch (probe failed or timed out)"
        cuda_line = "[ ] CUDA unavailable"
        nccl = gloo = " "
    from .mpi_run import MISSING_IMPL, UNKNOWN_IMPL, get_mpi_implementation
    mpi_impl = get_mpi_implementation()
    mpi_mark = " " if mpi_impl in (MISSING_IMPL, UNKNOWN_IMPL) else "X"
    if mpi_impl == MISSING_IMPL:
        mpi_impl = "not installed"
    return f"""\
horovod_tpu_torch v{__version__}:

Available Frameworks:
    {torch_line}
    {cuda_line}

Data Plane (torch.distributed):
    [{nccl}] NCCL (the card)
    [{gloo}] gloo (the CPU)

Hand-written kernels (ops/csrc, built by nvcc on first use):
    [{nvcc}] nvcc {nvcc_path}

Launchers:
    [X] local / ssh
    [{mpi_mark}] mpirun ({mpi_impl})
    [{'X' if shutil.which('jsrun') else ' '}] LSF jsrun"""


def _resolve_hosts(args) -> List[HostInfo]:
    if args.hosts and args.hostfile:
        raise ValueError("specify either --hosts or --hostfile, not both")
    if args.hosts:
        return parse_hosts(args.hosts)
    if args.hostfile:
        return parse_hostfile(args.hostfile)
    from .lsf import LSFUtils
    if LSFUtils.using_lsf():
        # default hosts from the LSF allocation (reference launch.py uses
        # lsf.LSFUtils the same way when -H/-hostfile are absent)
        lsf_hosts = LSFUtils.get_compute_hosts()
        if lsf_hosts:
            return [HostInfo(h, n) for h, n in lsf_hosts]
    return [HostInfo("localhost", args.np or 1)]


def _run_jsrun(args) -> int:
    """Launch workers through IBM jsrun resource sets (reference:
    runner/js_run.py:146). The rendezvous lives on the batch host; each
    task's rank identity is translated from the PMIx env by the
    ``horovod_tpu_torch.runner.lsf`` shim each task execs through."""
    from .lsf import make_jsrun_command

    hosts = _resolve_hosts(args)
    np = args.np or sum(h.slots for h in hosts)
    rendezvous = RendezvousServer(verbose=args.verbose)
    rendezvous.start()
    slots, _size = get_host_assignments(hosts, np)
    rendezvous.init(slots)
    try:
        base_env = config_parser.set_env_from_args(dict(os.environ), args)
        # the TCP store is BOUND by rank 0, which jsrun places on the
        # first compute host, not on this batch host: a free_port() probe
        # here would test the wrong machine, so derive a stable port from
        # the LSF job id (rationale in stable_coordinator_port)
        from .mpi_run import stable_coordinator_port
        coord_host = slots[0].hostname if slots else socket.gethostname()
        seed = os.environ.get("LSB_JOBID", str(os.getpid()))
        coord_port = stable_coordinator_port(f"hvd-tpu-coord-{seed}")
        base_env["HVD_TPU_COORDINATOR_ADDR"] = f"{coord_host}:{coord_port}"
        base_env["HVD_TPU_SIZE"] = str(np)
        base_env["HVD_TPU_RENDEZVOUS_ADDR"] = socket.gethostname()
        base_env["HVD_TPU_RENDEZVOUS_PORT"] = str(rendezvous.port)
        cmd = make_jsrun_command(
            [sys.executable, "-m", "horovod_tpu_torch.runner.lsf", "--"]
            + list(args.command),
            base_env, num_proc=np, num_hosts=len(hosts))
        if args.verbose:
            sys.stderr.write("horovod_tpu_torch.runner: " + " ".join(cmd)
                             + "\n")
        proc = subprocess.run(cmd, env={**os.environ, **base_env})
        return proc.returncode
    finally:
        rendezvous.stop()


def _run_static(args) -> int:
    hosts = _resolve_hosts(args)
    np = args.np or sum(h.slots for h in hosts)
    if not args.disable_ssh_check:
        bad = check_ssh([h.hostname for h in hosts], port=args.ssh_port)
        if bad:
            raise RuntimeError(
                f"hosts not reachable over passwordless ssh: {sorted(bad)}")
    slots, size = get_host_assignments(hosts, np)

    rendezvous = RendezvousServer(verbose=args.verbose)
    rendezvous.start()
    rendezvous.init(slots)
    try:
        all_local = all(is_local_host(s.hostname) for s in slots)
        coord_host = "127.0.0.1" if all_local else slots[0].hostname
        coordinator_addr = f"{coord_host}:{free_port()}"
        base_env = config_parser.set_env_from_args(dict(os.environ), args)
        rdv_host = "127.0.0.1" if all_local else socket.gethostname()
        codes = launch_workers(
            args.command, slots, coordinator_addr,
            rendezvous_addr=rdv_host, rendezvous_port=rendezvous.port,
            output_dir=args.output_filename, base_env=base_env)
    finally:
        rendezvous.stop()
    failed = [(r, c) for r, c in enumerate(codes) if c != 0]
    if failed:
        sys.stderr.write(f"horovod_tpu_torch.runner: ranks failed: {failed}\n")
        # Peers of the first failing rank are torn down with SIGTERM/SIGKILL
        # (negative codes); report the genuine failure, not the artifact.
        primary = next((c for _r, c in failed if c > 0), failed[0][1])
        return primary if primary > 0 else 1
    return 0


def _run_mpi(args, impl=None) -> int:
    """Launch workers through mpirun (reference: runner/mpi_run.py). MPI
    is the process launcher only: each worker recovers its rank from the
    MPI-set env (``config.mpi_task_identity``) and joins the TCP store
    whose address is injected into the worker env here."""
    from .mpi_run import MPISettings, mpi_run

    hosts = _resolve_hosts(args)
    np = args.np or sum(h.slots for h in hosts)
    if not args.disable_ssh_check:
        # mpirun's rsh launcher needs the same passwordless ssh as the
        # built-in launcher; failing here in seconds beats a password
        # prompt buried inside ORTE
        bad = check_ssh([h.hostname for h in hosts], port=args.ssh_port)
        if bad:
            raise RuntimeError(
                f"hosts not reachable over passwordless ssh: {sorted(bad)}")
    hosts_str = ",".join(f"{h.hostname}:{h.slots}" for h in hosts)
    settings = MPISettings(
        num_proc=np,
        hosts=hosts_str,
        ssh_port=args.ssh_port,
        nics=tuple(s.strip() for s in args.nics.split(",") if s.strip())
        if args.nics else (),
        extra_mpi_args=args.mpi_args,
        binding_args=args.binding_args,
        output_filename=args.output_filename,
        tcp_flag=args.tcp_flag,
        verbose=args.verbose,
    )
    env = config_parser.set_env_from_args(dict(os.environ), args)
    return mpi_run(settings, env, list(args.command), impl=impl)


def run_controller(use_mpi: bool, mpi_fn, use_jsrun: bool, js_fn,
                   use_local: bool, local_fn, args=None) -> int:
    """Select the launch route (reference launch.py:629-659
    run_controller, with gloo's role played by the built-in ssh/local
    launcher). Explicit requests win; 'auto' prefers jsrun inside an LSF
    job, then mpirun when one is installed AND the job spans remote
    hosts (local single-host jobs gain nothing from MPI), then local/ssh.
    """
    from .lsf import LSFUtils, is_jsrun_installed
    from . import mpi_run as _mpi

    if use_local and (use_mpi or use_jsrun):
        # the reference horovodrun errors on --mpi --gloo; dropping an
        # explicit route silently is what this check prevents
        raise RuntimeError(
            "contradictory launcher selection: --gloo/--launcher local "
            "together with --mpi/--launcher mpi/jsrun")
    if use_local:
        return local_fn()
    if use_mpi:
        impl = _mpi.get_mpi_implementation()
        if impl in (_mpi.MISSING_IMPL, _mpi.UNKNOWN_IMPL):
            raise RuntimeError(_mpi.MPI_NOT_FOUND_MSG)
        return mpi_fn(impl)
    if use_jsrun:
        if not LSFUtils.using_lsf():
            raise RuntimeError(
                "--launcher jsrun requires an LSF job environment")
        return js_fn()
    # auto
    if LSFUtils.using_lsf() and is_jsrun_installed():
        return js_fn()
    if args is not None:
        hosts = _resolve_hosts(args)
        spans_remote = any(not is_local_host(h.hostname) for h in hosts)
        if spans_remote:
            impl = _mpi.get_mpi_implementation()
            if impl not in (_mpi.MISSING_IMPL, _mpi.UNKNOWN_IMPL):
                return mpi_fn(impl)
    return local_fn()


def _run_elastic(args) -> int:
    try:
        from ..elastic.launcher import launch_elastic
    except ImportError as e:
        raise RuntimeError(
            "elastic launch requires the horovod_tpu_torch.elastic "
            "package; "
            f"it failed to import: {e}") from e
    return launch_elastic(args)


def run_commandline(argv=None) -> int:
    """Entry point (reference launch.py:711 run_commandline → _run:686)."""
    args = parse_args(argv)
    if args.version:
        from .. import __version__
        print(__version__)
        return 0
    if args.check_build:
        print(check_build())
        return 0
    if not args.command:
        make_parser().print_usage()
        return 2
    random.seed()
    if args.host_discovery_script or (args.min_np is not None):
        if args.use_mpi or args.launcher in ("mpi", "jsrun"):
            # Same restriction as the reference (launch.py _run: elastic
            # is gloo-only); an explicit backend must not be dropped
            # silently.
            raise RuntimeError(
                "elastic training (--min-np / --host-discovery-script) "
                "uses the built-in launcher; it cannot be combined with "
                "--mpi or --launcher mpi/jsrun")
        return _run_elastic(args)
    return run_controller(
        use_mpi=args.use_mpi or args.launcher == "mpi",
        mpi_fn=lambda impl=None: _run_mpi(args, impl=impl),
        use_jsrun=args.launcher == "jsrun",
        js_fn=lambda: _run_jsrun(args),
        use_local=args.use_gloo or args.launcher == "local",
        local_fn=lambda: _run_static(args),
        args=args)


def main():
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
