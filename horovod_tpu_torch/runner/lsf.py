"""LSF cluster detection and host parsing (a copy of
``horovod_tpu/runner/lsf.py``, its imports re-pointed; the jsrun command
line is the JAX package's, bit for bit).

Reference: horovod/runner/util/lsf.py (LSFUtils) — reads
the LSF batch environment to recover the allocated hosts and slot counts
so ``horovodrun`` can default -np/-H on LSF clusters, and js_run.py builds
the ``jsrun`` launch command.
"""

import os
import shutil
from typing import Dict, List, Optional, Tuple


class LSFUtils:
    """Static queries over the LSF batch environment."""

    @staticmethod
    def using_lsf() -> bool:
        """True inside an LSF batch job (reference lsf.py using_lsf)."""
        return "LSB_JOBID" in os.environ

    @staticmethod
    def get_compute_hosts() -> List[Tuple[str, int]]:
        """[(hostname, slots)] for the job's compute hosts.

        Prefers ``LSB_DJOB_HOSTFILE`` (one hostname per line, repeated per
        slot); falls back to ``LSB_MCPU_HOSTS`` ("host1 n1 host2 n2 ...").
        The first host is LSF's batch/launch host and is excluded when
        other hosts exist (reference lsf.py get_compute_hosts semantics).
        """
        hostfile = os.environ.get("LSB_DJOB_HOSTFILE")
        counts: Dict[str, int] = {}
        order: List[str] = []
        if hostfile and os.path.exists(hostfile):
            with open(hostfile) as f:
                for line in f:
                    h = line.strip()
                    if not h:
                        continue
                    if h not in counts:
                        counts[h] = 0
                        order.append(h)
                    counts[h] += 1
        else:
            mcpu = os.environ.get("LSB_MCPU_HOSTS", "").split()
            for host, n in zip(mcpu[0::2], mcpu[1::2]):
                if host not in counts:
                    counts[host] = 0
                    order.append(host)
                counts[host] += int(n)
        if len(order) > 1:
            # drop the batch host (first entry) — it launches, not computes
            order = order[1:]
        return [(h, counts[h]) for h in order]

    @staticmethod
    def get_num_processes() -> int:
        return sum(n for _, n in LSFUtils.get_compute_hosts())

    @staticmethod
    def get_num_hosts() -> int:
        return len(LSFUtils.get_compute_hosts())

    @staticmethod
    def get_num_threads() -> int:
        """Hardware threads per slot from LSB_SUBCPUNUM or OMP defaults."""
        v = os.environ.get("LSB_SUBCPUNUM")
        try:
            return max(int(v), 1) if v else 1
        except ValueError:
            return 1


def is_jsrun_installed() -> bool:
    """jsrun exists on IBM Spectrum LSF + CSM systems
    (reference js_run.py is_jsrun_installed)."""
    return shutil.which("jsrun") is not None


def make_jsrun_command(command: List[str], env: Dict[str, str],
                       num_proc: Optional[int] = None,
                       num_hosts: Optional[int] = None,
                       cpu_per_rs: Optional[str] = None,
                       launcher_args: Optional[List[str]] = None
                       ) -> List[str]:
    """Build the ``jsrun`` command line launching ``num_proc`` workers
    (reference: js_run.py:146 js_run — resource sets + env forwarding).

    One resource set per worker (``--tasks_per_rs 1``) so each process
    gets its own slot, the layout the env contract (HVD_TPU_RANK from
    jsrun's PMIX rank) expects. ``HVD_TPU_*``/``HOROVOD_*``/selected
    runtime env vars are forwarded with ``-E``.
    """
    hosts = LSFUtils.get_compute_hosts() if LSFUtils.using_lsf() else []
    if num_proc is None:
        num_proc = sum(n for _, n in hosts) or 1
    if num_hosts is None:
        num_hosts = len(hosts) or 1
    if cpu_per_rs is None:
        cpu_per_rs = "ALL_CPUS" if num_proc == num_hosts else str(
            LSFUtils.get_num_threads())
    cmd = ["jsrun",
           "--nrs", str(num_proc),
           "--tasks_per_rs", "1",
           "--cpu_per_rs", cpu_per_rs,
           "--rs_per_host", str(max(num_proc // max(num_hosts, 1), 1)),
           "--launch_distribution", "packed"]
    # the JAX package's forwarding list, kept whole so one environment
    # gives both packages the same command line
    for k, v in sorted(env.items()):
        if k.startswith(("HVD_TPU_", "HOROVOD_")) or k in (
                "PATH", "PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS"):
            cmd += ["-E", f"{k}={v}"]
    if launcher_args:
        cmd += list(launcher_args)
    return cmd + list(command)


# -- worker-side rank shim ---------------------------------------------------

def jsrun_rank_env(environ) -> Dict[str, str]:
    """Map jsrun/PMIx per-task rank variables onto the HVD_TPU_* env
    contract (the role the reference's MPI basics play when launched by
    jsrun: rank discovery from the MPI environment, common/basics.py).
    The family table lives in config.mpi_task_identity — one mapping,
    shared with the env-detection fallback, so they cannot drift."""
    from ..config import mpi_task_identity
    return {f"HVD_TPU_{k}": str(v)
            for k, v in mpi_task_identity(environ).items()}


def _shim_main(argv: Optional[List[str]] = None) -> int:
    """``python -m horovod_tpu_torch.runner.lsf -- <command...>``: translate the
    jsrun task env into the HVD_TPU_* contract, then exec the worker."""
    import sys
    args = list(argv if argv is not None else sys.argv[1:])
    if args and args[0] == "--":
        args = args[1:]
    if not args:
        sys.stderr.write("usage: python -m horovod_tpu_torch.runner.lsf -- "
                         "<command...>\n")
        return 2
    os.environ.update(jsrun_rank_env(os.environ))
    os.execvp(args[0], args)
    return 1   # unreachable


if __name__ == "__main__":
    raise SystemExit(_shim_main())
