"""Per-slot environment construction and threaded local/ssh execution.

Counterpart of ``horovod_tpu/runner/exec_run.py`` (reference:
runner/gloo_run.py — builds per-slot env, gloo_run.py:64-201, and executes
each slot via threaded ssh with ``safe_shell_exec``, gloo_run.py:112-181,
215-261).

The env contract is the JAX package's, byte for byte (:func:`slot_env`):
HVD_TPU_RANK/SIZE/... (HOROVOD_* aliases also resolved by
``horovod_tpu_torch.config``) plus HVD_TPU_COORDINATOR_ADDR, the host:port
of the TCP store the rank-0 worker's ``basics.init()`` listens on, and
HVD_TPU_RENDEZVOUS_ADDR/PORT pointing at the launcher's KV store. A worker
drives ``cuda:<HVD_TPU_LOCAL_RANK>``, so a host of N cards takes N slots.
Over ssh the launcher forwards ``CUDA_VISIBLE_DEVICES`` where the JAX
package forwards ``JAX_PLATFORMS`` and ``XLA_FLAGS``.
"""

import os
import re
import shlex
import socket
import threading
from typing import Dict, List, Optional, Sequence

from .hosts import SlotInfo
from .safe_exec import safe_exec

SSH_COMMAND_PREFIX = ["ssh", "-o", "PasswordAuthentication=no",
                      "-o", "StrictHostKeyChecking=no",
                      "-o", "BatchMode=yes"]

_LOCAL_NAMES = {"localhost", "127.0.0.1", "::1"}

#: variables a remote worker's ``env`` gets beside the contract's
FORWARD_ENV = ("PATH", "PYTHONPATH", "CUDA_VISIBLE_DEVICES")


def is_local_host(hostname: str) -> bool:
    # The whole 127/8 block is loopback, not just 127.0.0.1 — multi-"host"
    # single-machine tests use 127.0.0.2 etc. as distinct host identities.
    # IP LITERALS only: "127" is a legal DNS label, so a name like
    # 127.eu.example.com must still be treated as remote.
    if hostname in _LOCAL_NAMES or re.fullmatch(
            r"127\.\d{1,3}\.\d{1,3}\.\d{1,3}", hostname):
        return True
    try:
        return hostname in (socket.gethostname(), socket.getfqdn())
    except OSError:
        return False


def slot_env(slot: SlotInfo, coordinator_addr: str,
             rendezvous_addr: str = "", rendezvous_port: int = 0,
             elastic: bool = False,
             base_env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The env-var contract each worker process receives
    (reference gloo_run.py:64-201)."""
    env = dict(base_env if base_env is not None else os.environ)
    env.update({
        "HVD_TPU_RANK": str(slot.rank),
        "HVD_TPU_SIZE": str(slot.size),
        "HVD_TPU_LOCAL_RANK": str(slot.local_rank),
        "HVD_TPU_LOCAL_SIZE": str(slot.local_size),
        "HVD_TPU_CROSS_RANK": str(slot.cross_rank),
        "HVD_TPU_CROSS_SIZE": str(slot.cross_size),
        "HVD_TPU_HOSTNAME": slot.hostname,
        "HVD_TPU_COORDINATOR_ADDR": coordinator_addr,
    })
    if rendezvous_addr:
        env["HVD_TPU_RENDEZVOUS_ADDR"] = rendezvous_addr
        env["HVD_TPU_RENDEZVOUS_PORT"] = str(rendezvous_port)
    if elastic:
        env["HVD_TPU_ELASTIC"] = "1"
    return env


def _remote_command(command: Sequence[str], env: Dict[str, str],
                    hostname: str, forward_keys: Sequence[str]) -> List[str]:
    """Wrap a command for ssh execution, exporting the worker env contract
    plus ``forward_keys`` (reference gloo_run.py exports via `env` on the
    remote shell)."""
    exports = []
    for k, v in env.items():
        if k.startswith(("HVD_TPU_", "HOROVOD_")) or k in forward_keys:
            exports.append(f"{k}={shlex.quote(v)}")
    remote = "env " + " ".join(exports) + " " + " ".join(
        shlex.quote(c) for c in command)
    return SSH_COMMAND_PREFIX + [hostname, remote]


def launch_workers(command: Sequence[str], slots: Sequence[SlotInfo],
                   coordinator_addr: str,
                   rendezvous_addr: str = "", rendezvous_port: int = 0,
                   elastic: bool = False,
                   output_dir: Optional[str] = None,
                   prefix_output: bool = True,
                   forward_env: Sequence[str] = FORWARD_ENV,
                   base_env: Optional[Dict[str, str]] = None) -> List[int]:
    """Launch one worker per slot (threads), kill all on first failure,
    return exit codes ordered by rank (reference gloo_run.py:133-181)."""
    stop = threading.Event()
    codes: List[Optional[int]] = [None] * len(slots)

    def _one(i: int, slot: SlotInfo):
        env = slot_env(slot, coordinator_addr, rendezvous_addr,
                       rendezvous_port, elastic, base_env)
        if is_local_host(slot.hostname):
            cmd = list(command)
        else:
            cmd = _remote_command(command, env, slot.hostname, forward_env)
        out_file = None
        try:
            if output_dir:
                os.makedirs(output_dir, exist_ok=True)
                out_file = open(
                    os.path.join(output_dir, f"rank.{slot.rank}.log"),
                    "w", buffering=1)
            prefix = f"[{slot.rank}]<stdout> " if prefix_output else ""
            codes[i] = safe_exec(cmd, env=env, stdout_prefix=prefix,
                                 stop_event=stop, stdout_file=out_file)
        finally:
            if out_file:
                out_file.close()
        if codes[i] != 0:
            stop.set()

    threads = [threading.Thread(target=_one, args=(i, s), daemon=True)
               for i, s in enumerate(slots)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [c if c is not None else -1 for c in codes]
