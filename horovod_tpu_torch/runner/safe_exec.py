"""Process execution with whole-tree teardown.

Reference: horovod/runner/common/util/safe_shell_exec.py —
runs a command, forwards output line-tagged, and on an event signal kills the
entire process tree (the mechanism elastic teardown relies on).

Implementation is its own: ``start_new_session`` puts the child in a fresh
process group; termination signals the group (SIGTERM, grace period, SIGKILL).
"""

import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

GRACEFUL_TERMINATION_TIME_S = 5.0


def _forward_stream(stream, sink, prefix: str, on_line=None):
    for raw in iter(stream.readline, b""):
        line = raw.decode(errors="replace")
        if on_line:
            on_line(line)
        sink.write(f"{prefix}{line}" if prefix else line)
        sink.flush()
    stream.close()


def terminate_tree(proc: subprocess.Popen,
                   grace_s: float = GRACEFUL_TERMINATION_TIME_S):
    """SIGTERM the child's process group, then SIGKILL survivors."""
    if proc.poll() is not None:
        return
    try:
        pgid = os.getpgid(proc.pid)
    except ProcessLookupError:
        return
    try:
        os.killpg(pgid, signal.SIGTERM)
    except ProcessLookupError:
        return
    deadline = time.monotonic() + grace_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            return
        time.sleep(0.05)
    try:
        os.killpg(pgid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def safe_exec(command, env: Optional[dict] = None,
              stdout_prefix: str = "",
              stop_event: Optional[threading.Event] = None,
              stdout_file=None,
              on_line: Optional[Callable[[str], None]] = None,
              exit_info: Optional[dict] = None) -> int:
    """Run ``command`` (argv list or shell string); stream output with
    ``stdout_prefix`` per line; kill the whole tree if ``stop_event`` fires.
    Returns the exit code (negative signal number if signaled).

    ``exit_info``, when given, receives ``{"exit_time": <time.time()>}``
    captured the moment ``wait()`` observes the exit — BEFORE the output
    pipe drains. The elastic cascade-root heuristic orders failures by
    these timestamps; the post-drain time would let a root worker with a
    large unflushed buffer appear to die after a peer killed seconds
    later."""
    shell = isinstance(command, str)
    proc = subprocess.Popen(
        command, shell=shell, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True)

    sink = stdout_file if stdout_file is not None else sys.stdout
    fwd = threading.Thread(
        target=_forward_stream,
        args=(proc.stdout, sink, stdout_prefix, on_line), daemon=True)
    fwd.start()

    if stop_event is None:
        proc.wait()
    else:
        while True:
            try:
                proc.wait(timeout=0.1)
                break
            except subprocess.TimeoutExpired:
                if stop_event.is_set():
                    terminate_tree(proc)
                    proc.wait()
                    break
    if exit_info is not None:
        exit_info["exit_time"] = time.time()
    fwd.join(timeout=5)
    return proc.returncode
