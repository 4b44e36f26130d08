"""Elastic launch entry point of the port's launcher
(``python -m horovod_tpu_torch.runner``; a copy of
``horovod_tpu/elastic/launcher.py`` but for the variables forwarded to a
remote worker and the coordinator it publishes, the TCP store of each
generation's rank 0).

Reference: horovod/runner/gloo_run.py launch_gloo_elastic
(:276-324) — start a rendezvous with live elastic handlers, build the
driver, and hand it a ``create_worker_fn`` that execs the user command on
the assigned host and kills the process tree when the driver's shutdown
event or the host's change event fires.
"""

import os
import random
import shutil
import socket
import tempfile
import threading
import time
import uuid
from typing import List, Optional

from ..runner import config_parser
from ..runner.exec_run import (FORWARD_ENV, is_local_host, slot_env,
                               _remote_command)
from ..runner.hosts import SlotInfo
from ..runner.launch import free_port
from ..runner.rendezvous import RendezvousServer
from ..runner.safe_exec import safe_exec
from .discovery import FixedHosts, HostDiscoveryScript
from .driver import ElasticDriver
from .rendezvous import attach_elastic_handlers


def _make_create_worker_fn(command, rendezvous, rendezvous_addr: str,
                           rendezvous_port: int, base_env: dict,
                           output_dir: Optional[str] = None):
    """Build the driver's create_worker_fn (reference gloo_run.py:
    _exec_command_fn + get_run_command)."""

    def create_worker(slot_info: SlotInfo, events: List[threading.Event]):
        # The driver publishes the generation's coordinator address to the
        # rendezvous before spawning, so reading it here is race-free.
        coord = rendezvous.get("coordinator", "addr")
        coordinator_addr = coord.decode() if coord else ""
        env = slot_env(slot_info, coordinator_addr,
                       rendezvous_addr=rendezvous_addr,
                       rendezvous_port=rendezvous_port,
                       elastic=True, base_env=base_env)
        if is_local_host(slot_info.hostname):
            cmd = list(command)
        else:
            cmd = _remote_command(command, env, slot_info.hostname,
                                  FORWARD_ENV)
        stop = threading.Event()

        def watch_events():
            while not stop.is_set():
                if any(e.is_set() for e in events):
                    stop.set()
                    return
                time.sleep(0.1)

        watcher = threading.Thread(target=watch_events, daemon=True)
        watcher.start()
        out_file = None
        exit_info: dict = {}
        try:
            if output_dir:
                os.makedirs(output_dir, exist_ok=True)
                out_file = open(
                    os.path.join(output_dir,
                                 f"{slot_info.hostname}.{slot_info.local_rank}"
                                 f".log"), "w", buffering=1)
            code = safe_exec(
                cmd, env=env,
                stdout_prefix=f"[{slot_info.rank}]<stdout> ",
                stop_event=stop, stdout_file=out_file, exit_info=exit_info)
        finally:
            stop.set()
            if out_file:
                out_file.close()
        # exit_time is captured at wait() — before the stdout drain — so
        # cascade-root ordering reflects actual death order.
        return code, exit_info.get("exit_time", time.time())

    return create_worker


def launch_elastic(args) -> int:
    """Run an elastic job from the launcher's parsed args
    (reference launch.py:574 _run_elastic)."""
    # These knobs steer the LAUNCHER process (journal on its KV store,
    # heartbeat monitor on its driver), not only workers, so CLI values
    # must land in this process's env before any Config() resolves them;
    # set_env_from_args below then propagates the same values to workers.
    for flag, var in (("rendezvous_dir", "HVD_TPU_RENDEZVOUS_DIR"),
                      ("heartbeat_interval", "HVD_TPU_HEARTBEAT_INTERVAL"),
                      ("heartbeat_timeout", "HVD_TPU_HEARTBEAT_TIMEOUT")):
        value = getattr(args, flag, None)
        if value is not None and value != "":
            os.environ[var] = str(value)
    if args.host_discovery_script:
        discovery = HostDiscoveryScript(args.host_discovery_script,
                                        default_slots=args.slots or 1)
    elif args.hosts:
        from ..runner.hosts import parse_hosts
        discovery = FixedHosts({h.hostname: h.slots
                                for h in parse_hosts(args.hosts)})
    else:
        raise ValueError(
            "elastic mode requires --host-discovery-script (or --hosts for "
            "a fixed set)")

    min_np = args.min_np or args.np or 1
    max_np = args.max_np

    rendezvous = RendezvousServer(verbose=args.verbose)
    # Before start(): on a hot-restart the store rebinds the previous
    # incarnation's persisted port immediately, and surviving workers'
    # beats must not be fsync-journaled as permanent state in the window
    # before attach_elastic_handlers runs.
    from .heartbeat import HEARTBEAT_SCOPE
    rendezvous.ephemeral_scopes.add(HEARTBEAT_SCOPE)
    rendezvous.start()

    driver = ElasticDriver(
        rendezvous, discovery, min_np=min_np, max_np=max_np,
        timeout=args.elastic_timeout, reset_limit=args.reset_limit)
    attach_elastic_handlers(rendezvous, driver)
    if rendezvous.replayed_entries:
        # Coordinator hot-restart: the KV store came back from its journal
        # (HVD_TPU_RENDEZVOUS_DIR), so this launcher is a restart, not a
        # fresh job — re-seed the driver's worker registry and blacklist
        # from the restored state instead of starting blind.
        driver.restore_from_rendezvous()

    # The elastic membership counters (driver.py) live in THIS process,
    # not in any worker, so the launcher serves its own scrape endpoint
    # when the metrics port is configured. Workers bind the same port on
    # their own hosts; a same-host collision just logs and continues.
    metrics_server = None
    try:
        metrics_port = int(os.environ.get(
            "HVD_TPU_METRICS_PORT",
            os.environ.get("HOROVOD_METRICS_PORT", "0")) or 0)
    except ValueError:
        metrics_port = 0
    if metrics_port > 0:
        from .. import metrics as _metrics
        try:
            metrics_server = _metrics.start_http_server(metrics_port)
        except (OSError, OverflowError, ValueError) as e:
            import logging
            logging.getLogger("horovod_tpu_torch.elastic").warning(
                "elastic launcher: could not bind metrics endpoint on "
                "port %d: %s", metrics_port, e)

    def publish_coordinator(assignment_list):
        # New generation -> a new TCP store, which the new rank 0's
        # basics.init() listens on (its host, a port free there).
        head = assignment_list[0]
        host = "127.0.0.1" if is_local_host(head.hostname) \
            else head.hostname
        port = random.randint(29500, 59999) if not is_local_host(
            head.hostname) else free_port()
        rendezvous.put("coordinator", "addr", f"{host}:{port}".encode())

    driver.set_assignments_callback(publish_coordinator)

    base_env = config_parser.set_env_from_args(dict(os.environ), args)
    # Job-scoped durable-commit directory: workers persist every commit()
    # here so a slot respawned after a hard kill restores its last commit
    # (see elastic/run.py STATE_DIR_ENV). A user-provided
    # HVD_TPU_ELASTIC_STATE_DIR is honored (point it at shared storage on
    # multi-host clusters — a launcher-local mkdtemp path does not exist on
    # remote hosts, where workers then mkdir it themselves per-host and
    # recovery degrades to the rank-0 broadcast). Only the dir this
    # launcher created is cleaned up afterwards.
    state_dir = base_env.get("HVD_TPU_ELASTIC_STATE_DIR")
    own_state_dir = None
    if not state_dir:
        state_dir = own_state_dir = tempfile.mkdtemp(
            prefix="hvd_tpu_elastic_job_")
        base_env["HVD_TPU_ELASTIC_STATE_DIR"] = state_dir
    # Job-unique token namespacing the commit files, so a reused shared
    # state dir never resurrects a previous job's state.
    base_env.setdefault("HVD_TPU_ELASTIC_JOB_ID",
                        uuid.uuid4().hex[:12])
    rdv_host = socket.gethostname()
    try:
        socket.gethostbyname(rdv_host)
    except OSError:
        rdv_host = "127.0.0.1"

    create_worker_fn = _make_create_worker_fn(
        args.command, rendezvous, rdv_host, rendezvous.port, base_env,
        output_dir=args.output_filename)

    # First generation targets the requested -np (reference: launch_gloo_
    # elastic starts at settings.num_proc); later resumes shrink/grow within
    # [min_np, max_np].
    try:
        driver.start(args.np or min_np, create_worker_fn)
        results = driver.get_results()
        driver.stop()
    except TimeoutError as e:
        # wait_for_available_slots gave up: not enough discoverable slots
        # (reference scenario: min-np timeout). Surface the reason cleanly
        # instead of a traceback.
        driver.stop()
        import sys
        sys.stderr.write(f"horovod_tpu_torch.runner: {e}\n")
        return 1
    finally:
        if metrics_server is not None:
            from .. import metrics as _metrics
            _metrics.stop_http_server(metrics_server)
        if own_state_dir:
            shutil.rmtree(own_state_dir, ignore_errors=True)

    if results.error_message:
        import sys
        sys.stderr.write(results.error_message + "\n")
        return 1
    for name, (code, _ts) in results.worker_results.items():
        if code != 0:
            import sys
            sys.stderr.write(
                f"horovod_tpu_torch.runner: elastic worker {name} exited with "
                f"code {code}\n")
            return code
    return 0
