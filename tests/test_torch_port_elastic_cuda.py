"""The launcher and elastic training on NVIDIA GPUs, NCCL, one card a slot.

Marked ``cuda``; every test skips without a GPU, and the drills without 4:

* ``test_elastic_launch_one_card``: ``python -m horovod_tpu_torch.runner
  -np 1 --min-np 1 --host-discovery-script`` (a script printing
  localhost:1) starts ``chip_smoke.py --elastic-worker elastic``: the
  full-width default model, 3 steps under hvd.elastic.run, a durable
  TorchState commit every step (chip_smoke.py's elastic phase, part b);
* ``test_failed_nccl_world_is_aborted_then_formed_again``: a world whose
  wire call failed is aborted at shutdown and formed again in-process;
* ``test_membership_drill_four_cards``: one host whose discovered slots go
  4 -> 2 -> 4 while the full-width model trains under hvd.elastic.run,
  data-parallel over NCCL, a commit every step. Ranks 2 and 3 leave at the
  shrink (no slot at their reset: they exit 0), ranks 0 and 1 re-form
  NCCL in-process at size 2, and new workers join at the growth. Every
  rank must end with the same parameters; prints the seconds from each
  membership change to the first step of the new generation;
* ``test_hard_kill_stops_the_job``: rank 3 of 4 exits hard after its
  second commit. The survivors wait in NCCL until the wire-call bound
  (``basics.wire_timeout``, 60 s under an elastic launch) and the
  watchdog ends them; every slot of the only host has failed, so the
  driver stops the job with its message instead of hanging. Prints the
  seconds from the kill to the launcher's exit.

From the root of a checkout (4 cards for the drills):

    python -m pytest --noconftest -m cuda tests/test_torch_port_elastic_cuda.py -q -s

This file is also the drills' worker: ``python
tests/test_torch_port_elastic_cuda.py drill <dir>`` under the launcher.
"""

import json
import os
import re
import stat
import subprocess
import sys
import tempfile
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.abspath(__file__)
#: steps a generation must take before the harness changes membership
STEPS_PER_GENERATION = 2
#: each launch's limit, by test (the one-card launch takes about 50 s, the
#: kill about 60 s past its start: the wire-call bound)
LAUNCH_SECONDS = {"one_card": 300, "drill": 600, "kill": 300}


def _drill_worker(work: str) -> None:
    sys.path.insert(0, ROOT)
    import torch
    import horovod_tpu_torch as hvd
    from chip_smoke import _train_bundle
    from horovod_tpu_torch.models import TransformerConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    hvd.init()
    # no collective outside hvd.elastic.run: a worker that joins a running
    # job issues the same ones as the survivors, which re-enter at sync()
    bundle, tokens, targets = _train_bundle(torch, TransformerConfig(),
                                            broadcast=False)
    state = hvd.elastic.TorchState(bundle.model, bundle.optimizer, step=0)
    kill_at = int(os.environ.get("DRILL_KILL_RANK3_AT", "0"))
    finish = os.path.join(work, "finish")

    def log(msg):
        with open(os.path.join(work, "events.log"), "a") as f:
            f.write(f"{msg} t={time.time():.3f}\n")

    @hvd.elastic.run
    def train(state):
        while True:
            done = hvd.allreduce(
                torch.tensor([float(os.path.exists(finish))],
                             device=hvd.device()), op=hvd.Max,
                name="finish_check")
            if done.item() > 0:
                return
            loss = bundle.step(tokens, targets).item()
            state.step += 1
            state.commit()
            save_s, durable_s = state.last_commit_seconds
            log(f"step={state.step} rank={hvd.rank()} size={hvd.size()} "
                f"loss={loss:.6f} save_ms={1e3 * save_s:.1f} "
                f"durable_ms={1e3 * durable_s:.1f}")
            if kill_at and hvd.rank() == 3 and state.step == kill_at:
                log("killed rank=3")
                os._exit(17)

    train(state)
    total = sum(float(p.double().sum()) for p in bundle.model.parameters())
    log(f"done rank={hvd.rank()} size={hvd.size()} step={state.step} "
        f"param_sum={total!r}")
    hvd.shutdown()


if __name__ == "__main__" and sys.argv[1:2] == ["drill"]:
    _drill_worker(sys.argv[2])
    sys.exit(0)


pytestmark = pytest.mark.cuda


def _cards(n):
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        pytest.skip(f"needs {n} NVIDIA GPUs, found {have}")


def _discovery(work, hosts):
    hosts_file = os.path.join(work, "hosts.txt")
    with open(hosts_file, "w") as f:
        f.write(hosts + "\n")
    script = os.path.join(work, "discover.sh")
    with open(script, "w") as f:
        f.write(f"#!/bin/sh\ncat {hosts_file}\n")
    os.chmod(script, os.stat(script).st_mode | stat.S_IEXEC)
    return hosts_file, script


def _start(args, env=None):
    full = dict(os.environ, **(env or {}))
    full["PYTHONPATH"] = ROOT + os.pathsep + full.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", *args], cwd=ROOT,
        env=full, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)


def _finish(proc, token, limit):
    from chip_smoke import kill_matching
    try:
        out, _ = proc.communicate(timeout=LAUNCH_SECONDS[limit])
    except subprocess.TimeoutExpired:
        proc.kill()
        kill_matching(token)
        out = proc.communicate()[0]
        raise AssertionError("launch timed out:\n" + out[-8000:])
    return proc.returncode, out


def _events(work):
    path = os.path.join(work, "events.log")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def _t(event):
    return float(re.search(r" t=([0-9.]+)$", event).group(1))


def _wait(proc, work, pred, token, timeout=300):
    deadline = time.time() + timeout
    while time.time() < deadline:
        hits = [e for e in _events(work) if pred(e)]
        if hits:
            return hits
        if proc.poll() is not None:
            break
        time.sleep(0.5)
    from chip_smoke import kill_matching
    proc.kill()
    kill_matching(token)
    raise AssertionError(f"no such event: {_events(work)[-20:]}\n"
                         + proc.communicate()[0][-8000:])


def test_elastic_launch_one_card():
    _cards(1)
    with tempfile.TemporaryDirectory() as work:
        _, script = _discovery(work, "localhost:1")
        out = os.path.join(work, "elastic.json")
        proc = _start(["-np", "1", "--min-np", "1", "--host-discovery-script",
                       script, "--", sys.executable,
                       os.path.join(ROOT, "chip_smoke.py"),
                       "--elastic-worker", "elastic", out])
        code, log = _finish(proc, out, "one_card")
        assert code == 0, log[-8000:]
        res = json.load(open(out))
        print(json.dumps({"test": "elastic_launch_one_card", **res}))
        assert res["elastic_env"] == "1" and res["backend"] == "nccl"
        assert len(res["commit_save_ms"]) == 3
        assert res["flash_launches"] == 12 * 3
        assert all(x == x and x < 20 for x in res["losses"])


def test_failed_nccl_world_is_aborted_then_formed_again():
    """A world whose wire call failed (basics.mark_failed) is aborted at
    shutdown, not destroyed, on NCCL; init() then forms a new one on the
    same card, in the same process (the reset after HorovodInternalError
    takes this path)."""
    _cards(1)
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import basics
    hvd.init()
    try:
        first = basics.world()
        x = torch.arange(4.0, device=hvd.device())
        assert torch.equal(hvd.allreduce(x, op=hvd.Sum), x)
        basics.mark_failed()
        hvd.shutdown()
        hvd.init()
        assert basics.world() is not first
        assert basics.world().backend == "nccl" and not basics.world().failed
        assert torch.equal(hvd.allreduce(x, op=hvd.Sum), x)
    finally:
        hvd.shutdown()


def test_membership_drill_four_cards():
    _cards(4)
    with tempfile.TemporaryDirectory() as work:
        hosts_file, script = _discovery(work, "localhost:4")
        proc = _start(["-np", "4", "--min-np", "2", "--max-np", "4",
                       "--host-discovery-script", script, "--",
                       sys.executable, HERE, "drill", work])
        changes = []

        def steps_at(size, after):
            return lambda e: (re.match(rf"step=\d+ rank=0 size={size} ", e)
                              and _t(e) > after)

        def wait_steps(size, after):
            _wait(proc, work, lambda _: len(
                [e for e in _events(work) if steps_at(size, after)(e)])
                >= STEPS_PER_GENERATION, work)
        wait_steps(4, 0)
        for size in (2, 4):
            changes.append(time.time())
            with open(hosts_file, "w") as f:
                f.write(f"localhost:{size}\n")
            wait_steps(size, changes[-1])
        open(os.path.join(work, "finish"), "w").close()
        code, log = _finish(proc, work, "drill")
        evs = _events(work)
        assert code == 0, log[-8000:] + "\n".join(evs[-30:])
        done = [e for e in evs if e.startswith("done ")]
        sums = {re.search(r"param_sum=(\S+)", e).group(1) for e in done}
        sizes = [int(re.search(r"size=(\d+)", e).group(1)) for e in done]
        to_first_step = []
        for i, size in enumerate((2, 4)):
            first = min(_t(e) for e in evs if steps_at(size, changes[i])(e))
            to_first_step.append(first - changes[i])
        commits = [(float(re.search(r"save_ms=(\S+)", e).group(1)),
                    float(re.search(r"durable_ms=(\S+)", e).group(1)))
                   for e in evs if e.startswith("step=")]
        print(json.dumps({
            "test": "membership_drill_four_cards",
            "change_to_first_step_s": {"4->2": to_first_step[0],
                                       "2->4": to_first_step[1]},
            "final_sizes": sizes, "param_sums_equal": len(sums) == 1,
            "commit_save_ms": [c[0] for c in commits],
            "commit_durable_ms": [c[1] for c in commits],
            "events": evs}))
        assert sizes == [4, 4, 4, 4] and len(sums) == 1, evs[-30:]
        sizes_seen = [int(m.group(1)) for e in evs
                      for m in [re.match(r"step=\d+ rank=0 size=(\d+)", e)]
                      if m]
        assert 2 in sizes_seen and sizes_seen[-1] == 4


def test_hard_kill_stops_the_job():
    _cards(4)
    with tempfile.TemporaryDirectory() as work:
        _, script = _discovery(work, "localhost:4")
        proc = _start(["-np", "4", "--min-np", "4",
                       "--host-discovery-script", script, "--",
                       sys.executable, HERE, "drill", work],
                      env={"DRILL_KILL_RANK3_AT": "2"})
        code, log = _finish(proc, work, "kill")
        end = time.time()
        evs = _events(work)
        kill = [e for e in evs if e.startswith("killed rank=3")]
        assert kill, log[-8000:]
        # the survivors' watchdog lines carry glog's local time
        # ("[E1017 08:02:24.233658 ...] ... Watchdog caught ... timeout")
        year = time.localtime(_t(kill[0])).tm_year
        errors = sorted(time.mktime(time.strptime(
            f"{year}{m.group(1)} {m.group(2)}", "%Y%m%d %H:%M:%S"))
            + float("0." + m.group(3)) for m in re.finditer(
                r"\[E(\d{4}) (\d\d:\d\d:\d\d)\.(\d+) [^\n]*Watchdog caught",
                log))
        print(json.dumps({"test": "hard_kill_stops_the_job",
                          "exit_code": code,
                          "wire_timeout_s": 60.0,
                          "kill_to_first_survivor_error_s":
                              errors[0] - _t(kill[0]) if errors else None,
                          "survivor_errors": len(errors),
                          "kill_to_launcher_exit_s": end - _t(kill[0]),
                          "tail": log[-3000:]}))
        assert code != 0
        assert "no healthy host remains" in log, log[-8000:]
