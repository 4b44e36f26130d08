"""Elastic end-to-end launches of the port on localhost, on gloo.

The seven scenarios of ``tests/test_elastic_e2e.py`` (rank failure, scale
up, the all-ranks cascade, all hosts blacklisted, the min-np timeout, the
reset limit, hosts added and removed together) run through the port's
launcher, ``python -m horovod_tpu_torch.runner``, with a port worker on
the CPU (``device="cpu"``): this file's own ``__main__``. "Hosts" are
localhost aliases (localhost, 127.0.0.1, 127.0.0.2) with one slot each, so
the driver's multi-host logic (blacklisting, stable assignment) runs on one
machine. Where the JAX worker re-execs into a new generation, the port's
resets in-process (``elastic/run.py``); the driver's decisions are the
same.

One more scenario: a run with a kill and a scale-up ends with the
parameters of an uninterrupted run on the same per-epoch data, exactly
(fp32).

The worker trains a small linear model with SGD and momentum through
:class:`TorchState`. Each epoch's global batch is drawn from a seed of the
epoch and cut into two fixed chunks; chunk ``c`` belongs to rank ``c %
size``, each rank sums its chunks' gradients in chunk order, and the ranks
sum theirs (``op=Sum``). At sizes 1 and 2 that is one fp32 addition of the
two chunks' gradients either way, and IEEE addition commutes, so the
trajectory is bit-identical whatever the membership.

Worker env (``ELASTIC_TEST_*``, as ``tests/elastic_train_worker.py``):
DIR (shared scratch), EPOCHS, KILL_RANK / KILL_EPOCH or KILL_SCHEDULE
("rank:epoch,..."), WAIT_FOR_SIZE (train until this size is seen, then
two more epochs), SHRINK_THEN_GROW (train until size 1 and then size 2
were seen, then two more epochs), RUN_UNTIL_FILE, EPOCH_SLEEP.
"""

import os
import re
import stat
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
IN_FEATURES, OUT_FEATURES, BATCH, CHUNKS = 16, 4, 8, 2
LR, MOMENTUM = 0.05, 0.9


# ---------------------------------------------------------------------------
# the training function, shared by the worker and the uninterrupted replay
# ---------------------------------------------------------------------------

def epoch_batch(epoch: int):
    rng = np.random.RandomState(1000 + epoch)
    x = rng.standard_normal((BATCH, IN_FEATURES)).astype(np.float32)
    y = rng.standard_normal((BATCH, OUT_FEATURES)).astype(np.float32)
    return x, y


def make_model():
    import torch
    torch.manual_seed(0)
    model = torch.nn.Linear(IN_FEATURES, OUT_FEATURES)
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=MOMENTUM)
    return model, opt


def chunk_grads(model, epoch: int, chunks):
    """The sum, in chunk order, of the gradients of ``chunks`` of the
    epoch's batch (each chunk's loss a mean over the whole batch)."""
    import torch
    x, y = epoch_batch(epoch)
    rows = BATCH // CHUNKS
    total = None
    for c in chunks:
        xc = torch.from_numpy(x[c * rows:(c + 1) * rows])
        yc = torch.from_numpy(y[c * rows:(c + 1) * rows])
        loss = ((model(xc) - yc) ** 2).sum() / BATCH
        g = torch.autograd.grad(loss, list(model.parameters()))
        total = g if total is None else [a + b for a, b in zip(total, g)]
    return total


def apply_grads(model, opt, grads) -> None:
    for p, g in zip(model.parameters(), grads):
        p.grad = g.clone()
    opt.step()


def replay(epochs: int):
    """The uninterrupted run: ``epochs`` epochs on one process."""
    model, opt = make_model()
    for epoch in range(epochs):
        apply_grads(model, opt, chunk_grads(model, epoch, range(CHUNKS)))
    return [p.detach().numpy().copy() for p in model.parameters()]


# ---------------------------------------------------------------------------
# the worker (``python tests/test_torch_port_elastic_e2e.py worker``)
# ---------------------------------------------------------------------------

def _kill_schedule():
    sched = []
    for part in os.environ.get("ELASTIC_TEST_KILL_SCHEDULE", "").split(","):
        if part.strip():
            r, _, e = part.strip().partition(":")
            sched.append((int(r), int(e)))
    if os.environ.get("ELASTIC_TEST_KILL_RANK") is not None:
        sched.append((int(os.environ["ELASTIC_TEST_KILL_RANK"]),
                      int(os.environ.get("ELASTIC_TEST_KILL_EPOCH", "-1"))))
    return sched


def worker_main() -> None:
    sys.path.insert(0, REPO)
    import torch
    import horovod_tpu_torch as hvd

    test_dir = os.environ["ELASTIC_TEST_DIR"]
    epochs = int(os.environ.get("ELASTIC_TEST_EPOCHS", "4"))
    epoch_sleep = float(os.environ.get("ELASTIC_TEST_EPOCH_SLEEP", "0.3"))
    wait_for_size = int(os.environ.get("ELASTIC_TEST_WAIT_FOR_SIZE", "0"))
    shrink_grow = os.environ.get("ELASTIC_TEST_SHRINK_THEN_GROW") == "1"
    run_until = os.environ.get("ELASTIC_TEST_RUN_UNTIL_FILE", "")
    max_epochs = int(os.environ.get("ELASTIC_TEST_MAX_EPOCHS", "200"))
    kills = _kill_schedule()
    host = os.environ.get("HVD_TPU_HOSTNAME", "?")

    def log_event(msg: str) -> None:
        with open(os.path.join(test_dir, "events.log"), "a") as f:
            f.write(f"{msg} t={time.time():.3f}\n")

    def maybe_kill(epoch: int) -> None:
        for rank, kill_epoch in kills:
            if hvd.rank() != rank or epoch != kill_epoch:
                continue
            marker = os.path.join(test_dir, f"killed.{rank}.{kill_epoch}")
            if os.path.exists(marker):
                continue
            open(marker, "w").close()
            log_event(f"killed rank={rank} epoch={epoch}")
            sys.stdout.flush()
            os._exit(17)

    hvd.init(device="cpu")
    model, opt = make_model()
    state = hvd.elastic.TorchState(model, opt, epoch=0, grown_epoch=-1,
                                   seen_one=False)

    def finished(state) -> bool:
        if run_until:
            return os.path.exists(run_until) or state.epoch >= max_epochs
        if wait_for_size or shrink_grow:
            if shrink_grow and hvd.size() == 1:
                state.seen_one = True
            grown = hvd.size() >= (2 if shrink_grow else wait_for_size)
            if state.grown_epoch < 0 and grown and (
                    state.seen_one or not shrink_grow):
                state.grown_epoch = state.epoch
            if state.grown_epoch >= 0 and \
                    state.epoch >= state.grown_epoch + 2:
                return True
            return state.epoch >= max_epochs
        return state.epoch >= epochs

    @hvd.elastic.run
    def train(state):
        while True:
            # a stop decided from local observations (a sentinel file)
            # is MAX-reduced so every rank leaves at the same epoch
            flag = hvd.allreduce(
                torch.tensor([1.0 if finished(state) else 0.0]),
                op=hvd.Max, name="finish_check")
            if float(flag[0]) > 0:
                break
            time.sleep(epoch_sleep)
            mine = [c for c in range(CHUNKS) if c % hvd.size() == hvd.rank()]
            grads = chunk_grads(state.model, state.epoch, mine)
            maybe_kill(state.epoch)
            grads = hvd.grouped_allreduce(grads, op=hvd.Sum, name="grads")
            apply_grads(state.model, state.optimizer, grads)
            state.epoch += 1
            log_event(f"epoch={state.epoch} rank={hvd.rank()} "
                      f"size={hvd.size()} host={host}")
            state.commit()

    train(state)
    np.savez(os.path.join(test_dir, f"final.{hvd.rank()}.npz"),
             *[p.detach().numpy() for p in model.parameters()])
    log_event(f"done rank={hvd.rank()} size={hvd.size()} "
              f"epochs={state.epoch}")
    hvd.shutdown()


# ---------------------------------------------------------------------------
# the launch harness
# ---------------------------------------------------------------------------

def launch(test_dir: str, hosts: str, extra_env=None, np_=2, min_np=1,
           epochs=4, extra_args=()):
    hosts_file = os.path.join(test_dir, "hosts.txt")
    with open(hosts_file, "w") as f:
        f.write(hosts + "\n")
    script = os.path.join(test_dir, "discover.sh")
    with open(script, "w") as f:
        f.write(f"#!/bin/sh\ncat {hosts_file}\n")
    os.chmod(script, os.stat(script).st_mode | stat.S_IEXEC)
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
        "ELASTIC_TEST_DIR": test_dir,
        "ELASTIC_TEST_EPOCHS": str(epochs),
    })
    env.update(extra_env or {})
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner",
           "-np", str(np_), "--min-np", str(min_np),
           "--host-discovery-script", script, "--slots", "1",
           "--stall-check-warning-time-seconds", "5",
           "--stall-check-shutdown-time-seconds", "15",
           *extra_args, sys.executable, HERE, "worker"]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, cwd=test_dir)
    return proc, hosts_file


def finish(proc, timeout=240):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError("elastic launch timed out:\n"
                             + out.decode(errors="replace")[-6000:])
    return proc.returncode, out.decode(errors="replace")


def events(test_dir):
    path = os.path.join(test_dir, "events.log")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def wait_for_event(proc, test_dir, pred, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if any(pred(e) for e in events(test_dir)):
            return
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    proc.kill()
    out = proc.communicate()[0].decode(errors="replace")
    raise AssertionError(f"no such event: {events(test_dir)}\n{out[-4000:]}")


def _done(evs, rank=0):
    done = [e for e in evs if e.startswith(f"done rank={rank} ")]
    assert done, evs
    m = re.search(r"done rank=\d+ size=(\d+) epochs=(\d+)", done[0])
    return int(m.group(1)), int(m.group(2))


# ---------------------------------------------------------------------------
# the scenarios of tests/test_elastic_e2e.py
# ---------------------------------------------------------------------------

def test_port_elastic_rank_failure():
    """Rank 1 dies mid-epoch: its host is blacklisted, the survivor's
    gloo call fails (HorovodInternalError), it restores its commit,
    re-forms the world at size 1 in-process and finishes every epoch."""
    with tempfile.TemporaryDirectory() as td:
        proc, _ = launch(td, "localhost:1\n127.0.0.1:1",
                         extra_env={"ELASTIC_TEST_KILL_RANK": "1",
                                    "ELASTIC_TEST_KILL_EPOCH": "1"},
                         np_=2, min_np=1, epochs=4)
        code, out = finish(proc)
        evs = events(td)
        assert code == 0, f"launcher exited {code}:\n{out[-6000:]}\n{evs}"
        assert any(e.startswith("killed rank=1 epoch=1") for e in evs), evs
        assert _done(evs) == (1, 4)
        later = [e for e in evs if re.match(r"epoch=[234] rank=0 size=1 ", e)]
        assert len(later) >= 3, evs

        def t(e):
            return float(re.search(r" t=([0-9.]+)$", e).group(1))
        kill_t = t(next(e for e in evs if e.startswith("killed")))
        recovery_s = min(t(e) for e in later if t(e) > kill_t) - kill_t
        print(f"port elastic recovery: kill -> first epoch of the new "
              f"generation = {recovery_s:.2f}s")
        assert recovery_s < 60.0, recovery_s


def test_port_elastic_scale_up():
    """One host, then two: the workers interrupt at the next commit,
    re-form at size 2 (the old worker in-process, the new one spawned)
    and finish two epochs after growing."""
    with tempfile.TemporaryDirectory() as td:
        proc, hosts_file = launch(
            td, "localhost:1", np_=1, min_np=1, epochs=0,
            extra_env={"ELASTIC_TEST_WAIT_FOR_SIZE": "2"},
            extra_args=("--max-np", "2"))
        wait_for_event(proc, td, lambda e: e.startswith("epoch=1 "))
        with open(hosts_file, "w") as f:
            f.write("localhost:1\n127.0.0.1:1\n")
        code, out = finish(proc)
        evs = events(td)
        assert code == 0, f"launcher exited {code}:\n{out[-6000:]}\n{evs}"
        assert _done(evs)[0] == 2, evs
        grown = [e for e in evs if re.match(r"epoch=\d+ rank=0 size=2", e)]
        assert len(grown) >= 2, evs


def test_port_elastic_all_ranks_failure_cascade():
    """Both ranks die in one epoch: the registry blacklists only the
    first failure's host and respawns the other, which reloads its
    durable commit and finishes."""
    with tempfile.TemporaryDirectory() as td:
        proc, _ = launch(td, "localhost:1\n127.0.0.1:1",
                         extra_env={"ELASTIC_TEST_KILL_SCHEDULE": "0:1,1:1"},
                         np_=2, min_np=1, epochs=4)
        code, out = finish(proc)
        evs = events(td)
        assert code == 0, f"launcher exited {code}:\n{out[-6000:]}\n{evs}"
        assert [e for e in evs if e.startswith("killed ")], evs
        assert _done(evs) == (1, 4)


def test_port_elastic_all_hosts_blacklisted():
    with tempfile.TemporaryDirectory() as td:
        proc, _ = launch(td, "localhost:1",
                         extra_env={"ELASTIC_TEST_KILL_RANK": "0",
                                    "ELASTIC_TEST_KILL_EPOCH": "1"},
                         np_=1, min_np=1, epochs=4)
        code, out = finish(proc)
        assert code != 0, out[-4000:]
        assert "no healthy host remains" in out, out[-4000:]


def test_port_elastic_min_np_timeout():
    with tempfile.TemporaryDirectory() as td:
        proc, _ = launch(td, "localhost:1", np_=2, min_np=2, epochs=2,
                         extra_args=("--elastic-timeout", "4"))
        code, out = finish(proc, timeout=120)
        assert code != 0, out[-4000:]
        assert "Timed out waiting" in out, out[-4000:]


def test_port_elastic_reset_limit():
    with tempfile.TemporaryDirectory() as td:
        proc, _ = launch(td, "localhost:1\n127.0.0.1:1",
                         extra_env={"ELASTIC_TEST_KILL_RANK": "1",
                                    "ELASTIC_TEST_KILL_EPOCH": "1"},
                         np_=2, min_np=1, epochs=4,
                         extra_args=("--reset-limit", "0"))
        code, out = finish(proc)
        assert code != 0, out[-4000:]
        assert "Exceeded the permitted number of elastic resets" in out, \
            out[-4000:]


def test_port_elastic_hosts_added_and_removed_together():
    """127.0.0.1 is swapped for 127.0.0.2 in one discovery change: the
    removed host's worker finds no slot at its reset and exits 0, the new
    one joins, and training finishes at size 2."""
    with tempfile.TemporaryDirectory() as td:
        finish_file = os.path.join(td, "finish.marker")
        proc, hosts_file = launch(
            td, "localhost:1\n127.0.0.1:1", np_=2, min_np=1, epochs=0,
            extra_env={"ELASTIC_TEST_RUN_UNTIL_FILE": finish_file},
            extra_args=("--max-np", "2"))
        wait_for_event(proc, td, lambda e: e.startswith("epoch=2 "))
        with open(hosts_file, "w") as f:
            f.write("localhost:1\n127.0.0.2:1\n")
        wait_for_event(proc, td, lambda e: "host=127.0.0.2" in e,
                       timeout=180)
        open(finish_file, "w").close()
        code, out = finish(proc)
        evs = events(td)
        assert code == 0, f"launcher exited {code}:\n{out[-6000:]}\n{evs}"
        assert _done(evs)[0] == 2, evs
        first_new = next(i for i, e in enumerate(evs)
                         if "host=127.0.0.2" in e)
        assert not any("host=127.0.0.1" in e for e in evs[first_new:]), evs


def test_port_elastic_kill_and_regrow_matches_uninterrupted_run():
    """Two hosts; rank 1 dies in epoch 1 (size 1 from then on, its host
    blacklisted); once the survivor trains alone a third host is offered
    and the world grows back to 2; two epochs later the run ends. Every
    rank's final parameters equal, bit for bit, those of the same number
    of epochs run without interruption in this process."""
    with tempfile.TemporaryDirectory() as td:
        proc, hosts_file = launch(
            td, "localhost:1\n127.0.0.1:1", np_=2, min_np=1, epochs=0,
            extra_env={"ELASTIC_TEST_KILL_RANK": "1",
                       "ELASTIC_TEST_KILL_EPOCH": "1",
                       "ELASTIC_TEST_SHRINK_THEN_GROW": "1"},
            extra_args=("--max-np", "2"))
        wait_for_event(proc, td,
                       lambda e: re.match(r"epoch=\d+ rank=0 size=1 ", e))
        with open(hosts_file, "w") as f:
            f.write("localhost:1\n127.0.0.1:1\n127.0.0.2:1\n")
        code, out = finish(proc)
        evs = events(td)
        assert code == 0, f"launcher exited {code}:\n{out[-6000:]}\n{evs}"
        assert any(e.startswith("killed rank=1 epoch=1") for e in evs), evs
        size, epochs = _done(evs)
        assert size == 2 and _done(evs, rank=1) == (2, epochs), evs
        sizes = [int(m.group(1)) for e in evs
                 for m in [re.match(r"epoch=\d+ rank=0 size=(\d+) ", e)] if m]
        assert 1 in sizes and sizes[-1] == 2, evs
        want = replay(epochs)
        for rank in (0, 1):
            got = np.load(os.path.join(td, f"final.{rank}.npz"))
            for i, w in enumerate(want):
                np.testing.assert_array_equal(got[f"arr_{i}"], w)


if __name__ == "__main__" and sys.argv[1:] == ["worker"]:
    worker_main()
