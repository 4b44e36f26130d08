"""The comparison that decides ``correct``, driven through a whole run
on the CPU at tiny sizes (the look for a card skipped): sound runs pass,
and a run with the timed path broken underneath comes out not correct,
once for each fault a training cell can have (a step that returns its
state unchanged; half of the batch left out, the mean taken over the
rest; on two ranks, the exchange between them left out). The control,
the reference in float8 put in the program's place, fails the limits.

The same control on the chip, at the cells' own sizes:
``python3 -m perfbench.calibrate reference ... --control-seeds``."""

import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch
import torch.nn.functional as F

from perfbench import check, spec, worker
from perfbench.families import gpt2, resnet
from perfbench.tests import tiny

SEED = 2**31 + 77
CELLS = ("tiny_lm", "tiny_cnn")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return tiny.make(str(tmp_path_factory.mktemp("tiny")))


def _correct(root, cell, seed=SEED):
    r = worker.run_rank(cell, seed, 0.2, False, time.time(), device="cpu",
                        root=root, check_chip=False)
    ok, rows = check.judge(r["gaps"], r["limits"])
    return ok, {name: value for name, value, _ in rows}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [SEED, 3, 2**32 + 9])
def test_a_sound_run_is_correct(root, cell, seed):
    ok, gaps = _correct(root, cell, seed)
    assert ok, gaps


def _frozen_gpt2(self, x, y):
    """A step that returns its state unchanged: the loss, no update."""
    with torch.no_grad():
        logits = self.model(x)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               y.reshape(-1).long())


def _frozen_resnet(self, x, y):
    with torch.no_grad():
        return F.cross_entropy(self.model(x), y)


def _half(step):
    def half(self, x, y):
        n = x.shape[0] // 2
        return step(self, x[:n], y[:n])
    return half


@pytest.mark.parametrize("cell,program", [("tiny_lm", gpt2.Program),
                                          ("tiny_cnn", resnet.Program)])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(root, monkeypatch, cell, program,
                                      fault):
    if fault == "unchanged":
        frozen = _frozen_gpt2 if program is gpt2.Program else _frozen_resnet
        monkeypatch.setattr(program, "step", frozen)
    else:
        monkeypatch.setattr(program, "step", _half(program.step))
    ok, gaps = _correct(root, cell)
    assert not ok, gaps
    if fault == "unchanged":
        assert gaps["change_gap"] == pytest.approx(1.0)


def _world(root, fault, tmp_path):
    """A gloo world of two ranks of the tiny LM cell; rank 0's result."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / f"{fault}.json")
    procs = []
    for rank in range(2):
        env = {**os.environ, "HVD_TPU_COORDINATOR_ADDR": f"127.0.0.1:{port}",
               "HVD_TPU_SIZE": "2", "HVD_TPU_RANK": str(rank),
               "PYTHONPATH": spec.ROOT}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "perfbench.tests.dp_world", root, fault,
             out], env=env, cwd=spec.ROOT))
    for p in procs:
        assert p.wait(timeout=300) == 0
    with open(out) as f:
        r = json.load(f)
    return check.judge(r["gaps"], r["limits"])


def test_the_exchange_between_chips_is_checked(tmp_path):
    root = tiny.make(str(tmp_path / "dp"), chips=2)
    ok, rows = _world(root, "none", tmp_path)
    assert ok, rows
    ok, rows = _world(root, "no_exchange", tmp_path)
    assert not ok, rows
    assert rows_value(rows, "ranks_differ") > 0


def rows_value(rows, name):
    return dict((n, v) for n, v, _ in rows)[name]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails(root, cell, seed):
    """The reference in float8 against the reference in float32: it fails
    at least one of the cell's numbers."""
    c = spec.cell(cell, root)
    ref = worker.reference_readings(c, seed, "cpu")
    ctl = worker.reference_readings(c, seed, "cpu", "fp8")
    ok, rows = check.judge(check.gaps(ctl, ref), c.limits)
    assert not ok, rows


def test_judge_compares_the_listed_numbers():
    assert check.judge({"loss_gap": 0.0}, None)[0] is False
    assert check.judge({"loss_gap": 0.0}, {})[0] is False
    limits = {"loss_gap": {"limit": 1e-3}}
    assert check.judge({"loss_gap": 1e-4}, limits)[0] is True
    assert check.judge({"ranks_differ": 0},
                       {"ranks_differ": {"limit": 0}})[0] is True
    assert check.judge({"ranks_differ": 1},
                       {"ranks_differ": {"limit": 0}})[0] is False
    assert check.judge({"loss_gap": math.nan}, limits)[0] is False
    assert check.judge({"loss_gap": math.inf}, limits)[0] is False
    # a number not listed is not compared; a listed one not read fails
    assert check.judge({"loss_gap": 1e-4, "grad_gap": 9.0}, limits) == \
        (True, [("loss_gap", 1e-4, 1e-3)])
    assert check.judge({"grad_gap": 0.0}, limits)[0] is False


def test_gaps_by_the_worst_leaf():
    ref = {"losses": [2.0, 2.0, 2.0], "grad": {"a": 1.0, "b": 1.0, "z": 0.0},
           "change": {"a": 1.0, "b": 2.0, "z": 5.0}, "stats": {}}
    prog = {"losses": [2.0, 2.02, 2.0], "grad": {"a": 1.0, "b": 1.5,
                                                 "z": 0.1},
            "change": {"a": 1.0, "b": 2.0, "z": 9.0}, "stats": {}}
    g = check.gaps(prog, ref)
    assert g["loss_gap"] == pytest.approx(0.01)
    assert g["grad_gap"] == pytest.approx(0.5)
    # per-leaf gaps 0, 0.5, 0.1 (z against the median norm, 1)
    assert g["grad_gap_median"] == pytest.approx(0.1)
    # z's reference gradient is nought: it is left out of the change
    assert g["change_gap"] == 0.0
    assert "stats_gap" not in g
    prog["losses"][0] = math.nan
    assert check.gaps(prog, ref)["loss_gap"] == math.inf


def test_ranks_differ_counts_every_leaf_that_differs():
    same = [[[1.0, 2.0], [3.0, 4.0]]] * 3
    assert check.ranks_differ(same) == 0
    off = [[[1.0, 2.0], [3.0, 4.0]], [[1.0, 2.0], [3.0, 4.5]],
           [[1.5, 2.0], [3.0, 4.5]]]
    assert check.ranks_differ(off) == 3
