"""Helpers of the frontend parity tests (``test_torch_port_frontends_*``):
both packages' worlds of one process in the test process, gloo worlds of
two spawned from a test file that is its own worker, TensorFlow's thread
pools capped, and the JAX suite's stub mxnet surface
(``tests/test_mxnet_stub.py``) as a module either package's bridge can
import.
"""

import contextlib
import json
import os
import socket
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cap_tf_threads(tf) -> None:
    """One intra-op and one inter-op thread: the suite runs several test
    processes at once, each with torch's own pool beside TF's. The pools
    are fixed once TF's context exists; a file that another one ran
    before in this process finds them set already and keeps them."""
    try:
        tf.config.threading.set_intra_op_parallelism_threads(1)
        tf.config.threading.set_inter_op_parallelism_threads(1)
    except RuntimeError:
        pass


@contextlib.contextmanager
def both_worlds():
    """A world of one of each package in this process (the port's on the
    CPU), yielding the two package modules. On exit the port's world is
    shut down, and the JAX package's too unless it existed before: a JAX
    world left behind changes how later test files of this process
    resolve their rank (``horovod_tpu.faults`` reads it from the world)."""
    import horovod_tpu as jhvd
    import horovod_tpu_torch as hvd
    started = not jhvd.is_initialized()
    if started:
        jhvd.init()
    if hvd.is_initialized():
        hvd.shutdown()
    hvd.init(device="cpu")
    try:
        yield jhvd, hvd
    finally:
        hvd.shutdown()
        if started:
            jhvd.shutdown()


def fake_mxnet():
    """A stand-in ``mxnet`` module over the JAX suite's stub NDArray,
    Parameter and Trainer classes (the slice of mxnet both bridges use)."""
    from tests.test_mxnet_stub import FakeND, FakeTrainer
    mx = types.ModuleType("mxnet")
    mx.nd = types.SimpleNamespace(
        array=lambda a, dtype=None: FakeND(a, dtype))
    mx.gluon = types.SimpleNamespace(Trainer=FakeTrainer)
    return mx


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(script, args, n=2):
    """``n`` processes of ``python script *args`` as one gloo world, by the
    ``HVD_TPU_*`` env contract."""
    port = free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, HVD_TPU_COORDINATOR_ADDR=f"127.0.0.1:{port}",
                   HVD_TPU_SIZE=str(n), HVD_TPU_RANK=str(rank),
                   HVD_TPU_LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   JAX_PLATFORMS="cpu", TF_CPP_MIN_LOG_LEVEL="3",
                   PYTHONPATH=ROOT + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, script, *args], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def collect(procs, timeout):
    """Each rank's ``RESULT <json>`` line, by rank; kills what is left."""
    deadline = time.monotonic() + timeout
    out = []
    try:
        for p in procs:
            o, e = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, e[-4000:]
            line = [ln for ln in o.splitlines() if ln.startswith("RESULT ")]
            assert line, (o[-2000:], e[-2000:])
            out.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            p.kill()
    return out


def result_line(obj) -> None:
    print("RESULT " + json.dumps(obj), flush=True)
