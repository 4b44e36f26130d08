"""The port's TensorFlow frontend (``horovod_tpu_torch.tensorflow`` and its
``elastic``) against the JAX package's ``horovod_tpu.tensorflow``, the
oracle, on the CPU.

In a world of one process of each package, the same TF inputs (numpy
seed 0) go through both frontends: every verb and its async form,
``tf.IndexedSlices``, fp16 compression, the gradients of the
differentiable verbs, ``DistributedGradientTape``, the TF1 optimizer and
the session hook, the Adasum delta optimizer, and the elastic states.
Tolerance 0 throughout: at one process every reduction is the identity
(or a scale by a power of two), so the results are bit-equal. A gloo
world of 2 of each package (this file is its own worker: ``python
tests/test_torch_port_frontends_tf.py world jax|port`` with the
``HVD_TPU_*`` env) computes the tape's averaged gradients and
``broadcast_variables`` from root 1 on integer-valued float inputs:
every sum there is of two values, and the ranks' results must equal the
JAX world's, bit for bit.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _world_scenarios(hvd_tf, tf):
    r = hvd_tf.rank()
    out = {}
    w = tf.Variable(np.arange(6, dtype=np.float32).reshape(3, 2) + r)
    x = tf.constant(np.arange(12, dtype=np.float32).reshape(4, 3) * (r + 1))
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(tf.matmul(x, w) * (r + 2.0))
    tape = hvd_tf.DistributedGradientTape(tape)
    (g,) = tape.gradient(loss, [w])
    out["tape_average"] = g.numpy().tolist()
    with tf.GradientTape() as tape:
        loss = tf.reduce_sum(tf.matmul(x, w))
    tape = hvd_tf.DistributedGradientTape(tape, op=hvd_tf.Sum)
    (g,) = tape.gradient(loss, [w])
    out["tape_sum"] = g.numpy().tolist()
    vs = [tf.Variable(np.full((3,), 10.0 * r + i, np.float32))
          for i in range(3)] + [tf.Variable(np.int32(7 + r))]
    hvd_tf.broadcast_variables(vs, root_rank=1)
    out["broadcast_variables_root1"] = [v.numpy().tolist() for v in vs]
    return out


def _world_main(which):
    import tensorflow as tf
    sys.path.insert(0, ROOT)
    from tests.torch_port_frontends_common import cap_tf_threads, result_line
    cap_tf_threads(tf)
    if which == "jax":
        import horovod_tpu as hvd
        import horovod_tpu.tensorflow as hvd_tf
        hvd.init()
    else:
        import horovod_tpu_torch as hvd
        import horovod_tpu_torch.tensorflow as hvd_tf
        hvd.init(device="cpu")
    try:
        res = _world_scenarios(hvd_tf, tf)
    finally:
        hvd.shutdown()
    result_line(res)


if __name__ == "__main__" and len(sys.argv) > 2 and sys.argv[1] == "world":
    _world_main(sys.argv[2])
    sys.exit(0)


import pytest  # noqa: E402

tf = pytest.importorskip("tensorflow")

import torch  # noqa: E402

import horovod_tpu.tensorflow as jtf  # noqa: E402
import horovod_tpu_torch.tensorflow as ptf  # noqa: E402
from horovod_tpu.compression import Compression as JCompression  # noqa: E402
from horovod_tpu_torch.compression import Compression  # noqa: E402
from tests import torch_port_frontends_common as common  # noqa: E402

common.cap_tf_threads(tf)


@pytest.fixture(scope="module", autouse=True)
def worlds():
    with common.both_worlds():
        yield


def _bits(t):
    """A TF tensor's values and dtype, compared bit for bit (half types
    through their 16-bit patterns)."""
    if t.dtype in (tf.bfloat16, tf.float16):
        return t.dtype.name, tf.bitcast(t, tf.uint16).numpy().tolist()
    return t.dtype.name, t.numpy().tolist()


def _input(dtype, shape=(4, 3), seed=0):
    a = np.random.RandomState(seed).randn(*shape) * 8
    if dtype in (tf.int32, tf.int64):
        a = np.round(a)
    return tf.cast(tf.constant(a), dtype)


DTYPES = [tf.float32, tf.float64, tf.bfloat16, tf.int32]
VERBS = {
    "allreduce_average": lambda m, x: m.allreduce(x, name="v.ar"),
    "allreduce_sum_scaled": lambda m, x: m.allreduce(
        x, op=m.Sum, prescale_factor=0.5, postscale_factor=4.0,
        name="v.ars"),
    "allgather": lambda m, x: m.allgather(x, name="v.ag"),
    "broadcast": lambda m, x: m.broadcast(x, 0, name="v.bc"),
    "alltoall": lambda m, x: m.alltoall(x, name="v.a2a"),
}


# a fractional scale of an integer tensor raises (tested below)
CASES = [(v, d) for v in sorted(VERBS) for d in DTYPES
         if not (v == "allreduce_sum_scaled" and d == tf.int32)]


@pytest.mark.parametrize("verb,dtype", CASES,
                         ids=[f"{v}-{d.name}" for v, d in CASES])
def test_verbs_equal_jax(verb, dtype):
    x = _input(dtype)
    got, want = VERBS[verb](ptf, x), VERBS[verb](jtf, x)
    assert isinstance(got, tf.Tensor)
    assert _bits(got) == _bits(want)


def test_scaled_integer_allreduce_raises_in_both():
    x = _input(tf.int32)
    for mod in (ptf, jtf):
        with pytest.raises(ValueError):
            mod.allreduce(x, op=mod.Sum, prescale_factor=0.5)


def test_async_verbs_equal_jax():
    x = _input(tf.float32, (4, 2), seed=1)
    out = {}
    for key, mod in (("port", ptf), ("jax", jtf)):
        hs = [mod.allreduce_async(x, op=mod.Sum, name="a.ar"),
              mod.allgather_async(x, name="a.ag"),
              mod.broadcast_async(x, 0, name="a.bc"),
              mod.alltoall_async(x, name="a.a2a")]
        for h in hs:
            while not mod.poll(h):
                pass
        out[key] = [_bits(mod.synchronize(h)) for h in hs]
    assert out["port"] == out["jax"]


def test_indexed_slices_equal_jax():
    s = tf.IndexedSlices(values=_input(tf.float32, (3, 4), seed=2),
                         indices=tf.constant([4, 1, 4]),
                         dense_shape=tf.constant([6, 4]))
    for kw in ({}, {"average": False}, {"op": ptf.Sum}):
        jkw = {k: (jtf.Sum if v is ptf.Sum else v) for k, v in kw.items()}
        got = ptf.allreduce(s, name="s.p", **kw)
        want = jtf.allreduce(s, name="s.j", **jkw)
        assert isinstance(got, tf.IndexedSlices)
        assert _bits(got.values) == _bits(want.values)
        assert _bits(got.indices) == _bits(want.indices)
        assert got.dense_shape.numpy().tolist() == [6, 4]


def test_fp16_compression_equal_jax():
    """Compression.fp16 is bfloat16 in both packages: the wire value and
    the gradient are rounded to it and come back in the input's dtype."""
    v = tf.Variable(_input(tf.float32, (5,), seed=3))
    out = {}
    for key, mod, comp in (("port", ptf, Compression.fp16),
                           ("jax", jtf, JCompression.fp16)):
        with tf.GradientTape() as tape:
            y = mod.allreduce(v, op=mod.Sum, compression=comp, name="c")
            loss = tf.reduce_sum(y * tf.constant([1.0, 1 / 3, 2.0, 5.0, 7.1]))
        g = tape.gradient(loss, v)
        with tf.GradientTape() as tape:
            loss = tf.reduce_sum(v * v * tf.constant(1 / 3))
        tape = mod.DistributedGradientTape(tape, compression=comp)
        (tg,) = tape.gradient(loss, [v])
        out[key] = [_bits(y), _bits(g), _bits(tg)]
    assert out["port"] == out["jax"]
    # the wire value really was rounded: not every fp32 value survives
    assert out["port"][0] != _bits(tf.convert_to_tensor(v))


def test_differentiable_verbs_gradients_equal_jax():
    w = tf.constant([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    out = {}
    for key, mod in (("port", ptf), ("jax", jtf)):
        x = tf.Variable(np.arange(6, dtype=np.float32).reshape(3, 2))
        s = tf.Variable(np.float32(2.5))
        with tf.GradientTape(persistent=True) as tape:
            ar = mod.allreduce(x, op=mod.Average, name="g.ar")
            ag = mod.allgather(x, name="g.ag")
            bc = mod.broadcast(x, root_rank=0, name="g.bc")
            sc = mod.allgather(s, name="g.sc")
            losses = [tf.reduce_sum(tf.reshape(t, [-1]) * w)
                      for t in (ar, ag, bc)] + [tf.reduce_sum(sc) * 3.0]
        out[key] = [_bits(tape.gradient(loss, v))
                    for loss, v in zip(losses, (x, x, x, s))]
    assert out["port"] == out["jax"]


def test_distributed_gradient_tape_equal_jax():
    """A small dense model's gradients through the tape, None entries
    passed through, under Average and Sum with scales."""
    rng = np.random.RandomState(4)
    x = tf.constant(rng.randn(8, 5).astype(np.float32))
    out = {}
    for key, mod in (("port", ptf), ("jax", jtf)):
        w1 = tf.Variable(rng.randn(5, 4).astype(np.float32) * 0 + 0.5)
        b1 = tf.Variable(np.zeros(4, np.float32))
        unused = tf.Variable(np.ones(2, np.float32))
        res = []
        for kw in ({}, {"op": mod.Sum, "prescale_factor": 0.25,
                        "postscale_factor": 2.0}):
            with tf.GradientTape() as tape:
                h = tf.nn.relu(tf.matmul(x, w1) + b1)
                loss = tf.reduce_mean(h * h)
            tape = mod.DistributedGradientTape(tape, **kw)
            grads = tape.gradient(loss, [w1, b1, unused])
            assert grads[2] is None
            res.append([_bits(g) for g in grads[:2]])
        out[key] = res
    assert out["port"] == out["jax"]


def test_tape_and_verbs_leave_tf_buffers_alone():
    """A TF buffer is immutable: the result never aliases the input and
    the input keeps its values after every verb."""
    x = _input(tf.float32, (4, 3), seed=5)
    before = x.numpy().copy()
    outs = [ptf.allreduce(x, op=ptf.Sum, postscale_factor=3.0),
            ptf.allgather(x), ptf.broadcast(x, 0), ptf.alltoall(x)]
    np.testing.assert_array_equal(x.numpy(), before)
    base = torch.from_dlpack(x).data_ptr()
    assert all(torch.from_dlpack(o).data_ptr() != base for o in outs)
    np.testing.assert_array_equal(outs[0].numpy(), before * 3.0)


def test_broadcast_variables_equal_jax_and_fused(monkeypatch):
    calls = []
    real = ptf._c.grouped_broadcast
    monkeypatch.setattr(ptf._c, "grouped_broadcast",
                        lambda ts, **kw: calls.append(len(ts)) or real(ts,
                                                                       **kw))
    out = {}
    for key, mod in (("port", ptf), ("jax", jtf)):
        vs = [tf.Variable(np.full((4,), float(i), np.float32))
              for i in range(7)] + [tf.Variable(np.int64(3))]
        mod.broadcast_variables(vs, root_rank=0)
        out[key] = [_bits(tf.convert_to_tensor(v)) for v in vs]
    assert out["port"] == out["jax"]
    assert calls == [8]   # 8 small variables, one bucket, one call


def test_broadcast_object_equal_jax():
    obj = {"epoch": 3, "lr": [0.1, 0.01]}
    assert ptf.broadcast_object(obj, 0, name="o") == \
        jtf.broadcast_object(obj, 0, name="o") == obj


def _v1_run(mod, name):
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, [4, 3], name="x")
        w = tf.compat.v1.get_variable(
            "w", initializer=np.linspace(-1, 1, 3, dtype=np.float32)[:, None])
        unused = tf.compat.v1.get_variable(
            "u", initializer=np.ones(2, np.float32))
        loss = tf.reduce_mean(tf.square(tf.matmul(x, w) - 1.0))
        inner = tf.compat.v1.train.MomentumOptimizer(0.1, momentum=0.9)
        opt = mod.DistributedOptimizer(inner, name_prefix=name)
        gvs = opt.compute_gradients(loss, var_list=[w, unused])
        assert gvs[1][0] is None and gvs[1][1] is unused
        train = opt.minimize(loss, var_list=[w])
        assert opt.get_slot_names() == inner.get_slot_names()
        hook = mod.BroadcastGlobalVariablesHook(root_rank=0)
        xv = np.arange(12, dtype=np.float32).reshape(4, 3) / 10
        with tf.compat.v1.train.MonitoredTrainingSession(
                hooks=[hook]) as sess:
            for _ in range(5):
                sess.run(train, feed_dict={x: xv})
            return sess.run(w).tolist(), sess.run(
                opt.get_slot(w, "momentum")).tolist()


def test_v1_optimizer_and_session_hook_equal_jax():
    """The TF1 recipe: minimize() through the wrapper (its one py_function
    node in the graph) and the broadcast hook in a MonitoredTrainingSession;
    the variable and the momentum slot after 5 steps are equal."""
    got, want = _v1_run(ptf, "p.v1"), _v1_run(jtf, "j.v1")
    assert got == want


def test_session_hook_broadcasts_every_global_variable():
    for mod in (ptf, jtf):
        g = tf.Graph()
        with g.as_default():
            v1 = tf.compat.v1.get_variable(
                "v1", initializer=tf.constant([1.0, 2.0]))
            v2 = tf.compat.v1.get_variable("v2", initializer=tf.constant(5))
            hook = mod.BroadcastGlobalVariablesHook(root_rank=0)
            hook.begin()
            with tf.compat.v1.Session(graph=g) as sess:
                sess.run(tf.compat.v1.global_variables_initializer())
                hook.after_create_session(sess, None)
                assert sess.run([v1, v2])[0].tolist() == [1.0, 2.0]
                assert sess.run(v2) == 5


@pytest.mark.parametrize("passes", [1, 2])
def test_delta_optimizer_equal_jax(passes):
    """The Adasum delta optimizer: at one process Adasum of the delta is
    the delta, and the two packages' trajectories are equal."""
    import keras
    out = {}
    for key, mod in (("port", ptf), ("jax", jtf)):
        v = tf.Variable([1.0, -2.0, 3.0])
        opt = mod.DistributedDeltaOptimizer(
            keras.optimizers.SGD(learning_rate=0.1, momentum=0.5),
            backward_passes_per_step=passes)
        for _ in range(4):
            with tf.GradientTape() as t:
                loss = tf.reduce_sum(v ** 2 * tf.constant([1.0, 0.3, 2.0]))
            (g,) = t.gradient(loss, [v])
            opt.apply_gradients([(g, v)])
        out[key] = _bits(tf.convert_to_tensor(v))
    assert out["port"] == out["jax"]


def test_keras_optimizer_apply_gradients_in_tf_function_equal_jax():
    """Inside a tf.function the gradient list reduces through one
    py_function node (the path Keras 3's traced train_step takes)."""
    import keras
    out = {}
    for key, mod in (("port", ptf), ("jax", jtf)):
        v = tf.Variable(np.linspace(-1, 1, 6, dtype=np.float32))
        opt = mod.DistributedOptimizer(keras.optimizers.Adam(0.05),
                                       name_prefix=f"tf.fn.{key}")

        @tf.function
        def step():
            with tf.GradientTape() as t:
                loss = tf.reduce_sum(tf.sin(v) * v)
            (g,) = t.gradient(loss, [v])
            opt.apply_gradients([(g, v)])
        for _ in range(3):
            step()
        out[key] = _bits(tf.convert_to_tensor(v))
    assert out["port"] == out["jax"]


def _keras_model(seed):
    import keras
    keras.utils.set_random_seed(seed)
    model = keras.Sequential([keras.Input(shape=(4,)),
                              keras.layers.Dense(3, activation="relu"),
                              keras.layers.Dense(2)])
    model.compile(optimizer=keras.optimizers.SGD(0.05, momentum=0.9),
                  loss="mse")
    return model


def test_tf_keras_state_commit_restore_sync_equal_jax():
    from horovod_tpu.tensorflow.elastic import TensorFlowKerasState as JS
    from horovod_tpu_torch.tensorflow.elastic import TensorFlowKerasState
    x = np.random.RandomState(6).randn(8, 4).astype(np.float32)
    y = np.random.RandomState(7).randn(8, 2).astype(np.float32)
    out = {}
    for key, cls in (("port", TensorFlowKerasState), ("jax", JS)):
        model = _keras_model(0)
        model.train_on_batch(x, y)
        state = cls(model, model.optimizer, batch=0, epoch=0)
        state.epoch = 3
        state.commit()
        committed = [w.copy() for w in model.get_weights()]
        opt_committed = state._opt_values()
        model.train_on_batch(x, y)   # drift
        state.epoch = 9
        state.restore()
        assert state.epoch == 3
        assert all(np.array_equal(a, b)
                   for a, b in zip(model.get_weights(), committed))
        assert all(np.array_equal(a, b)
                   for a, b in zip(state._opt_values(), opt_committed))
        state.sync()   # one process: the broadcast is the identity
        model.train_on_batch(x, y)
        out[key] = [w.tolist() for w in model.get_weights()] + [
            v.tolist() for v in state._opt_values()]
    assert out["port"] == out["jax"]


def test_tensorflow_state_equal_jax():
    from horovod_tpu.tensorflow.elastic import TensorFlowState as JS
    from horovod_tpu_torch.tensorflow.elastic import TensorFlowState
    for cls in (TensorFlowState, JS):
        v = tf.Variable([1.0, 1.0])
        n = tf.Variable(np.int32(5))
        state = cls(variables=[v, n], step=0)
        v.assign([4.0, 4.0])
        state.step = 2
        state.commit()
        v.assign([0.0, 0.0])
        n.assign(1)
        state.step = 7
        state.restore()
        assert v.numpy().tolist() == [4.0, 4.0] and int(n.numpy()) == 5
        assert state.step == 2
        state.sync()
        assert v.numpy().tolist() == [4.0, 4.0]
    from horovod_tpu_torch.tensorflow import elastic
    assert elastic.KerasState is elastic.TensorFlowKerasState
    assert elastic.run is __import__(
        "horovod_tpu_torch.elastic", fromlist=["run"]).run


def test_public_names_match_jax():
    import horovod_tpu.tensorflow.elastic as je
    import horovod_tpu_torch.tensorflow.elastic as pe
    for jmod, pmod in ((jtf, ptf), (je, pe)):
        names = [n for n in dir(jmod) if not n.startswith("_")
                 and not isinstance(getattr(jmod, n), type(os))
                 and getattr(getattr(jmod, n), "__module__", "") != "typing"]
        assert names and all(hasattr(pmod, n) for n in names), [
            n for n in names if not hasattr(pmod, n)]


# ---------------------------------------------------------------------------
# a gloo world of 2 of each package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world2():
    script = os.path.abspath(__file__)
    jax_procs = common.spawn(script, ["world", "jax"])
    port_procs = common.spawn(script, ["world", "port"])
    return common.collect(jax_procs, 240), common.collect(port_procs, 240)


SCENARIOS = ("tape_average", "tape_sum", "broadcast_variables_root1")


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_world_of_two_equal_jax(world2, scenario, rank):
    """Tolerance 0: integer-valued inputs, each sum of two values."""
    jax_res, port_res = world2
    assert port_res[rank][scenario] == jax_res[rank][scenario]


def test_world_of_two_by_hand(world2):
    _, port = world2
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    # d/dw sum((x (r+1)) @ w * (r+2)) = (r+1)(r+2) x^T 1, averaged
    col = x.sum(axis=0)[:, None] * np.ones((1, 2), np.float32)
    assert port[0]["tape_average"] == ((2 * col + 6 * col) / 2).tolist()
    assert port[1]["tape_sum"] == (col + 2 * col).tolist()
    want = [[10.0 + i] * 3 for i in range(3)] + [8]
    assert port[0]["broadcast_variables_root1"] == want
