"""The port's torch frontend (``horovod_tpu_torch.torch``), MXNet bridge
(``horovod_tpu_torch.mxnet``) and driver service
(``horovod_tpu_torch.runner.driver_service``) against the JAX package's,
the oracle, on the CPU.

* Every public name of ``horovod_tpu.torch``, ``.torch.elastic`` and
  ``.torch.sync_batch_norm`` exists in the port's frontend, which is the
  core under that path; the 5-line recipe trains a small model to the
  same parameters as the JAX frontend (tolerance 0: one process, so each
  reduction is the identity and both run the same torch optimizer).
* MXNet is not installed: both bridges are driven through the JAX
  suite's stub NDArray/Trainer surface (``tests/test_mxnet_stub.py``, put
  in ``sys.modules`` as ``mxnet``) and their outputs compared exactly;
  without the stub the port's bridge raises an error that names it.
* Driver and task services of each package register the same task
  layout (one live loopback interface, one whose port is closed) and
  agree on the common interfaces.
"""

import sys

import numpy as np
import pytest
import torch

import horovod_tpu.mxnet as jmx
import horovod_tpu.torch as jt
import horovod_tpu_torch as hvd
import horovod_tpu_torch.mxnet as pmx
import horovod_tpu_torch.torch as pt
from horovod_tpu.compression import Compression as JCompression
from horovod_tpu_torch.compression import Compression
from tests import torch_port_frontends_common as common
from tests.test_mxnet_stub import FakeND, FakeParam, FakeSGD


@pytest.fixture(scope="module", autouse=True)
def worlds():
    with common.both_worlds():
        yield


def _public(mod):
    return sorted(n for n in dir(mod) if not n.startswith("_")
                  and not isinstance(getattr(mod, n), type(sys))
                  and getattr(getattr(mod, n), "__module__", "") != "typing")


@pytest.mark.parametrize("sub", ["", ".elastic", ".sync_batch_norm"])
def test_torch_frontend_has_every_jax_name(sub):
    import importlib
    jmod = importlib.import_module("horovod_tpu.torch" + sub)
    pmod = importlib.import_module("horovod_tpu_torch.torch" + sub)
    names = _public(jmod) + (["SyncBatchNorm", "elastic"] if not sub else [])
    assert names
    assert [n for n in names if not hasattr(pmod, n)] == []


def test_torch_frontend_is_the_core():
    for name in ("allreduce_async_", "synchronize", "broadcast_parameters",
                 "broadcast_optimizer_state", "DistributedOptimizer",
                 "init", "Compression", "Adasum", "SyncBatchNorm"):
        assert getattr(pt, name) is getattr(hvd, name), name
    assert pt.elastic.TorchState is hvd.elastic.TorchState
    assert pt.elastic.run is hvd.elastic.run
    from horovod_tpu_torch.torch import sync_batch_norm
    assert sync_batch_norm.get_sync_batch_norm_class() is hvd.SyncBatchNorm
    # the frontend's package does not shadow the real torch
    assert torch.__file__ != pt.__file__
    assert "site-packages" in torch.__file__ or "dist-packages" in \
        torch.__file__


def _recipe(mod):
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(),
                                torch.nn.Linear(5, 2))
    opt = mod.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1 * mod.size(),
                        momentum=0.9),
        named_parameters=model.named_parameters())
    mod.broadcast_parameters(model.state_dict(), root_rank=0)
    mod.broadcast_optimizer_state(opt, root_rank=0)
    rng = np.random.RandomState(0)
    for _ in range(3):
        x = torch.from_numpy(rng.randn(8, 6).astype(np.float32))
        opt.zero_grad()
        model(x).pow(2).mean().backward()
        opt.step()
    mod.broadcast_optimizer_state(opt, root_rank=0)
    return [p.detach().clone() for p in model.parameters()]


def test_five_line_recipe_equal_jax():
    got, want = _recipe(pt), _recipe(jt)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_frontend_verbs_equal_jax():
    x = torch.from_numpy(np.random.RandomState(1).randn(4, 3)
                         .astype(np.float32))
    for mod, tag in ((pt, "p"), (jt, "j")):
        y = x.clone()
        mod.allreduce_(y, op=mod.Sum, name=f"{tag}.ip")
        h = mod.allreduce_async_(y, op=mod.Average, name=f"{tag}.ipa")
        assert mod.synchronize(h) is y
        outs = [y, mod.allgather(x, name=f"{tag}.ag"),
                mod.broadcast(x, 0, name=f"{tag}.bc"),
                mod.alltoall(x, name=f"{tag}.a2a")]
        if tag == "p":
            got = outs
        else:
            want = outs
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# MXNet through the stub surface
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_mx(monkeypatch):
    monkeypatch.setitem(sys.modules, "mxnet", common.fake_mxnet())


def _mx_run(mod, comp):
    x = FakeND(np.arange(6, dtype=np.float32).reshape(2, 3) / 7)
    out = {"allreduce": mod.allreduce(x, average=True, name="mx.ar"),
           "allreduce_sum": mod.allreduce(x, average=False, name="mx.ars"),
           "allgather": mod.allgather(x, name="mx.ag"),
           "broadcast": mod.broadcast(x, root_rank=0, name="mx.bc"),
           "alltoall": mod.alltoall(x, name="mx.a2a")}
    for i, o in enumerate(mod.grouped_allreduce(
            [FakeND(np.ones(3, np.float64)), FakeND(np.full(2, 2, np.int32))],
            average=False, name="mx.gar")):
        out[f"grouped{i}"] = o
    out = {k: (v.dtype.str, v.asnumpy().tolist()) for k, v in out.items()}
    out["object"] = mod.broadcast_object({"epoch": 3}, 0, name="mx.bo")
    p = FakeParam("w", np.arange(4, dtype=np.float32), np.zeros(4))
    mod.broadcast_parameters({"w": p, "b": FakeND(np.ones(2))}, 0)
    out["params"] = p.data().asnumpy().tolist()
    opt = mod.DistributedOptimizer(FakeSGD(lr=0.5))
    w = FakeND(np.ones(3, np.float32))
    opt.update(0, w, FakeND(np.array([2.0, 0.5, -1.0], np.float32)), None)
    out["update"] = w.asnumpy().tolist()
    for f in (1.0, 2.0):
        live = FakeParam("w", np.zeros(4, np.float32),
                         np.array([8.0, 1 / 3, -2.0, 5.0], np.float32))
        frozen = FakeParam("f", np.zeros(2), np.zeros(2), grad_req="null")
        tr = mod.DistributedTrainer([live, frozen], FakeSGD(),
                                    gradient_predivide_factor=f,
                                    compression=comp)
        tr._allreduce_grads()
        out[f"trainer{f}"] = (tr._scale, live.list_grad()[0].asnumpy()
                              .tolist(),
                              frozen.list_grad()[0].asnumpy().tolist())
    with pytest.raises(ValueError, match="plain optimizer"):
        mod.DistributedTrainer([FakeParam("w", [0.0], [0.0])],
                               mod.DistributedOptimizer(FakeSGD()))
    with pytest.raises(ValueError, match="positive"):
        mod.DistributedTrainer([], FakeSGD(), gradient_predivide_factor=0)
    return out


@pytest.mark.parametrize("compression", ["none", "fp16"])
def test_mxnet_bridge_equal_jax(fake_mx, compression):
    got = _mx_run(pmx, getattr(Compression, compression)
                  if compression != "none" else None)
    want = _mx_run(jmx, getattr(JCompression, compression)
                   if compression != "none" else None)
    assert got == want
    if compression == "fp16":   # the trainer's wire value was rounded
        assert got["trainer1.0"][1][1] != float(np.float32(1 / 3))


def test_missing_mxnet_raises_naming_the_port(monkeypatch):
    monkeypatch.setitem(sys.modules, "mxnet", None)
    for call in (lambda: pmx.allreduce(FakeND([1.0])),
                 lambda: pmx.broadcast_parameters({}),
                 lambda: pmx.DistributedOptimizer(FakeSGD()),
                 lambda: pmx.DistributedTrainer([], FakeSGD())):
        with pytest.raises(ImportError,
                           match="horovod_tpu_torch.mxnet requires mxnet"):
            call()
    assert pmx.rank() == 0 and pmx.size() == 1


# ---------------------------------------------------------------------------
# driver and task services
# ---------------------------------------------------------------------------

def _services(pkg):
    import importlib
    ds = importlib.import_module(pkg + ".runner.driver_service")
    net = importlib.import_module(pkg + ".runner.network")
    key = net.make_secret_key()
    driver = ds.DriverService(num_tasks=3, key=key)
    tasks = [ds.TaskService(i, key) for i in range(3)]
    dead = common.free_port()   # nothing listens there
    try:
        client = ds.DriverClient({"lo": [("127.0.0.1", driver.port)]}, key)
        before = client.all_registered()
        for i, t in enumerate(tasks[:2]):
            client.register(i, {"lo": [("127.0.0.1", t.port)],
                                "mgmt": [("127.0.0.1", dead)]})
        partial = (client.all_registered(), client.task_addresses(2))
        client.register(2, {"lo": [("127.0.0.1", tasks[2].port)],
                            "mgmt": [("127.0.0.1", dead)]})
        done = (client.all_registered(), driver.wait_for_all(timeout=5))
        addrs = client.task_addresses(1)
        common_ifs, filtered = ds.get_common_interfaces(driver, key,
                                                        probe_timeout=1.0)
        reachable = ds.TaskClient(0, driver.task_addresses(0), key) \
            .probe_neighbor({"lo": [("127.0.0.1", tasks[1].port)]}, key)
    finally:
        driver.shutdown()
        for t in tasks:
            t.shutdown()
    return {"before": before, "partial": partial, "done": done,
            "registered_1": sorted(addrs) == ["lo", "mgmt"]
            and addrs["lo"] == [("127.0.0.1", tasks[1].port)],
            "common": sorted(common_ifs),
            "filtered": {i: sorted(a) for i, a in filtered.items()},
            "filtered_lo_is_registered": all(
                filtered[i]["lo"] == [("127.0.0.1", tasks[i].port)]
                for i in range(3)),
            "probe": sorted(reachable)}


def test_driver_service_equal_jax():
    got, want = _services("horovod_tpu_torch"), _services("horovod_tpu")
    assert got == want
    assert got["common"] == ["lo"] and got["done"] == (True, True)
    assert got["partial"] == (False, None)


def test_driver_service_public_names_equal_jax():
    import horovod_tpu.runner.driver_service as jds
    import horovod_tpu_torch.runner.driver_service as pds
    assert _public(pds) == _public(jds)
    assert pds.TaskService.NAME_FMT == jds.TaskService.NAME_FMT
    assert pds.DriverService.NAME == jds.DriverService.NAME
