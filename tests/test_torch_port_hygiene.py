"""Hygiene of the PyTorch port: it stands alone (no JAX, flax, optax or
horovod_tpu import, and it imports with them blocked), it runs on CUDA
unless asked for the CPU, and its CUDA wrapper neither takes CPU tensors
nor falls back to another path.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.basics import resolve_device
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.ops import flash_attention as tfa
from horovod_tpu_torch.parallel import make_transformer_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "horovod_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "horovod_tpu"}


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_no_jax_or_reference_package_imports():
    files = _port_files()
    assert len(files) >= 15
    bad = [f"{os.path.relpath(p, ROOT)}:{line} imports {mod}"
           for p in files for line, mod in _imported_roots(p)
           if mod in FORBIDDEN]
    assert bad == []


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        f"for m in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[m] = None\n"
        "import horovod_tpu_torch\n"
        "import horovod_tpu_torch.models, horovod_tpu_torch.parallel\n"
        "import horovod_tpu_torch.ops.flash_attention\n"
        "import horovod_tpu_torch.ops._build\n"
        "import horovod_tpu_torch.checkpoint, horovod_tpu_torch.faults\n"
        "import horovod_tpu_torch.checkpointing.manager\n"
        "import horovod_tpu_torch.metrics, horovod_tpu_torch.callbacks\n"
        "print('imported', len([m for m in sys.modules\n"
        "                       if m.startswith('horovod_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("imported")


def test_launcher_and_elastic_import_with_jax_blocked(tmp_path):
    """The launcher and the elastic package (and every module they load)
    import with jax and the JAX package blocked, and none of the modules
    loaded is the JAX package's; --check-build runs so too."""
    code = (
        "import sys\n"
        f"for m in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[m] = None\n"
        "import horovod_tpu_torch as hvd\n"
        "import horovod_tpu_torch.runner, horovod_tpu_torch.elastic\n"
        "import horovod_tpu_torch.runner.run_task\n"
        "import horovod_tpu_torch.elastic.launcher\n"
        "import horovod_tpu_torch.sdc, horovod_tpu_torch.retry\n"
        "import horovod_tpu_torch._http\n"
        "from horovod_tpu_torch.elastic import TorchState, run\n"
        "assert hvd.elastic.TorchState is TorchState\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and m.split('.')[0] in ('horovod_tpu', 'jax', 'flax')]\n"
        "assert not bad, bad\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.startswith(('horovod_tpu_torch.runner',\n"
        "                              'horovod_tpu_torch.elastic'))))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    for mod in ("runner.launch", "runner.rendezvous", "runner.exec_run",
                "runner.api", "elastic.driver", "elastic.run",
                "elastic.state", "elastic.launcher", "elastic.worker"):
        assert f"'horovod_tpu_torch.{mod}'" in r.stdout, mod
    # the CLI: a site hook blocks the forbidden packages in the launcher
    # process itself
    block = str(tmp_path)
    with open(os.path.join(block, "sitecustomize.py"), "w") as f:
        f.write("import sys\n"
                f"for m in {sorted(FORBIDDEN)!r}:\n"
                "    sys.modules[m] = None\n")
    env = dict(os.environ, PYTHONPATH=block + os.pathsep + ROOT)
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "--check-build"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "horovod_tpu_torch v" in r.stdout and "PyTorch" in r.stdout


def test_cnn_zoo_and_benchmark_import_with_jax_blocked():
    code = (
        "import sys\n"
        f"for m in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[m] = None\n"
        "import horovod_tpu_torch.models.resnet\n"
        "import horovod_tpu_torch.models.vgg\n"
        "import horovod_tpu_torch.models.inception\n"
        "import horovod_tpu_torch.models.mlp\n"
        "import horovod_tpu_torch.models.layers\n"
        "import horovod_tpu_torch.benchmark, horovod_tpu_torch.bench\n"
        "from horovod_tpu_torch.models import ResNet50\n"
        "print(sum(p.numel() for p in ResNet50(device='meta')"
        ".parameters()))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "25557032"


def test_cnn_models_run_on_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from horovod_tpu_torch import models
    for build in (models.ResNet18, models.VGG11, models.InceptionV3,
                  models.MLP):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = TransformerConfig(vocab_size=64, num_layers=1, d_model=32,
                            num_heads=2, head_dim=16, max_seq_len=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_transformer_train_step(cfg)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_wrapper_refuses_cpu_tensors():
    q = torch.randn(2, 16, 16)
    before = dict(tfa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_fwd_cuda(q, q, q)
    assert tfa.LAUNCHES == before


def test_kernel_path_has_no_fallback():
    """No try/except in the flash module (a failing launch or build
    raises), and no library attention call anywhere in the package."""
    src = open(tfa.__file__).read()
    assert not [n for n in ast.walk(ast.parse(src))
                if isinstance(n, ast.Try)]
    for path in _port_files():
        if path.endswith("chip_smoke.py"):
            continue  # times the library call as a yardstick only
        assert "scaled_dot_product_attention" not in open(path).read(), path


def test_sequence_parallel_attention_has_no_fallback():
    """Ring attention, Ulysses and their send/recv catch nothing: on a
    CUDA tensor each step launches the kernel or raises."""
    for name in ("ring_attention", "ulysses", "comm"):
        path = os.path.join(PKG, "parallel", f"{name}.py")
        tree = ast.parse(open(path).read(), path)
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_cuda_source_and_build_recipe():
    from horovod_tpu_torch.ops import _build
    for name, src in _build.SOURCES.items():
        assert os.path.exists(os.path.join(PKG, "ops", "csrc", src))
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert os.path.relpath(_build.BUILD_DIR, ROOT) == os.path.join(
        "build", "torch_kernels")
    assert _build.library_path("flash_fwd").startswith(_build.BUILD_DIR)


def test_sharded_step_has_no_fallback():
    """The sharded forward, its collectives and the mesh step catch
    nothing: a failed gather, sum or kernel launch raises."""
    for rel in (("parallel", "train.py"), ("models", "transformer.py"),
                ("models", "convert.py")):
        path = os.path.join(PKG, *rel)
        tree = ast.parse(open(path).read(), path)
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], rel
    path = os.path.join(PKG, "parallel", "mesh_utils.py")
    tree = ast.parse(open(path).read(), path)
    sharding = [n for n in tree.body if getattr(n, "name", None) in (
        "MeshSharding", "param_shardings", "grad_process_sets",
        "tensor_parallel_blocks", "tensor_parallel_local")]
    assert len(sharding) == 5
    assert not [n for node in sharding for n in ast.walk(node)
                if isinstance(n, ast.Try)]


def test_estimator_and_sdc_modules_import_with_jax_blocked():
    """The Estimator slice (data, callbacks, the SDC plane, the autotuner,
    the serving buckets, the mpirun and jsrun routes) imports with jax and
    the JAX package blocked and loads none of them."""
    code = (
        "import sys\n"
        f"for m in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[m] = None\n"
        "import horovod_tpu_torch as hvd\n"
        "import horovod_tpu_torch.data, horovod_tpu_torch.callbacks\n"
        "import horovod_tpu_torch.estimator, horovod_tpu_torch._schedule\n"
        "import horovod_tpu_torch.sdc.guard, horovod_tpu_torch.sdc.policy\n"
        "import horovod_tpu_torch.sdc.fingerprint\n"
        "import horovod_tpu_torch.parameter_manager\n"
        "import horovod_tpu_torch.serving.batcher\n"
        "import horovod_tpu_torch.runner.mpi_run\n"
        "import horovod_tpu_torch.runner.lsf\n"
        "assert hvd.Estimator is horovod_tpu_torch.estimator.Estimator\n"
        "assert hvd.callbacks.MetricAverageCallback\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and m.split('.')[0] in ('horovod_tpu', 'jax', 'flax',\n"
        "                               'optax')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_estimator_and_prefetch_default_to_cuda_and_raise_without():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from horovod_tpu_torch import data
    from horovod_tpu_torch.estimator import Estimator
    model = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Estimator(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data.prefetch_to_device(iter([]))
    # asked for the card, there is none: raise, never stage on the host
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.PrefetchIterator(iter([]), device="cuda")
    assert Estimator(model, device="cpu").device == torch.device("cpu")


def test_guard_and_fingerprint_stay_on_the_device(monkeypatch):
    """The step guard and the fingerprint fold never copy a tensor to the
    host: no .cpu(), .numpy() or .to() of a gradient or parameter; each
    reads one host value list (one sync) and is otherwise device work, so
    on CUDA tensors nothing falls back to a host check."""
    from horovod_tpu_torch import sdc
    grads = {"a": torch.randn(64, 8), "b": torch.randn(8)}
    grads["a"][3, 1] = float("nan")
    calls = {"tolist": 0}
    tolist = torch.Tensor.tolist

    def counting_tolist(self):
        calls["tolist"] += 1
        return tolist(self)

    def refuse(*a, **k):
        raise AssertionError("a host copy")
    monkeypatch.setattr(torch.Tensor, "tolist", counting_tolist)
    for name in ("cpu", "numpy", "item"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    det = sdc.StepGuard(sync=lambda c: c).check(grads, torch.tensor(1.0))
    assert det == sdc.Detection("nonfinite", True)
    assert calls["tolist"] == 1
    sdc.fold_fingerprint(grads)
    assert calls["tolist"] == 2
    src = open(os.path.join(PKG, "sdc", "guard.py")).read() + open(
        os.path.join(PKG, "sdc", "fingerprint.py")).read()
    assert "np.asarray" not in src and ".numpy()" not in src


def test_prefetch_and_guard_paths_catch_nothing():
    """A failed copy, event wait or reduction raises: the prefetcher's
    staging, the guard and the fingerprint fold have no try/except of
    their own (the worker thread re-raises a source's error on the
    consumer)."""
    for rel, names in ((("data.py",), ("_stage", "__next__")),
                       (("sdc", "guard.py"), ("_grads_ok", "check",
                                              "guard_update")),
                       (("sdc", "fingerprint.py"), ("_leaf_sums",))):
        path = os.path.join(PKG, *rel)
        tree = ast.parse(open(path).read(), path)
        fns = [n for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef) and n.name in names]
        assert len(fns) == len(names), rel
        assert not [n for f in fns for n in ast.walk(f)
                    if isinstance(n, ast.Try)], rel


def test_autotune_flag_is_no_longer_a_silent_no_op():
    """``--autotune`` reaches a ParameterManager that the optimizer
    feeds, and the threshold it adopts re-plans the buckets."""
    from horovod_tpu_torch.runner import config_parser, launch
    args = launch.parse_args(["--autotune", "python", "x.py"])
    env = config_parser.set_env_from_args({}, args)
    from horovod_tpu_torch import config
    overrides = {k[len("HVD_TPU_"):]: config._REGISTRY[
        k[len("HVD_TPU_"):]].parser(v) for k, v in env.items()
        if k.startswith("HVD_TPU_AUTOTUNE")}
    assert overrides["AUTOTUNE"] is True
    hvd.init(device="cpu", config_overrides=dict(
        overrides, AUTOTUNE_WARMUP_SAMPLES=0, AUTOTUNE_STEPS_PER_SAMPLE=1))
    try:
        pm = hvd.basics.world().parameter_manager
        assert pm is not None and pm.active
        model = torch.nn.Linear(4, 2)
        opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                       lr=0.1))
        for _ in range(2):
            model(torch.ones(1, 4)).sum().backward()
            opt.step()
        assert pm._samples_done == 2
        assert [t for t, _ in opt.plans] == [64 << 20, 1 << 22, 1 << 24]
    finally:
        hvd.shutdown()


def test_compiled_plane_modules_import_with_jax_blocked():
    """The compiled-plane reductions (int8, the packed planner, Adasum over
    groups, the ("cross", "local") mesh) and the compiled autotuner import
    with jax and the JAX package blocked and load none of them."""
    code = (
        "import sys\n"
        f"for m in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[m] = None\n"
        "import horovod_tpu_torch as hvd\n"
        "import horovod_tpu_torch.compiled_autotune\n"
        "from horovod_tpu_torch.compression import int8_pack_reduce\n"
        "from horovod_tpu_torch.fusion import packed_plan, packed_apply\n"
        "from horovod_tpu_torch.adasum import adasum_grads\n"
        "from horovod_tpu_torch.mesh import cross_local_mesh, flat_group\n"
        "from horovod_tpu_torch.models.convert import "
        "int8_residual_from_flax\n"
        "assert hvd.compiled_autotune.tune_distributed_step\n"
        "assert hvd.Compression.int8.stateful\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and m.split('.')[0] in ('horovod_tpu', 'jax', 'flax',\n"
        "                               'optax')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_compiled_plane_reduction_catches_nothing():
    """A failed wire call or reduction on the compiled plane raises: the
    optimizer's reduction, int8, Adasum over groups and the mesh's wire
    calls have no try/except of their own."""
    for rel, names in (
            (("optimizer.py",), ("synchronize", "_reduce", "_reduce_bucket",
                                 "_mean")),
            (("compression.py",), ("int8_pack_reduce", "true_divide")),
            (("adasum.py",), ("adasum_grads",)),
            (("mesh.py",), ("cross_local_mesh", "flat_group",
                            "group_allreduce", "group_allgather")),
            (("fusion.py",), ("packed_apply", "flatten_bucket"))):
        path = os.path.join(PKG, *rel)
        tree = ast.parse(open(path).read(), path)
        fns = [n for n in ast.walk(tree)
               if isinstance(n, ast.FunctionDef) and n.name in names]
        assert {f.name for f in fns} == set(names), rel
        assert not [n for f in fns for n in ast.walk(f)
                    if isinstance(n, ast.Try)], rel
