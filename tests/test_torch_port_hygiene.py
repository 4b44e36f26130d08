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


def test_native_runtime_stands_alone(tmp_path):
    """The port's native runtime (``_native/``) imports with jax and the
    JAX package blocked, builds from its own sources, and a port world
    that drives every consumer maps the port's library and never the JAX
    package's ``horovod_tpu/_native/_libhvdtpu.so``."""
    assert os.path.isdir(os.path.join(PKG, "_native", "csrc"))
    code = (
        "import sys\n"
        f"for m in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[m] = None\n"
        "import os, torch\n"
        "import horovod_tpu_torch as hvd\n"
        "from horovod_tpu_torch import _native, timeline\n"
        "from horovod_tpu_torch._native import build\n"
        "assert build.CSRC.startswith(os.path.dirname(_native.__file__))\n"
        "hvd.init(device='cpu')\n"
        "hvd.allreduce(torch.ones(4), name='x')\n"
        "tl = timeline.Timeline(sys.argv[1]); tl.start('x', 'allreduce')\n"
        "tl.close()\n"
        "hvd.shutdown()\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(_native.available(), _native.path)\n"
        "assert 'horovod_tpu/_native' not in maps\n"
        "if _native.available():\n"
        "    assert _native.path in maps\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code,
                        str(tmp_path / "tl.json")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    assert "torch_native" in r.stdout or r.stdout.startswith("False")


def test_check_build_prints_the_native_core_rows():
    from horovod_tpu_torch import _native
    from horovod_tpu_torch.runner import launch
    out = launch.check_build()
    mark = "X" if _native.available() else " "
    assert "Native Core (C++):" in out
    assert f"    [{mark}] tensor table / fusion planner / response cache " \
        "/ wire" in out
    assert f"    [{mark}] timeline writer / stall tracker / GP-BO " \
        "autotuner" in out


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


def test_backward_kernel_source_is_built():
    """``csrc/flash_bwd.cu`` is a source of its own, built by the same
    recipe into ``BUILD_DIR``; the Hopper helpers both kernels include
    are hashed into every library's name."""
    from horovod_tpu_torch.ops import _build
    assert _build.SOURCES["flash_bwd"] == "flash_bwd.cu"
    csrc = os.path.join(PKG, "ops", "csrc")
    assert os.path.exists(os.path.join(csrc, "flash_bwd.cu"))
    assert os.path.exists(os.path.join(csrc, "flash_common.cuh"))
    path = _build.library_path("flash_bwd")
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("flash_bwd-")
    assert path != _build.library_path("flash_fwd")


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


def test_autotune_flag_is_no_longer_a_silent_no_op(monkeypatch):
    """``--autotune`` reaches a ParameterManager that the optimizer
    feeds, and the threshold it adopts re-plans the buckets. The tuner is
    pinned to its Python optimizer, whose first proposals (a grid) do not
    depend on the measured times; test_torch_port_native holds the native
    GP/BO's first proposal on this path."""
    from horovod_tpu_torch import parameter_manager
    monkeypatch.setattr(parameter_manager, "_native_get", lambda: None)
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


def test_generation_and_disagg_import_with_jax_blocked():
    """The generation plane (paged cache, threefry, scheduler, spec,
    engine), the disagg wire and pull, and the server with its
    generation routes import with jax and the JAX package blocked and
    load none of them."""
    code = (
        "import sys\n"
        f"for m in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[m] = None\n"
        "import horovod_tpu_torch.serving.generation as gen\n"
        "import horovod_tpu_torch.serving.disagg as disagg\n"
        "from horovod_tpu_torch.serving import GenerationEngine, "
        "InferenceServer\n"
        "from horovod_tpu_torch.serving.generation import _threefry\n"
        "from horovod_tpu_torch.models.transformer import PagedCache\n"
        "assert gen.ContinuousBatcher and gen.build_verify_program\n"
        "assert disagg.pack_blocks and disagg.pull_and_import\n"
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


def test_generation_engine_defaults_to_cuda_and_raises_without():
    from horovod_tpu_torch.serving.generation import GenerationEngine
    from horovod_tpu_torch.serving.generation.kv_cache import make_pools
    cfg = TransformerConfig(vocab_size=17, num_layers=1, d_model=8,
                            num_heads=2, head_dim=4, max_seq_len=16)
    model = Transformer(cfg, device="meta")
    params = {n: torch.zeros(p.shape) for n, p in model.named_parameters()}
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(model, params=params, num_blocks=4, block_size=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_pools(cfg, 4, 4)
    with GenerationEngine(model, params=params, num_blocks=4, block_size=4,
                          device="cpu") as eng:
        assert eng.device.type == "cpu"


def test_scheduler_step_has_no_cpu_retry():
    """No ``except`` in the scheduler or the programs turns a device
    failure into a retry on the CPU or on a plain version: a handler
    names no CPU device and moves no tensor to the host, and the
    programs catch nothing at all."""
    path = os.path.join(PKG, "serving", "generation", "scheduler.py")
    tree = ast.parse(open(path).read(), path)
    handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    assert handlers
    for h in handlers:
        src = ast.get_source_segment(open(path).read(), h)
        assert "cpu" not in src.lower(), src
        assert ".to(" not in src and "numpy" not in src, src
    for rel in (("serving", "generation", "kv_cache.py"),
                ("serving", "generation", "_threefry.py"),
                ("models", "transformer.py")):
        p = os.path.join(PKG, *rel)
        t = ast.parse(open(p).read(), p)
        assert not [n for n in ast.walk(t) if isinstance(n, ast.Try)], rel


def test_fleet_and_microbench_import_with_jax_blocked():
    """The serving fleet (router, tenancy, rollout) and the microbench
    import with jax and the JAX package blocked and load none of them;
    the fleet exports the JAX package's names."""
    code = (
        "import sys\n"
        f"for m in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[m] = None\n"
        "import horovod_tpu_torch.serving.fleet as fleet\n"
        "import horovod_tpu_torch.microbench as mb\n"
        "from horovod_tpu_torch import serving\n"
        "from horovod_tpu_torch.serving.disagg import transfer\n"
        "from horovod_tpu_torch.serving import server\n"
        "names = ('FleetRouter', 'ReplicaHeartbeat', 'REQUEST_ID_HEADER',\n"
        "         'FairScheduler', 'Tenant', 'TenantQuotaError',\n"
        "         'TenantRegistry', 'API_KEY_HEADER', 'TENANT_HEADER',\n"
        "         'RolloutAborted', 'rolling_reload')\n"
        "assert all(hasattr(fleet, n) for n in names)\n"
        "assert serving.fleet is fleet and mb.SECTIONS\n"
        "assert transfer.REQUEST_ID_HEADER is fleet.REQUEST_ID_HEADER\n"
        "assert server.REQUEST_ID_HEADER == fleet.REQUEST_ID_HEADER\n"
        "assert fleet.REQUEST_ID_HEADER == 'X-HVD-TPU-Request-Id'\n"
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


def test_microbench_command_defaults_to_cuda_and_raises_without():
    """``python -m horovod_tpu_torch.microbench`` runs on the card unless
    ``--device cpu`` is given: without a card it raises and prints no
    section line, and its sections' device defaults raise too."""
    from horovod_tpu_torch import microbench
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m", "horovod_tpu_torch.microbench",
                        "--sections", "tracing"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "CUDA" in r.stderr
    assert '"section"' not in r.stdout
    with pytest.raises(RuntimeError, match="CUDA"):
        microbench.resume_sweep(emitted=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        microbench.sdc_guard_sweep(steps=1, rounds=1)


FRONTENDS = ("torch", "torch.elastic", "torch.sync_batch_norm",
             "tensorflow", "tensorflow.elastic", "tensorflow.keras",
             "keras", "keras.callbacks", "mxnet", "spark", "spark.store",
             "spark.estimator", "spark.torch", "spark.keras",
             "runner.driver_service")


def test_frontends_import_with_jax_blocked():
    """Every framework frontend imports with jax and the JAX package
    blocked and loads none of them; ``import horovod_tpu_torch`` alone
    loads no tensorflow, keras, mxnet or pyspark, and the frontends that
    need none of those load none either."""
    code = (
        "import sys\n"
        f"for m in {sorted(FORBIDDEN)!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        "import horovod_tpu_torch\n"
        "heavy = ('tensorflow', 'keras', 'mxnet', 'pyspark')\n"
        "def loaded():\n"
        "    return sorted(m for m in heavy if m in sys.modules)\n"
        "assert loaded() == [], loaded()\n"
        "for name in ('torch', 'torch.elastic', 'torch.sync_batch_norm',\n"
        "             'tensorflow', 'tensorflow.elastic', 'mxnet', 'spark',\n"
        "             'spark.store', 'spark.estimator', 'spark.torch',\n"
        "             'runner.driver_service'):\n"
        "    importlib.import_module('horovod_tpu_torch.' + name)\n"
        "assert loaded() == [], loaded()\n"
        "import torch\n"
        "assert 'site-packages' in torch.__file__, torch.__file__\n"
        "try:\n"
        "    import tensorflow\n"
        "except ImportError:\n"
        "    tensorflow = None\n"
        "if tensorflow is not None:\n"
        "    for name in ('keras', 'keras.callbacks', 'tensorflow.keras',\n"
        "                 'spark.keras'):\n"
        "        importlib.import_module('horovod_tpu_torch.' + name)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and m.split('.')[0] in ('horovod_tpu', 'jax', 'flax',\n"
        "                               'optax')]\n"
        "assert not bad, bad\n"
        "print('ok', tensorflow is not None)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, TF_CPP_MIN_LOG_LEVEL="3")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.startswith("ok")
    for name in FRONTENDS:
        rel = name.replace(".", os.sep)
        assert os.path.exists(os.path.join(PKG, rel + ".py")) or \
            os.path.exists(os.path.join(PKG, rel, "__init__.py")), name


def test_frontend_entry_points_run_on_cuda_unless_asked():
    """The Spark TorchEstimator and TorchModel hold tensors of their own:
    on a box without a card they raise unless given device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from horovod_tpu_torch.spark.torch import TorchEstimator, TorchModel
    net = torch.nn.Linear(2, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchEstimator(model=net)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchModel(net, ["x"], ["y"])
    assert TorchEstimator(model=net, device="cpu").device.type == "cpu"
