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
