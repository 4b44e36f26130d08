"""Build the native host runtime from ``csrc/*.cc`` with the system C++
compiler at first use.

The library is small and has no dependencies, so it is built on demand,
keyed by a hash of the sources (the JAX package's key: each source's name
and bytes, sorted by name), into ``build/torch_native/`` at the root of the
checkout, beside ``ops/_build.py``'s ``build/torch_kernels/``: a fresh
checkout builds itself on first use, and an edited source is rebuilt at
its next one. ``CXX`` names the compiler (default ``g++``).
``HVD_TPU_NATIVE=0`` skips the library altogether (``_native.get()``
returns None and every consumer takes its pure-Python path).
"""

import hashlib
import os
import subprocess
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
_ROOT = os.path.dirname(os.path.dirname(_HERE))
BUILD_DIR = os.path.join(_ROOT, "build", "torch_native")

CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread",
             "-fvisibility=hidden")

#: seconds the last build() of this process spent compiling (0.0 when the
#: library was already there)
last_build_seconds = 0.0


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cc", ".hpp")))


def content_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def lib_path() -> str:
    return os.path.join(BUILD_DIR, f"_libhvdtpu_torch-{content_hash()}.so")


def build(force: bool = False) -> str:
    """Build (or reuse) the shared library; returns its path.

    Compiles into a temporary file in the build directory and renames it
    into place, so a process that loads the library concurrently (pytest's
    workers, a launched worker) never opens a half-written one. Raises
    RuntimeError when no working compiler is available."""
    global last_build_seconds
    lib = lib_path()
    if not force and os.path.exists(lib):
        last_build_seconds = 0.0
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    cxx = os.environ.get("CXX", "g++")
    srcs = [s for s in _sources() if s.endswith(".cc")]
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp] + srcs
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed to run {cxx}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"native build failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    last_build_seconds = time.perf_counter() - t0
    return lib
