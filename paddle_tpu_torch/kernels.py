"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which
``ctypes`` loads; no PyTorch headers are involved, so a build takes
seconds. Libraries go to ``paddle_tpu_torch/build/`` (git-ignored) under
a name that carries a digest of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and
concurrent processes never load a half-written file.

Launch counts: every wrapper adds one to ``launch_counts`` where it
launches its kernel (``count``), so that a CUDA graph replay, which runs
no Python, can add what its capture counted (core/lowering.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from typing import Dict, Optional, Tuple

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the package's kernels")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, f), "rb") as src:
            h.update(src.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def build(name: str) -> Optional[Tuple[str, float]]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Returns the compiler's output (ptxas' register and shared-memory
    report) and the build's wall seconds, or None when it was cached."""
    path = library_path(name)
    if os.path.exists(path):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, path)  # atomic: readers see a whole library or none
    return proc.stdout, time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib


def function(name: str, symbol: str, argtypes):
    """The C entry ``symbol`` of ``csrc/<name>.cu`` (built and loaded on
    first use), taking ``argtypes`` and returning a ``cudaError_t``."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(name: str, rc: int, what: str) -> None:
    """Raise when a C entry of ``csrc/<name>.cu`` returned a CUDA error."""
    if rc != 0:
        describe = load(name).pt_cuda_error_string
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(f"{what} launch failed: {describe(rc).decode()} "
                           f"(cudaError {rc})")


# Launch counts, {key: launches}, one dict for every wrapper: each adds one
# where it launches its kernel (``count``) and nowhere else. A CUDA graph's
# replay runs no Python, so the step runner adds at each replay what was
# counted while the step was captured (core/lowering.py).
launch_counts: Counter = Counter()


def count(key) -> None:
    """Add one to ``launch_counts[key]``."""
    launch_counts[key] += 1


def reset_counts() -> None:
    """Set every launch count to 0."""
    launch_counts.clear()
