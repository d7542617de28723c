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
no Python, can add what its capture counted (core/lowering.py). Several
threads launch (the replicas of a serving fleet): the counts change
under a lock, a capture counts only its own thread's launches
(``recording``), and two threads that need one library build it once.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from typing import Dict, Optional, Tuple

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
# one lock a source, made under the module lock: a thread that builds or
# loads a library holds its source's lock, so sources build in parallel
# and one source builds once
_LOCK = threading.Lock()
_source_locks: Dict[str, threading.RLock] = {}


def _source_lock(name: str) -> "threading.RLock":
    with _LOCK:
        return _source_locks.setdefault(name, threading.RLock())


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
    with _source_lock(name):
        path = library_path(name)
        if os.path.exists(path):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        # the process and the thread: no other build writes this file
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC_DIR, name + ".cu")],
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
        with _source_lock(name):
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
# counted while the step was captured (core/lowering.py). Written under
# _COUNTS_LOCK; read one key at a time.
launch_counts: Counter = Counter()
_COUNTS_LOCK = threading.Lock()
_recording = threading.local()
# a recording thread's counter, lent to the threads that launch on its
# behalf while it waits for them (``lend_recording``)
_lent: Optional[Counter] = None


def count(key) -> None:
    """Add one to ``launch_counts[key]``, or to the calling thread's
    ``recording`` counter while it records (or to the counter a waiting
    recording thread lent)."""
    rec = getattr(_recording, "counter", None)
    if rec is None:
        rec = _lent
    if rec is not None:
        with _COUNTS_LOCK:
            rec[key] += 1
        return
    with _COUNTS_LOCK:
        launch_counts[key] += 1


@contextlib.contextmanager
def lend_recording():
    """While the calling thread records (a capture) and waits for other
    threads that launch kernels on its behalf, count their launches into
    its recording: autograd runs a derived grad op's backward of CUDA
    tensors on its own device threads (the attention backward kernels of
    a ``scan_grad``), inside the capture. A capture holds the capture
    gate alone (core/lowering.py), so no other executor launches
    meanwhile."""
    global _lent
    rec = getattr(_recording, "counter", None)
    if rec is None:
        yield
        return
    prev, _lent = _lent, rec
    try:
        yield
    finally:
        _lent = prev


def add_counts(counts) -> None:
    """Add ``counts`` ({key: launches}) to ``launch_counts``."""
    with _COUNTS_LOCK:
        launch_counts.update(counts)


@contextlib.contextmanager
def recording():
    """Count the calling thread's launches into a Counter of their own
    (yielded) instead of ``launch_counts``: a capture's launches, which
    its replays add. Launches of other threads meanwhile are counted as
    always."""
    prev = getattr(_recording, "counter", None)
    rec: Counter = Counter()
    _recording.counter = rec
    try:
        yield rec
    finally:
        _recording.counter = prev


def reset_counts() -> None:
    """Set every launch count to 0."""
    with _COUNTS_LOCK:
        launch_counts.clear()
