"""Build, load and count the port's hand-written CUDA kernels.

Every kernel library is one ``.cu`` file under ``ops/csrc/`` with a plain
C interface (it may include the ``.cuh`` headers beside it).  At first
use it is compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``cloud_tpu_torch/build/`` (named by a hash of the source, the headers,
the flags and the ``nvcc`` version, so an edited source or header, or
another toolkit, rebuilds and an unchanged one is reused) and loaded with
``ctypes``.  ``training.compile_cache.maybe_enable_persistent_cache``
moves the build directory to ``CLOUD_TPU_COMPILE_CACHE``'s
(:func:`set_build_dir`), so that a fresh process or container finds its
libraries built.  Pointers and the
stream cross the boundary as ``c_void_p``; every C entry point returns
``cudaGetLastError()`` after its launch, which :func:`check` turns into
an exception.

Nothing here runs at import time: importing the package on a host with
no ``nvcc`` and no card touches neither.

The launch counters live here too, one per kernel (a library may hold
several: ``group_norm`` holds K1-K4, ``flash_bwd`` K6 and K7,
``paged_attention`` K8 and K8q).  A kernel wrapper calls
:func:`count_launch` exactly where it launches its kernel (never on the
plain CPU path), so a run can show that its main path went through the
kernels: reset the counts, drive the path, read the counts of the
kernels that path runs.

A CUDA graph launches nothing while it is captured and every captured
kernel each time it replays.  So while :func:`capturing_launches` holds a
stream, a launch made on that stream goes to the capture's own record
instead (from any thread: autograd runs a captured backward on its own
worker thread, on the capture stream), and :func:`replay_launches` adds
that record once per replay (``training/train.py``'s ``make_multi_step``).
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
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

#: Kernel library name -> its source file under ``ops/csrc``.
SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd": "flash_bwd.cu",
    "paged_attention": "paged_attention.cu",
    "group_norm": "group_norm.cu",
}

#: Kernel names, one launch counter each: K5 in its own library, K8 and
#: its int8 variant K8q both in ``paged_attention``, K6/K7 (flash
#: backward) both in ``flash_bwd``, K1-K4 (GroupNorm) all in
#: ``group_norm``.
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_attention",
           "paged_attention_int8", "gn_fwd", "gn_fwd_res", "gn_bwd",
           "gn_bwd_res")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-lineinfo",
)

_lock = threading.Lock()
#: Where libraries are built and loaded from (:func:`set_build_dir`).
_build_dir = BUILD_DIR
_nvcc_version: Optional[str] = None
_libs: Dict[str, ctypes.CDLL] = {}
_counts: Dict[str, int] = {name: 0 for name in KERNELS}
#: Seconds each library took to build (0.0 when reused from the cache).
build_seconds: Dict[str, float] = {}
#: ``nvcc`` output of the last build of each library (``-Xptxas -v``).
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (its release and build), or
    ``"none"`` on a host without ``nvcc``; read once a process."""
    global _nvcc_version
    if _nvcc_version is None:
        try:
            proc = subprocess.run([nvcc_path(), "--version"],
                                  capture_output=True, text=True, timeout=60)
            lines = proc.stdout.strip().splitlines()
            _nvcc_version = lines[-1].strip() if lines else "unknown"
        except (RuntimeError, OSError, subprocess.SubprocessError):
            _nvcc_version = "none"
    return _nvcc_version


def build_dir() -> str:
    """The directory libraries are built into and loaded from."""
    return _build_dir


def set_build_dir(path: Optional[str]) -> None:
    """Build and load libraries under ``path`` from now on (``None``: the
    package's own ``build/``).  A library already loaded stays loaded."""
    global _build_dir
    _build_dir = BUILD_DIR if path is None else os.path.abspath(path)


def library_path(name: str) -> str:
    """Where library ``name`` is (or will be) built."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for source in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC_DIR, source), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest.update(nvcc_version().encode())
    return os.path.join(_build_dir,
                        f"lib{name}_{digest.hexdigest()[:16]}.so")


def _build(name: str) -> str:
    out = library_path(name)
    if os.path.exists(out):
        build_seconds[name] = 0.0
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
           os.path.join(CSRC_DIR, SOURCES[name])]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - start
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {SOURCES[name]} (exit {proc.returncode}):\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every kernel library at once, one ``nvcc`` per source, all
    started together.  Returns the build seconds per library."""
    names = list(SOURCES if names is None else names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(load, names))
    return {n: build_seconds.get(n, 0.0) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = _build(name)
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(path)
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = getattr(_libs[name], f"{name}_error_string")(code)
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {code} "
            f"({msg.decode() if msg else 'unknown'})"
        )


#: Capture stream (its ``cuda_stream`` handle) -> the record of the CUDA
#: graph capture in progress on it.
_captures: Dict[int, Dict[str, int]] = {}


def _current_stream() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream


def count_launch(name: str) -> None:
    """One more launch of kernel ``name`` (one of :data:`KERNELS`).  Under
    a lock: the engine's warmup worker launches beside its scheduler.  A
    launch on a stream under :func:`capturing_launches` goes to the
    capture's record: the kernel runs when the graph replays."""
    with _lock:
        record = _captures.get(_current_stream()) if _captures else None
        if record is not None:
            record[name] = record.get(name, 0) + 1
        else:
            _counts[name] += 1


@contextlib.contextmanager
def capturing_launches(stream: int):
    """Around a CUDA graph capture on ``stream`` (a ``cuda_stream``
    handle): launches on it inside the block are recorded in the yielded
    dict (kernel -> launches a replay) and not counted."""
    record: Dict[str, int] = {}
    with _lock:
        _captures[stream] = record
    try:
        yield record
    finally:
        with _lock:
            del _captures[stream]


def replay_launches(record: Dict[str, int]) -> None:
    """Count one replay of a graph whose capture recorded ``record``."""
    with _lock:
        for name, n in record.items():
            _counts[name] += n


def launch_counts(names: Optional[Iterable[str]] = None) -> Dict[str, int]:
    """Launches per kernel since the last reset: of every kernel, or only
    of ``names`` (an unknown name raises ``KeyError``)."""
    if names is None:
        return dict(_counts)
    return {name: _counts[name] for name in names}


def reset_launch_counts() -> None:
    for name in _counts:
        _counts[name] = 0
