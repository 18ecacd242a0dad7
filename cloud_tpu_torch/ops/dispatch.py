"""Build, load and count the port's hand-written CUDA kernels.

Every kernel library is one ``.cu`` file under ``ops/csrc/`` with a plain
C interface (it may include the ``.cuh`` headers beside it).  At first
use it is compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``cloud_tpu_torch/build/`` (named by a hash of the source, the headers
and the flags, so an edited source or header rebuilds and an unchanged
one is reused) and loaded with ``ctypes``.  Pointers and the
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
"""

from __future__ import annotations

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


def library_path(name: str) -> str:
    """Where library ``name`` is (or will be) built."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for source in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC_DIR, source), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def _build(name: str) -> str:
    out = library_path(name)
    if os.path.exists(out):
        build_seconds[name] = 0.0
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
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


def count_launch(name: str) -> None:
    """One more launch of kernel ``name`` (one of :data:`KERNELS`).  Under
    a lock: the engine's warmup worker launches beside its scheduler."""
    with _lock:
        _counts[name] += 1


def launch_counts(names: Optional[Iterable[str]] = None) -> Dict[str, int]:
    """Launches per kernel since the last reset: of every kernel, or only
    of ``names`` (an unknown name raises ``KeyError``)."""
    if names is None:
        return dict(_counts)
    return {name: _counts[name] for name in names}


def reset_launch_counts() -> None:
    for name in _counts:
        _counts[name] = 0
