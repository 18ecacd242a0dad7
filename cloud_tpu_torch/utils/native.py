"""Loader for the port's host C++ libraries (ctypes; the port's copy of
``cloud_tpu/utils/native.py``).

A native component (``training/cpp``, the records pipeline's crc32c and
frame scanner) keeps its sources and Makefile next to the package; the
``.so`` is git-ignored and built lazily (``make`` on first use when
missing or stale), and every failure degrades to the caller's
pure-Python fallback.  These are host libraries, not device kernels
(those are ``ops/dispatch.py``'s).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional

logger = logging.getLogger(__name__)


def lib_stale(cpp_dir: str, lib_path: str) -> bool:
    """True when the .so is missing or older than any source/Makefile.

    Compares mtimes in-process so the steady state never pays a make
    subprocess (concurrent workers only race on make when a rebuild is
    genuinely needed).
    """
    if not os.path.exists(lib_path):
        return True
    lib_mtime = os.path.getmtime(lib_path)
    for name in os.listdir(cpp_dir):
        if name.endswith((".cc", ".h", "Makefile")):
            if os.path.getmtime(os.path.join(cpp_dir, name)) > lib_mtime:
                return True
    return False


def load_native_lib(cpp_dir: str, lib_name: str, *,
                    what: str = "native library",
                    timeout: float = 120.0) -> Optional[ctypes.CDLL]:
    """Build-if-stale then load ``cpp_dir/lib_name``; None on any failure
    (including a missing ``cpp_dir`` — source-less installs fall back to
    pure Python)."""
    lib_path = os.path.join(cpp_dir, lib_name)
    try:
        if lib_stale(cpp_dir, lib_path):
            try:
                subprocess.run(
                    ["make", "-C", cpp_dir, lib_name],
                    check=True, capture_output=True, timeout=timeout,
                )
            except Exception as e:  # noqa: BLE001 — stale-load or fallback
                if not os.path.exists(lib_path):
                    logger.info("%s build unavailable (%s); using "
                                "pure-Python fallback", what, e)
                    return None
                logger.info("%s rebuild failed (%s); loading stale "
                            "library", what, e)
        return ctypes.CDLL(lib_path)
    except OSError as e:
        logger.info("could not load %s (%s)", lib_path, e)
        return None
