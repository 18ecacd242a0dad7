"""cloud_tpu_torch: the PyTorch/CUDA port of ``cloud_tpu`` for one NVIDIA H100.

The package mirrors ``cloud_tpu``'s layout module for module.  Its hot
attention kernels are hand-written CUDA C++ for ``sm_90a`` under
``ops/csrc/``, built with ``nvcc`` at first use; plain PyTorch versions
of the same functions serve tensors that lie on the CPU (the tests).

Submodules load lazily so ``import cloud_tpu_torch`` stays cheap.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_SUBMODULES = ("bridge", "models", "ops", "serving", "utils")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module 'cloud_tpu_torch' has no attribute {name!r}")
