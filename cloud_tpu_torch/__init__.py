"""cloud_tpu_torch: the PyTorch/CUDA port of ``cloud_tpu`` for one NVIDIA H100.

The package mirrors ``cloud_tpu``'s layout module for module.  Its hot
attention kernels are hand-written CUDA C++ for ``sm_90a`` under
``ops/csrc/``, built with ``nvcc`` at first use; plain PyTorch versions
of the same functions serve tensors that lie on the CPU (the tests).

The root re-exports the reference root's public surface
(``cloud_tpu/__init__.py``): the machine configs eagerly, ``run``,
``remote``, ``RunReport``, ``CloudTuner``, ``CloudOracle`` and
``cloud_fit`` lazily.  Submodules load lazily so ``import
cloud_tpu_torch`` stays cheap.
"""

from __future__ import annotations

import importlib

from cloud_tpu_torch.version import __version__
from cloud_tpu_torch.core.machine_config import (
    AcceleratorType,
    COMMON_MACHINE_CONFIGS,
    MachineConfig,
    TpuTopology,
    TPU_SLICE_CATALOG,
    is_tpu_config,
)

__all__ = [
    "__version__",
    "AcceleratorType",
    "COMMON_MACHINE_CONFIGS",
    "MachineConfig",
    "TpuTopology",
    "TPU_SLICE_CATALOG",
    "is_tpu_config",
]

_SUBMODULES = ("bridge", "core", "fleet", "models", "monitoring", "ops",
               "parallel", "random", "serving", "training", "tuner", "utils")


def __getattr__(name):
    if name in ("run", "remote", "RunReport"):
        from cloud_tpu_torch.core import run as _run

        return getattr(_run, name)
    if name in ("CloudTuner", "CloudOracle"):
        from cloud_tpu_torch import tuner as _tuner

        return getattr(_tuner, name)
    if name == "cloud_fit":
        from cloud_tpu_torch.cloud_fit import client as _client

        return _client.cloud_fit
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module 'cloud_tpu_torch' has no attribute {name!r}")
