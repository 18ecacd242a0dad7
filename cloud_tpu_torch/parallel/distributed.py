"""Multi-process initialization (port of ``cloud_tpu/parallel/distributed.py``).

The JAX package calls ``jax.distributed.initialize`` from the
``CLOUD_TPU_*`` variables below or, on a TPU VM pod, from the TPU
metadata.  The port reads the same variables and calls
``torch.distributed.init_process_group`` with a ``tcp://`` rendezvous at
the coordinator; the TPU-metadata route has no counterpart (no card host
publishes a topology), so a multi-process job sets the variables.

Env contract:

- ``CLOUD_TPU_COORDINATOR``    host:port of process 0
- ``CLOUD_TPU_NUM_PROCESSES``  total process count
- ``CLOUD_TPU_PROCESS_ID``     this process's rank
"""

from __future__ import annotations

import atexit
import datetime
import logging
import os
from typing import Optional

import torch.distributed as dist

from cloud_tpu_torch._device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

ENV_COORDINATOR = "CLOUD_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "CLOUD_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "CLOUD_TPU_PROCESS_ID"


def backend_for(device: DeviceLike = None) -> str:
    """The collectives backend a device implies: ``nccl`` for a card,
    ``gloo`` for the CPU (``device`` resolves as every entry point's:
    ``cuda`` unless the caller asks for the CPU)."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize_from_env(timeout_seconds: Optional[int] = None, *,
                        device: DeviceLike = None,
                        backend: Optional[str] = None) -> bool:
    """Initialize the default process group if this is a multi-process job.

    Returns True when the group exists (initialized here or before),
    False for a single-process job (no ``CLOUD_TPU_COORDINATOR``).
    Idempotent.  The backend is ``backend``, else the one ``device``
    implies (:func:`backend_for`; ranks that share a card name ``gloo``:
    NCCL refuses two ranks on one device).
    """
    if dist.is_initialized():
        return True
    coordinator = os.environ.get(ENV_COORDINATOR)
    if not coordinator:
        logger.debug("single-process run; skipping torch.distributed")
        return False
    num_processes = os.environ.get(ENV_NUM_PROCESSES)
    process_id = os.environ.get(ENV_PROCESS_ID)
    if not num_processes or not process_id:
        raise ValueError(
            f"{ENV_COORDINATOR} is set, so {ENV_NUM_PROCESSES} and "
            f"{ENV_PROCESS_ID} must be too (no metadata service supplies "
            "them off a TPU VM)"
        )
    kwargs = dict(backend=backend or backend_for(device),
                  init_method=f"tcp://{coordinator}",
                  world_size=int(num_processes), rank=int(process_id))
    if timeout_seconds is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_seconds)
    logger.info("torch.distributed.init_process_group(%s)", kwargs)
    dist.init_process_group(**kwargs)
    # A group still alive when the interpreter finalizes is destroyed with
    # its worker threads running, and the process aborts ("terminate
    # called without an active exception") instead of exiting.
    atexit.register(_destroy_at_exit)
    return True


def _destroy_at_exit() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_chief() -> bool:
    """Process 0 is the chief (checkpoint writer, log owner)."""
    return process_index() == 0
