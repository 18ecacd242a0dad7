"""Input validation for the run() pipeline.

The port's copy of ``cloud_tpu/core/validate.py``: the same checks, the
same exception types and the same messages.

Reference analogue: ``src/python/tensorflow_cloud/core/validate.py``
(entry-point checks :87-114, strategy whitelist :117-124, cluster rules
:153-176, labels :179-181, notebook bucket :209-218).  TPU-native rule
changes:

* The chief **may** be (and by default is) a TPU slice — the reference
  forbade TPU chiefs because CAIP's ``cloud_tpu`` worker was a sidecar
  machine; on Cloud TPU VMs the training process runs *on* the slice.
* ``worker_count`` counts additional identical slices (multi-slice data
  parallelism over DCN), so TPU jobs are no longer capped at one worker.
* GPU configs are rejected with a migration hint instead of being the
  default path.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from cloud_tpu_torch.core import gcp, machine_config

VALID_DISTRIBUTION_STRATEGIES = ("auto", None)
_ENTRY_POINT_SUFFIXES = (".py", ".ipynb")


def validate(
    entry_point: Optional[str],
    requirements_txt: Optional[str],
    distribution_strategy: Optional[str],
    chief_config: machine_config.MachineConfig,
    worker_config: Optional[machine_config.MachineConfig],
    worker_count: int,
    entry_point_args: Optional[List[str]],
    stream_logs: bool,
    docker_image_build_bucket: Optional[str],
    called_from_notebook: bool,
    job_labels: Optional[Dict[str, str]] = None,
    service_account: Optional[str] = None,
) -> None:
    """Raise ValueError/NotImplementedError unless the job spec is launchable."""
    _validate_files(entry_point, requirements_txt, called_from_notebook)
    _validate_strategy(distribution_strategy)
    _validate_cluster(chief_config, worker_config, worker_count)
    gcp.validate_job_labels(job_labels)
    _validate_misc(entry_point_args, stream_logs, service_account)
    if called_from_notebook and not docker_image_build_bucket:
        # Notebook kernels have no local docker daemon worth assuming;
        # Cloud Build needs a bucket (reference validate.py:209-218).
        raise ValueError(
            "Called from a notebook: docker_image_build_bucket is required "
            "so the container can be built with Cloud Build."
        )


def _validate_files(entry_point, requirements_txt, called_from_notebook):
    if entry_point is None and not called_from_notebook:
        # Allowed: run() invoked from within the training script itself
        # (reference run.py:79-83 'script mode').
        return
    if entry_point is not None:
        if not os.path.isfile(entry_point):
            raise ValueError(f"entry_point not found: {entry_point!r}")
        if not entry_point.endswith(_ENTRY_POINT_SUFFIXES):
            raise ValueError(
                f"entry_point must be one of {_ENTRY_POINT_SUFFIXES}, got "
                f"{entry_point!r}"
            )
    if requirements_txt is not None and not os.path.isfile(requirements_txt):
        raise ValueError(f"requirements_txt not found: {requirements_txt!r}")


def _validate_strategy(distribution_strategy):
    if distribution_strategy not in VALID_DISTRIBUTION_STRATEGIES:
        raise ValueError(
            "distribution_strategy must be 'auto' (framework plans the "
            "mesh) or None (user script owns its mesh); got "
            f"{distribution_strategy!r}"
        )


def _validate_cluster(chief_config, worker_config, worker_count):
    if not isinstance(chief_config, machine_config.MachineConfig):
        raise ValueError(
            f"chief_config must be a MachineConfig, got {chief_config!r}"
        )
    if not isinstance(worker_count, int) or worker_count < 0:
        raise ValueError(f"worker_count must be an int >= 0, got {worker_count!r}")
    if chief_config.is_gpu():
        raise NotImplementedError(machine_config.gpu_migration_hint(chief_config))
    if worker_count > 0:
        if worker_config is None:
            raise ValueError("worker_count > 0 requires a worker_config")
        if not isinstance(worker_config, machine_config.MachineConfig):
            raise ValueError(
                f"worker_config must be a MachineConfig, got {worker_config!r}"
            )
        if worker_config.is_gpu():
            raise NotImplementedError(
                machine_config.gpu_migration_hint(worker_config)
            )
        if chief_config.is_tpu() and worker_config != chief_config:
            # Multi-slice jobs are homogeneous: DCN data parallelism needs
            # identical per-slice meshes.  (A CPU chief with TPU workers is
            # allowed — the single worker_config keeps slices homogeneous.)
            raise ValueError(
                "Multi-slice TPU jobs must be homogeneous: worker_config "
                f"({worker_config}) must equal chief_config ({chief_config})."
            )


def _validate_misc(entry_point_args, stream_logs, service_account):
    if entry_point_args is not None:
        if not isinstance(entry_point_args, list) or not all(
            isinstance(a, str) for a in entry_point_args
        ):
            raise ValueError(
                f"entry_point_args must be a list of str, got {entry_point_args!r}"
            )
    if not isinstance(stream_logs, bool):
        raise ValueError(f"stream_logs must be a bool, got {stream_logs!r}")
    if service_account is not None and "@" not in service_account:
        raise ValueError(
            f"service_account must be an email, got {service_account!r}"
        )
