"""cloud_fit client: serialize in-memory training state, submit the job (port
of ``cloud_tpu/cloud_fit/client.py``).

Reference analogue: ``cloud_fit/client.py`` — guards (:87-101, :159-160),
asset serialization (:138-192), default job spec (:195-224), submission
(:227-286).  The submitted container re-enters through the standard
launcher pipeline with a generated shim entry point that calls
``cloud_tpu_torch.cloud_fit.remote.run`` — so cloud_fit rides the same
containerize/deploy path as the port's ``run()``, its
``parallelism_hints`` passed through to the mesh plan.
"""

from __future__ import annotations

import os
import tempfile
import textwrap
from typing import Any, Dict, List, Optional, Union

import numpy as np

from cloud_tpu_torch.cloud_fit import serialization
from cloud_tpu_torch.core import machine_config


def cloud_fit(
    trainer_spec: serialization.TrainerSpec,
    remote_dir: str,
    *,
    train_data: Dict[str, np.ndarray],
    validation_data: Optional[Dict[str, np.ndarray]] = None,
    callbacks: Optional[List[Any]] = None,
    chief_config: Union[str, machine_config.MachineConfig] = "auto",
    worker_count: int = 0,
    job_labels: Optional[Dict[str, str]] = None,
    docker_config=None,
    dry_run: bool = False,
    storage_client=None,
    _session=None,
    _builder=None,
    **fit_kwargs,
):
    """Serialize a TrainerSpec + data + callbacks and fit remotely.

    ``fit_kwargs`` pass through to ``Trainer.fit`` (epochs,
    steps_per_epoch, plus ``batch_size`` consumed by the remote runner).
    Returns the RunReport from the launcher pipeline.
    """
    _validate(trainer_spec, train_data, validation_data, fit_kwargs)
    serialization.serialize_assets(
        remote_dir,
        trainer_spec,
        train_data,
        validation_data=validation_data,
        callbacks=callbacks,
        fit_kwargs=fit_kwargs,
        storage_client=storage_client,
    )

    # Shim entry point: the remote container re-enters here and runs the
    # deserialized fit under the planned mesh (reference made remote.py the
    # ENTRYPOINT directly, cloud_fit.md dockerfile).
    shim = write_entry_shim(remote_dir)

    from cloud_tpu_torch.core import run as run_lib

    return run_lib.run(
        entry_point=shim,
        chief_config=chief_config,
        worker_config=chief_config if worker_count > 0 else "auto",
        worker_count=worker_count,
        job_labels=job_labels,
        docker_config=docker_config,
        parallelism_hints=trainer_spec.parallelism_hints,
        dry_run=dry_run,
        _session=_session,
        _builder=_builder,
    )


def write_entry_shim(remote_dir: str) -> str:
    """Write the container's entry point for ``remote_dir`` into a fresh
    temporary directory (the build context's source) and return its
    path: ``cloud_fit_entry.py``, which runs :func:`remote.run`."""
    shim_dir = tempfile.mkdtemp(prefix="cloud_fit_entry_")
    shim = os.path.join(shim_dir, "cloud_fit_entry.py")
    with open(shim, "w") as f:
        f.write(textwrap.dedent(f"""
            from cloud_tpu_torch.cloud_fit import remote

            remote.run(remote_dir={remote_dir!r})
        """))
    return shim


def _validate(trainer_spec, train_data, validation_data, fit_kwargs):
    if not isinstance(trainer_spec, serialization.TrainerSpec):
        raise ValueError(
            f"trainer_spec must be a TrainerSpec, got {type(trainer_spec)}"
        )
    batch_size = fit_kwargs.get("batch_size", 32)
    if batch_size <= 0:
        raise ValueError("batch_size must be positive")
    _validate_dataset("train_data", train_data, batch_size)
    if validation_data is not None:
        _validate_dataset("validation_data", validation_data, batch_size)


def _validate_dataset(name, data, batch_size):
    """Catch every remote-side ArrayDataset failure here, before a container
    is built and a TPU slice provisioned (the remote runner defaults
    batch_size to 32)."""
    if not isinstance(data, dict) or not all(
        isinstance(v, np.ndarray) for v in data.values()
    ):
        # The reference likewise rejected non-serializable dataset forms
        # (generators, client.py:159-160).
        raise ValueError(
            f"{name} must be a dict of numpy arrays (in-memory datasets "
            "are the serializable unit; for file-based data use run() with "
            "a training script)."
        )
    lengths = {k: len(v) for k, v in data.items()}
    if len(set(lengths.values())) > 1:
        raise ValueError(
            f"{name} arrays must all have the same leading dimension, "
            f"got {lengths}"
        )
    n = min(lengths.values()) if lengths else 0
    if batch_size > n:
        raise ValueError(
            f"batch_size {batch_size} exceeds the {name} size {n}; pass a "
            "smaller batch_size to cloud_fit()."
        )
