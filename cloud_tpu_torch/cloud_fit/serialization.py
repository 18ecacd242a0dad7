"""Asset (de)serialization for cloud_fit (port of
``cloud_tpu/cloud_fit/serialization.py``, the same layout under
``remote_dir/training_assets``):

- ``trainer.pkl``      cloudpickle of the TrainerSpec (loss/optimizer/init
                       closures, logical axes, rules, hints)
- ``train_data.npz``   training arrays; ``validation_data.npz`` optional
- ``callbacks.pkl``    cloudpickled callback list
- ``fit_kwargs.json``  epochs / steps / batch size
- ``state/``           optional checkpoint of an existing TrainState
                       (``training.checkpoint.CheckpointManager``)

The spec's ``init_fn`` takes a ``torch.Generator`` (the server seeds it
with 0) and returns the parameter tree.  Paths may be local or ``gs://``
(GCS through ``google.cloud.storage``, or an injected ``storage_client``).
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
from typing import Any, Dict, List, Optional

import cloudpickle
import numpy as np

from cloud_tpu_torch.utils import gcs

ASSET_DIR = "training_assets"


@dataclasses.dataclass
class TrainerSpec:
    """Everything needed to rebuild a Trainer remotely."""

    loss_fn: Any
    optimizer: Any
    init_fn: Any
    logical_axes: Any = None
    rules: Any = None
    parallelism_hints: Any = None
    #: Thread a PRNG key through train steps (dropout) — Trainer's
    #: ``stochastic`` flag.
    stochastic: bool = False
    #: Gradient accumulation micro-batches per step — Trainer's
    #: ``accum_steps``.
    accum_steps: int = 1


def _write_bytes(path: str, data: bytes, storage_client=None) -> None:
    if gcs.is_gcs(path):
        gcs.write_bytes(path, data, storage_client)
    else:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)


def _read_bytes(path: str, storage_client=None) -> bytes:
    if gcs.is_gcs(path):
        return gcs.read_bytes(path, storage_client)
    with open(path, "rb") as f:
        return f.read()


def _join(*parts: str) -> str:
    if gcs.is_gcs(parts[0]):
        return gcs.join(*parts)
    return os.path.join(*parts)


def _arrays_to_npz(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _npz_to_arrays(data: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(data)) as npz:
        return {k: npz[k] for k in npz.files}


def serialize_assets(
    remote_dir: str,
    spec: TrainerSpec,
    train_data: Dict[str, np.ndarray],
    *,
    validation_data: Optional[Dict[str, np.ndarray]] = None,
    callbacks: Optional[List[Any]] = None,
    fit_kwargs: Optional[Dict[str, Any]] = None,
    storage_client=None,
) -> str:
    """Write all training assets under remote_dir/training_assets."""
    base = _join(remote_dir, ASSET_DIR)
    _write_bytes(_join(base, "trainer.pkl"), cloudpickle.dumps(spec),
                 storage_client)
    _write_bytes(_join(base, "train_data.npz"), _arrays_to_npz(train_data),
                 storage_client)
    if validation_data is not None:
        _write_bytes(
            _join(base, "validation_data.npz"),
            _arrays_to_npz(validation_data), storage_client,
        )
    _write_bytes(
        _join(base, "callbacks.pkl"), cloudpickle.dumps(callbacks or []),
        storage_client,
    )
    _write_bytes(
        _join(base, "fit_kwargs.json"),
        json.dumps(fit_kwargs or {}).encode(), storage_client,
    )
    return base


def deserialize_assets(remote_dir: str, *, storage_client=None):
    """Load what serialize_assets wrote.  Returns (spec, train_data,
    validation_data | None, callbacks, fit_kwargs)."""
    base = _join(remote_dir, ASSET_DIR)
    spec = cloudpickle.loads(
        _read_bytes(_join(base, "trainer.pkl"), storage_client)
    )
    train_data = _npz_to_arrays(
        _read_bytes(_join(base, "train_data.npz"), storage_client)
    )
    validation_data = None
    try:
        validation_data = _npz_to_arrays(
            _read_bytes(_join(base, "validation_data.npz"), storage_client)
        )
    except Exception as e:  # local FileNotFoundError or GCS NotFound
        if type(e).__name__ not in ("FileNotFoundError", "NotFound"):
            raise
    callbacks = cloudpickle.loads(
        _read_bytes(_join(base, "callbacks.pkl"), storage_client)
    )
    fit_kwargs = json.loads(
        _read_bytes(_join(base, "fit_kwargs.json"), storage_client)
    )
    return spec, train_data, validation_data, callbacks, fit_kwargs
