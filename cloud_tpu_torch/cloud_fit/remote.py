"""cloud_fit server side: deserialize assets and fit under the mesh (port of
``cloud_tpu/cloud_fit/remote.py``).

The generated shim entry point calls :func:`run` under the bootstrap, with
the planned mesh installed as the global one; every rank runs it.  Each
rank feeds its data coordinate's rows of every global batch (the port
runs one process per rank), so a fit of several ranks takes the steps a
one-process fit of the same ``batch_size`` takes.  The final state is
saved with the port's sharded checkpoints (every rank writes its pieces,
the chief commits); ``history.json`` is the chief's, and the other ranks
write theirs to a throwaway directory (the reference's
``remote.py:130-145``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
from typing import Optional

from cloud_tpu_torch.cloud_fit import serialization
from cloud_tpu_torch.cloud_fit.serialization import _join
from cloud_tpu_torch.utils import gcs

logger = logging.getLogger(__name__)

OUTPUT_DIR = "output"


class _RankRows:
    """This rank's rows of every global batch of ``dataset``: those of its
    data coordinate over ``dp`` x ``fsdp`` (the ``train.shard_batch``
    contract).  Position queries and fast-forwards go to ``dataset``."""

    def __init__(self, dataset, mesh):
        self._dataset = dataset
        self._count = mesh.axis_size("dp") * mesh.axis_size("fsdp")
        self._index = (mesh.axis_index("dp") * mesh.axis_size("fsdp")
                       + mesh.axis_index("fsdp"))

    def __getattr__(self, name):
        return getattr(self._dataset, name)

    def __call__(self):
        for batch in self._dataset():
            n = len(next(iter(batch.values())))
            if n % self._count:
                raise ValueError(
                    f"a batch of {n} rows does not split over the mesh's "
                    f"{self._count} data ranks; pass a batch_size that "
                    "they divide")
            rows = n // self._count
            yield {k: v[self._index * rows:(self._index + 1) * rows]
                   for k, v in batch.items()}


def run(remote_dir: str, *, mesh=None, storage_client=None, device=None):
    """Load serialized assets from ``remote_dir`` and run the fit.

    Returns the History.  Called by the generated shim entry point under
    the bootstrap runtime (mesh already installed globally), or directly
    with an explicit mesh.  The Trainer runs on the mesh's device, else
    on ``device`` (the card unless the caller asks for ``"cpu"``).
    """
    import torch

    from cloud_tpu_torch.parallel import distributed
    from cloud_tpu_torch.parallel import mesh as mesh_lib
    from cloud_tpu_torch.training import Trainer, data as data_lib
    from cloud_tpu_torch.training import checkpoint

    spec, train_arrays, val_arrays, callbacks, fit_kwargs = (
        serialization.deserialize_assets(remote_dir,
                                         storage_client=storage_client)
    )
    mesh = mesh if mesh is not None else mesh_lib.get_global_mesh()
    several = mesh_lib.effective_mesh(mesh)

    batch_size = fit_kwargs.pop("batch_size", 32)
    train_ds = data_lib.ArrayDataset(train_arrays, batch_size, shuffle=True)
    val_ds = (
        data_lib.ArrayDataset(val_arrays, batch_size) if val_arrays else None
    )
    if several is not None:
        train_ds = _RankRows(train_ds, several)
        val_ds = None if val_ds is None else _RankRows(val_ds, several)

    trainer = Trainer(
        spec.loss_fn,
        spec.optimizer,
        init_fn=spec.init_fn,
        mesh=mesh,
        logical_axes=spec.logical_axes,
        rules=spec.rules or _default_rules(),
        stochastic=spec.stochastic,
        accum_steps=spec.accum_steps,
        device=None if mesh is not None else device,
    )
    # Init first: the fresh state is the restore template.
    trainer.init_state(torch.Generator(device=trainer.device).manual_seed(0))
    _maybe_restore(trainer, _join(remote_dir, "state"), storage_client)
    history = trainer.fit(
        train_ds,
        validation_data=val_ds,
        callbacks=callbacks,
        **fit_kwargs,
    )

    # Every rank saves its pieces; the chief commits the step.
    output_dir = _join(remote_dir, OUTPUT_DIR)
    manager = checkpoint.CheckpointManager(
        _join(output_dir, "checkpoint"), device=trainer.device,
        layout=checkpoint.layout_of(trainer), storage_client=storage_client)
    manager.save(int(trainer.state.step), trainer.state)
    manager.wait()
    manager.close()
    if distributed.is_chief():
        _write_history(output_dir, history, storage_client)
    else:
        # Non-chief bookkeeping goes to a throwaway location (parity with
        # reference remote.py:130-145).
        with tempfile.TemporaryDirectory() as tmp:
            _write_history(tmp, history, None)
    return history


def _default_rules():
    from cloud_tpu_torch.parallel.sharding import DEFAULT_RULES

    return DEFAULT_RULES


def _maybe_restore(trainer, state_dir: str, storage_client=None) -> bool:
    """Restore a user-uploaded ``state/`` (local or ``gs://``, the latter
    through ``storage_client``) into the fresh state.

    ``only_if_ahead=False``: a state saved at step 0 (pretrained weights)
    replaces the fresh init too.  ``quarantine=False``: the directory is
    the user's upload, never moved.  Any error of the restore logs and
    starts fresh, as the JAX package's does.
    """
    if gcs.is_gcs(state_dir) or os.path.isdir(state_dir):
        try:
            from cloud_tpu_torch.training.checkpoint import (
                CheckpointManager,
                resume_trainer_state,
            )

            return resume_trainer_state(
                trainer, CheckpointManager(state_dir, device=trainer.device,
                                           storage_client=storage_client),
                only_if_ahead=False, quarantine=False)
        except Exception:
            logger.exception("could not restore from %s; starting fresh",
                             state_dir)
    return False


def _write_history(output_dir: str, history, storage_client) -> None:
    serialization._write_bytes(
        _join(output_dir, "history.json"),
        json.dumps(history.history).encode(),
        storage_client,
    )


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--remote-dir", required=True)
    args = parser.parse_args(argv)
    run(args.remote_dir)


if __name__ == "__main__":
    main()
