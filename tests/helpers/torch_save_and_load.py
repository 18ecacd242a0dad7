"""The port's copy of the golden workload ``tests/testdata/save_and_load.py``:
train, checkpoint, restore, resume, on a user-owned mesh of ``dp`` over
every rank (the devices of the mesh the bootstrap installed; one device,
the card unless ``main(device="cpu")``, without one).

Phase 1 fits one epoch with a checkpoint every 2 steps; phase 2 restores
the latest step into a differently-initialised trainer (its parameters
must be phase 1's, not the fresh init) and resumes from it.  Every rank
iterates the same dataset (its batches are the rank's rows), and every
rank calls the collective checkpoint calls together.

Env: ``SAVE_AND_LOAD_DIR`` (default: a fresh temporary directory).
"""

import os
import tempfile

import numpy as np
import torch

from cloud_tpu_torch import bridge, parallel
from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import mnist
from cloud_tpu_torch.training import checkpoint, data, optimizers, trainer


def make_trainer(mesh):
    return trainer.Trainer(
        mnist.loss_fn,
        optimizers.adam(1e-3, mu_dtype=None),
        lambda gen: bridge.init_mnist(mnist.MnistConfig(), gen,
                                      device="cpu"),
        mesh=mesh,
        logical_axes=mnist.param_logical_axes(),
    )


def main(device=None):
    ckpt_dir = os.environ.get("SAVE_AND_LOAD_DIR") or tempfile.mkdtemp(
        prefix="save_and_load_"
    )

    outer = parallel.get_global_mesh()
    devices = (list(outer.devices) if outer is not None
               else [resolve_device(device)])
    mesh = parallel.MeshSpec({"dp": len(devices)}).build(
        devices=devices, backend=outer.backend if outer is not None
        else None)
    rng = np.random.default_rng(0)
    images = rng.normal(size=(256, 28, 28)).astype(np.float32)
    labels = np.clip(
        ((images.mean(axis=(1, 2)) + 0.5) * 10).astype(np.int32), 0, 9
    )
    dataset = data.ArrayDataset({"image": images, "label": labels}, 64)

    # Phase 1: train one epoch, checkpointing along the way.
    t1 = make_trainer(mesh)
    t1.init_state(torch.Generator().manual_seed(0))
    t1.fit(
        dataset,
        epochs=1,
        callbacks=[
            checkpoint.CheckpointCallback(ckpt_dir, every_n_steps=2,
                                          device=mesh.device)
        ],
    )
    trained_step = int(t1.state.step)

    # Phase 2: a fresh process-equivalent restores and resumes.
    manager = checkpoint.CheckpointManager(ckpt_dir, device=mesh.device)
    assert manager.latest_step() == trained_step, (
        manager.latest_step(), trained_step,
    )
    t2 = make_trainer(mesh)
    template = t2.init_state(torch.Generator().manual_seed(1))
    # The layout says how the template lies on the mesh (under the dp
    # mesh every leaf is replicated, whatever mesh the bootstrap planned).
    restored = manager.restore(template=template,
                               layout=checkpoint.layout_of(t2))
    manager.close()

    # Restored params must match what phase 1 saved, not the fresh init.
    for a, b in zip(bridge.leaves(restored.params),
                    bridge.leaves(t1.state.params)):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().cpu().numpy())

    history = t2.fit(dataset, epochs=1, state=restored)
    assert int(t2.state.step) > trained_step
    assert np.isfinite(history.history["loss"][-1])
    print(
        f"resumed from step {trained_step} -> {int(t2.state.step)}; "
        f"loss {history.history['loss'][-1]:.4f}"
    )
    return ckpt_dir


if __name__ == "__main__":
    main()
