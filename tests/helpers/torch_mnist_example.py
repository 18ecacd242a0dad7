"""The port's copy of the golden minimal workload,
``tests/testdata/mnist_example_using_fit.py``: the dense MNIST classifier
through ``Trainer.fit`` under whatever mesh the bootstrap installed
(``parallel.get_global_mesh()``), so the same file runs on one card and
data-parallel over a job's ranks.  Every rank iterates the same dataset:
its batches are the rank's rows (the JAX package's multi-process
contract).

Hermetic: synthetic arrays, made as the JAX script makes them.  Env:
``MNIST_EXAMPLE_EPOCHS`` / ``MNIST_EXAMPLE_STEPS`` shrink the run,
``MNIST_EXAMPLE_SAVE_DIR`` receives ``history.json`` (the chief writes
it), ``MNIST_EXAMPLE_PARAMS`` names an ``.npz`` of starting parameters
(``hidden/kernel`` ...; default: ``bridge.init_mnist`` from seed 0).
"""

import json
import os

import numpy as np
import torch

from cloud_tpu_torch import bridge, parallel
from cloud_tpu_torch.models import mnist
from cloud_tpu_torch.parallel import distributed
from cloud_tpu_torch.training import data, optimizers, trainer


def make_datasets(n_train=512, n_test=128, batch_size=64, seed=0):
    rng = np.random.default_rng(seed)

    def synth(n):
        images = rng.normal(size=(n, 28, 28)).astype(np.float32)
        # Labels carry signal (mean-brightness bucket) so accuracy can move.
        labels = np.clip(
            ((images.mean(axis=(1, 2)) + 0.5) * 10).astype(np.int32), 0, 9
        )
        return {"image": images, "label": labels}

    train = data.ArrayDataset(synth(n_train), batch_size, shuffle=True)
    test = data.ArrayDataset(synth(n_test), batch_size)
    return train, test


def init_fn(generator):
    path = os.environ.get("MNIST_EXAMPLE_PARAMS")
    if not path:
        return bridge.init_mnist(mnist.MnistConfig(), generator,
                                 device="cpu")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    tree = {}
    for key, value in flat.items():
        layer, leaf = key.split("/")
        tree.setdefault(layer, {})[leaf] = value
    return bridge.mnist_to_torch(tree, device="cpu")


def main():
    epochs = int(os.environ.get("MNIST_EXAMPLE_EPOCHS", "3"))
    steps = os.environ.get("MNIST_EXAMPLE_STEPS")
    mesh = parallel.get_global_mesh()

    train_ds, test_ds = make_datasets()
    t = trainer.Trainer(
        mnist.loss_fn,
        # optax.adam: the first moment in the parameters' f32.
        optimizers.adam(1e-3, mu_dtype=None),
        init_fn,
        mesh=mesh,
        logical_axes=mnist.param_logical_axes(),
    )
    t.init_state(torch.Generator().manual_seed(0))
    history = t.fit(
        train_ds,
        epochs=epochs,
        steps_per_epoch=int(steps) if steps else None,
        validation_data=test_ds,
        callbacks=[trainer.ProgressLogger(every_n_steps=10)],
    )

    losses = history.history["loss"]
    assert losses[-1] < losses[0], f"loss did not improve: {losses}"

    save_dir = os.environ.get("MNIST_EXAMPLE_SAVE_DIR")
    if save_dir and distributed.process_index() == 0:
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "history.json"), "w") as f:
            json.dump(history.history, f)
    return history


if __name__ == "__main__":
    main()
