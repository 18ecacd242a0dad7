"""The port's copy of the golden workload
``tests/testdata/mnist_example_using_ctl.py``: a custom training loop on a
user-owned mesh.

The user builds a mesh of ``dp`` over every rank of the job (the devices
of the mesh the bootstrap installed; one device, the card unless
``main(device="cpu")``, without one), feeds each rank its rows of every
global batch and writes the step: the loss is the rank's share of the
global mean (``mnist.loss_fn(..., mesh=)``), ``torch.autograd.grad``
gives its gradient, one sum over ``dp`` (``collectives.grad_sync``) makes
it the global one, and SGD with momentum updates in place.  The chief
saves the final parameters.

Env: ``MNIST_CTL_EPOCHS`` (default 2), ``MNIST_CTL_SAVE_DIR`` receives
``params.npz``.
"""

import os

import numpy as np
import torch

from cloud_tpu_torch import bridge, parallel
from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import mnist
from cloud_tpu_torch.parallel import collectives, distributed
from cloud_tpu_torch.training import data, optimizers


def main(device=None):
    epochs = int(os.environ.get("MNIST_CTL_EPOCHS", "2"))
    batch_size = 64

    # User-owned parallelism: pure data-parallel over every rank.
    outer = parallel.get_global_mesh()
    devices = (list(outer.devices) if outer is not None
               else [resolve_device(device)])
    mesh = parallel.MeshSpec({"dp": len(devices)}).build(
        devices=devices, backend=outer.backend if outer is not None
        else None)
    dev = mesh.device
    rank, n = mesh.axis_index("dp"), len(devices)

    config = mnist.MnistConfig()
    params = bridge.map_leaves(
        bridge.init_mnist(config, torch.Generator().manual_seed(0),
                          device=dev),
        lambda t: t.requires_grad_(True))
    optimizer = optimizers.sgd(0.1, momentum=0.9)
    opt_state = optimizer.init(params)

    def train_step(params, opt_state, batch):
        loss, metrics = mnist.loss_fn(params, batch, config, mesh=mesh,
                                      device=dev)
        grads = list(torch.autograd.grad(loss, bridge.leaves(params)))
        if n > 1:
            grads = collectives.grad_sync(grads, "dp", mean=False, mesh=mesh)
        optimizer.update_(params, grads, opt_state)
        return metrics

    rng = np.random.default_rng(0)
    count = 512
    images = rng.normal(size=(count, 28, 28)).astype(np.float32)
    labels = np.clip(
        ((images.mean(axis=(1, 2)) + 0.5) * 10).astype(np.int32), 0, 9
    )
    dataset = data.ArrayDataset(
        {"image": images, "label": labels}, batch_size, shuffle=True
    )

    first_loss = last_loss = None
    per = batch_size // n
    for epoch in range(epochs):
        for batch in dataset():
            batch = {k: torch.as_tensor(v[rank * per:(rank + 1) * per],
                                        device=dev)
                     for k, v in batch.items()}
            metrics = train_step(params, opt_state, batch)
        last_loss = float(metrics["loss"])
        if first_loss is None:
            first_loss = last_loss
        print(f"epoch {epoch}: loss={last_loss:.4f}")

    assert np.isfinite(last_loss), last_loss

    # Chief-aware save: only process 0 writes the final params snapshot.
    save_dir = os.environ.get("MNIST_CTL_SAVE_DIR")
    if save_dir and distributed.process_index() == 0:
        os.makedirs(save_dir, exist_ok=True)
        np.savez(os.path.join(save_dir, "params.npz"), **{
            f"{layer}/{leaf}": value.detach().cpu().numpy()
            for layer, leaves in params.items()
            for leaf, value in leaves.items()})
    return last_loss


if __name__ == "__main__":
    main()
