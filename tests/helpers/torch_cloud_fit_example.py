"""The port's copy of ``examples/cloud_fit_example.py``: fit an in-memory
model remotely with ``cloud_fit``.  The trainer spec, data and callbacks
are serialized to a remote dir and a job is submitted whose container
deserializes and fits; no entry-point script at all.
"""

import functools

import numpy as np

from cloud_tpu_torch import bridge
from cloud_tpu_torch.cloud_fit import client
from cloud_tpu_torch.cloud_fit.serialization import TrainerSpec
from cloud_tpu_torch.core.containerize import DockerConfig
from cloud_tpu_torch.models import mnist
from cloud_tpu_torch.training import optimizers, trainer


def main(remote_dir="gs://my-bucket/cloud_fit_demo", dry_run: bool = False,
         **overrides):
    rng = np.random.default_rng(0)
    images = rng.normal(size=(512, 28, 28)).astype(np.float32)
    labels = np.clip(
        ((images.mean(axis=(1, 2)) + 0.5) * 10).astype(np.int32), 0, 9
    )

    config = mnist.MnistConfig()
    spec = TrainerSpec(
        loss_fn=functools.partial(mnist.loss_fn, config=config),
        optimizer=optimizers.adam(1e-3, mu_dtype=None),
        init_fn=functools.partial(bridge.init_mnist, config),
        logical_axes=mnist.param_logical_axes(config),
    )
    return client.cloud_fit(
        spec,
        remote_dir,
        train_data={"image": images, "label": labels},
        callbacks=[trainer.ProgressLogger(every_n_steps=10)],
        epochs=2,
        batch_size=64,
        docker_config=DockerConfig(image="gcr.io/my-project/cloudfit:demo"),
        dry_run=dry_run,
        **overrides,
    )


if __name__ == "__main__":
    main()
