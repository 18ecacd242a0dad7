"""Entry point of a multi-file project (the port's copy of
``examples/multi_file_example/train.py``): ``run()`` ships the entry
point's whole directory, so sibling modules import normally in the
container."""

import torch

from data_util import make_dataset  # sibling module, shipped with the entry

from cloud_tpu_torch import bridge, parallel
from cloud_tpu_torch.models import mnist
from cloud_tpu_torch.training import optimizers, trainer


def main():
    t = trainer.Trainer(
        mnist.loss_fn, optimizers.adam(1e-3, mu_dtype=None),
        lambda gen: bridge.init_mnist(mnist.MnistConfig(), gen,
                                      device="cpu"),
        mesh=parallel.get_global_mesh(),
        logical_axes=mnist.param_logical_axes(),
    )
    t.init_state(torch.Generator().manual_seed(0))
    return t.fit(make_dataset(), epochs=2)


if __name__ == "__main__":
    main()
