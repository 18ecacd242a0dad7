"""The port's copy of the golden workload
``tests/testdata/tuner_mnist_example.py``: a hyperparameter search with
``CloudTuner`` over the dense MNIST model, learning rate and hidden
width, backed by the file-based ``LocalStudyService`` so it is hermetic
(swapping in ``cloud_tpu_torch.tuner.vizier_client`` is a one-line
change).

``dispatch_search`` appends ``--study-id``/``--tuner-id`` (the worker
contract of ``tuner/dispatch.py``); ``--device cpu`` runs the trials on
the CPU (the card otherwise).  Env: ``TUNER_EXAMPLE_MAX_TRIALS`` (4),
``TUNER_EXAMPLE_STUDY_DIR`` (a fresh temporary directory).
"""

import functools
import os
import tempfile

import numpy as np
import torch

from cloud_tpu_torch import bridge
from cloud_tpu_torch import tuner as tuner_lib
from cloud_tpu_torch.models import mnist
from cloud_tpu_torch.training import data, optimizers, trainer


def make_dataset(n=256, batch_size=64, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, 28, 28)).astype(np.float32)
    labels = np.clip(
        ((images.mean(axis=(1, 2)) + 0.5) * 10).astype(np.int32), 0, 9
    )
    return data.ArrayDataset({"image": images, "label": labels}, batch_size)


def build_hyperparameters():
    hp = tuner_lib.HyperParameters()
    hp.Float("learning_rate", 1e-4, 1e-1, sampling="log")
    hp.Choice("hidden_dim", [64, 128])
    return hp


def hypermodel(hp, device=None):
    config = mnist.MnistConfig(hidden_dim=hp.get("hidden_dim"))
    t = trainer.Trainer(
        functools.partial(mnist.loss_fn, config=config, device=device),
        optimizers.adam(hp.get("learning_rate"), mu_dtype=None),
        lambda gen: bridge.init_mnist(config, gen, device=gen.device),
        logical_axes=mnist.param_logical_axes(config),
        device=device,
    )
    t.init_state(torch.Generator(device=t.device).manual_seed(0))
    return t


def main(argv=None):
    # argv=None means "no CLI args", so importing callers (the tests)
    # never inherit pytest's own command line; script mode passes
    # sys.argv[1:].
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--study-id",
                        default=os.environ.get("STUDY_ID", "mnist_hp_study"))
    parser.add_argument("--tuner-id",
                        default=os.environ.get("TUNER_ID", "tuner0"))
    parser.add_argument("--device", default=None, choices=["cuda", "cpu"])
    args = parser.parse_args([] if argv is None else argv)

    max_trials = int(os.environ.get("TUNER_EXAMPLE_MAX_TRIALS", "4"))
    study_dir = os.environ.get("TUNER_EXAMPLE_STUDY_DIR") or tempfile.mkdtemp(
        prefix="tuner_example_"
    )
    service = tuner_lib.LocalStudyService(args.study_id, study_dir)
    t = tuner_lib.CloudTuner(
        functools.partial(hypermodel, device=args.device),
        service,
        objective="loss",
        hyperparameters=build_hyperparameters(),
        max_trials=max_trials,
        tuner_id=args.tuner_id,
    )
    t.search(train_data=make_dataset(), epochs=1)

    best = t.get_best_hyperparameters(1)[0]
    print(
        f"best: learning_rate={best.get('learning_rate'):.5f} "
        f"hidden_dim={best.get('hidden_dim')}"
    )
    return best


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
