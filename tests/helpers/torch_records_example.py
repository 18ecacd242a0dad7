"""The port's copy of the streaming-input golden workload,
``tests/testdata/records_streaming_example.py``: record shards on disk ->
``RecordDataset`` (per-host shards by data coordinate, shuffle buffer) ->
prefetch to the rank's device -> ``Trainer.fit`` under whatever mesh the
bootstrap installed.

Env (all optional): ``RECORDS_EXAMPLE_DIR`` (where shards live / are
written), ``RECORDS_EXAMPLE_EPOCHS`` (default 2), ``RECORDS_EXAMPLE_SAVE``
(the chief writes ``history.json`` there).
"""

import functools
import json
import os
import tempfile

import numpy as np
import torch

from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import mnist
from cloud_tpu_torch.parallel import distributed
from cloud_tpu_torch.parallel import mesh as mesh_lib
from cloud_tpu_torch.training import Trainer, optimizers, records


def ensure_dataset(data_dir: str, *, n: int = 256, shards: int = 4):
    """Write synthetic MNIST-shaped shards once (idempotent)."""
    marker = os.path.join(data_dir, "train-00.rec")
    if os.path.exists(marker):
        return
    rng = np.random.default_rng(0)

    def examples():
        for _ in range(n):
            image = rng.normal(size=(28, 28)).astype(np.float32)
            label = np.int64(
                np.clip(int((image.mean() + 0.5) * 10), 0, 9)
            )
            yield {"image": image, "label": label}

    records.write_records(
        os.path.join(data_dir, "train-{shard:02d}.rec"),
        examples(),
        num_shards=shards,
    )


def main():
    data_dir = os.environ.get("RECORDS_EXAMPLE_DIR") or tempfile.mkdtemp(
        prefix="records_example_"
    )
    if distributed.process_index() == 0:
        ensure_dataset(data_dir)
    if distributed.process_count() > 1:
        torch.distributed.barrier()
    epochs = int(os.environ.get("RECORDS_EXAMPLE_EPOCHS", "2"))

    mesh = mesh_lib.get_global_mesh()  # installed by the bootstrap (or None)
    dataset = records.RecordDataset(
        os.path.join(data_dir, "train-*.rec"),
        batch_size=64,
        shuffle_buffer=128,
        seed=0,
    )
    cfg = mnist.MnistConfig(hidden_dim=64)
    trainer = Trainer(
        functools.partial(mnist.loss_fn, config=cfg),
        optimizers.adam(1e-3, mu_dtype=None),
        init_fn=lambda gen: bridge.init_mnist(cfg, gen, device="cpu"),
        mesh=mesh,
        logical_axes=mnist.param_logical_axes(cfg) if mesh else None,
    )
    trainer.init_state(torch.Generator().manual_seed(0))
    history = trainer.fit(
        records.prefetch_to_device(dataset, mesh=mesh), epochs=epochs
    )
    losses = history.history["loss"]
    assert np.isfinite(losses[-1]), losses
    assert losses[-1] < losses[0], f"loss did not improve: {losses}"
    save = os.environ.get("RECORDS_EXAMPLE_SAVE")
    if save and distributed.process_index() == 0:
        os.makedirs(save, exist_ok=True)
        with open(os.path.join(save, "history.json"), "w") as f:
            json.dump(history.history, f)
    print(f"records streaming: losses={['%.4f' % x for x in losses]}")
    return history


if __name__ == "__main__":
    main()
