"""The dataset module of the multi-file project (a sibling of
``train.py``, shipped with it)."""

import numpy as np

from cloud_tpu_torch.training import data


def make_dataset(n=256, batch_size=64, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(n, 28, 28)).astype(np.float32)
    labels = np.clip(
        ((images.mean(axis=(1, 2)) + 0.5) * 10).astype(np.int32), 0, 9
    )
    return data.ArrayDataset({"image": images, "label": labels}, batch_size)
