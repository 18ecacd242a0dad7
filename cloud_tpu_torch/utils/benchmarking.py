"""Benchmark workloads of the port (counterpart of ``cloud_tpu/utils/benchmarking.py``)."""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from cloud_tpu_torch import bridge
from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import resnet, transformer
from cloud_tpu_torch.training import optimizers, train


def decode_setup(*, batch_size: int = 4, prompt_len: int = 128, params=None,
                 device=None, seed: int = 0):
    """The generation-decode workload: CloudLM SMALL with params on the
    device (random, from ``seed``, unless given) and full-length prompts
    from a numpy generator seeded with 0.  Returns ``(config, params,
    prompts, lens)``."""
    device = resolve_device(device)
    cfg = transformer.SMALL
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        params = bridge.init(cfg, gen, device=device)
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, (batch_size, prompt_len)).astype(
            np.int32)).to(device)
    lens = torch.full((batch_size,), prompt_len, dtype=torch.int32,
                      device=device)
    return cfg, params, prompts, lens


def chain_then_read_throughput(step, state, batch, *, warmup=3, iters=20):
    """Steps/sec of ``step(state, batch) -> (state, metrics)``: ``warmup``
    chained steps, then ``iters`` chained steps timed up to a host read of
    the final step's first metric (which waits for the device)."""
    metrics = None
    for _ in range(warmup):
        state, metrics = step(state, batch)
    float(next(iter(metrics.values())))
    start = time.perf_counter()
    for _ in range(iters):
        state, metrics = step(state, batch)
    float(next(iter(metrics.values())))
    return iters / (time.perf_counter() - start)


def resnet_train_setup(*, imagenet_shape: bool, batch_size: int,
                       steps_per_dispatch: int = 1, device=None,
                       seed: int = 0):
    """The ResNet training workload: ResNet-50 (224x224, 1000 classes, or
    the CIFAR variant at 32x32, 10 classes) in bf16 with random params from
    ``seed``, ``sgd(0.1, momentum=0.9)``, and one synthetic batch from a
    numpy generator seeded with 0 (labels drawn first, then the images, as
    in the JAX package).  Returns ``(step, state, batch)``."""
    if steps_per_dispatch != 1:
        raise NotImplementedError(
            "steps_per_dispatch > 1 (make_multi_step) comes with the "
            "training slice of the port (ROADMAP.md A.6)"
        )
    device = resolve_device(device)
    if imagenet_shape:
        config, image_hw, num_classes = resnet.RESNET50, 224, 1000
    else:
        config, image_hw, num_classes = resnet.RESNET50_CIFAR, 32, 10
    tx = optimizers.sgd(0.1, momentum=0.9)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = train.create_sharded_state(
        gen, lambda g: bridge.init_resnet(config, g, device=device), tx,
        device=device)
    loss = functools.partial(resnet.loss_fn, config=config, device=device)
    rng = np.random.default_rng(0)
    label = rng.integers(0, num_classes, batch_size)
    image = rng.normal(size=(batch_size, image_hw, image_hw, 3))
    batch = {"image": torch.from_numpy(image.astype(np.float32)).to(device),
             "label": torch.from_numpy(label).to(device)}
    return train.make_train_step(loss, tx), state, batch
