"""Benchmark workloads of the port (counterpart of ``cloud_tpu/utils/benchmarking.py``)."""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from cloud_tpu_torch import bridge
from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import bert, generation, resnet, transformer, vit
from cloud_tpu_torch.training import optimizers, train


def decode_setup(*, batch_size: int = 4, prompt_len: int = 128, params=None,
                 config=None, device=None, seed: int = 0):
    """The generation-decode workload: CloudLM SMALL (or ``config``) with
    params on the device (random, from ``seed``, unless given) and
    full-length prompts from a numpy generator seeded with 0.  Returns
    ``(config, params, prompts, lens)``."""
    device = resolve_device(device)
    cfg = config or transformer.SMALL
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


def decode_tokens_per_sec(params, cfg, prompts, lens, *, max_new_tokens,
                          warmup: int = 1, iters: int = 4,
                          kv_quant: bool = False, device=None) -> float:
    """Greedy KV-cache decode throughput of ``generation.generate``:
    ``warmup`` calls, then ``iters`` timed calls, each ending in a host read
    of its sequences (which waits for the device), as the JAX package
    times it.  Returns generated tokens per second."""
    device = resolve_device(device)

    def run():
        out = generation.generate(params, prompts, lens, cfg,
                                  max_new_tokens=max_new_tokens,
                                  kv_quant=kv_quant, device=device)
        float(out["sequences"].float().sum())

    for _ in range(warmup):
        run()
    start = time.perf_counter()
    for _ in range(iters):
        run()
    elapsed = time.perf_counter() - start
    return iters * prompts.shape[0] * max_new_tokens / elapsed


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


def fused_throughput(multi_step, state, super_batch, *, steps_per_dispatch,
                     warmup=1, iters=5):
    """Steps/sec (steps, not windows) of a K-step window
    (``train.make_multi_step``): :func:`chain_then_read_throughput` of the
    window, times K."""
    return steps_per_dispatch * chain_then_read_throughput(
        multi_step, state, super_batch, warmup=warmup, iters=iters)


def resnet_train_setup(*, imagenet_shape: bool, batch_size: int,
                       steps_per_dispatch: int = 1, device=None,
                       seed: int = 0):
    """The ResNet training workload: ResNet-50 (224x224, 1000 classes, or
    the CIFAR variant at 32x32, 10 classes) in bf16 with random params from
    ``seed``, ``sgd(0.1, momentum=0.9)``, and one synthetic batch from a
    numpy generator seeded with 0 (labels drawn first, then the images, as
    in the JAX package).  Returns ``(step, state, batch)``.

    ``steps_per_dispatch`` K > 1 returns the fused variant instead:
    ``train.make_multi_step`` and a super-batch of K distinct batches
    (labels ``[K, B]`` drawn first, then images ``[K, B, H, W, 3]``)."""
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
    lead = (batch_size,)
    if steps_per_dispatch > 1:
        lead = (steps_per_dispatch, batch_size)
        step = train.make_multi_step(loss, tx,
                                     steps_per_dispatch=steps_per_dispatch)
    else:
        step = train.make_train_step(loss, tx)
    label = rng.integers(0, num_classes, lead)
    image = rng.normal(size=lead + (image_hw, image_hw, 3))
    batch = {"image": torch.from_numpy(image.astype(np.float32)).to(device),
             "label": torch.from_numpy(label).to(device)}
    return step, state, batch


def lm_train_setup(*, batch_size: int = 4, seq_len: int = 1024,
                   fused_ce: bool = False, config=None, device=None,
                   seed: int = 0):
    """The CloudLM training workload of the JAX package's fused-CE A/B:
    ``SMALL.scaled(tied_embeddings=True)`` (or ``config``) with
    ``fused_ce`` set, f32 master weights random from ``seed``,
    ``adamw(1e-4)`` with f32 moments (``optax.adamw(1e-4)``), and one
    batch of tokens in [1, V) from a numpy generator seeded with 0.
    Returns ``(step, state, batch)``."""
    device = resolve_device(device)
    cfg = config or transformer.SMALL.scaled(tied_embeddings=True)
    cfg = cfg.scaled(fused_ce=fused_ce)
    tx = optimizers.adamw(1e-4, mu_dtype=None)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = train.create_sharded_state(
        gen, lambda g: bridge.init(cfg, g, device=device), tx, device=device)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, (batch_size, seq_len))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(device)}
    loss = functools.partial(transformer.loss_fn, config=cfg, device=device)
    return train.make_train_step(loss, tx), state, batch


def bert_train_setup(*, batch_size: int = 32, seq_len: int = 128,
                     config=None, device=None, seed: int = 0):
    """The BERT fine-tune workload of the JAX package's bench:
    ``BERT_BASE`` (or ``config``), f32 master weights random from
    ``seed``, ``adamw(2e-5)`` with f32 moments, and one batch of tokens
    in [0, V) and labels in {0, 1} from a numpy generator seeded with 0,
    with no attention mask.  Returns ``(step, state, batch)``."""
    device = resolve_device(device)
    cfg = config or bert.BERT_BASE
    tx = optimizers.adamw(2e-5, mu_dtype=None)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = train.create_sharded_state(
        gen, lambda g: bridge.init_bert(cfg, g, device=device), tx,
        device=device)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (batch_size, seq_len))
    label = rng.integers(0, 2, batch_size)
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(device),
             "label": torch.from_numpy(label.astype(np.int64)).to(device)}
    loss = functools.partial(bert.loss_fn, cfg=cfg, device=device)
    return train.make_train_step(loss, tx), state, batch


def vit_train_setup(*, batch_size: int = 128, config=None, device=None,
                    seed: int = 0):
    """The ViT training workload: ``VIT_BASE_16`` (or ``config``) in its
    compute type with f32 master weights random from ``seed``,
    ``adamw(3e-4)`` with f32 moments, and one batch of NHWC images and
    labels from a numpy generator seeded with 0 (labels drawn first).
    Returns ``(step, state, batch)``."""
    device = resolve_device(device)
    cfg = config or vit.VIT_BASE_16
    tx = optimizers.adamw(3e-4, mu_dtype=None)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = train.create_sharded_state(
        gen, lambda g: bridge.init_vit(cfg, g, device=device), tx,
        device=device)
    rng = np.random.default_rng(0)
    label = rng.integers(0, cfg.num_classes, batch_size)
    image = rng.normal(size=(batch_size, cfg.image_size, cfg.image_size,
                             cfg.channels))
    batch = {"image": torch.from_numpy(image.astype(np.float32)).to(device),
             "label": torch.from_numpy(label).to(device)}
    loss = functools.partial(vit.loss_fn, cfg=cfg, device=device)
    return train.make_train_step(loss, tx), state, batch
