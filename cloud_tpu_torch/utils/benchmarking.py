"""Benchmark workloads of the port (counterpart of ``cloud_tpu/utils/benchmarking.py``)."""

from __future__ import annotations

import numpy as np
import torch

from cloud_tpu_torch import bridge
from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import transformer


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
