"""Dense MNIST classifier, the reference's golden minimal workload (port
of ``cloud_tpu/models/mnist.py``): flattened 28x28 images, a 512-unit
relu layer and a 10-way head.  It runs no kernel of the port; its params
come from ``bridge.init_mnist`` or, from JAX's, ``bridge.mnist_to_torch``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import layers


@dataclasses.dataclass(frozen=True)
class MnistConfig:
    input_dim: int = 784
    hidden_dim: int = 512
    num_classes: int = 10


def apply(params, images, config: MnistConfig = MnistConfig(), *,
          device=None):
    """images ``[B, ...]`` (flattened to ``[B, input_dim]``) -> logits
    ``[B, num_classes]``."""
    device = resolve_device(device)
    x = torch.as_tensor(images, device=device)
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(layers.dense_apply(params["hidden"], x))
    return layers.dense_apply(params["out"], x)


def loss_fn(params, batch: Dict[str, Any],
            config: MnistConfig = MnistConfig(), *,
            device=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean softmax cross-entropy and accuracy over ``batch["image"]``,
    ``batch["label"]``; the metrics are detached from the graph."""
    logits = apply(params, batch["image"], config, device=device)
    labels = torch.as_tensor(batch["label"], device=logits.device).long()
    log_probs = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.take_along_dim(log_probs, labels[:, None],
                                            dim=-1))
    accuracy = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"loss": loss.detach(), "accuracy": accuracy}
