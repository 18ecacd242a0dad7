"""ResNet-50 with GroupNorm (port of ``cloud_tpu/models/resnet.py``).

Activations are NHWC ``[B, H, W, C]`` and conv kernels HWIO, as in the JAX
package, and parameters are the same dict (``bridge.resnet_to_torch``
carries the JAX weights across; ``bridge.init_resnet`` makes fresh ones).
Convolutions are PyTorch's (cuDNN on the card, as XLA's were outside any
Pallas kernel): ``F.conv2d`` gets an NCHW *view* of the NHWC tensor, which
is channels-last in memory, so no activation is copied to change layout.
GroupNorm goes through :func:`cloud_tpu_torch.ops.group_norm.group_norm`
(kernels K1-K4 on the card).

JAX's ``SAME`` padding puts the odd pixel of a strided window at the end
(``lo = total // 2``); PyTorch's ``padding=`` is symmetric.  Where the two
differ (the stride-2 stem, stride-2 3x3 convs and the max-pool at even
sizes) the input is padded explicitly, with ``-inf`` for the pool.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import layers
from cloud_tpu_torch.ops.group_norm import group_norm


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Sequence[int] = (3, 4, 6, 3)  # ResNet-50
    width: int = 64
    num_classes: int = 1000
    num_groups: int = 32
    dtype: torch.dtype = torch.bfloat16


RESNET50 = ResNetConfig()
#: CIFAR-10-scale variant (the bench headline's model).
RESNET50_CIFAR = ResNetConfig(num_classes=10)
#: Tiny variant for tests: one block per stage, narrow.
RESNET8_CIFAR = ResNetConfig(
    stage_sizes=(1, 1, 1, 1), width=16, num_classes=10, num_groups=8
)


def same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """XLA's ``SAME`` padding ``(lo, hi)`` of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv(params, x, *, stride=1):
    kernel = params["kernel"]  # HWIO
    (h0, h1) = same_pads(x.shape[1], kernel.shape[0], stride)
    (w0, w1) = same_pads(x.shape[2], kernel.shape[1], stride)
    weight = kernel.permute(3, 2, 0, 1).to(
        dtype=x.dtype, memory_format=torch.channels_last)
    xc = _nchw(x)
    if (h0, w0) == (h1, w1):
        y = F.conv2d(xc, weight, stride=stride, padding=(h0, w0))
    else:
        y = F.conv2d(F.pad(xc, (w0, w1, h0, h1)), weight, stride=stride)
    return _nhwc(y)


def _max_pool(x):
    """3x3 max-pool, stride 2, ``SAME`` with ``-inf`` padding."""
    (h0, h1) = same_pads(x.shape[1], 3, 2)
    (w0, w1) = same_pads(x.shape[2], 3, 2)
    xc = F.pad(_nchw(x), (w0, w1, h0, h1), value=float("-inf"))
    return _nhwc(F.max_pool2d(xc, 3, 2))


def _gn(params, x, num_groups, activation=None, residual=None):
    return group_norm(x, params["scale"], params["bias"],
                      num_groups=num_groups, activation=activation,
                      residual=residual)


def _bottleneck(params, x, cfg, stride):
    residual = x
    y = _gn(params["gn1"], _conv(params["conv1"], x), cfg.num_groups,
            activation="relu")
    y = _gn(params["gn2"], _conv(params["conv2"], y, stride=stride),
            cfg.num_groups, activation="relu")
    if "proj" in params:
        residual = _gn(params["gn_proj"],
                       _conv(params["proj"], x, stride=stride),
                       cfg.num_groups)
    return _gn(params["gn3"], _conv(params["conv3"], y), cfg.num_groups,
               activation="relu", residual=residual)


def apply(params, images, config: ResNetConfig = RESNET50, *, device=None):
    """images ``[B, H, W, 3]`` -> logits ``[B, num_classes]`` (float32)."""
    device = resolve_device(device)
    x = torch.as_tensor(images, device=device).to(config.dtype)
    x = _conv(params["stem"], x, stride=2)
    x = _gn(params["gn_stem"], x, config.num_groups, activation="relu")
    x = _max_pool(x)
    for stage, num_blocks in enumerate(config.stage_sizes):
        for block in range(num_blocks):
            stride = 2 if (block == 0 and stage > 0) else 1
            x = _bottleneck(params[f"stage{stage}_block{block}"], x, config,
                            stride)
    x = torch.mean(x, dim=(1, 2))
    return layers.dense_apply(params["head"], x, dtype=torch.float32)


def loss_fn(params, batch: Dict[str, Any], config: ResNetConfig = RESNET50,
            *, device=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean softmax cross-entropy and accuracy over ``batch["image"]``,
    ``batch["label"]``; the metrics are detached from the graph."""
    logits = apply(params, batch["image"], config, device=device)
    labels = torch.as_tensor(batch["label"], device=logits.device).long()
    log_probs = torch.log_softmax(logits, dim=-1)
    loss = -torch.mean(torch.take_along_dim(log_probs, labels[:, None],
                                            dim=-1))
    accuracy = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"loss": loss.detach(), "accuracy": accuracy}
