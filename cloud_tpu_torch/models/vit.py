"""Vision Transformer for image classification (port of ``cloud_tpu/models/vit.py``).

The patch embedding is one dense product over flattened patches
(``[B, N, P*P*C] @ [P*P*C, D]``), the encoder is the pre-LN block of the
JAX package's ``layers.encoder_block_init`` (LayerNorm, non-causal
attention, LayerNorm, a tanh-GELU MLP, each with its residual), walked
layer by layer under the config's remat policy, and the head reads the
class token (``pooling="cls"``) or the mean over patches (``"gap"``) in
f32.  Attention goes through
:func:`cloud_tpu_torch.ops.flash_attention.flash_attention` with
``causal=False`` at ``T = N`` (or ``N + 1`` with the class token): 196 or
197 at 224 px and patch 16, off the kernels' 64-row tiles.  Parameters are
the dict :func:`cloud_tpu_torch.bridge.vit_to_torch` builds: the JAX
package's names with the stacked layer axis split into a list.

Types follow the JAX package: images and activations in ``cfg.dtype``;
``pos`` and ``cls`` stored f32 and cast before they are added; LayerNorm
statistics in f32; the mean pooling in the compute type; the head in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import layers
from cloud_tpu_torch.ops import flash_attention as flash_lib


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    num_layers: int = 12
    dim: int = 768
    num_heads: int = 12
    mlp_hidden: int = 3072
    num_classes: int = 1000
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    #: "full" or "dots" (``layers.remat_wrap``).
    remat_policy: str = "full"
    #: "cls" prepends a learned class token and classifies from it; "gap"
    #: mean-pools the patch tokens.
    pooling: str = "gap"

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    def scaled(self, **kw) -> "ViTConfig":
        return dataclasses.replace(self, **kw)


VIT_BASE_16 = ViTConfig()
#: CIFAR-scale variant for tests.
VIT_TINY_CIFAR = ViTConfig(
    image_size=32, patch_size=4, num_layers=4, dim=64, num_heads=4,
    mlp_hidden=128, num_classes=10, remat=False,
)


def _patchify(images, cfg: ViTConfig):
    """``[B, H, W, C]`` -> ``[B, N, P*P*C]`` flattened patches, in the JAX
    package's order (patch rows, patch columns; within a patch: pixel
    row, pixel column, channel)."""
    b, h, w, c = images.shape
    p = cfg.patch_size
    x = images.reshape(b, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // p) * (w // p), p * p * c)


def _layer(lp, x, *, cfg: ViTConfig):
    b, t, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    y = layers.layernorm_apply(lp["ln1"], x)

    def proj(p):
        return layers.dense_apply(p, y).reshape(b, t, h, hd)

    attended = flash_lib.flash_attention(
        proj(lp["att"]["q"]), proj(lp["att"]["k"]), proj(lp["att"]["v"]),
        causal=False)
    x = x + layers.dense_apply(lp["att"]["out"], attended.reshape(b, t, -1))
    y = layers.layernorm_apply(lp["ln2"], x)
    return x + layers.dense_apply(
        lp["wo"], layers.gelu(layers.dense_apply(lp["wi"], y)))


def apply(params, images, cfg: ViTConfig = VIT_BASE_16, *, device=None):
    """images ``[B, H, W, C]`` -> logits ``[B, num_classes]`` in f32."""
    device = resolve_device(device)
    images = torch.as_tensor(images, device=device)
    b = images.shape[0]
    x = layers.dense_apply(params["patch"],
                           _patchify(images, cfg).to(cfg.dtype))
    if cfg.pooling == "cls":
        cls = params["cls"].to(cfg.dtype).expand(b, 1, cfg.dim)
        x = torch.cat([cls, x], dim=1)
    x = x + params["pos"].to(cfg.dtype)[None]
    body = layers.remat_wrap(_layer, cfg.remat, cfg.remat_policy)
    for lp in params["layers"]:
        x = body(lp, x, cfg=cfg)
    x = layers.layernorm_apply(params["ln_f"], x)
    pooled = x[:, 0] if cfg.pooling == "cls" else x.mean(dim=1)
    return layers.dense_apply(params["head"], pooled, dtype=torch.float32)


def loss_fn(params, batch: Dict[str, Any], cfg: ViTConfig = VIT_BASE_16, *,
            device=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean cross-entropy over ``batch = {"image": [B, H, W, C], "label":
    [B]}``; returns ``(loss, {"loss", "accuracy"})``."""
    device = resolve_device(device)
    logits = apply(params, batch["image"], cfg, device=device)
    labels = torch.as_tensor(batch["label"], device=device).long()
    log_probs = F.log_softmax(logits, dim=-1)
    loss = -log_probs.gather(-1, labels[:, None]).mean()
    accuracy = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": accuracy}
