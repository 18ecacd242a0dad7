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

Training under a mesh (``mesh=``, or the installed global mesh, of more
than one rank) follows :func:`param_logical_axes`, the JAX package's
table: ``embed`` over ``fsdp``, the heads and hidden units over ``tp``
(column- and row-split as BERT's, ``models/bert.py``).  Under ``sp`` each
rank keeps its contiguous block of the sequence and attention runs the
ring; ``"gap"`` pooling sums the block in f32, sums that over ``sp``
differentiably and divides by the global T (196 at 224 px: 98 a rank on
two), and ``"cls"`` reads sp rank 0's position 0 as BERT's pooler does.
A sequence the ``sp`` size does not divide (``"cls"``'s 197) raises, as
the JAX package's ring does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import layers
from cloud_tpu_torch.ops import flash_attention as flash_lib
from cloud_tpu_torch.parallel import sharding, tensor_parallel


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


def param_logical_axes(cfg: ViTConfig = VIT_BASE_16):
    """The JAX package's logical axes, in the port's layout (the layer
    list a ``sharding.LayerStack``)."""
    axes = {
        "patch": layers.dense_axes(None, "embed"),
        "pos": (None, "embed"),
        "layers": sharding.LayerStack(
            [layers.encoder_block_axes()] * cfg.num_layers),
        "ln_f": {"scale": (None,), "bias": (None,)},
        "head": layers.dense_axes("embed", None),
    }
    if cfg.pooling == "cls":
        axes["cls"] = ("embed",)
    return axes


def _layer(lp, x, *, cfg: ViTConfig, ctx=None):
    b, t, _ = x.shape
    hd = cfg.head_dim
    y = layers.layernorm_apply(lp["ln1"], x)
    y = ctx.copy(y) if ctx is not None else y

    def proj(p):
        return layers.dense_apply(p, y).reshape(b, t, -1, hd)

    q, k, v = (proj(lp["att"][n]) for n in ("q", "k", "v"))
    if ctx is None:
        attended = flash_lib.flash_attention(q, k, v, causal=False)
    else:
        attended = layers.sharded_attention(q, k, v, causal=False,
                                            rules=ctx.rules, mesh=ctx.mesh)
    x = x + layers.row_parallel_dense(lp["att"]["out"],
                                      attended.reshape(b, t, -1), ctx)
    y = layers.layernorm_apply(lp["ln2"], x)
    y = ctx.copy(y) if ctx is not None else y
    return x + layers.row_parallel_dense(
        lp["wo"], layers.gelu(layers.dense_apply(lp["wi"], y)), ctx)


def apply(params, images, cfg: ViTConfig = VIT_BASE_16, *, device=None,
          mesh=None, rules=None):
    """images ``[B, H, W, C]`` -> logits ``[B, num_classes]`` in f32
    (under a mesh: this rank's rows)."""
    ctx = tensor_parallel.mesh_context(cfg, mesh, rules)
    if device is None and ctx is not None:
        device = ctx.mesh.device
    return _apply(params, images, cfg, resolve_device(device), ctx)


def _apply(params, images, cfg: ViTConfig, device, ctx):
    images = torch.as_tensor(images, device=device)
    b = images.shape[0]
    x = layers.dense_apply(params["patch"],
                           _patchify(images, cfg).to(cfg.dtype))
    if cfg.pooling == "cls":
        cls = params["cls"].to(cfg.dtype).expand(b, 1, cfg.dim)
        x = torch.cat([cls, x], dim=1)
    x = x + params["pos"].to(cfg.dtype)[None]
    t = x.shape[1]
    sp = ctx is not None and ctx.sp_size > 1
    if sp:
        start, stop = ctx.seq_bounds(t)
        x = x[:, start:stop]
    body = layers.remat_wrap(_layer, cfg.remat, cfg.remat_policy)
    for lp in params["layers"]:
        x = body(lp, x, cfg=cfg, ctx=ctx)
    x = layers.layernorm_apply(params["ln_f"], x)
    if cfg.pooling == "cls":
        pooled = x[:, 0]
        if sp:
            pooled = ctx.sum_over_seq(pooled * float(ctx.sp_index == 0))
    elif sp:
        pooled = (ctx.sum_over_seq(x.float().sum(dim=1)) / t).to(x.dtype)
    else:
        pooled = x.mean(dim=1)
    return layers.dense_apply(params["head"], pooled, dtype=torch.float32)


def loss_fn(params, batch: Dict[str, Any], cfg: ViTConfig = VIT_BASE_16, *,
            device=None, mesh=None, rules=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean cross-entropy over ``batch = {"image": [B, H, W, C], "label":
    [B]}``; returns ``(loss, {"loss", "accuracy"})``.  Under a mesh of more
    than one rank ``batch`` is this rank's rows and the loss its share of
    the global loss; the metrics are the global values."""
    ctx = tensor_parallel.mesh_context(cfg, mesh, rules)
    if device is None and ctx is not None:
        device = ctx.mesh.device
    device = resolve_device(device)
    logits = _apply(params, batch["image"], cfg, device, ctx)
    if ctx is not None:
        return layers.classification_loss(logits, batch["label"], ctx.mesh,
                                          replicas=ctx.sp_size)
    labels = torch.as_tensor(batch["label"], device=device).long()
    log_probs = F.log_softmax(logits, dim=-1)
    loss = -log_probs.gather(-1, labels[:, None]).mean()
    accuracy = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": accuracy}


#: Under a mesh, :func:`loss_fn` returns its rank's share of the global
#: loss: the kind ``training.train``'s step under a mesh takes.
loss_fn.mesh_loss = True
