"""CloudLM, the decoder-only transformer (port of ``cloud_tpu/models/transformer.py``).

Pre-RMSNorm, RoPE, SwiGLU MLP, optional tied head.  Parameters are the
dict that :mod:`cloud_tpu_torch.bridge` builds: the JAX package's names,
with the stacked layer axis split into a Python list ``params["layers"]``
that the forward pass walks in a plain loop, each layer wrapped in the
config's remat policy.  Causal attention goes through
:func:`cloud_tpu_torch.ops.flash_attention.flash_attention`, differentiable
through the flash backward kernels.  :func:`loss_fn` is the next-token
cross-entropy of training, with the plain and the fused (chunked-vocab)
branch.

The port serves one card: the JAX package's mesh layouts (tp/sp/pp,
zig-zag and Ulysses sequence parallelism) have no counterpart here, and
MoE layers come with a later slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import layers
from cloud_tpu_torch.ops import flash_attention as flash_lib
from cloud_tpu_torch.ops.fused_cross_entropy import fused_linear_cross_entropy


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    dim: int = 768
    num_heads: int = 12
    head_dim: int = 64
    mlp_hidden: int = 3072
    max_seq_len: int = 2048
    #: Mixture-of-experts MLP; only ``None`` (dense SwiGLU) in this slice.
    moe: Optional[Any] = None
    dtype: torch.dtype = torch.bfloat16
    rope_base: float = 10000.0
    #: Tie the LM head to the token embedding (logits = x @ table^T).
    tied_embeddings: bool = False
    #: Recompute each layer in the backward pass (``layers.remat_wrap``).
    remat: bool = True
    remat_policy: str = "full"
    #: Training loss through ``ops.fused_cross_entropy``: the [B, T, V]
    #: logits are never materialized.
    fused_ce: bool = False

    def scaled(self, **kw) -> "TransformerConfig":
        return dataclasses.replace(self, **kw)


#: Tiny config for tests.
TINY = TransformerConfig(
    vocab_size=256, num_layers=4, dim=64, num_heads=4, head_dim=16,
    mlp_hidden=128, max_seq_len=128, remat=False,
)

#: ~124M-parameter single-chip config (GPT-2-small shape).
SMALL = TransformerConfig(
    vocab_size=32000, num_layers=12, dim=768, num_heads=12, head_dim=64,
    mlp_hidden=3072, max_seq_len=1024,
)


def check_supported(config: TransformerConfig) -> None:
    if config.moe is not None:
        raise NotImplementedError(
            "MoE layers come with a later slice of the port (ROADMAP.md)"
        )


def qkv_project(att_params, x, positions, config: TransformerConfig):
    """RoPE'd q/k and v projections ``[B, T, H, hd]``, shared by the
    forward pass and generation's prefill/decode."""
    b, t, _ = x.shape
    h, hd = config.num_heads, config.head_dim

    def proj(p):
        return layers.dense_apply(p, x).reshape(b, t, h, hd)

    q = layers.rotary_embedding(proj(att_params["q"]), positions,
                                base=config.rope_base)
    k = layers.rotary_embedding(proj(att_params["k"]), positions,
                                base=config.rope_base)
    v = proj(att_params["v"])
    return q, k, v


def _layer_compute(layer_params, x, *, config, positions):
    b, t, _ = x.shape
    y = layers.rmsnorm_apply(layer_params["ln1"], x)
    q, k, v = qkv_project(layer_params["att"], y, positions, config)
    attended = flash_lib.flash_attention(q, k, v, causal=True)
    x = x + layers.dense_apply(layer_params["att"]["out"],
                               attended.reshape(b, t, -1))
    y = layers.rmsnorm_apply(layer_params["ln2"], x)
    return x + layers.mlp_block_apply(layer_params["mlp"], y)


def apply_hidden(params, tokens, config: TransformerConfig, *, device=None):
    """Forward pass up to the final norm: tokens ``[B, T]`` -> hidden
    ``[B, T, D]``."""
    check_supported(config)
    device = resolve_device(device)
    tokens = torch.as_tensor(tokens, device=device)
    b, t = tokens.shape
    x = layers.embedding_apply(params["embed"], tokens, dtype=config.dtype)
    x = x * math.sqrt(config.dim)  # stays in config.dtype, as in JAX
    positions = torch.arange(t, device=device).expand(b, t)
    body = layers.remat_wrap(_layer_compute, config.remat,
                             config.remat_policy)
    for layer_params in params["layers"]:
        x = body(layer_params, x, config=config, positions=positions)
    return layers.rmsnorm_apply(params["ln_f"], x)


def apply(params, tokens, config: TransformerConfig, *, device=None):
    """Forward pass: tokens ``[B, T]`` -> ``(logits [B, T, V] f32, aux)``;
    ``aux`` is the MoE auxiliary loss, zero for the dense MLP."""
    x = apply_hidden(params, tokens, config, device=device)
    return lm_logits(params, x, config), torch.zeros((), device=x.device)


def head_table(params, config: TransformerConfig):
    """``(table, layout)`` of the vocabulary projection: ``"vd"`` is the
    tied embedding table ``[V, D]``, ``"dv"`` the dense head ``[D, V]``.
    An int8 leaf comes back materialized in f32 (the fused-CE consumer);
    :func:`lm_logits` takes the post-scale route instead."""
    if config.tied_embeddings:
        embed = params["embed"]
        if "table_q" in embed:
            return layers.materialize_matrix(embed, "table", torch.float32), "vd"
        return embed["table"], "vd"
    head = params["head"]
    extra = set(head) - {"kernel", "kernel_q", "kernel_scale"}
    if extra:
        raise NotImplementedError(
            f"head has params beyond 'kernel' ({sorted(extra)}); "
            "bias-free heads only"
        )
    if "kernel_q" in head:
        return layers.materialize_matrix(head, "kernel", torch.float32), "dv"
    return head["kernel"], "dv"


def lm_logits(params, x, config: TransformerConfig):
    """Final vocabulary projection in f32.  An int8 head or tied table
    takes the post-scale route, ``(x @ q) * scale``, in f32."""
    x = x.float()
    if config.tied_embeddings and "table_q" in params["embed"]:
        embed = params["embed"]
        logits = torch.matmul(x, embed["table_q"].float().t())
        return logits * embed["table_scale"][:, 0].float()
    if not config.tied_embeddings and "kernel_q" in params["head"]:
        head = params["head"]
        extra = set(head) - {"kernel_q", "kernel_scale"}
        if extra:
            raise NotImplementedError(
                f"quantized head has extra params {sorted(extra)}"
            )
        logits = torch.matmul(x, head["kernel_q"].float())
        return logits * head["kernel_scale"][0].float()
    table, layout = head_table(params, config)
    table = table.float()
    if layout == "vd":
        return torch.matmul(x, table.t())
    return torch.matmul(x, table)


def loss_fn(params, batch: Dict[str, Any], config: TransformerConfig, *,
            device=None):
    """Next-token cross-entropy; ``batch = {"tokens": [B, T]}``, optionally
    ``"loss_mask"`` [B, T] gating the loss at each target position.
    Returns ``(loss, {"loss", "ce", "aux"})``."""
    device = resolve_device(device)
    tokens = torch.as_tensor(batch["tokens"], device=device)
    if config.fused_ce:
        hidden = apply_hidden(params, tokens, config, device=device)
        aux = torch.zeros((), device=device)
    else:
        logits, aux = apply(params, tokens, config, device=device)
    t = tokens.shape[1]
    pos = torch.arange(t, device=device)
    target_idx = torch.clamp(pos + 1, max=t - 1)
    targets = tokens[:, target_idx].long()
    weights = (pos < t - 1).float()[None, :]
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=device).float()
        weights = weights * mask[:, target_idx]
    if config.fused_ce:
        table, layout = head_table(params, config)
        ce = fused_linear_cross_entropy(hidden, table, targets,
                                        table_layout=layout, weights=weights)
    else:
        log_probs = F.log_softmax(logits, dim=-1)
        nll = -log_probs.gather(-1, targets[..., None])[..., 0]
        weights = weights.expand(nll.shape)
        ce = (nll * weights).sum() / torch.clamp(weights.sum(), min=1.0)
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}
