"""BERT-base encoder for fine-tuning (port of ``cloud_tpu/models/bert.py``).

Bidirectional encoder: learned positions (``pos.table[:T]``), optional
segment embeddings, post-attention LayerNorm pairs, a GELU MLP (the tanh
approximation, ``jax.nn.gelu``'s default) and a pooled classification
head (``tanh(dense(x[:, 0]))``, the classifier in f32).  Parameters are
the dict :func:`cloud_tpu_torch.bridge.bert_to_torch` builds: the JAX
package's names with the stacked layer axis split into a list.
Attention goes through
:func:`cloud_tpu_torch.ops.flash_attention.flash_attention` with
``causal=False`` and the optional ``[B, T]`` key-padding mask.

Dropout is not ported: a ``dropout_rng`` with ``dropout_rate > 0``
raises.  Without one the JAX package's path is deterministic too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import layers
from cloud_tpu_torch.ops import flash_attention as flash_lib


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    num_layers: int = 12
    dim: int = 768
    num_heads: int = 12
    mlp_hidden: int = 3072
    max_seq_len: int = 512
    num_classes: int = 2
    dtype: torch.dtype = torch.bfloat16
    dropout_rate: float = 0.0
    #: Remat of each layer: "none", "full" or "dots" (``layers.remat_wrap``).
    remat: str = "none"

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


BERT_BASE = BertConfig()
TINY = BertConfig(
    vocab_size=512, num_layers=2, dim=64, num_heads=4, mlp_hidden=128,
    max_seq_len=64,
)


def _check_dropout(cfg: BertConfig, dropout_rng) -> None:
    if dropout_rng is not None and cfg.dropout_rate > 0.0:
        raise NotImplementedError(
            "BERT dropout (a dropout rng with dropout_rate > 0) is not "
            "ported yet (ROADMAP.md A.6)"
        )


def _layer(lp, x, *, cfg: BertConfig, mask):
    b, t, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim

    def proj(p):
        return layers.dense_apply(p, x).reshape(b, t, h, hd)

    attended = flash_lib.flash_attention(
        proj(lp["att"]["q"]), proj(lp["att"]["k"]), proj(lp["att"]["v"]),
        causal=False, mask=mask)
    att_out = layers.dense_apply(lp["att"]["out"], attended.reshape(b, t, -1))
    x = layers.layernorm_apply(lp["ln1"], x + att_out)
    mlp = layers.dense_apply(
        lp["wo"], layers.gelu(layers.dense_apply(lp["wi"], x)))
    return layers.layernorm_apply(lp["ln2"], x + mlp)


def encode(params, tokens, cfg: BertConfig = BERT_BASE, *,
           attention_mask: Optional[torch.Tensor] = None,
           segment_ids: Optional[torch.Tensor] = None,
           dropout_rng=None, device=None):
    """tokens ``[B, T]`` -> contextual embeddings ``[B, T, D]``."""
    _check_dropout(cfg, dropout_rng)
    device = resolve_device(device)
    tokens = torch.as_tensor(tokens, device=device)
    t = tokens.shape[1]
    x = layers.embedding_apply(params["tok"], tokens, dtype=cfg.dtype)
    x = x + params["pos"]["table"][:t].to(cfg.dtype)[None]
    if segment_ids is not None:
        x = x + layers.embedding_apply(
            params["seg"], torch.as_tensor(segment_ids, device=device),
            dtype=cfg.dtype)
    x = layers.layernorm_apply(params["ln_embed"], x)
    if attention_mask is not None:
        attention_mask = torch.as_tensor(attention_mask, device=device)
    body = layers.remat_wrap(_layer, cfg.remat != "none", cfg.remat)
    for lp in params["layers"]:
        x = body(lp, x, cfg=cfg, mask=attention_mask)
    return x


def apply(params, tokens, cfg: BertConfig = BERT_BASE, *,
          attention_mask: Optional[torch.Tensor] = None,
          segment_ids: Optional[torch.Tensor] = None,
          dropout_rng=None, device=None):
    """Sequence classification: tokens ``[B, T]`` -> logits
    ``[B, num_classes]`` in f32."""
    x = encode(params, tokens, cfg, attention_mask=attention_mask,
               segment_ids=segment_ids, dropout_rng=dropout_rng,
               device=device)
    pooled = torch.tanh(layers.dense_apply(params["pooler"], x[:, 0]))
    return layers.dense_apply(params["classifier"], pooled,
                              dtype=torch.float32)


def loss_fn(params, batch: Dict[str, Any], cfg: BertConfig = BERT_BASE, *,
            rng=None, device=None):
    """Mean cross-entropy over ``batch["label"]``; returns
    ``(loss, {"loss", "accuracy"})``."""
    device = resolve_device(device)
    logits = apply(params, batch["tokens"], cfg,
                   attention_mask=batch.get("attention_mask"),
                   segment_ids=batch.get("segment_ids"), dropout_rng=rng,
                   device=device)
    labels = torch.as_tensor(batch["label"], device=device).long()
    log_probs = F.log_softmax(logits, dim=-1)
    loss = -log_probs.gather(-1, labels[:, None]).mean()
    accuracy = (logits.argmax(-1) == labels).float().mean()
    return loss, {"loss": loss, "accuracy": accuracy}
