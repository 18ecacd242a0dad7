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

Dropout (``cfg.dropout_rate``) is on when a ``dropout_rng`` (a threefry
key, ``cloud_tpu_torch.random``) is passed, the training path: on the
embeddings, each layer's attention output and MLP output, and the pooled
head, with the JAX package's keys (the same splits in the same order),
so the masks equal JAX's bit for bit.  Without a key the path is
deterministic (eval).

Training under a mesh (``mesh=``, or the installed global mesh, of more
than one rank; ``rules=`` as the JAX package's): :func:`param_logical_axes`
is the JAX package's table, so ``embed`` splits over ``fsdp`` (the step
gathers those leaves whole), the heads and hidden units over ``tp``
(q/k/v and ``wi`` column-split behind one differentiable copy, ``out``
and ``wo`` row-split with one sum, ``parallel/tensor_parallel.py``) and
the token table's vocabulary over ``tp`` (a masked lookup and one sum).
Under ``sp`` each rank embeds its contiguous block of the sequence (the
position table sliced at the block's offset) and attention runs the ring
with the padding mask riding it (``layers.sharded_attention``); the
pooler's ``x[:, 0]`` lives on ``sp`` rank 0 and reaches every rank
through a sum whose transpose is a sum too.  Dropout draws each rank's
block of the global masks (``layers.dropout``'s ``start``/``full``).
:func:`loss_fn` then returns this rank's share of the global mean over
rows (``layers.classification_loss``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from cloud_tpu_torch import random as random_lib
from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import layers
from cloud_tpu_torch.ops import flash_attention as flash_lib
from cloud_tpu_torch.parallel import sharding, tensor_parallel


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


def param_logical_axes(cfg: BertConfig = BERT_BASE):
    """The JAX package's logical axes, in the port's layout (the layer
    list a ``sharding.LayerStack``)."""
    return {
        "tok": {"table": ("vocab", "embed")},
        "pos": {"table": (None, "embed")},
        "seg": {"table": (None, "embed")},
        "ln_embed": {"scale": (None,), "bias": (None,)},
        "layers": sharding.LayerStack(
            [layers.encoder_block_axes()] * cfg.num_layers),
        "pooler": layers.dense_axes("embed", None),
        "classifier": layers.dense_axes("embed", None),
    }


def _block_of(ctx, shape):
    """``(start, full)`` of this rank's block ``shape`` (rows first, then
    the sequence when ``shape`` has one) of a global activation, for
    ``layers.dropout``; ``(None, None)`` without a mesh."""
    if ctx is None:
        return None, None
    start = [ctx.data_index * shape[0]] + [0] * (len(shape) - 1)
    full = [shape[0] * ctx.data_size] + list(shape[1:])
    if len(shape) == 3:
        start[1] = ctx.sp_index * shape[1]
        full[1] = shape[1] * ctx.sp_size
    return tuple(start), tuple(full)


def _layer(lp, x, *, cfg: BertConfig, mask, att_rng=None, mlp_rng=None,
           ctx=None):
    b, t, _ = x.shape
    hd = cfg.head_dim
    start, full = _block_of(ctx, x.shape)
    y = ctx.copy(x) if ctx is not None else x

    def proj(p):
        return layers.dense_apply(p, y).reshape(b, t, -1, hd)

    q, k, v = (proj(lp["att"][n]) for n in ("q", "k", "v"))
    if ctx is None:
        attended = flash_lib.flash_attention(q, k, v, causal=False,
                                             mask=mask)
    else:
        attended = layers.sharded_attention(q, k, v, causal=False, mask=mask,
                                            rules=ctx.rules, mesh=ctx.mesh)
    att_out = layers.row_parallel_dense(lp["att"]["out"],
                                        attended.reshape(b, t, -1), ctx)
    att_out = layers.dropout(att_rng, att_out, cfg.dropout_rate,
                             start=start, full=full)
    x = layers.layernorm_apply(lp["ln1"], x + att_out)
    y = ctx.copy(x) if ctx is not None else x
    mlp = layers.row_parallel_dense(
        lp["wo"], layers.gelu(layers.dense_apply(lp["wi"], y)), ctx)
    mlp = layers.dropout(mlp_rng, mlp, cfg.dropout_rate, start=start,
                         full=full)
    return layers.layernorm_apply(lp["ln2"], x + mlp)


def encode(params, tokens, cfg: BertConfig = BERT_BASE, *,
           attention_mask: Optional[torch.Tensor] = None,
           segment_ids: Optional[torch.Tensor] = None,
           dropout_rng=None, device=None, mesh=None, rules=None):
    """tokens ``[B, T]`` -> contextual embeddings ``[B, T, D]`` (under a
    mesh: this rank's rows, and its ``sp`` block of the sequence).

    ``dropout_rng`` switches on ``cfg.dropout_rate`` dropout (training);
    None (the default) is the deterministic eval path."""
    ctx = tensor_parallel.mesh_context(cfg, mesh, rules)
    return _encode(params, tokens, cfg, attention_mask, segment_ids,
                   dropout_rng, _device(ctx, device), ctx)


def _device(ctx, device):
    if device is None and ctx is not None:
        return ctx.mesh.device
    return resolve_device(device)


def _encode(params, tokens, cfg, attention_mask, segment_ids, dropout_rng,
            device, ctx):
    rate = cfg.dropout_rate if dropout_rng is not None else 0.0
    embed_rng = layer_rngs = None
    if rate > 0.0:
        embed_rng, stack_rng = random_lib.split(dropout_rng)
        # One key a layer, each split into its attention and MLP keys:
        # [L, 2, 2], JAX's ``split(stack_rng, L)`` and then ``split`` of
        # each in its layer scan.
        layer_rngs = random_lib.split(
            random_lib.split(stack_rng, cfg.num_layers))
    tokens = torch.as_tensor(tokens, device=device)
    start, stop = (0, tokens.shape[1]) if ctx is None else ctx.seq_bounds(
        tokens.shape[1])
    tokens = tokens[:, start:stop]
    x = layers.embedding_apply(params["tok"], tokens, dtype=cfg.dtype,
                               tp=ctx)
    # The positions of this rank's block: [start, stop), not [:t].
    x = x + params["pos"]["table"][start:stop].to(cfg.dtype)[None]
    if segment_ids is not None:
        x = x + layers.embedding_apply(
            params["seg"],
            torch.as_tensor(segment_ids, device=device)[:, start:stop],
            dtype=cfg.dtype)
    x = layers.layernorm_apply(params["ln_embed"], x)
    x = layers.dropout(embed_rng, x, rate, *_block_of(ctx, x.shape))
    if attention_mask is not None:
        attention_mask = torch.as_tensor(attention_mask,
                                         device=device)[:, start:stop]
    body = layers.remat_wrap(_layer, cfg.remat != "none", cfg.remat)
    for i, lp in enumerate(params["layers"]):
        keys = {} if layer_rngs is None else {
            "att_rng": layer_rngs[i, 0], "mlp_rng": layer_rngs[i, 1]}
        x = body(lp, x, cfg=cfg, mask=attention_mask, ctx=ctx, **keys)
    return x


def apply(params, tokens, cfg: BertConfig = BERT_BASE, *,
          attention_mask: Optional[torch.Tensor] = None,
          segment_ids: Optional[torch.Tensor] = None,
          dropout_rng=None, device=None, mesh=None, rules=None):
    """Sequence classification: tokens ``[B, T]`` -> logits
    ``[B, num_classes]`` in f32 (under a mesh: this rank's rows, the
    same on every rank of its row block)."""
    ctx = tensor_parallel.mesh_context(cfg, mesh, rules)
    return _apply(params, tokens, cfg, attention_mask, segment_ids,
                  dropout_rng, _device(ctx, device), ctx)


def _apply(params, tokens, cfg, attention_mask, segment_ids, dropout_rng,
           device, ctx):
    head_rng = None
    if dropout_rng is not None and cfg.dropout_rate > 0.0:
        dropout_rng, head_rng = random_lib.split(dropout_rng)
    x = _encode(params, tokens, cfg, attention_mask, segment_ids,
                dropout_rng, device, ctx)
    first = x[:, 0]
    if ctx is not None and ctx.sp_size > 1:
        # Position 0 is sp rank 0's; the product keeps every rank's
        # encoder in the graph, so each runs its half of the ring's
        # backward.
        first = ctx.sum_over_seq(first * float(ctx.sp_index == 0))
    pooled = torch.tanh(layers.dense_apply(params["pooler"], first))
    pooled = layers.dropout(head_rng, pooled, cfg.dropout_rate,
                            *_block_of(ctx, pooled.shape))
    return layers.dense_apply(params["classifier"], pooled,
                              dtype=torch.float32)


def loss_fn(params, batch: Dict[str, Any], cfg: BertConfig = BERT_BASE, *,
            rng=None, device=None, mesh=None, rules=None):
    """Mean cross-entropy over ``batch["label"]``; returns
    ``(loss, {"loss", "accuracy"})``.  Under a mesh of more than one rank
    ``batch`` is this rank's rows (whole sequences) and the loss its share
    of the global loss; the metrics are the global values."""
    ctx = tensor_parallel.mesh_context(cfg, mesh, rules)
    device = _device(ctx, device)
    logits = _apply(params, batch["tokens"], cfg,
                    batch.get("attention_mask"), batch.get("segment_ids"),
                    rng, device, ctx)
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
