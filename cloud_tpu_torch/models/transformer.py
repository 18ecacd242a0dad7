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

Tensor parallelism: params cut to one rank's shard
(``parallel/tensor_parallel.py``, :func:`param_logical_axes`) carry their
``TensorParallel`` under ``params["tp"]``; the forward pass then runs a
rank's heads and hidden units and calls the collectives where the JAX
package's GSPMD inserts them.

Training under a mesh: :func:`apply`, :func:`apply_hidden` and
:func:`loss_fn` take ``mesh=`` and ``rules=`` as the JAX package's do
(the installed global mesh when ``mesh`` is None) and build a
``parallel.tensor_parallel.TrainContext``.  Each rank runs its heads and
hidden units (``tp``) on its rows (``dp``, ``fsdp``) and its block of
the sequence (``sp``): ``apply_hidden`` permutes tokens and positions
for ``zigzag_sp`` and keeps the rank's block, attention goes through
``layers.sharded_attention`` (the ring, or Ulysses with ``ulysses_sp``),
and ``loss_fn`` returns this rank's share of the GLOBAL loss (its
numerator over the weight total of every rank) with the global value in
its metrics.  With ``pp`` > 1 and rules that map ``layers`` to ``pp``
(``_is_pipelined``, the JAX package's test) the rank holds its stage's
block of layers and the stack runs as a GPipe pipeline of
``num_microbatches`` microbatches (``parallel/pipeline.py``); the rank's
rows are then ``pipeline.microbatch_rows`` of the global batch.  With
``moe`` set, each layer's MLP is
:func:`cloud_tpu_torch.models.moe.moe_mlp_apply` (under a mesh its
experts split over ``ep`` and its auxiliary loss is the global batch's)
and the forward pass returns the layers' summed auxiliary loss beside
the logits; under a pipeline, the mean of the microbatches' as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import layers
from cloud_tpu_torch.models.moe import MoeConfig, moe_mlp_apply, moe_mlp_axes
from cloud_tpu_torch.ops import flash_attention as flash_lib
from cloud_tpu_torch.ops.fused_cross_entropy import fused_linear_cross_entropy
from cloud_tpu_torch.parallel import mesh as mesh_lib
from cloud_tpu_torch.parallel import pipeline as pipeline_lib
from cloud_tpu_torch.parallel import sharding, tensor_parallel


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    dim: int = 768
    num_heads: int = 12
    head_dim: int = 64
    mlp_hidden: int = 3072
    max_seq_len: int = 2048
    #: Mixture-of-experts MLP; ``None`` is the dense SwiGLU MLP.
    moe: Optional[MoeConfig] = None
    dtype: torch.dtype = torch.bfloat16
    #: Recompute each layer in the backward pass (``layers.remat_wrap``):
    #: policy "full" or "dots".
    remat: bool = True
    remat_policy: str = "full"
    rope_base: float = 10000.0
    #: Pipeline microbatches (pp > 1); None -> the pp size.  The bubble
    #: is (pp-1)/(M+pp-1) of the step.
    num_microbatches: Optional[int] = None
    #: Tie the LM head to the token embedding (logits = x @ table^T).
    tied_embeddings: bool = False
    #: Sequence-parallel attention layouts; act only under a mesh with
    #: sp > 1.
    zigzag_sp: bool = False
    ulysses_sp: bool = False
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


def qkv_project(att_params, x, positions, config: TransformerConfig):
    """RoPE'd q/k and v projections ``[B, T, H, hd]``, shared by the
    forward pass and generation's prefill/decode.  ``H`` is the heads the
    projection holds: ``config.num_heads``, or a tensor-parallel rank's
    share of them."""
    b, t, _ = x.shape
    hd = config.head_dim

    def proj(p):
        return layers.dense_apply(p, x).reshape(b, t, -1, hd)

    q = layers.rotary_embedding(proj(att_params["q"]), positions,
                                base=config.rope_base)
    k = layers.rotary_embedding(proj(att_params["k"]), positions,
                                base=config.rope_base)
    v = proj(att_params["v"])
    return q, k, v


def _layer_compute(layer_params, x, aux, *, config, positions, tp=None):
    """One block on ``(x [B, T, D], aux)``; an MoE MLP adds its
    auxiliary loss to ``aux``.  ``tp``: the params are a tensor-parallel
    shard."""
    b, t, _ = x.shape
    y = layers.rmsnorm_apply(layer_params["ln1"], x)
    if tp is not None:
        y = tp.copy(y)
    q, k, v = qkv_project(layer_params["att"], y, positions, config)
    if isinstance(tp, tensor_parallel.TrainContext):
        attended = layers.sharded_attention(
            q, k, v, causal=True, rules=tp.rules, mesh=tp.mesh,
            zigzag=config.zigzag_sp, ulysses=config.ulysses_sp)
    else:
        attended = flash_lib.flash_attention(q, k, v, causal=True)
    x = x + layers.row_parallel_dense(layer_params["att"]["out"],
                                      attended.reshape(b, t, -1), tp)
    y = layers.rmsnorm_apply(layer_params["ln2"], x)
    if config.moe is not None:
        mlp_out, layer_aux = moe_mlp_apply(
            layer_params["mlp"], y, config.moe,
            ctx=tp if isinstance(tp, tensor_parallel.TrainContext) else None)
        aux = aux + layer_aux
    else:
        mlp_out = layers.mlp_block_apply(layer_params["mlp"], y, tp=tp)
    return x + mlp_out, aux


def _context(params, config: TransformerConfig, mesh, rules):
    """The params' own ``TensorParallel`` (a serving shard), else the
    :class:`TrainContext` of ``mesh`` (or the installed global mesh),
    else None (one card)."""
    if config.zigzag_sp and config.ulysses_sp:
        raise ValueError(
            "zigzag_sp and ulysses_sp are mutually exclusive sp strategies"
        )
    tp = params.get("tp")
    if tp is not None:
        return tp
    mesh = mesh if mesh is not None else mesh_lib.get_global_mesh()
    if mesh is None:
        return None
    return tensor_parallel.train_context(mesh, config,
                                         rules or sharding.DEFAULT_RULES)


def _is_pipelined(config: TransformerConfig, rules, mesh) -> bool:
    """pp > 1 and the rules map ``layers`` to ``pp`` (read with ``.get``:
    a table without a ``layers`` entry keeps the plain stack), as the
    JAX package decides."""
    if mesh is None:
        return False
    if mesh.axis_size(mesh_lib.AXIS_PP) <= 1:
        return False
    assignment = (rules or sharding.DEFAULT_RULES).rules.get("layers")
    return mesh_lib.AXIS_PP in sharding.mesh_axes(assignment)


def num_microbatches(config: TransformerConfig, mesh) -> int:
    """The pipeline's microbatch count: ``config.num_microbatches``, else
    the ``pp`` size."""
    return config.num_microbatches or mesh.axis_size(mesh_lib.AXIS_PP)


def _check_microbatches(config: TransformerConfig, tp, rows: int) -> int:
    """The microbatch count, checked against this rank's ``rows``: the
    global batch (every data rank's rows) must divide by it, with the
    JAX package's message, and so must the rank's share."""
    m = num_microbatches(config, tp.mesh)
    total = rows * tp.data_size
    if total % m:
        raise ValueError(
            f"Global batch {total} not divisible by num_microbatches={m} "
            f"(pp={tp.pp_size}); set config.num_microbatches accordingly.")
    if rows % m:
        raise ValueError(
            f"this rank's {rows} rows (global batch {total} over "
            f"{tp.data_size} data ranks) do not split into "
            f"num_microbatches={m}: a global microbatch must divide over "
            "dp x fsdp")
    return m


def _pipelined_stack(params, x, aux, config: TransformerConfig, tp,
                     positions, m: int):
    """The stage's layers as a GPipe pipeline over ``pp``
    (``parallel/pipeline.py``) on ``m`` microbatches of this rank's rows
    (its share of each global microbatch, ``pipeline.microbatch_rows``).
    Returns the hidden states and the mean of the microbatches' summed
    auxiliary losses (JAX's gradient-accumulation scale)."""
    b, t, d = x.shape
    body = layers.remat_wrap(_layer_compute, config.remat,
                             config.remat_policy)
    positions = positions[: b // m]

    def pipe_layer(layer_params, carry):
        xc, aux_c = carry
        return body(layer_params, xc, aux_c, config=config,
                    positions=positions, tp=tp)

    x_mbs, aux_mbs = pipeline_lib.pipeline(
        pipe_layer, params["layers"],
        (x.reshape(m, b // m, t, d), aux.expand(m).clone()), mesh=tp.mesh)
    return x_mbs.reshape(b, t, d), aux_mbs.sum() / m


def _device(ctx, device):
    if device is None and isinstance(ctx, tensor_parallel.TrainContext):
        return ctx.mesh.device
    return resolve_device(device)


def _positions(ctx, t: int, config: TransformerConfig, device):
    """Global positions of the slots this rank computes: ``arange(t)``,
    permuted by the zig-zag layout when it is active, cut to the rank's
    ``sp`` block."""
    pos = torch.arange(t, device=device)
    if not isinstance(ctx, tensor_parallel.TrainContext) or ctx.sp_size == 1:
        return pos
    from cloud_tpu_torch.parallel import ring_attention

    sp = ctx.sp_size
    if config.zigzag_sp:
        pos = ring_attention.zigzag_indices(t, sp, device=device)
    elif t % sp:
        raise ValueError(f"seq_len {t} does not divide by sp={sp}")
    block = t // sp
    return pos[ctx.sp_index * block:(ctx.sp_index + 1) * block]


def apply_hidden(params, tokens, config: TransformerConfig, *, device=None,
                 mesh=None, rules=None):
    """Forward pass up to the final norm: tokens ``[B, T]`` ->
    ``(hidden [B, T, D], aux)``, ``aux`` the f32 sum of the MoE layers'
    auxiliary losses (zero for the dense MLP).  Under a training mesh the
    hidden states are the rank's ``sp`` block of the sequence, in the
    zig-zag order when ``zigzag_sp`` is active."""
    tp = _context(params, config, mesh, rules)
    return _apply_hidden(params, tokens, config, tp, _device(tp, device))


def _apply_hidden(params, tokens, config: TransformerConfig, tp, device):
    tokens = torch.as_tensor(tokens, device=device)
    b, t = tokens.shape
    pipelined = (isinstance(tp, tensor_parallel.TrainContext)
                 and _is_pipelined(config, tp.rules, tp.mesh))
    if pipelined:
        if config.zigzag_sp and tp.sp_size > 1:
            raise ValueError("zigzag_sp is incompatible with pp pipelining")
        m = _check_microbatches(config, tp, b)
    pos = _positions(tp, t, config, device)
    if pos.shape[0] != t:
        tokens = tokens[:, pos]
    x = layers.embedding_apply(params["embed"], tokens, dtype=config.dtype,
                               tp=tp)
    x = x * math.sqrt(config.dim)  # stays in config.dtype, as in JAX
    positions = pos.expand(b, pos.shape[0])
    aux = torch.zeros((), dtype=torch.float32, device=device)
    if pipelined:
        x, aux = _pipelined_stack(params, x, aux, config, tp, positions, m)
        return layers.rmsnorm_apply(params["ln_f"], x), aux
    body = layers.remat_wrap(_layer_compute, config.remat,
                             config.remat_policy)
    for layer_params in params["layers"]:
        x, aux = body(layer_params, x, aux, config=config,
                      positions=positions, tp=tp)
    return layers.rmsnorm_apply(params["ln_f"], x), aux


def apply(params, tokens, config: TransformerConfig, *, device=None,
          mesh=None, rules=None):
    """Forward pass: tokens ``[B, T]`` -> ``(logits [B, T, V] f32, aux)``;
    ``aux`` is the MoE auxiliary loss, zero for the dense MLP.  Under a
    training mesh, the logits of the rank's ``sp`` block (zig-zag order
    with ``zigzag_sp``), every vocabulary column."""
    tp = _context(params, config, mesh, rules)
    x, aux = _apply_hidden(params, tokens, config, tp, _device(tp, device))
    return lm_logits(params, x, config, tp=tp), aux


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


def lm_logits(params, x, config: TransformerConfig, *, tp=None):
    """Final vocabulary projection in f32.  An int8 head or tied table
    takes the post-scale route, ``(x @ q) * scale``, in f32.  A
    tensor-parallel shard (``params["tp"]``, or ``tp`` in training) with a
    split vocabulary computes its own columns and gathers every rank's, in
    order: the one reshard of a forward pass, at the sampling boundary."""
    tp = tp if tp is not None else params.get("tp")
    if tp is not None and tp.vocab_split:
        return tp.gather_vocab(_local_logits(params, tp.copy(x), config))
    return _local_logits(params, x, config)


def _local_logits(params, x, config: TransformerConfig):
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


def param_logical_axes(config: TransformerConfig):
    """The logical axes of every leaf of :func:`cloud_tpu_torch.bridge.
    init`'s params, in the port's layout: the table
    ``cloud_tpu/models/transformer.py`` ``param_logical_axes`` keeps,
    with the stacked ``layers`` axis as a ``sharding.LayerStack`` of
    per-layer trees (cut over ``pp`` where the rules say so)."""
    att = {name: {"kernel": ("embed", "heads")} for name in ("q", "k", "v")}
    att["out"] = {"kernel": ("heads", "embed")}
    if config.moe is not None:
        mlp = moe_mlp_axes()
    else:
        mlp = {"wi": {"kernel": ("embed", "mlp")},
               "wg": {"kernel": ("embed", "mlp")},
               "wo": {"kernel": ("mlp", "embed")}}
    layer = {"att": att, "ln1": {"scale": (None,)}, "mlp": mlp,
             "ln2": {"scale": (None,)}}
    axes = {
        "embed": {"table": ("vocab", "embed")},
        "layers": sharding.LayerStack([layer] * config.num_layers),
        "ln_f": {"scale": (None,)},
    }
    if not config.tied_embeddings:
        axes["head"] = {"kernel": ("embed", "vocab")}
    return axes


def _mesh_loss(params, batch, config, tp, device):
    """:func:`loss_fn` under a training mesh.  The loss is JAX's global
    ``sum(nll * w) / max(sum(w), 1)`` over every rank's rows and
    positions: this rank returns its numerator over the global weight
    total (a constant), so the step's sum of the ranks' gradients over
    the data axes is the global loss's gradient; the metrics carry the
    global value, the same on every rank.  With ``fused_ce`` and the
    vocabulary split over ``tp``, each rank scans its own shard
    (``ops.fused_cross_entropy``'s ``tp=``)."""
    tokens = torch.as_tensor(batch["tokens"], device=device)
    t = tokens.shape[1]
    # Slot j predicts global position pos[j] + 1, from the rank's whole
    # row, so the shift crosses sp blocks; then the rank's block.
    pos = _positions(tp, t, config, device)
    target_idx = torch.clamp(pos + 1, max=t - 1)
    targets = tokens[:, target_idx].long()
    weights = (pos < t - 1).float()[None, :].expand(tokens.shape[0],
                                                    pos.shape[0])
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=device).float()
        weights = weights * mask[:, target_idx]
    w_local = weights.sum()
    hidden, aux = _apply_hidden(params, tokens, config, tp, device)
    if config.fused_ce:
        table, layout = head_table(params, config)
        mean = fused_linear_cross_entropy(hidden, table, targets,
                                          table_layout=layout,
                                          weights=weights, tp=tp)
        num = mean * torch.clamp(w_local, min=1.0)
    else:
        logits = lm_logits(params, hidden, config, tp=tp)
        log_probs = F.log_softmax(logits, dim=-1)
        nll = -log_probs.gather(-1, targets[..., None])[..., 0]
        num = (nll * weights).sum()
    total = torch.clamp(tp.sum_over_data(w_local.detach()), min=1.0)
    ce = tp.sum_over_data(num.detach()) / total
    loss = ce + aux
    return num / total + aux, {"loss": loss, "ce": ce, "aux": aux}


def loss_fn(params, batch: Dict[str, Any], config: TransformerConfig, *,
            device=None, mesh=None, rules=None):
    """Next-token cross-entropy; ``batch = {"tokens": [B, T]}``, optionally
    ``"loss_mask"`` [B, T] gating the loss at each target position.
    Returns ``(loss, {"loss", "ce", "aux"})``.  Under a training mesh
    (``mesh``, or the installed global mesh) ``batch`` is this rank's rows
    (whole sequences) and the returned loss is its share of the global
    loss (see :func:`_mesh_loss`)."""
    tp = _context(params, config, mesh, rules)
    if isinstance(tp, tensor_parallel.TrainContext):
        return _mesh_loss(params, batch, config, tp, _device(tp, device))
    device = resolve_device(device)
    tokens = torch.as_tensor(batch["tokens"], device=device)
    if config.fused_ce:
        hidden, aux = apply_hidden(params, tokens, config, device=device)
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


#: Under a mesh, :func:`loss_fn` returns its rank's share of the global
#: loss: the only kind ``training.train``'s step under a mesh takes
#: (``train.mesh_loss``).
loss_fn.mesh_loss = True
