"""Mixture-of-experts MLP with capacity-based dense dispatch (port of ``cloud_tpu/models/moe.py``).

GShard-style routing, the JAX package's exactly: the router runs in f32,
each token picks its top-k experts (ties go to the lower expert index, as
``jax.lax.top_k`` breaks them) with the k gates renormalised, and each
(token, choice) takes the next free slot of its expert's buffer in the
order of the flattened ``T * K`` routing sequence of its batch row.  A
choice past the expert's capacity ``C`` is dropped.  Dispatch, the
stacked SwiGLU experts and the combine are plain products
(``torch.einsum``), as the JAX package computes them outside any Pallas
kernel.

On a training mesh (``ctx``) the experts split over ``ep`` and the
auxiliary loss is the global batch's (:func:`moe_mlp_apply`); on a
serving slice (a ``TensorParallel`` ``ctx``) each expert's hidden units
split over ``tp``, a split prefill routes its ``sp`` block as part of
the whole sequence, and the auxiliary loss is not computed.

``C`` is set by the call's ``T`` (:func:`_capacity`), so a prompt routed
through a prefill at a bucket's width, a prefill chunk or a speculative
verify window can drop different choices: the port matches JAX program
for program.

The combine weights ``[B, T, E, C]`` are built from each (token, expert)
slot directly instead of summing a ``[B, T, K, E, C]`` one-hot over k: a
token chooses an expert at most once, so the sum has one nonzero term and
the two give the same numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from cloud_tpu_torch.models import layers
from cloud_tpu_torch.parallel import collectives, ring_attention
from cloud_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    #: Router z-loss (ST-MoE): penalises ``logsumexp(logits)^2``.  0 is off.
    z_loss_weight: float = 0.0


def moe_mlp_axes():
    """Logical axes of the MoE params, the JAX package's table: the
    stacked experts' dim 0 is ``expert`` (``ep`` under the default
    rules), their hidden dim ``mlp`` (``tp``)."""
    return {
        "router": {"kernel": ("embed", None)},
        "wi": ("expert", "embed", "mlp"),
        "wg": ("expert", "embed", "mlp"),
        "wo": ("expert", "mlp", "embed"),
    }


def _capacity(tokens_per_batch: int, cfg: MoeConfig) -> int:
    cap = int(tokens_per_batch * cfg.capacity_factor * cfg.top_k
              / cfg.num_experts)
    return max(cap, cfg.top_k)


def _top_k(gates, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, ties to the
    lower index (a stable descending sort; ``torch.topk`` promises no
    order among equal values)."""
    values, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def moe_mlp_apply(params, x, cfg: MoeConfig, *, ctx=None, aux: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Apply the MoE MLP to ``x [B, T, D]``; returns ``(out [B, T, D],
    aux)``, ``aux`` the f32 load-balancing loss (plus the z-loss), or None
    with ``aux=False`` (serving drops it).

    ``ctx``, a ``parallel.tensor_parallel.TrainContext``, runs the layer
    on a training mesh as the JAX package's GSPMD runs it (``expert`` ->
    ``ep``, ``batch`` -> ``dp`` x ``fsdp``, the sequence -> ``sp``): the
    router, top-k, dispatch and combine run alike on every rank that holds
    these tokens; the rank's experts (``ctx.expert_bounds``, cut as
    ``sharding.shard_bounds`` cuts them) see ``x`` and the combine weights
    through ``ctx.copy_experts`` (their cotangents summed over ``ep``),
    their hidden units split over ``tp`` behind the TP pair, and the
    experts' partial outputs are summed over ``ep`` in f32.  Under ``sp``
    the rank routes its block of the sequence as the JAX layer routes the
    whole: capacity from the global ``T``, and each choice's slot offset
    by the choices of the chunks before it in sequence order
    (:func:`_slot_positions`); the expert products are row-wise, so each
    rank fills and reads only its own tokens' slots.  The auxiliary
    loss's statistics (the top-1 share and the mean gate per expert, the
    z-loss) are means over the GLOBAL batch's tokens: sums over the data
    axes and ``sp`` in the forward pass with an identity backward
    (``ctx.sum_tokens``), so each rank's gradient is its own tokens' share
    and the step's sum over those axes makes it whole.  A serving slice's
    ``parallel.tensor_parallel.TensorParallel`` (with ``aux=False``) runs
    the TP pair alone, and the ``sp`` routing only when its ``seq_split``
    says ``x`` is the rank's block of a split prefill.  With ``ctx``
    None, the one-card layer."""
    b, t, _ = x.shape
    e, k = cfg.num_experts, cfg.top_k
    sp = ctx.sp_size if ctx is not None and ctx.seq_split else 1
    c = _capacity(t * sp, cfg)

    router_logits = layers.dense_apply(params["router"], x,
                                       dtype=torch.float32)
    gates = torch.softmax(router_logits, dim=-1)  # [B, T, E]
    top_gates, top_idx = _top_k(gates, k)  # [B, T, K]
    top_gates = top_gates / torch.clamp(
        top_gates.sum(dim=-1, keepdim=True), min=1e-9)

    # Position of each (token, choice) in its expert's buffer: a cumsum
    # over the flattened (T * K) routing sequence of each batch row.
    choice_mask = F.one_hot(top_idx, e).float()  # [B, T, K, E]
    flat_mask = choice_mask.reshape(b, t * k, e)
    pos_in_expert = _slot_positions(flat_mask, ctx if sp > 1 else None
                                    ).reshape(b, t, k, e)
    keep = choice_mask * (pos_in_expert < c).float()

    # combine[b, t, e, c]: the gate of token t's slot c in expert e.
    gate_te = (keep * top_gates[..., None]).sum(dim=2)  # [B, T, E]
    slot_te = (choice_mask * pos_in_expert).sum(dim=2)  # [B, T, E]
    slots = torch.arange(c, device=x.device, dtype=slot_te.dtype)
    combine = torch.where(slot_te[..., None] == slots, gate_te[..., None],
                          torch.zeros((), device=x.device))
    out = _experts(params, x, combine, ctx)
    if not aux:
        return out, None

    # Load-balancing loss (Switch/GShard form) on the top-1 choice, over
    # every row and position, padding included.
    if ctx is None:
        fraction_routed = choice_mask[..., 0, :].mean(dim=(0, 1))
        mean_gate = gates.mean(dim=(0, 1))
    else:
        tokens = b * t * ctx.data_size * sp
        fraction_routed = ctx.sum_tokens(
            choice_mask[..., 0, :].sum(dim=(0, 1))) / tokens
        mean_gate = ctx.sum_tokens(gates.sum(dim=(0, 1))) / tokens
    aux = (fraction_routed * mean_gate).sum() * e * cfg.aux_loss_weight
    if cfg.z_loss_weight:
        z = torch.logsumexp(router_logits, dim=-1)  # [B, T]
        z2 = ((z * z).mean() if ctx is None
              else ctx.sum_tokens((z * z).sum()) / tokens)
        aux = aux + cfg.z_loss_weight * z2
    return out, aux


def _slot_positions(flat_mask, ctx=None):
    """Each (token, choice)'s position in its expert's buffer: the
    exclusive cumsum of ``flat_mask`` ``[B, T * K, E]`` over the routing
    sequence of each batch row.  Under ``sp`` (``ctx``) the rank's tokens
    are chunks of the global sequence (one, or the zig-zag pair,
    ``ring_attention.block_chunks``): the cumsum runs within each chunk,
    offset by the choices of every chunk before it in sequence order,
    whichever rank holds it (each rank's ``[B, chunks, E]`` counts,
    gathered over ``sp``)."""
    if ctx is None:
        return torch.cumsum(flat_mask, dim=1) - flat_mask
    b, n, e = flat_mask.shape
    sp = ctx.sp_size
    ids, count = ring_attention.block_chunks(sp, ctx.sp_index,
                                             zigzag=ctx.zigzag)
    per = flat_mask.reshape(b, len(ids), n // len(ids), e)
    within = torch.cumsum(per, dim=2) - per
    counts = collectives.all_gather(  # [B, sp * chunks, E]
        per.sum(dim=2), mesh_lib.AXIS_SP, gather_dim=1, mesh=ctx.mesh)
    order = [i for rank in range(sp)
             for i in ring_attention.block_chunks(sp, rank,
                                                  zigzag=ctx.zigzag)[0]]
    by_chunk = torch.zeros(b, count, e, dtype=counts.dtype,
                           device=counts.device)
    by_chunk[:, order] = counts
    before = torch.cumsum(by_chunk, dim=1) - by_chunk
    return (within + before[:, list(ids), None, :]).reshape(b, n, e)


def _experts(params, x, combine, ctx=None):
    """Dispatch, the stacked SwiGLU experts and the combine.  With a
    mesh's ``ctx``, this rank's experts (``params``' expert leaves are its
    shard); see :func:`moe_mlp_apply`."""
    if ctx is not None and ctx.experts_split:
        start, stop = ctx.expert_bounds(combine.shape[2])
        x = ctx.copy_experts(x)
        combine = ctx.copy_experts(combine)[:, :, start:stop]
    dispatch = (combine > 0.0).to(x.dtype)  # [B, T, E, C]
    expert_in = torch.einsum("btec,btd->becd", dispatch, x)
    # The TP pair around the expert products, as the dense MLP's: the
    # input copied, the row-split output summed over tp in f32.
    split_tp = ctx is not None and ctx.size > 1
    if split_tp:
        expert_in = ctx.copy(expert_in)
    # int8-aware: wi/wg/wo may be stored int8 with per-(expert, out) scales.
    wi = layers.materialize_matrix(params, "wi", x.dtype)
    wg = layers.materialize_matrix(params, "wg", x.dtype)
    wo = layers.materialize_matrix(params, "wo", x.dtype)
    h = (F.silu(torch.einsum("becd,edh->bech", expert_in, wi))
         * torch.einsum("becd,edh->bech", expert_in, wg))
    if split_tp:
        expert_out = ctx.reduce(torch.einsum(
            "bech,ehd->becd", h.float(), wo.float())).to(x.dtype)
    else:
        expert_out = torch.einsum("bech,ehd->becd", h, wo)
    if ctx is None or not ctx.experts_split:
        return torch.einsum("btec,becd->btd", combine.to(x.dtype),
                            expert_out)
    # The experts' partial outputs, summed over ep in f32.
    partial = torch.einsum("btec,becd->btd", combine, expert_out.float())
    return ctx.reduce_experts(partial).to(x.dtype)
