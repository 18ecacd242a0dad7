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
auxiliary loss is the global batch's (:func:`moe_mlp_apply`).

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
from typing import Tuple

import torch
import torch.nn.functional as F

from cloud_tpu_torch.models import layers


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


def moe_mlp_apply(params, x, cfg: MoeConfig, *, ctx=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE MLP to ``x [B, T, D]``; returns ``(out [B, T, D],
    aux)``, ``aux`` the f32 load-balancing loss (plus the z-loss).

    ``ctx``, a ``parallel.tensor_parallel.TrainContext``, runs the layer
    on a training mesh as the JAX package's GSPMD runs it (``expert`` ->
    ``ep``, ``batch`` -> ``dp`` x ``fsdp``): the router, top-k, capacity
    (from this call's ``T``), dispatch and combine run alike on every
    rank that holds these rows; the rank's experts (``ctx.expert_bounds``,
    cut as ``sharding.shard_bounds`` cuts them) see ``x`` and the combine
    weights through ``ctx.copy_experts`` (their cotangents summed over
    ``ep``), their hidden units split over ``tp`` behind the TP pair, and
    the experts' partial outputs are summed over ``ep`` in f32.  The
    auxiliary loss's statistics (the top-1 share and the mean gate per
    expert) are means over the GLOBAL batch's rows: sums over the data
    axes in the forward pass with an identity backward
    (``ctx.sum_rows``), so each rank's gradient is its own rows' share
    and the step's sum over the data axes makes it whole.  With ``ctx``
    None, the one-card layer."""
    b, t, _ = x.shape
    e, k = cfg.num_experts, cfg.top_k
    c = _capacity(t, cfg)

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
    pos_in_expert = (torch.cumsum(flat_mask, dim=1) - flat_mask).reshape(
        b, t, k, e)
    keep = choice_mask * (pos_in_expert < c).float()

    # combine[b, t, e, c]: the gate of token t's slot c in expert e.
    gate_te = (keep * top_gates[..., None]).sum(dim=2)  # [B, T, E]
    slot_te = (choice_mask * pos_in_expert).sum(dim=2)  # [B, T, E]
    slots = torch.arange(c, device=x.device, dtype=slot_te.dtype)
    combine = torch.where(slot_te[..., None] == slots, gate_te[..., None],
                          torch.zeros((), device=x.device))
    out = _experts(params, x, combine, ctx)

    # Load-balancing loss (Switch/GShard form) on the top-1 choice, over
    # every row and position, padding included.
    if ctx is None:
        fraction_routed = choice_mask[..., 0, :].mean(dim=(0, 1))
        mean_gate = gates.mean(dim=(0, 1))
    else:
        rows = b * t * ctx.data_size
        fraction_routed = ctx.sum_rows(
            choice_mask[..., 0, :].sum(dim=(0, 1))) / rows
        mean_gate = ctx.sum_rows(gates.sum(dim=(0, 1))) / rows
    aux = (fraction_routed * mean_gate).sum() * e * cfg.aux_loss_weight
    if cfg.z_loss_weight:
        z = torch.logsumexp(router_logits, dim=-1)  # [B, T]
        z2 = ((z * z).mean() if ctx is None
              else ctx.sum_rows((z * z).sum()) / (b * t * ctx.data_size))
        aux = aux + cfg.z_loss_weight * z2
    return out, aux


def _experts(params, x, combine, ctx=None):
    """Dispatch, the stacked SwiGLU experts and the combine.  With a
    training mesh's ``ctx``, this rank's experts (``params``' expert
    leaves are its shard); see :func:`moe_mlp_apply`."""
    if ctx is not None:
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
