"""Differentiable collectives of a training step under a mesh (the port's
own: the JAX package's transposes are implicit in GSPMD and ``shard_map``).

Each is a ``torch.autograd.Function`` whose backward is the transpose of
its forward, written out:

- :func:`copy_to`: the identity forward, a sum over the axis backward.
  Over ``tp`` (:func:`copy_to_tp`) it stands once before a block's
  column-split projections (q/k/v together, wi/wg together, a
  vocab-split head): each rank's projections see the replicated input,
  and the input's cotangent is the sum of every rank's partial one.
  Over ``ep`` it stands before an MoE layer takes its rank's experts.
- :func:`reduce_from`: a sum over the axis forward, the identity
  backward: over ``tp`` (:func:`reduce_from_tp`) a row-split product or
  a vocab-split lookup, over ``ep`` the experts' partial outputs, over
  the data axes an MoE layer's routing statistics (each rank's gradient
  is then its own rows' share).
- :func:`gather_vocab`: an all-gather along the last dim forward; the
  backward is this rank's own slice of the (replicated) cotangent.
- :func:`seq_to_heads` / :func:`heads_to_seq`: Ulysses' all-to-all and
  its inverse, each the other's transpose.

The collectives run inside autograd's graph, so their order in the
backward is autograd's.  Each layer makes them a chain (one copy before
its attention, one before its MLP, one all-to-all for q, k and v
stacked), so every rank issues them in the same order.  A backward
that sends uses the groups its forward used (``mesh.routed``): autograd
runs the backward of CUDA tensors on a thread of its own.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from cloud_tpu_torch.parallel import collectives
from cloud_tpu_torch.parallel import mesh as mesh_lib


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.args = (axes, mesh_lib.routed(mesh))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        axes, mesh = ctx.args
        return collectives.all_reduce_sum(g.contiguous(), axes,
                                          mesh=mesh), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return collectives.all_reduce_sum(x, axes, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherVocab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, sizes):
        dim = x.dim() - 1
        ctx.start = sum(sizes[:mesh.axis_index(mesh_lib.AXIS_TP)])
        ctx.width = x.shape[dim]
        return collectives.all_gather(x, mesh_lib.AXIS_TP, gather_dim=dim,
                                      sizes=sizes, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(g.dim() - 1, ctx.start, ctx.width), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, seq_dim, heads_dim, to_heads):
        ctx.args = (mesh_lib.routed(mesh), seq_dim, heads_dim, to_heads)
        return collectives.all_to_all_seq_heads(
            x, mesh_lib.AXIS_SP, seq_dim=seq_dim, heads_dim=heads_dim,
            to_heads=to_heads, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        mesh, seq_dim, heads_dim, to_heads = ctx.args
        return collectives.all_to_all_seq_heads(
            g.contiguous(), mesh_lib.AXIS_SP, seq_dim=seq_dim,
            heads_dim=heads_dim, to_heads=not to_heads,
            mesh=mesh), None, None, None, None


def _nontrivial(axis: collectives.AxisNames, mesh) -> Tuple[str, ...]:
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    return tuple(a for a in names if mesh.axis_size(a) > 1)


def copy_to(x: torch.Tensor, axis: collectives.AxisNames, mesh
            ) -> torch.Tensor:
    """``x`` forward; its cotangent summed over ``axis`` (a name or a
    tuple of names) backward."""
    axes = _nontrivial(axis, mesh)
    if not axes:
        return x
    return _CopyTo.apply(x, axes, mesh)


def reduce_from(x: torch.Tensor, axis: collectives.AxisNames, mesh
                ) -> torch.Tensor:
    """The sum of every ``axis`` member's ``x`` forward; the cotangent as
    it is backward."""
    axes = _nontrivial(axis, mesh)
    if not axes:
        return x
    return _ReduceFrom.apply(x, axes, mesh)


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """:func:`copy_to` over ``tp``."""
    return copy_to(x, mesh_lib.AXIS_TP, mesh)


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """:func:`reduce_from` over ``tp``."""
    return reduce_from(x, mesh_lib.AXIS_TP, mesh)


def gather_vocab(x: torch.Tensor, mesh,
                 sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every ``tp`` member's ``[..., V_i]`` block along the last dim, in
    axis order (``sizes``: each member's ``V_i``, default all equal);
    backward, this member's own slice of the cotangent."""
    n = mesh.axis_size(mesh_lib.AXIS_TP)
    if n == 1:
        return x
    sizes = tuple(sizes) if sizes is not None else (x.shape[-1],) * n
    return _GatherVocab.apply(x, mesh, sizes)


def seq_to_heads(x: torch.Tensor, mesh, *, seq_dim: int = 1,
                 heads_dim: int = 2) -> torch.Tensor:
    """Ulysses' all-to-all over ``sp``: ``[.., T/n, H, ..]`` ->
    ``[.., T, H/n, ..]``, differentiable (the backward is the inverse)."""
    return _AllToAll.apply(x, mesh, seq_dim, heads_dim, True)


def heads_to_seq(x: torch.Tensor, mesh, *, seq_dim: int = 1,
                 heads_dim: int = 2) -> torch.Tensor:
    """The inverse of :func:`seq_to_heads`, differentiable."""
    return _AllToAll.apply(x, mesh, seq_dim, heads_dim, False)
