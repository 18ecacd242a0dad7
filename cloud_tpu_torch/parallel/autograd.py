"""Differentiable collectives of a training step under a mesh (the port's
own: the JAX package's transposes are implicit in GSPMD and ``shard_map``).

Each is a ``torch.autograd.Function`` whose backward is the transpose of
its forward, written out:

- :func:`copy_to_tp`: the identity forward, a sum over ``tp`` backward.
  It stands once before a block's column-split projections (q/k/v
  together, wi/wg together, a vocab-split head): each rank's projections
  see the replicated input, and the input's cotangent is the sum of every
  rank's partial one.
- :func:`reduce_from_tp`: a sum over ``tp`` forward (a row-split product,
  a vocab-split lookup), the identity backward.
- :func:`gather_vocab`: an all-gather along the last dim forward; the
  backward is this rank's own slice of the (replicated) cotangent.
- :func:`seq_to_heads` / :func:`heads_to_seq`: Ulysses' all-to-all and
  its inverse, each the other's transpose.

The collectives run inside autograd's graph, so their order in the
backward is autograd's.  Each layer makes them a chain (one copy before
its attention, one before its MLP, one all-to-all for q, k and v
stacked), so every rank issues them in the same order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from cloud_tpu_torch.parallel import collectives
from cloud_tpu_torch.parallel import mesh as mesh_lib


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collectives.all_reduce_sum(g.contiguous(), mesh_lib.AXIS_TP,
                                          mesh=ctx.mesh), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return collectives.all_reduce_sum(x, mesh_lib.AXIS_TP, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


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
        ctx.args = (mesh, seq_dim, heads_dim, to_heads)
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


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` forward; its cotangent summed over ``tp`` backward."""
    if mesh.axis_size(mesh_lib.AXIS_TP) == 1:
        return x
    return _CopyToTP.apply(x, mesh)


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every ``tp`` member's ``x`` forward; the cotangent as it
    is backward."""
    if mesh.axis_size(mesh_lib.AXIS_TP) == 1:
        return x
    return _ReduceFromTP.apply(x, mesh)


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
