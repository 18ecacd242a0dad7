"""Fused linear + softmax cross-entropy (port of ``cloud_tpu/ops/fused_cross_entropy.py``).

``nll = logsumexp_V(x @ W) - (x @ W)[target]`` computed by scanning the
vocabulary in chunks with an online (running max, scaled sum)
logsumexp, so the ``[N, V]`` logits and their log-softmax are never held
whole.  The backward recomputes each chunk's logits from the saved
activations and lse (one extra ``[N, D] x [D, C]`` product per chunk)
instead of keeping an ``[N, V]`` residual.  Compute is f32 whatever the
inputs' type, as the JAX package's op.

The JAX package has no Pallas kernel here (its scan is left to XLA), so
this is plain PyTorch on every device; the chunk products are
``torch.matmul``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

#: Vocab columns per chunk, as the JAX package's default.
DEFAULT_CHUNK = 8192


def _table_vd(table, layout: str):
    """The class matrix as ``[V, D]`` (rows = classes), in f32."""
    if layout == "vd":
        return table.float()
    if layout == "dv":
        return table.float().t()
    raise ValueError(f"table layout must be 'vd' or 'dv', got {layout!r}")


class _FusedNll(torch.autograd.Function):
    """Per-row nll ``[N]`` of ``softmax(x @ W)`` against ``targets``."""

    @staticmethod
    def forward(ctx, x, table, targets, layout, chunk):
        x32 = x.float()
        w = _table_vd(table, layout)
        n, v = x32.shape[0], w.shape[0]
        m = torch.full((n,), -math.inf, dtype=torch.float32, device=x.device)
        s = torch.zeros((n,), dtype=torch.float32, device=x.device)
        tgt = torch.zeros((n,), dtype=torch.float32, device=x.device)
        for start in range(0, v, chunk):
            logits = x32 @ w[start:start + chunk].t()  # the only [N, C] live
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            hit = (targets >= start) & (targets < start + logits.shape[1])
            local = torch.clamp(targets - start, 0, logits.shape[1] - 1)
            picked = logits.gather(1, local[:, None])[:, 0]
            tgt = torch.where(hit, picked, tgt)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, table, targets, lse)
        ctx.layout, ctx.chunk = layout, chunk
        return lse - tgt

    @staticmethod
    def backward(ctx, g):
        x, table, targets, lse = ctx.saved_tensors
        x32 = x.float()
        w = _table_vd(table, ctx.layout)
        g32 = g.float()
        dx = torch.zeros_like(x32)
        dws = []
        for start in range(0, w.shape[0], ctx.chunk):
            w_c = w[start:start + ctx.chunk]
            logits = x32 @ w_c.t()  # recompute: no [N, V] residual exists
            cols = torch.arange(start, start + w_c.shape[0], device=x.device)
            gp = torch.exp(logits - lse[:, None])
            gp = (gp - (targets[:, None] == cols[None, :]).float()) \
                * g32[:, None]
            dx = dx + gp @ w_c
            dws.append(gp.t() @ x32)
        dtable = torch.cat(dws)
        if ctx.layout == "dv":
            dtable = dtable.t()
        return dx.to(x.dtype), dtable.to(table.dtype), None, None, None


def fused_linear_cross_entropy(x, table, targets, *, table_layout: str = "vd",
                               chunk_size: int = DEFAULT_CHUNK,
                               weights: Optional[torch.Tensor] = None):
    """Mean cross-entropy of ``softmax(x @ W)`` against ``targets`` without
    materializing the ``[..., V]`` logits.

    ``x`` is ``[..., D]``; ``table`` is ``[V, D]`` (``table_layout="vd"``,
    the tied embedding) or ``[D, V]`` (``"dv"``, a dense head kernel);
    ``targets`` holds class ids of ``x``'s leading shape.  With
    ``weights`` (broadcastable to that shape) the result is
    ``sum(nll * w) / max(sum(w), 1)``, the plain loss path's
    normalization.
    """
    lead = targets.shape
    n = math.prod(lead)
    nll = _FusedNll.apply(x.reshape(n, x.shape[-1]), table,
                          targets.reshape(n).long(), table_layout,
                          int(chunk_size)).reshape(lead)
    if weights is None:
        return nll.mean()
    w = torch.broadcast_to(weights.float(), lead)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
