"""Flash attention forward: a hand-written CUDA kernel plus its plain version.

Port of ``cloud_tpu/ops/flash_attention.py`` (forward only).  The public
layout is the JAX package's: q/k/v ``[B, T, H, D]``, an optional
``[B, T_k]`` key-padding mask (nonzero = attend), out ``[B, T, H, D]`` and
lse ``[B, H, T]``.

Dispatch is by device alone.  A tensor on the CPU takes
:func:`_reference_with_lse`, a term-for-term port of the jnp reference;
a CUDA tensor launches ``csrc/flash_fwd.cu`` (see its header for the
design and what bounds it) or raises.  The JAX package's TPU crossover
thresholds do not apply here and are not carried over.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from cloud_tpu_torch.ops import dispatch

NEG_INF = -1e30  # finite: fully-masked rows softmax to uniform, not NaN

#: Head dims the kernel is compiled for.
KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def _reference_with_lse(q, k, v, *, causal, mask):
    """Plain PyTorch attention returning (out [B, T, H, D], lse [B, H, T])."""
    dim = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    s = s / math.sqrt(dim)
    t_q, t_k = q.shape[1], k.shape[1]
    if causal:
        causal_mask = torch.ones(
            (t_q, t_k), dtype=torch.bool, device=q.device
        ).tril(diagonal=t_k - t_q)
        s = torch.where(causal_mask, s, NEG_INF)
    if mask is not None:
        s = torch.where(mask[:, None, None, :] != 0, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    w = (p / safe_l).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    lse = (m + torch.log(safe_l))[..., 0]
    return out, lse


_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = dispatch.load("flash_fwd").flash_fwd
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ll, ll, ll,
                       i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _flash_kernel(q, k, v, *, causal, mask):
    """Launch ``flash_fwd.cu`` on CUDA tensors; returns (out, lse)."""
    if not (q.shape == k.shape == v.shape and q.dim() == 4):
        raise ValueError(
            "the flash kernel takes self-attention q/k/v of one [B, T, H, D] "
            f"shape; got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(
            f"flash kernel takes float32 or bfloat16 q/k/v of one type; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (k.device == v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    b, t, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {KERNEL_HEAD_DIMS}")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    mask_i32 = None
    if mask is not None:
        if tuple(mask.shape) != (b, t):
            raise ValueError(
                f"mask must be [B, T] = {(b, t)}, got {tuple(mask.shape)}"
            )
        mask_i32 = mask.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask_i32 is None else mask_i32.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, t, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), 1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
        q.device.index, stream,
    )
    dispatch.check("flash_fwd", rc)
    dispatch.count_launch("flash_fwd")
    return out, lse


def _dispatch(q, k, v, *, causal, mask):
    if q.device.type == "cpu":
        return _reference_with_lse(q, k, v, causal=causal, mask=mask)
    if q.device.type == "cuda":
        return _flash_kernel(q, k, v, causal=causal, mask=mask)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             mask: Optional[torch.Tensor] = None):
    """Like :func:`flash_attention` but also returns lse ``[B, H, T]``."""
    return _dispatch(q, k, v, causal=causal, mask=mask)


def flash_attention(q, k, v, *, causal: bool = True,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over ``[B, T, H, D]`` tensors (forward only).

    ``mask`` is a ``[B, T_k]`` valid-token padding mask applied key-side;
    a query row with no valid key gets the finite-NEG_INF answer (uniform
    weights), as in the JAX reference.
    """
    return _dispatch(q, k, v, causal=causal, mask=mask)[0]
