"""Flash attention, differentiable: hand-written CUDA kernels plus their plain versions.

Port of ``cloud_tpu/ops/flash_attention.py``.  The public layout is the
JAX package's: q/k/v ``[B, T, H, D]``, an optional ``[B, T_k]``
key-padding mask (nonzero = attend), out ``[B, T, H, D]`` and lse
``[B, H, T]``.  Both entry points are differentiable in q, k and v
through one ``torch.autograd.Function`` (the JAX package's
``custom_vjp``): the forward saves (q, k, v, mask, out, lse), the
backward recomputes the scores from the lse.  ``flash_attention_with_lse``
takes the lse's cotangent too (``g_lse``); the mask gets no gradient.

Dispatch is by device alone.  A tensor on the CPU takes the plain
versions, :func:`_reference_with_lse` (a term-for-term port of the jnp
reference) and :func:`_bwd_reference` (what the TPU backward kernels
compute, on whole score matrices); a CUDA tensor launches
``csrc/flash_fwd.cu`` (K5) and ``csrc/flash_bwd.cu`` (K6, K7), see their
headers for the design and what bounds them, or raises.  The JAX
package's TPU crossover thresholds and tile-divisibility rule do not
apply here and are not carried over.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from cloud_tpu_torch.ops import dispatch

NEG_INF = -1e30  # finite: fully-masked rows softmax to uniform, not NaN

#: Head dims the kernels are compiled for.
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


def _row_term(do, out, g_lse):
    """``delta - g_lse`` ``[B, H, T]`` f32, with ``delta = rowsum(dO * O)``
    (computed outside the kernels, as the JAX package leaves it to XLA)."""
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    return delta if g_lse is None else delta - g_lse.float()


def _bwd_reference(q, k, v, mask, do, out, lse, *, causal, g_lse=None):
    """What the TPU backward kernels (``_bwd_dq_kernel``,
    ``_bwd_dkv_kernel``) compute, on whole ``[B, H, T, T]`` score matrices:
    ``p = exp(s - lse)``, ``ds = p * (dp - (delta - g_lse))``, with ``p``
    and ``ds`` rounded to the input type before their products and the
    products summed in f32.  Returns (dq, dk, dv) in the input type."""
    dtype = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    t = q.shape[1]
    if causal:
        tril = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(tril, s, NEG_INF)
    if mask is not None:
        s = torch.where(mask[:, None, None, :] != 0, s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - _row_term(do, out, g_lse)[..., None])
    ds = ds.to(dtype).float()
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).float(), dof)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


_fns = {}


def _kernel_fn(name):
    """The C entry point ``name`` of the flash libraries, typed."""
    fn = _fns.get(name)
    if fn is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        if name == "flash_fwd":
            fn = dispatch.load("flash_fwd").flash_fwd
            fn.argtypes = [p, p, p, p, p, p, i, i, i, i,
                           ll, ll, ll, ll, ll, ll, ll, ll, ll,
                           i, ctypes.c_float, i, i, p]
        else:  # flash_bwd_dq, flash_bwd_dkv: one signature
            fn = getattr(dispatch.load("flash_bwd"), name)
            fn.argtypes = [p] * 10 + [i] * 4 + [ll] * 12 + [
                i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_qkv(q, k, v):
    """Validate the kernels' q/k/v; returns them with aligned rows."""
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
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not in {KERNEL_HEAD_DIMS}")
    return tuple(_aligned_rows(x) for x in (q, k, v))


def _aligned_rows(x):
    """``x`` itself if the kernels can read it, else a contiguous copy.
    The bf16 kernels copy each row in 16-byte ``cp.async`` pieces, so
    their rows must be contiguous and start on 16-byte boundaries; the f32
    kernels read element by element and need a unit last stride only."""
    if x.dtype != torch.bfloat16:
        return x if x.stride(-1) == 1 else x.contiguous()
    # Contiguous rows of a head dim in KERNEL_HEAD_DIMS (multiples of 8
    # elements) keep every row on 16 bytes: the common case, tested first
    # because this runs on every call.
    if x.data_ptr() % 16 == 0 and (x.is_contiguous() or (
            x.stride(-1) == 1
            and all(s % 8 == 0 for s in x.stride()[:-1]))):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _mask_i32(mask, b, t, device):
    if mask is None:
        return None
    if tuple(mask.shape) != (b, t):
        raise ValueError(
            f"mask must be [B, T] = {(b, t)}, got {tuple(mask.shape)}"
        )
    return mask.to(device=device, dtype=torch.int32).contiguous()


def _flash_kernel(q, k, v, *, causal, mask):
    """Launch ``flash_fwd.cu`` on CUDA tensors; returns (out, lse)."""
    q, k, v = _check_qkv(q, k, v)
    b, t, h, d = q.shape
    mask_i32 = _mask_i32(mask, b, t, q.device)
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel_fn("flash_fwd")(
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


def _bwd_launch(name, q, k, v, mask, do, lse, row_term, *, causal):
    """Launch K6 (``flash_bwd_dq``) or K7 (``flash_bwd_dkv``) on CUDA
    tensors; returns ``(dq,)`` or ``(dk, dv)``."""
    q, k, v = _check_qkv(q, k, v)
    b, t, h, d = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(
            f"dO must match q: got {tuple(do.shape)} {do.dtype} {do.device}")
    do = _aligned_rows(do)
    mask_i32 = _mask_i32(mask, b, t, q.device)
    lse, row_term = (x.to(device=q.device, dtype=torch.float32).contiguous()
                     for x in (lse, row_term))
    if lse.shape != (b, h, t) or row_term.shape != (b, h, t):
        raise ValueError(f"lse and row terms must be [B, H, T] = {(b, h, t)}")
    is_dq = name == "flash_bwd_dq"
    outs = [torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
            for _ in range(1 if is_dq else 2)]
    ptrs = [o.data_ptr() for o in outs]
    ptrs = ptrs + [None, None] if is_dq else [None] + ptrs  # dq, dk, dv
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel_fn(name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), row_term.data_ptr(),
        None if mask_i32 is None else mask_i32.data_ptr(), *ptrs,
        b, t, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *do.stride()[:3], int(causal), 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), q.device.index, stream,
    )
    dispatch.check("flash_bwd", rc)
    dispatch.count_launch(name)
    return tuple(outs)


def _bwd_kernels(q, k, v, mask, do, out, lse, *, causal, g_lse=None):
    """K6 then K7 on CUDA tensors; returns (dq, dk, dv)."""
    row_term = _row_term(do, out, g_lse)
    (dq,) = _bwd_launch("flash_bwd_dq", q, k, v, mask, do, lse, row_term,
                        causal=causal)
    dk, dv = _bwd_launch("flash_bwd_dkv", q, k, v, mask, do, lse, row_term,
                         causal=causal)
    return dq, dk, dv


def _by_device(q, cpu, cuda):
    if q.device.type == "cpu":
        return cpu
    if q.device.type == "cuda":
        return cuda
    raise ValueError(f"flash_attention: unsupported device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """(out, lse) with the JAX package's custom VJP: grads for q, k, v
    from the saved (q, k, v, mask, out, lse); none for the mask."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        fwd = _by_device(q, _reference_with_lse, _flash_kernel)
        out, lse = fwd(q, k, v, causal=causal, mask=mask)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal = causal
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, mask, out, lse = ctx.saved_tensors
        if g_out is None:  # only the lse was used
            g_out = torch.zeros_like(out)
        bwd = _by_device(q, _bwd_reference, _bwd_kernels)
        dq, dk, dv = bwd(q, k, v, mask, g_out, out, lse, causal=ctx.causal,
                         g_lse=g_lse)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             mask: Optional[torch.Tensor] = None):
    """Like :func:`flash_attention` but also returns lse ``[B, H, T]``,
    differentiable in both outputs."""
    return _FlashAttention.apply(q, k, v, mask, causal)


def flash_attention(q, k, v, *, causal: bool = True,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over ``[B, T, H, D]`` tensors, differentiable in q/k/v.

    ``mask`` is a ``[B, T_k]`` valid-token padding mask applied key-side;
    a query row with no valid key gets the finite-NEG_INF answer (uniform
    weights), as in the JAX reference.
    """
    return _FlashAttention.apply(q, k, v, mask, causal)[0]
