"""GroupNorm over NHWC: hand-written CUDA kernels K1-K4 plus their plain versions.

Port of ``cloud_tpu/ops/group_norm.py``.  The public layout is the JAX
package's: ``x`` ``[B, H, W, C]``, affine ``scale``/``bias`` ``[C]``, an
optional fused ReLU and an optional residual added before it:
``y = [relu](group_norm(x) + residual)``.

Dispatch is by device alone, in the forward and in the backward of one
``torch.autograd.Function``.  A tensor on the CPU takes the plain
PyTorch versions below (term-for-term ports of the TPU kernels' math:
:func:`_fwd_plain` of ``_fwd_math`` and its epilogues, :func:`_bwd_plain`
of the relu gates and ``_bwd_core``); a CUDA tensor launches
``csrc/group_norm.cu`` (see its header for the design and what bounds it)
or raises.  The kernels take every NHWC shape whose channels divide into
the groups; the JAX package's TPU eligibility rules (VMEM budget, sublane
alignment), its kill switch and its partitioned routes are not carried
over.

Launch counters: ``gn_fwd`` (K1) and ``gn_fwd_res`` (K2) per forward,
``gn_bwd`` (K3) and ``gn_bwd_res`` (K4) per backward.  A residual without
ReLU runs K2 forward and K3 backward: its cotangent is ``dy`` itself, so
the residual is not saved for the backward (as in the JAX package).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from cloud_tpu_torch.ops import dispatch

#: Elements of one sample that one CUDA block of the row-chunk grid covers.
_CHUNK_ELEMS = 16384


def _reference(x, scale, bias, num_groups, eps=1e-5, relu=False,
               residual=None):
    """Ground truth, differentiable by autograd: the JAX package's
    ``_reference`` (shifted moments over a ``[B, H, W, G, C/G]`` view)."""
    b, h, w, c = x.shape
    g = min(num_groups, c)
    x32 = x.float().reshape(b, h, w, g, c // g)
    pivot = x32[:, :1, :1, :, :1].detach()
    xc = x32 - pivot
    m1c = torch.mean(xc, dim=(1, 2, 4), keepdim=True)
    m2c = torch.mean(xc * xc, dim=(1, 2, 4), keepdim=True)
    var = torch.clamp_min(m2c - m1c * m1c, 0.0)
    y = (xc - m1c) * torch.rsqrt(var + eps)
    y = y.reshape(b, h, w, c) * scale + bias
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


def _fold(v, g):
    """``[B, 1, C]`` -> ``[B, 1, G]``: sums over each group's C/G adjacent
    channels (the TPU kernel's one-hot ``[C, G]`` matmul)."""
    b, _, c = v.shape
    return v.reshape(b, 1, g, c // g).sum(-1)


def _expand(v, cg):
    """``[B, 1, G]`` -> ``[B, 1, C]`` (the one-hot ``[G, C]`` matmul)."""
    return v.repeat_interleave(cg, dim=-1)


def _fwd_math(x2, scale, bias, g, eps):
    """``_fwd_math`` batched over samples: ``[B, HW, C]`` f32 ->
    (pre-activation y2, mean ``[B, G]``, rstd ``[B, G]``)."""
    _, hw, c = x2.shape
    cg = c // g
    n = float(hw * cg)
    pivot = x2[:, 0:1, :]
    xc = x2 - pivot
    s1 = xc.sum(1, keepdim=True)
    s2 = (xc * xc).sum(1, keepdim=True)
    mean_g = _fold(s1 + hw * pivot, g) / n
    mean_c = _expand(mean_g, cg)
    d = mean_c - pivot
    # sum_(hw, c in g) (x - m)^2 = s2 - 2 d s1 + hw d^2, folded per group.
    var_g = _fold(s2 - 2.0 * d * s1 + hw * d * d, g) / n
    rstd_g = torch.rsqrt(torch.clamp_min(var_g, 0.0) + eps)
    rstd_c = _expand(rstd_g, cg)
    y2 = (x2 - mean_c) * rstd_c * scale + bias
    return y2, mean_g[:, 0], rstd_g[:, 0]


def _fwd_plain(x, scale, bias, residual, g, eps, relu):
    """Plain K1/K2: ``(y like x, mean [B, G], rstd [B, G])``."""
    b, h, w, c = x.shape
    y2, mean, rstd = _fwd_math(x.float().reshape(b, h * w, c), scale, bias,
                               g, eps)
    if residual is not None:
        y2 = y2 + residual.float().reshape(b, h * w, c)
    if relu:
        y2 = torch.clamp_min(y2, 0.0)
    return y2.reshape(x.shape).to(x.dtype), mean, rstd


def _bwd_plain(x, dy, mean, rstd, scale, bias, residual, g, relu):
    """Plain K3/K4: ``(dx, ds [B, C], db [B, C], dres or None)``.  The
    relu gate is recomputed from the saved statistics (and the residual);
    ``dres`` is the gated ``dy`` when a residual is given."""
    b, h, w, c = x.shape
    hw, cg = h * w, c // g
    n = float(hw * cg)
    x2 = x.float().reshape(b, hw, c)
    dy2 = dy.float().reshape(b, hw, c)
    mean_c = _expand(mean[:, None], cg)
    rstd_c = _expand(rstd[:, None], cg)
    if relu:
        pre = (x2 - mean_c) * rstd_c * scale + bias
        if residual is not None:
            pre = pre + residual.float().reshape(b, hw, c)
        dy2 = torch.where(pre > 0.0, dy2, 0.0)
    dres = None
    if residual is not None:
        dres = dy2.reshape(x.shape).to(residual.dtype)
    # _bwd_core
    xhat = (x2 - mean_c) * rstd_c
    dxh = dy2 * scale
    a_c = _expand(_fold(dxh.sum(1, keepdim=True), g), cg)
    b_c = _expand(_fold((dxh * xhat).sum(1, keepdim=True), g), cg)
    dx = rstd_c * (dxh - (a_c + xhat * b_c) / n)
    ds = (dy2 * xhat).sum(1)
    db = dy2.sum(1)
    return dx.reshape(x.shape).to(x.dtype), ds, db, dres


_fns = {}


def _kernel_fn(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(dispatch.load("group_norm"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "group_norm_fwd":
            fn.argtypes = [p] * 8 + [i] * 5 + [ctypes.c_float, i, i, i, p]
        else:
            fn.argtypes = [p] * 13 + [i] * 5 + [i, i, i, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_kernel_inputs(x, others):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"group_norm kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    for t in others:
        if t is None:
            continue
        if t.dtype != x.dtype or t.shape != x.shape:
            raise TypeError(
                f"group_norm kernel: every activation must be {x.dtype} "
                f"{tuple(x.shape)}; got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError("group_norm kernel: tensors on two devices")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _geometry(x, g):
    b, h, w, c = x.shape
    rpc = max(1, _CHUNK_ELEMS // c)
    nchunks = -(-(h * w) // rpc)
    return b, h * w, c, rpc, nchunks


def _fwd_kernel(x, scale, bias, residual, g, eps, relu):
    """Launch K1 (no residual) or K2 on CUDA tensors."""
    _check_kernel_inputs(x, [residual])
    x = x.contiguous()
    residual = None if residual is None else residual.contiguous()
    scale, bias = (v.to(x.device, torch.float32).contiguous()
                   for v in (scale, bias))
    b, hw, c, rpc, nchunks = _geometry(x, g)
    y = torch.empty_like(x)
    mean = torch.empty((b, g), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    part = torch.empty((2 * nchunks * b * c,), dtype=torch.float32,
                       device=x.device)
    rc = _kernel_fn("group_norm_fwd")(
        x.data_ptr(), _ptr(residual), scale.data_ptr(), bias.data_ptr(),
        y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), part.data_ptr(),
        b, hw, c, g, rpc, eps, int(relu), int(x.dtype == torch.bfloat16),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )
    dispatch.check("group_norm", rc)
    dispatch.count_launch("gn_fwd" if residual is None else "gn_fwd_res")
    return y, mean, rstd


def _bwd_kernel(x, dy, mean, rstd, scale, bias, residual, g, relu):
    """Launch K3 (no residual) or K4 on CUDA tensors."""
    _check_kernel_inputs(x, [dy, residual])
    x, dy = x.contiguous(), dy.contiguous()
    residual = None if residual is None else residual.contiguous()
    mean, rstd, scale, bias = (v.to(x.device, torch.float32).contiguous()
                               for v in (mean, rstd, scale, bias))
    b, hw, c, rpc, nchunks = _geometry(x, g)
    dx = torch.empty_like(x)
    dres = None if residual is None else torch.empty_like(residual)
    ds = torch.empty((b, c), dtype=torch.float32, device=x.device)
    db = torch.empty_like(ds)
    part = torch.empty((2 * nchunks * b * c,), dtype=torch.float32,
                       device=x.device)
    ab = torch.empty((2 * b * g,), dtype=torch.float32, device=x.device)
    rc = _kernel_fn("group_norm_bwd")(
        x.data_ptr(), dy.data_ptr(), _ptr(residual), scale.data_ptr(),
        bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        _ptr(dres), ds.data_ptr(), db.data_ptr(), part.data_ptr(),
        ab.data_ptr(), b, hw, c, g, rpc, int(relu),
        int(x.dtype == torch.bfloat16), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    dispatch.check("group_norm", rc)
    dispatch.count_launch("gn_bwd" if residual is None else "gn_bwd_res")
    return dx, ds, db, dres


def _by_device(x, plain, kernel):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return kernel
    raise ValueError(f"group_norm: unsupported device {x.device}")


class _GroupNorm(torch.autograd.Function):
    """``[relu](group_norm(x) + residual)`` with the TPU kernels' custom
    VJP (``_gn``/``_gn_res``): the backward recomputes the relu gate from
    the saved statistics instead of saving the output."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, g, eps, relu):
        fwd = _by_device(x, _fwd_plain, _fwd_kernel)
        y, mean, rstd = fwd(x, scale, bias, residual, g, eps, relu)
        # Without relu the backward never reads the residual (dres == dy).
        ctx.save_for_backward(x, mean, rstd, scale, bias,
                              residual if relu else None)
        ctx.g, ctx.relu = g, relu
        ctx.res_dtype = None if residual is None else residual.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd, scale, bias, saved_res = ctx.saved_tensors
        bwd = _by_device(x, _bwd_plain, _bwd_kernel)
        dx, ds, db, dres = bwd(x, dy, mean, rstd, scale, bias, saved_res,
                               ctx.g, ctx.relu)
        if ctx.res_dtype is not None and saved_res is None:
            dres = dy.to(ctx.res_dtype)
        return dx, ds.sum(0), db.sum(0), dres, None, None, None


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               num_groups: int = 32, eps: float = 1e-5,
               activation: Optional[str] = None,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GroupNorm over NHWC ``x`` with affine params ``[C]``; differentiable
    in ``x``, ``scale``, ``bias`` and ``residual``.

    ``activation="relu"`` fuses the ReLU epilogue; ``residual`` (same shape
    as ``x``) is added before it.  Statistics are float32 whatever the
    type of ``x``; the output has the type of ``x``.
    """
    if activation not in (None, "relu"):
        raise ValueError(
            f"activation must be None or 'relu', got {activation!r}"
        )
    if x.dim() != 4:
        raise ValueError(f"group_norm takes NHWC [B, H, W, C], got "
                         f"{tuple(x.shape)}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(
            f"residual shape {tuple(residual.shape)} != x shape "
            f"{tuple(x.shape)}"
        )
    c = x.shape[-1]
    g = min(num_groups, c)
    if c % g:
        raise ValueError(f"{c} channels do not divide into {g} groups")
    return _GroupNorm.apply(x, scale.float(), bias.float(), residual, g, eps,
                            activation == "relu")
