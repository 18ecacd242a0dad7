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
or raises: one kernel forward, and backward one kernel plus its sum of
``dscale``/``dbias`` over the batch, laid out by :func:`_plan`.  The
kernels take every NHWC shape whose channels divide into the groups; the
JAX package's TPU eligibility rules (VMEM budget, sublane alignment), its
kill switch and its partitioned routes are not carried over.

Launch counters: ``gn_fwd`` (K1) and ``gn_fwd_res`` (K2) per forward,
``gn_bwd`` (K3) and ``gn_bwd_res`` (K4) per backward.  A residual without
ReLU runs K2 forward and K3 backward: its cotangent is ``dy`` itself, so
the residual is not saved for the backward (as in the JAX package).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from cloud_tpu_torch.ops import dispatch


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
    """Plain K3/K4: ``(dx, ds [C], db [C], dres or None)``, ds and db
    summed over the batch.  The relu gate is recomputed from the saved
    statistics (and the residual); ``dres`` is the gated ``dy`` when a
    residual is given."""
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
    ds = (dy2 * xhat).sum((0, 1))
    db = dy2.sum((0, 1))
    return dx.reshape(x.shape).to(x.dtype), ds, db, dres


#: Shared memory one block may use on an H100 (227 KB), the portable
#: cluster size, and the card's SMs (the plan spreads small batches).
SMEM_MAX = 232448
MAX_CLUSTER = 8
SMS = 132
#: A CTA of a cluster keeps at least this many rows of its sample.
_MIN_ROWS = 16
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}


class Plan(NamedTuple):
    """How ``csrc/group_norm.cu`` lays one call out (see its header); the
    fields, in order, are the C entry points' plan arguments."""

    vec: int      # elements per load and store: 16 bytes, or 1 (scalar)
    threads: int  # per CTA
    cluster: int  # CTAs per sample
    rows: int     # rows of HW per CTA; CTA k owns [k rows, (k + 1) rows)
    cached: int   # of those, rows kept in shared memory (the rest re-read)
    smem: int     # dynamic shared memory bytes per CTA


def _fixed_smem(c, g, threads, vec, cluster):
    """Bytes before the cached rows (``fixed_smem_bytes`` in the source)."""
    floats = 2 * c * (2 if cluster > 1 else 1) + threads * vec + 2 * g
    return (floats * 4 + 15) // 16 * 16


def _threads(rows, cv, backward):
    """Block size for ``rows`` rows of ``cv`` column vectors: 512 threads
    when each of 256 would have more than 8 vectors, and 128 for a small
    backward tile of narrow rows, whose latency-bound sums are shorter
    over fewer threads (both chosen by timing on an H100)."""
    if rows * cv > 8 * 256:
        return 512
    if backward and cv < 128 and rows * cv <= 512:
        return 128
    return 256


@functools.lru_cache(maxsize=None)
def _plan(shape, dtype, groups=32, backward=False, aligned=True) -> Plan:
    """The kernel's layout for an NHWC ``shape`` of ``dtype``.

    The smallest cluster (1, 2, 4, 8 CTAs a sample, then trimmed to the
    CTAs that own rows) whose CTAs each hold their rows in shared memory,
    grown further while the batch gives the card fewer CTAs than SMs and
    every CTA keeps ``_MIN_ROWS`` rows.  A cached row holds x (and,
    backward, the gated dy).  A sample too large
    for 8 CTAs keeps what fits and re-reads the rest from L2.  The scalar
    route (channels not a multiple of 16 bytes, or ``aligned`` false)
    keeps nothing and re-reads every row.
    """
    b, h, w, c = shape
    hw, g = h * w, min(groups, c)
    item = _ITEMSIZE[dtype]
    vec = 16 // item if aligned and c % (16 // item) == 0 else 1
    row_bytes = c * item * (2 if backward else 1) if vec > 1 else 0
    cluster = 1
    while True:
        rows = -(-hw // cluster)
        threads = _threads(rows, c // vec, backward)
        fixed = _fixed_smem(c, g, threads, vec, cluster)
        cached = min(rows, (SMEM_MAX - fixed) // row_bytes) if row_bytes else 0
        fits = cached == rows or not row_bytes
        spread = (b * cluster >= SMS
                  or -(-hw // (2 * cluster)) < _MIN_ROWS)
        if cluster == MAX_CLUSTER or (fits and spread):
            break
        cluster *= 2
    # No CTA without rows (7 rows in 8 CTAs of 1: a cluster of 7).
    cluster = -(-hw // rows)
    fixed = _fixed_smem(c, g, threads, vec, cluster)
    return Plan(vec, threads, cluster, rows, cached,
                fixed + cached * row_bytes)


_fns = {}


def _kernel_fn(name):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(dispatch.load("group_norm"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        if name == "group_norm_fwd":
            fn.argtypes = [p] * 7 + [i] * 10 + [ctypes.c_float, i, i, i, p]
        else:
            fn.argtypes = [p] * 11 + [i] * 10 + [i, i, i, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_kernel_inputs(x, others):
    if x.dtype not in _ITEMSIZE:
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


def _dense(t):
    return t if t is None or t.is_contiguous() else t.contiguous()


def _f32(v, device):
    """``v`` as a contiguous float32 tensor on ``device``, copied only if
    it is not one already."""
    if (v.dtype == torch.float32 and v.device == device
            and v.is_contiguous()):
        return v
    return v.to(device, torch.float32).contiguous()


def _aligned(*tensors):
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


#: Per-sample ds/db partials of the backward, [B, 2C] float32, one buffer
#: per (device, stream, B, C): reused in stream order by every call (the
#: kernel writes it before its sum reads it, so it needs no clearing).
_scratch = {}


def _part(device, stream, b, c):
    key = (device, stream, b, c)
    buf = _scratch.get(key)
    if buf is None:
        buf = torch.empty((b, 2 * c), dtype=torch.float32, device=device)
        _scratch[key] = buf
    return buf


def _fwd_kernel(x, scale, bias, residual, g, eps, relu):
    """Launch K1 (no residual) or K2 on CUDA tensors: one kernel."""
    _check_kernel_inputs(x, [residual])
    x, residual = _dense(x), _dense(residual)
    scale, bias = _f32(scale, x.device), _f32(bias, x.device)
    b, h, w, c = x.shape
    plan = _plan(tuple(x.shape), x.dtype, g, aligned=_aligned(x, residual))
    y = torch.empty_like(x)
    stats = torch.empty((2, b, g), dtype=torch.float32, device=x.device)
    rc = _kernel_fn("group_norm_fwd")(
        x.data_ptr(), _ptr(residual), scale.data_ptr(), bias.data_ptr(),
        y.data_ptr(), stats.data_ptr(), stats.data_ptr() + 4 * b * g,
        b, h * w, c, g, *plan, eps, int(relu),
        int(x.dtype == torch.bfloat16), x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    dispatch.check("group_norm", rc)
    dispatch.count_launch("gn_fwd" if residual is None else "gn_fwd_res")
    return y, stats[0], stats[1]


def _bwd_kernel(x, dy, mean, rstd, scale, bias, residual, g, relu):
    """Launch K3 (no residual) or K4 on CUDA tensors: the kernel and its
    sum over B.  Returns ``(dx, ds [C], db [C], dres or None)``."""
    _check_kernel_inputs(x, [dy, residual])
    x, dy, residual = _dense(x), _dense(dy), _dense(residual)
    mean, rstd, scale, bias = (_f32(v, x.device)
                               for v in (mean, rstd, scale, bias))
    b, h, w, c = x.shape
    plan = _plan(tuple(x.shape), x.dtype, g, backward=True,
                 aligned=_aligned(x, dy, residual))
    dx = torch.empty_like(x)
    dres = None if residual is None else torch.empty_like(residual)
    sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel_fn("group_norm_bwd")(
        x.data_ptr(), dy.data_ptr(), _ptr(residual), scale.data_ptr(),
        bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        _ptr(dres), sums.data_ptr(), _part(x.device, stream, b, c).data_ptr(),
        b, h * w, c, g, *plan, int(relu),
        int(x.dtype == torch.bfloat16), x.device.index, stream,
    )
    dispatch.check("group_norm", rc)
    dispatch.count_launch("gn_bwd" if residual is None else "gn_bwd_res")
    return dx, sums[1], sums[0], dres


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
        return dx, ds, db, dres, None, None, None


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
