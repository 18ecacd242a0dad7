"""Functional layers over parameter dicts (port of ``cloud_tpu/models/layers.py``).

Parameters are plain dicts of tensors with the JAX package's names and
layouts (dense kernels ``[in, out]``).  Compute runs in the dtype of the
activations; a weight is cast to it where it is used, as in the JAX
package, so f32 master weights and weights stored once in the compute
dtype give the same numbers.  Weight-only int8 leaves (``kernel_q`` /
``table_q`` with their ``*_scale``, ``models/quantization.py``) take the
JAX package's post-scale route: the int8 matrix feeds the product and the
per-channel scale applies to its small output.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

#: Remat policies of the JAX package's layer stacks; "dots" (save the
#: matmul outputs) has no port yet.
REMAT_POLICIES = ("none", "full", "dots")


def remat_wrap(body, enabled: bool = True, policy: str = "full"):
    """Wrap a layer body with the named remat policy, as
    ``cloud_tpu/models/layers.py``'s ``remat_wrap``: "full" keeps only the
    layer's inputs and recomputes the layer in the backward pass
    (``torch.utils.checkpoint``, non-reentrant); "none" (or ``enabled``
    False) keeps every activation.  Numbers are the same either way.
    Without autograd (serving, ``torch.no_grad()``) the body runs plain."""
    if not enabled or policy == "none":
        return body
    if policy == "dots":
        raise NotImplementedError(
            "remat policy 'dots' (save matmul outputs) is not ported yet "
            "(ROADMAP.md A.3)"
        )
    if policy != "full":
        raise ValueError(
            f"remat policy must be one of {REMAT_POLICIES}, got {policy!r}"
        )

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return body(*args, **kwargs)
        return checkpoint(body, *args, use_reentrant=False, **kwargs)

    return wrapped


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, *,
               use_bias: bool = True):
    """Kernel ``[in, out]``, truncated normal in [-2, 2] scaled by
    1/sqrt(in), and a zero bias, as ``cloud_tpu/models/layers.py``'s
    ``dense_init``; on the generator's device."""
    w = torch.empty((in_dim, out_dim), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    params = {"kernel": w * (1.0 / math.sqrt(in_dim))}
    if use_bias:
        params["bias"] = torch.zeros((out_dim,), dtype=torch.float32,
                                     device=generator.device)
    return params


def materialize_matrix(params, name: str, dtype):
    """The (possibly int8-quantized) matrix ``name`` at compute width:
    ``{name}_q * {name}_scale`` for a quantized leaf."""
    if f"{name}_q" in params:
        return (params[f"{name}_q"].to(dtype)
                * params[f"{name}_scale"].to(dtype))
    return params[name].to(dtype)


def dense_apply(params, x, *, dtype=None):
    """``x @ kernel (+ bias)`` in ``dtype`` (default: x's).  An int8 kernel
    takes the post-scale route, ``(x @ q) * scale``, with the per-output
    scale ``[1, out]`` applied to the product."""
    dtype = dtype or x.dtype
    if "kernel_q" in params:
        q = params["kernel_q"].to(dtype)
        scale = params["kernel_scale"].squeeze(-2).to(dtype)
        y = torch.matmul(x.to(dtype), q) * scale
    else:
        y = torch.matmul(x.to(dtype), params["kernel"].to(dtype))
    if "bias" in params:
        y = y + params["bias"].to(dtype)
    return y


def embedding_apply(params, token_ids, *, dtype=torch.float32):
    """Table lookup; rows are gathered first and cast after (the same
    numbers as casting the whole table, without touching all of it).  An
    int8 table gathers int8 rows and scales them by their per-row scale."""
    ids = token_ids.long()
    if "table_q" in params:
        rows = params["table_q"][ids].to(dtype)
        return rows * params["table_scale"][ids].to(dtype)
    return params["table"][ids].to(dtype)


def layernorm_apply(params, x, *, eps: float = 1e-6):
    """LayerNorm with f32 statistics (population variance, as ``jnp.var``)
    whatever the activations' type."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def rmsnorm_apply(params, x, *, eps: float = 1e-6):
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * params["scale"]).to(x.dtype)


def rotary_embedding(x, positions, *, base: float = 10000.0):
    """RoPE applied to ``[..., T, H, D]`` with positions ``[..., T]``."""
    dim = x.shape[-1]
    half = dim // 2
    freqs = base ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions[..., :, None].float() * freqs  # [..., T, half]
    angles = angles[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_block_apply(params, x):
    """Gated (SwiGLU) MLP."""
    h = F.silu(dense_apply(params["wi"], x)) * dense_apply(params["wg"], x)
    return dense_apply(params["wo"], h)
