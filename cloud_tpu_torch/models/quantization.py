"""Weight-only int8 quantization for the inference path (port of ``cloud_tpu/models/quantization.py``).

Decode reads every weight once per generated token, so at CloudLM SMALL's
124M parameters the weight stream is the decode cost.  Storing matrices as
int8 with per-output-channel f32 scales halves those bytes against bf16.

Scheme (symmetric, per channel), the JAX package's exactly:

* matmul weights ``kernel`` (2-D, or a layer's ``[in, out]`` kernel of a
  stacked ``[L, in, out]`` leaf) and the MoE names ``wi``/``wg``/``wo``:
  one scale per output channel, over ``axis=-2``, shape ``[..., 1, out]``;
* embedding tables ``[V, D]``: one scale per row, over ``axis=-1``, shape
  ``[V, 1]`` (right for the lookup and for the tied head alike).

An eligible leaf ``{"kernel": w}`` becomes ``{"kernel_q": int8,
"kernel_scale": f32}``; everything else passes through.

The JAX package stacks the layers, so its eligibility rule (at least
:data:`MIN_QUANT_ELEMENTS` elements) sees ``L`` times a layer's leaf.  The
port keeps ``params["layers"]`` as a list of per-layer dicts and applies
the rule to the stacked size, ``L`` times the layer's, so both packages
quantize the same leaves.

Rounding is half-to-even (``torch.round``, as ``jnp.round``).  The check for
non-finite weights reads the device, so it runs in :func:`quantize_array`
(eager parameter preparation) and never in the KV cache's per-step
quantization (:func:`quantize_unchecked`).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

#: Leaves smaller than this stay full precision: norm scales, biases and
#: tiny kernels contribute nothing to the weight stream but would lose
#: accuracy.
MIN_QUANT_ELEMENTS = 16384

#: Matmul-weight leaf names: ``kernel`` (dense layers) and the MoE expert
#: matrices.
_MATMUL_NAMES = ("kernel", "wi", "wg", "wo")


def _quantize(w: torch.Tensor, axis: int):
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale, amax


def quantize_unchecked(w: torch.Tensor, *, axis: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with per-channel scales over ``axis`` (keepdims):
    ``(q, scale)`` with ``q * scale ~= w``; all-zero channels get scale 1.
    No host sync: a NaN channel gets scale 1 and undefined ``q``."""
    q, scale, _ = _quantize(w, axis)
    return q, scale


def quantize_array(w: torch.Tensor, *, axis: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_unchecked` that refuses non-finite weights (a
    corrupted checkpoint would round-trip as noise); reads the device."""
    q, scale, amax = _quantize(w, axis)
    if not bool(torch.isfinite(amax).all()):
        raise ValueError(
            "quantize_array: non-finite values in weights (amax is NaN/inf);"
            " refusing to quantize a corrupted array"
        )
    return q, scale


def _eligible(name: str, leaf, stacked: int) -> bool:
    """The JAX package's rule on the leaf as it would be stacked: ``stacked``
    is the layer count for a per-layer leaf, 0 for an unstacked one."""
    if name not in _MATMUL_NAMES + ("table",):
        return False
    if not isinstance(leaf, torch.Tensor):
        return False
    ndim = leaf.dim() + (1 if stacked else 0)
    if ndim < 2:
        return False
    if name == "kernel" and ndim > 3:
        return False  # conv kernels feed the convolution directly
    if name == "table" and ndim != 2:
        return False
    if not leaf.is_floating_point():
        return False
    return leaf.numel() * max(stacked, 1) >= MIN_QUANT_ELEMENTS


def _quantize_tree(tree, stacked: int):
    if isinstance(tree, list):
        return [_quantize_tree(layer, len(tree)) for layer in tree]
    if not isinstance(tree, dict):
        return tree
    out: Dict[str, Any] = {}
    for name, value in tree.items():
        if isinstance(value, (dict, list)):
            out[name] = _quantize_tree(value, stacked)
        elif _eligible(name, value, stacked):
            axis = -1 if name == "table" else -2
            q, scale = quantize_array(value, axis=axis)
            out[f"{name}_q"] = q
            out[f"{name}_scale"] = scale
        else:
            out[name] = value
    return out


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize every eligible ``kernel``/``table`` leaf of a param tree
    (a list of per-layer dicts counts as one stacked leaf per name)."""
    return _quantize_tree(params, 0)


def dequantize_params(params):
    """Inverse of :func:`quantize_params` up to rounding: full-width f32
    leaves under the original names.  A ``*_q`` leaf without its scale is
    passed through untouched."""
    if isinstance(params, list):
        return [dequantize_params(layer) for layer in params]
    if not isinstance(params, dict):
        return params
    out: Dict[str, Any] = {}
    for name, value in params.items():
        if isinstance(value, (dict, list)):
            out[name] = dequantize_params(value)
        elif name.endswith("_q"):
            base = name[:-2]
            scale = params.get(f"{base}_scale")
            if scale is None:
                out[name] = value
            else:
                out[base] = value.float() * scale
        elif name.endswith("_scale") and f"{name[:-6]}_q" in params:
            continue
        else:
            out[name] = value
    return out


def param_bytes(params) -> int:
    """Total stored bytes of a param tree, quantized or not."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_bytes(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    return 0
