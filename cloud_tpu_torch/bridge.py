"""Weights between the JAX package and the port.

The JAX package keeps CloudLM's parameters as a pytree with numpy-like
leaves and the per-layer params stacked on a leading ``L`` axis
(``cloud_tpu/models/transformer.py`` ``init``).  The port keeps the same
names and layouts but a Python list of per-layer dicts, which its
forward pass walks in a loop.

- :func:`to_torch` turns the JAX pytree (numpy leaves, or anything
  ``numpy.asarray`` accepts) into the port's params on a device;
- :func:`to_numpy` goes back, restacking the layers;
- :func:`init` makes fresh random params with the JAX package's
  distributions from a ``torch.Generator`` (for runs that need weights of
  the right shape and scale, not the JAX package's exact numbers).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models.transformer import TransformerConfig, check_supported


def map_leaves(tree, fn):
    """``fn`` applied to every tensor leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_leaves(v, fn) for v in tree]
    return fn(tree)


def _unstack(tree, index: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, index) for k, v in tree.items()}
    return tree[index]


def to_torch(params, config: TransformerConfig, *, device=None
             ) -> Dict[str, Any]:
    """JAX-layout params (layers stacked on axis 0) -> the port's params."""
    check_supported(config)
    device = resolve_device(device)

    def convert(leaf):
        arr = np.asarray(leaf)
        if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
            arr = arr.astype(np.float32)
        return torch.from_numpy(np.array(arr, copy=True)).to(device)

    out = {k: map_leaves(v, convert) for k, v in params.items()
           if k != "layers"}
    out["layers"] = [map_leaves(_unstack(params["layers"], i), convert)
                     for i in range(config.num_layers)]
    return out


def to_numpy(params) -> Dict[str, Any]:
    """The port's params -> JAX-layout numpy pytree (layers restacked)."""
    def convert(t):
        return t.detach().float().cpu().numpy()

    out = {k: map_leaves(v, convert) for k, v in params.items()
           if k != "layers"}
    per_layer = [map_leaves(layer, convert) for layer in params["layers"]]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(l[k] for l in leaves)) for k in leaves[0]}
        return np.stack(leaves)

    out["layers"] = stack(*per_layer)
    return out


def _dense(gen, in_dim: int, out_dim: int):
    w = torch.empty((in_dim, out_dim), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return {"kernel": w * (1.0 / math.sqrt(in_dim))}


def init(config: TransformerConfig, generator: torch.Generator, *,
         device=None) -> Dict[str, Any]:
    """Random f32 params with the JAX package's distributions: dense
    kernels truncated-normal in [-2, 2] scaled by 1/sqrt(fan_in), the
    embedding N(0, 0.02^2), norm scales one."""
    check_supported(config)
    device = resolve_device(device)
    gen = generator
    d, hd = config.dim, config.num_heads * config.head_dim

    def ones(n):
        return {"scale": torch.ones((n,), dtype=torch.float32,
                                    device=gen.device)}

    table = torch.empty((config.vocab_size, d), dtype=torch.float32,
                        device=gen.device)
    table.normal_(0.0, 1.0, generator=gen)
    params = {"embed": {"table": table * 0.02}, "layers": [], "ln_f": ones(d)}
    for _ in range(config.num_layers):
        params["layers"].append({
            "att": {"q": _dense(gen, d, hd), "k": _dense(gen, d, hd),
                    "v": _dense(gen, d, hd), "out": _dense(gen, hd, d)},
            "ln1": ones(d),
            "mlp": {"wi": _dense(gen, d, config.mlp_hidden),
                    "wg": _dense(gen, d, config.mlp_hidden),
                    "wo": _dense(gen, config.mlp_hidden, d)},
            "ln2": ones(d),
        })
    if not config.tied_embeddings:
        params["head"] = _dense(gen, d, config.vocab_size)
    return map_leaves(params, lambda t: t.to(device))
