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

Weight-only int8 trees (``quantize_params``) cross both ways: ``*_q``
leaves stay int8, and a stacked ``*_scale`` ``[L, 1, out]`` splits into a
layer's ``[1, out]`` like any other stacked leaf.

ResNet's params are one dict with the same names and layouts on both
sides (HWIO conv kernels, ``{"scale", "bias"}`` GroupNorm leaves, a dense
``head``): :func:`resnet_to_torch`, :func:`resnet_to_numpy` and
:func:`init_resnet` are their counterparts.  BERT's are stacked on ``L``
like CloudLM's: :func:`bert_to_torch`, :func:`bert_to_numpy` and
:func:`init_bert`.  MNIST's (``{"hidden", "out"}`` dense layers) are
:func:`mnist_to_torch`, :func:`mnist_to_numpy` and :func:`init_mnist`.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import layers
from cloud_tpu_torch.models.bert import BertConfig
from cloud_tpu_torch.models.mnist import MnistConfig
from cloud_tpu_torch.models.resnet import ResNetConfig
from cloud_tpu_torch.models.transformer import TransformerConfig, check_supported


def map_leaves(tree, fn):
    """``fn`` applied to every tensor leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_leaves(v, fn) for v in tree]
    return fn(tree)


def leaves(tree) -> List[Any]:
    """The tensor leaves of nested dicts and lists, dict keys sorted (the
    order ``jax.tree_util`` flattens them in)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in leaves(v)]
    return [tree]


def _tensor(leaf, device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _to_numpy(t) -> np.ndarray:
    """f32 for floating leaves (bf16 has no numpy type); int8 ``*_q``
    leaves and other integer leaves keep their type."""
    t = t.detach()
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


def _unstack(tree, index: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, index) for k, v in tree.items()}
    return tree[index]


def _split_layers(params, num_layers: int, device) -> Dict[str, Any]:
    """Numpy-like leaves to tensors on ``device``, the stacked
    ``params["layers"]`` split into a list of ``num_layers`` dicts."""
    device = resolve_device(device)

    def convert(leaf):
        return _tensor(leaf, device)

    out = {k: map_leaves(v, convert) for k, v in params.items()
           if k != "layers"}
    out["layers"] = [map_leaves(_unstack(params["layers"], i), convert)
                     for i in range(num_layers)]
    return out


def to_torch(params, config: TransformerConfig, *, device=None
             ) -> Dict[str, Any]:
    """JAX-layout params (layers stacked on axis 0) -> the port's params."""
    check_supported(config)
    return _split_layers(params, config.num_layers, device)


def to_numpy(params) -> Dict[str, Any]:
    """The port's params -> JAX-layout numpy pytree (layers restacked)."""
    out = {k: map_leaves(v, _to_numpy) for k, v in params.items()
           if k != "layers"}
    per_layer = [map_leaves(layer, _to_numpy) for layer in params["layers"]]

    def stack(*leaves):
        if isinstance(leaves[0], dict):
            return {k: stack(*(l[k] for l in leaves)) for k in leaves[0]}
        return np.stack(leaves)

    out["layers"] = stack(*per_layer)
    return out


def _dense(gen, in_dim: int, out_dim: int):
    return layers.dense_init(gen, in_dim, out_dim, use_bias=False)


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


def resnet_to_torch(params, *, device=None) -> Dict[str, Any]:
    """JAX ResNet params (numpy-like leaves) -> the port's, as float32."""
    device = resolve_device(device)
    return map_leaves(params, lambda leaf: _tensor(leaf, device))


def resnet_to_numpy(params) -> Dict[str, Any]:
    """The port's ResNet params -> a numpy pytree for the JAX package."""
    return map_leaves(params, _to_numpy)


def _conv_init(gen, kh: int, kw: int, cin: int, cout: int):
    w = torch.empty((kh, kw, cin, cout), dtype=torch.float32,
                    device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return {"kernel": w * (2.0 / (kh * kw * cin)) ** 0.5}


def _gn_init(c: int, device):
    return {"scale": torch.ones((c,), dtype=torch.float32, device=device),
            "bias": torch.zeros((c,), dtype=torch.float32, device=device)}


def init_resnet(config: ResNetConfig, generator: torch.Generator, *,
                device=None) -> Dict[str, Any]:
    """Random float32 ResNet params with the JAX package's distributions
    and tree: conv kernels HWIO, truncated normal in [-2, 2] times
    sqrt(2 / fan_in); GroupNorm scale one, bias zero; the dense head as
    ``layers.dense_init``."""
    device = resolve_device(device)
    gen = generator
    params: Dict[str, Any] = {
        "stem": _conv_init(gen, 7, 7, 3, config.width),
        "gn_stem": _gn_init(config.width, gen.device),
    }
    cin = config.width
    for stage, num_blocks in enumerate(config.stage_sizes):
        cmid = config.width * (2 ** stage)
        cout = cmid * 4
        for block in range(num_blocks):
            stride = 2 if (block == 0 and stage > 0) else 1
            p = {
                "conv1": _conv_init(gen, 1, 1, cin, cmid),
                "gn1": _gn_init(cmid, gen.device),
                "conv2": _conv_init(gen, 3, 3, cmid, cmid),
                "gn2": _gn_init(cmid, gen.device),
                "conv3": _conv_init(gen, 1, 1, cmid, cout),
                "gn3": _gn_init(cout, gen.device),
            }
            if stride != 1 or cin != cout:
                p["proj"] = _conv_init(gen, 1, 1, cin, cout)
                p["gn_proj"] = _gn_init(cout, gen.device)
            params[f"stage{stage}_block{block}"] = p
            cin = cout
    params["head"] = layers.dense_init(gen, cin, config.num_classes)
    return map_leaves(params, lambda t: t.to(device))


def bert_to_torch(params, config: BertConfig, *, device=None
                  ) -> Dict[str, Any]:
    """JAX BERT params (layers stacked on axis 0) -> the port's params."""
    return _split_layers(params, config.num_layers, device)


def bert_to_numpy(params) -> Dict[str, Any]:
    """The port's BERT params -> the JAX layout (layers restacked)."""
    return to_numpy(params)


def _embedding(gen, rows: int, dim: int):
    table = torch.empty((rows, dim), dtype=torch.float32, device=gen.device)
    table.normal_(0.0, 1.0, generator=gen)
    return {"table": table * 0.02}


def _ln_init(dim: int, device):
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device),
            "bias": torch.zeros((dim,), dtype=torch.float32, device=device)}


def init_bert(config: BertConfig, generator: torch.Generator, *,
              device=None) -> Dict[str, Any]:
    """Random f32 BERT params with the JAX package's distributions and
    tree: embeddings N(0, 0.02^2); attention projections without bias,
    ``wi``/``wo``, pooler and classifier with a zero bias, all kernels
    truncated-normal in [-2, 2] scaled by 1/sqrt(fan_in); LayerNorm scale
    one, bias zero."""
    device = resolve_device(device)
    gen = generator
    d, f = config.dim, config.mlp_hidden
    params: Dict[str, Any] = {
        "tok": _embedding(gen, config.vocab_size, d),
        "pos": _embedding(gen, config.max_seq_len, d),
        "seg": _embedding(gen, 2, d),
        "ln_embed": _ln_init(d, gen.device),
        "layers": [],
    }
    for _ in range(config.num_layers):
        params["layers"].append({
            "att": {"q": _dense(gen, d, d), "k": _dense(gen, d, d),
                    "v": _dense(gen, d, d), "out": _dense(gen, d, d)},
            "ln1": _ln_init(d, gen.device),
            "wi": layers.dense_init(gen, d, f),
            "wo": layers.dense_init(gen, f, d),
            "ln2": _ln_init(d, gen.device),
        })
    params["pooler"] = layers.dense_init(gen, d, d)
    params["classifier"] = layers.dense_init(gen, d, config.num_classes)
    return map_leaves(params, lambda t: t.to(device))


def mnist_to_torch(params, *, device=None) -> Dict[str, Any]:
    """JAX MNIST params (numpy-like leaves) -> the port's, as float32."""
    device = resolve_device(device)
    return map_leaves(params, lambda leaf: _tensor(leaf, device))


def mnist_to_numpy(params) -> Dict[str, Any]:
    """The port's MNIST params -> a numpy pytree for the JAX package."""
    return map_leaves(params, _to_numpy)


def init_mnist(config: MnistConfig, generator: torch.Generator, *,
               device=None) -> Dict[str, Any]:
    """Random f32 MNIST params with the JAX package's distributions and
    tree: two ``layers.dense_init`` layers, ``hidden`` and ``out``."""
    device = resolve_device(device)
    params = {
        "hidden": layers.dense_init(generator, config.input_dim,
                                    config.hidden_dim),
        "out": layers.dense_init(generator, config.hidden_dim,
                                 config.num_classes),
    }
    return map_leaves(params, lambda t: t.to(device))
