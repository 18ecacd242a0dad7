"""The port's ResNet against the JAX package's, on the CPU.

Weights come from the JAX package's ``resnet.init`` and cross through
``cloud_tpu_torch.bridge``.  Pinned here: XLA's asymmetric ``SAME``
padding for strided convolutions and the max-pool (exact for the pool,
f32 atol 1e-5 for the convolutions), ``RESNET8_CIFAR`` logits in f32
(atol 1e-4), ``loss_fn``'s loss and accuracy, and the bridge and the
port-side init.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cloud_tpu.models import resnet as jax_resnet
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import resnet
from tests.helpers.torch_port import image_batch, resnet8_models

torch.set_num_threads(2)

#: One XLA program per call: far quicker on the CPU than op-by-op dispatch.
_jax_apply = jax.jit(jax_resnet.apply, static_argnums=2)
_jax_loss = jax.jit(jax_resnet.loss_fn, static_argnums=2)


@pytest.mark.parametrize("size,window,stride,want", [
    (32, 7, 2, (2, 3)), (224, 7, 2, (2, 3)), (16, 3, 2, (0, 1)),
    (15, 3, 2, (1, 1)), (8, 3, 1, (1, 1)), (8, 1, 2, (0, 0)),
    (1, 3, 2, (1, 1)),
])
def test_same_pads(size, window, stride, want):
    assert resnet.same_pads(size, window, stride) == want


@pytest.mark.parametrize("size,window,stride", [
    (32, 7, 2), (16, 3, 2), (15, 3, 2), (8, 3, 1), (8, 1, 2), (7, 1, 2),
])
def test_conv_same_padding_matches_jax(size, window, stride):
    rng = np.random.default_rng(size * 10 + window + stride)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    kernel = rng.standard_normal((window, window, 4, 6)).astype(np.float32)
    want = jax_resnet._conv({"kernel": kernel}, x, stride=stride)
    got = resnet._conv({"kernel": torch.from_numpy(kernel)},
                       torch.from_numpy(x), stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("size", [16, 15, 8, 2, 1])
def test_max_pool_same_padding_matches_jax(size):
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1), "SAME"))
    got = resnet._max_pool(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    if size == 16:  # PyTorch's symmetric padding gives other values here
        sym = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2,
                           padding=1).permute(0, 2, 3, 1).numpy()
        assert sym.shape == want.shape and not np.array_equal(sym, want)


@pytest.mark.parametrize("hw", [32, 36])
def test_logits_match_jax(hw):
    jax_cfg, params, cfg, port_params = resnet8_models(seed=0)
    images, _ = image_batch(2, hw, cfg.num_classes, seed=hw)
    want = np.asarray(_jax_apply(params, images, jax_cfg))
    got = resnet.apply(port_params, torch.from_numpy(images), cfg,
                       device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_loss_fn_matches_jax():
    jax_cfg, params, cfg, port_params = resnet8_models(seed=1)
    images, labels = image_batch(4, 32, cfg.num_classes, seed=4)
    labels[:2] = np.asarray(_jax_apply(params, images, jax_cfg)
                            )[:2].argmax(-1)  # two right answers at least
    want_loss, want_m = _jax_loss(
        params, {"image": images, "label": labels}, jax_cfg)
    loss, metrics = resnet.loss_fn(
        port_params, {"image": torch.from_numpy(images),
                      "label": torch.from_numpy(labels)}, cfg, device="cpu")
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert float(metrics["loss"]) == float(loss)
    assert float(metrics["accuracy"]) == float(want_m["accuracy"]) >= 0.5


def test_bridge_round_trip():
    _, params, _, port_params = resnet8_models(seed=2)
    back = bridge.resnet_to_numpy(port_params)
    flat, tree = jax.tree_util.tree_flatten(params)
    flat_back, tree_back = jax.tree_util.tree_flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        np.testing.assert_array_equal(a, b)


def test_init_resnet_tree_and_scales():
    cfg = resnet.RESNET50_CIFAR
    port = bridge.init_resnet(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    want = jax.eval_shape(lambda k: jax_resnet.init(k, jax_resnet.RESNET50_CIFAR),
                          jax.random.PRNGKey(0))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), want)
    assert jax.tree_util.tree_map(
        lambda t: tuple(t.shape), bridge.resnet_to_numpy(port)) == shapes
    # Truncated normal in [-2, 2] has std 0.8796 of the unit normal's.
    kernel = port["stage2_block0"]["conv2"]["kernel"]
    fan_in = 3 * 3 * kernel.shape[2]
    std = float(kernel.std()) / (2.0 / fan_in) ** 0.5
    assert abs(std - 0.8796) < 0.02
    assert float(kernel.abs().max()) <= 2.0 * (2.0 / fan_in) ** 0.5
    assert torch.equal(port["gn_stem"]["scale"], torch.ones(cfg.width))
    assert not port["head"]["bias"].any()
    assert sum(t.numel() for t in bridge.leaves(port)) == sum(
        int(np.prod(s)) for s in jax.tree_util.tree_leaves(
            shapes, is_leaf=lambda x: isinstance(x, tuple)))
