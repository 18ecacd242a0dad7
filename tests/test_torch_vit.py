"""The port's ViT on the CPU, against the JAX package.

``VIT_TINY_CIFAR`` at 2 layers in f32 from the JAX package's own weights,
with GAP and CLS pooling, at 32 px (T = 64, or 65 with the class token)
and at 28 px (T = 49 or 50, off the flash kernels' 64-row tiles): logits
within 1e-4; loss and accuracy within 1e-5 and every gradient within 1e-5
of the largest magnitude; remat "none", "full" and "dots" give
bit-identical gradients; two ``make_train_step`` steps with ``adamw``
follow the JAX step's loss and grad norm within 1e-4; the bridge
round-trips JAX's tree bit for bit, and ``bridge.init_vit`` makes a tree
of JAX's structure, shapes and types.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.models import vit as jax_vit
from cloud_tpu.training import train as jax_train
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import vit
from cloud_tpu_torch.training import optimizers, train
from helpers.torch_port import image_batch

torch.set_num_threads(1)

#: (pooling, image size): T = 64 / 65 at 32 px, 49 / 50 at 28 px.
CASES = [("gap", 32), ("cls", 32), ("gap", 28), ("cls", 28)]
BATCH = 4


def _jax_cfg(pooling, size, **kw):
    return jax_vit.VIT_TINY_CIFAR.scaled(
        dtype=jnp.float32, num_layers=2, pooling=pooling, image_size=size,
        **kw)


def _port_cfg(jcfg):
    fields = ("image_size", "patch_size", "channels", "num_layers", "dim",
              "num_heads", "mlp_hidden", "num_classes", "remat",
              "remat_policy", "pooling")
    return vit.ViTConfig(dtype=torch.float32,
                         **{f: getattr(jcfg, f) for f in fields})


@functools.lru_cache(maxsize=None)
def _jax_params(pooling, size):
    cfg = _jax_cfg(pooling, size)
    params = jax.jit(jax_vit.init, static_argnums=1)(jax.random.PRNGKey(7),
                                                     cfg)
    return jax.tree_util.tree_map(np.asarray, params)


def _batch(size):
    images, labels = image_batch(BATCH, size, 10, seed=3)
    return {"image": images, "label": labels}


def _port_grads(params_np, cfg, batch):
    params = bridge.vit_to_torch(params_np, cfg, device="cpu")
    params = bridge.map_leaves(params, lambda t: t.requires_grad_(True))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = vit.loss_fn(params, tbatch, cfg, device="cpu")
    loss.backward()
    grads = bridge.vit_to_numpy(bridge.map_leaves(params, lambda t: t.grad))
    return metrics, grads


@pytest.mark.parametrize("pooling,size", CASES)
def test_logits_match_jax(pooling, size):
    jcfg = _jax_cfg(pooling, size)
    params = _jax_params(pooling, size)
    images = _batch(size)["image"]
    want = jax_vit.apply(params, jnp.asarray(images), jcfg)
    cfg = _port_cfg(jcfg)
    got = vit.apply(bridge.vit_to_torch(params, cfg, device="cpu"),
                    torch.from_numpy(images), cfg, device="cpu")
    assert got.dtype == torch.float32
    t = cfg.num_patches + (pooling == "cls")
    assert (t % 64 == 0) == (size == 32 and pooling == "gap")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("pooling,size", CASES)
def test_loss_and_grads_match_jax(pooling, size):
    jcfg = _jax_cfg(pooling, size)
    params = _jax_params(pooling, size)
    batch = _batch(size)
    (_, want_m), want = jax.value_and_grad(
        functools.partial(jax_vit.loss_fn, cfg=jcfg), has_aux=True)(
            params, batch)
    metrics, got = _port_grads(params, _port_cfg(jcfg), batch)
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(want_m[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    want_leaves = jax.tree_util.tree_leaves(want)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    scale = max(np.abs(np.asarray(w)).max() for w in want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("pooling", ["gap", "cls"])
def test_remat_policies_give_identical_grads(pooling):
    params = _jax_params(pooling, 28)
    base = _port_cfg(_jax_cfg(pooling, 28))
    batch = _batch(28)
    runs = [_port_grads(params, base.scaled(remat=remat, remat_policy=policy),
                        batch)
            for remat, policy in ((False, "full"), (True, "full"),
                                  (True, "dots"))]
    for metrics, grads in runs[1:]:
        assert float(metrics["loss"].detach()) == float(
            runs[0][0]["loss"].detach())
        for a, b in zip(jax.tree_util.tree_leaves(grads),
                        jax.tree_util.tree_leaves(runs[0][1])):
            np.testing.assert_array_equal(a, b)


def test_two_adamw_steps_match_jax_trajectory():
    jcfg = _jax_cfg("gap", 28, remat=True)
    params = _jax_params("gap", 28)
    batch = _batch(28)
    jtx = optax.adamw(3e-4)
    jstate = jax_train.create_sharded_state(
        jax.random.PRNGKey(0),
        lambda _: jax.tree_util.tree_map(jnp.asarray, params), jtx,
        mesh=None)
    jstep = jax_train.make_train_step(
        functools.partial(jax_vit.loss_fn, cfg=jcfg), jtx)
    cfg = _port_cfg(jcfg)
    tx = optimizers.adamw(3e-4, mu_dtype=None)
    state = train.create_sharded_state(
        None, lambda _: bridge.vit_to_torch(params, cfg, device="cpu"), tx,
        device="cpu")
    step = train.make_train_step(
        functools.partial(vit.loss_fn, cfg=cfg, device="cpu"), tx)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(2):
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, tbatch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{key} step {i}")


@pytest.mark.parametrize("pooling", ["gap", "cls"])
def test_bridge_round_trip_and_init_tree(pooling):
    jcfg = _jax_cfg(pooling, 32)
    params = _jax_params(pooling, 32)
    cfg = _port_cfg(jcfg)
    back = bridge.vit_to_numpy(bridge.vit_to_torch(params, cfg, device="cpu"))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    fresh = bridge.vit_to_numpy(bridge.init_vit(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    assert (jax.tree_util.tree_structure(fresh)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(fresh),
                    jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert fresh["pos"].std() == pytest.approx(0.02, rel=0.2)


def test_init_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="divisible"):
        bridge.init_vit(vit.VIT_TINY_CIFAR.scaled(image_size=30),
                        torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="pooling"):
        bridge.init_vit(vit.VIT_TINY_CIFAR.scaled(pooling="max"),
                        torch.Generator(), device="cpu")
