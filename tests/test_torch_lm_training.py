"""The port's CloudLM training loss and step against the JAX package's, on the CPU.

TINY at 2 layers in f32 (batch 2 x T 32) from the JAX package's own
weights: ``transformer.loss_fn``'s loss and every gradient against
``jax.value_and_grad(transformer.loss_fn)``, in both head layouts (tied
``"vd"`` and dense ``"dv"``), both CE branches (plain and ``fused_ce``)
and with and without ``loss_mask``, with remat on, at 1e-5 of the largest
gradient magnitude; remat on and off give identical gradients; remat
"dots" gives "full"'s and "none"'s loss and gradients bit for bit and
JAX's "dots" within the same tolerances, and its backward recomputes no
dense product (counted at the dispatcher: "full" recomputes them all).  The
fused CE op alone is held against JAX's at a chunk that does not divide
V, and three ``make_train_step`` steps with ``adamw`` against the JAX
step with ``optax.adamw`` follow the same loss trajectory within 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cloud_tpu.models import transformer as jax_tf
from cloud_tpu.ops import fused_cross_entropy as jax_fce
from cloud_tpu.training import train as jax_train
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import transformer
from cloud_tpu_torch.ops import fused_cross_entropy as port_fce
from cloud_tpu_torch.training import optimizers, train
from tests.helpers.torch_port import port_config

torch.set_num_threads(1)

BATCH, SEQ = 2, 32


@functools.lru_cache(maxsize=None)
def _jax_params(tied):
    cfg = jax_tf.TINY.scaled(dtype=jnp.float32, num_layers=2,
                             tied_embeddings=tied)
    params = jax.jit(jax_tf.init, static_argnums=1)(jax.random.PRNGKey(4),
                                                    cfg)
    return jax.tree_util.tree_map(np.asarray, params)


def _batch(with_mask):
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(1, 256, (BATCH, SEQ)).astype(np.int32)}
    if with_mask:
        mask = np.ones((BATCH, SEQ), np.int32)
        mask[0, SEQ // 2:] = 0
        batch["loss_mask"] = mask
    return batch


def _port_loss_and_grads(params_np, cfg, batch):
    params = bridge.to_torch(params_np, cfg, device="cpu")
    params = bridge.map_leaves(params, lambda t: t.requires_grad_(True))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = transformer.loss_fn(params, tbatch, cfg, device="cpu")
    loss.backward()
    grads = bridge.to_numpy(bridge.map_leaves(params, lambda t: t.grad))
    return float(loss.detach()), metrics, grads


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("fused_ce", [False, True])
@pytest.mark.parametrize("tied", [True, False])
def test_loss_and_grads_match_jax(tied, fused_ce, with_mask):
    jax_cfg = jax_tf.TINY.scaled(dtype=jnp.float32, num_layers=2,
                                 tied_embeddings=tied, fused_ce=fused_ce,
                                 remat=True)
    params = _jax_params(tied)
    batch = _batch(with_mask)
    (want_loss, want_m), want = jax.jit(jax.value_and_grad(
        functools.partial(jax_tf.loss_fn, config=jax_cfg), has_aux=True))(
            params, batch)
    cfg = port_config(jax_cfg)
    assert cfg.remat and cfg.fused_ce == fused_ce
    loss, metrics, got = _port_loss_and_grads(params, cfg, batch)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"].detach()),
                               float(want_m["ce"]),
                               rtol=1e-5)
    want_leaves = jax.tree_util.tree_leaves(want)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    scale = max(np.abs(np.asarray(w)).max() for w in want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("fused_ce", [False, True])
def test_remat_on_and_off_give_identical_grads(fused_ce):
    params = _jax_params(True)
    base = port_config(jax_tf.TINY.scaled(
        dtype=jnp.float32, num_layers=2, tied_embeddings=True,
        fused_ce=fused_ce))
    batch = _batch(True)
    runs = [_port_loss_and_grads(params, base.scaled(remat=r), batch)
            for r in (False, True)]
    assert runs[0][0] == runs[1][0]
    for a, b in zip(jax.tree_util.tree_leaves(runs[0][2]),
                    jax.tree_util.tree_leaves(runs[1][2])):
        np.testing.assert_array_equal(a, b)


def test_remat_dots_is_not_ported():
    """Remat "dots" is ported (the name is the one of the refusal it
    replaced): its loss and every gradient are bit-identical to "full"
    and "none" in the port, and equal JAX's "dots" within the LM
    tolerances."""
    params = _jax_params(True)
    batch = _batch(True)
    jax_cfg = jax_tf.TINY.scaled(dtype=jnp.float32, num_layers=2,
                                 tied_embeddings=True, remat=True,
                                 remat_policy="dots")
    cfg = port_config(jax_cfg)
    assert cfg.remat_policy == "dots"
    runs = {name: _port_loss_and_grads(params, c, batch) for name, c in (
        ("dots", cfg), ("full", cfg.scaled(remat_policy="full")),
        ("none", cfg.scaled(remat=False)))}
    for name in ("full", "none"):
        assert runs[name][0] == runs["dots"][0], name
        for a, b in zip(jax.tree_util.tree_leaves(runs[name][2]),
                        jax.tree_util.tree_leaves(runs["dots"][2])):
            np.testing.assert_array_equal(a, b)
    (want_loss, _), want = jax.jit(jax.value_and_grad(
        functools.partial(jax_tf.loss_fn, config=jax_cfg), has_aux=True))(
            params, batch)
    np.testing.assert_allclose(runs["dots"][0], float(want_loss), rtol=1e-5)
    want_leaves = jax.tree_util.tree_leaves(want)
    scale = max(np.abs(np.asarray(w)).max() for w in want_leaves)
    for a, b in zip(jax.tree_util.tree_leaves(runs["dots"][2]), want_leaves):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=1e-5 * scale)


class _CountProducts(TorchDispatchMode):
    """Counts the dense products (``aten.mm``/``addmm``) dispatched."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _products(cfg, params_np, batch):
    """Dense products in the forward pass and in the backward pass."""
    params = bridge.map_leaves(bridge.to_torch(params_np, cfg, device="cpu"),
                               lambda t: t.requires_grad_(True))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with _CountProducts() as fwd:
        loss, _ = transformer.loss_fn(params, tbatch, cfg, device="cpu")
    with _CountProducts() as bwd:
        loss.backward()
    return fwd.n, bwd.n


@pytest.mark.parametrize("moe", [False, True])
def test_dots_recomputes_no_dense_product(moe):
    """The backward under "dots" runs exactly the products "none" runs
    (each layer's projections come from the saved outputs); under "full"
    it runs them plus the layers' forward products again.  The dense
    projections reach the dispatcher as ``aten.mm``."""
    from helpers.torch_port import TINY_MOE

    jax_cfg = jax_tf.TINY.scaled(dtype=jnp.float32, num_layers=2,
                                 tied_embeddings=True,
                                 moe=TINY_MOE if moe else None)
    params = jax.tree_util.tree_map(np.asarray, jax_tf.init(
        jax.random.PRNGKey(4), jax_cfg))
    cfg = port_config(jax_cfg)
    batch = _batch(False)
    fwd_none, bwd_none = _products(cfg.scaled(remat=False), params, batch)
    _, bwd_dots = _products(cfg.scaled(remat=True, remat_policy="dots"),
                            params, batch)
    _, bwd_full = _products(cfg.scaled(remat=True, remat_policy="full"),
                            params, batch)
    # q, k, v, out and the MLP's three (the router alone under MoE: its
    # experts are batched products), and the head outside the layers.
    per_layer = 5 if moe else 7
    assert fwd_none == 2 * per_layer + 1
    assert bwd_dots == bwd_none
    # "full" recomputes up to the last saved value the backward reads: the
    # dense MLP's ``wo`` output feeds only the residual add, so its
    # product is not run again.
    recomputed = per_layer if moe else per_layer - 1
    assert bwd_full == bwd_none + 2 * recomputed


@pytest.mark.parametrize("layout", ["vd", "dv"])
def test_fused_ce_op_matches_jax_at_ragged_chunk(layout):
    rng = np.random.default_rng(1)
    n, d, v, chunk = 24, 16, 100, 48  # 48 does not divide 100
    x = rng.standard_normal((2, n // 2, d)).astype(np.float32)
    table = (0.3 * rng.standard_normal((v, d) if layout == "vd" else (d, v))
             ).astype(np.float32)
    targets = rng.integers(0, v, (2, n // 2)).astype(np.int32)
    weights = (rng.random((2, n // 2)) > 0.3).astype(np.float32)

    def jax_loss(x, table):
        return jax_fce.fused_linear_cross_entropy(
            x, table, jnp.asarray(targets), table_layout=layout,
            chunk_size=chunk, weights=jnp.asarray(weights))

    want, (wx, wt) = jax.value_and_grad(jax_loss, argnums=(0, 1))(x, table)
    tx, tt = (torch.from_numpy(a).requires_grad_(True) for a in (x, table))
    got = port_fce.fused_linear_cross_entropy(
        tx, tt, torch.from_numpy(targets), table_layout=layout,
        chunk_size=chunk, weights=torch.from_numpy(weights))
    gx, gt = torch.autograd.grad(got, (tx, tt))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    for a, b in ((gx, wx), (gt, wt)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


def test_three_adamw_steps_match_jax_trajectory():
    jax_cfg = jax_tf.TINY.scaled(dtype=jnp.float32, num_layers=2,
                                 remat=True)
    params = _jax_params(False)
    batch = _batch(False)
    jtx = optax.adamw(1e-3)
    jstate = jax_train.create_sharded_state(
        jax.random.PRNGKey(0), lambda _: params, jtx, mesh=None)
    jstep = jax_train.make_train_step(
        functools.partial(jax_tf.loss_fn, config=jax_cfg), jtx)
    cfg = port_config(jax_cfg)
    tx = optimizers.adamw(1e-3, mu_dtype=None)
    state = train.create_sharded_state(
        None, lambda _: bridge.to_torch(params, cfg, device="cpu"), tx,
        device="cpu")
    step = train.make_train_step(
        functools.partial(transformer.loss_fn, config=cfg, device="cpu"), tx)
    tbatch = {"tokens": torch.from_numpy(batch["tokens"])}
    for i in range(3):
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, tbatch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{key} step {i}")
