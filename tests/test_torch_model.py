"""The port's CloudLM layers and forward pass against the JAX package's.

Weights come from the JAX package's own ``init`` and cross through
``cloud_tpu_torch.bridge``; inputs are numpy arrays from a seed.  f32
throughout: layers at atol 1e-5, logits at atol 1e-4.  Weight-only int8
trees (JAX ``quantize_params``) go through the same layers, heads and
forward pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import layers as jax_layers
from cloud_tpu.models import quantization as jax_quant
from cloud_tpu.models import transformer as jax_tf
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import layers, transformer

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _port_config(jax_cfg):
    fields = ("vocab_size", "num_layers", "dim", "num_heads", "head_dim",
              "mlp_hidden", "max_seq_len", "rope_base", "tied_embeddings")
    return transformer.TransformerConfig(
        dtype=torch.float32, **{f: getattr(jax_cfg, f) for f in fields})


def test_dense_and_mlp_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    dense = {"kernel": rng.standard_normal((12, 7)).astype(np.float32),
             "bias": rng.standard_normal((7,)).astype(np.float32)}
    np.testing.assert_allclose(
        layers.dense_apply({k: _t(v) for k, v in dense.items()}, _t(x)).numpy(),
        np.asarray(jax_layers.dense_apply(dense, x)), atol=1e-5)
    mlp = {n: {"kernel": rng.standard_normal(s).astype(np.float32)}
           for n, s in (("wi", (12, 20)), ("wg", (12, 20)), ("wo", (20, 12)))}
    port_mlp = {n: {"kernel": _t(p["kernel"])} for n, p in mlp.items()}
    np.testing.assert_allclose(
        layers.mlp_block_apply(port_mlp, _t(x)).numpy(),
        np.asarray(jax_layers.mlp_block_apply(mlp, x)), atol=1e-5)


def test_embedding_rmsnorm_rotary_match_jax():
    rng = np.random.default_rng(1)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (3, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        layers.embedding_apply({"table": _t(table)}, _t(ids)).numpy(),
        np.asarray(jax_layers.embedding_apply({"table": table}, ids)))
    x = rng.standard_normal((3, 4, 8)).astype(np.float32)
    scale = rng.standard_normal((8,)).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm_apply({"scale": _t(scale)}, _t(x)).numpy(),
        np.asarray(jax_layers.rmsnorm_apply({"scale": scale}, x)), atol=1e-5)
    xr = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4, 5], [7, 9, 11, 40, 100, 127]], np.int32)
    np.testing.assert_allclose(
        layers.rotary_embedding(_t(xr), _t(pos)).numpy(),
        np.asarray(jax_layers.rotary_embedding(xr, pos)), atol=1e-5)


def test_int8_weights_raise():
    """A quantized head with anything beyond ``kernel_q``/``kernel_scale``
    raises, as in JAX, rather than dropping the extra leaf."""
    cfg = transformer.TINY.scaled(dtype=torch.float32)
    head = {"kernel_q": torch.zeros((cfg.dim, 8), dtype=torch.int8),
            "kernel_scale": torch.ones((1, 8)), "bias": torch.zeros(8)}
    with pytest.raises(NotImplementedError, match="extra params"):
        transformer.lm_logits({"head": head, "embed": {}},
                              torch.zeros((1, cfg.dim)), cfg)
    with pytest.raises(NotImplementedError, match="bias-free"):
        transformer.head_table({"head": head}, cfg)


def _int8(tree):
    q, scale = jax_quant.quantize_array(jnp.asarray(tree), axis=-2)
    return {"kernel_q": np.array(q), "kernel_scale": np.array(scale)}


def test_int8_dense_and_embedding_match_jax():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    dense = dict(_int8(rng.standard_normal((12, 7)).astype(np.float32)),
                 bias=rng.standard_normal((7,)).astype(np.float32))
    np.testing.assert_allclose(
        layers.dense_apply({k: _t(v) for k, v in dense.items()}, _t(x)).numpy(),
        np.asarray(jax_layers.dense_apply(dense, x)), atol=1e-5)
    q, scale = jax_quant.quantize_array(
        jnp.asarray(rng.standard_normal((50, 8)).astype(np.float32)), axis=-1)
    table = {"table_q": np.array(q), "table_scale": np.array(scale)}
    ids = rng.integers(0, 50, (3, 4)).astype(np.int32)
    np.testing.assert_allclose(
        layers.embedding_apply({k: _t(v) for k, v in table.items()},
                               _t(ids)).numpy(),
        np.asarray(jax_layers.embedding_apply(table, ids)), atol=1e-5)
    np.testing.assert_allclose(
        layers.materialize_matrix({k: _t(v) for k, v in dense.items()},
                                  "kernel", torch.float32).numpy(),
        np.asarray(jax_layers.materialize_matrix(dense, "kernel",
                                                 jnp.float32)), atol=1e-6)


@pytest.mark.parametrize("tied", [False, True])
def test_int8_lm_logits_and_apply_match_jax(tied):
    jax_cfg = jax_tf.TINY.scaled(dtype=jnp.float32, tied_embeddings=tied)
    params = jax.tree_util.tree_map(np.asarray, jax_quant.quantize_params(
        jax_tf.init(jax.random.PRNGKey(6), jax_cfg)))
    cfg = _port_config(jax_cfg)
    port = bridge.to_torch(params, cfg, device="cpu")
    head = port["embed"] if tied else port["head"]
    assert head["table_q" if tied else "kernel_q"].dtype == torch.int8
    x = np.random.default_rng(7).standard_normal((2, 3, cfg.dim)).astype(
        np.float32)
    np.testing.assert_allclose(
        transformer.lm_logits(port, _t(x), cfg).numpy(),
        np.asarray(jax_tf.lm_logits(params, x, jax_cfg)), atol=1e-5)
    table, layout = transformer.head_table(port, cfg)
    want_table, want_layout = jax_tf.head_table(params, jax_cfg)
    assert layout == want_layout
    np.testing.assert_allclose(table.numpy(), np.asarray(want_table),
                               atol=1e-6)
    tokens = np.random.default_rng(8).integers(
        0, jax_cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jax_tf.apply(params, tokens, jax_cfg)
    got, _ = transformer.apply(port, _t(tokens), cfg, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("tied", [False, True])
def test_apply_logits_match_jax(tied):
    jax_cfg = jax_tf.TINY.scaled(dtype=jnp.float32, tied_embeddings=tied)
    params = jax_tf.init(jax.random.PRNGKey(1), jax_cfg)
    tokens = np.random.default_rng(2).integers(
        0, jax_cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = jax_tf.apply(params, tokens, jax_cfg)
    cfg = _port_config(jax_cfg)
    got, aux = transformer.apply(bridge.to_torch(params, cfg, device="cpu"),
                                 _t(tokens), cfg, device="cpu")
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_apply_at_small_widths_one_layer():
    jax_cfg = jax_tf.SMALL.scaled(dtype=jnp.float32, num_layers=1)
    params = jax_tf.init(jax.random.PRNGKey(3), jax_cfg)
    tokens = np.random.default_rng(4).integers(
        0, jax_cfg.vocab_size, (1, 12)).astype(np.int32)
    want, _ = jax_tf.apply(params, tokens, jax_cfg)
    cfg = _port_config(jax_cfg)
    assert (cfg.vocab_size, cfg.dim, cfg.num_heads) == (32000, 768, 12)
    got, _ = transformer.apply(bridge.to_torch(params, cfg, device="cpu"),
                               _t(tokens), cfg, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("tied", [False, True])
def test_bridge_round_trip(tied):
    jax_cfg = jax_tf.TINY.scaled(tied_embeddings=tied, num_layers=2)
    params = jax.tree_util.tree_map(
        np.asarray, jax_tf.init(jax.random.PRNGKey(5), jax_cfg))
    cfg = _port_config(jax_cfg)
    port = bridge.to_torch(params, cfg, device="cpu")
    assert len(port["layers"]) == 2 and ("head" in port) == (not tied)
    back = bridge.to_numpy(port)
    flat_a, tree_a = jax.tree_util.tree_flatten(params)
    flat_b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_port_init_shapes_and_scales():
    cfg = transformer.TINY.scaled(dtype=torch.float32)
    params = bridge.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    jax_shapes = jax.tree_util.tree_map(
        np.shape, jax_tf.init(jax.random.PRNGKey(0), jax_tf.TINY))
    port_shapes = jax.tree_util.tree_map(np.shape, bridge.to_numpy(params))
    assert port_shapes == jax_shapes
    wq = params["layers"][0]["att"]["q"]["kernel"]
    assert float(wq.abs().max()) <= 2.0 / np.sqrt(cfg.dim) + 1e-6
    assert abs(float(params["embed"]["table"].std()) - 0.02) < 0.002
