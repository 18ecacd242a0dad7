"""The port's weight-only int8 quantization against the JAX package's, on the CPU.

``quantize_array`` must be bit-identical to JAX's (int8 values and f32
scales, half-to-even rounding, all-zero channels, the non-finite refusal);
``quantize_params`` on TINY at 4 and at 2 layers must quantize exactly the
leaves JAX quantizes (eligibility is decided on the stacked ``[L, ...]``
size) with identical leaves, carried across by ``bridge``;
``dequantize_params`` and ``param_bytes`` agree with JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import quantization as jax_quant
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import quantization
from helpers.torch_port import tiny_models

torch.set_num_threads(1)


def _crafted():
    """Half-way values at scale 1 (amax 127 in channel 0), an all-zero
    channel, and random values."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    w[:, 0] = [127.0, 2.5, -3.5, 0.5, -1.5, 126.5]
    w[:, 1] = 0.0
    return w


@pytest.mark.parametrize("axis", [-2, -1])
def test_quantize_array_bit_identical(axis):
    w = _crafted()
    q, scale = quantization.quantize_array(torch.from_numpy(w), axis=axis)
    jq, jscale = jax_quant.quantize_array(jnp.asarray(w), axis=axis)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    if axis == -2:
        # Half-to-even at scale 1: 2.5 -> 2, -3.5 -> -4, 0.5 -> 0,
        # -1.5 -> -2, 126.5 -> 126; the zero channel keeps scale 1.
        assert q[:, 0].tolist() == [127, 2, -4, 0, -2, 126]
        assert float(scale[0, 0]) == 1.0 and float(scale[0, 1]) == 1.0
        assert q[:, 1].tolist() == [0] * 6


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_quantize_array_refuses_non_finite(bad):
    w = _crafted()
    w[2, 3] = bad
    with pytest.raises(ValueError, match="non-finite"):
        jax_quant.quantize_array(jnp.asarray(w), axis=-2)
    with pytest.raises(ValueError, match="non-finite"):
        quantization.quantize_array(torch.from_numpy(w), axis=-2)
    # The unchecked form (the KV cache's, on the decode path) never reads
    # the device and does not raise.
    quantization.quantize_unchecked(torch.from_numpy(w), axis=-2)


def _leaf_dict(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


@pytest.mark.parametrize("num_layers", [4, 2])
def test_quantize_params_matches_jax(num_layers):
    """At 2 layers q/k/v/out hold 2 x 64 x 64 = 8192 stacked elements and
    stay full precision in JAX, while wi/wg/wo (2 x 64 x 128) are
    quantized; a rule on the port's per-layer leaves would keep those in
    full precision too: only the stacked size gives JAX's tree."""
    _, params, cfg, tparams = tiny_models(seed=0, num_layers=num_layers)
    want = _leaf_dict(jax_quant.quantize_params(params))
    got_tree = quantization.quantize_params(tparams)
    got = _leaf_dict(bridge.to_numpy(got_tree))
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert got[name].dtype == leaf.dtype, name
        np.testing.assert_array_equal(got[name], leaf, err_msg=name)
    att = got_tree["layers"][0]["att"]["q"]
    if num_layers == 2:
        assert set(att) == {"kernel"}
    else:
        assert set(att) == {"kernel_q", "kernel_scale"}
        assert att["kernel_scale"].shape == (1, cfg.num_heads * cfg.head_dim)
    assert set(got_tree["layers"][0]["mlp"]["wi"]) == {"kernel_q",
                                                        "kernel_scale"}
    assert got_tree["embed"]["table_scale"].shape == (cfg.vocab_size, 1)
    # The JAX tree crosses the bridge with the same leaves (int8 kept).
    via = bridge.to_torch(jax_quant.quantize_params(params), cfg,
                          device="cpu")
    assert via["layers"][0]["mlp"]["wo"]["kernel_q"].dtype == torch.int8
    assert _leaf_dict(bridge.to_numpy(via)).keys() == want.keys()


def test_dequantize_and_param_bytes_match_jax():
    _, params, _, tparams = tiny_models(seed=2, num_layers=4)
    jq = jax_quant.quantize_params(params)
    q = quantization.quantize_params(tparams)
    assert quantization.param_bytes(q) == jax_quant.param_bytes(jq)
    assert quantization.param_bytes(tparams) == jax_quant.param_bytes(params)
    assert quantization.param_bytes(q) < quantization.param_bytes(
        tparams) / 3
    want = _leaf_dict(jax_quant.dequantize_params(jq))
    got = _leaf_dict(bridge.to_numpy(quantization.dequantize_params(q)))
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        np.testing.assert_array_equal(got[name], leaf, err_msg=name)
    # A "_q" leaf without its scale passes through, as in JAX.
    odd = {"weight_q": torch.ones(3)}
    assert quantization.dequantize_params(odd)["weight_q"] is odd["weight_q"]
