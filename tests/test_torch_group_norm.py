"""The port's GroupNorm against the JAX package's Pallas kernels, on the CPU.

On CPU tensors the port's ``group_norm`` runs the plain versions of
K1-K4 inside its ``autograd.Function``.  These are held against JAX
``group_norm(..., use_pallas=True, interpret=True, partitioned=False)``
on the same numpy inputs: the forward against K1/K2 in interpret mode, and
``dx``, ``dscale``, ``dbias`` and ``dres`` against ``jax.grad`` through
K3/K4.  (At HW = 1 and HW = 4 the JAX package takes its jnp reference,
whose ``[HW, C]`` view does not meet the TPU's sublane rule; the port's
function is the same.)  f32, atol 1e-5, gradients relative to their
largest magnitude.  The CUDA kernels are held against these plain
versions on the card by ``chip_smoke.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu_torch.ops import group_norm as port_gn

jax_gn = importlib.import_module("cloud_tpu.ops.group_norm")

torch.set_num_threads(2)

ATOL = 1e-5

#: (H, W, C, G): kernel-eligible shapes, the two small CIFAR stages' HW
#: (4 and 1) and a group count above the channel count (G = min(G, C)).
SHAPES = [(4, 4, 32, 8), (8, 4, 16, 4), (2, 2, 64, 32), (1, 1, 32, 8),
          (2, 4, 8, 16)]


def _inputs(shape, *, residual, seed, mean=0.0):
    h, w, c, _ = shape
    rng = np.random.default_rng(seed)
    x = (mean + rng.standard_normal((2, h, w, c))).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    res = (rng.standard_normal((2, h, w, c)).astype(np.float32)
           if residual else None)
    cot = rng.standard_normal((2, h, w, c)).astype(np.float32)
    return x, scale, bias, res, cot


def _jax_fn(g, relu, has_res):
    def f(x, scale, bias, res):
        return jax_gn.group_norm(
            x, scale, bias, num_groups=g, use_pallas=True, interpret=True,
            partitioned=False, activation="relu" if relu else None,
            residual=res if has_res else None)
    return f


def _port(x, scale, bias, res, g, relu):
    tensors = [torch.from_numpy(a).requires_grad_(True)
               for a in (x, scale, bias)]
    res_t = None if res is None else torch.from_numpy(res).requires_grad_(
        True)
    y = port_gn.group_norm(*tensors, num_groups=g,
                           activation="relu" if relu else None,
                           residual=res_t)
    return y, tensors + ([res_t] if res_t is not None else [])


def _close_rel(got, want):
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, atol=ATOL * scale, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("residual", [False, True], ids=["plain", "res"])
@pytest.mark.parametrize("relu", [False, True], ids=["id", "relu"])
def test_forward_and_grads_match_jax_kernels(shape, residual, relu):
    g = shape[3]
    x, scale, bias, res, cot = _inputs(shape, residual=residual,
                                       seed=sum(shape))
    f = _jax_fn(g, relu, residual)
    jres = jnp.asarray(res) if residual else jnp.zeros(())
    want = f(x, scale, bias, jres)

    y, inputs = _port(x, scale, bias, res, g, relu)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)

    argnums = (0, 1, 2, 3) if residual else (0, 1, 2)
    want_grads = jax.grad(
        lambda *a: jnp.sum(f(*a) * cot), argnums=argnums)(
            x, scale, bias, jres)
    got_grads = torch.autograd.grad(y, inputs, torch.from_numpy(cot))
    for got, want_g in zip(got_grads, want_grads):
        _close_rel(got.numpy(), np.asarray(want_g))


@pytest.mark.parametrize("relu", [False, True], ids=["id", "relu"])
def test_large_mean_small_std(relu):
    """|mean| >> std: the shifted moments keep the variance exact."""
    shape = (4, 4, 32, 8)
    x, scale, bias, res, cot = _inputs(shape, residual=True, seed=3,
                                       mean=1e3)
    f = _jax_fn(8, relu, True)
    want = f(x, scale, bias, jnp.asarray(res))
    y, inputs = _port(x, scale, bias, res, 8, relu)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=0)
    # Normalised output, not swamped: a naive E[x^2] - E[x]^2 at mean 1e3
    # in f32 loses the variance entirely.
    assert float(y.detach().std()) > 0.5
    want_grads = jax.grad(lambda *a: jnp.sum(f(*a) * cot),
                          argnums=(0, 1, 2, 3))(x, scale, bias,
                                                jnp.asarray(res))
    got_grads = torch.autograd.grad(y, inputs, torch.from_numpy(cot))
    for got, want_g in zip(got_grads, want_grads):
        _close_rel(got.numpy(), np.asarray(want_g))


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "res"])
@pytest.mark.parametrize("relu", [False, True], ids=["id", "relu"])
def test_plain_versions_match_reference(residual, relu):
    """The custom backward (plain K3/K4) equals autograd through the
    differentiable ``_reference``, and the plain forward equals it."""
    x, scale, bias, res, cot = _inputs((4, 2, 16, 4), residual=residual,
                                       seed=11)
    y, inputs = _port(x, scale, bias, res, 4, relu)
    ref_inputs = [t.detach().clone().requires_grad_(True) for t in inputs]
    ref = port_gn._reference(
        *ref_inputs[:3], 4, relu=relu,
        residual=ref_inputs[3] if residual else None)
    np.testing.assert_allclose(y.detach().numpy(), ref.detach().numpy(),
                               atol=ATOL, rtol=0)
    cot_t = torch.from_numpy(cot)
    got = torch.autograd.grad(y, inputs, cot_t)
    want = torch.autograd.grad(ref, ref_inputs, cot_t)
    for a, b in zip(got, want):
        _close_rel(a.numpy(), b.numpy())


@pytest.mark.parametrize("relu", [False, True], ids=["id", "relu"])
def test_residual_saved_only_with_relu(relu):
    x, scale, bias, res, _ = _inputs((2, 2, 8, 4), residual=True, seed=5)
    res_t = torch.from_numpy(res).requires_grad_(True)
    y = port_gn.group_norm(torch.from_numpy(x).requires_grad_(True),
                           torch.from_numpy(scale), torch.from_numpy(bias),
                           num_groups=4, residual=res_t,
                           activation="relu" if relu else None)
    saved = [t for t in y.grad_fn.saved_tensors if t is not None]
    holds_res = any(t.data_ptr() == res_t.data_ptr() for t in saved)
    assert holds_res == relu
    # Without relu the residual's cotangent is dy itself.
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    (dres,) = torch.autograd.grad(y, [res_t], dy)
    if not relu:
        assert torch.equal(dres, dy)


def test_launch_counters_stay_at_zero_on_cpu():
    from cloud_tpu_torch.ops import dispatch

    names = ("gn_fwd", "gn_fwd_res", "gn_bwd", "gn_bwd_res")
    dispatch.reset_launch_counts()
    x, scale, bias, res, cot = _inputs((2, 2, 8, 4), residual=True, seed=2)
    y, inputs = _port(x, scale, bias, res, 4, True)
    torch.autograd.grad(y, inputs, torch.from_numpy(cot))
    assert dispatch.launch_counts(names) == dict.fromkeys(names, 0)
    with pytest.raises(KeyError):
        dispatch.launch_counts(["group_norm"])


def test_bad_arguments_raise():
    x = torch.zeros((1, 2, 2, 6))
    s, b = torch.ones(6), torch.zeros(6)
    with pytest.raises(ValueError, match="activation"):
        port_gn.group_norm(x, s, b, num_groups=3, activation="gelu")
    with pytest.raises(ValueError, match="residual shape"):
        port_gn.group_norm(x, s, b, num_groups=3,
                           residual=torch.zeros((1, 2, 2, 3)))
    with pytest.raises(ValueError, match="divide"):
        port_gn.group_norm(x, s, b, num_groups=4)
    with pytest.raises(ValueError, match="NHWC"):
        port_gn.group_norm(torch.zeros((2, 6)), s, b, num_groups=3)
    with pytest.raises(ValueError, match="unsupported device"):
        port_gn.group_norm(x.to("meta"), s.to("meta"), b.to("meta"),
                           num_groups=3)
