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


# ---------------------------------------------------------------------------
# The kernels' layout (``_plan``) and their order of summation
# ---------------------------------------------------------------------------

import chip_smoke  # noqa: E402  (gn_calls: every GroupNorm call of a step)

_STEP_SHAPES = sorted({s for batch, hw in ((256, 32), (128, 224))
                       for s, _, _ in chip_smoke.gn_calls(batch, hw)})


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_plan_covers_every_row_once(dtype, backward):
    """Every GroupNorm shape of a ResNet-50 step at CIFAR b256 and at 224
    b128: the CTAs of a sample own disjoint row ranges that cover HW, each
    keeps at most its rows in shared memory, and shared memory and the
    cluster stay within the card's limits."""
    item = port_gn._ITEMSIZE[dtype]
    for shape in _STEP_SHAPES:
        b, h, w, c = shape
        hw, g = h * w, min(32, c)
        plan = port_gn._plan(shape, dtype, 32, backward)
        assert plan.vec == 16 // item, shape  # C is a multiple of 8
        assert 1 <= plan.cluster <= port_gn.MAX_CLUSTER == 8, shape
        owned = [range(k * plan.rows, min((k + 1) * plan.rows, hw))
                 for k in range(plan.cluster)]
        rows = [r for rng in owned for r in rng]
        assert rows == list(range(hw)), shape
        assert all(len(rng) > 0 for rng in owned), shape
        assert 0 <= plan.cached <= plan.rows
        assert plan.threads in (128, 256, 512)
        row_bytes = c * item * (2 if backward else 1)
        fixed = port_gn._fixed_smem(c, g, plan.threads, plan.vec,
                                    plan.cluster)
        assert plan.smem == fixed + plan.cached * row_bytes
        assert plan.smem <= port_gn.SMEM_MAX == 232448
        if plan.cached < plan.rows:  # only a sample too large for 8 CTAs
            assert plan.cluster == port_gn.MAX_CLUSTER, shape


def test_plan_takes_the_scalar_route():
    """Channels that are not a multiple of 16 bytes, or a misaligned
    pointer: one element a load, nothing kept in shared memory."""
    for dtype in (torch.bfloat16, torch.float32):
        for plan in (port_gn._plan((4, 5, 5, 30), dtype, 6),
                     port_gn._plan((4, 5, 5, 30), dtype, 6, True),
                     port_gn._plan((4, 8, 8, 64), dtype, 32, aligned=False)):
            assert plan.vec == 1 and plan.cached == 0
    assert port_gn._plan((4, 5, 5, 36), torch.float32, 6).vec == 4


def _emulate(x, scale, bias, res, dy, g, eps, relu):
    """The kernels' order of summation in plain PyTorch (f32): per-CTA
    shifted partials over ``_plan``'s row ranges, added in rank order; the
    group fold; and the backward's per-sample ds/db summed over B in
    eight slices, each in order, then the slices in order
    (``gn_bwd_sum``).  Returns (y, dx, ds, db, dres)."""
    b, h, w, c = x.shape
    hw, cpg = h * w, c // g
    n = float(hw * cpg)

    def ranks(plan):
        return [slice(k * plan.rows, (k + 1) * plan.rows)
                for k in range(plan.cluster)]

    def groups(v):
        return v.reshape(b, g, cpg).sum(-1).repeat_interleave(cpg, -1)

    x2 = x.reshape(b, hw, c)
    res2 = None if res is None else res.reshape(b, hw, c)
    piv = x2[:, 0, :]
    s1 = s2 = torch.zeros((b, c))
    for rng in ranks(port_gn._plan(tuple(x.shape), x.dtype, g)):
        v = x2[:, rng] - piv[:, None]
        s1, s2 = s1 + v.sum(1), s2 + (v * v).sum(1)
    m = groups(s1 + hw * piv) / n
    d = m - piv
    r = torch.rsqrt(torch.clamp_min(groups(s2 - 2 * d * s1 + hw * d * d) / n,
                                    0.0) + eps)
    m, r = m[:, None], r[:, None]
    pre = (x2 - m) * r * scale + bias
    if res2 is not None:
        pre = pre + res2
    y = torch.clamp_min(pre, 0.0) if relu else pre
    dy2 = dy.reshape(b, hw, c)
    if relu:
        dy2 = torch.where(pre > 0.0, dy2, 0.0)
    xhat = (x2 - m) * r
    db_b = ds_b = torch.zeros((b, c))
    for rng in ranks(port_gn._plan(tuple(x.shape), x.dtype, g, True)):
        db_b = db_b + dy2[:, rng].sum(1)
        ds_b = ds_b + (dy2[:, rng] * xhat[:, rng]).sum(1)
    a_g, b_g = groups(scale * db_b)[:, None], groups(scale * ds_b)[:, None]
    dx = r * (dy2 * scale - (a_g + xhat * b_g) / n)
    per = -(-b // 8)
    sums = []
    for part in (ds_b, db_b):
        total = torch.zeros(c)
        for k in range(8):
            acc = torch.zeros(c)
            for i in range(k * per, min((k + 1) * per, b)):
                acc = acc + part[i]
            total = total + acc
        sums.append(total)
    return (y.reshape(x.shape), dx.reshape(x.shape), sums[0], sums[1],
            None if res is None else dy2.reshape(x.shape))


@pytest.mark.parametrize("case", [
    ((2, 8, 8, 64), 32, 1e3, True, True),   # the stem's C/G = 2, mean 1e3
    ((3, 6, 6, 32), 8, 0.0, False, True),
    ((9, 8, 4, 16), 4, 0.0, True, False),   # B > 8: two samples a slice
], ids=["cg2-mean1e3-res-relu", "cg4-relu", "b9-res"])
def test_kernel_summation_order_matches_jax(case):
    """The emulated kernel order against the JAX package's group_norm (its
    Pallas kernels in interpret mode, or its reference where they do not
    apply) and ``jax.grad`` through it: y within 1e-5 (1e-4 at mean 1e3,
    as test_large_mean_small_std), dx, ds, db and dres within 1e-5 of their
    largest magnitude."""
    shape, g, mean, residual, relu = case
    h, w, c = shape[1:]
    rng = np.random.default_rng(sum(shape))
    x = (mean + rng.standard_normal(shape)).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    res = rng.standard_normal(shape).astype(np.float32) if residual else None
    cot = rng.standard_normal(shape).astype(np.float32)
    assert port_gn._plan(shape, torch.float32, g).cluster > 1
    f = _jax_fn(g, relu, residual)
    jres = jnp.asarray(res) if residual else jnp.zeros(())
    want_y = np.asarray(f(x, scale, bias, jres))
    argnums = (0, 1, 2, 3) if residual else (0, 1, 2)
    want = jax.grad(lambda *a: jnp.sum(f(*a) * cot), argnums=argnums)(
        x, scale, bias, jres)
    y, dx, ds, db, dres = _emulate(
        *(None if a is None else torch.from_numpy(a)
          for a in (x, scale, bias, res, cot)), g, 1e-5, relu)
    np.testing.assert_allclose(y.numpy(), want_y,
                               atol=1e-4 if mean else ATOL, rtol=0)
    got = [dx, ds, db] + ([dres] if residual else [])
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=ATOL * float(np.max(np.abs(b))),
                                   rtol=0)


def test_both_routes_return_summed_scale_and_bias_grads():
    """The plain K3/K4 return ds, db as [C] (summed over B), as the kernel
    does, and the autograd Function passes them through unsummed."""
    x, scale, bias, res, cot = _inputs((4, 2, 16, 4), residual=True, seed=8)
    xt, st, bt, rt, dyt = (torch.from_numpy(a) for a in (x, scale, bias,
                                                         res, cot))
    _, mean, rstd = port_gn._fwd_plain(xt, st, bt, rt, 4, 1e-5, True)
    dx, ds, db, dres = port_gn._bwd_plain(xt, dyt, mean, rstd, st, bt, rt,
                                          4, True)
    assert ds.shape == db.shape == (16,)
    assert dx.shape == dres.shape == xt.shape

    marks = (torch.arange(16.0), -torch.arange(16.0))

    def fake_bwd(x, dy, mean, rstd, scale, bias, residual, g, relu):
        return torch.zeros_like(x), marks[0], marks[1], None

    orig = port_gn._by_device
    port_gn._by_device = lambda x, plain, kernel: (
        fake_bwd if plain is port_gn._bwd_plain else plain)
    try:
        y, inputs = _port(x, scale, bias, None, 4, True)
        _, got_ds, got_db = torch.autograd.grad(y, inputs, dyt)
    finally:
        port_gn._by_device = orig
    assert torch.equal(got_ds, marks[0]) and torch.equal(got_db, marks[1])
