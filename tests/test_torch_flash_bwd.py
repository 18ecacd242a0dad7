"""The port's flash-attention backward against the JAX package's, on the CPU.

``_bwd_reference`` (the plain version of K6/K7, on whole score
matrices) is held against the JAX backward kernels ``_bwd_pallas`` in
interpret mode on the same q, k, v, dO, out and lse, in f32 at atol 1e-5
of the largest reference magnitude: causal and not, with and without a
padded-tail key mask, with and without an lse cotangent, and a sample
whose keys are all masked (the kernels' p = exp(NEG_INF - lse) = 1 there);
the port's side of those cases runs in a child process without JAX.
``torch.autograd.grad`` through the port's ``flash_attention`` and
``flash_attention_with_lse`` is held against ``jax.grad`` through the JAX
entry points with the interpret-mode kernels, as ``tests/unit/test_ops.py``
holds the kernels against the reference.  The CUDA kernels themselves
are held against ``_bwd_reference`` on the card by ``chip_smoke.py``.
"""

import importlib
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu_torch.ops import dispatch
from cloud_tpu_torch.ops import flash_attention as port_flash

jax_flash = importlib.import_module("cloud_tpu.ops.flash_attention")

REPO = pathlib.Path(__file__).resolve().parents[1]

torch.set_num_threads(2)

B, H, T, D = 2, 2, 64, 16
BLOCK_Q, BLOCK_K = 32, 16


def _inputs(seed, *, mask_kind, t=T):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, t, H, D)).astype(np.float32)
                   for _ in range(4))
    mask = None
    if mask_kind == "tail":  # right padding, every row keeps a valid key
        mask = np.ones((B, t), np.int32)
        mask[1, (2 * t) // 3:] = 0
    elif mask_kind == "empty":  # one sample with no valid key at all
        mask = np.ones((B, t), np.int32)
        mask[0, :] = 0
        mask[1, t // 2:] = 0
    g_lse = rng.standard_normal((B, H, t)).astype(np.float32)
    return q, k, v, do, mask, g_lse


def _bhtd(x):
    return jnp.asarray(x.transpose(0, 2, 1, 3))


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()),
                               err_msg=what)


KERNEL_CASES = [(mask_kind, causal, use_glse)
                for mask_kind, causal in ((None, True), ("tail", True),
                                          (None, False), ("tail", False),
                                          ("empty", False))
                for use_glse in (False, True)]

# The port's side of every case, in a process that never imports JAX: with
# JAX's runtime in the same process and the host under load, the CPU
# products of ``_bwd_reference`` came out off by ~1e-4 in the first
# sample's rows now and then, on bit-identical inputs.
_PORT_SIDE = """
import sys
import numpy as np, torch
torch.set_num_threads(2)
from cloud_tpu_torch.ops.flash_attention import _bwd_reference
data = dict(np.load(sys.argv[1]))
out = {}
for i in range(int(data["n"])):
    t = {n: torch.from_numpy(data[f"{i}_{n}"]) for n in
         ("q", "k", "v", "do", "out", "lse", "mask", "g_lse")}
    got = _bwd_reference(
        t["q"], t["k"], t["v"], t["mask"] if data[f"{i}_use_mask"] else None,
        t["do"], t["out"], t["lse"], causal=bool(data[f"{i}_causal"]),
        g_lse=t["g_lse"] if data[f"{i}_use_glse"] else None)
    for name, a in zip(("dq", "dk", "dv"), got):
        out[f"{i}_{name}"] = a.numpy()
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def kernel_cases(tmp_path_factory):
    """For every case of :data:`KERNEL_CASES`, ``(got, want)``: the port's
    ``_bwd_reference`` and the JAX interpret-mode backward kernels on the
    same q, k, v, dO, out and lse, [B, T, H, D] numpy (dq, dk, dv)."""
    inputs, wants = {"n": len(KERNEL_CASES)}, []
    for i, (mask_kind, causal, use_glse) in enumerate(KERNEL_CASES):
        q, k, v, do, mask, g_lse = _inputs(7, mask_kind=mask_kind)
        jmask = None if mask is None else jnp.asarray(mask)
        out, lse = jax_flash._fwd_pallas(
            _bhtd(q), _bhtd(k), _bhtd(v), jmask, causal=causal,
            block_q=BLOCK_Q, block_k=BLOCK_K, interpret=True)
        want = jax_flash._bwd_pallas(
            _bhtd(q), _bhtd(k), _bhtd(v), jmask, _bhtd(do), out, lse,
            causal=causal, block_q=BLOCK_Q, block_k=BLOCK_K, interpret=True,
            g_lse=jnp.asarray(g_lse)[..., None] if use_glse else None)
        wants.append([np.asarray(b).transpose(0, 2, 1, 3) for b in want])
        inputs.update({
            f"{i}_q": q, f"{i}_k": k, f"{i}_v": v, f"{i}_do": do,
            f"{i}_out": np.asarray(out).transpose(0, 2, 1, 3),
            f"{i}_lse": np.asarray(lse)[..., 0],
            f"{i}_mask": np.ones((B, T), np.int32) if mask is None else mask,
            f"{i}_g_lse": g_lse, f"{i}_use_mask": mask is not None,
            f"{i}_causal": causal, f"{i}_use_glse": use_glse})
    tmp = tmp_path_factory.mktemp("flash_bwd")
    np.savez(tmp / "in.npz", **inputs)
    proc = subprocess.run(
        [sys.executable, "-c", _PORT_SIDE, str(tmp / "in.npz"),
         str(tmp / "got.npz")], cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(tmp / "got.npz") as got:
        return [([got[f"{i}_{n}"] for n in ("dq", "dk", "dv")], want)
                for i, want in enumerate(wants)]


@pytest.mark.parametrize("mask_kind,causal,use_glse", KERNEL_CASES)
def test_bwd_reference_matches_interpret_kernels(kernel_cases, mask_kind,
                                                 causal, use_glse):
    got, want = kernel_cases[KERNEL_CASES.index((mask_kind, causal,
                                                 use_glse))]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close(a, b, name)


def _port_grads(fn, q, k, v, mask, causal, with_lse):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    tmask = None if mask is None else torch.from_numpy(mask)
    if with_lse:
        out, lse = fn(*leaves, causal=causal, mask=tmask)
        loss = (out ** 2).mean() + 0.3 * torch.sin(lse).mean()
    else:
        loss = (fn(*leaves, causal=causal, mask=tmask) ** 2).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _jax_grads(fn, q, k, v, mask, causal, with_lse):
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        if with_lse:
            out, lse = fn(q, k, v, causal=causal, mask=jmask,
                          block_q=BLOCK_Q, block_k=BLOCK_K, use_pallas=True,
                          interpret=True)
            return jnp.mean(out ** 2) + 0.3 * jnp.mean(jnp.sin(lse))
        out = fn(q, k, v, causal=causal, mask=jmask, block_q=BLOCK_Q,
                 block_k=BLOCK_K, use_pallas=True, interpret=True)
        return jnp.sum(out ** 2)

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("mask_kind,causal", [
    (None, True), ("tail", True), ("tail", False)])
def test_autograd_matches_jax_grad_through_kernels(mask_kind, causal,
                                                   with_lse):
    q, k, v, _, mask, _ = _inputs(11, mask_kind=mask_kind)
    name = "flash_attention_with_lse" if with_lse else "flash_attention"
    got = _port_grads(getattr(port_flash, name), q, k, v, mask, causal,
                      with_lse)
    want = _jax_grads(getattr(jax_flash, name), q, k, v, mask, causal,
                      with_lse)
    for label, a, b in zip("qkv", got, want):
        _close(a, b, f"d{label}")


def test_ragged_t_autograd_matches_jax_reference_grad():
    """T = 37 has no kernel tiling in the JAX package; its reference's
    autodiff is the oracle (every row keeps a valid key)."""
    q, k, v, _, mask, _ = _inputs(13, mask_kind="tail", t=37)
    got = _port_grads(port_flash.flash_attention, q, k, v, mask, True,
                      False)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jax_flash._reference(
            q, k, v, causal=True, mask=jnp.asarray(mask)) ** 2),
        argnums=(0, 1, 2))(q, k, v)
    for label, a, b in zip("qkv", got, want):
        _close(a, b, f"d{label}")


def test_cpu_path_launches_no_kernel_and_no_grad_builds_no_graph():
    dispatch.reset_launch_counts()
    q, k, v, _, mask, _ = _inputs(3, mask_kind="tail")
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = port_flash.flash_attention(*leaves, mask=torch.from_numpy(mask))
    torch.autograd.grad(out.sum(), leaves)
    with torch.no_grad():
        assert not port_flash.flash_attention(*leaves).requires_grad
    assert all(n == 0 for n in dispatch.launch_counts().values())
