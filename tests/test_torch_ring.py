"""The port's ring attention against the JAX package's, on the CPU.

* ``zigzag_indices`` (both directions) equals JAX's, and so does its
  error.
* On 2 and 4 gloo ranks (JAX-free processes, ``helpers.torch_port.
  run_ranks``), ``ring_attention`` contiguous (causal and not, with and
  without a key mask) and ``ring_attention_balanced`` (zig-zag): each
  rank's output block and its q/k/v gradients (``torch.autograd.grad``
  through the ring's explicit backward) against JAX's ring under
  ``shard_map`` on the same inputs (the jnp reference per block, 8
  virtual CPU devices) and against dense attention.  Values within 1e-5;
  gradients within 1e-5 of their largest magnitude.  The masked causal
  case empties whole blocks' rows (a left padding longer than a block):
  those rows get a zero cotangent, as the loss mask drops them, and their
  dq is exactly 0 (ROADMAP C1's contract).
* ``sharded_attention``'s routing: Ulysses when the local head group
  divides by ``sp``, the ring when it does not (the JAX package's
  fallback), a padding mask with the zig-zag layout raises; and
  ``ulysses_eligible`` equals JAX's on a grid of meshes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from cloud_tpu.models import layers as jax_layers
from cloud_tpu.parallel import ring_attention as jax_ring
from cloud_tpu_torch.models import layers
from cloud_tpu_torch.ops import flash_attention as flash_lib
from cloud_tpu_torch.parallel import ring_attention as ring
from helpers.torch_port import run_ranks

torch.set_num_threads(1)

B, T, H, D = 2, 16, 2, 8
#: Keys 0..PAD-1 of batch row 0 are padding: longer than a 4-rank block,
#: so the causal ring's first block has no valid key for any of its rows.
PAD = 6
#: (name, causal, zigzag, masked)
CASES = (("causal", True, False, False), ("full", False, False, False),
         ("causal masked", True, False, True),
         ("full masked", False, False, True),
         ("zigzag", True, True, False))


@pytest.mark.parametrize("t,n", [(16, 2), (16, 4), (24, 3), (8, 1), (10, 2)])
def test_zigzag_indices_match_jax(t, n):
    for inverse in (False, True):
        try:
            want = np.asarray(jax_ring.zigzag_indices(t, n, inverse=inverse))
        except ValueError as exc:
            with pytest.raises(ValueError, match="divisible by 2"):
                ring.zigzag_indices(t, n, inverse=inverse)
            assert "divisible by 2" in str(exc)
            return
        got = ring.zigzag_indices(t, n, inverse=inverse).numpy()
        np.testing.assert_array_equal(got, want)


def _inputs():
    rng = np.random.default_rng(0)
    q, k, v, g = (rng.normal(size=(B, T, H, D)).astype(np.float32)
                  for _ in range(4))
    mask = np.ones((B, T), np.int32)
    mask[0, :PAD] = 0
    return q, k, v, g, mask


def _valid_rows(causal, masked):
    """[B, T] rows that attend to at least one valid key."""
    valid = np.ones((B, T), bool)
    if causal and masked:
        valid[0, :PAD] = False
    return valid


def _jax_ring(n, causal, zigzag, masked, q, k, v, g, mask):
    """JAX's ring under shard_map over n devices: (out, dq, dk, dv) in
    the layout given (zig-zag order for the balanced ring)."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("sp",))
    spec = P(None, "sp")
    if zigzag:
        fn = functools.partial(jax_ring.ring_attention_balanced, axis="sp",
                               use_pallas=False)
        specs = (spec,) * 3
    elif masked:
        def fn(q_, k_, v_, m_):
            return jax_ring.ring_attention(q_, k_, v_, "sp", causal=causal,
                                           mask=m_, use_pallas=False)
        specs = (spec,) * 4
    else:
        fn = functools.partial(jax_ring.ring_attention, axis="sp",
                               causal=causal, use_pallas=False)
        specs = (spec,) * 3
    mapped = jax.shard_map(fn, mesh=mesh, in_specs=specs, out_specs=spec,
                           check_vma=False)
    extra = (jnp.asarray(mask),) if masked and not zigzag else ()

    # One compiled program: shard_map run op by op took ~20 s a case.
    @jax.jit
    def run(a, b, c, cot):
        out, vjp = jax.vjp(lambda a_, b_, c_: mapped(a_, b_, c_, *extra),
                           a, b, c)
        return (out,) + tuple(vjp(cot))

    return tuple(np.asarray(x) for x in run(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(g)))


def _dense(causal, masked, q, k, v, g, mask):
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out, _ = flash_lib._reference_with_lse(
        qt, kt, vt, causal=causal,
        mask=torch.tensor(mask) if masked else None)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.tensor(g))
    return (out.detach().numpy(),) + tuple(x.numpy() for x in grads)


_RING_RANKS = """
from cloud_tpu_torch.parallel import ring_attention as ring
mesh = MeshSpec({"sp": WORLD}).build(devices=["cpu"] * WORLD)
tl = IN["q"].shape[1] // WORLD
block = slice(RANK * tl, (RANK + 1) * tl)
for name, causal, zigzag, masked in CASES:
    perm = (ring.zigzag_indices(IN["q"].shape[1], WORLD).numpy() if zigzag
            else np.arange(IN["q"].shape[1]))
    q, k, v = (torch.tensor(IN[x][:, perm][:, block], requires_grad=True)
               for x in ("q", "k", "v"))
    g = torch.tensor(IN["g_" + name][:, perm][:, block])
    if zigzag:
        out = ring.ring_attention_balanced(q, k, v, mesh=mesh)
    else:
        mask = torch.tensor(IN["mask"][:, block]) if masked else None
        out = ring.ring_attention(q, k, v, causal=causal, mask=mask,
                                  mesh=mesh)
    grads = torch.autograd.grad(out, (q, k, v), g)
    OUT[name] = [x.detach().numpy().tolist() for x in (out,) + grads]
"""


@pytest.mark.parametrize("n", [2, 4])
def test_ring_matches_jax_ring_and_dense(n):
    q, k, v, g, mask = _inputs()
    files = {"q": q, "k": k, "v": v, "mask": mask}
    for name, causal, _, masked in CASES:
        valid = _valid_rows(causal, masked)
        files["g_" + name] = g * valid[..., None, None]
    outs = run_ranks(f"CASES = {CASES!r}\n" + _RING_RANKS, n, files=files)
    tl = T // n
    for name, causal, zigzag, masked in CASES:
        valid = _valid_rows(causal, masked)
        gz = files["g_" + name]
        perm = (np.asarray(jax_ring.zigzag_indices(T, n)) if zigzag
                else np.arange(T))
        # The port's blocks, assembled in the layout the ring ran in.
        got = [np.concatenate([np.asarray(o[name][i]) for o in outs], 1)
               for i in range(4)]
        want = _jax_ring(n, causal, zigzag, masked, q[:, perm], k[:, perm],
                         v[:, perm], gz[:, perm], mask)
        dense = _dense(causal, masked, q, k, v, gz, mask)
        rows = valid[:, perm][..., None, None]
        for i, what in enumerate(("out", "dq", "dk", "dv")):
            scale = 1.0 if i == 0 else max(1e-30, np.abs(want[i]).max())
            a, b = got[i], want[i]
            if i < 2:  # row-wise values: garbage rows are the loss's to drop
                a, b = a * rows, b * rows
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale,
                                       err_msg=f"{name} n={n} {what} vs JAX")
            d = dense[i][:, perm] * (rows if i < 2 else 1)
            np.testing.assert_allclose(a, d, rtol=0, atol=1e-5 * scale,
                                       err_msg=f"{name} n={n} {what} vs dense")
        if causal and masked:
            empty = ~valid[:, perm]
            if tl <= PAD:  # a whole block of rows without a valid key
                assert empty.reshape(B, n, tl).all(-1).any()
            assert np.all(got[1][empty] == 0.0), "C1: dq not 0 on empty rows"


class _Shape:
    """A mesh stand-in with both packages' size accessors."""

    def __init__(self, sizes):
        self.shape = sizes

    def axis_size(self, axis):
        return self.shape.get(axis, 1)


@pytest.mark.parametrize("heads", [4, 6, 12])
@pytest.mark.parametrize("sizes", [{}, {"sp": 2}, {"sp": 4}, {"sp": 8},
                                   {"sp": 2, "tp": 2}, {"sp": 4, "tp": 2},
                                   {"sp": 3, "tp": 2}])
def test_ulysses_eligible_matches_jax(heads, sizes):
    mesh = _Shape(sizes) if sizes else None
    assert layers.ulysses_eligible(heads, mesh) == \
        jax_layers.ulysses_eligible(heads, mesh)


_ROUTING_RANKS = """
from cloud_tpu_torch.models import layers
from cloud_tpu_torch.ops import flash_attention as flash_lib
from cloud_tpu_torch.parallel import autograd as ag
from cloud_tpu_torch.parallel import ring_attention as ring
calls = []
for mod, name in ((ag, "seq_to_heads"), (ring, "ring_attention"),
                  (ring, "ring_attention_balanced")):
    real = getattr(mod, name)
    def wrapped(*a, _real=real, _name=name, **kw):
        calls.append(_name)
        return _real(*a, **kw)
    setattr(mod, name, wrapped)
mesh = MeshSpec({"sp": 2}).build(devices=["cpu"] * 2)
rng = np.random.default_rng(1)
full = [torch.tensor(rng.normal(size=(2, 16, 4, 8)).astype(np.float32))
        for _ in range(3)]
blocks = [x[:, RANK * 8:(RANK + 1) * 8] for x in full]
want = flash_lib.flash_attention(*full, causal=True)
want = want[:, RANK * 8:(RANK + 1) * 8]
for heads, zigzag in ((4, False), (3, False), (4, True)):
    del calls[:]
    q, k, v = (b[:, :, :heads] for b in blocks)
    out = layers.sharded_attention(q, k, v, causal=True, mesh=mesh,
                                   ulysses=not zigzag, zigzag=zigzag)
    if zigzag:
        OUT["zigzag route"] = list(calls)
        continue
    OUT[f"{heads} route"] = list(calls)
    OUT[f"{heads} err"] = float((out - want[:, :, :heads]).abs().max())
try:
    layers.sharded_attention(*blocks, causal=True, mesh=mesh, zigzag=True,
                             mask=torch.ones(2, 8, dtype=torch.int32))
except ValueError as exc:
    OUT["zigzag mask"] = str(exc)
OUT["no mesh"] = float((layers.sharded_attention(*full, causal=True)
                        - flash_lib.flash_attention(*full, causal=True)
                        ).abs().max())
"""


def test_sharded_attention_routing():
    """Ulysses when eligible (4 heads over sp 2), the ring when not (3
    heads), the zig-zag ring without Ulysses; a mask with the zig-zag
    layout raises JAX's error; no mesh is the direct kernel call."""
    outs = run_ranks(_ROUTING_RANKS, 2)
    for out in outs:
        assert out["4 route"] == ["seq_to_heads"]
        assert out["3 route"] == ["ring_attention"]
        assert out["zigzag route"] == ["ring_attention_balanced"]
        assert out["4 err"] < 1e-5 and out["3 err"] < 1e-5
        assert "padding masks are unsupported with zigzag_sp" in \
            out["zigzag mask"]
        assert out["no mesh"] == 0.0
