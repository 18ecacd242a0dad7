"""The port's GPipe pipeline (``cloud_tpu_torch/parallel/pipeline.py``)
held to the JAX package's (CPU, f32).

* **The schedule** on the JAX tests' toy layer and carry (``tanh(x @ w +
  b)``, ``acc + sum(x)``; ``tests/unit/test_pipeline.py``) at pp 2 and 4
  with M = pp and 2 pp microbatches, as gloo ranks (one JAX-free process
  each, ``helpers.torch_port.run_ranks``): every stage's outputs, its
  layers' gradients and the microbatches' cotangent of ``sum(y * y) +
  sum(acc)`` against JAX's ``_sequential`` and ``jax.grad`` of it on the
  same numpy inputs (rtol 1e-5 values; gradients rtol 1e-4 with an atol
  of 1e-6 of the array's largest magnitude, the JAX tests' limits scaled
  to the array: the input cotangent reaches ~30), and against the
  port's own ``_sequential``.
* **The errors**: a layer count pp does not divide, a batch
  ``num_microbatches`` does not divide and ``zigzag_sp`` under a
  pipeline raise JAX's messages; inference
  (``generate``, ``beam_search``) refuses a pipelined or zig-zag mesh
  with JAX's messages.
* **microbatch_rows** against the rows GSPMD gives each data rank of
  JAX's ``[M, b/M]`` reshape on 8 virtual devices.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cloud_tpu import parallel as jax_parallel
from cloud_tpu.models import generation as jax_generation
from cloud_tpu.models import transformer as jax_tf
from cloud_tpu.parallel import pipeline as jax_pipeline
from helpers.torch_port import run_ranks

torch.set_num_threads(1)

LAYERS, DIM, MB = 8, 16, 4
#: (pp, microbatch counts) of each spawn.
SCHEDULES = ((2, (2, 4)), (4, (4, 8)))


def _toy_layer(p, carry):
    x, acc = carry
    return jnp.tanh(x @ p["w"] + p["b"]), acc + jnp.sum(x)


def _toy_inputs(m):
    rng = np.random.default_rng(m)
    w = (rng.normal(size=(LAYERS, DIM, DIM)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(LAYERS, DIM)) * 0.1).astype(np.float32)
    x = rng.normal(size=(m, MB, DIM)).astype(np.float32)
    return w, b, x


def _jax_reference(m):
    """JAX's ``_sequential`` on the toy stack: outputs, and the gradients
    of sum(y*y) + sum(acc) in the params and the microbatches."""
    w, b, x = _toy_inputs(m)
    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}

    def loss(pr, xs):
        y, a = jax_pipeline._sequential(_toy_layer, pr,
                                        (xs, jnp.zeros((m,))))
        return jnp.sum(y * y) + jnp.sum(a), (y, a)

    (_, (y, a)), (g, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    return {"y": np.asarray(y), "a": np.asarray(a), "gw": np.asarray(g["w"]),
            "gb": np.asarray(g["b"]), "gx": np.asarray(gx)}


_SCHEDULE = """
from cloud_tpu_torch.parallel import pipeline

def toy_layer(p, carry):
    x, acc = carry
    return torch.tanh(x @ p["w"] + p["b"]), acc + x.sum()

def run(fn, layers, x, m):
    x = x.clone().requires_grad_(True)
    y, a = fn(toy_layer, layers, (x, torch.zeros((m,))))
    loss = (y * y).sum() + a.sum()
    grads = torch.autograd.grad(loss, [x] + [t for l in layers
                                             for t in (l["w"], l["b"])])
    return y, a, grads[0], grads[1::2], grads[2::2]

pp = WORLD
mesh = MeshSpec({"pp": pp}).build(devices=["cpu"] * pp)
start, stop = pipeline.stage_bounds(IN["w0"].shape[0], mesh)
OUT["bounds"] = [start, stop]
for m in IN["ms"].tolist():
    w, b, x = (torch.from_numpy(IN[f"{k}{m}"]) for k in "wbx")
    layers = [{"w": w[i].clone().requires_grad_(True),
               "b": b[i].clone().requires_grad_(True)}
              for i in range(start, stop)]
    y, a, gx, gw, gb = run(functools.partial(pipeline.pipeline, mesh=mesh),
                           layers, x, m)
    OUT[f"m{m}"] = {"y": y.tolist(), "a": a.tolist(), "gx": gx.tolist(),
                    "gw": [g.tolist() for g in gw],
                    "gb": [g.tolist() for g in gb]}
    whole = [{"w": w[i].clone().requires_grad_(True),
              "b": b[i].clone().requires_grad_(True)}
             for i in range(w.shape[0])]
    y, a, gx, gw, gb = run(pipeline._sequential, whole, x, m)
    OUT[f"seq{m}"] = {"y": y.tolist(), "a": a.tolist(), "gx": gx.tolist(),
                      "gw": [g.tolist() for g in gw],
                      "gb": [g.tolist() for g in gb]}
    with torch.no_grad():  # the forward schedule alone keeps no graph
        y, a = pipeline.pipeline(toy_layer, layers,
                                 (x, torch.zeros((m,))), mesh=mesh)
    OUT[f"nograd{m}"] = [y.tolist(), a.tolist()]
"""


@pytest.fixture(scope="module")
def schedules():
    out = {}
    for pp, ms in SCHEDULES:
        files = {"ms": np.asarray(ms)}
        for m in ms:
            w, b, x = _toy_inputs(m)
            files.update({f"w{m}": w, f"b{m}": b, f"x{m}": x})
        files["w0"] = files[f"w{ms[0]}"]
        out[pp] = run_ranks("import functools\n" + _SCHEDULE, pp,
                            files=files)
    return out


@pytest.mark.parametrize("pp,m", [(pp, m) for pp, ms in SCHEDULES
                                  for m in ms])
def test_schedule_matches_jax_sequential(schedules, pp, m):
    """Every stage returns every microbatch's output (the last stage's,
    broadcast); each stage's layer gradients are the block of JAX's
    whole-stack gradients its layers own; every stage gets the same
    microbatch cotangent."""
    want = _jax_reference(m)
    per = LAYERS // pp
    for rank, out in enumerate(schedules[pp]):
        assert out["bounds"] == [rank * per, (rank + 1) * per]
        for key in (f"m{m}", f"seq{m}"):
            got = out[key]
            rows = (slice(rank * per, (rank + 1) * per) if key[0] == "m"
                    else slice(None))
            np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
            np.testing.assert_allclose(got["a"], want["a"], rtol=1e-5,
                                       atol=1e-5, err_msg=key)
            for g in ("gx", "gw", "gb"):
                ref = want[g] if g == "gx" else want[g][rows]
                np.testing.assert_allclose(
                    got[g], ref, rtol=1e-4,
                    atol=1e-6 * max(1.0, np.abs(want[g]).max()),
                    err_msg=f"{key} {g}")
        y, a = out[f"nograd{m}"]
        np.testing.assert_allclose(y, want["y"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a, want["a"], rtol=1e-5, atol=1e-5)


def _fake_mesh(sizes, coords=None):
    """A built-looking mesh with no process groups: enough for what
    raises, or computes, before any collective."""
    from cloud_tpu_torch.parallel import MeshSpec
    from cloud_tpu_torch.parallel.mesh import CANONICAL_AXES, Mesh

    spec = MeshSpec(sizes)
    coords = {a: (coords or {}).get(a, 0) for a in CANONICAL_AXES}
    return Mesh(spec=spec, devices=(torch.device("cpu"),) * spec.num_devices,
                rank=0, coords=coords, backend="gloo", groups={},
                group_ranks={})


def _message(call):
    with pytest.raises(ValueError) as got:
        call()
    return str(got.value)


def test_layer_count_must_divide_pp():
    """JAX's message, from ``stage_bounds`` and from cutting a CloudLM's
    layer list over pp (``sharding.shard_tree`` of a LayerStack)."""
    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import transformer
    from cloud_tpu_torch.parallel import pipeline, sharding

    w, b, _ = _toy_inputs(2)
    jmesh = jax_parallel.MeshSpec({"pp": 2, "dp": 4}).build()
    want = _message(lambda: jax_pipeline.pipeline(
        _toy_layer, {"w": jnp.asarray(w[:3]), "b": jnp.asarray(b[:3])},
        (jnp.zeros((2, 4, DIM)), jnp.zeros((2,))), mesh=jmesh))
    mesh = _fake_mesh({"pp": 2, "dp": 4})
    assert _message(lambda: pipeline.stage_bounds(3, mesh)) == want
    cfg = transformer.TINY.scaled(dtype=torch.float32, num_layers=3)
    params = bridge.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    rules = sharding.DEFAULT_RULES.extended(layers="pp")
    assert _message(lambda: sharding.shard_tree(
        params, transformer.param_logical_axes(cfg), mesh, rules)) == want


def test_batch_must_divide_num_microbatches():
    """JAX's message for a global batch of 8 and num_microbatches=3 on
    {pp: 2, fsdp: 4}; the port's rank holds its 2 rows."""
    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import transformer
    from cloud_tpu_torch.parallel import sharding

    jcfg = jax_tf.TINY.scaled(num_microbatches=3)
    jparams = jax_tf.init(jax.random.PRNGKey(0), jcfg)
    jmesh = jax_parallel.MeshSpec({"pp": 2, "fsdp": 4}).build()
    jrules = jax_parallel.DEFAULT_RULES.extended(layers="pp")
    tokens = np.zeros((8, 32), np.int32)
    with jax_parallel.use_mesh(jmesh):
        want = _message(lambda: jax.jit(functools.partial(
            jax_tf.loss_fn, config=jcfg, rules=jrules, mesh=jmesh))(
                jparams, {"tokens": tokens}))
    cfg = transformer.TINY.scaled(dtype=torch.float32, num_microbatches=3)
    params = bridge.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    rules = sharding.DEFAULT_RULES.extended(layers="pp")
    got = _message(lambda: transformer.loss_fn(
        params, {"tokens": tokens[:2]}, cfg,
        mesh=_fake_mesh({"pp": 2, "fsdp": 4}), rules=rules))
    assert got == want and "num_microbatches" in got


def test_zigzag_with_a_pipeline_raises_as_jax_does():
    """``zigzag_sp`` on a pipelined {pp: 2, sp: 2} mesh: JAX's message."""
    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import transformer
    from cloud_tpu_torch.parallel import sharding

    jcfg = jax_tf.TINY.scaled(zigzag_sp=True)
    jparams = jax_tf.init(jax.random.PRNGKey(0), jcfg)
    jmesh = jax_parallel.MeshSpec({"pp": 2, "sp": 2}).build(
        jax.devices()[:4])
    jrules = jax_parallel.DEFAULT_RULES.extended(layers="pp")
    tokens = np.zeros((4, 32), np.int32)
    with jax_parallel.use_mesh(jmesh):
        want = _message(lambda: jax.jit(functools.partial(
            jax_tf.loss_fn, config=jcfg, rules=jrules, mesh=jmesh))(
                jparams, {"tokens": tokens}))
    cfg = transformer.TINY.scaled(dtype=torch.float32, zigzag_sp=True)
    params = bridge.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    got = _message(lambda: transformer.loss_fn(
        params, {"tokens": tokens}, cfg, mesh=_fake_mesh({"pp": 2, "sp": 2}),
        rules=sharding.DEFAULT_RULES.extended(layers="pp")))
    assert got == want and "zigzag" in got


@pytest.mark.parametrize("case", ["generate pp", "beam_search pp",
                                  "generate zigzag"])
def test_inference_refuses_pipelined_and_zigzag_meshes(case):
    """``generate`` and ``beam_search`` refuse a pipelined mesh and a
    zig-zag one with the JAX package's messages."""
    from cloud_tpu_torch.models import generation, transformer
    from cloud_tpu_torch.parallel import sharding

    zigzag = case.endswith("zigzag")
    sizes = {"sp": 4} if zigzag else {"pp": 2, "dp": 4}
    jcfg = jax_tf.TINY.scaled(zigzag_sp=zigzag)
    cfg = transformer.TINY.scaled(zigzag_sp=zigzag)
    jrules = (jax_parallel.DEFAULT_RULES if zigzag
              else jax_parallel.DEFAULT_RULES.extended(layers="pp"))
    rules = (sharding.DEFAULT_RULES if zigzag
             else sharding.DEFAULT_RULES.extended(layers="pp"))
    jmesh = jax_parallel.MeshSpec(sizes).build(
        jax.devices()[:4] if zigzag else None)
    prompt, lens = np.zeros((2, 4), np.int32), np.full((2,), 4, np.int32)
    if case.startswith("beam"):
        want = _message(lambda: jax_generation.beam_search(
            {}, prompt, lens, jcfg, num_beams=2, max_new_tokens=2,
            rules=jrules, mesh=jmesh))
        got = _message(lambda: generation.beam_search(
            {}, prompt, lens, cfg, num_beams=2, max_new_tokens=2,
            rules=rules, mesh=_fake_mesh(sizes), device="cpu"))
    else:
        want = _message(lambda: jax_generation.generate(
            {}, prompt, lens, jcfg, max_new_tokens=2, rules=jrules,
            mesh=jmesh))
        got = _message(lambda: generation.generate(
            {}, prompt, lens, cfg, max_new_tokens=2, rules=rules,
            mesh=_fake_mesh(sizes), device="cpu"))
    assert got == want
    assert ("zigzag" if zigzag else "pp") in got


@pytest.mark.parametrize("m", [1, 2, 4])
def test_microbatch_rows_are_jax_reshape_shards(m):
    """A rank's rows are, microbatch by microbatch, the rows GSPMD puts
    on its data coordinate of JAX's ``x.reshape(M, b/M)`` split over
    (dp, fsdp): on {dp: 2, pp: 2, fsdp: 2} with b = 16."""
    from cloud_tpu_torch.parallel import pipeline

    b = 16
    jmesh = jax_parallel.MeshSpec({"dp": 2, "pp": 2, "fsdp": 2}).build()
    xs = jax.device_put(jnp.arange(b).reshape(m, b // m),
                        NamedSharding(jmesh, P(None, ("dp", "fsdp"))))
    grid = np.asarray(jmesh.devices)
    names = list(jmesh.axis_names)
    for shard in xs.addressable_shards:
        coords = dict(zip(names, (int(c) for c in
                                  np.argwhere(grid == shard.device)[0])))
        mesh = _fake_mesh({"dp": 2, "pp": 2, "fsdp": 2}, coords)
        np.testing.assert_array_equal(
            pipeline.microbatch_rows(mesh, b, m),
            np.asarray(shard.data).reshape(-1))
