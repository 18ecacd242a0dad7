"""The window under a mesh (``train.make_multi_step(mesh=...)``) on 2 gloo
ranks, held to the JAX package's window without a mesh on the same
weights and global batches, and to the port's own eager steps under the
mesh (CPU, CloudLM TINY f32 at 2 layers).

Every arm runs in one ``run_ranks`` call (one JAX-free process a rank):
a window of K=2 over a super-batch of this rank's rows of two global
batches (``shard_batch(..., stacked=True)``), from weights cut by
``bridge.to_train_shard``.  Held to JAX's ``make_multi_step`` on the
global super-batch: the window's loss within 1e-4 relative, every other
metric within 1e-5 of max(1, |v|), the gathered parameters within 1e-5 of
their leaf's largest magnitude.  Held to the port's eager steps under the
same mesh, run slot by slot from a copy of the state: the parameter
shards and the window's metric means equal bit for bit.

Arms: ``{dp: 2}``; ``{fsdp: 2}`` with ``accum_steps=2`` (micro-batch i is
every data rank's local micro-batch i); ``{tp: 2}``; ``{sp: 2}`` zig-zag;
``{pp: 2}`` (rules ``layers -> pp``); ``{ep: 2}`` on the MoE (4 experts,
top 2); a stochastic window under ``{dp: 2}`` (the key's chain after the
window is JAX's); ``skip_nonfinite`` with a NaN in rank 1's rows of slot
1 (every rank skips that slot); ``valid=[1, 0]``; and masks that differ
between the ranks, which raise ``ValueError`` on both (no hang) and leave
the ranks in step for the next window.  The window under the mesh runs no
CUDA graph (``captures == 0``).  Compile-ahead of the window under
``{tp: 2}`` warms it up on a worker over axis groups of its own while the
main thread runs steps under the same mesh.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from cloud_tpu.models import moe as jax_moe
from cloud_tpu.models import transformer as jax_tf
from cloud_tpu.training import train as jax_train
from helpers.torch_port import model_inputs, run_ranks
from helpers.torch_sigterm import sigterm_restored  # noqa: F401

K = 2
SEQ = 32

_RANKS = """
import dataclasses
import functools
from cloud_tpu_torch import bridge
from cloud_tpu_torch import random as random_lib
from cloud_tpu_torch.bridge import leaves
from cloud_tpu_torch.models import transformer
from cloud_tpu_torch.parallel import pipeline, sharding
from cloud_tpu_torch.training import optimizers, train


def tree(prefix):
    out = {}
    for key, value in IN.items():
        if key.startswith(prefix + "/"):
            node = out
            parts = key[len(prefix) + 1:].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = value
    return out


def model(prefix):
    fields = json.loads(str(IN[prefix + ".config"]))
    if fields.get("moe") is not None:
        from cloud_tpu_torch.models.moe import MoeConfig
        fields["moe"] = MoeConfig(**fields["moe"])
    return transformer.TransformerConfig(dtype=torch.float32, remat=False,
                                         **fields), tree(prefix)


PP_RULES = sharding.DEFAULT_RULES.extended(layers="pp")


def rows_of(mesh, cfg, rules, n):
    if transformer._is_pipelined(cfg, rules, mesh):
        return pipeline.microbatch_rows(
            mesh, n, transformer.num_microbatches(cfg, mesh))
    index = mesh.axis_index("dp") * mesh.axis_size("fsdp") + \\
        mesh.axis_index("fsdp")
    per = n // (mesh.axis_size("dp") * mesh.axis_size("fsdp"))
    return np.arange(index * per, (index + 1) * per)


def arm(name, sizes, prefix="params", rules=None, fields=None,
        mask="loss_mask", valid=None, stochastic=False, **kw):
    cfg, params = model(prefix)
    cfg = dataclasses.replace(cfg, **(fields or {}))
    mesh = MeshSpec(sizes).build(devices=["cpu"] * WORLD)
    axes = transformer.param_logical_axes(cfg)
    tx = optimizers.sgd(0.1, momentum=0.9)

    def state():
        shard, _ = bridge.to_train_shard(params, cfg, mesh, rules)
        key = random_lib.as_key(IN["key"]) if stochastic else None
        return train.TrainState(step=torch.zeros((), dtype=torch.int32),
                                params=shard, opt_state=tx.init(shard),
                                rng=key)

    if stochastic:  # CloudLM's loss draws nothing: the chain is the test
        loss = train.mesh_loss(lambda p, b, rng: transformer.loss_fn(
            p, b, cfg, mesh=mesh, rules=rules))
    else:
        loss = functools.partial(transformer.loss_fn, config=cfg, mesh=mesh,
                                 rules=rules)
    opts = dict(mesh=mesh, logical_axes=axes, rules=rules,
                stochastic=stochastic, **kw)
    rows = rows_of(mesh, cfg, rules, IN["tokens"].shape[1])
    local = {"tokens": IN["tokens"][:, rows], "loss_mask": IN[mask][:, rows]}
    sb = train.shard_batch(local, mesh, stacked=True)
    window = train.make_multi_step(loss, tx, steps_per_dispatch=K, **opts)
    v = None if valid is None else np.asarray(valid, np.float32)
    got, metrics = window(state(), sb, v)
    # The port's eager steps under the same mesh, slot by slot.
    step = train.make_train_step(loss, tx, **opts)
    eager, per_step = state(), []
    run = range(K) if v is None else np.flatnonzero(v > 0)
    for i in run:
        eager, m = step(eager, {k: x[i] for k, x in sb.items()})
        per_step.append(m)
    sums = {k: torch.stack([m[k].float() for m in per_step]).sum(0)
            for k in per_step[0]}
    n = float(max(np.float32(len(run)), np.float32(1.0)))
    same = (int(got.step) == int(eager.step) and all(
        torch.equal(a, b) for a, b in
        zip(leaves(got.params) + leaves(got.opt_state),
            leaves(eager.params) + leaves(eager.opt_state))))
    if stochastic:
        same = same and torch.equal(got.rng, eager.rng)
    OUT[name] = {
        "metrics": {k: float(x) for k, x in metrics.items()},
        # NaN where the other has NaN (the poisoned slot's loss).
        "bitwise": same and all(
            torch.equal(torch.isnan(metrics[k]), torch.isnan(sums[k]))
            and torch.equal(metrics[k].nan_to_num(0.0),
                            (sums[k] / n).nan_to_num(0.0)) for k in sums),
        "step": int(got.step), "captures": window.captures,
        "rng": None if got.rng is None else got.rng.tolist(),
    }
    whole = bridge.from_train_shard(got.params, cfg, mesh, rules)
    if RANK == 0:
        flat = {}

        def walk(node, prefix):
            if isinstance(node, dict):
                for k, x in node.items():
                    walk(x, prefix + "/" + k)
            else:
                flat[prefix.lstrip("/")] = np.asarray(node)

        walk(whole, "")
        np.savez(f"{OUTDIR}/{name}.npz", **flat)
    return window, state, sb


arm("dp", {"dp": 2})
arm("fsdp accum", {"fsdp": 2}, accum_steps=2)
arm("tp", {"tp": 2})
arm("sp zigzag", {"sp": 2}, fields={"zigzag_sp": True})
arm("pp", {"pp": 2}, rules=PP_RULES)
arm("moe ep", {"ep": 2}, prefix="moe")
arm("stochastic", {"dp": 2}, stochastic=True)
arm("nonfinite", {"dp": 2}, mask="nan_mask", skip_nonfinite=True)
window, state, sb = arm("tail", {"dp": 2}, valid=[1, 0])
# Masks that differ between the ranks: ValueError on both, no step runs,
# and the next window pairs its collectives as before.
try:
    window(state(), sb, np.asarray([1, RANK == 0], np.float32))
    OUT["mask"] = "ran"
except ValueError as exc:
    OUT["mask"] = str(exc)
again, _ = window(state(), sb, np.asarray([1, 0], np.float32))
OUT["after mask"] = int(again.step)

# Compile-ahead of the window under {tp: 2} with remat: the worker warms
# one step body up over groups of its own while this thread runs eager
# steps under the same mesh, then the artifact serves the window.
from cloud_tpu_torch.parallel import mesh as mesh_lib
from cloud_tpu_torch.training import compile_cache
cfg, params = model("params")
cfg = dataclasses.replace(cfg, remat=True)
tp = MeshSpec({"tp": 2}).build(devices=["cpu"] * WORLD)
axes = transformer.param_logical_axes(cfg)
tx = optimizers.sgd(0.1, momentum=0.9)
loss = functools.partial(transformer.loss_fn, config=cfg, mesh=tp)


def tp_state():
    shard, _ = bridge.to_train_shard(params, cfg, tp)
    return train.TrainState(step=torch.zeros((), dtype=torch.int32),
                            params=shard, opt_state=tx.init(shard))


sb = train.shard_batch({"tokens": IN["tokens"],
                        "loss_mask": IN["loss_mask"]}, tp, stacked=True)
window = train.make_multi_step(loss, tx, steps_per_dispatch=K, mesh=tp,
                               logical_axes=axes)
aot = compile_cache.AotStep(window, "multi_step")
plan = compile_cache.start_compile_ahead(
    [(aot, (tp_state(), compile_cache.abstract_batch(
        sb, mesh=tp, stacked=True),
        compile_cache.TensorSpec((K,), torch.float32)),
      compile_cache.context_key(mesh=tp, donation=(0,),
                                steps_per_dispatch=K))],
    device="cpu", mesh=tp)
step = train.make_train_step(loss, tx, mesh=tp, logical_axes=axes)
eager = tp_state()
for i in range(K):
    eager, _ = step(eager, {k: x[i] for k, x in sb.items()})
plan.wait()
got, _ = aot(tp_state(), sb, np.ones((K,), np.float32))
OUT["ahead"] = {
    "error": repr(plan.error), "served": aot.compiled is not None,
    "own groups": mesh_lib.worker_mesh(tp).group("tp") is not tp.group("tp"),
    "bitwise": all(torch.equal(a, b) for a, b in
                   zip(leaves(got.params), leaves(eager.params))),
    "captures": window.captures}
"""


@functools.lru_cache(maxsize=None)
def _models():
    """Prefix -> (JAX config, numpy params): CloudLM TINY f32 at 2 layers
    and its MoE (4 experts, top 2), from PRNGKey(0)."""
    base = jax_tf.TINY.scaled(dtype=jnp.float32, num_layers=2)
    cfgs = {"params": base,
            "moe": base.scaled(moe=jax_moe.MoeConfig(num_experts=4,
                                                     top_k=2))}
    return {name: (cfg, jax.tree_util.tree_map(
        np.asarray, jax_tf.init(jax.random.PRNGKey(0), cfg)))
        for name, cfg in cfgs.items()}


def _super_batch():
    """Two global batches of 4 x 32 random tokens (the data ranks' mask
    counts differ), and the twin whose slot 1 has a NaN in rank 1's
    rows."""
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 256, (K, 4, SEQ)).astype(np.int32)
    keep = np.array([[.9], [.9], [.4], [.4]])
    loss_mask = (rng.random((K, 4, SEQ)) < keep).astype(np.float32)
    nan_mask = loss_mask.copy()
    nan_mask[1, 3, 5] = np.nan
    return {"tokens": tokens, "loss_mask": loss_mask}, nan_mask


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("window")
    batch, nan_mask = _super_batch()
    files = {**batch, "nan_mask": nan_mask,
             "key": np.asarray(jax.random.PRNGKey(7))}
    for name, (cfg, params) in _models().items():
        files.update(model_inputs(cfg, params, prefix=name))
    outs = run_ranks(f"import json\nK = {K}\nOUTDIR = {str(tmp)!r}\n"
                     + _RANKS, 2, files=files, timeout=300)
    return tmp, outs


def _jax_window(prefix, batch, *, valid=None, stochastic=False, **kw):
    """JAX's window without a mesh: (metrics, params after, rng after)."""
    cfg, params = _models()[prefix]
    tx = optax.sgd(0.1, momentum=0.9)
    loss = functools.partial(jax_tf.loss_fn, config=cfg)
    if stochastic:
        loss = lambda p, b, rng: jax_tf.loss_fn(p, b, cfg)  # noqa: E731
    window = jax_train.make_multi_step(loss, tx, steps_per_dispatch=K,
                                       stochastic=stochastic, **kw)
    state = jax_train.create_sharded_state(
        jax.random.PRNGKey(0),
        lambda _: jax.tree_util.tree_map(jnp.asarray, params), tx, None,
        train_rng=jax.random.PRNGKey(7) if stochastic else None)
    args = [{k: jnp.asarray(v) for k, v in batch.items()}]
    if valid is not None:
        args.append(jnp.asarray(valid, jnp.float32))
    state, metrics = window(state, *args)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(state.params)[0]}
    return ({k: float(v) for k, v in metrics.items()}, flat,
            None if state.rng is None else np.asarray(state.rng))


#: arm -> (model prefix, JAX window options, how the global batch reads)
ARMS = {
    "dp": ("params", {}, None),
    "fsdp accum": ("params", {"accum_steps": 2}, "interleave"),
    "tp": ("params", {}, None),
    "sp zigzag": ("params", {}, None),
    "pp": ("params", {}, None),
    "moe ep": ("moe", {}, None),
    "stochastic": ("params", {"stochastic": True}, None),
    "nonfinite": ("params", {"skip_nonfinite": True}, "nan"),
    "tail": ("params", {"valid": [1.0, 0.0]}, None),
}


def _close(got, want, scale):
    if np.isnan(want):
        return np.isnan(got)
    return abs(got - want) <= scale


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_window_under_a_mesh_equals_jax_and_eager_steps(ranks, arm):
    tmp, outs = ranks
    prefix, kw, reads = ARMS[arm]
    batch, nan_mask = _super_batch()
    if reads == "interleave":
        # Micro-batch i is both data ranks' local micro-batch i.
        batch = {k: v[:, [0, 2, 1, 3]] for k, v in batch.items()}
    elif reads == "nan":
        batch = dict(batch, loss_mask=nan_mask)
    want_m, want_p, want_rng = _jax_window(prefix, batch, **kw)
    with np.load(tmp / f"{arm}.npz") as saved:
        got_p = {k: saved[k] for k in saved.files}
    assert set(got_p) == set(want_p)
    for leaf, value in want_p.items():
        err = np.abs(got_p[leaf] - value).max()
        assert err <= 1e-5 * max(np.abs(value).max(), 1e-30), (arm, leaf, err)
    for out in outs:
        got = out[arm]
        assert got["bitwise"], (arm, "the window against eager mesh steps")
        assert got["captures"] == 0
        assert got["step"] == (1 if arm == "tail" else K)
        assert set(got["metrics"]) == set(want_m), arm
        for key, want in want_m.items():
            scale = (1e-4 * abs(want) if key == "loss"
                     else 1e-5 * max(1.0, abs(want)))
            assert _close(got["metrics"][key], want, scale), (
                arm, key, got["metrics"][key], want)
        if arm == "stochastic":
            np.testing.assert_array_equal(
                np.asarray(got["rng"], np.uint32), want_rng)
    if arm == "nonfinite":
        assert all(out[arm]["metrics"]["nonfinite"] == 0.5 for out in outs)


def test_compile_ahead_warms_on_groups_of_its_own(ranks):
    """``start_compile_ahead`` of the window under ``{tp: 2}`` (remat on)
    on every rank: the worker's warm-up step runs over a second set of
    axis groups while the main thread runs two eager steps under the same
    mesh; no error, and the artifact's window equals those steps bit for
    bit."""
    _, outs = ranks
    for out in outs:
        assert out["ahead"] == {"error": "None", "served": True,
                                "own groups": True, "bitwise": True,
                                "captures": 0}


def test_masks_that_differ_raise_on_every_rank(ranks):
    """Rank 0 given ``[1, 1]`` and rank 1 ``[1, 0]``: both raise
    ``ValueError`` naming their own mask and the mesh's min and max, and
    the next window (``[1, 0]`` on both) runs."""
    _, outs = ranks
    for rank, out in enumerate(outs):
        mine = [1.0, 1.0] if rank == 0 else [1.0, 0.0]
        assert "valid differs between the ranks" in out["mask"]
        assert f"this rank's {mine}" in out["mask"]
        assert "min [1.0, 0.0] and max [1.0, 1.0]" in out["mask"]
        assert out["after mask"] == 1


def test_routes_are_the_threads_own():
    """``parallel.mesh.route`` sends one thread's collectives over a mesh
    through the worker mesh's groups and installs the mesh as that
    thread's global mesh; other threads, and the thread after the block,
    see the mesh's own groups.  ``keep_route`` carries the route to a
    function run later on another thread (a remat body that autograd's
    thread recomputes)."""
    import threading

    import torch

    from cloud_tpu_torch.parallel import MeshSpec
    from cloud_tpu_torch.parallel import mesh as mesh_lib

    spec = MeshSpec({"tp": 2})
    mesh = mesh_lib.Mesh(spec=spec, devices=(torch.device("cpu"),) * 2,
                         rank=0, coords={a: 0 for a in
                                         mesh_lib.CANONICAL_AXES},
                         backend="gloo", groups={"tp": "main"},
                         group_ranks={"tp": (0, 1)})
    side = mesh_lib.Mesh(spec=spec, devices=mesh.devices, rank=0,
                         coords=mesh.coords, backend="gloo",
                         groups={"tp": "worker"}, group_ranks={"tp": (0, 1)})
    seen = {}

    def other():
        seen["other"] = (mesh.group("tp"), mesh_lib.get_global_mesh())

    with mesh_lib.route(mesh, side):
        assert mesh.group("tp") == "worker" and side.group("tp") == "worker"
        assert mesh_lib.routed(mesh) is side
        assert mesh_lib.get_global_mesh() is mesh
        kept = mesh_lib.keep_route(
            lambda: (mesh.group("tp"), mesh_lib.routed(mesh)))
        thread = threading.Thread(target=other)
        thread.start()
        thread.join()
    assert seen["other"] == ("main", None)
    assert mesh.group("tp") == "main" and mesh_lib.routed(mesh) is mesh
    box = {}
    thread = threading.Thread(target=lambda: box.setdefault("v", kept()))
    thread.start()
    thread.join()
    assert box["v"] == ("worker", side)
    assert mesh.group("tp") == "main"
    plain = object()
    assert mesh_lib.keep_route(plain) is plain  # no route on this thread
