"""CloudLM training under a mesh on the port, held to the JAX package's
unsharded step on the same weights and batches (CPU, TINY in f32).

Each mesh runs as gloo ranks, one JAX-free process each
(``helpers.torch_port.run_ranks``); the JAX side runs here.  Weights come
from JAX's ``init`` through ``bridge.to_train_shard``; each rank's
updated shards are gathered back whole (``bridge.from_train_shard``).

* **The dryrun's configs** (``__graft_entry__.dryrun_multichip``): A,
  fsdp 2 x sp 2 x tp 2 with the zig-zag ring (8 ranks); B, dp 2 x pp 2
  x ep 2 over MoE TINY (4 experts, top 2; 8 ranks); C, the same mesh as
  A with Ulysses; D, ``plan_mesh(num_devices=4, worker_count=1)`` (dp 2
  over DCN x fsdp 2) through ``make_hybrid_dp_train_step``.  Each on
  TINY from ``PRNGKey(0)`` (D: ``PRNGKey(1)``) and the dryrun's zero
  batches, one ``sgd(1.0)`` step: the loss on every rank within 1e-5 of
  JAX's unsharded ``loss_fn``, the gradient (the step's update) within
  1e-5 of its largest magnitude, the params within JAX's own tolerance
  (rtol 1e-4, atol 1e-6).  The recorded ``MULTICHIP_r05.json`` losses
  (bf16, AdamW, 8 virtual devices) are printed beside the port's.
* **Each axis alone on 2 ranks**, one step against JAX's: dp, fsdp, tp
  (vocabulary split, remat on and off), sp contiguous, zig-zag and
  Ulysses, and the fused CE under fsdp and under tp with the vocabulary
  whole and split (JAX's plain CE the reference), on a batch whose
  ``loss_mask`` counts differ between the data
  ranks (the loss is JAX's global value, not a mean of local means), with
  ``grad_norm``; ``accum_steps=2`` under dp; ``skip_nonfinite`` with a
  NaN in one rank's rows (every rank skips); AdamW under fsdp held by its
  moments (mu and nu reassembled within 1e-5 relative of optax's);
  ``shard_batch(pad_to=)``; the pipeline (pp 2, a dense and a tied
  head) and the MoE (4 experts, top 2) under ep (and 3 experts, cut
  unevenly), dp, fsdp and tp, with random tokens so the aux is the
  global batch's.
* **The pipeline on 4 ranks**: {pp: 2, tp: 2} and {pp: 2, dp: 2}
  against JAX's unsharded step; the MoE under {pp: 2, dp: 2} with M = 2
  against JAX's own pipelined step on 4 virtual devices (the microbatch
  aux couples each global microbatch's rows); ``skip_nonfinite`` with a
  NaN in one data rank's rows.
* **MNIST through the hybrid step** against the plain step and JAX's
  (``tests/unit/test_parallel.py``'s ``TestHybridDpTrainStep``).
* **What stays refused under a mesh**, each naming its queued ROADMAP
  line, and the record pipeline's default shard by data coordinate.
"""

import dataclasses
import functools
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.models import mnist as jax_mnist
from cloud_tpu.models import transformer as jax_tf
from cloud_tpu.training import train as jax_train
from helpers.torch_port import model_inputs, run_ranks

REPO = pathlib.Path(__file__).resolve().parents[1]

torch.set_num_threads(1)

#: The losses ``dryrun_multichip(8)`` recorded (bf16 TINY, AdamW), by
#: config letter.
RECORDED = dict(re.findall(
    r"config ([A-D]) .*?loss=([0-9.]+)",
    json.loads((REPO / "MULTICHIP_r05.json").read_text())["tail"]))

#: Rebuilds the JAX weights and the config on a rank.
_RANK_MODEL = """
import functools
from cloud_tpu_torch import bridge
from cloud_tpu_torch.bridge import leaves
from cloud_tpu_torch.models import transformer
from cloud_tpu_torch.parallel import sharding
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


def model(prefix="params"):
    fields = json.loads(str(IN[prefix + ".config"]))
    if fields.get("moe") is not None:
        from cloud_tpu_torch.models.moe import MoeConfig
        fields["moe"] = MoeConfig(**fields["moe"])
    return transformer.TransformerConfig(dtype=torch.float32, remat=False,
                                         **fields), tree(prefix)


def data_rows(mesh, n):
    index = mesh.axis_index("dp") * mesh.axis_size("fsdp") + \\
        mesh.axis_index("fsdp")
    per = n // (mesh.axis_size("dp") * mesh.axis_size("fsdp"))
    return slice(index * per, (index + 1) * per)


def batch_rows(mesh, cfg, rules, n):
    \"\"\"The rank's rows: its data slice, or under a pipeline its share of
    every global microbatch.\"\"\"
    if transformer._is_pipelined(cfg, rules, mesh):
        from cloud_tpu_torch.parallel import pipeline
        return pipeline.microbatch_rows(
            mesh, n, transformer.num_microbatches(cfg, mesh))
    return data_rows(mesh, n)


PP_RULES = sharding.DEFAULT_RULES.extended(layers="pp")


def one_step(name, cfg, params, mesh, batch, tx, rules=None, **kw):
    \"\"\"One step of ``tx`` under ``mesh`` from the JAX weights: the
    rank's metrics in OUT[name], the gathered params (and AdamW moments)
    saved by rank 0.\"\"\"
    axes = transformer.param_logical_axes(cfg)
    shard, _ = bridge.to_train_shard(params, cfg, mesh, rules)
    state = train.TrainState(step=torch.zeros((), dtype=torch.int32),
                             params=shard, opt_state=tx.init(shard))
    step = train.make_train_step(
        functools.partial(transformer.loss_fn, config=cfg, mesh=mesh,
                          rules=rules), tx,
        mesh=mesh, logical_axes=axes, rules=rules, **kw)
    rows = batch_rows(mesh, cfg, rules, batch["tokens"].shape[0])
    local = train.shard_batch({k: v[rows] for k, v in batch.items()}, mesh)
    state, metrics = step(state, local)
    OUT[name] = {k: float(v) for k, v in metrics.items()}
    saved = {"params": bridge.from_train_shard(state.params, cfg, mesh,
                                               rules)}
    if "mu" in state.opt_state:
        saved["mu"] = bridge.from_train_shard(state.opt_state["mu"], cfg,
                                              mesh, rules)
        saved["nu"] = bridge.from_train_shard(state.opt_state["nu"], cfg,
                                              mesh, rules)
    if RANK == 0:
        flat = {}
        def walk(node, prefix):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, prefix + "/" + k)
            else:
                flat[prefix] = np.asarray(node)
        walk(saved, "")
        np.savez(f"{OUTDIR}/{name}.npz", **flat)
"""


def _saved(tmp_path, name):
    with np.load(tmp_path / f"{name}.npz") as data:
        return {k.lstrip("/"): data[k] for k in data.files}


def _flat(tree, prefix):
    return {f"{prefix}/{'/'.join(str(getattr(k, 'key', k)) for k in path)}":
            np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_step(cfg, params, batch, tx, **kw):
    """JAX's unsharded step: (metrics, params after, opt_state after)."""
    step = jax_train.make_train_step(
        functools.partial(jax_tf.loss_fn, config=cfg), tx, **kw)
    state = jax_train.create_sharded_state(
        jax.random.PRNGKey(0),
        lambda _: jax.tree_util.tree_map(jnp.asarray, params), tx, None)
    state, metrics = step(state, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree_util.tree_map(np.asarray, state.params),
            state.opt_state)


def _hold(what, got, want_params, start_params, want_metrics, metrics,
          *, grad_norm=True):
    """Loss within 1e-5, gradient (the sgd(1.0) update) within 1e-5 of
    its largest magnitude, params within rtol 1e-4 / atol 1e-6."""
    assert abs(metrics["loss"] - want_metrics["loss"]) <= 1e-5, (
        what, metrics["loss"], want_metrics["loss"])
    if "aux" in metrics:
        assert abs(metrics["aux"] - want_metrics["aux"]) <= 1e-5, (
            what, metrics["aux"], want_metrics["aux"])
    if grad_norm:
        assert abs(metrics["grad_norm"] - want_metrics["grad_norm"]) <= \
            1e-5 * want_metrics["grad_norm"], what
    want = _flat(want_params, "params")
    start = _flat(start_params, "params")
    scale = max(np.abs(start[k] - want[k]).max() for k in want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-6, err_msg=f"{what} {key}")
        np.testing.assert_allclose(start[key] - got[key],
                                   start[key] - want[key], rtol=0,
                                   atol=1e-5 * scale,
                                   err_msg=f"{what} grad {key}")


# ---------------------------------------------------------------------------
# The dryrun's configs A, C (8 ranks) and D (4 ranks)

_DRYRUN_AC = """
cfg, params = model()
mesh = MeshSpec({"fsdp": 2, "sp": 2, "tp": 2}).build(devices=["cpu"] * 8)
batch = {"tokens": IN["tokens"]}
one_step("A", dataclasses.replace(cfg, zigzag_sp=True), params, mesh, batch,
         optimizers.sgd(1.0))
from cloud_tpu_torch.models import layers
assert layers.ulysses_eligible(cfg.num_heads, mesh)
one_step("C", dataclasses.replace(cfg, ulysses_sp=True), params, mesh,
         batch, optimizers.sgd(1.0))
"""


def test_dryrun_configs_a_and_c_on_eight_ranks(tmp_path):
    cfg = jax_tf.TINY.scaled(dtype=jnp.float32)
    params = jax_tf.init(jax.random.PRNGKey(0), cfg)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    # The dryrun's batch: data_par 2 -> 8 rows of 32 zero tokens.
    batch = {"tokens": np.zeros((8, 32), np.int32)}
    want_m, want_p, _ = _jax_step(cfg, np_params, batch, optax.sgd(1.0))
    outs = run_ranks(
        "import dataclasses\n" + f"OUTDIR = {str(tmp_path)!r}\n"
        + _RANK_MODEL + _DRYRUN_AC, 8,
        files={**model_inputs(cfg, np_params), **batch})
    got = {name: _saved(tmp_path, name) for name in "AC"}
    for name in "AC":
        for out in outs:
            _hold(f"config {name}", got[name], want_p, np_params, want_m,
                  out[name])
    print(f"config A: port {outs[0]['A']['loss']:.6f}, JAX unsharded f32 "
          f"{want_m['loss']:.6f}, recorded (bf16 AdamW) "
          f"{RECORDED['A']}; config C: port {outs[0]['C']['loss']:.6f},"
          f" recorded {RECORDED['C']}")


_DRYRUN_D = """
from cloud_tpu_torch.models import mnist
from cloud_tpu_torch.parallel import planner
plan = planner.plan_mesh(num_devices=4, worker_count=1)
assert plan.spec.dcn_sizes == {"dp": 2}, plan.spec
mesh = plan.spec.build(devices=["cpu"] * 4)
cfg, params = model()
OUT["mesh"] = [mesh.axis_size("dp"), mesh.axis_size("fsdp")]
rows = data_rows(mesh, IN["tokens"].shape[0])
state = train.create_sharded_state(
    None, lambda _: bridge.to_torch(params, cfg, device="cpu"),
    optimizers.sgd(1.0), device="cpu")
step = train.make_hybrid_dp_train_step(
    functools.partial(transformer.loss_fn, config=cfg, device="cpu"),
    optimizers.sgd(1.0), mesh=mesh)
state, metrics = step(state, {"tokens": IN["tokens"][rows]})
OUT["D"] = {k: float(v) for k, v in metrics.items()}
OUT["D step"] = int(state.step)
if RANK == 0:
    np.savez(f"{OUTDIR}/D.npz", **{"params/" + k: v for k, v in
             flat_tree(bridge.to_numpy(state.params)).items()})

# MNIST: the hybrid step against the plain step on the whole batch.
mcfg = mnist.MnistConfig(hidden_dim=16)
mparams = tree("mnist")
def mnist_state():
    return train.create_sharded_state(
        None, lambda _: bridge.mnist_to_torch(mparams, device="cpu"),
        optimizers.sgd(0.1), device="cpu")
mloss = functools.partial(mnist.loss_fn, config=mcfg, device="cpu")
mbatch = {"image": IN["image"], "label": IN["label"]}
hybrid, hm = train.make_hybrid_dp_train_step(
    mloss, optimizers.sgd(0.1), mesh=mesh)(
        mnist_state(), {k: v[data_rows(mesh, 16)] for k, v in mbatch.items()})
plain, pm = train.make_train_step(mloss, optimizers.sgd(0.1))(
    mnist_state(), mbatch)
OUT["mnist loss"] = [float(hm["loss"]), float(pm["loss"])]
OUT["mnist err"] = max(float((a - b).abs().max()) for a, b in
                       zip(leaves(hybrid.params), leaves(plain.params)))
if RANK == 0:
    np.savez(f"{OUTDIR}/mnist.npz", **{"params/" + k: v for k, v in
             flat_tree(bridge.mnist_to_numpy(hybrid.params)).items()})
"""

_FLAT_TREE = """
def flat_tree(node, prefix=""):
    out = {}
    for k, v in node.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out
"""


def test_dryrun_config_d_and_mnist_through_the_hybrid_step(tmp_path):
    cfg = jax_tf.TINY.scaled(dtype=jnp.float32)
    np_params = jax.tree_util.tree_map(
        np.asarray, jax_tf.init(jax.random.PRNGKey(1), cfg))
    batch = {"tokens": np.zeros((8, 32), np.int32)}
    want_m, want_p, _ = _jax_step(cfg, np_params, batch, optax.sgd(1.0))
    mcfg = jax_mnist.MnistConfig(hidden_dim=16)
    mparams = jax.tree_util.tree_map(
        np.asarray, jax_mnist.init(jax.random.PRNGKey(0), mcfg))
    rng = np.random.default_rng(0)
    mbatch = {"image": rng.normal(size=(16, 784)).astype(np.float32),
              "label": rng.integers(0, 10, 16)}
    mwant_m, mwant_p, _ = _jax_step_generic(
        functools.partial(jax_mnist.loss_fn, config=mcfg), mparams, mbatch)
    files = {**model_inputs(cfg, np_params), **batch, **mbatch,
             **_flat(mparams, "mnist")}
    outs = run_ranks(f"OUTDIR = {str(tmp_path)!r}\n" + _RANK_MODEL
                     + _FLAT_TREE + _DRYRUN_D, 4, files=files)
    got = _saved(tmp_path, "D")
    for out in outs:
        assert out["mesh"] == [2, 2] and out["D step"] == 1
        _hold("config D", got, want_p, np_params, want_m, out["D"],
              grad_norm=False)
        assert abs(out["mnist loss"][0] - out["mnist loss"][1]) <= 1e-5
        assert abs(out["mnist loss"][0] - mwant_m["loss"]) <= 1e-5
        assert out["mnist err"] <= 1e-6
    mgot = _saved(tmp_path, "mnist")
    for key, want in _flat(mwant_p, "params").items():
        np.testing.assert_allclose(mgot[key], want, rtol=1e-4, atol=1e-6)
    print(f"config D: port {outs[0]['D']['loss']:.6f}, JAX unsharded f32 "
          f"{want_m['loss']:.6f}, recorded (bf16 AdamW) {RECORDED['D']}")


def _jax_step_generic(loss, params, batch):
    step = jax_train.make_train_step(loss, optax.sgd(0.1))
    state = jax_train.create_sharded_state(
        jax.random.PRNGKey(0),
        lambda _: jax.tree_util.tree_map(jnp.asarray, params),
        optax.sgd(0.1), None)
    state, metrics = step(state, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree_util.tree_map(np.asarray, state.params), None)


_CONFIG_B = """
cfg, params = model()
mesh = MeshSpec({"dp": 2, "pp": 2, "ep": 2}).build(devices=["cpu"] * 8)
OUT["mesh"] = {a: mesh.axis_size(a) for a in ("dp", "pp", "ep")}
OUT["layers"] = len(bridge.to_train_shard(params, cfg, mesh, PP_RULES)[0][
    "layers"])
one_step("B", cfg, params, mesh, {"tokens": IN["tokens"]},
         optimizers.sgd(1.0), PP_RULES)
"""


def test_dryrun_config_b_on_eight_ranks(tmp_path):
    """Config B: dp 2 x pp 2 x ep 2, MoE TINY (4 experts, top 2), rules
    ``layers`` -> ``pp``, the dryrun's zero batch of 8 x 32: one
    ``sgd(1.0)`` step held to JAX's unsharded step (on zero tokens every
    row routes alike, so the microbatches' aux is the whole batch's)."""
    from cloud_tpu.models import moe as jax_moe

    cfg = jax_tf.TINY.scaled(dtype=jnp.float32, moe=jax_moe.MoeConfig(
        num_experts=4, top_k=2))
    np_params = jax.tree_util.tree_map(
        np.asarray, jax_tf.init(jax.random.PRNGKey(0), cfg))
    batch = {"tokens": np.zeros((8, 32), np.int32)}
    want_m, want_p, _ = _jax_step(cfg, np_params, batch, optax.sgd(1.0))
    outs = run_ranks(
        "import dataclasses\n" + f"OUTDIR = {str(tmp_path)!r}\n"
        + _RANK_MODEL + _CONFIG_B, 8,
        files={**model_inputs(cfg, np_params), **batch})
    got = _saved(tmp_path, "B")
    for out in outs:
        assert out["mesh"] == {"dp": 2, "pp": 2, "ep": 2}
        assert out["layers"] == 2  # a stage's block of the 4 layers
        _hold("config B", got, want_p, np_params, want_m, out["B"])
    print(f"config B: port {outs[0]['B']['loss']:.6f}, JAX unsharded f32 "
          f"{want_m['loss']:.6f}, recorded (bf16 AdamW) {RECORDED['B']}")


# ---------------------------------------------------------------------------
# Each axis alone on two ranks

_AXES = """
cfg, params = model()
batch = {"tokens": IN["tokens"], "loss_mask": IN["loss_mask"]}
sgd = optimizers.sgd(1.0)
whole_vocab = sharding.DEFAULT_RULES.extended(vocab=None)
for name, sizes, kw, rules in (
        ("dp", {"dp": 2}, {}, None), ("fsdp", {"fsdp": 2}, {}, None),
        ("tp", {"tp": 2}, {}, None),
        ("tp remat", {"tp": 2}, {"remat": True}, None),
        ("sp", {"sp": 2}, {}, None),
        ("sp zigzag", {"sp": 2}, {"zigzag_sp": True}, None),
        ("sp ulysses", {"sp": 2}, {"ulysses_sp": True}, None),
        ("fsdp fused_ce", {"fsdp": 2}, {"fused_ce": True}, None),
        ("tp fused_ce", {"tp": 2}, {"fused_ce": True}, whole_vocab),
        ("tp fused_ce split", {"tp": 2}, {"fused_ce": True}, None)):
    mesh = MeshSpec(sizes).build(devices=["cpu"] * 2)
    one_step(name, dataclasses.replace(cfg, **kw), params, mesh, batch, sgd,
             rules)
# The pipeline and the MoE, each on its own model (ARM_MODELS).
for name, sizes, prefix, rules in (
        ("pp", {"pp": 2}, "params", PP_RULES),
        ("pp tied", {"pp": 2}, "tied", PP_RULES),
        ("moe ep", {"ep": 2}, "moe", None),
        ("moe ep uneven", {"ep": 2}, "moe3", None),
        ("moe dp", {"dp": 2}, "moe", None),
        ("moe fsdp", {"fsdp": 2}, "moe", None),
        ("moe tp", {"tp": 2}, "moe", None)):
    mcfg, mparams = model(prefix)
    mesh = MeshSpec(sizes).build(devices=["cpu"] * 2)
    one_step(name, mcfg, mparams, mesh, batch, sgd, rules)

dp = MeshSpec({"dp": 2}).build(devices=["cpu"] * 2)
# accum_steps=2: micro-batch i is every data rank's local micro-batch i.
one_step("accum", cfg, params, dp, batch, sgd, accum_steps=2)
# A NaN in rank 1's rows only: the global loss is NaN on every rank.
bad = dict(batch, loss_mask=IN["nan_mask"])
one_step("nonfinite", cfg, params, dp, bad, sgd, skip_nonfinite=True)
fsdp = MeshSpec({"fsdp": 2}).build(devices=["cpu"] * 2)
one_step("adamw", cfg, params, fsdp, batch,
         optimizers.adamw(1e-3, mu_dtype=None))  # optax.adamw's mu dtype

# make_eval_step under fsdp and tp: the global metrics of the batch.
axes = transformer.param_logical_axes(cfg)
for name, sizes in (("eval fsdp", {"fsdp": 2}), ("eval tp", {"tp": 2})):
    mesh = MeshSpec(sizes).build(devices=["cpu"] * 2)
    shard, _ = bridge.to_train_shard(params, cfg, mesh)
    state = train.TrainState(step=torch.zeros((), dtype=torch.int32),
                             params=shard, opt_state={})
    evaluate = train.make_eval_step(
        functools.partial(transformer.loss_fn, config=cfg, mesh=mesh),
        mesh=mesh, logical_axes=axes)
    rows = data_rows(mesh, 4)
    OUT[name] = float(evaluate(state, train.shard_batch(
        {k: v[rows] for k, v in batch.items()}, mesh))["loss"])

# A stochastic step under dp: the state's key splits as JAX's does (the
# CloudLM loss draws nothing from the step key).
stochastic_loss = train.mesh_loss(
    lambda p, b, rng: transformer.loss_fn(p, b, cfg, mesh=dp))
state = train.create_sharded_state(
    None, lambda _: bridge.to_torch(params, cfg, device="cpu"), sgd,
    mesh=dp, logical_axes=axes, train_rng=IN["key"])
step = train.make_train_step(stochastic_loss, sgd, mesh=dp,
                             logical_axes=axes, stochastic=True)
state, metrics = step(state, train.shard_batch(
    {k: v[data_rows(dp, 4)] for k, v in batch.items()}, dp))
OUT["stochastic"] = [state.rng.tolist(), float(metrics["loss"])]

local, valid = train.shard_batch(
    {"tokens": IN["tokens"][data_rows(dp, 4)]}, dp, pad_to=3)
OUT["pad"] = [list(local["tokens"].shape), str(local["tokens"].device),
              valid.tolist(), int(local["tokens"][2:].abs().sum())]
"""

#: The arms of ``_AXES`` held to JAX's plain step.
AXIS_ARMS = ("dp", "fsdp", "tp", "tp remat", "sp", "sp zigzag",
             "sp ulysses", "fsdp fused_ce", "tp fused_ce",
             "tp fused_ce split", "pp", "pp tied",
             "moe ep", "moe ep uneven", "moe dp", "moe fsdp", "moe tp")
#: The model of each arm that does not train the 2-layer TINY.
ARM_MODELS = {"pp tied": "tied", "moe ep": "moe", "moe ep uneven": "moe3",
              "moe dp": "moe", "moe fsdp": "moe", "moe tp": "moe"}


@functools.lru_cache(maxsize=None)
def _axis_models():
    """Prefix -> (JAX config, numpy params): the 2-layer TINY, its tied
    head, and MoE TINY with 4 and 3 experts (top 2), each from
    PRNGKey(0)."""
    from cloud_tpu.models import moe as jax_moe

    base = jax_tf.TINY.scaled(dtype=jnp.float32, num_layers=2)
    cfgs = {"params": base, "tied": base.scaled(tied_embeddings=True),
            "moe": base.scaled(moe=jax_moe.MoeConfig(num_experts=4,
                                                     top_k=2)),
            "moe3": base.scaled(moe=jax_moe.MoeConfig(num_experts=3,
                                                      top_k=2))}
    return {name: (cfg, jax.tree_util.tree_map(
        np.asarray, jax_tf.init(jax.random.PRNGKey(0), cfg)))
        for name, cfg in cfgs.items()}


def _axis_batch():
    """The axis arms' batch (random tokens; the data ranks' mask counts
    differ) and its NaN twin."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (4, 32)).astype(np.int32)
    # Rank 0's rows keep ~90% of their targets, rank 1's ~40%.
    loss_mask = (rng.random((4, 32)) < np.array([[.9], [.9], [.4], [.4]])
                 ).astype(np.float32)
    nan_mask = loss_mask.copy()
    nan_mask[3, 5] = np.nan
    return {"tokens": tokens, "loss_mask": loss_mask}, nan_mask


def _model_files(names):
    files = {}
    for name in names:
        cfg, params = _axis_models()[name]
        files.update(model_inputs(cfg, params, prefix=name))
    return files


@pytest.fixture(scope="module")
def axis_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("axes")
    jcfg, params = _axis_models()["params"]
    batch, nan_mask = _axis_batch()
    outs = run_ranks(
        "import dataclasses\n" + f"OUTDIR = {str(tmp)!r}\n" + _RANK_MODEL
        + _AXES, 2, files={**_model_files(_axis_models()), **batch,
                           "nan_mask": nan_mask,
                           "key": np.asarray(jax.random.PRNGKey(7))})
    return tmp, jcfg, params, batch, outs


@pytest.mark.parametrize("arm", AXIS_ARMS)
def test_each_axis_alone_matches_the_unsharded_step(axis_runs, arm):
    """One sgd(1.0) step under the arm's mesh: JAX's global loss (the
    data ranks' mask counts differ), aux, grad_norm, gradient and params.
    The MoE arms route random tokens, so their aux is the global batch's
    (under dp and fsdp its statistics span both ranks' rows); under pp
    the dense output does not depend on the microbatching; "pp tied"
    would count the table's head gradient twice if it were summed over
    pp."""
    tmp, _, _, batch, outs = axis_runs
    jcfg, params = _axis_models()[ARM_MODELS.get(arm, "params")]
    want_m, want_p, _ = _jax_step(jcfg, params, batch, optax.sgd(1.0))
    local_means = [
        float(jax_tf.loss_fn(params, {k: v[r:r + 2] for k, v in
                                      batch.items()}, jcfg)[0])
        for r in (0, 2)]
    # A mean of the data ranks' local means is not the global loss here.
    assert abs(np.mean(local_means) - want_m["loss"]) > 1e-3
    for out in outs:
        _hold(arm, _saved(tmp, arm), want_p, params, want_m, out[arm])


def test_accum_steps_under_dp(axis_runs):
    """accum_steps=2 under dp 2: micro-batch i is both data ranks' local
    micro-batch i (rows 0 and 2, then 1 and 3), each normalized by its
    own global weight; JAX's accumulated step on those micro-batches."""
    tmp, jcfg, params, batch, outs = axis_runs
    order = [0, 2, 1, 3]
    interleaved = {k: v[order] for k, v in batch.items()}
    want_m, want_p, _ = _jax_step(jcfg, params, interleaved, optax.sgd(1.0),
                                  accum_steps=2)
    for out in outs:
        _hold("accum", _saved(tmp, "accum"), want_p, params, want_m,
              out["accum"])


def test_skip_nonfinite_agrees_across_ranks(axis_runs):
    tmp, _, params, _, outs = axis_runs
    for out in outs:
        assert out["nonfinite"]["nonfinite"] == 1.0
        assert not np.isfinite(out["nonfinite"]["loss"])
    got = _saved(tmp, "nonfinite")
    for key, want in _flat(params, "params").items():
        np.testing.assert_array_equal(got[key], want)


def test_adamw_moments_under_fsdp_match_optax(axis_runs):
    tmp, jcfg, params, batch, outs = axis_runs
    want_m, _, opt_state = _jax_step(jcfg, params, batch, optax.adamw(1e-3))
    adam = opt_state[0]
    got = _saved(tmp, "adamw")
    for out in outs:
        assert abs(out["adamw"]["loss"] - want_m["loss"]) <= 1e-5
    for moment in ("mu", "nu"):
        for key, want in _flat(getattr(adam, moment), moment).items():
            scale = np.abs(want).max()
            np.testing.assert_allclose(got[key], want, rtol=0,
                                       atol=1e-5 * scale,
                                       err_msg=f"{moment} {key}")
    # Params are not held elementwise: AdamW's first update is about
    # +-lr wherever a gradient is tiny.
    diff = max(np.abs(got[k] - v).max() for k, v in
               _flat(_jax_step(jcfg, params, batch,
                               optax.adamw(1e-3))[1], "params").items())
    print(f"AdamW under fsdp 2: largest param difference {diff:.3g}")


def test_eval_step_and_stochastic_step_under_a_mesh(axis_runs):
    """``make_eval_step`` under fsdp and tp gives JAX's global loss; a
    stochastic step under dp splits the state's key as JAX's step does."""
    _, jcfg, params, batch, outs = axis_runs
    want = float(jax_tf.loss_fn(params, batch, jcfg)[0])
    next_key = np.asarray(jax.random.split(jax.random.PRNGKey(7))[0])
    for out in outs:
        assert abs(out["eval fsdp"] - want) <= 1e-5
        assert abs(out["eval tp"] - want) <= 1e-5
        rng, loss = out["stochastic"]
        np.testing.assert_array_equal(np.asarray(rng, np.uint32), next_key)
        assert abs(loss - want) <= 1e-5


def test_shard_batch_pads_this_ranks_rows(axis_runs):
    *_, outs = axis_runs
    for out in outs:
        assert out["pad"] == [[3, 32], "cpu", [1.0, 1.0, 0.0], 0]


# ---------------------------------------------------------------------------
# The pipeline on four ranks

_PP4 = """
cfg, params = model()
mcfg, mparams = model("moe")
batch = {"tokens": IN["tokens"], "loss_mask": IN["loss_mask"]}
sgd = optimizers.sgd(1.0)
for name, sizes, c, p in (("pp tp", {"pp": 2, "tp": 2}, cfg, params),
                          ("pp dp", {"pp": 2, "dp": 2}, cfg, params),
                          ("moe pp dp", {"pp": 2, "dp": 2}, mcfg, mparams)):
    mesh = MeshSpec(sizes).build(devices=["cpu"] * 4)
    one_step(name, c, p, mesh, batch, sgd, PP_RULES)
# A NaN in data rank 1's rows: every rank of both stages skips.
one_step("pp nonfinite", cfg, params, mesh,
         dict(batch, loss_mask=IN["nan_mask"]), sgd, PP_RULES,
         skip_nonfinite=True)
"""


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    batch, nan_mask = _axis_batch()
    outs = run_ranks(
        "import dataclasses\n" + f"OUTDIR = {str(tmp)!r}\n" + _RANK_MODEL
        + _PP4, 4, files={**_model_files(("params", "moe")), **batch,
                          "nan_mask": nan_mask})
    return tmp, batch, outs


@pytest.mark.parametrize("arm", ["pp tp", "pp dp"])
def test_pipeline_meshes_match_the_unsharded_step(pp_runs, arm):
    """{pp: 2, tp: 2} (the self-check's pp mesh) and {pp: 2, dp: 2} with
    M = 2: JAX's unsharded step (a dense loss does not depend on the
    microbatching)."""
    tmp, batch, outs = pp_runs
    jcfg, params = _axis_models()["params"]
    want_m, want_p, _ = _jax_step(jcfg, params, batch, optax.sgd(1.0))
    for out in outs:
        _hold(arm, _saved(tmp, arm), want_p, params, want_m, out[arm])


def _jax_aux(cfg, params, tokens, groups):
    """The mean over microbatches of JAX's unsharded aux, microbatch k
    being the rows ``groups[k]``."""
    return float(np.mean([float(jax_tf.apply(params, tokens[g], cfg)[1])
                          for g in groups]))


def test_moe_under_pp_dp_matches_jax_pipelined_step(pp_runs):
    """MoE TINY under {pp: 2, dp: 2}, M = 2, random tokens: JAX's own
    pipelined step on the same mesh of virtual devices (loss, aux,
    grad_norm, gradient, params).  Global microbatch k is rows [2k,
    2k+1], one on each data rank (``pipeline.microbatch_rows``); a port
    that cut each rank's rows into microbatches locally (microbatches
    {0, 2} and {1, 3}), or took the whole batch's aux, or a mean of the
    ranks' local auxes, would miss JAX's aux by more than the limit."""
    from cloud_tpu import parallel as jax_parallel

    tmp, batch, outs = pp_runs
    jcfg, params = _axis_models()["moe"]
    mesh = jax_parallel.MeshSpec({"pp": 2, "dp": 2}).build(
        jax.devices()[:4])
    rules = jax_parallel.DEFAULT_RULES.extended(layers="pp")
    axes = jax_tf.param_logical_axes(jcfg)
    tx = optax.sgd(1.0)
    with jax_parallel.use_mesh(mesh):
        state = jax_train.create_sharded_state(
            jax.random.PRNGKey(0),
            lambda _: jax.tree_util.tree_map(jnp.asarray, params), tx,
            mesh, logical_axes=axes, rules=rules)
        step = jax_train.make_train_step(
            functools.partial(jax_tf.loss_fn, config=jcfg, rules=rules,
                              mesh=mesh), tx, logical_axes=axes,
            rules=rules, mesh=mesh)
        state, metrics = step(state, jax_train.shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, mesh, rules))
    want_m = {k: float(v) for k, v in metrics.items()}
    want_p = jax.tree_util.tree_map(np.asarray, state.params)
    tokens = batch["tokens"]
    right = _jax_aux(jcfg, params, tokens, ([0, 1], [2, 3]))
    assert abs(right - want_m["aux"]) <= 1e-6
    for wrong in (_jax_aux(jcfg, params, tokens, ([0, 2], [1, 3])),
                  _jax_aux(jcfg, params, tokens, ([0, 1, 2, 3],)),
                  _jax_aux(jcfg, params, tokens, ([0], [1], [2], [3]))):
        assert abs(wrong - right) > 1e-5, (wrong, right)
    for out in outs:
        _hold("moe pp dp", _saved(tmp, "moe pp dp"), want_p, params,
              want_m, out["moe pp dp"])


def test_skip_nonfinite_under_a_pipeline(pp_runs):
    """A NaN in one data rank's rows under {pp: 2, dp: 2}: the loss and
    ``grad_norm`` are NaN on every rank of both stages, every rank skips,
    and the params come back unchanged."""
    tmp, _, outs = pp_runs
    _, params = _axis_models()["params"]
    for out in outs:
        assert out["pp nonfinite"]["nonfinite"] == 1.0
        assert not np.isfinite(out["pp nonfinite"]["grad_norm"])
    got = _saved(tmp, "pp nonfinite")
    for key, want in _flat(params, "params").items():
        np.testing.assert_array_equal(got[key], want)


# ---------------------------------------------------------------------------
# What stays refused, and the records' shard


def _fake_mesh(sizes, coords=None):
    """A built-looking mesh with no process groups: enough for entry
    points that refuse before any collective."""
    from cloud_tpu_torch.parallel import MeshSpec
    from cloud_tpu_torch.parallel.mesh import CANONICAL_AXES, Mesh

    spec = MeshSpec(sizes)
    coords = {a: (coords or {}).get(a, 0) for a in CANONICAL_AXES}
    return Mesh(spec=spec, devices=(torch.device("cpu"),) * spec.num_devices,
                rank=0, coords=coords, backend="gloo", groups={},
                group_ranks={})


def test_refusals_under_a_mesh_name_their_queued_line(tmp_path):
    from cloud_tpu_torch.models import transformer
    from cloud_tpu_torch.parallel import use_mesh
    from cloud_tpu_torch.training import (checkpoint, compile_cache,
                                          optimizers, pipeline_io, train,
                                          trainer)

    mesh = _fake_mesh({"tp": 2})
    sgd = optimizers.sgd(0.1)
    cfg = transformer.TINY.scaled(dtype=torch.float32, num_layers=1)
    lm_loss = functools.partial(transformer.loss_fn, config=cfg, mesh=mesh)
    calls = {
        "window": lambda: train.make_multi_step(
            lm_loss, sgd, steps_per_dispatch=2, mesh=mesh),
        "fit": lambda: trainer.Trainer(lm_loss, sgd, mesh=mesh,
                                       device="cpu").fit(
                                           list, steps_per_dispatch=2),
        "compile-ahead": lambda: compile_cache.abstract_batch(
            {}, mesh=mesh, device="cpu"),
        "pipeline_io": lambda: pipeline_io.prefetch_windows(
            list, 2, mesh=mesh, device="cpu"),
        "MoE under sp": lambda: transformer.loss_fn(
            {}, {"tokens": np.zeros((1, 8), np.int64)},
            cfg.scaled(moe=__import__(
                "cloud_tpu_torch.models.moe", fromlist=["MoeConfig"]
            ).MoeConfig(num_experts=4, top_k=2)),
            mesh=_fake_mesh({"sp": 2})),
    }
    for what, call in calls.items():
        with pytest.raises(NotImplementedError, match="ROADMAP.md A") as got:
            call()
        item = "A.3" if what == "MoE under sp" else "A.2"
        assert item in str(got.value), (what, str(got.value))
    # Checkpoints under a mesh are ported (tests/test_torch_checkpoint_
    # sharded.py): under an installed {tp: 2} mesh a manager needs the
    # state's layout (without one it cannot tell a shard from a replica
    # and refuses), and with it saves and restores; a pipeline stage's
    # block of layers stays refused.
    state = train.create_sharded_state(None, lambda _: {"w": torch.ones(2)},
                                       sgd, device="cpu")
    bare = checkpoint.CheckpointManager(str(tmp_path / "bare"),
                                        device="cpu")
    manager = checkpoint.CheckpointManager(
        str(tmp_path), device="cpu", layout=checkpoint.StateLayout(
            mesh=mesh, logical_axes={"w": (None,)}))
    with use_mesh(mesh):
        for call in (lambda: bare.save(0, state),
                     lambda: bare.restore(0, template=state)):
            with pytest.raises(ValueError, match="layout=StateLayout"):
                call()
        manager.save(0, state)
        manager.wait()
        restored = manager.restore(0, template=state)
        assert torch.equal(restored.params["w"], state.params["w"])
    manager.close()
    manager = checkpoint.CheckpointManager(str(tmp_path / "layers"),
                                           device="cpu")
    from cloud_tpu_torch.parallel import sharding

    pp = _fake_mesh({"pp": 2})
    layers = train.create_sharded_state(
        None, lambda _: {"layers": [{"w": torch.ones(2)}] * 2}, sgd,
        device="cpu")
    manager.save(1, layers)
    manager.wait()
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.3"):
        manager.restore(1, template=layers, layout=checkpoint.StateLayout(
            mesh=pp, logical_axes={"layers": sharding.LayerStack(
                [{"w": ("embed",)}] * 2)},
            rules=sharding.DEFAULT_RULES.extended(layers="pp")))
    manager.close()
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        train.make_train_step(lm_loss, sgd, mesh=object())


def test_records_shard_by_data_coordinate(tmp_path):
    """Under an installed dp x tp mesh, a RecordDataset's default shard is
    the data coordinate: tp peers read the same files, dp ranks differ."""
    from cloud_tpu_torch.parallel import use_mesh
    from cloud_tpu_torch.training import records

    for i in range(4):
        with records.RecordWriter(str(tmp_path / f"part-{i}.rec")) as w:
            w.write(records.encode_tensor_record(
                {"x": np.full((2,), i, np.float32)}))
    seen = {}
    for dp in range(2):
        for tp in range(2):
            with use_mesh(_fake_mesh({"dp": 2, "tp": 2},
                                     {"dp": dp, "tp": tp})):
                ds = records.RecordDataset(str(tmp_path / "*.rec"), 1)
            seen[dp, tp] = (ds.process_index, ds.process_count,
                            [pathlib.Path(f).name for f in ds.shard_files])
    assert seen[0, 0] == seen[0, 1] == (0, 2, ["part-0.rec", "part-2.rec"])
    assert seen[1, 0] == seen[1, 1] == (1, 2, ["part-1.rec", "part-3.rec"])
