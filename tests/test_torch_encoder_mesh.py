"""Training under a mesh finished: BERT and ViT under dp, fsdp, tp and sp,
the fused cross-entropy over a vocabulary split by tp, and MNIST and
ResNet on meshes whose other axes hold replicas (CPU, TINY in f32).

Each mesh runs as gloo ranks, one JAX-free process each
(``helpers.torch_port.run_ranks``); the JAX side runs here.

* **BERT TINY** (a ragged padding mask) and **ViT TINY** (``"gap"``, 64
  patches) from JAX's ``init``: one ``sgd(1.0)`` step under ``{tp: 2}``,
  ``{sp: 2}``, ``{fsdp: 2}``, ``{dp: 2, tp: 2}`` and (as the JAX
  package's ``test_sharded_forward_matches_unsharded``) ``{fsdp: 2, dp:
  2, tp: 2}``.  The global loss on every rank within 1e-5 of JAX's
  ``loss_fn``, the gradient (the update, every rank's shard gathered
  back) within 1e-5 of its largest magnitude, and on the eight ranks
  ViT's logits within that JAX test's 2e-4.
* **BERT's stochastic step** (dropout 0.1) under ``{tp: 2}``, ``{sp: 2}``
  and ``{dp: 2, tp: 2}`` equals the one-process stochastic step from the
  same key (each rank draws its block of the global masks).
* **CloudLM's fused CE with the vocabulary split over tp**: loss and
  gradients against JAX's ``fused_ce`` loss.
* **``Trainer.fit``** of BERT under ``{tp: 2}`` and ``{dp: 2, tp: 2}``
  (each rank its rows of every global batch) logs one process's losses.
* **MNIST and ResNet-8** under ``{tp: 2}`` (MNIST's hidden units split),
  ``{sp: 2}``, ``{pp: 2}`` and ``{ep: 2}``: one step equal to one
  process's on the whole batch.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import bert as jax_bert
from cloud_tpu.models import transformer as jax_tf
from cloud_tpu.models import vit as jax_vit
from helpers.torch_port import model_inputs, port_config, run_ranks
from helpers.torch_sigterm import sigterm_restored  # noqa: F401

torch.set_num_threads(1)

BERT_T = 16
VIT_IMAGES = 8


def _flat(tree, prefix=""):
    """``{"a/b/0/c": array}`` of a tree of dicts and lists."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, key))
        else:
            out[key] = (v.detach().numpy() if torch.is_tensor(v)
                        else np.asarray(v))
    return out


#: On every rank: the models rebuilt from ``IN``, then each case of
#: ``CASES`` (a function ``case_<name>``): a step under the mesh, and for
#: the port-only cases the same step in one process.
_RANK = """
import dataclasses
import functools
from cloud_tpu_torch import bridge
from cloud_tpu_torch import random as random_lib
from cloud_tpu_torch.models import bert, mnist, resnet, transformer, vit
from cloud_tpu_torch.parallel import sharding, tensor_parallel
from cloud_tpu_torch.training import optimizers, train

mesh = MeshSpec(SIZES).build(devices=["cpu"] * WORLD)
f32 = torch.float32


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


def flat(node, prefix=""):
    out = {}
    items = node.items() if isinstance(node, dict) else enumerate(node)
    for k, v in items:
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            out.update(flat(v, key))
        else:
            out[key] = v.detach().numpy()
    return out


def rows(n):
    index = mesh.axis_index("dp") * mesh.axis_size("fsdp") + \\
        mesh.axis_index("fsdp")
    per = n // (mesh.axis_size("dp") * mesh.axis_size("fsdp"))
    return slice(index * per, (index + 1) * per)


def step(loss, params, axes, batch, *, sharded=True, rng=None):
    \"\"\"One sgd(1.0) step under the mesh (``sharded``) or in one process
    on the whole batch: (metrics, the params after it, whole).\"\"\"
    tx = optimizers.sgd(1.0)
    on = mesh if sharded else None
    state = train.create_sharded_state(
        None, lambda _: bridge.map_leaves(params, lambda t: t.clone()), tx,
        mesh=on, logical_axes=axes if sharded else None,
        train_rng=None if rng is None else np.asarray(rng, np.uint32),
        device="cpu")
    if sharded:
        batch = train.shard_batch(
            {k: v[rows(len(v))] for k, v in batch.items()}, mesh)
        loss = functools.partial(loss, mesh=mesh)
    else:
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        loss = functools.partial(loss, device="cpu")
    state, metrics = train.make_train_step(
        loss, tx, mesh=on, logical_axes=axes if sharded else None,
        stochastic=rng is not None)(state, batch)
    after = state.params
    if sharded:
        after = sharding.gather_tree(after, axes, mesh)
    return {k: float(v) for k, v in metrics.items()}, after


def save(name, params):
    if RANK == 0:
        np.savez(f"{OUTDIR}/{name}.npz", **flat(params))


def largest_gap(a, b):
    return max(float((x - y).abs().max()) for x, y in
               zip(bridge.leaves(a), bridge.leaves(b)))


bcfg = dataclasses.replace(bert.TINY, dtype=f32)
bparams = bridge.bert_to_torch(tree("bert"), bcfg, device="cpu")
bbatch = {k: IN["bert." + k] for k in ("tokens", "attention_mask", "label")}
vcfg = vit.VIT_TINY_CIFAR.scaled(dtype=f32, num_layers=2)
vparams = bridge.vit_to_torch(tree("vit"), vcfg, device="cpu")
vbatch = {"image": IN["vit.image"], "label": IN["vit.label"]}


def case_bert():
    OUT["bert"], after = step(functools.partial(bert.loss_fn, cfg=bcfg),
                              bparams, bert.param_logical_axes(bcfg), bbatch)
    save("bert", after)


def case_vit():
    OUT["vit"], after = step(functools.partial(vit.loss_fn, cfg=vcfg),
                             vparams, vit.param_logical_axes(vcfg), vbatch)
    save("vit", after)


def case_vit_logits():
    # Each rank's logits of its rows from its shards (fsdp's gathered).
    axes = vit.param_logical_axes(vcfg)
    with torch.no_grad():
        shard = sharding.shard_tree(vparams, axes, mesh)
        whole = train._MeshLayout(mesh, None, axes, shard).gather(shard)
        logits = vit.apply(whole, torch.as_tensor(
            vbatch["image"][rows(len(vbatch["image"]))]), vcfg, mesh=mesh)
    held = rows(len(vbatch["image"]))
    OUT["vit logits"] = [held.start, held.stop, logits.tolist()]


def case_stochastic():
    scfg = dataclasses.replace(bcfg, dropout_rate=0.1)
    sloss = functools.partial(bert.loss_fn, cfg=scfg)
    key = random_lib.key_data(random_lib.PRNGKey(7))
    got_m, got = step(sloss, bparams, bert.param_logical_axes(scfg), bbatch,
                      rng=key)
    want_m, want = step(sloss, bparams, None, bbatch, sharded=False,
                        rng=key)
    OUT["stochastic"] = [got_m["loss"], want_m["loss"],
                         largest_gap(got, want)]


def case_fused_ce():
    lcfg = transformer.TransformerConfig(
        dtype=f32, remat=False, fused_ce=True,
        **json.loads(str(IN["params.config"])))
    lparams = bridge.to_torch(tree("params"), lcfg, device="cpu")
    assert tensor_parallel.check_rules(mesh, sharding.DEFAULT_RULES,
                                       training=True)  # vocab on tp
    OUT["fused_ce"], after = step(
        functools.partial(transformer.loss_fn, config=lcfg), lparams,
        transformer.param_logical_axes(lcfg), {"tokens": IN["tokens"]})
    save("fused_ce", after)


def case_fit():
    # Trainer.fit under the mesh: each rank iterates its rows of every
    # global batch, as the multi-process contract says.
    from cloud_tpu_torch.training import data, trainer

    def fit(sharded):
        on = mesh if sharded else None
        loss = functools.partial(bert.loss_fn, cfg=bcfg,
                                 **({"mesh": mesh} if sharded
                                    else {"device": "cpu"}))
        t = trainer.Trainer(
            loss, optimizers.sgd(0.1),
            init_fn=lambda _: bridge.map_leaves(bparams, torch.clone),
            mesh=on, device=None if sharded else "cpu",
            logical_axes=bert.param_logical_axes(bcfg) if sharded else None)
        t.init_state(None)
        held = rows(4) if sharded else slice(None)
        arrays = {k: np.concatenate([v[i:i + 4][held]
                                     for i in range(0, len(v), 4)])
                  for k, v in bbatch.items()}
        per = 4 // (mesh.axis_size("dp") * mesh.axis_size("fsdp"))
        history = t.fit(data.ArrayDataset(arrays, per if sharded else 4),
                        epochs=2)
        return history.history["loss"]

    OUT["fit"] = [fit(True), fit(False)]


def case_replicas():
    mcfg = mnist.MnistConfig(hidden_dim=16)
    mparams = bridge.init_mnist(mcfg, torch.Generator().manual_seed(0),
                                device="cpu")
    mbatch = {"image": IN["mnist.image"], "label": IN["mnist.label"]}
    maxes = mnist.param_logical_axes(mcfg)
    mloss = functools.partial(mnist.loss_fn, config=mcfg)
    got_m, got = step(mloss, mparams, maxes, mbatch)
    want_m, want = step(mloss, mparams, None, mbatch, sharded=False)
    held = sharding.shard_tree(mparams, maxes, mesh)["hidden"]["kernel"]
    OUT["mnist"] = [got_m["loss"], want_m["loss"], largest_gap(got, want),
                    list(held.shape)]
    rcfg = dataclasses.replace(resnet.RESNET8_CIFAR, dtype=f32)
    rparams = bridge.init_resnet(rcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    rbatch = {"image": IN["resnet.image"], "label": IN["resnet.label"]}
    rloss = functools.partial(resnet.loss_fn, config=rcfg)
    got_m, got = step(rloss, rparams, resnet.param_logical_axes(rcfg),
                      rbatch)
    want_m, want = step(rloss, rparams, None, rbatch, sharded=False)
    OUT["resnet"] = [got_m["loss"], want_m["loss"], largest_gap(got, want)]


for case in CASES:
    globals()["case_" + case.replace(" ", "_")]()
"""


def _jax_grads(loss, params, batch):
    (value, _), grads = jax.value_and_grad(loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(value), grads


@pytest.fixture(scope="module")
def jax_side():
    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import bert, vit

    rng = np.random.default_rng(0)
    bcfg = dataclasses.replace(jax_bert.TINY, dtype=jnp.float32)
    bparams = jax_bert.init(jax.random.PRNGKey(0), bcfg)
    lengths = np.asarray([16, 9, 12, 5, 16, 3, 11, 14])
    bbatch = {
        "tokens": rng.integers(0, bcfg.vocab_size, (8, BERT_T)).astype(
            np.int32),
        "attention_mask": (np.arange(BERT_T)[None] < lengths[:, None]
                           ).astype(np.int32),
        "label": rng.integers(0, 2, 8).astype(np.int32)}
    vcfg = jax_vit.VIT_TINY_CIFAR.scaled(dtype=jnp.float32, num_layers=2)
    vparams = jax_vit.init(jax.random.PRNGKey(1), vcfg)
    vbatch = {"image": rng.normal(size=(VIT_IMAGES, 32, 32, 3)).astype(
        np.float32), "label": rng.integers(0, 10, VIT_IMAGES).astype(
            np.int32)}
    lcfg = jax_tf.TINY.scaled(dtype=jnp.float32, num_layers=2,
                              fused_ce=True)
    lparams = jax_tf.init(jax.random.PRNGKey(2), lcfg)
    tokens = rng.integers(0, lcfg.vocab_size, (4, 16)).astype(np.int32)

    port_b = dataclasses.replace(bert.TINY, dtype=torch.float32)
    port_v = vit.VIT_TINY_CIFAR.scaled(dtype=torch.float32, num_layers=2)
    port_l = port_config(lcfg)
    out = {"vit logits": np.asarray(jax_vit.apply(
        vparams, jnp.asarray(vbatch["image"]), vcfg))}
    for name, loss, params, batch, to_port in (
            ("bert", functools.partial(jax_bert.loss_fn, cfg=bcfg), bparams,
             bbatch, lambda t: bridge.bert_to_torch(t, port_b,
                                                    device="cpu")),
            ("vit", functools.partial(jax_vit.loss_fn, cfg=vcfg), vparams,
             vbatch, lambda t: bridge.vit_to_torch(t, port_v, device="cpu")),
            ("fused_ce", functools.partial(jax_tf.loss_fn, config=lcfg),
             lparams, {"tokens": tokens},
             lambda t: bridge.to_torch(t, port_l, device="cpu"))):
        value, grads = _jax_grads(loss, params, batch)
        out[name] = (value, _flat(to_port(params)), _flat(to_port(grads)))
    rng = np.random.default_rng(4)
    out["files"] = {
        **{f"bert/{k}": v for k, v in _flat(bparams).items()},
        **{f"bert.{k}": v for k, v in bbatch.items()},
        **{f"vit/{k}": v for k, v in _flat(vparams).items()},
        **{f"vit.{k}": v for k, v in vbatch.items()},
        **model_inputs(lcfg, lparams),
        "tokens": tokens,
        "mnist.image": rng.normal(size=(8, 784)).astype(np.float32),
        "mnist.label": rng.integers(0, 10, 8),
        "resnet.image": rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
        "resnet.label": rng.integers(0, 10, 4),
    }
    return out


def _hold(what, got_after, start, grads, metrics, want_loss):
    """Loss within 1e-5; the update (minus the gradient) within 1e-5 of
    the gradient's largest magnitude."""
    assert abs(metrics["loss"] - want_loss) <= 1e-5, (
        what, metrics["loss"], want_loss)
    scale = max(np.abs(g).max() for g in grads.values())
    assert set(got_after) == set(grads), what
    for key, g in grads.items():
        np.testing.assert_allclose(start[key] - got_after[key], g, rtol=0,
                                   atol=1e-5 * scale,
                                   err_msg=f"{what} grad {key}")


def _replicas_hold(what, out):
    for model in ("mnist", "resnet"):
        got_loss, want_loss, gap = out[model][:3]
        assert abs(got_loss - want_loss) <= 1e-5, (what, model, out[model])
        assert gap <= 1e-5, (what, model, gap)


MESHES = {
    "tp2": ({"tp": 2}, ["bert", "vit", "stochastic", "fused_ce",
                        "replicas", "fit"]),
    "sp2": ({"sp": 2}, ["bert", "vit", "stochastic", "replicas"]),
    "fsdp2": ({"fsdp": 2}, ["bert", "vit"]),
    "dp2tp2": ({"dp": 2, "tp": 2}, ["bert", "vit", "stochastic", "fit"]),
    "fsdp2dp2tp2": ({"fsdp": 2, "dp": 2, "tp": 2},
                    ["bert", "vit", "vit logits"]),
    "pp2": ({"pp": 2}, ["replicas"]),
    "ep2": ({"ep": 2}, ["replicas"]),
}


@pytest.mark.parametrize("name", list(MESHES))
def test_training_under_a_mesh_matches(jax_side, tmp_path, name):
    sizes, cases = MESHES[name]
    world = int(np.prod(list(sizes.values())))
    outs = run_ranks(
        f"OUTDIR = {str(tmp_path)!r}\nSIZES = {sizes!r}\n"
        f"CASES = {cases!r}\n" + _RANK, world, files=jax_side["files"],
        timeout=120)
    for model in ("bert", "vit", "fused_ce"):
        if model not in cases:
            continue
        want_loss, start, grads = jax_side[model]
        with np.load(tmp_path / f"{model}.npz") as data:
            got = {k: data[k] for k in data.files}
        for rank, out in enumerate(outs):
            _hold(f"{name} {model} rank {rank}", got, start, grads,
                  out[model], want_loss)
    for out in outs:
        if "vit logits" in cases:
            start, stop, logits = out["vit logits"]
            np.testing.assert_allclose(
                np.asarray(logits), jax_side["vit logits"][start:stop],
                rtol=2e-4, atol=2e-4)
        if "stochastic" in cases:
            got_loss, want_loss, gap = out["stochastic"]
            assert abs(got_loss - want_loss) <= 1e-5, (name, out)
            assert gap <= 1e-5, (name, gap)
        if "fit" in cases:
            got, want = out["fit"]
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
        if "replicas" in cases:
            _replicas_hold(name, out)
            if "tp" in sizes:  # MNIST's hidden units split over tp
                assert out["mnist"][3] == [784, 8]
