"""``Trainer.fit`` under a mesh (``cloud_tpu_torch.training.trainer`` with
``mesh=``), MNIST and ResNet under a mesh, against the JAX package's
unsharded ``fit``, on the CPU.

* On 2 gloo ranks, ``fit`` of MNIST (hidden 16, SGD, two epochs with
  validation; the fsdp arm with ``accum_steps=2``) and of ResNet TINY
  (``RESNET8_CIFAR`` f32, SGD momentum, with validation) under ``{dp: 2}``
  and under ``{fsdp: 2}`` equals JAX's ``fit`` without a mesh on the same
  weights and the same shuffled global batches, each rank given its rows
  of every batch: every logged loss within 1e-4 relative, the metrics
  within 1e-5 of max(1, |value|), the parameters within 1e-5 of their
  leaf's largest magnitude.
* A one-rank mesh is the single-process step: ``fit`` equals ``fit``
  without a mesh bit for bit, windows and compile-ahead included.
* What stays refused names ROADMAP.md A.2: windows and compile-ahead
  under a mesh of more than one rank (MNIST and ResNet under tp, sp, pp
  and ep are held to one process in ``test_torch_encoder_mesh.py``).
"""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.models import mnist as jax_mnist
from cloud_tpu.models import resnet as jax_resnet
from cloud_tpu.training import data as jax_data
from cloud_tpu.training import trainer as jax_trainer
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import mnist
from cloud_tpu_torch.parallel import MeshSpec
from cloud_tpu_torch.parallel.mesh import CANONICAL_AXES, Mesh
from cloud_tpu_torch.training import data, optimizers, trainer
from helpers.torch_port import mnist_models, resnet8_models, run_ranks

torch.set_num_threads(1)

MNIST_BATCH, MNIST_BATCHES = 8, 4
RESNET_BATCH, RESNET_BATCHES = 4, 3

_RANKS = """
import functools
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import mnist, resnet
from cloud_tpu_torch.parallel import mesh as mesh_lib
from cloud_tpu_torch.training import data, optimizers, trainer


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


class RankRows:
    # This rank's rows of every global batch (its data coordinate).
    def __init__(self, ds, mesh):
        self.ds = ds
        self.index = (mesh.axis_index("dp") * mesh.axis_size("fsdp")
                      + mesh.axis_index("fsdp"))
        self.count = mesh.axis_size("dp") * mesh.axis_size("fsdp")

    def __call__(self):
        for batch in self.ds():
            n = len(batch["label"]) // self.count
            yield {k: v[self.index * n:(self.index + 1) * n]
                   for k, v in batch.items()}


def arm(name, sizes, loss, tx, init, axes, batch, val_batch, epochs, **kw):
    mesh = MeshSpec(sizes).build(devices=["cpu"] * WORLD)
    t = trainer.Trainer(loss, tx, init_fn=init, mesh=mesh,
                        logical_axes=axes, **kw)
    t.init_state(None)
    ds = data.ArrayDataset({"image": IN[name + ".image"],
                            "label": IN[name + ".label"]}, batch,
                           shuffle=True, seed=0)
    val = data.ArrayDataset({"image": IN[name + ".val_image"],
                             "label": IN[name + ".val_label"]}, val_batch)
    hist = t.fit(RankRows(ds, mesh), epochs=epochs,
                 validation_data=RankRows(val, mesh))
    OUT[f"{name} {sizes}"] = {
        "history": hist.history,
        "params": {k: v.tolist() for k, v in flat(t.state.params).items()},
    }


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = v.detach().numpy()
    return out


mcfg = mnist.MnistConfig(hidden_dim=16)
rcfg = resnet.ResNetConfig(stage_sizes=(1, 1, 1, 1), width=16,
                           num_classes=10, num_groups=8, dtype=torch.float32)
for sizes, accum in (({"dp": 2}, 1), ({"fsdp": 2}, 2)):
    arm("mnist", sizes, functools.partial(mnist.loss_fn, config=mcfg),
        optimizers.sgd(0.1),
        lambda _: bridge.mnist_to_torch(tree("mnist"), device="cpu"),
        mnist.param_logical_axes(mcfg), MNIST_BATCH, MNIST_BATCH, 2,
        accum_steps=accum)
    arm("resnet", sizes, functools.partial(resnet.loss_fn, config=rcfg),
        optimizers.sgd(0.1, momentum=0.9),
        lambda _: bridge.resnet_to_torch(tree("resnet"), device="cpu"),
        resnet.param_logical_axes(rcfg), RESNET_BATCH, RESNET_BATCH, 1)
"""


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = (v.detach().numpy() if torch.is_tensor(v)
                        else np.asarray(v))
    return out


def _arrays(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "mnist":
        return {"image": rng.normal(size=(n, 784)).astype(np.float32),
                "label": rng.integers(0, 10, n).astype(np.int64)}
    labels = rng.integers(0, 10, n).astype(np.int64)
    return {"image": rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            "label": labels}


def _cases():
    jm_cfg, jm_params, _, _ = mnist_models(0)
    jr_cfg, jr_params, _, _ = resnet8_models(0)
    return {
        "mnist": dict(
            loss=functools.partial(jax_mnist.loss_fn, config=jm_cfg),
            tx=optax.sgd(0.1), params=jm_params, batch=MNIST_BATCH,
            train=_arrays("mnist", MNIST_BATCH * MNIST_BATCHES, 1),
            val=_arrays("mnist", MNIST_BATCH * 2, 2), epochs=2),
        "resnet": dict(
            loss=functools.partial(jax_resnet.loss_fn, config=jr_cfg),
            tx=optax.sgd(0.1, momentum=0.9), params=jr_params,
            batch=RESNET_BATCH,
            train=_arrays("resnet", RESNET_BATCH * RESNET_BATCHES, 3),
            val=_arrays("resnet", RESNET_BATCH, 4), epochs=1),
    }


def _jax_fit(case, accum_steps=1):
    params = jax.tree_util.tree_map(jax.numpy.asarray, case["params"])
    t = jax_trainer.Trainer(case["loss"], case["tx"], lambda _: params,
                            accum_steps=accum_steps)
    t.init_state(jax.random.PRNGKey(0))
    hist = t.fit(jax_data.ArrayDataset(case["train"], case["batch"],
                                       shuffle=True, seed=0),
                 epochs=case["epochs"],
                 validation_data=jax_data.ArrayDataset(case["val"],
                                                       case["batch"]))
    return hist.history, _flat(jax.tree_util.tree_map(np.asarray,
                                                      t.state.params))


@pytest.fixture(scope="module")
def ranks():
    files = {}
    for name, case in _cases().items():
        files.update({f"{name}/{k}": v
                      for k, v in _flat(case["params"]).items()})
        for split in ("train", "val"):
            prefix = "" if split == "train" else "val_"
            for key, value in case[split].items():
                files[f"{name}.{prefix}{key}"] = value
    script = (f"MNIST_BATCH, RESNET_BATCH = {MNIST_BATCH}, {RESNET_BATCH}\n"
              + _RANKS)
    return run_ranks(script, 2, files=files, timeout=400)


@pytest.mark.parametrize("arm", [("mnist", "dp", 1), ("mnist", "fsdp", 2),
                                 ("resnet", "dp", 1), ("resnet", "fsdp", 1)],
                         ids=lambda a: f"{a[0]}-{a[1]}")
def test_fit_under_a_mesh_equals_jax_unsharded(ranks, arm):
    name, axis, accum = arm
    want_hist, want_params = _jax_fit(_cases()[name], accum)
    key = f"{name} {{'{axis}': 2}}"
    for out in ranks:
        got = out[key]
        assert set(got["history"]) == set(want_hist)
        for metric, values in want_hist.items():
            if metric == "epoch_seconds":
                continue
            got_values = np.asarray(got["history"][metric])
            if metric.endswith("loss"):
                np.testing.assert_allclose(got_values, values, rtol=1e-4,
                                           err_msg=metric)
            else:
                scale = np.maximum(1.0, np.abs(values))
                assert np.all(np.abs(got_values - values) <= 1e-5 * scale), (
                    metric, got_values, values)
        assert set(got["params"]) == set(want_params)
        for leaf, value in want_params.items():
            err = np.abs(np.asarray(got["params"][leaf]) - value).max()
            assert err <= 1e-5 * max(np.abs(value).max(), 1e-30), (leaf, err)
    # Every rank holds the same replicated params and global metrics.
    assert ranks[0][key]["params"] == ranks[1][key]["params"]


def _one_rank_mesh():
    return MeshSpec({}).build(devices=["cpu"])


@pytest.mark.parametrize("k", [1, 2])
def test_one_rank_mesh_is_the_single_process_fit(k):
    _, _, cfg, _ = mnist_models(0)
    _, params, _, _ = mnist_models(0)
    arrays = _arrays("mnist", MNIST_BATCH * 5, 1)
    runs = []
    for mesh in (None, _one_rank_mesh()):
        t = trainer.Trainer(
            functools.partial(mnist.loss_fn, config=cfg, device="cpu"),
            optimizers.sgd(0.1),
            init_fn=lambda _: bridge.mnist_to_torch(params, device="cpu"),
            mesh=mesh, logical_axes=mnist.param_logical_axes(cfg),
            device="cpu")
        t.init_state(None)
        hist = t.fit(data.ArrayDataset(arrays, MNIST_BATCH, shuffle=True),
                     epochs=2, steps_per_dispatch=k, compile_ahead=k == 2)
        runs.append((hist.history["loss"], hist.history["accuracy"],
                     _flat(t.state.params)))
    assert runs[0][:2] == runs[1][:2]
    for leaf in runs[0][2]:
        np.testing.assert_array_equal(runs[0][2][leaf], runs[1][2][leaf])


def _fake_mesh(sizes):
    spec = MeshSpec(sizes)
    return Mesh(spec=spec, devices=(torch.device("cpu"),) * spec.num_devices,
                rank=0, coords={a: 0 for a in CANONICAL_AXES},
                backend="gloo", groups={}, group_ranks={})


def test_refusals_name_a2():
    """The window and compile-ahead under a mesh stay refused, naming
    A.2 (MNIST and ResNet under tp, sp, pp and ep run: they are held to
    one process in tests/test_torch_encoder_mesh.py)."""
    _, _, mcfg, _ = mnist_models(0)
    calls = []
    dp2 = _fake_mesh({"dp": 2})
    t = trainer.Trainer(functools.partial(mnist.loss_fn, config=mcfg),
                        optimizers.sgd(0.1), mesh=dp2, device="cpu")
    calls.append(("window", lambda: t.fit(list, steps_per_dispatch=2)))
    calls.append(("compile-ahead", lambda: t.fit(list, compile_ahead=True)))
    for what, call in calls:
        with pytest.raises(NotImplementedError, match="ROADMAP.md A.2"):
            call()
    with pytest.raises(ValueError, match="not the mesh's device"):
        trainer.Trainer(mnist.loss_fn, optimizers.sgd(0.1),
                        mesh=_one_rank_mesh(), device="cuda")
