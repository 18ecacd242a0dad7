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
* Windows and compile-ahead under a mesh of more than one rank: MNIST
  and ResNet ``fit(steps_per_dispatch=2)`` with a tail (5 and 3 batches),
  with ``compile_ahead=True`` and with ``batch_spec=``, against JAX's
  ``fit(steps_per_dispatch=2)`` without a mesh, by the limits above; and
  ``pipeline_io.prefetch_windows`` under ``{dp: 2}`` (this rank's stacked
  rows, the padded tail's mask).  With compile-ahead under ``{fsdp: 2}``
  (MNIST's hidden units cut over fsdp), rank 0's worker warms the eval
  step up only after its first validation and rank 1's before it: the
  fit still equals JAX's.  MNIST and ResNet under tp, sp, pp and
  ep are held to one process in ``test_torch_encoder_mesh.py``.
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
from helpers.torch_sigterm import sigterm_restored  # noqa: F401

torch.set_num_threads(1)

MNIST_BATCH, MNIST_BATCHES = 8, 4
RESNET_BATCH, RESNET_BATCHES = 4, 3

_RANKS = """
import functools
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import mnist, resnet
from cloud_tpu_torch.parallel import mesh as mesh_lib
from cloud_tpu_torch.parallel import sharding
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


def arm(name, sizes, loss, tx, init, axes, batch, val_batch, epochs,
        fit_kw=None, tag="", train=None, val_rows=RankRows, **kw):
    mesh = MeshSpec(sizes).build(devices=["cpu"] * WORLD)
    t = trainer.Trainer(loss, tx, init_fn=init, mesh=mesh,
                        logical_axes=axes, **kw)
    t.init_state(None)
    train = train or name
    ds = data.ArrayDataset({"image": IN[train + ".image"],
                            "label": IN[train + ".label"]}, batch,
                           shuffle=True, seed=0)
    val = data.ArrayDataset({"image": IN[name + ".val_image"],
                             "label": IN[name + ".val_label"]}, val_batch)
    fit_kw = dict(fit_kw or {})
    if fit_kw.pop("batch_spec", False):
        rows = batch // (mesh.axis_size("dp") * mesh.axis_size("fsdp"))
        fit_kw["batch_spec"] = {
            "image": IN[train + ".image"][:rows],
            "label": IN[train + ".label"][:rows]}
    hist = t.fit(RankRows(ds, mesh), epochs=epochs,
                 validation_data=val_rows(val, mesh), **fit_kw)
    params = t.state.params
    if "rules" in kw:  # the rank's shards of the rules' cuts, gathered
        params = sharding.gather_tree(params, axes, mesh, kw["rules"])
    OUT[f"{name} {sizes}{tag}"] = {
        "history": hist.history,
        "params": {k: v.tolist() for k, v in flat(params).items()},
        "step": int(t.state.step),
    }
    if fit_kw.get("compile_ahead"):
        plan = t.compile_plan
        OUT[f"{name} {sizes}{tag}"]["ahead"] = [
            repr(plan.error), sorted(label for label, s in plan.steps.items()
                                     if s.compiled is not None)]


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

# Windows of 2 with a tail (5 MNIST batches, 3 ResNet batches), with
# compile-ahead under dp and with batch_spec under fsdp.
for sizes, fit_kw in (({"dp": 2}, {"compile_ahead": True}),
                      ({"fsdp": 2}, {"compile_ahead": True,
                                     "batch_spec": True})):
    fit_kw = dict(fit_kw, steps_per_dispatch=2)
    arm("mnist", sizes, functools.partial(mnist.loss_fn, config=mcfg),
        optimizers.sgd(0.1),
        lambda _: bridge.mnist_to_torch(tree("mnist"), device="cpu"),
        mnist.param_logical_axes(mcfg), MNIST_BATCH, MNIST_BATCH, 2,
        fit_kw=fit_kw, tag=" windows", train="mnist_tail")
    arm("resnet", sizes, functools.partial(resnet.loss_fn, config=rcfg),
        optimizers.sgd(0.1, momentum=0.9),
        lambda _: bridge.resnet_to_torch(tree("resnet"), device="cpu"),
        resnet.param_logical_axes(rcfg), RESNET_BATCH, RESNET_BATCH, 1,
        fit_kw=fit_kw, tag=" windows")

# The eval step's warm-up after the first validation on rank 0 alone (its
# compile-ahead worker peeks the validation data only once the main thread
# has validated), before it on rank 1, under fsdp with MNIST's hidden units
# cut over fsdp, so that the step's layout exchanges the leaves' extents
# at its first use: each thread of a rank exchanges over its own groups,
# whichever comes first.
import threading


class Validated(trainer.Callback):
    def __init__(self):
        self.event = threading.Event()

    def on_epoch_end(self, epoch, logs, trainer):
        self.event.set()


validated = Validated()


class LateRows(RankRows):
    def __call__(self):
        if (RANK == 0 and threading.current_thread().name
                == "cloud-tpu-compile-ahead"):
            assert validated.event.wait(60)
        yield from super().__call__()


arm("mnist", {"fsdp": 2}, functools.partial(mnist.loss_fn, config=mcfg),
    optimizers.sgd(0.1),
    lambda _: bridge.mnist_to_torch(tree("mnist"), device="cpu"),
    mnist.param_logical_axes(mcfg), MNIST_BATCH, MNIST_BATCH, 2,
    fit_kw={"compile_ahead": True, "steps_per_dispatch": 2,
            "callbacks": [validated]},
    tag=" late eval", train="mnist_tail", val_rows=LateRows,
    rules=sharding.ShardingRules({**sharding.DEFAULT_RULES.rules,
                                  "mlp": "fsdp"}))

# The windowed pipeline under {dp: 2}: this rank's rows, stacked, and the
# padded tail's mask.
from cloud_tpu_torch.training import pipeline_io
dp = MeshSpec({"dp": 2}).build(devices=["cpu"] * WORLD)
ds = data.ArrayDataset({"image": IN["resnet.image"],
                        "label": IN["resnet.label"]}, RESNET_BATCH)
OUT["prefetch_windows"] = [
    [n, list(payload["image"].shape), str(payload["image"].device),
     payload["image"].double().sum(dim=(2, 3, 4)).tolist(),
     payload["label"].tolist(), valid.tolist()]
    for n, payload, valid in pipeline_io.prefetch_windows(
        RankRows(ds, dp), 2, mesh=dp)()]
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
            tail=_arrays("mnist", MNIST_BATCH * (MNIST_BATCHES + 1), 5),
            val=_arrays("mnist", MNIST_BATCH * 2, 2), epochs=2),
        "resnet": dict(
            loss=functools.partial(jax_resnet.loss_fn, config=jr_cfg),
            tx=optax.sgd(0.1, momentum=0.9), params=jr_params,
            batch=RESNET_BATCH,
            train=_arrays("resnet", RESNET_BATCH * RESNET_BATCHES, 3),
            val=_arrays("resnet", RESNET_BATCH, 4), epochs=1),
    }


def _jax_fit(case, accum_steps=1, steps_per_dispatch=1, train="train"):
    params = jax.tree_util.tree_map(jax.numpy.asarray, case["params"])
    t = jax_trainer.Trainer(case["loss"], case["tx"], lambda _: params,
                            accum_steps=accum_steps)
    t.init_state(jax.random.PRNGKey(0))
    hist = t.fit(jax_data.ArrayDataset(case[train], case["batch"],
                                       shuffle=True, seed=0),
                 epochs=case["epochs"],
                 validation_data=jax_data.ArrayDataset(case["val"],
                                                       case["batch"]),
                 steps_per_dispatch=steps_per_dispatch)
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
        for key, value in case.get("tail", {}).items():
            files[f"{name}_tail.{key}"] = value
    script = (f"MNIST_BATCH, RESNET_BATCH = {MNIST_BATCH}, {RESNET_BATCH}\n"
              + _RANKS)
    return run_ranks(script, 2, files=files)


def _hold_to_jax(ranks, key, want_hist, want_params):
    """Every logged loss within 1e-4 relative, the metrics within 1e-5 of
    max(1, |value|), the params within 1e-5 of their leaf's largest
    magnitude, on every rank."""
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


@pytest.mark.parametrize("arm", [("mnist", "dp", 1), ("mnist", "fsdp", 2),
                                 ("resnet", "dp", 1), ("resnet", "fsdp", 1)],
                         ids=lambda a: f"{a[0]}-{a[1]}")
def test_fit_under_a_mesh_equals_jax_unsharded(ranks, arm):
    name, axis, accum = arm
    want_hist, want_params = _jax_fit(_cases()[name], accum)
    _hold_to_jax(ranks, f"{name} {{'{axis}': 2}}", want_hist, want_params)


@pytest.mark.parametrize("arm", [("mnist", "dp"), ("mnist", "fsdp"),
                                 ("resnet", "dp"), ("resnet", "fsdp")],
                         ids=lambda a: f"{a[0]}-{a[1]}")
def test_fit_windows_under_a_mesh_equal_jax_unsharded(ranks, arm):
    """``fit(steps_per_dispatch=2)`` under the mesh, 5 MNIST batches (two
    epochs) and 3 ResNet batches, so every epoch ends in a 1-of-2 tail,
    with ``compile_ahead=True`` under dp and with ``batch_spec=`` too
    under fsdp: JAX's ``fit(steps_per_dispatch=2)`` without a mesh.
    Compile-ahead warmed the window and the eval step on every rank with
    no error, and the artifacts served the whole fit."""
    name, axis = arm
    case = _cases()[name]
    want_hist, want_params = _jax_fit(
        case, steps_per_dispatch=2,
        train="tail" if name == "mnist" else "train")
    key = f"{name} {{'{axis}': 2}} windows"
    _hold_to_jax(ranks, key, want_hist, want_params)
    batches = MNIST_BATCHES + 1 if name == "mnist" else RESNET_BATCHES
    for out in ranks:
        assert out[key]["step"] == batches * case["epochs"]
        assert out[key]["ahead"] == ["None", ["eval_step", "multi_step"]]


def test_eval_warm_up_after_validation_on_one_rank(ranks):
    """Under ``{fsdp: 2}`` with ``compile_ahead=True``, rank 0's worker
    warms the eval step up only after its main thread's first validation,
    rank 1's before it: the fit (windows of 2, two epochs with a tail)
    ends with no compile-ahead error and equals JAX's
    ``fit(steps_per_dispatch=2)`` without a mesh, by the limits above."""
    case = _cases()["mnist"]
    want_hist, want_params = _jax_fit(case, steps_per_dispatch=2,
                                      train="tail")
    key = "mnist {'fsdp': 2} late eval"
    _hold_to_jax(ranks, key, want_hist, want_params)
    for out in ranks:
        assert out[key]["step"] == (MNIST_BATCHES + 1) * case["epochs"]
        assert out[key]["ahead"] == ["None", ["eval_step", "multi_step"]]


def test_prefetch_windows_under_a_mesh_stacks_this_ranks_rows(ranks):
    """Under ``{dp: 2}``: 3 batches of 4 in windows of 2; each window the
    rank's 2 rows of every batch stacked ``[K, 2, ...]`` on the mesh's
    device, the tail padded with zeros and its mask ``[1, 0]``."""
    arrays = _cases()["resnet"]["train"]
    for rank, out in enumerate(ranks):
        got = out["prefetch_windows"]
        assert [w[0] for w in got] == [2, 1]
        assert [w[5] for w in got] == [[1.0, 1.0], [1.0, 0.0]]
        for i, (n, shape, device, sums, labels, _) in enumerate(got):
            assert shape == [2, 2, 32, 32, 3] and device == "cpu"
            for j in range(2):
                b = 2 * i + j
                rows = slice(b * RESNET_BATCH + 2 * rank,
                             b * RESNET_BATCH + 2 * rank + 2)
                if j < n:
                    want_l = arrays["label"][rows].tolist()
                    want_s = arrays["image"][rows].astype(
                        np.float64).sum(axis=(1, 2, 3)).tolist()
                else:
                    want_l, want_s = [0, 0], [0.0, 0.0]
                assert labels[j] == want_l
                np.testing.assert_allclose(sums[j], want_s, rtol=1e-12)


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


def test_windows_and_compile_ahead_take_a_mesh():
    """``fit`` under a mesh of two ranks takes windows and compile-ahead
    (held to JAX on 2 gloo ranks above and in test_torch_window_mesh.py):
    on an empty dataset the window is built on the route without graphs
    and nothing runs, and compile-ahead finds nothing to warm.  MNIST and
    ResNet under tp, sp, pp and ep are held to one process in
    tests/test_torch_encoder_mesh.py.  A Trainer's device must be its
    mesh's."""
    _, params, mcfg, _ = mnist_models(0)
    dp2 = _fake_mesh({"dp": 2})
    t = trainer.Trainer(functools.partial(mnist.loss_fn, config=mcfg),
                        optimizers.sgd(0.1), mesh=dp2, device="cpu",
                        init_fn=lambda _: bridge.mnist_to_torch(
                            params, device="cpu"))
    t.init_state(None)
    for kw in ({"steps_per_dispatch": 2},
               {"steps_per_dispatch": 2, "compile_ahead": True},
               {"compile_ahead": True}):
        hist = t.fit(list, **kw)
        assert int(t.state.step) == 0, kw
        assert set(hist.history) == {"epoch_seconds"}, kw
        assert t.compile_plan is None, kw
    window = t._multi_steps[2]
    assert window.eager and window.captures == 0
    with pytest.raises(ValueError, match="not the mesh's device"):
        trainer.Trainer(mnist.loss_fn, optimizers.sgd(0.1),
                        mesh=_one_rank_mesh(), device="cuda")
