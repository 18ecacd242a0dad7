"""The port's cloud_fit (``cloud_tpu_torch.cloud_fit``) against the JAX
package's, on the CPU.

The port's counterpart of every case of ``tests/unit/test_cloud_fit.py``:
the asset round trip, the client's guards, the submit side (a dry run:
the assets, the Dockerfile's shim entry point, which imports the port's
``remote``), ``remote.run`` from the assets (a cloudpickled callback
runs, ``history.json`` and the checkpoint land), accumulation and
stochastic steps, a restore across a stochastic flip (both ways), a
step-0 uploaded
state replacing the fresh init, and a restore of an existing state.  And:

* JAX's ``remote.run`` and the port's on the same ``train_data.npz`` and
  ``fit_kwargs.json``, an MNIST spec whose ``init_fn`` returns the JAX
  weights (bridged on the port's side): the Histories' losses within
  1e-4;
* ``remote.run`` on 2 gloo ranks under ``{dp: 2}`` and ``{fsdp: 2}``: the
  History equals the one-process run's (losses within 1e-4), only rank 0
  writes ``history.json`` (rank 1's goes to a throwaway directory), and
  the sharded checkpoint verifies and restores into one process equal to
  the ranks' gathered parameters;
* a ``gs://`` ``state/`` propagates the checkpoint's refusal (it names
  ROADMAP.md A.6) instead of silently starting fresh, while any other
  restore error still logs and starts fresh;
* the example's dry run (``tests/helpers/torch_cloud_fit_example.py``).
"""

import functools
import json
import os
import pathlib
import sys

import cloudpickle
import numpy as np
import pytest
import torch

import cloud_tpu_torch
from cloud_tpu_torch import bridge
from cloud_tpu_torch.cloud_fit import client, remote, serialization
from cloud_tpu_torch.models import mnist
from cloud_tpu_torch.parallel import MeshSpec
from cloud_tpu_torch.training import Trainer, checkpoint, optimizers
from cloud_tpu_torch.training import data as data_lib
from cloud_tpu_torch.training.trainer import Callback
from helpers.torch_port import mnist_models, run_ranks
from helpers.torch_sigterm import sigterm_restored  # noqa: F401

torch.set_num_threads(1)

# The spec's closures and the callbacks below are pickled by value, so a
# rank process that cannot import this module can load them.
cloudpickle.register_pickle_by_value(sys.modules[__name__])

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = mnist.MnistConfig(hidden_dim=16)


def _init(generator, params=None):
    if params is not None:
        return bridge.mnist_to_torch(params, device="cpu")
    return bridge.init_mnist(CFG, generator, device="cpu")


def make_spec(**kw):
    fields = dict(
        loss_fn=functools.partial(mnist.loss_fn, config=CFG, device="cpu"),
        optimizer=optimizers.adam(1e-2, mu_dtype=None),
        init_fn=_init,
        logical_axes=mnist.param_logical_axes(CFG),
    )
    fields.update(kw)
    return serialization.TrainerSpec(**fields)


def make_data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(n, 784)).astype(np.float32),
            "label": rng.integers(0, 10, n)}


class RecordingCallback(Callback):
    """Cloudpickled through the asset store; proves the round trip."""

    def __init__(self, marker_path):
        self.marker_path = marker_path

    def on_epoch_end(self, epoch, logs, trainer):
        with open(self.marker_path, "a") as f:
            f.write(f"epoch{epoch}:{logs['loss']:.4f}\n")


def _trainer(spec, seed=0):
    t = Trainer(spec.loss_fn, spec.optimizer, init_fn=spec.init_fn,
                stochastic=spec.stochastic, device="cpu")
    t.init_state(torch.Generator().manual_seed(seed))
    return t


def _save(state, directory, step):
    manager = checkpoint.CheckpointManager(str(directory), device="cpu")
    manager.save(step, state)
    manager.wait()
    manager.close()


def _one_rank_mesh():
    return MeshSpec({}).build(devices=["cpu"])


# --- serialization ----------------------------------------------------------


def test_round_trip(tmp_path):
    data = make_data()
    serialization.serialize_assets(
        str(tmp_path), make_spec(), data, validation_data=make_data(16),
        callbacks=[RecordingCallback("/unused")],
        fit_kwargs={"epochs": 2, "batch_size": 8})
    spec2, train2, val2, cbs2, kwargs2 = serialization.deserialize_assets(
        str(tmp_path))
    np.testing.assert_array_equal(train2["image"], data["image"])
    assert val2["image"].shape == (16, 784)
    assert isinstance(cbs2[0], RecordingCallback)
    assert kwargs2 == {"epochs": 2, "batch_size": 8}
    assert sorted(os.listdir(tmp_path / serialization.ASSET_DIR)) == [
        "callbacks.pkl", "fit_kwargs.json", "train_data.npz", "trainer.pkl",
        "validation_data.npz"]
    params = spec2.init_fn(torch.Generator().manual_seed(0))
    loss, _ = spec2.loss_fn(params, {
        "image": torch.as_tensor(train2["image"][:4]),
        "label": torch.as_tensor(train2["label"][:4])})
    assert np.isfinite(float(loss))


def test_missing_validation_is_none(tmp_path):
    serialization.serialize_assets(str(tmp_path), make_spec(), make_data(8))
    _, _, val, _, _ = serialization.deserialize_assets(str(tmp_path))
    assert val is None


class _Blob:
    def __init__(self, store, name):
        self.store, self.name = store, name

    def upload_from_string(self, data):
        self.store[self.name] = bytes(data)

    def download_as_bytes(self):
        if self.name not in self.store:
            raise type("NotFound", (Exception,), {})(self.name)
        return self.store[self.name]


class _FakeStorage:
    def __init__(self):
        self.store = {}

    def bucket(self, bucket):
        client_self = self

        class _Bucket:
            def blob(self, name):
                return _Blob(client_self.store, f"{bucket}/{name}")

        return _Bucket()


def test_gcs_round_trip_through_an_injected_client():
    storage = _FakeStorage()
    serialization.serialize_assets("gs://b/run", make_spec(), make_data(8),
                                   fit_kwargs={"epochs": 1},
                                   storage_client=storage)
    assert sorted(storage.store) == [
        f"b/run/training_assets/{n}" for n in (
            "callbacks.pkl", "fit_kwargs.json", "train_data.npz",
            "trainer.pkl")]
    _, train, val, _, kwargs = serialization.deserialize_assets(
        "gs://b/run", storage_client=storage)
    assert val is None and kwargs == {"epochs": 1}
    np.testing.assert_array_equal(train["label"], make_data(8)["label"])


# --- the client's guards and the submit side --------------------------------


def test_rejects_non_spec(tmp_path):
    with pytest.raises(ValueError, match="TrainerSpec"):
        client.cloud_fit(object(), str(tmp_path), train_data=make_data())


def test_rejects_generator_data(tmp_path):
    with pytest.raises(ValueError, match="numpy arrays"):
        client.cloud_fit(make_spec(), str(tmp_path),
                         train_data=(x for x in range(3)))


def test_rejects_bad_batch_size(tmp_path):
    with pytest.raises(ValueError, match="batch_size"):
        client.cloud_fit(make_spec(), str(tmp_path), train_data=make_data(),
                         batch_size=0, dry_run=True)
    with pytest.raises(ValueError, match="exceeds"):
        client.cloud_fit(make_spec(), str(tmp_path), train_data=make_data(),
                         batch_size=128, dry_run=True)
    with pytest.raises(ValueError, match="same leading dimension"):
        client.cloud_fit(make_spec(), str(tmp_path), train_data={
            "image": np.zeros((4, 784), np.float32),
            "label": np.zeros(3, np.int64)}, batch_size=2)


def test_submit_side(tmp_path, monkeypatch):
    monkeypatch.setenv("GOOGLE_CLOUD_PROJECT", "proj")
    from cloud_tpu_torch.core import run as run_lib

    submitted = {}
    real_run = run_lib.run

    def recording_run(**kw):
        submitted.update(kw)
        return real_run(**kw)

    monkeypatch.setattr(run_lib, "run", recording_run)
    report = cloud_tpu_torch.cloud_fit(
        make_spec(), str(tmp_path / "remote"), train_data=make_data(),
        epochs=1, batch_size=8, dry_run=True)
    assert os.path.isdir(tmp_path / "remote" / "training_assets")
    assert "cloud_fit_entry.py" in report.dockerfile
    node = next(iter(report.node_requests.values()))
    assert node["acceleratorType"] == "v5litepod-8"
    from cloud_tpu_torch.core import containerize

    argv = containerize.entrypoint_argv(report.dockerfile)
    assert "cloud_tpu_torch.core.bootstrap" in argv
    # The shim the image runs is the one cloud_fit handed run().
    shim = pathlib.Path(submitted["entry_point"])
    assert shim.name == "cloud_fit_entry.py"
    text = shim.read_text()
    assert "from cloud_tpu_torch.cloud_fit import remote" in text
    assert repr(str(tmp_path / "remote")) in text


def test_parallelism_hints_reach_the_plan(tmp_path):
    from cloud_tpu_torch.parallel import planner

    report = client.cloud_fit(
        make_spec(parallelism_hints=planner.ParallelismHints(dp=2, fsdp=2)),
        str(tmp_path), train_data=make_data(), batch_size=8,
        chief_config=cloud_tpu_torch.COMMON_MACHINE_CONFIGS["TPU_V5E_4"],
        docker_config=__import__(
            "cloud_tpu_torch.core.containerize",
            fromlist=["DockerConfig"]).DockerConfig(image="gcr.io/p/i:0"),
        dry_run=True)
    sizes = {k: v for k, v in report.mesh_plan.spec.sizes.items() if v > 1}
    assert sizes == {"dp": 2, "fsdp": 2}


# --- the server side --------------------------------------------------------


def test_remote_run_trains_from_assets(tmp_path):
    marker = tmp_path / "marker.txt"
    serialization.serialize_assets(
        str(tmp_path / "r"), make_spec(), make_data(),
        validation_data=make_data(16),
        callbacks=[RecordingCallback(str(marker))],
        fit_kwargs={"epochs": 2, "batch_size": 8})
    history = remote.run(str(tmp_path / "r"), mesh=_one_rank_mesh())
    assert len(history.history["loss"]) == 2
    lines = marker.read_text().strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("epoch0:")
    out = tmp_path / "r" / "output"
    saved = json.loads((out / "history.json").read_text())
    assert "val_loss" in saved
    manager = checkpoint.CheckpointManager(str(out / "checkpoint"),
                                           device="cpu")
    assert manager.steps() == [16] and manager.verify(16) == "verified"


def test_remote_run_honors_accum_and_stochastic(tmp_path):
    def loss_with_rng(params, batch, rng=None):
        # Stochastic mode hands the loss a key; MNIST has no dropout.
        return mnist.loss_fn(params, batch, config=CFG, device="cpu")

    spec = make_spec(loss_fn=loss_with_rng, stochastic=True, accum_steps=2)
    serialization.serialize_assets(str(tmp_path / "r"), spec, make_data(),
                                   fit_kwargs={"epochs": 2, "batch_size": 8})
    history = remote.run(str(tmp_path / "r"), device="cpu")
    losses = history.history["loss"]
    assert len(losses) == 2 and losses[-1] < losses[0]
    final = checkpoint.CheckpointManager(
        str(tmp_path / "r" / "output" / "checkpoint"), device="cpu")
    restored = final.restore(final.latest_step())
    assert restored.rng is not None  # the stochastic chain was saved


def test_restore_survives_stochastic_flip(tmp_path):
    def loss_with_rng(params, batch, rng=None):
        return mnist.loss_fn(params, batch, config=CFG, device="cpu")

    spec = make_spec(loss_fn=loss_with_rng, stochastic=True)
    serialization.serialize_assets(str(tmp_path / "r"), spec, make_data(),
                                   fit_kwargs={"epochs": 1, "batch_size": 8})
    # Pre-train DETERMINISTICALLY (rng=None) and save.
    pre = _trainer(make_spec())
    pre.fit(data_lib.ArrayDataset(make_data(), 8), epochs=1)
    pre_steps = int(pre.state.step)
    assert pre_steps > 0
    _save(pre.state, tmp_path / "r" / "state", pre_steps)
    remote.run(str(tmp_path / "r"), device="cpu")
    assert json.loads((tmp_path / "r" / "output" / "history.json")
                      .read_text())
    final = checkpoint.CheckpointManager(
        str(tmp_path / "r" / "output" / "checkpoint"), device="cpu")
    assert final.latest_step() == 2 * pre_steps  # resumed, not restarted


def test_restore_survives_the_other_stochastic_flip(tmp_path):
    """A stochastic checkpoint resumes a deterministic spec: the saved
    rng chain is skipped, the rest restored."""
    def loss_with_rng(params, batch, rng=None):
        return mnist.loss_fn(params, batch, config=CFG, device="cpu")

    serialization.serialize_assets(str(tmp_path / "r"), make_spec(),
                                   make_data(),
                                   fit_kwargs={"epochs": 1, "batch_size": 8})
    pre = _trainer(make_spec(loss_fn=loss_with_rng, stochastic=True))
    pre.fit(data_lib.ArrayDataset(make_data(), 8), epochs=1)
    assert pre.state.rng is not None
    _save(pre.state, tmp_path / "r" / "state", int(pre.state.step))
    server = _trainer(make_spec())
    assert remote._maybe_restore(server, str(tmp_path / "r" / "state"))
    assert server.state.rng is None
    assert int(server.state.step) == int(pre.state.step)
    for got, want in zip(bridge.leaves(server.state.params),
                         bridge.leaves(pre.state.params)):
        assert torch.equal(got, want)


def test_step0_uploaded_state_replaces_fresh_init(tmp_path):
    spec = make_spec()
    uploaded = _trainer(spec, seed=42).state
    _save(uploaded, tmp_path / "state", 0)
    server = _trainer(spec, seed=0)
    fresh = [p.detach().clone() for p in bridge.leaves(server.state.params)]
    assert remote._maybe_restore(server, str(tmp_path / "state"))
    got = bridge.leaves(server.state.params)
    for g, w in zip(got, bridge.leaves(uploaded.params)):
        assert torch.equal(g, w)
    assert any(not torch.equal(g, f) for g, f in zip(got, fresh))
    # The user's upload is never moved, whatever happens to it.
    assert os.listdir(tmp_path / "state") == ["0"]


def test_remote_run_restores_existing_state(tmp_path):
    spec = make_spec()
    serialization.serialize_assets(str(tmp_path / "r"), spec, make_data(),
                                   fit_kwargs={"epochs": 1, "batch_size": 8})
    pre = _trainer(spec)
    pre.fit(data_lib.ArrayDataset(make_data(), 8), epochs=1)
    pre_steps = int(pre.state.step)
    _save(pre.state, tmp_path / "r" / "state", pre_steps)
    history = remote.run(str(tmp_path / "r"), device="cpu")
    assert history is not None
    final = checkpoint.CheckpointManager(
        str(tmp_path / "r" / "output" / "checkpoint"), device="cpu")
    assert final.latest_step() == 2 * pre_steps


def test_a_gcs_state_propagates_the_refusal(tmp_path):
    """A ``gs://`` ``state/`` restores through the run's storage client (a
    directory-backed fake) into the fresh state, bit for bit, and is never
    moved; an empty one starts fresh."""
    from helpers.torch_gcs_fake import DirectoryStorage

    storage = DirectoryStorage(str(tmp_path / "bucket"))
    spec = make_spec()
    uploaded = _trainer(spec, seed=42).state
    manager = checkpoint.CheckpointManager(
        "gs://bucket/run/state", device="cpu", storage_client=storage)
    manager.save(3, uploaded)
    manager.wait()
    before = storage.objects("bucket")
    server = _trainer(spec, seed=0)
    assert remote._maybe_restore(server, "gs://bucket/run/state", storage)
    for got, want in zip(bridge.leaves(server.state.params),
                         bridge.leaves(uploaded.params)):
        assert torch.equal(got, want)
    assert storage.objects("bucket") == before
    fresh = _trainer(spec, seed=0)
    assert not remote._maybe_restore(fresh, "gs://bucket/other/state",
                                     storage)


def test_another_restore_error_starts_fresh(tmp_path, caplog):
    spec = make_spec()
    _save(_trainer(spec, seed=42).state, tmp_path / "state", 0)
    # A damaged index: the restore raises, the walk-back finds nothing.
    (tmp_path / "state" / "0" / checkpoint.INDEX_NAME).write_text("{")
    os.remove(tmp_path / "state" / "0" / checkpoint.MANIFEST_NAME)
    server = _trainer(spec, seed=0)
    fresh = [p.detach().clone() for p in bridge.leaves(server.state.params)]
    assert remote._maybe_restore(server, str(tmp_path / "state")) is False
    for g, f in zip(bridge.leaves(server.state.params), fresh):
        assert torch.equal(g, f)
    assert "starting fresh" in caplog.text
    assert os.listdir(tmp_path / "state") == ["0"]


# --- against the JAX package ------------------------------------------------


def test_remote_run_equals_jax_on_the_same_assets(tmp_path):
    import jax
    import optax

    from cloud_tpu.cloud_fit import remote as jax_remote
    from cloud_tpu.cloud_fit import serialization as jax_serialization
    from cloud_tpu.models import mnist as jax_mnist

    jax_cfg, params, _, _ = mnist_models(0)
    data, val = make_data(48, seed=1), make_data(16, seed=2)
    kwargs = {"epochs": 2, "batch_size": 8}
    jax_serialization.serialize_assets(
        str(tmp_path / "jax"), jax_serialization.TrainerSpec(
            loss_fn=functools.partial(jax_mnist.loss_fn, config=jax_cfg),
            optimizer=optax.adam(1e-2),
            init_fn=lambda _: jax.tree_util.tree_map(jax.numpy.asarray,
                                                     params)),
        data, validation_data=val, fit_kwargs=kwargs)
    serialization.serialize_assets(
        str(tmp_path / "port"),
        make_spec(init_fn=functools.partial(_init, params=params)), data,
        validation_data=val, fit_kwargs=kwargs)
    for name in ("train_data.npz", "validation_data.npz", "fit_kwargs.json"):
        assert ((tmp_path / "jax" / "training_assets" / name).read_bytes()
                == (tmp_path / "port" / "training_assets" / name)
                .read_bytes())
    want = jax_remote.run(str(tmp_path / "jax"), mesh=None).history
    got = remote.run(str(tmp_path / "port"), device="cpu").history
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)


_RANKS = """
import functools
import os
import tempfile

from cloud_tpu_torch.cloud_fit import remote, serialization
from cloud_tpu_torch.parallel import sharding

ROOT = IN["root"].item()
writes = []
real = serialization._write_bytes


def spy(path, data, storage_client=None):
    writes.append(path)
    return real(path, data, storage_client)


serialization._write_bytes = spy
for sizes in ({"dp": 2}, {"fsdp": 2}):
    name = next(iter(sizes))
    mesh = MeshSpec(sizes).build(devices=["cpu"] * WORLD)
    writes.clear()
    history = remote.run(os.path.join(ROOT, name), mesh=mesh)
    OUT[name] = {"history": history.history,
                 "history_writes": [w for w in writes
                                    if w.endswith("history.json")]}
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("cloud_fit_ranks")
    for name in ("dp", "fsdp", "one"):
        serialization.serialize_assets(
            str(root / name), make_spec(), make_data(),
            validation_data=make_data(16, seed=3),
            fit_kwargs={"epochs": 2, "batch_size": 8})
    outs = run_ranks(_RANKS, 2, files={"root": np.asarray(str(root))})
    one = remote.run(str(root / "one"), device="cpu").history
    return root, outs, one


@pytest.mark.parametrize("axis", ["dp", "fsdp"])
def test_remote_run_on_two_ranks(two_ranks, axis):
    root, outs, one = two_ranks
    for rank, out in enumerate(outs):
        got = out[axis]["history"]
        for key in ("loss", "val_loss", "accuracy"):
            np.testing.assert_allclose(got[key], one[key], rtol=1e-4,
                                       err_msg=key)
        (path,) = out[axis]["history_writes"]
        if rank == 0:
            assert path == str(root / axis / "output" / "history.json")
        else:
            assert not path.startswith(str(root))
    assert json.loads((root / axis / "output" / "history.json").read_text())
    manager = checkpoint.CheckpointManager(
        str(root / axis / "output" / "checkpoint"), device="cpu")
    (step,) = manager.steps()
    assert manager.verify(step) == "verified"
    index = json.loads((root / axis / "output" / "checkpoint" / str(step)
                        / checkpoint.INDEX_NAME).read_text())
    assert index["mesh"] == {axis: 2}
    # MNIST's logical axes cut no dim over dp or fsdp: rank 0 writes all.
    assert all(len(leaf["pieces"]) == 1
               and leaf["pieces"][0]["file"].endswith(".r0.bin")
               for leaf in index["leaves"])
    # Restored into one process, the run continues from the ranks' state.
    server = _trainer(make_spec())
    assert remote._maybe_restore(server, str(root / axis / "output"
                                             / "checkpoint"))
    assert int(server.state.step) == step


def test_cloud_fit_example_dry_run(tmp_path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_cloud_fit_example",
        REPO / "tests" / "helpers" / "torch_cloud_fit_example.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    report = mod.main(remote_dir=str(tmp_path), dry_run=True)
    assert report is not None and not report.submitted
    assert any(tmp_path.iterdir())
    assert "cloud_fit_entry.py" in report.dockerfile
