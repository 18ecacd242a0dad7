"""The port's ``gs://`` paths on a directory-backed fake storage client
(``helpers.torch_gcs_fake.DirectoryStorage``), against the JAX package.

* Records: the objects the port's ``RecordWriter`` uploads are the bytes
  the JAX package's uploads on the same fake, and ``RecordDataset`` over
  a ``gs://`` glob yields the JAX dataset's batches.
* Checkpoints: save, list, prune to ``max_to_keep``, restore (with and
  without a template) bit for bit; ``verify()`` reads ``"unmanifested"``,
  ``read_extras()`` is None, nothing is quarantined, and
  ``CheckpointCallback(resume_data=True)`` warns, as the JAX package does
  for a non-local directory; a step whose index object is absent is not
  listed, and the next manager's first save clears its pieces; no
  ``google.cloud`` import happens while a client is injected.
* A state sharded over ``{fsdp: 2}`` on two gloo ranks: each rank uploads
  its pieces to one shared bucket, the chief the index last, and one
  process restores the whole state bit for bit.
* ``cloud_fit``'s ``remote.run`` on a ``gs://`` job directory: assets,
  the output checkpoint and the history all through the client.
"""

import functools
import logging
import sys

import numpy as np
import pytest
import torch

from cloud_tpu.training import records as jax_records
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import mnist
from cloud_tpu_torch.training import (Trainer, checkpoint, data, optimizers,
                                      records)
from cloud_tpu_torch.training.train import TrainState
from helpers.torch_gcs_fake import DirectoryStorage
from helpers.torch_port import run_ranks

torch.set_num_threads(1)


@pytest.fixture
def storage(tmp_path):
    return DirectoryStorage(str(tmp_path / "bucket"))


@pytest.fixture
def no_google_cloud(monkeypatch):
    """Any import of ``google.cloud`` raises ImportError."""
    for name in ("google.cloud", "google.cloud.storage"):
        monkeypatch.setitem(sys.modules, name, None)


def _examples(n=11, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(size=(3,)).astype(np.float32),
             "y": np.int64(i)} for i in range(n)]


def test_record_uploads_equal_the_jax_package(storage, monkeypatch):
    def batches(module):
        ds = module.RecordDataset(
            "gs://b/port/train-*.rec", 2, shuffle_buffer=5, seed=3,
            process_index=1, process_count=2, verify=True,
            storage_client=storage)
        return [b for _ in range(2) for b in ds()]

    # The JAX package imports google.cloud even with a client injected.
    jax_records.write_records("gs://b/jax/train-{shard}.rec",
                              iter(_examples()), num_shards=3,
                              storage_client=storage)
    for name in ("google.cloud", "google.cloud.storage"):
        monkeypatch.setitem(sys.modules, name, None)
    records.write_records("gs://b/port/train-{shard}.rec", iter(_examples()),
                          num_shards=3, storage_client=storage)
    got = batches(records)
    monkeypatch.undo()
    want = batches(jax_records)
    objects = storage.objects("b")
    assert objects == [f"{n}/train-{i}.rec" for n in ("jax", "port")
                       for i in range(3)]
    for i in range(3):
        assert (storage.bucket("b").blob(f"port/train-{i}.rec")
                .download_as_bytes()
                == storage.bucket("b").blob(f"jax/train-{i}.rec")
                .download_as_bytes())
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])


def _state(seed, step=0):
    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(3, 4, generator=gen).bfloat16(),
              "layers": [{"b": torch.randn(5, generator=gen)}]}
    return TrainState(step=torch.tensor(step, dtype=torch.int32),
                      params=params,
                      opt_state={"mu": [torch.randn(4, generator=gen)]})


def test_checkpoints_on_gcs(storage, no_google_cloud):
    manager = checkpoint.CheckpointManager(
        "gs://b/ckpt", max_to_keep=2, device="cpu", storage_client=storage)
    states = {s: _state(s, s) for s in (1, 2, 3)}
    for s, state in states.items():
        assert manager.save(s, state, extras={"data_state": {"s": s}})
    assert not manager.save(2, states[2])  # not ahead of the latest
    manager.wait()
    assert manager.steps() == [2, 3] and manager.latest_step() == 3
    assert all(not o.startswith("ckpt/1/") for o in storage.objects("b"))
    assert manager.verify(3) == "unmanifested"
    assert manager.read_extras(3) is None
    assert not manager.quarantine(3) and manager.steps() == [2, 3]
    restored = manager.restore(template=_state(9))
    for got, want in zip(_leaves(restored), _leaves(states[3])):
        assert got.dtype == want.dtype and torch.equal(got, want)
    whole = manager.restore(2)
    assert torch.equal(whole.params["w"], states[2].params["w"])
    assert not any(o.endswith(checkpoint.MANIFEST_NAME)
                   for o in storage.objects("b"))
    manager.close()
    # A step whose index never landed (a killed write) is not listed, and
    # the next manager's first save clears its pieces.
    storage.bucket("b").blob("ckpt/7/0.r0.bin").upload_from_string(b"xx")
    again = checkpoint.CheckpointManager("gs://b/ckpt", device="cpu",
                                         storage_client=storage)
    assert again.steps() == [2, 3]
    again.save(4, states[3])
    again.wait()
    assert again.steps() == [2, 3, 4]
    assert not any(o.startswith("ckpt/7/") for o in storage.objects("b"))
    # Resume walks to the latest step, as on a local directory.
    tr = _trainer()
    assert checkpoint.resume_trainer_state(tr, _mnist_manager(storage, tr))


def _leaves(state):
    return ([state.step] + bridge.leaves(state.params)
            + bridge.leaves(state.opt_state))


def _trainer():
    cfg = mnist.MnistConfig(hidden_dim=8)
    tr = Trainer(functools.partial(mnist.loss_fn, config=cfg, device="cpu"),
                 optimizers.sgd(0.1),
                 init_fn=lambda gen: bridge.init_mnist(cfg, gen,
                                                       device="cpu"),
                 device="cpu")
    tr.init_state(torch.Generator().manual_seed(0))
    return tr


def _mnist_manager(storage, tr):
    manager = checkpoint.CheckpointManager(
        "gs://b/mnist", device="cpu", storage_client=storage)
    manager.save(5, TrainState(step=torch.tensor(5, dtype=torch.int32),
                               params=tr.state.params,
                               opt_state=tr.state.opt_state))
    manager.wait()
    return manager


def test_resume_data_warns_on_gcs(storage, caplog):
    rng = np.random.default_rng(0)
    arrays = {"image": rng.normal(size=(16, 784)).astype(np.float32),
              "label": rng.integers(0, 10, 16)}
    tr = _trainer()
    with caplog.at_level(logging.WARNING):
        tr.fit(data.ArrayDataset(arrays, 8), epochs=1, callbacks=[
            checkpoint.CheckpointCallback(
                "gs://b/fit", every_n_steps=1, resume_data=True,
                device="cpu", storage_client=storage)])
    assert "iterator state is NOT saved or restored there" in caplog.text
    manager = checkpoint.CheckpointManager("gs://b/fit", device="cpu",
                                           storage_client=storage)
    assert manager.steps() == [1, 2] and manager.read_extras(2) is None


_FSDP_SAVE = """
import functools
sys.path.insert(0, "tests")
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import transformer
from cloud_tpu_torch.parallel import sharding
from cloud_tpu_torch.training import checkpoint, optimizers, train
from helpers.torch_gcs_fake import DirectoryStorage

cfg = transformer.TINY.scaled(dtype=torch.float32, num_layers=2)
mesh = MeshSpec({"fsdp": 2}).build(devices=["cpu"] * 2)
axes = transformer.param_logical_axes(cfg)
tx = optimizers.adamw(1e-3)
state = train.create_sharded_state(
    None, lambda _: bridge.init(cfg, torch.Generator().manual_seed(0),
                                device="cpu"),
    tx, mesh=mesh, logical_axes=axes, device="cpu")
step = train.make_train_step(
    functools.partial(transformer.loss_fn, config=cfg, mesh=mesh), tx,
    mesh=mesh, logical_axes=axes)
tokens = torch.as_tensor(IN["tokens"][RANK * 2:(RANK + 1) * 2])
state, _ = step(state, {"tokens": tokens})
manager = checkpoint.CheckpointManager(
    "gs://b/sharded", device="cpu", storage_client=DirectoryStorage(ROOT),
    layout=checkpoint.StateLayout(mesh, axes))
manager.save(1, state)
manager.wait()
manager.close()
whole = sharding.gather_tree(state.params, axes, mesh)
OUT["local"] = list(state.params["embed"]["table"].shape)
if RANK == 0:
    np.savez(ROOT + "/../whole.npz", **{str(i): t.detach().numpy()
             for i, t in enumerate(bridge.leaves(whole))})
"""


def test_fsdp_ranks_save_to_one_bucket(tmp_path, storage):
    tokens = np.random.default_rng(0).integers(0, 256, (4, 16))
    outs = run_ranks(f"ROOT = {storage.root!r}\n" + _FSDP_SAVE, 2,
                     files={"tokens": tokens})
    assert [o["local"] for o in outs] == [[256, 32]] * 2  # embed on fsdp
    objects = storage.objects("b")
    assert "sharded/1/index.json" in objects
    assert any(o.endswith(".r1.bin") for o in objects)  # rank 1's pieces
    manager = checkpoint.CheckpointManager(
        "gs://b/sharded", device="cpu", storage_client=storage)
    assert manager.steps() == [1] and manager.verify(1) == "unmanifested"
    restored = manager.restore(1)
    with np.load(tmp_path / "whole.npz") as whole:
        got = bridge.leaves(restored.params)
        assert len(got) == len(whole.files)
        for i, leaf in enumerate(got):
            np.testing.assert_array_equal(leaf.numpy(), whole[str(i)])


def test_cloud_fit_runs_a_gcs_job(storage, no_google_cloud):
    from cloud_tpu_torch.cloud_fit import remote, serialization

    cfg = mnist.MnistConfig(hidden_dim=8)
    spec = serialization.TrainerSpec(
        loss_fn=functools.partial(mnist.loss_fn, config=cfg, device="cpu"),
        optimizer=optimizers.sgd(0.1),
        init_fn=functools.partial(bridge.init_mnist, cfg, device="cpu"))
    rng = np.random.default_rng(0)
    arrays = {"image": rng.normal(size=(16, 784)).astype(np.float32),
              "label": rng.integers(0, 10, 16)}
    serialization.serialize_assets("gs://b/job", spec, arrays,
                                   fit_kwargs={"epochs": 1, "batch_size": 8},
                                   storage_client=storage)
    history = remote.run("gs://b/job", storage_client=storage, device="cpu")
    assert len(history.history["loss"]) == 1
    objects = storage.objects("b")
    assert "job/output/history.json" in objects
    assert "job/output/checkpoint/2/index.json" in objects
