"""The port's record pipeline (``cloud_tpu_torch.training.records``) against the JAX package's, on the CPU.

* crc32c: the RFC 3720 vectors through the native library and the
  pure-Python table, which agree on arbitrary data;
* framing: files the port writes are byte-identical to the reference's
  for the same payloads, and each side reads the other's; corruption and
  truncation are detected on both read paths;
* codecs: tensor records and ``tf.train.Example`` bytes equal the
  reference's (the TF golden bytes included);
* ``RecordDataset``: batch order, per-host file shards, record striding,
  the shuffle buffer, ``drop_remainder`` and ordered parallel decode equal
  the reference's for the same files and seed, over two epochs; the
  ``state_dict`` fast-forward replays the uninterrupted stream;
* ``Trainer.fit`` over a ``RecordDataset`` with prefetch, and a mid-epoch
  checkpoint whose restore resumes at exactly the uninterrupted run's
  next batch (losses equal, params bit for bit).
"""

import functools

import numpy as np
import pytest
import torch

from cloud_tpu.training import records as jax_records
from cloud_tpu_torch.models import mnist
from cloud_tpu_torch import bridge
from cloud_tpu_torch.training import (checkpoint, optimizers, records,
                                      trainer)

torch.set_num_threads(1)


@pytest.fixture(params=["native", "python"])
def backend(request, monkeypatch):
    """The port's records module with its native library, or with the
    pure-Python crc32c and framing loop."""
    if request.param == "native":
        assert records._native() is not None, "the host has no C++ toolchain"
    else:
        monkeypatch.setattr(records, "_native_lib", None)
        monkeypatch.setattr(records, "_native_tried", True)
    return request.param


def _write_range(module, tmp_path, *, num_files, per_file, stem="train"):
    """File j holds examples [j*per_file, (j+1)*per_file) as {"x": i}."""
    paths, idx = [], 0
    for j in range(num_files):
        path = str(tmp_path / f"{stem}-{j:03d}.rec")
        with module.RecordWriter(path) as w:
            for _ in range(per_file):
                w.write(module.encode_tensor_record(
                    {"x": np.array([idx], np.int64),
                     "y": np.full((2, 3), idx, np.float32)}))
                idx += 1
        paths.append(path)
    return paths


def test_crc32c_vectors(backend):
    assert records.crc32c(b"") == 0x00000000
    assert records.crc32c(b"123456789") == 0xE3069283
    assert records.crc32c(bytes(32)) == 0x8A9136AA


def test_native_and_python_crc_agree():
    assert records._native() is not None
    rng = np.random.default_rng(0)
    for n in (1, 7, 8, 9, 63, 64, 65, 1000, 4097):
        buf = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert records.crc32c(buf) == records._crc32c_python(buf)
        assert records.crc32c(buf) == jax_records._crc32c_python(buf)
        assert records.masked_crc32c(buf) == jax_records.masked_crc32c(buf)


def test_files_equal_the_reference_byte_for_byte(backend, tmp_path):
    payloads = [b"hello", b"", b"x" * 1000,
                np.random.default_rng(1).bytes(70000)]
    ours, theirs = str(tmp_path / "port.rec"), str(tmp_path / "jax.rec")
    with records.RecordWriter(ours) as w:
        for p in payloads:
            w.write(p)
    with jax_records.RecordWriter(theirs) as w:
        for p in payloads:
            w.write(p)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert list(records.read_records(theirs, verify=True)) == payloads
    assert list(jax_records.read_records(ours, verify=True)) == payloads


def test_corruption_and_truncation_detected(backend, tmp_path):
    path = str(tmp_path / "a.rec")
    with records.RecordWriter(path) as w:
        w.write(b"payload-bytes")
        w.write(b"second")
    good = open(path, "rb").read()
    data = bytearray(good)
    data[14] ^= 0xFF  # a payload byte
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        list(records.read_records(path, verify=True))
    # Unverified, the corrupt payload comes back without raising.
    assert len(list(records.read_records(path))) == 2
    data = bytearray(good)
    data[3] ^= 0x01  # the length's crc no longer matches
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        list(records.read_records(path, verify=True))
    open(path, "wb").write(good[:-3])  # the last record cut short
    with pytest.raises(ValueError, match="truncated"):
        list(records.read_records(path))


def test_codecs_equal_the_reference():
    tensors = {"image": np.arange(12, dtype=np.float32).reshape(3, 4),
               "label": np.int64(7), "mask": np.ones((5,), np.bool_)}
    payload = records.encode_tensor_record(tensors)
    assert payload == jax_records.encode_tensor_record(tensors)
    for got in (records.decode_tensor_record(payload),
                jax_records.decode_tensor_record(payload)):
        for k, v in tensors.items():
            np.testing.assert_array_equal(got[k], v)
            assert got[k].dtype == np.asarray(v).dtype
    features = {"floats": np.array([1.5, -2.25, 0.0], np.float32),
                "ints": np.array([1, -7, 2**40], np.int64),
                "raw": b"\x00\x01binary", "text": "hello"}
    example = records.encode_example(features)
    assert example == jax_records.encode_example(features)
    decoded = records.decode_example(example)
    np.testing.assert_array_equal(decoded["floats"], features["floats"])
    np.testing.assert_array_equal(decoded["ints"], features["ints"])
    assert decoded["raw"] == [b"\x00\x01binary"]
    assert decoded["text"] == [b"hello"]
    # tf.train.Example(features={"a": Int64List([3])}), TF's own bytes.
    golden = bytes.fromhex("0a0c0a0a0a016112051a030a0103")
    assert records.encode_example({"a": np.array([3], np.int64)}) == golden
    assert records.decode_example(golden)["a"].tolist() == [3]


#: RecordDataset arguments -> (num_files, per_file); hosts given by
#: ``process_index``/``process_count`` (several means one run a host).
DATASETS = {
    "in order": ({"batch_size": 4}, (2, 6)),
    "remainder kept": ({"batch_size": 4, "drop_remainder": False}, (1, 10)),
    "file shards": ({"batch_size": 2, "process_count": 2}, (4, 4)),
    "record striding": ({"batch_size": 2, "process_count": 3}, (1, 12)),
    "shuffle": ({"batch_size": 4, "shuffle_buffer": 8, "seed": 1}, (2, 8)),
    "shuffle shards": ({"batch_size": 2, "shuffle_buffer": 4, "seed": 5,
                        "process_count": 2}, (4, 6)),
    "decode threads": ({"batch_size": 4, "decode_threads": 4}, (2, 16)),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_equals_the_reference(name, tmp_path):
    kwargs, (num_files, per_file) = DATASETS[name]
    kwargs = dict(kwargs)
    _write_range(records, tmp_path, num_files=num_files, per_file=per_file)
    hosts = kwargs.pop("process_count", None)
    pattern = str(tmp_path / "*.rec")
    seen = []
    for index in range(hosts or 1):
        shard = ({"shard_by_process": False} if hosts is None else
                 {"process_index": index, "process_count": hosts})
        ours = records.RecordDataset(pattern, **kwargs, **shard)
        theirs = jax_records.RecordDataset(pattern, **kwargs, **shard)
        assert ours.shard_files == theirs.shard_files
        for epoch in range(2):  # two epochs: the shuffle is keyed by epoch
            got, want = list(ours()), list(theirs())
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
            if epoch == 0:
                seen.extend(int(v) for b in got for v in b["x"][:, 0])
    if "shuffle_buffer" not in kwargs and hosts:
        # Disjoint host shards that cover the files.
        assert sorted(seen) == sorted(set(seen))


@pytest.mark.parametrize("shuffle_buffer", [0, 8])
def test_state_dict_fast_forward(shuffle_buffer, tmp_path):
    _write_range(records, tmp_path, num_files=2, per_file=16)

    def build(module):
        return module.RecordDataset(str(tmp_path / "*.rec"), batch_size=4,
                                    shuffle_buffer=shuffle_buffer, seed=3,
                                    shard_by_process=False)

    full = build(records)
    epochs = [[b["x"] for b in full()] for _ in range(2)]
    assert full.state_dict() == {"epoch": 2, "seed": 3}
    for module in (records, jax_records):
        resumed = build(module)
        resumed.load_state_dict({"epoch": 1, "batches_consumed": 3,
                                 "seed": 3})
        got = [b["x"] for b in resumed()]
        assert len(got) == len(epochs[1]) - 3
        for want, have in zip(epochs[1][3:], got):
            np.testing.assert_array_equal(want, have)


def test_gcs_paths_name_the_cloud_layers(tmp_path):
    """``gs://`` record paths run through an injected storage client (a
    directory-backed fake): ``write_records`` uploads each shard on close,
    ``read_records`` reads it back, and ``RecordDataset`` over a ``gs://``
    glob yields the batches it yields over the same files on a local
    path (a sidecar object under the prefix is not read)."""
    from helpers.torch_gcs_fake import DirectoryStorage

    storage = DirectoryStorage(str(tmp_path / "bucket"))
    rng = np.random.default_rng(0)
    examples = [{"x": rng.normal(size=(3,)).astype(np.float32)}
                for _ in range(10)]
    for where, client in (("gs://b/recs", storage),
                          (str(tmp_path / "local"), None)):
        records.write_records(f"{where}/train-{{shard}}.rec", iter(examples),
                              num_shards=2, storage_client=client)
    storage.bucket("b").blob("recs/train-index.json").upload_from_string(
        b"{}")
    assert storage.objects("b") == ["recs/train-0.rec", "recs/train-1.rec",
                                    "recs/train-index.json"]
    assert [records.decode_tensor_record(p)["x"].tolist() for p in
            records.read_records("gs://b/recs/train-0.rec", verify=True,
                                 storage_client=storage)] == [
        e["x"].tolist() for e in examples[::2]]

    def batches(pattern, client):
        ds = records.RecordDataset(pattern, 3, shuffle_buffer=4, seed=1,
                                   shard_by_process=False, verify=True,
                                   storage_client=client)
        return ds.files, [b["x"] for _ in range(2) for b in ds()]

    files, got = batches("gs://b/recs/train-*.rec", storage)
    assert files == ["gs://b/recs/train-0.rec", "gs://b/recs/train-1.rec"]
    _, want = batches(str(tmp_path / "local" / "train-*.rec"), None)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _mnist_records(tmp_path, n=48, files=2):
    rng = np.random.default_rng(0)
    examples = ({"image": rng.normal(size=(784,)).astype(np.float32),
                 "label": np.int64(rng.integers(0, 10))} for _ in range(n))
    return records.write_records(str(tmp_path / "mnist-{shard}.rec"),
                                 examples, num_shards=files)


def _mnist_trainer():
    cfg = mnist.MnistConfig(hidden_dim=16)
    tr = trainer.Trainer(
        functools.partial(mnist.loss_fn, config=cfg, device="cpu"),
        optimizers.sgd(0.1),
        init_fn=lambda gen: bridge.init_mnist(cfg, gen, device="cpu"),
        device="cpu")
    tr.init_state(torch.Generator().manual_seed(0))
    return tr


class _Losses(trainer.Callback):
    def __init__(self):
        self.losses = {}

    def on_step_end(self, step, logs, tr):
        self.losses[step] = float(logs["loss"])


def test_fit_resumes_exactly_once_over_records(tmp_path):
    """A 2-file, shuffle-buffered RecordDataset through ``fit`` with
    prefetch; a run restored from its checkpoint at step 9 (inside the
    first 12-batch epoch) continues at the uninterrupted run's next
    batch."""
    paths = _mnist_records(tmp_path)

    def dataset():
        return records.RecordDataset(paths, batch_size=4, shuffle_buffer=16,
                                     seed=11)

    control, seen = _mnist_trainer(), _Losses()
    control.fit(dataset(), epochs=2, callbacks=[seen], prefetch=2)
    assert sorted(seen.losses) == list(range(1, 25))

    ckpt = str(tmp_path / "ckpt")
    first = _mnist_trainer()
    first.fit(dataset(), epochs=2, prefetch=2,
              callbacks=[checkpoint.CheckpointCallback(
                  ckpt, every_n_steps=9, resume_data=True, device="cpu"),
                  trainer.LambdaCallback(on_step_end=lambda s, l, tr: setattr(
                      tr, "stop_training", s >= 9))])
    resumed, got = _mnist_trainer(), _Losses()
    resumed.fit(dataset(), epochs=2, prefetch=2, callbacks=[
        checkpoint.CheckpointCallback(ckpt, every_n_steps=100,
                                      resume_data=True, device="cpu"), got])
    assert sorted(got.losses) == list(range(10, 25))
    assert all(got.losses[s] == seen.losses[s] for s in got.losses)
    for a, b in zip(bridge.leaves(resumed.state.params),
                    bridge.leaves(control.state.params)):
        assert torch.equal(a.detach(), b.detach())
