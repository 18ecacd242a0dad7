"""The port's distributed self-check CLI (``python -m
cloud_tpu_torch.parallel.selfcheck``) as real processes over the
``CLOUD_TPU_*`` env contract, launched by the JAX package's own rig
(``cloud_tpu.utils.local_rig.launch_process_fleet`` with the port's
module; ``CLOUD_TPU_SELFCHECK_FORCE_CPU=1``: the CPU over gloo, one
device a rank), asserting what ``tests/unit/test_multiprocess.py``
asserts of the JAX package's CLI in every mode:

- ``basic`` on 2 ranks: the topology, ``global_sum == expected_sum``,
  one finite loss on every rank, and that loss the JAX package's sharded
  MNIST step's (``create_sharded_state`` + ``make_train_step(mesh=,
  logical_axes=)`` under a ``dp`` mesh of two devices) on the same
  weights and the two ranks' rows, within 1e-4;
- ``transformer``, ``pp``, ``tp``, ``sp`` and ``ulysses`` on 4 ranks:
  the mesh reported (sized from 4 ranks as the JAX CLI sizes it from the
  device count), ``ok`` and one finite loss on every rank;
  ``ulysses_eligible`` true;
- ``records`` on 2 ranks: the shards disjoint and complete.

And the failure reports: ``tp`` on 2 ranks is ``mesh_too_small``, and a
coordinator nobody serves fails within the init timeout, each a JSON
line with ``ok: false`` and exit code 1.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from cloud_tpu.utils import local_rig

MODULE = "cloud_tpu_torch.parallel.selfcheck"
#: Each model-parallel mode's mesh on 4 ranks (size-1 axes left out).
MESHES = {"transformer": {"fsdp": 2, "tp": 2}, "pp": {"pp": 2, "tp": 2},
          "tp": {"tp": 4}, "sp": {"sp": 2, "tp": 2},
          "ulysses": {"sp": 2, "tp": 2}}


def _fleet(n, mode, **env):
    return local_rig.launch_process_fleet(
        num_processes=n, devices_per_process=1, module=MODULE, timeout=240,
        extra_env={"CLOUD_TPU_SELFCHECK_MODE": mode, "OMP_NUM_THREADS": "1",
                   **env})


def _report(result):
    for line in reversed(result.stdout.splitlines()):
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        if isinstance(obj, dict):
            return obj
    raise AssertionError(
        f"no JSON report in stdout; rc={result.returncode}\n"
        f"stdout={result.stdout[-2000:]}\nstderr={result.stderr[-2000:]}")


def _clean(results):
    for rank, res in enumerate(results):
        assert res.returncode == 0, (
            f"rank {rank} rc={res.returncode}\n"
            f"stdout={res.stdout[-2000:]}\nstderr={res.stderr[-2000:]}")
    return [_report(res) for res in results]


@pytest.fixture(scope="module")
def basic_fleet():
    return _fleet(2, "basic")


def test_basic_topology_reduction_and_step(basic_fleet):
    reports = _clean(basic_fleet)
    for rank, rep in enumerate(reports):
        assert rep["distributed"] is True
        assert rep["process_index"] == rank
        assert rep["process_count"] == rep["device_count"] == 2
        assert rep["local_device_count"] == 1
        assert rep["platform"] == "cpu"
        # rank 0 contributes 1 on one row of 4, rank 1 contributes 2.
        assert rep["global_sum"] == rep["expected_sum"] == 12.0
        assert rep["ok"] is True
    # Every process computes the same global loss.
    assert len({round(rep["loss"], 5) for rep in reports}) == 1


def test_basic_step_is_the_jax_sharded_mnist_step(basic_fleet):
    import functools

    import jax
    import optax
    import torch

    from cloud_tpu import parallel as jax_parallel
    from cloud_tpu.models import mnist as jax_mnist
    from cloud_tpu.training import train as jax_train
    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import mnist

    reports = _clean(basic_fleet)
    # The ranks' weights (seed 0 on the CPU) and rows (rank r draws from
    # default_rng(r): 2 images, then 2 labels).
    params = bridge.mnist_to_numpy(bridge.init_mnist(
        mnist.MnistConfig(hidden_dim=16), torch.Generator().manual_seed(0),
        device="cpu"))
    images, labels = [], []
    for rank in range(2):
        rng = np.random.default_rng(rank)
        images.append(rng.normal(size=(2, 784)).astype(np.float32))
        labels.append(rng.integers(0, 10, 2))
    cfg = jax_mnist.MnistConfig(hidden_dim=16)
    axes = jax_mnist.param_logical_axes(cfg)
    mesh = jax_parallel.MeshSpec({"dp": 2}).build(jax.devices()[:2])
    with jax_parallel.use_mesh(mesh):
        state = jax_train.create_sharded_state(
            jax.random.PRNGKey(0),
            lambda _: jax.tree_util.tree_map(jax.numpy.asarray, params),
            optax.sgd(0.1), mesh, logical_axes=axes)
        step = jax_train.make_train_step(
            functools.partial(jax_mnist.loss_fn, config=cfg),
            optax.sgd(0.1), logical_axes=axes, mesh=mesh)
        batch = jax_train.shard_batch(
            {"image": np.concatenate(images),
             "label": np.concatenate(labels)}, mesh)
        _, metrics = step(state, batch)
    want = float(metrics["loss"])
    for rep in reports:
        assert abs(rep["loss"] - want) <= 1e-4 * max(1.0, abs(want)), (
            rep["loss"], want)


@pytest.fixture(scope="module")
def model_parallel_fleets():
    return {mode: _fleet(4, mode) for mode in MESHES}


@pytest.mark.parametrize("mode", sorted(MESHES))
def test_model_parallel_mode_on_four_ranks(model_parallel_fleets, mode):
    reports = _clean(model_parallel_fleets[mode])
    losses = set()
    for rep in reports:
        assert rep["ok"] is True and rep["phase"] == "done"
        assert rep["process_count"] == 4
        assert rep["mesh"] == MESHES[mode]
        assert np.isfinite(rep["loss"])
        losses.add(round(rep["loss"], 5))
        if mode == "ulysses":
            assert rep["ulysses_eligible"] is True
    assert len(losses) == 1, f"ranks disagree on the loss: {losses}"


def test_records_shards_disjoint_and_complete(tmp_path):
    from cloud_tpu_torch.training import records

    idx = 0
    for j in range(4):
        with records.RecordWriter(str(tmp_path / f"train-{j}.rec")) as w:
            for _ in range(4):
                w.write(records.encode_tensor_record(
                    {"x": np.array([idx], np.int64)}))
                idx += 1
    reports = _clean(_fleet(2, "records",
                            CLOUD_TPU_SELFCHECK_RECORDS_DIR=str(tmp_path)))
    shards = [set(rep["example_ids"]) for rep in reports]
    assert all(rep["ok"] is True for rep in reports)
    assert shards[0] & shards[1] == set()
    assert sorted(shards[0] | shards[1]) == list(range(16))


def test_tp_mode_on_two_ranks_reports_mesh_too_small():
    for res in _fleet(2, "tp"):
        rep = _report(res)
        assert res.returncode == 1
        assert rep["phase"] == "mesh_too_small" and rep["ok"] is False
        assert "every axis must be >= 1" in rep["error"]


def test_unserved_coordinator_fails_within_the_timeout():
    """Rank 1 of 2 pointed at a port nobody serves: the bounded init
    fails, reported as one JSON line, instead of hanging."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=local_rig.REPO_ROOT,
               CLOUD_TPU_COORDINATOR=f"127.0.0.1:{port}",
               CLOUD_TPU_NUM_PROCESSES="2", CLOUD_TPU_PROCESS_ID="1",
               CLOUD_TPU_SELFCHECK_FORCE_CPU="1",
               CLOUD_TPU_SELFCHECK_TIMEOUT="5")
    start = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", MODULE], env=env,
                          capture_output=True, text=True, timeout=120)
    elapsed = time.monotonic() - start
    rep = _report(proc)
    assert proc.returncode == 1 and rep["ok"] is False
    assert "timed out" in rep["error"], rep["error"]
    assert elapsed < 60, elapsed
