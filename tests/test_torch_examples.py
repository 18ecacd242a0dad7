"""The port's copies of the golden workloads and example launchers
(``tests/helpers/torch_*``) run, and pass what ``tests/unit/
test_examples.py`` asserts of the JAX package's originals.

* ``torch_mnist_example_using_ctl.py`` (a user-written step, dp over
  every rank) and ``torch_save_and_load.py`` (fit with a checkpoint every
  2 steps, restore into a differently-initialised trainer, resume) in
  this process on the CPU, and on two gloo ranks under the port's
  bootstrap (``local_rig.run_bootstrap``).
* ``torch_generate_text.py`` and ``torch_long_context_ring_attention.py``
  (four ranks, ``sp: 4``): slow, as their originals are.
* Every launcher through the port's ``run(dry_run=True)``: a full
  artifact set, no GPU nodes requested, the workers example planning tp 4
  across two slices, the notebook launcher's converted script.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from cloud_tpu_torch.utils import local_rig

torch.set_num_threads(1)

HELPERS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "helpers")


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.path.insert(0, os.path.dirname(path))
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path.pop(0)
    return module


def _helper(name):
    return os.path.join(HELPERS, name)


def _ok(result):
    assert result.returncode == 0, "\n".join(
        r.stderr[-3000:] for r in result.ranks)
    return result


class TestGoldenWorkloads:
    @pytest.mark.slow
    def test_long_context_ring_example_trains(self):
        result = _ok(local_rig.run_bootstrap(
            _helper("torch_long_context_ring_attention.py"), device="cpu",
            num_processes=4, timeout=900))
        assert "ring-attention training ran end to end" in result.stdout
        assert "mesh: ['sp=4']" in result.stdout

    @pytest.mark.slow
    def test_generate_text_example(self):
        mod = load_module(_helper("torch_generate_text.py"), "tex_generate")
        trainer = mod.main(device="cpu")  # trains (asserted) + samples
        assert set(trainer.texts) == {"greedy", "nucleus", "int8",
                                      "int8+kv"}

    def test_mnist_ctl(self, monkeypatch, tmp_path):
        monkeypatch.setenv("MNIST_CTL_EPOCHS", "1")
        monkeypatch.setenv("MNIST_CTL_SAVE_DIR", str(tmp_path))
        mod = load_module(_helper("torch_mnist_example_using_ctl.py"),
                          "tmnist_ctl")
        loss = mod.main(device="cpu")
        assert np.isfinite(loss)
        saved = np.load(tmp_path / "params.npz")
        assert len(saved.files) > 0

    def test_mnist_ctl_over_two_ranks(self, tmp_path):
        result = _ok(local_rig.run_bootstrap(
            _helper("torch_mnist_example_using_ctl.py"), device="cpu",
            num_processes=2, extra_env={
                "MNIST_CTL_EPOCHS": "1",
                "MNIST_CTL_SAVE_DIR": str(tmp_path)}))
        assert "epoch 0: loss=" in result.stdout
        saved = np.load(tmp_path / "params.npz")
        assert sorted(saved.files) == ["hidden/bias", "hidden/kernel",
                                       "out/bias", "out/kernel"]

    def test_save_and_load(self, monkeypatch, tmp_path):
        monkeypatch.setenv("SAVE_AND_LOAD_DIR", str(tmp_path / "ckpt"))
        mod = load_module(_helper("torch_save_and_load.py"),
                          "tsave_and_load")
        assert mod.main(device="cpu") == str(tmp_path / "ckpt")

    def test_save_and_load_over_two_ranks(self, tmp_path):
        result = _ok(local_rig.run_bootstrap(
            _helper("torch_save_and_load.py"), device="cpu",
            num_processes=2,
            extra_env={"SAVE_AND_LOAD_DIR": str(tmp_path / "ckpt")}))
        assert "resumed from step 4 -> 8" in result.stdout
        index = json.loads((tmp_path / "ckpt" / "4" / "index.json")
                           .read_text())
        assert index["mesh"]["dp"] == 2 and index["processes"] == 2


class TestExampleLaunchers:
    """Every launcher produces a full artifact set under dry_run."""

    @pytest.mark.parametrize(
        "example",
        [
            "torch_call_run_on_script.py",
            # Slow, as the original: a full .ipynb conversion; the
            # dry-run contract stays fast-pinned by
            # test_notebook_dockerfile_points_at_converted_script.
            pytest.param("torch_call_run_on_notebook.py",
                         marks=pytest.mark.slow),
            "torch_call_run_with_cloud_build.py",
            "torch_call_run_with_custom_image.py",
            "torch_call_run_with_workers.py",
            "torch_call_run_with_tuner_search.py",
            "torch_call_run_with_save_and_load.py",
            os.path.join("torch_multi_file_example", "launch.py"),
        ],
    )
    def test_dry_run(self, example):
        mod = load_module(_helper(example),
                          "texample_" + os.path.basename(example)[:-3])
        report = mod.main(dry_run=True)
        assert report.dockerfile and report.dockerfile.startswith("FROM ")
        assert report.node_requests
        assert not report.submitted
        # TPU jobs must never request GPU nodes (the reference's contract).
        for node in report.node_requests.values():
            assert "guestAccelerators" not in str(node)

    def test_workers_example_mesh_spans_slices(self):
        mod = load_module(_helper("torch_call_run_with_workers.py"),
                          "tex_workers")
        report = mod.main(dry_run=True)
        assert len(report.node_requests) == 2  # chief slice + 1 worker slice
        assert report.mesh_plan is not None
        assert report.mesh_plan.spec.sizes.get("tp") == 4

    def test_notebook_dockerfile_points_at_converted_script(self):
        mod = load_module(_helper("torch_call_run_on_notebook.py"), "tex_nb")
        report = mod.main(dry_run=True)
        assert "torch_mnist_example_using_fit.py" in report.dockerfile
