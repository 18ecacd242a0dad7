"""The port's local end to end (``tests/integration/test_run_e2e_local.py``
on the port), on the CPU: ``cloud_tpu_torch.run(dry_run=True)`` makes the
artifacts, and the ENTRYPOINT they encode (``python -m
cloud_tpu_torch.core.bootstrap``) runs as a job of real processes through
``cloud_tpu_torch.utils.local_rig`` (gloo ranks on the CPU, asked for
with ``--device=cpu``).

The port's MNIST workload (``tests/helpers/torch_mnist_example.py``, the
copy of ``tests/testdata/mnist_example_using_fit.py``) starts from the
parameters the JAX script's ``t.init_state(jax.random.PRNGKey(0))``
makes (``mnist.init(PRNGKey(0))``, carried across through an npz with
``bridge.mnist_to_torch``).  On 2 gloo ranks its loss history equals the
history of JAX's own bootstrapped script on a 2-device plan within 1e-4
relative (f32); each rank's dataset yields the same shuffled batches as
JAX's, which are that rank's rows.  Also: monitoring enabled with no
project (exit 0), the notebook entry point, the records workload, the
within-script contract, and deploy's real startup script booting a
2-host emulated slice of the port's self-check.
"""

import importlib.util
import json
import os
import pathlib
import textwrap

import jax
import numpy as np
import pytest
import torch

import cloud_tpu_torch
from cloud_tpu.models import mnist as jax_mnist
from cloud_tpu.utils import local_rig as jax_rig
from cloud_tpu_torch.core import containerize
from cloud_tpu_torch.core.containerize import DockerConfig
from cloud_tpu_torch.models import resnet
from cloud_tpu_torch.parallel import mesh as mesh_lib
from cloud_tpu_torch.parallel import planner
from cloud_tpu_torch.utils import local_rig
from helpers.torch_sigterm import sigterm_restored  # noqa: F401

torch.set_num_threads(1)

REPO = pathlib.Path(local_rig.REPO_ROOT)
HELPERS = REPO / "tests" / "helpers"
MNIST = str(HELPERS / "torch_mnist_example.py")
#: Seconds each bootstrapped job may take (its ranks are killed after):
#: a few times a loaded run's, and their sum over this file well under
#: the whole suite's limit.
RIG_TIMEOUT_S = 150
JAX_MNIST = str(REPO / "tests" / "testdata" / "mnist_example_using_fit.py")

#: History keys compared (epoch_seconds is a wall clock).
COMPARED = ("loss", "accuracy", "grad_norm", "val_loss", "val_accuracy")


def _mnist_env(save_dir, params=None):
    env = {"MNIST_EXAMPLE_EPOCHS": "2", "MNIST_EXAMPLE_STEPS": "4",
           "MNIST_EXAMPLE_SAVE_DIR": str(save_dir)}
    if params is not None:
        env["MNIST_EXAMPLE_PARAMS"] = str(params)
    return env


def _jax_init_npz(path):
    params = jax.tree_util.tree_map(
        np.asarray, jax_mnist.init(jax.random.PRNGKey(0)))
    np.savez(path, **{f"{layer}/{leaf}": value
                      for layer, leaves in params.items()
                      for leaf, value in leaves.items()})
    return path


def _ok(result):
    ranks = getattr(result, "ranks", [result])
    assert result.returncode == 0, "\n".join(
        f"rank {i} rc={r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-3000:]}"
        for i, r in enumerate(ranks))


def test_submit_artifacts_then_bootstrap_trains_as_jax(tmp_path):
    report = cloud_tpu_torch.run(
        entry_point=MNIST,
        chief_config=cloud_tpu_torch.COMMON_MACHINE_CONFIGS["TPU"],
        docker_config=DockerConfig(image="gcr.io/p/e2e:t"),
        dry_run=True,
    )
    assert report.dockerfile and report.mesh_plan is not None
    assert not report.submitted
    assert "cloud_tpu_torch.core.bootstrap" in report.dockerfile
    params = _jax_init_npz(tmp_path / "mnist0.npz")
    # The JAX package's bootstrapped script on a 2-device plan (its rig:
    # 2 virtual CPU devices, the plan made over them).
    jax_result = jax_rig.run_bootstrap(
        JAX_MNIST, n_devices=2, extra_env=_mnist_env(tmp_path / "jax"),
        timeout=RIG_TIMEOUT_S)
    assert jax_result.returncode == 0, jax_result.stderr[-3000:]
    # The port's: 2 gloo ranks, the plan made over the job's processes.
    _ok(local_rig.run_bootstrap(
        MNIST, device="cpu", num_processes=2,
        extra_env=_mnist_env(tmp_path / "port", params),
        timeout=RIG_TIMEOUT_S))
    want = json.loads((tmp_path / "jax" / "history.json").read_text())
    got = json.loads((tmp_path / "port" / "history.json").read_text())
    assert set(got) == set(want)
    for key in COMPARED:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)
    assert got["loss"][-1] < got["loss"][0]


def test_bootstrap_monitoring_enabled_without_project_exits_cleanly(
        tmp_path):
    env = _mnist_env(tmp_path)
    env["CLOUD_TPU_MONITORING_ENABLED"] = "1"
    env.pop("CLOUD_TPU_MONITORING_PROJECT_ID", None)
    result = local_rig.run_bootstrap(MNIST, device="cpu", extra_env=env,
                                     timeout=RIG_TIMEOUT_S)
    _ok(result)
    assert "metrics exporter failed to start" in result.stderr
    assert np.isfinite(json.loads(
        (tmp_path / "history.json").read_text())["loss"][-1])


def test_notebook_entry_point_bootstrap(tmp_path):
    """A notebook of the MNIST workload, converted by the bootstrap: its
    last cell asserts the loss is finite, so exit 0 means conversion,
    mesh and training all worked."""
    source = pathlib.Path(MNIST).read_text().replace(
        'if __name__ == "__main__":\n    main()\n', "")
    cells = [source, "%matplotlib inline\n!echo shell escape\n"
             "history = main()\n",
             "import numpy as np\n"
             "assert np.isfinite(history.history['loss'][-1])\n"
             "print('NOTEBOOK DONE')\n"]
    nb = {"cells": [{"cell_type": "code", "metadata": {}, "outputs": [],
                     "execution_count": None, "id": f"c{i}",
                     "source": text.splitlines(keepends=True)}
                    for i, text in enumerate(cells)],
          "metadata": {}, "nbformat": 4, "nbformat_minor": 5}
    path = tmp_path / "mnist_example_using_fit.ipynb"
    path.write_text(json.dumps(nb))
    result = local_rig.run_bootstrap(
        str(path), device="cpu", extra_env=_mnist_env(tmp_path / "out"),
        timeout=RIG_TIMEOUT_S)
    _ok(result)
    assert "NOTEBOOK DONE" in result.stdout


def test_records_streaming_workload_through_bootstrap(tmp_path):
    entry = str(HELPERS / "torch_records_example.py")
    report = cloud_tpu_torch.run(
        entry_point=entry,
        chief_config=cloud_tpu_torch.COMMON_MACHINE_CONFIGS["TPU"],
        docker_config=DockerConfig(image="gcr.io/p/rec:t"),
        dry_run=True,
    )
    assert report.mesh_plan.spec.size("fsdp") == 8
    _ok(local_rig.run_bootstrap(
        entry, device="cpu", num_processes=2,
        extra_env={"RECORDS_EXAMPLE_DIR": str(tmp_path / "data"),
                   "RECORDS_EXAMPLE_SAVE": str(tmp_path)},
        timeout=RIG_TIMEOUT_S))
    history = json.loads((tmp_path / "history.json").read_text())
    assert history["loss"][-1] < history["loss"][0]


def test_within_script_contract_remote_half(tmp_path):
    script = tmp_path / "self_launch.py"
    script.write_text(
        "import cloud_tpu_torch\n"
        "from cloud_tpu_torch.core.containerize import DockerConfig\n"
        "cloud_tpu_torch.run(\n"
        "    chief_config=cloud_tpu_torch.COMMON_MACHINE_CONFIGS['TPU'],\n"
        "    docker_config=DockerConfig(image='gcr.io/p/self:t'),\n"
        ")\n"
        "print('TRAINED')\n"
    )
    result = local_rig.run_bootstrap(str(script), device="cpu",
                                     timeout=RIG_TIMEOUT_S)
    _ok(result)
    assert "TRAINED" in result.stdout


def test_emulated_slice_boots_the_port_selfcheck():
    """deploy's real startup script, per emulated host, with shimmed
    ``curl`` and ``docker``: the two hosts form one gloo job whose ranks
    came from the script's arithmetic."""
    results = local_rig.launch_emulated_slice(2, device="cpu", timeout=240)
    reports = []
    for rank, res in enumerate(results):
        assert res.returncode == 0, (rank, res.stdout[-2000:],
                                     res.stderr[-2000:])
        reports.append(json.loads(res.stdout.strip().splitlines()[-1]))
    assert [r["process_index"] for r in reports] == [0, 1]
    for rep in reports:
        assert rep["ok"] and rep["distributed"] is True
        assert rep["process_count"] == 2 and rep["platform"] == "cpu"


_JOB_SCRIPT = """
import json, os, sys
import cloud_tpu_torch
from cloud_tpu_torch.parallel import mesh
m = mesh.get_global_mesh()
print(json.dumps({
    "package": cloud_tpu_torch.__file__, "cwd": os.getcwd(),
    "argv": sys.argv[1:], "remote": cloud_tpu_torch.remote(),
    "submit_ts": os.environ.get("CLOUD_TPU_SUBMIT_TS"),
    "mesh": m.shape, "device": str(m.device)}))
"""


def test_emulated_slice_boots_a_jobs_own_image(tmp_path):
    """The emulated boot of a job's own image: the node request's startup
    script, the Dockerfile's ENTRYPOINT (the bootstrap, asked for the
    CPU) and the build context as the image's working directory and its
    whole ``PYTHONPATH``: the vendored package runs the script."""
    entry = tmp_path / "job" / "train.py"
    entry.parent.mkdir()
    entry.write_text(textwrap.dedent(_JOB_SCRIPT))
    report = cloud_tpu_torch.run(
        entry_point=str(entry),
        chief_config=cloud_tpu_torch.COMMON_MACHINE_CONFIGS["TPU_V5E_1"],
        docker_config=DockerConfig(image="gcr.io/p/own:t"),
        entry_point_args=["--lr", "0.5"], dry_run=True)
    context = containerize.build_context(
        report.dockerfile, str(entry), None, dst_dir=str(tmp_path / "ctx"))
    argv = containerize.entrypoint_argv(report.dockerfile)
    argv.insert(argv.index("--"), "--device=cpu")
    (node,) = report.node_requests.values()
    (result,) = local_rig.launch_emulated_slice(
        1, device="cpu", startup_script=node["metadata"]["startup-script"],
        entrypoint=argv, context_dir=context, timeout=120)
    _ok(result)
    out = json.loads(result.stdout.strip().splitlines()[-1])
    assert out["package"].startswith(context + os.sep)
    assert out["cwd"] == context
    assert out["argv"] == ["--lr", "0.5"]
    assert out["remote"] is True and out["submit_ts"]
    assert out["device"] == "cpu" and out["mesh"]["dp"] == 1


def test_rig_asks_for_the_cpu_only_when_told(monkeypatch):
    """Every entry point of the rig takes its device from the caller; the
    CPU's switches are set only when the caller asked for the CPU, and a
    rank on the card drops one inherited from the caller's environment."""
    monkeypatch.setenv("CLOUD_TPU_SELFCHECK_FORCE_CPU", "1")
    with pytest.raises(TypeError):
        local_rig.run_bootstrap(MNIST)
    with pytest.raises(TypeError):
        local_rig.launch_process_fleet(2)
    with pytest.raises(TypeError):
        local_rig.launch_emulated_slice(2)
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        local_rig.rank_env(device="tpu")
    cpu = local_rig.rank_env(0, 2, "localhost:1", device="cpu")
    card = local_rig.rank_env(0, 2, "localhost:1", device="cuda")
    assert cpu["CLOUD_TPU_SELFCHECK_FORCE_CPU"] == "1"
    assert "CLOUD_TPU_SELFCHECK_FORCE_CPU" not in card
    for env in (cpu, card):
        assert env["CLOUD_TPU_NUM_PROCESSES"] == "2"


def test_resnet_cifar_workload_under_a_one_rank_mesh():
    """The container workload of the card's front-door check, at the
    narrow ResNet-8 on the CPU under a one-rank mesh: the steps taken,
    finite losses, parameters that moved, no kernel launched."""
    spec = importlib.util.spec_from_file_location(
        "torch_resnet_cifar_fit", HELPERS / "torch_resnet_cifar_fit.py")
    workload = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(workload)
    mesh = planner.plan_mesh(num_devices=1).build([torch.device("cpu")])
    with mesh_lib.use_mesh(mesh):
        out = workload.main(resnet.RESNET8_CIFAR, steps=2, batch=8)
    assert (out["device"], out["steps"]) == ("cpu", 2)
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert np.isfinite(out["param_change"]) and out["param_change"] > 0
    assert set(out["launches"].values()) == {0}


def test_fleet_cpu_deficit_matches_the_reference(monkeypatch):
    monkeypatch.delenv("CLOUD_TPU_FLEET_FORCE", raising=False)
    for k in (2, 64, 4096):
        assert (local_rig.fleet_cpu_deficit(k) is None) == (
            jax_rig.fleet_cpu_deficit(k) is None)
    monkeypatch.setenv("CLOUD_TPU_FLEET_FORCE", "1")
    assert local_rig.fleet_cpu_deficit(4096) is None
