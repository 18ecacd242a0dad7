"""Import hygiene of the PyTorch port.

Every module of ``cloud_tpu_torch`` imports with JAX blocked; no module of
the port, nor ``chip_smoke.py``, ``flash_ab.py`` or ``gn_ab.py``, imports
``jax``, ``optax``, ``orbax``, ``flax`` or the JAX package; the port's
copies of framework-free reference modules (``monitoring`` with
``report.py``, ``serving/qos.py``, ``serving/prefix_cache.py``,
``utils/faults.py``, ``utils/retries.py``, ``utils/native.py``,
``training/preemption.py``, the fleet's ``disagg.py``, ``router.py``,
``replica.py`` and ``autoscaler.py``, and the front door: ``version.py``,
``core/*``, ``utils/api_client.py``, ``utils/local_rig.py`` and
``monitoring/exporter.py``, and the tuner and cloud_fit, with the port's
copies of their golden workloads, :data:`TUNER_FIT_FILES`) import only
the standard library, the port
and the reference's own deferred third-party imports (the ``random.py``, ``training/compile_cache.py`` and
``training/records.py`` are scanned with every module, as are the
model zoo's ``models/moe.py``, ``models/vit.py`` and ``models/export.py``,
named in :data:`ZOO_MODULES`, and the parallel layer with the serving
slice's follower entry point, :data:`PARALLEL_MODULES`); and an
entry point called without ``device="cpu"`` on a host with no card raises
instead of quietly running on the CPU.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from helpers.torch_sigterm import sigterm_restored  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "cloud_tpu_torch"


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_with_jax_blocked():
    modules = list(_port_modules())
    assert len(modules) >= 14
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "from cloud_tpu_torch.ops import dispatch\n"
        "assert not dispatch._libs, 'a kernel library was loaded at import'\n"
        "bad = [m for m in sys.modules if m == 'cloud_tpu' "
        "or m.startswith('cloud_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "flash_ab.py",
                                          REPO / "gn_ab.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    for name in _imported_names(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "optax", "orbax", "flax",
                            "cloud_tpu"), (
            f"{path.name} imports {name}")


#: The port's copies of reference modules that import only the standard
#: library (and each other): so must the copies.  Each maps to the part of
#: the port it may import besides.
STDLIB_COPIES = {
    "monitoring/__init__.py": "cloud_tpu_torch.monitoring",
    # The native library's loader, as the reference's metrics.py imports
    # its utils/native.py.
    "monitoring/metrics.py": ("cloud_tpu_torch.monitoring",
                              "cloud_tpu_torch.utils"),
    # The profiler ranges spans mirror into (the reference imports
    # jax.profiler at the same place).
    "monitoring/tracing.py": ("cloud_tpu_torch.monitoring", "torch"),
    "monitoring/report.py": None,
    "serving/qos.py": "cloud_tpu_torch.monitoring",
    "serving/prefix_cache.py": "cloud_tpu_torch.monitoring",
    "utils/faults.py": "cloud_tpu_torch.monitoring",
    # The API session's typed errors, as the reference's retries.py.
    "utils/retries.py": ("cloud_tpu_torch.monitoring",
                         "cloud_tpu_torch.utils"),
    "utils/native.py": None,
    "training/preemption.py": "cloud_tpu_torch.monitoring",
    "fleet/disagg.py": None,
    "fleet/autoscaler.py": None,
    "fleet/router.py": "cloud_tpu_torch.fleet",
    "fleet/replica.py": ("cloud_tpu_torch.fleet", "cloud_tpu_torch.monitoring",
                         "cloud_tpu_torch.utils"),
    # The front door: framework-free copies whose only third-party
    # imports are the reference's own deferred ones (the card machine has
    # neither requests nor google.auth, nbconvert or IPython).
    "version.py": None,
    "monitoring/exporter.py": ("cloud_tpu_torch.monitoring",
                               "cloud_tpu_torch.utils"),
    "utils/api_client.py": ("cloud_tpu_torch.utils", "cloud_tpu_torch.version",
                            "requests", "google.auth"),
    "core/machine_config.py": None,
    "core/gcp.py": ("cloud_tpu_torch.core", "google.auth"),
    "core/validate.py": "cloud_tpu_torch.core",
    "core/notebook.py": ("IPython", "nbconvert", "google.colab"),
    "core/containerize.py": ("cloud_tpu_torch.utils", "google.cloud",
                             "torch"),
    "core/deploy.py": ("cloud_tpu_torch.core", "cloud_tpu_torch.fleet",
                       "cloud_tpu_torch.parallel", "cloud_tpu_torch.utils"),
    "core/run.py": ("cloud_tpu_torch.core", "cloud_tpu_torch.monitoring",
                    "cloud_tpu_torch.parallel"),
    "core/bootstrap.py": "cloud_tpu_torch",
    "utils/local_rig.py": ("cloud_tpu_torch.core", "torch"),
    # The tuner and cloud_fit: framework-free copies (the tuner's study
    # service and engine import only the standard library and each
    # other; cloud_fit's remote side builds the port's Trainer).
    "tuner/__init__.py": "cloud_tpu_torch.tuner",
    "tuner/hyperparameters.py": None,
    "tuner/engine.py": ("cloud_tpu_torch.monitoring",
                        "cloud_tpu_torch.tuner"),
    "tuner/study_service.py": "cloud_tpu_torch.tuner",
    "tuner/vizier_utils.py": "cloud_tpu_torch.tuner",
    "tuner/vizier_client.py": ("cloud_tpu_torch.tuner",
                               "cloud_tpu_torch.utils"),
    "tuner/tuner.py": ("cloud_tpu_torch.monitoring", "cloud_tpu_torch.tuner"),
    "tuner/dispatch.py": ("cloud_tpu_torch.tuner", "cloud_tpu_torch.core"),
    "cloud_fit/__init__.py": "cloud_tpu_torch.cloud_fit",
    "cloud_fit/serialization.py": ("cloudpickle", "numpy",
                                   "cloud_tpu_torch.utils"),
    # gs:// paths: google.cloud only when no client is injected.
    "utils/gcs.py": "google.cloud",
    "cloud_fit/client.py": ("cloud_tpu_torch.cloud_fit",
                            "cloud_tpu_torch.core", "numpy"),
    "cloud_fit/remote.py": ("cloud_tpu_torch.cloud_fit",
                            "cloud_tpu_torch.parallel",
                            "cloud_tpu_torch.training",
                            "cloud_tpu_torch.utils", "torch"),
}


#: The tuner and cloud_fit, with the port's copies of their golden
#: workloads and examples: scanned with every module above; named here so
#: a move or rename cannot drop them from the scan.
TUNER_FIT_FILES = (
    "cloud_tpu_torch/tuner/__init__.py", "cloud_tpu_torch/tuner/engine.py",
    "cloud_tpu_torch/tuner/hyperparameters.py",
    "cloud_tpu_torch/tuner/study_service.py",
    "cloud_tpu_torch/tuner/tuner.py", "cloud_tpu_torch/tuner/dispatch.py",
    "cloud_tpu_torch/tuner/vizier_client.py",
    "cloud_tpu_torch/tuner/vizier_utils.py",
    "cloud_tpu_torch/cloud_fit/__init__.py",
    "cloud_tpu_torch/cloud_fit/client.py",
    "cloud_tpu_torch/cloud_fit/remote.py",
    "cloud_tpu_torch/cloud_fit/serialization.py",
    "tests/helpers/torch_tuner_mnist_example.py",
    "tests/helpers/torch_tuner_resnet_example.py",
    "tests/helpers/torch_call_run_with_tuner_search.py",
    "tests/helpers/torch_cloud_fit_example.py",
    "tests/helpers/torch_preemptible_train.py",
    "tests/helpers/torch_tuner_fakes.py",
)


@pytest.mark.parametrize("rel", TUNER_FIT_FILES)
def test_tuner_and_cloud_fit_are_jax_free(rel):
    path = REPO / rel
    assert path.is_file(), rel
    test_no_jax_or_reference_imports(path)


def test_tuner_and_cloud_fit_import_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import cloud_tpu_torch\n"
        "from cloud_tpu_torch import tuner\n"
        "assert cloud_tpu_torch.CloudTuner is tuner.CloudTuner\n"
        "assert cloud_tpu_torch.CloudOracle is tuner.CloudOracle\n"
        "assert callable(cloud_tpu_torch.cloud_fit)\n"
        "from cloud_tpu_torch.cloud_fit import client, remote\n"
        "assert callable(cloud_tpu_torch.cloud_fit)\n"
        "bad = [m for m in sys.modules if m == 'cloud_tpu' "
        "or m.startswith('cloud_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


#: The model zoo's modules of the last slice: scanned with every module
#: above; named here so a move or rename cannot drop them from the scan.
ZOO_MODULES = ("models/moe.py", "models/vit.py", "models/export.py")


#: The parallel layer (with the ring and the differentiable collectives
#: of training under a mesh, the pipeline and the self-check CLI) and the
#: serving slice's follower entry point
#: (``serving/slice.py`` ``_follower_main``, the target a spawned follower
#: runs): scanned with every module above; named here so a move or
#: rename cannot drop them from the scan.
PARALLEL_MODULES = ("parallel/__init__.py", "parallel/mesh.py",
                    "parallel/distributed.py", "parallel/sharding.py",
                    "parallel/planner.py", "parallel/collectives.py",
                    "parallel/tensor_parallel.py",
                    "parallel/ring_attention.py", "parallel/autograd.py",
                    "parallel/pipeline.py", "parallel/selfcheck.py",
                    "serving/slice.py")


@pytest.mark.parametrize("rel", PARALLEL_MODULES)
def test_parallel_modules_are_jax_free(rel):
    path = PORT / rel
    assert path in set(PORT.rglob("*.py"))
    test_no_jax_or_reference_imports(path)


def test_follower_entry_point_runs_with_jax_blocked():
    """What a spawned follower imports (its target and the modules the
    target imports) loads in a process where JAX cannot be imported."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from cloud_tpu_torch.serving.slice import _follower_main\n"
        "from cloud_tpu_torch.parallel import tensor_parallel\n"
        "from cloud_tpu_torch.serving.engine import ServingEngine\n"
        "bad = [m for m in sys.modules if m == 'cloud_tpu' "
        "or m.startswith('cloud_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_mesh_training_entry_points_run_with_jax_blocked():
    """The entry points of training under a mesh (a one-rank CPU mesh, no
    process group) run in a process where JAX cannot be imported."""
    code = (
        "import sys, functools\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "from cloud_tpu_torch import bridge\n"
        "from cloud_tpu_torch.models import transformer\n"
        "from cloud_tpu_torch.parallel import MeshSpec, ring_attention\n"
        "from cloud_tpu_torch.parallel import autograd\n"
        "from cloud_tpu_torch.training import (make_hybrid_dp_train_step,\n"
        "    param_shardings, shard_batch, train, optimizers)\n"
        "cfg = transformer.TINY.scaled(dtype=torch.float32, num_layers=1)\n"
        "mesh = MeshSpec({}).build(devices=['cpu'])\n"
        "axes = transformer.param_logical_axes(cfg)\n"
        "init = lambda g: bridge.init(cfg, g, device='cpu')\n"
        "st = train.create_sharded_state(torch.Generator(), init,\n"
        "    optimizers.sgd(0.1), mesh=mesh, logical_axes=axes)\n"
        "loss = functools.partial(transformer.loss_fn, config=cfg, mesh=mesh)\n"
        "step = train.make_train_step(loss, optimizers.sgd(0.1), mesh=mesh,\n"
        "    logical_axes=axes)\n"
        "batch = shard_batch({'tokens': np.ones((2, 8), np.int64)}, mesh)\n"
        "st, m = step(st, batch)\n"
        "hy = make_hybrid_dp_train_step(loss, optimizers.sgd(0.1), mesh=mesh)\n"
        "st, m = hy(st, batch)\n"
        "spec = param_shardings(mesh, axes)['embed']['table']\n"
        "assert tuple(spec) == ('tp', 'fsdp'), spec\n"
        "bad = [m for m in sys.modules if m == 'cloud_tpu' "
        "or m.startswith('cloud_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("rel", ZOO_MODULES)
def test_zoo_modules_are_jax_free(rel):
    path = PORT / rel
    assert path in set(PORT.rglob("*.py"))
    test_no_jax_or_reference_imports(path)


@pytest.mark.parametrize("rel", sorted(STDLIB_COPIES))
def test_reference_copies_import_only_the_standard_library(rel):
    path = PORT / rel
    allowed = STDLIB_COPIES[rel] or ()
    for name in _imported_names(path):
        root = name.split(".")[0]
        assert (root in sys.stdlib_module_names or root == "__future__"
                or name.startswith(allowed)), f"{rel} imports {name}"


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device resolves")
    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import moe
    from cloud_tpu_torch.models import (bert, export, generation, mnist,
                                        resnet, transformer, vit)
    from cloud_tpu_torch.parallel import MeshSpec, distributed
    from cloud_tpu_torch.serving import ServeConfig, ServingEngine
    from cloud_tpu_torch.training import (check_durability, checkpoint,
                                          compile_cache, optimizers,
                                          pipeline_io, train, trainer)
    from cloud_tpu_torch.core import bootstrap
    from cloud_tpu_torch.monitoring import profiler
    from cloud_tpu_torch.utils import benchmarking

    cfg = transformer.TINY.scaled(dtype=torch.float32, num_layers=1)
    params = bridge.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    calls = [
        lambda: bridge.init(cfg, torch.Generator()),
        lambda: transformer.apply(params, torch.ones((1, 4), dtype=torch.long),
                                  cfg),
        lambda: generation.generate(params, torch.ones((1, 4)),
                                    torch.tensor([4]), cfg,
                                    max_new_tokens=2),
        lambda: generation.init_slot_cache(cfg, 2, 8),
        lambda: generation.init_slot_cache(cfg, 2, 8, kv_quant=True),
        lambda: generation.beam_search(params, torch.ones((1, 4)),
                                       torch.tensor([4]), cfg, num_beams=2,
                                       max_new_tokens=2),
        lambda: benchmarking.decode_tokens_per_sec(
            params, cfg, torch.ones((1, 4)), torch.tensor([4]),
            max_new_tokens=2),
        lambda: ServingEngine(params, cfg, start=False),
        lambda: benchmarking.decode_setup(),
        lambda: bridge.init_resnet(resnet.RESNET8_CIFAR, torch.Generator()),
        lambda: resnet.apply({}, torch.zeros((1, 32, 32, 3)),
                             resnet.RESNET8_CIFAR),
        lambda: train.create_sharded_state(None, dict, optimizers.sgd(0.1)),
        lambda: benchmarking.resnet_train_setup(imagenet_shape=False,
                                                batch_size=2),
        lambda: transformer.loss_fn(params, {"tokens": torch.ones((1, 4))},
                                    cfg),
        lambda: benchmarking.lm_train_setup(batch_size=1, seq_len=4,
                                            config=cfg),
        lambda: bridge.init_bert(bert.TINY, torch.Generator()),
        lambda: bert.apply({}, torch.ones((1, 4)), bert.TINY),
        lambda: benchmarking.bert_train_setup(batch_size=1, seq_len=4,
                                              config=bert.TINY),
        lambda: bridge.init_mnist(mnist.MnistConfig(), torch.Generator()),
        lambda: mnist.apply({}, torch.zeros((1, 784))),
        lambda: trainer.Trainer(lambda p, b: None, optimizers.sgd(0.1)),
        lambda: checkpoint.CheckpointManager("unused"),
        lambda: checkpoint.CheckpointCallback("unused")._get(),
        lambda: pipeline_io.prefetch_to_device(list),
        lambda: pipeline_io.prefetch_windows(list, 2),
        lambda: pipeline_io.iter_windows(list, 2),
        lambda: pipeline_io.place_batch({"x": np.zeros(2)}),
        lambda: check_durability.main([]),
        lambda: compile_cache.abstract_batch({"x": np.zeros(2)}),
        lambda: bridge.init(cfg.scaled(moe=moe.MoeConfig()),
                            torch.Generator()),
        lambda: bridge.init_vit(vit.VIT_TINY_CIFAR, torch.Generator()),
        lambda: vit.apply({}, torch.zeros((1, 32, 32, 3)),
                          vit.VIT_TINY_CIFAR),
        lambda: vit.loss_fn({}, {"image": torch.zeros((1, 32, 32, 3)),
                                 "label": torch.zeros(1)},
                            vit.VIT_TINY_CIFAR),
        lambda: benchmarking.vit_train_setup(batch_size=1,
                                             config=vit.VIT_TINY_CIFAR),
        lambda: export.load_pretrained("unused"),
        lambda: MeshSpec({"tp": 2}).build(),
        lambda: distributed.backend_for(),
        lambda: ServingEngine(params, cfg, ServeConfig(mesh_shape=(2, 1)),
                              start=False),
        lambda: bootstrap.main(["--entry-point=unused.py"]),
        lambda: profiler.save_device_memory_profile("unused"),
        lambda: trainer.Trainer(lambda p, b: None, optimizers.sgd(0.1),
                                mesh=None, logical_axes={}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
