"""The port's compile-ahead (``cloud_tpu_torch.training.compile_cache``) against the JAX package's, on the CPU.

On a CPU state nothing is captured: the artifact is the eager step bound
to its specs, so the registry, the spec check, the worker thread and the
Trainer's wiring run here as on the card (where ``chip_smoke.py``'s
compile-ahead phase holds the CUDA graphs):

* the registry memoizes by step and specs, is bounded, and counts hits
  and misses; ``AotStep`` reverts for good to the plain step on a spec
  mismatch;
* ``fit(compile_ahead=True)``: the train (window) and eval compiles end
  before the first dispatch (spans), ``batch_spec`` compiles without
  peeking, a repeat fit hits the registry, an empty dataset degrades, and
  K=1 and K=4 fits log JAX's ``fit(compile_ahead=True)`` losses within
  1e-5 on the same weights and data;
* the persistent kernel cache: an unset env is a no-op, a failing or
  markerless probe child is refused, a pass enables the cache (the
  kernel libraries' path lies under the directory) and a second process
  enables it from the marker without probing; the ``nvcc`` version is
  part of a library's name.  No ``nvcc`` runs here.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.models import mnist as jax_mnist
from cloud_tpu.training import data as jax_data
from cloud_tpu.training import trainer as jax_trainer
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import mnist
from cloud_tpu_torch.monitoring import metrics, tracing
from cloud_tpu_torch.ops import dispatch
from cloud_tpu_torch.training import (compile_cache, data, optimizers, train,
                                      trainer)
from tests.helpers.torch_port import mnist_models
from helpers.torch_sigterm import sigterm_restored  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_registry():
    compile_cache.clear_registry()
    yield
    compile_cache.clear_registry()


def _linear_problem(n=16, batch_size=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 4)).astype(np.float32)
    w_true = rng.normal(size=(4, 2)).astype(np.float32)
    return data.ArrayDataset({"x": x, "y": (x @ w_true).astype(np.float32)},
                             batch_size=batch_size)


def _linear_loss(params, batch):
    loss = torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
    return loss, {"loss": loss.detach()}


def _make_trainer():
    tr = trainer.Trainer(_linear_loss, optimizers.sgd(0.1),
                         init_fn=lambda _: {"w": torch.zeros(4, 2)},
                         device="cpu")
    tr.init_state(None)
    return tr


def _state():
    return train.create_sharded_state(
        None, lambda _: {"w": torch.zeros(4, 2)}, optimizers.sgd(0.1),
        device="cpu")


def _specs(n):
    return compile_cache.abstract_batch(
        {"x": np.zeros((n, 4), np.float32), "y": np.zeros((n, 2), np.float32)},
        device="cpu")


def _counter(name):
    return metrics.snapshot()["counters"].get(name, 0)


def test_specs_keep_shape_dtype_device_and_grad():
    state = _state()
    specs = compile_cache.abstract_state(state)
    assert specs.params["w"] == compile_cache.TensorSpec(
        (4, 2), torch.float32, torch.device("cpu"), True)
    assert specs.step.dtype == torch.int32 and specs.rng is None
    batch = compile_cache.abstract_batch(
        {"x": np.zeros((2, 4), np.float64), "t": torch.zeros(3, dtype=torch.int8)},
        device="cpu")
    assert batch["x"] == compile_cache.TensorSpec((2, 4), torch.float64,
                                                  torch.device("cpu"))
    assert batch["t"].dtype == torch.int8
    # Under a mesh the specs are this rank's rows on the mesh's device
    # (held on 2 ranks in tests/test_torch_window_mesh.py).
    from cloud_tpu_torch.parallel import MeshSpec

    one = MeshSpec({}).build(devices=["cpu"])
    stacked = compile_cache.abstract_batch(
        {"x": np.zeros((2, 3, 4), np.float32)}, mesh=one, stacked=True)
    assert stacked["x"] == compile_cache.TensorSpec((2, 3, 4), torch.float32,
                                                    torch.device("cpu"))
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        compile_cache.abstract_batch({}, mesh=object(), device="cpu")


def test_get_or_compile_memoizes_by_step_and_specs():
    step = train.make_train_step(_linear_loss, optimizers.sgd(0.1))
    hits, misses = (_counter("compile/registry_hit"),
                    _counter("compile/registry_miss"))
    c1 = compile_cache.get_or_compile(step, (_state(), _specs(2)),
                                      label="train_step")
    c2 = compile_cache.get_or_compile(step, (_state(), _specs(2)),
                                      label="train_step")
    c3 = compile_cache.get_or_compile(step, (_state(), _specs(4)),
                                      label="train_step")
    other = train.make_train_step(_linear_loss, optimizers.sgd(0.1))
    c4 = compile_cache.get_or_compile(other, (_state(), _specs(2)),
                                      label="train_step")
    assert c1 is c2 and c3 is not c1 and c4 is not c1
    assert _counter("compile/registry_hit") - hits == 1
    assert _counter("compile/registry_miss") - misses == 3
    assert compile_cache.registry_size() == 3


def test_registry_is_bounded(monkeypatch):
    monkeypatch.setattr(compile_cache, "REGISTRY_MAX_ENTRIES", 3)
    step = train.make_train_step(_linear_loss, optimizers.sgd(0.1))
    for n in range(2, 8):  # 6 distinct spec keys through a cap of 3
        compile_cache.get_or_compile(step, (_state(), _specs(n)),
                                     label="bounded")
    assert compile_cache.registry_size() <= 3


def test_aot_step_reverts_on_a_spec_mismatch(caplog):
    step = train.make_train_step(_linear_loss, optimizers.sgd(0.1))
    aot = compile_cache.AotStep(step, "train_step")
    aot.attach(compile_cache.aot_compile(step, _state(), _specs(2),
                                         label="train_step"))
    batch = {k: torch.from_numpy(v)
             for k, v in next(iter(_linear_problem()())).items()}
    state, _ = aot(_state(), batch)
    assert aot.compiled is not None and int(state.step) == 1
    wide = {k: torch.cat([v, v]) for k, v in batch.items()}  # [4, ...]
    want, _ = step(_state(), wide)
    with caplog.at_level("WARNING"):
        got, _ = aot(_state(), wide)
    assert aot.compiled is None  # reverted for good
    assert any("rejected its inputs" in r.message for r in caplog.records)
    assert torch.equal(got.params["w"], want.params["w"])


def _spy_events(tr, fit_kwargs):
    with tracing.collecting() as collector:
        history = tr.fit(**fit_kwargs)
    return history, collector.events()


def test_compile_finishes_before_first_dispatch():
    """The window's compile/backend_compile span ends before the first
    dispatch span starts; the eval compile rides behind it on the worker,
    with specs from the validation data's own (differently sized)
    batches, and stays attached through evaluate()."""
    tr = _make_trainer()
    _, events = _spy_events(tr, dict(
        train_data=_linear_problem(n=22), epochs=1, steps_per_dispatch=4,
        prefetch=2, compile_ahead=True,
        validation_data=_linear_problem(n=16, batch_size=4)))
    compiles = [e for e in events if e["name"] == "compile/backend_compile"]
    assert {e["args"].get("fn") for e in compiles} == {"multi_step",
                                                       "eval_step"}
    first = [e for e in events if e["name"] == "step/first_compile"]
    assert len(first) == 1
    end = max(e["ts"] + e["dur"] for e in compiles
              if e["args"].get("fn") == "multi_step")
    assert end <= first[0]["ts"]
    plan = tr.compile_plan
    assert plan.error is None
    assert plan.steps["multi_step"].compiled is not None
    assert plan.steps["eval_step"].compiled is not None


def test_batch_spec_compiles_without_peeking():
    tr = _make_trainer()
    spec = {"x": np.zeros((2, 4), np.float32),
            "y": np.zeros((2, 2), np.float32)}
    history = tr.fit(_linear_problem(n=22), epochs=1, steps_per_dispatch=4,
                     compile_ahead=True, batch_spec=spec)
    assert len(history.history["loss"]) == 1
    assert tr.compile_plan.error is None
    assert tr.compile_plan.steps["multi_step"].compiled is not None


def test_registry_serves_repeat_fits():
    tr = _make_trainer()
    tr.fit(_linear_problem(), epochs=1, steps_per_dispatch=4,
           compile_ahead=True)
    hits = _counter("compile/registry_hit")
    with tracing.collecting() as collector:
        tr.fit(_linear_problem(), epochs=1, steps_per_dispatch=4,
               compile_ahead=True)
    assert "compile/backend_compile" not in collector.aggregates()
    assert _counter("compile/registry_hit") - hits == 1
    assert tr.compile_plan.steps["multi_step"].compiled is not None


def test_empty_dataset_degrades_gracefully():
    tr = _make_trainer()
    history = tr.fit(lambda: iter(()), epochs=1, compile_ahead=True)
    assert "loss" not in history.history  # no steps ran, no crash
    assert tr.compile_plan is None


@pytest.mark.parametrize("k,prefetch", [(1, 0), (1, 2), (4, 2)])
def test_compile_ahead_fit_equals_jax(k, prefetch):
    """MNIST (hidden 16) with the same weights and shuffled data: the
    port's fit(compile_ahead=True) logs JAX's within 1e-5, with
    validation; a 22-batch epoch gives windows of 4 a 2-of-4 tail."""
    jax_cfg, jparams, cfg, pparams = mnist_models(seed=0)
    rng = np.random.default_rng(3)
    arrays = {"image": rng.normal(size=(88, 784)).astype(np.float32),
              "label": rng.integers(0, 10, 88).astype(np.int64)}
    jtr = jax_trainer.Trainer(
        functools.partial(jax_mnist.loss_fn, config=jax_cfg),
        optax.sgd(0.1), init_fn=lambda _: jax.tree_util.tree_map(
            jnp.asarray, jparams))
    jtr.init_state(jax.random.PRNGKey(0))
    tr = trainer.Trainer(
        functools.partial(mnist.loss_fn, config=cfg, device="cpu"),
        optimizers.sgd(0.1),
        init_fn=lambda _: bridge.map_leaves(pparams, torch.clone),
        device="cpu")
    tr.init_state(None)
    kw = dict(epochs=2, steps_per_dispatch=k, prefetch=prefetch,
              compile_ahead=True)
    want = jtr.fit(jax_data.ArrayDataset(arrays, 4, shuffle=True, seed=1),
                   validation_data=jax_data.ArrayDataset(arrays, 8), **kw)
    got = tr.fit(data.ArrayDataset(arrays, 4, shuffle=True, seed=1),
                 validation_data=data.ArrayDataset(arrays, 8), **kw)
    assert tr.compile_plan.error is None
    for key in ("loss", "accuracy", "val_loss", "val_accuracy"):
        np.testing.assert_allclose(got.history[key], want.history[key],
                                   rtol=0, atol=1e-5, err_msg=key)


class TestPersistentCache:
    @pytest.fixture(autouse=True)
    def _isolated(self, monkeypatch):
        monkeypatch.delenv(compile_cache.ENV_COMPILE_CACHE, raising=False)
        compile_cache._reset_persistent_state_for_tests()
        yield
        compile_cache._reset_persistent_state_for_tests()
        assert dispatch.build_dir() == dispatch.BUILD_DIR

    def test_unset_env_is_a_noop(self, monkeypatch):
        assert compile_cache.maybe_enable_persistent_cache() is False
        for off in ("", "off", "0", "false"):
            monkeypatch.setenv(compile_cache.ENV_COMPILE_CACHE, off)
            assert compile_cache.maybe_enable_persistent_cache() is False
        assert not compile_cache.persistent_cache_enabled()
        assert dispatch.build_dir() == dispatch.BUILD_DIR

    def test_refuses_on_failing_probe(self, tmp_path, monkeypatch):
        calls = []
        monkeypatch.setattr(
            compile_cache, "_run_probe_child",
            lambda d, t: calls.append(d) or (139, "Segmentation fault"))
        cache = str(tmp_path / "cache")
        assert compile_cache.maybe_enable_persistent_cache(cache) is False
        assert calls == [cache]
        assert not compile_cache.persistent_cache_enabled()
        assert dispatch.build_dir() == dispatch.BUILD_DIR
        assert not [f for f in os.listdir(cache)
                    if f.startswith(".cloud_tpu_torch_probe_ok")]

    def test_clean_exit_without_marker_string_refused(self, tmp_path,
                                                      monkeypatch):
        monkeypatch.setattr(compile_cache, "_run_probe_child",
                            lambda d, t: (0, "no marker here"))
        assert compile_cache.maybe_enable_persistent_cache(
            str(tmp_path)) is False

    def test_probe_pass_enables_and_a_second_process_skips_it(
            self, tmp_path, monkeypatch):
        cache = str(tmp_path / "cache")
        monkeypatch.setattr(
            compile_cache, "_run_probe_child",
            lambda d, t: (0, compile_cache._PROBE_OK_MARKER))
        monkeypatch.setenv(compile_cache.ENV_COMPILE_CACHE, cache)
        # Trainer.fit asks for the cache at its start.
        _make_trainer().fit(_linear_problem(n=4), epochs=1)
        assert compile_cache.persistent_cache_enabled()
        assert dispatch.build_dir() == os.path.abspath(cache)
        for name in dispatch.SOURCES:
            assert dispatch.library_path(name).startswith(
                os.path.abspath(cache) + os.sep)
        markers = [f for f in os.listdir(cache)
                   if f.startswith(".cloud_tpu_torch_probe_ok")]
        assert len(markers) == 1
        child = (
            "import sys\n"
            "from cloud_tpu_torch.ops import dispatch\n"
            "from cloud_tpu_torch.training import compile_cache\n"
            "def no_probe(*a):\n"
            "    raise AssertionError('the marker should skip the probe')\n"
            "compile_cache._run_probe_child = no_probe\n"
            "assert compile_cache.maybe_enable_persistent_cache()\n"
            "print(dispatch.library_path('group_norm'))\n"
        )
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.run([sys.executable, "-c", child],
                              capture_output=True, text=True, timeout=120,
                              env=env)
        assert proc.returncode == 0, proc.stderr[-800:]
        assert proc.stdout.strip() == dispatch.library_path("group_norm")

    def test_ranks_probing_one_directory_leave_one_whole_marker(
            self, tmp_path, monkeypatch):
        """Two ranks of one host probe into one directory at once (each a
        process; here two threads, the decision reset between them): the
        marker lands whole by a rename, and no partial file stays."""
        import threading

        cache = str(tmp_path / "cache")
        both = threading.Barrier(2)

        def probe(d, t):
            both.wait(timeout=30)  # both probes run before either writes
            return 0, compile_cache._PROBE_OK_MARKER

        monkeypatch.setattr(compile_cache, "_run_probe_child", probe)
        got = []

        def rank():
            got.append(compile_cache.maybe_enable_persistent_cache(cache))

        threads = [threading.Thread(target=rank) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert got == [True, True]
        files = [f for f in os.listdir(cache)
                 if f.startswith(".cloud_tpu_torch_probe_ok")]
        assert files == [os.path.basename(
            compile_cache._probe_marker_path(cache))]
        with open(os.path.join(cache, files[0])) as f:
            assert f.read() == compile_cache._PROBE_OK_MARKER + "\n"

    def test_nvcc_version_names_the_library(self, monkeypatch):
        monkeypatch.setattr(dispatch, "_nvcc_version", "release 12.9")
        a = dispatch.library_path("flash_fwd")
        monkeypatch.setattr(dispatch, "_nvcc_version", "release 13.0")
        assert dispatch.library_path("flash_fwd") != a
