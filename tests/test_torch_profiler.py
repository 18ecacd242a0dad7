"""The port's profiler (``cloud_tpu_torch.monitoring.profiler``, on
``torch.profiler``) on the CPU, as ``tests/unit/test_profiler.py`` holds
the JAX package's.

* ``trace`` / ``start_trace`` / ``stop_trace`` write Chrome trace JSON in
  the TensorBoard layout, holding the ranges of ``annotate`` /
  ``annotate_function``;
* tracing spans are mirrored as ranges only while a trace runs;
* ``ProfilerCallback`` traces the same steps as the JAX package's for the
  same ``start_step``/``num_steps`` (each JAX ``StepTraceAnnotation``
  against each ``ProfilerStep#<n>`` range of the port's trace);
* ``save_device_memory_profile``; the server's env gate and one
  on-demand capture over its HTTP endpoint on ``localhost``;
* a capture requested while a training loop runs starts and stops on the
  loop's thread, at its steps (or the end of ``Trainer.fit``); with no
  loop it runs on the server's thread.
"""

import glob
import json
import os
import pickle
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.monitoring import profiler as jax_profiler
from cloud_tpu.training import trainer as jax_trainer
from cloud_tpu_torch.monitoring import profiler, tracing
from cloud_tpu_torch.training import optimizers, train, trainer

torch.set_num_threads(1)


def _profile_files(logdir):
    return glob.glob(os.path.join(logdir, "plugins", "profile", "*", "*"))


def _names(path):
    with open(path) as f:
        return [e.get("name") for e in json.load(f)["traceEvents"]]


def test_trace_context_writes_profile_dir(tmp_path):
    logdir = str(tmp_path / "tr")
    with profiler.trace(logdir) as out:
        with profiler.annotate("my/range"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert out == logdir
    files = _profile_files(logdir)
    assert files == [profiler.last_trace_path()]
    assert files[0].endswith(".pt.trace.json")
    assert "my/range" in _names(files[0])


def test_start_stop_trace_and_annotate_function(tmp_path):
    @profiler.annotate_function(name="fn_span")
    def f(x):
        return x + 1

    @profiler.annotate_function
    def g(x):
        return x * 2

    logdir = profiler.start_trace(str(tmp_path / "m"))
    with pytest.raises(RuntimeError, match="already running"):
        profiler.start_trace(str(tmp_path / "other"))
    assert int(g(f(torch.tensor(1)))) == 4
    path = profiler.stop_trace()
    with pytest.raises(RuntimeError, match="no profiler trace"):
        profiler.stop_trace()
    assert _profile_files(logdir) == [path]
    names = _names(path)
    assert "fn_span" in names
    assert any(n and n.endswith("g") for n in names)


def test_default_logdir_env(monkeypatch, tmp_path):
    monkeypatch.setenv(profiler.ENV_PROFILER_LOGDIR, str(tmp_path))
    assert profiler.default_logdir() == str(tmp_path)
    monkeypatch.delenv(profiler.ENV_PROFILER_LOGDIR)
    assert profiler.default_logdir().endswith("cloud_tpu_profile")


def test_spans_mirror_only_while_a_trace_runs(tmp_path):
    with tracing.collecting():
        with tracing.span("outside/before"):
            pass
        assert tracing._xprof_depth == 0
        with profiler.trace(str(tmp_path / "t")):
            assert tracing._xprof_depth == 1
            with tracing.span("inside/span") as span:
                assert span._annotation is not None
                torch.ones(8).sum()
        assert tracing._xprof_depth == 0
        with tracing.span("outside/after") as span:
            assert span._annotation is None
    names = _names(profiler.last_trace_path())
    assert "inside/span" in names
    assert "outside/before" not in names and "outside/after" not in names


def test_device_memory_profile(tmp_path):
    path = profiler.save_device_memory_profile(
        str(tmp_path / "mem" / "memory.pickle"), device="cpu")
    assert os.path.getsize(path) > 0
    with open(path, "rb") as f:
        assert pickle.load(f)["segments"] == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            profiler.save_device_memory_profile(str(tmp_path / "x"))


def test_server_env_gate_and_one_capture(monkeypatch, tmp_path):
    monkeypatch.delenv(profiler.ENV_PROFILER_PORT, raising=False)
    assert profiler.maybe_start_server_from_env() is False
    assert jax_profiler.maybe_start_server_from_env() is False
    monkeypatch.setenv(profiler.ENV_PROFILER_LOGDIR, str(tmp_path))
    monkeypatch.setattr(profiler, "_safe_seen", float("-inf"))  # no loop
    host, port = profiler.start_server(0)
    try:
        assert host == "127.0.0.1"
        assert profiler.start_server(0) == (host, port)  # idempotent
        answer = profiler.request_capture(port, 50)
        assert answer["duration_ms"] == 50
        assert answer["trace"] in _profile_files(str(tmp_path))
        assert json.load(open(answer["trace"]))["traceEvents"] is not None
        profiler.start_trace(str(tmp_path / "busy"))
        try:
            with pytest.raises(Exception, match="409"):
                profiler.request_capture(port, 10)
        finally:
            profiler.stop_trace()
    finally:
        profiler.stop_server()
    monkeypatch.setenv(profiler.ENV_PROFILER_PORT, "0")
    try:
        assert profiler.maybe_start_server_from_env() is True
    finally:
        profiler.stop_server()


def _linear_loss(params, batch):
    loss = torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
    return loss, {"loss": loss.detach()}


def _threads_of_trace_calls(monkeypatch):
    """Record the thread of every start_trace / stop_trace."""
    seen = []
    for name in ("start_trace", "stop_trace"):
        def wrapped(*args, _real=getattr(profiler, name), _name=name, **kw):
            seen.append((_name, threading.get_ident()))
            return _real(*args, **kw)
        monkeypatch.setattr(profiler, name, wrapped)
    return seen


@pytest.mark.parametrize("loop", ["steps", "fit"])
def test_server_capture_runs_at_the_loops_steps(loop, monkeypatch, tmp_path):
    """While steps run, the capture starts and stops at their safe points on
    the loop's thread: at the first step ``duration_ms`` after its start,
    or, when the loop is a ``Trainer.fit`` that ends sooner, at its end."""
    monkeypatch.setenv(profiler.ENV_PROFILER_LOGDIR, str(tmp_path))
    seen = _threads_of_trace_calls(monkeypatch)
    tr = trainer.Trainer(_linear_loss, optimizers.sgd(0.1),
                         init_fn=lambda _: {"w": torch.zeros(4, 2)},
                         device="cpu")
    tr.init_state(None)
    step = train.make_train_step(_linear_loss, optimizers.sgd(0.1))
    batch = {k: torch.as_tensor(v) for k, v in next(_data(torch)()).items()}
    state, _ = step(tr.state, batch)  # the loop is live
    _, port = profiler.start_server(0)
    try:
        answer = {}
        asker = threading.Thread(target=lambda: answer.update(
            profiler.request_capture(port, 200 if loop == "steps" else 60e3)))
        asker.start()
        while asker.is_alive() and not seen:
            time.sleep(0.01)
            state, _ = step(state, batch)
        if loop == "steps":
            while asker.is_alive():
                state, _ = step(state, batch)
                time.sleep(0.01)
        else:
            tr.fit(_data(torch), epochs=1, prefetch=0)
        asker.join(timeout=30)
        assert not asker.is_alive()
    finally:
        profiler.stop_server()
    assert answer["trace"] in _profile_files(str(tmp_path))
    assert seen == [("start_trace", threading.get_ident()),
                    ("stop_trace", threading.get_ident())]
    assert profiler._pending is None and profiler._active is None
    assert any(n and "mm" in n for n in _names(answer["trace"]))


def test_server_captures_on_its_thread_without_a_loop(monkeypatch, tmp_path):
    monkeypatch.setenv(profiler.ENV_PROFILER_LOGDIR, str(tmp_path))
    monkeypatch.setattr(profiler, "_safe_seen", float("-inf"))
    seen = _threads_of_trace_calls(monkeypatch)
    _, port = profiler.start_server(0)
    try:
        answer = profiler.request_capture(port, 20)
    finally:
        profiler.stop_server()
    assert answer["trace"] in _profile_files(str(tmp_path))
    assert [name for name, _ in seen] == ["start_trace", "stop_trace"]
    assert seen[0][1] == seen[1][1] != threading.get_ident()


def _data(lib):
    rng = np.random.RandomState(0)
    batches = [{"x": rng.randn(8, 4).astype(np.float32),
                "y": rng.randn(8, 2).astype(np.float32)} for _ in range(6)]
    return lambda: iter(batches)


def _jax_traced_steps(start_step, num_steps, monkeypatch):
    steps = []

    class Marker:
        def __init__(self, name, step_num):
            steps.append(step_num)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(jax.profiler, "StepTraceAnnotation", Marker)
    monkeypatch.setattr(jax.profiler, "start_trace", lambda logdir: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)

    def loss_fn(params, batch):
        loss = jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
        return loss, {"loss": loss}

    t = jax_trainer.Trainer(loss_fn, optax.sgd(0.1),
                            lambda rng: {"w": jax.random.normal(rng, (4, 2))})
    t.init_state(jax.random.PRNGKey(0))
    cb = jax_profiler.ProfilerCallback("unused", start_step=start_step,
                                       num_steps=num_steps)
    t.fit(_data(jax), epochs=1, callbacks=[cb], prefetch=0)
    assert cb._done and not cb._tracing
    return steps


def _port_traced_steps(start_step, num_steps, logdir):
    def loss_fn(params, batch):
        x = torch.as_tensor(batch["x"])
        loss = torch.mean((x @ params["w"] - torch.as_tensor(batch["y"])) ** 2)
        return loss, {"loss": loss.detach()}

    t = trainer.Trainer(loss_fn, optimizers.sgd(0.1),
                        init_fn=lambda _: {"w": torch.zeros(4, 2)},
                        device="cpu")
    t.init_state(None)
    cb = profiler.ProfilerCallback(logdir, start_step=start_step,
                                   num_steps=num_steps)
    t.fit(_data(torch), epochs=1, callbacks=[cb], prefetch=0)
    assert cb._done and not cb._tracing
    assert _profile_files(logdir) == [cb.trace_path]
    names = _names(cb.trace_path)
    return sorted(int(n.split("#")[1]) for n in names
                  if n and n.startswith("ProfilerStep#"))


@pytest.mark.parametrize("window", [(2, 3), (2, 50), (1, 1), (4, 2)])
def test_callback_traces_the_reference_steps(window, monkeypatch, tmp_path):
    want = _jax_traced_steps(*window, monkeypatch)
    got = _port_traced_steps(*window, str(tmp_path / "cb"))
    assert got == sorted(want) and got


def test_invalid_window_rejected():
    with pytest.raises(ValueError):
        profiler.ProfilerCallback(num_steps=0)
