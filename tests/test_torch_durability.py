"""Durable resume of the port on the CPU: the exactly-once data position,
the preemption drain, the non-finite rollback and the kill -9 drill.

The reference's ``tests/unit/test_durability.py`` contracts, held on the
port (``cloud_tpu_torch.training``):

* ``ArrayDataset`` gives the JAX class's batches index for index (same
  seed, three epochs), fast-forwards, derives each epoch's order from
  ``(seed, epoch)`` and adopts a checkpoint's seed;
* a fit stopped mid-epoch by ``preemption.request_stop`` and resumed with
  ``CheckpointCallback(resume_data=True)`` replays exactly the remaining
  batches: per-step losses and final params bit for bit equal to the
  uninterrupted run (shuffled, not stochastic), one step at a time and in
  windows of 2; positions are dataset-absolute across a warmup fit; a
  dataset without resume hooks restarts its stream with a warning;
* a real SIGTERM through ``install_sigterm_handler``, in a child process
  that never imports JAX, drains and saves the current step;
* ``rollback_after_nonfinite`` rolls back to the last verified checkpoint
  once, then stops, or stops at once with no checkpoint; a quarantined
  window stays out of the epoch logs;
* ``python -m cloud_tpu_torch.training.check_durability --device cpu``
  (MNIST: kill -9 mid-fit, both corruptions, resume in a fresh process)
  prints ``ok: true`` and ``digest_match: true`` within 120 s.
"""

import functools
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cloud_tpu.training import data as jax_data
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import mnist
from cloud_tpu_torch.monitoring import metrics, tracing
from cloud_tpu_torch.training import (data, optimizers, pipeline_io,
                                      preemption, trainer)
from cloud_tpu_torch.training.checkpoint import CheckpointCallback
from tests.helpers.torch_port import REPO, mnist_models

torch.set_num_threads(1)


def _counter(name):
    return metrics.snapshot()["counters"].get(name, 0)


def _build(ckpt_dir=None, *, every=2, resume_data=False, seed=0,
           shuffle=False):
    """The reference's MNIST fixture (hidden 16, 48 examples, batch 8),
    on the CPU, from JAX's init."""
    _, _, cfg, params = mnist_models(seed=0)
    tr = trainer.Trainer(
        functools.partial(mnist.loss_fn, config=cfg, device="cpu"),
        optimizers.sgd(0.1), device="cpu",
        init_fn=lambda _: bridge.map_leaves(params, torch.clone))
    tr.init_state(None)
    rng = np.random.default_rng(0)
    ds = data.ArrayDataset(
        {"image": rng.normal(size=(48, 784)).astype(np.float32),
         "label": rng.integers(0, 10, 48).astype(np.int64)},
        batch_size=8, shuffle=shuffle, seed=seed,
    )
    cb = None
    if ckpt_dir is not None:
        cb = CheckpointCallback(str(ckpt_dir), every_n_steps=every,
                                resume_data=resume_data, device="cpu")
    return tr, ds, cb


def _params_equal(a, b):
    return all(torch.equal(x.detach(), y.detach())
               for x, y in zip(bridge.leaves(a.params),
                               bridge.leaves(b.params)))


def _loss_spy(losses):
    return trainer.LambdaCallback(
        on_step_end=lambda s, logs, t: losses.update({s: float(logs["loss"])}))


# --- the dataset ---------------------------------------------------------------


def _xs(lib, seed=5):
    rng = np.random.default_rng(1)
    return lib.ArrayDataset({"x": rng.normal(size=(24, 3)).astype(np.float32)},
                            batch_size=4, shuffle=True, seed=seed)


def test_batch_order_equals_jax_class():
    port, ref = _xs(data), _xs(jax_data)
    for _ in range(3):
        got, want = list(port()), list(ref())
        assert len(got) == len(want) == 6
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["x"], b["x"])


def test_array_dataset_fast_forward_and_derived_orders():
    full = _xs(data)
    epochs = [[b["x"] for b in full()] for _ in range(3)]
    resumed = _xs(data)
    resumed.load_state_dict({"epoch": 1, "batches_consumed": 2})
    got = [b["x"] for b in resumed()]
    assert len(got) == len(epochs[1]) - 2
    for want, have in zip(epochs[1][2:], got):
        np.testing.assert_array_equal(want, have)
    for want, have in zip(epochs[2], [b["x"] for b in resumed()]):
        np.testing.assert_array_equal(want, have)
    assert not np.array_equal(np.concatenate(epochs[0]),
                              np.concatenate(epochs[1]))


def test_seed_mismatch_adopts_checkpoint_seed(caplog):
    recorded = _xs(data, seed=5)
    epochs = [[b["x"] for b in recorded()] for _ in range(2)]
    misbuilt = _xs(data, seed=99)
    with caplog.at_level(logging.WARNING,
                         logger="cloud_tpu_torch.training.data"):
        misbuilt.load_state_dict({"epoch": 1, "batches_consumed": 2,
                                  "seed": 5})
    assert any("seed" in r.message for r in caplog.records)
    for want, have in zip(epochs[1][2:], [b["x"] for b in misbuilt()]):
        np.testing.assert_array_equal(want, have)


def test_prefetch_factories_forward_state_hooks():
    ds = _xs(data)
    wrapped = pipeline_io.prefetch_to_device(ds, size=1, device="cpu")
    assert wrapped.state_dict() == ds.state_dict()
    wrapped.load_state_dict({"epoch": 2, "batches_consumed": 1})
    assert ds._epoch == 2 and ds._skip == 1


# --- drain and exactly-once resume -----------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
def test_drain_resume_is_exactly_once_and_bit_exact(tmp_path, k):
    """Stop at step 4 (a dispatch boundary at K=1 and K=2), save, restart
    with resume_data=True: the remaining batches (shuffled order
    included) replay exactly, so losses and final params equal the
    uninterrupted run's bit for bit."""
    control, ds, _ = _build(shuffle=True, seed=3)
    control_losses = {}
    control.fit(ds, epochs=2, steps_per_dispatch=k,
                callbacks=[_loss_spy(control_losses)])
    assert int(control.state.step) == 12

    ckpt = tmp_path / "drain"
    preemption._reset_for_tests()
    try:
        tr1, ds1, cb1 = _build(ckpt, every=100, resume_data=True,
                               shuffle=True, seed=3)
        stopper = trainer.LambdaCallback(
            on_step_end=lambda s, logs, t:
                preemption.request_stop("test") if s == 4 else None)
        before = _counter("preempt/drains")
        with tracing.collecting() as collector:
            tr1.fit(ds1, epochs=2, steps_per_dispatch=k,
                    callbacks=[cb1, stopper])
        assert tr1.drained and int(tr1.state.step) == 4
        assert _counter("preempt/drains") == before + 1
        assert [e["args"]["step"] for e in collector.events()
                if e["name"] == "preempt/drain"] == [4]
        assert tr1.data_state == {"epoch": 0, "batches_consumed": 4,
                                  "seed": 3}
    finally:
        preemption._reset_for_tests()

    tr2, ds2, cb2 = _build(ckpt, every=100, resume_data=True, shuffle=True,
                           seed=3)
    resumed_losses = {}
    tr2.fit(ds2, epochs=2, steps_per_dispatch=k,
            callbacks=[cb2, _loss_spy(resumed_losses)])
    assert min(resumed_losses) == 4 + k   # no replayed, no skipped steps
    assert int(tr2.state.step) == 12      # the ORIGINAL budget
    assert all(control_losses[s] == v for s, v in resumed_losses.items())
    assert _params_equal(control.state, tr2.state)


def test_warmup_fit_resume_uses_absolute_dataset_epoch(tmp_path):
    def build():
        tr, ds, _ = _build(shuffle=True, seed=3)
        tr.fit(ds, epochs=1)  # warmup: ds epoch counter now at 1
        return tr, ds

    control, control_ds = build()
    control.fit(control_ds, epochs=2)
    assert int(control.state.step) == 18

    ckpt = str(tmp_path / "warmup")
    preemption._reset_for_tests()
    try:
        tr1, ds1 = build()
        cb1 = CheckpointCallback(ckpt, every_n_steps=100, resume_data=True,
                                 device="cpu")
        stopper = trainer.LambdaCallback(
            on_step_end=lambda s, logs, t:
                preemption.request_stop("test") if s == 9 else None)
        tr1.fit(ds1, epochs=2, callbacks=[cb1, stopper])
        assert tr1.drained and int(tr1.state.step) == 9
        assert tr1.data_state == {"epoch": 1, "batches_consumed": 3,
                                  "seed": 3}
    finally:
        preemption._reset_for_tests()

    tr2, ds2 = build()
    cb2 = CheckpointCallback(ckpt, every_n_steps=100, resume_data=True,
                             device="cpu")
    tr2.fit(ds2, epochs=2, callbacks=[cb2])
    assert int(tr2.state.step) == 18
    assert _params_equal(control.state, tr2.state)


def test_resume_without_hooks_warns_and_restarts_stream(tmp_path, caplog):
    ckpt = tmp_path / "nohooks"
    tr, ds, cb = _build(ckpt, every=2, resume_data=True)
    tr.fit(ds, epochs=1, callbacks=[cb])

    def plain_dataset():  # no state hooks
        rng = np.random.default_rng(0)
        for _ in range(6):
            yield {"image": rng.normal(size=(8, 784)).astype(np.float32),
                   "label": rng.integers(0, 10, 8).astype(np.int64)}

    tr2, _, cb2 = _build(ckpt, every=2, resume_data=True)
    with caplog.at_level(logging.WARNING):
        tr2.fit(plain_dataset, epochs=1, callbacks=[cb2])
    assert "no load_state_dict" in caplog.text
    assert int(tr2.state.step) == 12  # resumed params, fresh stream


_SIGTERM_CHILD = """
import json, os, signal, sys
sys.modules["jax"] = None
import numpy as np, torch
torch.set_num_threads(1)
from cloud_tpu_torch.monitoring import metrics
from cloud_tpu_torch.training import data, optimizers, preemption, trainer
from cloud_tpu_torch.training.checkpoint import (CheckpointCallback,
                                                 CheckpointManager)

ckpt = sys.argv[1]
assert preemption.install_sigterm_handler()

def loss_fn(params, batch):
    loss = torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
    return loss, {"loss": loss.detach()}

rng = np.random.default_rng(0)
ds = data.ArrayDataset({"x": rng.normal(size=(24, 4)).astype(np.float32),
                        "y": rng.normal(size=(24, 2)).astype(np.float32)}, 4)
tr = trainer.Trainer(loss_fn, optimizers.sgd(0.01), device="cpu",
                     init_fn=lambda _: {"w": torch.zeros(4, 2)})
tr.init_state(None)
kill = trainer.LambdaCallback(on_step_end=lambda s, logs, t: os.kill(
    os.getpid(), signal.SIGTERM) if s == 3 else None)
tr.fit(ds, epochs=2, callbacks=[CheckpointCallback(
    ckpt, every_n_steps=100, resume_data=True, device="cpu"), kill])
counters = metrics.snapshot()["counters"]
manager = CheckpointManager(ckpt, device="cpu")
print(json.dumps({"drained": tr.drained, "step": int(tr.state.step),
                  "reason": preemption.stop_reason(),
                  "steps": manager.steps(),
                  "verified": manager.verify(3),
                  "extras": manager.read_extras(3),
                  "drains": counters.get("preempt/drains"),
                  "sigterm": counters.get("preempt/sigterm")}))
"""


def test_sigterm_drains_in_a_child_process(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _SIGTERM_CHILD, str(tmp_path / "ckpt")],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {
        "drained": True, "step": 3, "reason": f"signal {15}",
        "steps": [3], "verified": "verified",
        "extras": {"data_state": {"epoch": 0, "batches_consumed": 3,
                                  "seed": 0}},
        "drains": 1, "sigterm": 1,
    }


# --- the non-finite rollback --------------------------------------------------


def _linear(poison=None):
    def loss_fn(params, batch):
        loss = torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
        return loss, {"loss": loss.detach()}

    rng = np.random.default_rng(0)
    x = rng.normal(size=(24, 4)).astype(np.float32)
    y = rng.normal(size=(24, 2)).astype(np.float32)
    if poison is not None:
        x[poison] = np.nan
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 2)).astype(np.float32) * 0.1)
    tr = trainer.Trainer(loss_fn, optimizers.sgd(0.01), device="cpu",
                         nonfinite_guard=True, init_fn=lambda _: {
                             "w": w.clone()})
    tr.init_state(None)
    return tr, data.ArrayDataset({"x": x, "y": y}, batch_size=4)


def test_streak_rolls_back_then_terminates(tmp_path):
    """Two consecutive bad windows: roll back to the last verified
    checkpoint (step 2), continue; the second streak stops training."""
    tr, ds = _linear(poison=slice(8, None))
    cb = CheckpointCallback(str(tmp_path / "rollback"), every_n_steps=2,
                            device="cpu")
    before = _counter("train/rollbacks")
    with tracing.collecting() as collector:
        tr.fit(ds, epochs=2, callbacks=[cb], rollback_after_nonfinite=2)
    assert _counter("train/rollbacks") == before + 1
    assert tr.stop_training is True
    rollbacks = [e for e in collector.events()
                 if e["name"] == "train/rollback"]
    assert len(rollbacks) == 1 and rollbacks[0]["args"]["to_step"] == 2
    assert torch.isfinite(tr.state.params["w"]).all()


def test_streak_without_checkpoint_terminates():
    tr, ds = _linear(poison=slice(8, None))
    tr.fit(ds, epochs=2, rollback_after_nonfinite=2)
    assert tr.stop_training is True
    assert int(tr.state.step) == 4  # stopped at the second bad window


def test_unguarded_trainer_rejects_rollback_arg():
    tr, ds = _linear()
    tr.nonfinite_guard = False
    with pytest.raises(ValueError, match="nonfinite_guard"):
        tr.fit(ds, epochs=1, rollback_after_nonfinite=2)


def test_quarantined_window_excluded_from_epoch_logs():
    tr, ds = _linear(poison=slice(8, 12))
    logs = {}
    history = tr.fit(ds, epochs=1, callbacks=[trainer.LambdaCallback(
        on_epoch_end=lambda e, epoch_logs, t: logs.update(epoch_logs))])
    assert np.isfinite(logs["loss"])
    assert np.isfinite(history.history["loss"][0])


# --- the drill ------------------------------------------------------------------


def test_check_durability_drill_on_cpu(tmp_path):
    """kill -9 mid-fit, the newest step garbled and a byte flipped in the
    newest manifested one, a resume in a fresh process: bit-exact with
    the control run (three torch-only processes, seconds)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "cloud_tpu_torch.training.check_durability",
         "--device", "cpu", "--model", "mnist",
         "--tmp-dir", str(tmp_path / "drill")],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=120)
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]
    summary = lines[-1]
    assert summary["phase"] == "summary"
    assert summary["ok"] is True and summary["digest_match"] is True
    assert summary["max_loss_err"] == 0.0
    resume = next(p for p in lines if p["phase"] == "resume")
    assert resume["fallbacks"] >= 2 and len(resume["quarantined"]) >= 2
    # A work directory given with --tmp-dir is kept for inspection.
    quarantine = tmp_path / "drill" / "ckpt" / "quarantine"
    assert sorted(os.listdir(quarantine)) == resume["quarantined"]
