"""The port's checkpoints (``cloud_tpu_torch.training.checkpoint``) against the JAX package's, on the CPU.

One scenario runs on both sides, each with its own manager, faults and
metrics (JAX: Orbax underneath; the port: its own format), and must give
equal observations: which saves land (the interval, a save not ahead of
the latest step), ``steps()``, ``verify`` statuses after saves at 2/4/6,
a byte flipped in the newest step and a manifest deleted, the walk-back
(restored step, ``checkpoint/fallbacks``, fallback reasons, quarantine
listing), a fault at ``checkpoint.commit``, a failed save that must not
drop the earlier manifests, ``verify`` raising, the ``checkpoint.verify``
corrupt seam, ``only_if_ahead=False`` and the extras sidecar.  Restored
params equal the saved ones exactly on each side.

Then the reference's ``TestCheckpointCallbackSatellites`` cases on the
port (interval crossings under fused dispatch, the train-end save off the
interval, quarantine gc by quarantine time, a double save failure
survived, no state at train end), the exact round trip of every dtype a
port state holds (bf16 bits equal to Orbax's round trip of the same
values), the snapshot taken at the save call, and the temporary
directory of an interrupted write.
"""

import dataclasses
import functools
import json
import logging
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.models import mnist as jax_mnist
from cloud_tpu.monitoring import metrics as jax_metrics
from cloud_tpu.monitoring import tracing as jax_tracing
from cloud_tpu.training import checkpoint as jax_ckpt
from cloud_tpu.training import trainer as jax_trainer
from cloud_tpu.utils import faults as jax_faults
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import mnist
from cloud_tpu_torch.monitoring import metrics, tracing
from cloud_tpu_torch.training import checkpoint, data, optimizers, trainer
from cloud_tpu_torch.training.train import TrainState
from cloud_tpu_torch.utils import faults
from tests.helpers.torch_port import mnist_models
from helpers.torch_sigterm import sigterm_restored  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_leaked_fault_plan():
    yield
    for lib in (faults, jax_faults):
        lib._clear_for_tests()
        os.environ.pop(lib.ENV_FAULT_PLAN, None)


def _mnist_arrays(n=48):
    rng = np.random.default_rng(0)
    return {"image": rng.normal(size=(n, 784)).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int64)}


class Side:
    """One implementation's modules and constructors."""

    def __init__(self, name):
        self.name = name
        port = name == "port"
        self.ck = checkpoint if port else jax_ckpt
        self.faults = faults if port else jax_faults
        self.metrics = metrics if port else jax_metrics
        self.tracing = tracing if port else jax_tracing

    def trainer(self, shift=0.0):
        jax_cfg, jparams, cfg, pparams = mnist_models(seed=0)
        if self.name == "port":
            tr = trainer.Trainer(
                functools.partial(mnist.loss_fn, config=cfg, device="cpu"),
                optimizers.sgd(0.1), device="cpu",
                init_fn=lambda _: bridge.map_leaves(
                    pparams, lambda t: t.clone() + shift))
            tr.init_state(None)
        else:
            tr = jax_trainer.Trainer(
                functools.partial(jax_mnist.loss_fn, config=jax_cfg),
                optax.sgd(0.1), init_fn=lambda _: jax.tree_util.tree_map(
                    lambda x: jnp.asarray(x) + shift, jparams))
            tr.init_state(jax.random.PRNGKey(0))
        return tr

    def manager(self, path, **kw):
        if self.name == "port":
            kw["device"] = "cpu"
        return self.ck.CheckpointManager(str(path), **kw)

    def callback(self, path, **kw):
        if self.name == "port":
            kw["device"] = "cpu"
        return self.ck.CheckpointCallback(str(path), **kw)

    def break_next_save(self, manager):
        """Make the manager's next underlying write raise ("disk full");
        returns the undo."""
        def full_disk(*args, **kwargs):
            raise RuntimeError("disk full")

        if self.name == "port":
            original = manager._start_write
            manager._start_write = full_disk
            return lambda: setattr(manager, "_start_write", original)
        original = manager._manager.save
        manager._manager.save = full_disk
        return lambda: setattr(manager._manager, "save", original)

    def at_step(self, state, step):
        """``state`` with its step counter at ``step``."""
        if self.name == "port":
            return dataclasses.replace(
                state, step=torch.tensor(step, dtype=torch.int32))
        return state.replace(step=jnp.asarray(step, jnp.int32))

    def counter(self, name):
        return self.metrics.snapshot()["counters"].get(name, 0)

    def params(self, tr):
        return [np.asarray(x.detach() if torch.is_tensor(x) else x)
                for x in jax.tree_util.tree_leaves(
                    bridge.leaves(tr.state.params) if self.name == "port"
                    else tr.state.params)]


def _flip_byte(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        original = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([original[0] ^ 0xFF]))


def _first_entry(root, step):
    with open(os.path.join(root, str(step), jax_ckpt.MANIFEST_NAME)) as f:
        return sorted(json.load(f)["entries"])[0]


def _quarantined(root):
    qdir = os.path.join(root, "quarantine")
    if not os.path.isdir(qdir):
        return []
    return sorted(name.rsplit("-", 1)[0] for name in os.listdir(qdir))


def _walk(side, manager, **kw):
    """resume_trainer_state into a fresh trainer: (returned, restored
    step, fallbacks counted, fallback reasons, steps left, quarantine)."""
    tr = side.trainer(shift=1.0)
    before = side.counter("checkpoint/fallbacks")
    with side.tracing.collecting() as collector:
        ok = side.ck.resume_trainer_state(tr, manager, **kw)
    reasons = [e["args"]["reason"] for e in collector.events()
               if e["name"] == "checkpoint/fallback"]
    return tr, (ok, int(tr.state.step),
                side.counter("checkpoint/fallbacks") - before, reasons,
                manager.steps(), _quarantined(manager.directory))


def _scenario(side, tmp_path):
    tr = side.trainer()
    state = tr.state
    out = {}
    root = tmp_path / side.name

    # Saves at 2/4/6 (interval 2): 5 is off the interval, the second 6 is
    # not ahead of the latest step.
    m = side.manager(root / "a", max_to_keep=3, save_interval_steps=2)
    out["saved"] = [m.save(s, side.at_step(state, s),
                           extras={"data_state": {"at": s}})
                    for s in (2, 4, 5, 6, 6)]
    m.wait()
    out["steps"] = m.steps()
    out["verified"] = [m.verify(s) for s in out["steps"]]
    out["extras"] = [m.read_extras(s) for s in (2, 4, 6, 5)]
    # Bit rot in the newest step, a commit marker lost in the middle one.
    a = str(root / "a")
    _flip_byte(os.path.join(a, "6", _first_entry(a, 6)))
    os.remove(os.path.join(a, "4", jax_ckpt.MANIFEST_NAME))
    out["damaged"] = [m.verify(s) for s in (2, 4, 6)]
    restored, out["walk"] = _walk(side, m)
    out["restored_equal"] = all(
        np.array_equal(x, y)
        for x, y in zip(side.params(restored), side.params(tr)))
    out["extras_after"] = m.read_extras(6)
    m.close()

    # A crash at the commit seam leaves that step unmanifested.
    m = side.manager(root / "b", save_interval_steps=2)
    with side.faults.inject([{"site": "checkpoint.commit", "nth": 1}]) as got:
        m.save(2, state)
        m.wait()
        m.save(4, state)
        m.wait()
    out["commit"] = (got.fired(), m.verify(2), m.verify(4))
    m.close()

    # A failed save keeps the earlier save's pending manifest.
    m = side.manager(root / "c")
    m.save(2, state)
    undo = side.break_next_save(m)
    with pytest.raises(RuntimeError, match="disk full"):
        m.save(4, state)
    undo()
    m.wait()
    out["failed_save"] = (m.verify(2), m.steps())
    m.close()

    # verify raising walks back and quarantines; the corrupt seam forces a
    # verdict once.
    m = side.manager(root / "d", save_interval_steps=2)
    for s in (2, 4, 6):
        m.save(s, side.at_step(state, s))
    m.wait()
    with side.faults.inject([{"site": "checkpoint.verify", "nth": 1}]):
        _, out["verify_error"] = _walk(side, m)
    with side.faults.inject([{"site": "checkpoint.verify", "mode": "corrupt",
                              "value": "corrupt", "nth": 1}]):
        out["seam"] = [m.verify(2), m.verify(2)]
    m.close()

    # only_if_ahead=False restores a state saved at step 0.
    m = side.manager(root / "e")
    m.save(0, side.trainer(shift=2.0).state)
    m.wait()
    fresh, walk0 = _walk(side, m)
    fresh, walk1 = _walk(side, m, only_if_ahead=False)
    out["step_zero"] = (walk0[0], walk1[0], all(
        np.array_equal(x, y + 2.0)
        for x, y in zip(side.params(fresh), side.params(tr))))
    m.close()
    return out


def test_scenario_matches_jax(tmp_path):
    jax_out = _scenario(Side("jax"), tmp_path)
    port_out = _scenario(Side("port"), tmp_path)
    assert port_out == jax_out
    # The reference's own expectations, spelled out.
    assert port_out["saved"] == [True, True, False, True, False]
    assert port_out["steps"] == [2, 4, 6]
    assert port_out["damaged"] == ["verified", "unmanifested", "corrupt"]
    assert port_out["walk"] == (True, 4, 1, ["corrupt"], [2, 4], ["step-6"])
    assert port_out["restored_equal"]
    assert port_out["commit"] == ({"checkpoint.commit": 1}, "unmanifested",
                                  "verified")
    assert port_out["failed_save"] == ("verified", [2])
    assert port_out["verify_error"] == (True, 4, 1, ["verify_error"], [2, 4],
                                        ["step-6"])
    assert port_out["seam"] == ["corrupt", "verified"]
    assert port_out["step_zero"] == (False, True, True)


# --- the reference's callback satellites, on the port -----------------------


def _port_fit(tmp_path, every, **fit_kw):
    side = Side("port")
    tr = side.trainer()
    cb = side.callback(tmp_path / "ckpt", every_n_steps=every)
    tr.fit(data.ArrayDataset(_mnist_arrays(), 8), callbacks=[cb], **fit_kw)
    return tr, checkpoint.CheckpointManager(str(tmp_path / "ckpt"),
                                            device="cpu")


def test_fused_dispatch_fires_on_interval_crossings(tmp_path):
    """Windows of 3 end at 3, 6, 9, 12: the every-4 trigger fires at each
    crossing (6, 9, 12), not only at lcm(3, 4) = 12."""
    tr, manager = _port_fit(tmp_path, 4, epochs=2, steps_per_dispatch=3)
    assert int(tr.state.step) == 12
    assert manager.steps() == [6, 9, 12]
    assert all(manager.verify(s) == "verified" for s in (6, 9, 12))


def test_train_end_save_lands_off_interval(tmp_path):
    tr, manager = _port_fit(tmp_path, 4, epochs=1)  # periodic save: 4
    assert manager.steps() == [4, 6]
    assert manager.verify(6) == "verified"


def test_checkpoint_carries_data_state(tmp_path):
    _, manager = _port_fit(tmp_path, 2, epochs=1)
    assert manager.read_extras(4) == {
        "data_state": {"epoch": 0, "batches_consumed": 4, "seed": 0},
    }


def test_quarantine_gc_prunes_by_quarantine_time(tmp_path):
    manager = checkpoint.CheckpointManager(str(tmp_path / "q"),
                                           max_to_keep=2, device="cpu")
    qdir = os.path.join(manager.directory, "quarantine")
    os.makedirs(qdir)
    # Quarantine order by name-timestamp: step-2 first, step-6 last;
    # mtimes inverted: the earliest-quarantined dir looks newest.
    for name, mtime in (("step-2-1000", 300.0), ("step-4-2000", 200.0),
                        ("step-6-3000", 100.0)):
        path = os.path.join(qdir, name)
        os.makedirs(path)
        os.utime(path, (mtime, mtime))
    manager._gc_quarantine(qdir)
    assert sorted(os.listdir(qdir)) == ["step-4-2000", "step-6-3000"]


def test_double_save_failure_survived(tmp_path):
    """Two periodic saves fail (the rebuilt manager's too): both absorbed,
    two save_failures, and the train-end save still lands."""
    before = Side("port").counter("checkpoint/save_failures")
    plan = [{"site": "checkpoint.save", "mode": "raise", "times": 2}]
    with faults.inject(plan) as active:
        tr, manager = _port_fit(tmp_path, 2, epochs=1)
    assert active.fired() == {"checkpoint.save": 2}
    assert Side("port").counter("checkpoint/save_failures") == before + 2
    assert int(tr.state.step) == 6
    assert manager.latest_step() == 6
    assert manager.verify(6) == "verified"


def test_on_train_end_without_state_logs_not_crashes(tmp_path, caplog):
    cb = checkpoint.CheckpointCallback(str(tmp_path / "nostate"),
                                       device="cpu")
    with caplog.at_level(logging.WARNING):
        cb.on_train_end(types.SimpleNamespace(state=None))
    assert "skipping final save" in caplog.text


# --- the format ---------------------------------------------------------------

DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32,
          torch.int64, torch.uint8, torch.int8, torch.bool)


def _values(dtype):
    base = torch.tensor([0.0, -0.0, 1.5, -2.25, 3e-3, 65504.0, float("inf"),
                         float("-inf"), float("nan"), 1e-8])
    if dtype.is_floating_point:
        return base.to(dtype).reshape(2, 5)
    if dtype == torch.bool:
        return torch.tensor([[True, False, True], [False, False, True]])
    return torch.arange(-6, 6).clamp(min=0 if dtype == torch.uint8
                                     else -6).to(dtype).reshape(3, 4)


def test_every_dtype_round_trips_exactly(tmp_path):
    """Every dtype a state holds comes back bit for bit (NaN, inf and -0.0
    included), a 0-d and an empty leaf too, with and without a template;
    bf16 bits equal Orbax's round trip of the same bits."""
    tree = {str(d): _values(d) for d in DTYPES}
    tree["scalar"] = torch.tensor(7, dtype=torch.int32)
    tree["empty"] = torch.zeros((0, 3), dtype=torch.bfloat16)
    state = TrainState(step=torch.tensor(3, dtype=torch.int32),
                       params=tree, opt_state={"count": torch.tensor(2)})
    manager = checkpoint.CheckpointManager(str(tmp_path / "port"),
                                           device="cpu")
    manager.save(3, state)
    manager.wait()
    for restored in (manager.restore(3), manager.restore(3, template=state)):
        for key, want in tree.items():
            got = restored.params[key]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            if want.is_floating_point():
                width = {2: torch.int16, 4: torch.int32}[want.element_size()]
                assert torch.equal(got.view(width), want.view(width)), key
            else:
                assert torch.equal(got, want), key
    jax_manager = jax_ckpt.CheckpointManager(str(tmp_path / "jax"))
    bits = tree["torch.bfloat16"].view(torch.int16).numpy()
    jax_manager.save(1, {"x": jnp.asarray(bits.view(jnp.bfloat16))})
    jax_manager.wait()
    jax_bits = np.asarray(jax_manager.restore(1)["x"]).view(np.int16)
    port_bits = manager.restore(3).params["torch.bfloat16"].view(
        torch.int16).numpy()
    np.testing.assert_array_equal(port_bits, jax_bits)
    np.testing.assert_array_equal(port_bits, bits)
    jax_manager.close()


def test_snapshot_taken_at_the_save_call(tmp_path):
    """The state is updated in place after save() returns: the checkpoint
    holds the values at the call."""
    state = TrainState(step=torch.tensor(1, dtype=torch.int32),
                       params={"w": torch.ones(4, requires_grad=True)},
                       opt_state={})
    manager = checkpoint.CheckpointManager(str(tmp_path / "s"), device="cpu")
    manager.save(1, state)
    with torch.no_grad():
        state.params["w"].add_(5.0)
        state.step.add_(1)
    manager.wait()
    restored = manager.restore(1, template=state)
    assert torch.equal(restored.params["w"].detach(), torch.ones(4))
    assert restored.params["w"].requires_grad and int(restored.step) == 1


def test_interrupted_write_is_not_listed(tmp_path):
    """A kill mid-write leaves a temporary dir, never a step; the next
    manager's first save clears it."""
    root = tmp_path / "k"
    os.makedirs(root / (checkpoint.TMP_PREFIX + "8-1234"))
    manager = checkpoint.CheckpointManager(str(root), device="cpu")
    assert manager.steps() == [] and manager.latest_step() is None
    manager.save(2, {"w": torch.ones(2)})
    manager.wait()
    assert manager.steps() == [2]
    assert sorted(os.listdir(root)) == ["2"]
