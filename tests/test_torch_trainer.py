"""The port's Trainer (``cloud_tpu_torch.training.trainer``) against the JAX package's, on the CPU.

The same weights (JAX's init, through ``bridge``) and the same shuffled
``ArrayDataset`` go through ``Trainer.fit`` on both sides:

* MNIST (hidden 16, batch 8, 6 batches an epoch, two epochs, with
  validation) with ``optax.sgd(0.1)`` against the port's ``sgd(0.1)``, at
  ``prefetch`` 0 and 2 and ``steps_per_dispatch`` 1 and 4 (a window of 4
  and a 2-of-4 tail): every epoch's History logs and the final params
  within 1e-5 (f32), the data position after every dispatch exactly;
* ResNet TINY (``RESNET8_CIFAR``, f32, SGD momentum), two epochs with
  validation: params within 1e-5 of their leaf's largest magnitude,
  every logged metric within 1e-5 of max(1, |value|);
* the callbacks' cadence (``LambdaCallback``, ``EarlyStopping`` with the
  best state restored, ``TerminateOnNaN``), ``make_eval_step`` (1e-5),
  gradient accumulation (``accum_steps=2``, step and window, 1e-5 of
  max(1, max |p|)) and its error on a batch that does not divide (JAX's
  message);
* the non-finite guard: the reference's poisoned-batch scenario, eager
  and in a window (the skip counted and spanned, params within 1e-7 of a
  run that never saw the batch, 1e-6 of JAX's), and a skipped step
  leaving params and every optimizer slot bit for bit;
* every option of a later item raising ``NotImplementedError`` that
  names it, and the options of the ported items (stochastic steps,
  ``train_rng``, compile-ahead, ``batch_spec``, a one-rank mesh) held to
  JAX or to the run without them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.models import mnist as jax_mnist
from cloud_tpu.models import resnet as jax_resnet
from cloud_tpu.training import data as jax_data
from cloud_tpu.training import train as jax_train
from cloud_tpu.training import trainer as jax_trainer
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import mnist, resnet
from cloud_tpu_torch.monitoring import metrics, tracing
from cloud_tpu_torch.training import (checkpoint, data, optimizers,
                                      pipeline_io, train, trainer)
from tests.helpers.torch_port import mnist_models, resnet8_models
from helpers.torch_sigterm import sigterm_restored  # noqa: F401

torch.set_num_threads(1)

BATCH = 8


def _arrays(n, seed=0, dim=784):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(n, dim)).astype(np.float32),
            "label": rng.integers(0, 10, n).astype(np.int64)}


def _jax_trainer(loss, tx, params, **kw):
    tr = jax_trainer.Trainer(
        loss, tx, init_fn=lambda _: jax.tree_util.tree_map(jnp.asarray,
                                                           params), **kw)
    tr.init_state(jax.random.PRNGKey(0))
    return tr


def _port_trainer(loss, tx, params, **kw):
    tr = trainer.Trainer(loss, tx,
                         init_fn=lambda _: bridge.map_leaves(params,
                                                             torch.clone),
                         device="cpu", **kw)
    tr.init_state(None)
    return tr


def _mnist_pair(**kw):
    jax_cfg, jparams, cfg, pparams = mnist_models(seed=0)
    jtr = _jax_trainer(functools.partial(jax_mnist.loss_fn, config=jax_cfg),
                       optax.sgd(0.1), jparams, **kw)
    ptr = _port_trainer(functools.partial(mnist.loss_fn, config=cfg,
                                          device="cpu"),
                        optimizers.sgd(0.1), pparams, **kw)
    return jtr, ptr


def _leaves_np(tree):
    return [np.asarray(x.detach() if torch.is_tensor(x) else x)
            for x in bridge.leaves(tree)]


def _assert_logs(got, want, atol=1e-5):
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "epoch_seconds":
            continue
        for a, b in zip(got[key], want[key]):
            assert abs(a - b) <= atol * max(1.0, abs(b)), (key, a, b)


def _spy(seen):
    return lambda step, logs, tr: seen.append((step, dict(tr.data_state)))


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_fit_matches_jax_mnist(prefetch, k):
    """History logs and final params within 1e-5, the data position after
    every dispatch and at the end exactly, the step count exactly."""
    jtr, ptr = _mnist_pair()
    arrays, val = _arrays(48), _arrays(16, seed=1)
    runs = []
    for tr, lib, cb in ((jtr, jax_data, jax_trainer.LambdaCallback),
                        (ptr, data, trainer.LambdaCallback)):
        seen = []
        hist = tr.fit(lib.ArrayDataset(arrays, BATCH, shuffle=True, seed=3),
                      epochs=2, steps_per_dispatch=k, prefetch=prefetch,
                      validation_data=lib.ArrayDataset(val, BATCH),
                      callbacks=[cb(on_step_end=_spy(seen))])
        runs.append((hist.history, seen, dict(tr.data_state),
                     int(tr.state.step), _leaves_np(tr.state.params)))
    (jh, jseen, jpos, jstep, jp), (ph, pseen, ppos, pstep, pp) = runs
    assert pseen == jseen and ppos == jpos
    assert pstep == jstep == 12
    _assert_logs(ph, jh)
    for a, b in zip(pp, jp):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_consumed_counted_at_dispatch_not_prefetch():
    """The prefetcher pulls ahead; only dispatched batches count (the
    reference's assertion and JAX's sequence)."""
    jtr, ptr = _mnist_pair()
    seqs = []
    for tr, lib, cb in ((jtr, jax_data, jax_trainer.LambdaCallback),
                        (ptr, data, trainer.LambdaCallback)):
        seen = []
        tr.fit(lib.ArrayDataset(_arrays(48), BATCH), epochs=1,
               steps_per_epoch=3, prefetch=2,
               callbacks=[cb(on_step_end=_spy(seen))])
        seqs.append(([pos for _, pos in seen], dict(tr.data_state)))
    assert seqs[1] == seqs[0]
    assert seqs[1][0] == [{"epoch": 0, "batches_consumed": i, "seed": 0}
                          for i in (1, 2, 3)]
    assert seqs[1][1] == {"epoch": 1, "batches_consumed": 0, "seed": 0}


def test_fit_matches_jax_resnet_tiny():
    """RESNET8_CIFAR f32, SGD momentum, two epochs with validation: params
    within 1e-5 of max(1, max |p|) per leaf, logs within 1e-5."""
    jax_cfg, jparams, cfg, pparams = resnet8_models(seed=3)
    rng = np.random.default_rng(5)

    def images(n):
        return {"image": rng.standard_normal((n, 32, 32, 3)).astype(
            np.float32), "label": rng.integers(0, 10, n).astype(np.int32)}

    arrays, val = images(12), images(8)
    jtr = _jax_trainer(functools.partial(jax_resnet.loss_fn, config=jax_cfg),
                       optax.sgd(0.1, momentum=0.9), jparams)
    ptr = _port_trainer(functools.partial(resnet.loss_fn, config=cfg,
                                          device="cpu"),
                        optimizers.sgd(0.1, momentum=0.9), pparams)
    hists = []
    for tr, lib in ((jtr, jax_data), (ptr, data)):
        hists.append(tr.fit(lib.ArrayDataset(arrays, 4, shuffle=True,
                                             seed=1),
                            epochs=2, prefetch=2,
                            validation_data=lib.ArrayDataset(val, 4)).history)
    assert any(key.startswith("val_") for key in hists[1])
    _assert_logs(hists[1], hists[0])
    for a, b in zip(_leaves_np(bridge.resnet_to_numpy(ptr.state.params)),
                    jax.tree_util.tree_leaves(jtr.state.params)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(b).max()))


def test_callback_cadence_matches_jax():
    """LambdaCallback at K=4 (windows end at 4, 6, 10, 12), epoch hooks
    once an epoch, TerminateOnNaN's stop step (every step and every 2),
    and EarlyStopping's stop epoch and restored best state."""
    poisoned = _arrays(48)
    poisoned["image"][16:24] = np.nan  # batch 3 (no shuffle): step 3
    results = []
    for side in ("jax", "port"):
        jtr, ptr = _mnist_pair()
        tr = jtr if side == "jax" else ptr
        lib = jax_trainer if side == "jax" else trainer
        dlib = jax_data if side == "jax" else data
        steps, epochs = [], []
        tr.fit(dlib.ArrayDataset(_arrays(48), BATCH), epochs=2,
               steps_per_dispatch=4, callbacks=[lib.LambdaCallback(
                   on_step_end=lambda s, logs, t: steps.append(s),
                   on_epoch_end=lambda e, logs, t: epochs.append(e))])
        stops = []
        for every in (1, 2):
            jt, pt = _mnist_pair()
            nan_cb = lib.TerminateOnNaN(check_every_n_steps=every)
            (jt if side == "jax" else pt).fit(
                dlib.ArrayDataset(poisoned, BATCH), epochs=1,
                callbacks=[nan_cb])
            stops.append(nan_cb.stopped_step)
        jt, pt = _mnist_pair()
        tr = jt if side == "jax" else pt
        early = lib.EarlyStopping("loss", mode="max", patience=0,
                                  restore_best_state=True)
        tr.fit(dlib.ArrayDataset(_arrays(48), BATCH), epochs=3,
               callbacks=[early])
        results.append((steps, epochs, stops, early.stopped_epoch,
                        int(tr.state.step), _leaves_np(tr.state.params)))
    (js, je, jstop, jearly, jstep, jp), (ps, pe, pstop, pearly, pstep,
                                         pp) = results
    assert ps == js == [4, 6, 10, 12] and pe == je == [0, 1]
    assert pstop == jstop == [3, 4]
    assert pearly == jearly == 1
    assert pstep == jstep == 6  # the best (first) epoch's state
    for a, b in zip(pp, jp):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


class _FakeTrainer:
    def __init__(self):
        self.state = None
        self.stop_training = False


@pytest.mark.parametrize("case", [
    ("loss", dict(mode="min", patience=1), [3.0, 2.0, 2.5, 2.6, 1.0]),
    ("val_accuracy", dict(patience=0), [0.5, 0.7, 0.6]),
    ("loss", dict(mode="min", min_delta=0.5, patience=0), [3.0, 2.8, 2.7]),
], ids=["patience", "auto-max", "min-delta"])
def test_early_stopping_semantics_match_jax(case):
    monitor, kw, values = case
    out = []
    for lib in (jax_trainer, trainer):
        cb, tr = lib.EarlyStopping(monitor, **kw), _FakeTrainer()
        cb.on_train_begin(tr)
        for epoch, v in enumerate(values):
            cb.on_epoch_end(epoch, {monitor: v}, tr)
            if tr.stop_training:
                break
        out.append((tr.stop_training, cb.stopped_epoch))
    assert out[1] == out[0] and out[1][0]


def test_eval_step_matches_jax():
    jax_cfg, jparams, cfg, pparams = mnist_models(seed=2)
    batch = _arrays(BATCH, seed=4)
    jstate = jax_train.TrainState(step=jnp.zeros((), jnp.int32),
                                  params=jparams, opt_state=None)
    want = jax_train.make_eval_step(functools.partial(
        jax_mnist.loss_fn, config=jax_cfg))(jstate, batch)
    pstate = train.TrainState(step=torch.zeros((), dtype=torch.int32),
                              params=pparams, opt_state=None)
    got = train.make_eval_step(functools.partial(
        mnist.loss_fn, config=cfg, device="cpu"))(
        pstate, pipeline_io.place_batch(batch, "cpu"))
    assert sorted(got) == sorted(want)
    for key in want:
        assert not got[key].requires_grad
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("route", ["step", "window"])
def test_accum_steps_matches_jax(route):
    """accum_steps=2 on RESNET8 b4 with SGD momentum, two steps (or one
    window of 2): params within 1e-5 of max(1, max |p|), metrics 1e-5."""
    jax_cfg, jparams, cfg, pparams = resnet8_models(seed=3)
    rng = np.random.default_rng(9)
    images = rng.standard_normal((2, 4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (2, 4)).astype(np.int32)
    jtx, ptx = optax.sgd(0.1, momentum=0.9), optimizers.sgd(0.1,
                                                             momentum=0.9)
    jloss = functools.partial(jax_resnet.loss_fn, config=jax_cfg)
    ploss = functools.partial(resnet.loss_fn, config=cfg, device="cpu")
    jstate = jax_train.create_sharded_state(
        jax.random.PRNGKey(0), lambda _: jparams, jtx, mesh=None)
    pstate = train.create_sharded_state(
        None, lambda _: bridge.map_leaves(pparams, torch.clone), ptx,
        device="cpu")
    if route == "step":
        jstep = jax_train.make_train_step(jloss, jtx, accum_steps=2)
        pstep = train.make_train_step(ploss, ptx, accum_steps=2)
        for i in range(2):
            jstate, jm = jstep(jstate, {"image": images[i],
                                        "label": labels[i]})
            pstate, pm = pstep(pstate, {"image": torch.from_numpy(images[i]),
                                        "label": torch.from_numpy(labels[i])})
    else:
        jstate, jm = jax_train.make_multi_step(
            jloss, jtx, steps_per_dispatch=2, accum_steps=2)(
            jstate, {"image": images, "label": labels})
        pstate, pm = train.make_multi_step(
            ploss, ptx, steps_per_dispatch=2, accum_steps=2)(
            pstate, {"image": torch.from_numpy(images),
                     "label": torch.from_numpy(labels)})
    assert int(pstate.step) == int(jstate.step) == 2
    assert sorted(pm) == sorted(jm)
    for key in jm:
        np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=0,
                                   atol=1e-5 * max(1.0, abs(float(jm[key]))))
    for a, b in zip(_leaves_np(bridge.resnet_to_numpy(pstate.params)),
                    jax.tree_util.tree_leaves(jstate.params)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(b).max()))


def test_accum_batch_must_divide_as_jax():
    def jloss(params, batch):
        return jnp.sum(params["w"] * batch["x"]), {}

    jstate = jax_train.TrainState(step=jnp.zeros((), jnp.int32),
                                  params={"w": jnp.ones(3)},
                                  opt_state=optax.sgd(0.1).init(
                                      {"w": jnp.ones(3)}))
    with pytest.raises(ValueError) as want:
        jax_train.make_train_step(jloss, optax.sgd(0.1), accum_steps=3)(
            jstate, {"x": np.ones((8, 3), np.float32)})
    state = train.create_sharded_state(
        None, lambda _: {"w": torch.ones(3)}, optimizers.sgd(0.1),
        device="cpu")
    with pytest.raises(ValueError) as got:
        train.make_train_step(
            lambda p, b: ((p["w"] * b["x"]).sum(), {}), optimizers.sgd(0.1),
            accum_steps=3)(state, {"x": torch.ones(8, 3)})
    assert str(got.value) == str(want.value)


# --- the non-finite guard -------------------------------------------------


def _linear(poison=None):
    """The reference's linear fixture: x [24, 4], y [24, 2], batch 4; the
    rows of ``poison`` hold NaN."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(24, 4)).astype(np.float32)
    y = rng.normal(size=(24, 2)).astype(np.float32)
    if poison is not None:
        x[poison] = np.nan
    w = np.array(jax.random.normal(jax.random.PRNGKey(1), (4, 2)) * 0.1)
    return {"x": x, "y": y}, {"w": w}


def _jax_linear(params, batch):
    loss = jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
    return loss, {"loss": loss}


def _port_linear(params, batch):
    loss = torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
    return loss, {"loss": loss.detach()}


def _counter(name):
    return metrics.snapshot()["counters"].get(name, 0)


@pytest.mark.parametrize("k", [1, 2], ids=["eager", "window"])
def test_poisoned_step_skipped_on_device(k):
    """One NaN batch: the update is skipped (params match a run that never
    saw the batch within 1e-7, and JAX's guarded run within 1e-6), the step
    counter still advances, and the skip is counted and spanned."""
    arrays, params = _linear(poison=slice(8, 12))
    jtr = _jax_trainer(_jax_linear, optax.sgd(0.01), params,
                       nonfinite_guard=True)
    jtr.fit(jax_data.ArrayDataset(arrays, 4), epochs=1,
            steps_per_dispatch=k)
    ptr = _port_trainer(_port_linear, optimizers.sgd(0.01),
                        {"w": torch.from_numpy(params["w"])},
                        nonfinite_guard=True)
    before = _counter("train/nonfinite_skips")
    with tracing.collecting() as collector:
        ptr.fit(data.ArrayDataset(arrays, 4), epochs=1, steps_per_dispatch=k)
    assert _counter("train/nonfinite_skips") == before + 1
    assert int(ptr.state.step) == 6
    got = ptr.state.params["w"].detach().numpy()
    assert np.isfinite(got).all()
    spans = [e for e in collector.events()
             if e["name"] == "train/nonfinite_skip"]
    assert len(spans) == 1 and spans[0]["args"]["step"] == (3 if k == 1
                                                            else 4)
    keep = np.concatenate([np.arange(0, 8), np.arange(12, 24)])
    clean, _ = _linear()
    ref = _port_trainer(_port_linear, optimizers.sgd(0.01),
                        {"w": torch.from_numpy(params["w"])})
    ref.fit(data.ArrayDataset({n: a[keep] for n, a in clean.items()}, 4),
            epochs=1)
    np.testing.assert_allclose(got, ref.state.params["w"].detach().numpy(),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(got, np.asarray(jtr.state.params["w"]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("opt", ["sgd_momentum", "adamw"])
@pytest.mark.parametrize("k", [1, 2], ids=["eager", "window"])
def test_skipped_step_leaves_state_bit_for_bit(k, opt):
    """A poisoned batch (eager) or slot (a window of 2, the poisoned slot
    second) leaves the params and every optimizer slot (momentum; AdamW's
    moments and count) exactly as the good batch left them; ``nonfinite``
    is 1 for the bad step (1/2 as the window's mean) and the step count
    advances."""
    arrays, params = _linear()
    tx = (optimizers.sgd(0.1, momentum=0.9) if opt == "sgd_momentum"
          else optimizers.adamw(1e-2, mu_dtype=None))
    good = {n: torch.from_numpy(a[:4]) for n, a in arrays.items()}
    bad = {"x": torch.full((4, 4), float("nan")), "y": good["y"]}

    def fresh():
        return train.create_sharded_state(
            None, lambda _: {"w": torch.from_numpy(params["w"].copy())}, tx,
            device="cpu")

    want, m = train.make_train_step(_port_linear, tx, skip_nonfinite=True)(
        fresh(), good)
    assert float(m["nonfinite"]) == 0.0
    if k == 1:
        got, m = train.make_train_step(_port_linear, tx,
                                       skip_nonfinite=True)(
            train.TrainState(step=want.step.clone(),
                             params=bridge.map_leaves(
                                 want.params, lambda t: t.detach().clone()
                                 .requires_grad_(True)),
                             opt_state=bridge.map_leaves(want.opt_state,
                                                         torch.clone)), bad)
        assert float(m["nonfinite"]) == 1.0 and int(got.step) == 2
    else:
        got, m = train.make_multi_step(_port_linear, tx, steps_per_dispatch=2,
                                       skip_nonfinite=True)(
            fresh(), {n: torch.stack([good[n], bad[n]]) for n in good})
        assert float(m["nonfinite"]) == 0.5 and int(got.step) == 2
    for a, b in zip(bridge.leaves(got.params) + bridge.leaves(got.opt_state),
                    bridge.leaves(want.params) + bridge.leaves(want.opt_state)):
        assert torch.equal(a.detach(), b.detach())


# --- refusals --------------------------------------------------------------


def _tiny_trainer(**kw):
    return trainer.Trainer(_port_linear, optimizers.sgd(0.1),
                           init_fn=lambda _: {"w": torch.zeros(4, 2)},
                           device="cpu", **kw)


def _fit_with(**kw):
    tr = _tiny_trainer()
    tr.init_state(None)
    arrays, _ = _linear()
    tr.fit(data.ArrayDataset(arrays, 4), epochs=1, **kw)


def _jax_noisy_linear(params, batch, *, rng=None):
    x = batch["x"]
    if rng is not None:
        x = x * jax.random.bernoulli(rng, 0.9, x.shape).astype(x.dtype) / 0.9
    return _jax_linear(params, {"x": x, "y": batch["y"]})


def _port_noisy_linear(params, batch, *, rng=None):
    from cloud_tpu_torch import random as random_lib

    x = batch["x"]
    if rng is not None:
        x = x * random_lib.bernoulli(rng, 0.9, x.shape).to(x.dtype) / 0.9
    return _port_linear(params, {"x": x, "y": batch["y"]})


def _stochastic_trainer_key():
    """Trainer(stochastic=True).init_state derives the key JAX's does
    (from PRNGKey(seed); the port from a generator of that seed)."""
    jtr = jax_trainer.Trainer(_jax_linear, optax.sgd(0.1),
                              init_fn=lambda _: {"w": jnp.zeros((4, 2))},
                              stochastic=True)
    jtr.init_state(jax.random.PRNGKey(3))
    tr = _tiny_trainer(stochastic=True)
    tr.init_state(torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(tr.state.rng.numpy(),
                                  np.asarray(jtr.state.rng))


def _stochastic_step():
    """One stochastic step (input-noise dropout from the step's key) on
    both sides: loss and params within 1e-5, the key advanced alike."""
    arrays, params = _linear()
    batch = {k: v[:4] for k, v in arrays.items()}
    jstate = jax_train.create_sharded_state(
        None, lambda _: {"w": jnp.asarray(params["w"])}, optax.sgd(0.1),
        mesh=None, train_rng=jax.random.PRNGKey(7))
    jstate, jm = jax_train.make_train_step(
        _jax_noisy_linear, optax.sgd(0.1), stochastic=True)(jstate, batch)
    state = train.create_sharded_state(
        None, lambda _: {"w": torch.from_numpy(params["w"])},
        optimizers.sgd(0.1), train_rng=np.asarray(jax.random.PRNGKey(7)),
        device="cpu")
    state, m = train.make_train_step(_port_noisy_linear, optimizers.sgd(0.1),
                                     stochastic=True)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(state.params["w"].detach().numpy(),
                               np.asarray(jstate.params["w"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(state.rng.numpy(), np.asarray(jstate.rng))


def _state_with_train_rng():
    key = jax.random.PRNGKey(11)
    state = train.create_sharded_state(
        None, lambda _: {"w": torch.zeros(2)}, optimizers.sgd(0.1),
        train_rng=np.asarray(key), device="cpu")
    np.testing.assert_array_equal(state.rng.numpy(), np.asarray(key))


def _fit_ahead_equals_plain(**kw):
    """fit with compile-ahead (the CPU binds the plain step) logs what
    the plain fit logs, and its plan attached with no error."""
    arrays, _ = _linear()
    logs = []
    for ahead in (False, True):
        tr = _tiny_trainer()
        tr.init_state(None)
        hist = tr.fit(data.ArrayDataset(arrays, 4), epochs=1,
                      compile_ahead=ahead, **(kw if ahead else {}))
        logs.append(hist.history["loss"])
        if ahead:
            assert tr.compile_plan.error is None
            assert tr.compile_plan.steps["train_step"].compiled is not None
    assert logs[0] == logs[1]


def _one_rank_mesh():
    from cloud_tpu_torch.parallel import MeshSpec

    return MeshSpec({}).build(devices=["cpu"])


def _fit_as_without(**kw):
    """A Trainer given a one-rank mesh (the single-process step), or
    logical axes or rules without a mesh of several ranks, fits exactly as
    without them; a mesh that is not a ``parallel.mesh.Mesh`` raises
    ``TypeError``.  Trainers under a mesh of several ranks are held to JAX
    in ``tests/test_torch_fit_mesh.py``."""
    arrays, _ = _linear()
    got = []
    for opts in ({}, kw):
        tr = _tiny_trainer(**opts)
        tr.init_state(None)
        hist = tr.fit(data.ArrayDataset(arrays, 4), epochs=1)
        got.append((hist.history["loss"],
                    tr.state.params["w"].detach().numpy()))
    assert got[0][0] == got[1][0]
    np.testing.assert_array_equal(got[0][1], got[1][1])
    if "mesh" in kw:
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            _tiny_trainer(mesh=object())


def _prefetch_under_mesh():
    """Under a mesh the prefetcher places this rank's rows on the mesh's
    device (a mesh that is not a ``parallel.mesh.Mesh`` raises)."""
    batches = list(pipeline_io.prefetch_to_device(
        lambda: iter([{"x": np.ones(2, np.float32)}]),
        mesh=_one_rank_mesh())())
    assert batches[0]["x"].device == torch.device("cpu")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        pipeline_io.prefetch_to_device(list, mesh=object(), device="cpu")


def _windows_with_rules():
    """The windowed pipeline takes ``rules`` (the rows are already the
    rank's, so they change nothing) and ``mesh``: its windows are the ones
    without them (a mesh that is not a ``parallel.mesh.Mesh`` raises)."""
    batches = [{"x": np.full(2, i, np.float32)} for i in range(3)]
    plain = list(pipeline_io.prefetch_windows(
        lambda: iter(batches), 2, device="cpu")())
    for kw in ({"rules": object()}, {"mesh": _one_rank_mesh()}):
        got = list(pipeline_io.prefetch_windows(
            lambda: iter(batches), 2, device="cpu", **kw)())
        assert [n for n, _, _ in got] == [n for n, _, _ in plain] == [2, 1]
        for (_, a, va), (_, b, vb) in zip(got, plain):
            assert torch.equal(a["x"], b["x"])
            np.testing.assert_array_equal(va, vb)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        pipeline_io.prefetch_windows(list, 2, mesh=object(), device="cpu")


def _gcs_checkpoints_resume():
    """A fit checkpointing to ``gs://`` (a directory-backed fake client)
    every 2 steps keeps ``max_to_keep`` steps, and a fresh trainer resumes
    from the latest bit for bit."""
    import tempfile

    from helpers.torch_gcs_fake import DirectoryStorage

    storage = DirectoryStorage(tempfile.mkdtemp(prefix="fake-gcs-"))
    arrays, _ = _linear()

    def fit(epochs):
        tr = _tiny_trainer()
        tr.init_state(None)
        tr.fit(data.ArrayDataset(arrays, 4), epochs=epochs, callbacks=[
            checkpoint.CheckpointCallback(
                "gs://b/ckpt", every_n_steps=2, max_to_keep=2,
                device="cpu", storage_client=storage)])
        return tr

    first = fit(1)
    steps = int(first.state.step)
    manager = checkpoint.CheckpointManager("gs://b/ckpt", device="cpu",
                                           storage_client=storage)
    assert manager.steps()[-1] == steps and len(manager.steps()) == 2
    resumed = _tiny_trainer()
    resumed.init_state(None)
    assert checkpoint.resume_trainer_state(resumed, manager)
    assert int(resumed.state.step) == steps
    assert torch.equal(resumed.state.params["w"], first.state.params["w"])


#: Options that raised until their items were ported; each now runs and
#: is held to the JAX package or to the run without it (more in
#: test_torch_stochastic.py, test_torch_compile_cache.py,
#: test_torch_fit_mesh.py and test_torch_window_mesh.py).
PORTED = {
    "prefetch_windows(rules)": _windows_with_rules,
    "Trainer(mesh)": lambda: _fit_as_without(mesh=_one_rank_mesh()),
    "Trainer(logical_axes)": lambda: _fit_as_without(logical_axes={}),
    "Trainer(rules)": lambda: _fit_as_without(rules=object()),
    "prefetch_to_device(mesh)": _prefetch_under_mesh,
    "Trainer(stochastic)": _stochastic_trainer_key,
    "make_train_step(stochastic)": _stochastic_step,
    "create_sharded_state(train_rng)": _state_with_train_rng,
    "fit(compile_ahead)": _fit_ahead_equals_plain,
    "fit(batch_spec)": lambda: _fit_ahead_equals_plain(batch_spec={
        "x": np.zeros((4, 4), np.float32),
        "y": np.zeros((4, 2), np.float32)}),
    "CheckpointManager(gs://)": _gcs_checkpoints_resume,
}


@pytest.mark.parametrize("name", sorted(PORTED))
def test_once_refused_options_run(name):
    """Every option that raised until its item was ported (``PORTED``, a
    gs:// checkpoint directory and the windowed pipeline's ``rules``
    among them) runs, held to JAX or to the run without it."""
    PORTED[name]()
