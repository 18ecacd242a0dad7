"""The port's train step and SGD momentum against the JAX package's, on the CPU.

Three chained steps of ``train.make_train_step`` with
``optimizers.sgd(0.1, momentum=0.9)`` on ``RESNET8_CIFAR`` in f32 (batch
4) against JAX ``make_train_step`` with ``optax.sgd(0.1, momentum=0.9)``
from the same weights: per step, loss, accuracy and ``grad_norm`` agree
to 1e-5 relative, and every parameter after step 3 to 1e-4 relative to
its largest magnitude.  Options the port does not have yet raise.
"""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.models import resnet as jax_resnet
from cloud_tpu.training import train as jax_train
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import resnet
from cloud_tpu_torch.training import optimizers, train
from cloud_tpu_torch.utils import benchmarking
from tests.helpers.torch_port import image_batch, resnet8_models

torch.set_num_threads(1)


def _port_step(cfg, params, lr=0.1, momentum=0.9):
    tx = optimizers.sgd(lr, momentum=momentum)
    state = train.create_sharded_state(None, lambda _: params, tx,
                                       device="cpu")
    loss = functools.partial(resnet.loss_fn, config=cfg, device="cpu")
    return train.make_train_step(loss, tx), state


def test_three_steps_match_jax_and_optax():
    jax_cfg, params, cfg, port_params = resnet8_models(seed=3)
    images, labels = image_batch(4, 32, cfg.num_classes, seed=7)

    tx = optax.sgd(0.1, momentum=0.9)
    jstate = jax_train.create_sharded_state(
        jax.random.PRNGKey(0), lambda _: params, tx, mesh=None)
    jstep = jax_train.make_train_step(
        functools.partial(jax_resnet.loss_fn, config=jax_cfg), tx)

    step, state = _port_step(cfg, port_params)
    batch = {"image": torch.from_numpy(images),
             "label": torch.from_numpy(labels)}
    for i in range(3):
        jstate, jm = jstep(jstate, {"image": images, "label": labels})
        state, m = step(state, batch)
        assert int(state.step) == i + 1
        for key in ("loss", "accuracy", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"{key} step {i}")
    want = jax.tree_util.tree_leaves(jstate.params)
    got = jax.tree_util.tree_leaves(bridge.resnet_to_numpy(state.params))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(b).max()))


def test_sgd_matches_optax_leafwise():
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        for _ in range(3)]
    for momentum in (None, 0.9):
        tx = optax.sgd(0.1, momentum=momentum)
        jp, jstate = params, tx.init(params)
        port = optimizers.sgd(0.1, momentum=momentum)
        tp = bridge.map_leaves(params, lambda a: torch.from_numpy(a.copy()))
        tstate = port.init(tp)
        for g in grads:
            updates, jstate = tx.update(g, jstate, jp)
            jp = optax.apply_updates(jp, updates)
            port.update_(tp, bridge.map_leaves(g, torch.from_numpy), tstate)
        for a, b in zip(bridge.leaves(tp), jax.tree_util.tree_leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_global_norm_matches_optax():
    rng = np.random.default_rng(1)
    tensors = [rng.standard_normal(s).astype(np.float32)
               for s in ((3, 3), (7,), (2, 2, 2))]
    np.testing.assert_allclose(
        float(train.global_norm([torch.from_numpy(t) for t in tensors])),
        float(optax.global_norm(tensors)), rtol=1e-6)


def test_resnet_train_setup_and_chained_throughput_on_cpu():
    step, state, batch = benchmarking.resnet_train_setup(
        imagenet_shape=False, batch_size=2, device="cpu")
    assert batch["image"].shape == (2, 32, 32, 3)
    assert batch["label"].dtype == torch.int64
    assert state.params["head"]["kernel"].shape == (2048, 10)
    rate = benchmarking.chain_then_read_throughput(step, state, batch,
                                                   warmup=1, iters=1)
    assert rate > 0
    assert int(state.step) == 0  # the caller's state object is not replaced
    _, metrics = step(state, batch)
    assert all(torch.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("option", [
    {"mesh": object()}, {"stochastic": True}, {"accum_steps": 2},
    {"skip_nonfinite": True}, {"logical_axes": {}},
])
def test_unsupported_step_options_raise(option):
    """Options of a later item raise naming it; ``accum_steps`` and
    ``skip_nonfinite`` are ported (held to JAX in
    ``tests/test_torch_trainer.py``) and build a step that runs."""
    if next(iter(option)) in ("accum_steps", "skip_nonfinite"):
        state = train.create_sharded_state(
            None, lambda _: {"w": torch.ones(3)}, optimizers.sgd(0.1),
            device="cpu")
        step = train.make_train_step(
            lambda p, b: ((p["w"] * b["x"]).mean(), {}), optimizers.sgd(0.1),
            **option)
        state, metrics = step(state, {"x": torch.ones(4, 3)})
        assert int(state.step) == 1
        assert all(torch.isfinite(v) for v in metrics.values())
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.6"):
        train.make_train_step(lambda p, b: None, optimizers.sgd(0.1),
                              **option)


def test_other_unsupported_entry_points_raise():
    with pytest.raises(ValueError, match="accum_steps"):
        train.make_train_step(lambda p, b: None, optimizers.sgd(0.1),
                              accum_steps=0)
    # make_multi_step and resnet_train_setup(steps_per_dispatch > 1) are
    # ported (tests/test_torch_multi_step.py); the window refuses what the
    # step refuses.
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.6"):
        train.make_multi_step(lambda p, b: None, optimizers.sgd(0.1),
                              steps_per_dispatch=2, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.6"):
        train.create_sharded_state(None, dict, optimizers.sgd(0.1),
                                   mesh=object(), device="cpu")
