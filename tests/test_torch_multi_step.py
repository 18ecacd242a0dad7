"""The port's multi-step window (``train.make_multi_step``) against the JAX package's, on the CPU.

``RESNET8_CIFAR`` in f32 from the same weights (through ``bridge``) and
the same super-batch of K = 3 batches: JAX ``make_multi_step`` against the
port's, with ``sgd(0.1, momentum=0.9)`` and AdamW, for ``valid=None``, a
padded tail ``[1, 1, 0]`` and an all-padded window (metrics 0, state
untouched).  Parameters agree within 1e-5 of their leaf's largest
magnitude, window metrics within 1e-4.  On the CPU the window runs the
same step bodies as K sequential ``make_train_step`` calls, so the two
agree exactly.  The ``ValueError`` messages are JAX's, and
``resnet_train_setup(steps_per_dispatch=2)`` draws JAX's numpy arrays.
The CUDA-graph route is held on the card by ``chip_smoke.py`` phase 4f.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.models import resnet as jax_resnet
from cloud_tpu.training import train as jax_train
from cloud_tpu.utils import benchmarking as jax_bench
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import resnet
from cloud_tpu_torch.ops import dispatch
from cloud_tpu_torch.training import optimizers, train
from cloud_tpu_torch.utils import benchmarking
from tests.helpers.torch_port import resnet8_models

torch.set_num_threads(1)

K, B = 3, 4
OPTIMIZERS = {
    "sgd": (lambda: optax.sgd(0.1, momentum=0.9),
            lambda: optimizers.sgd(0.1, momentum=0.9)),
    # The LM workload's rate (``benchmarking.lm_train_setup``).
    "adamw": (lambda: optax.adamw(1e-4),
              lambda: optimizers.adamw(1e-4, mu_dtype=None)),
}
VALID = {"full": None, "tail": (1.0, 1.0, 0.0), "padded": (0.0, 0.0, 0.0)}


def _super_batch(num_classes, seed=11):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, (K, B)).astype(np.int32)
    images = rng.standard_normal((K, B, 32, 32, 3)).astype(np.float32)
    return images, labels


def _port_state(params, tx):
    return train.create_sharded_state(
        None, lambda _: bridge.map_leaves(params, torch.clone), tx,
        device="cpu")


@pytest.fixture(scope="module")
def windows():
    """Per (optimizer, valid): the JAX window's params, step and metrics,
    and the port's, from the same start."""
    jax_cfg, params, cfg, port_params = resnet8_models(seed=3)
    images, labels = _super_batch(cfg.num_classes)
    port_batch = {"image": torch.from_numpy(images),
                  "label": torch.from_numpy(labels)}
    out = {}
    for opt, (make_jax, make_port) in OPTIMIZERS.items():
        tx = make_jax()
        jstep = jax_train.make_multi_step(
            functools.partial(jax_resnet.loss_fn, config=jax_cfg), tx,
            steps_per_dispatch=K)
        ptx = make_port()
        pstep = train.make_multi_step(
            functools.partial(resnet.loss_fn, config=cfg, device="cpu"), ptx,
            steps_per_dispatch=K)
        for name, valid in VALID.items():
            jstate = jax_train.create_sharded_state(
                jax.random.PRNGKey(0), lambda _: params, tx, mesh=None)
            args = () if valid is None else (jnp.asarray(valid, jnp.float32),)
            jstate, jm = jstep(jstate, {"image": images, "label": labels},
                               *args)
            pstate = _port_state(port_params, ptx)
            args = () if valid is None else (torch.tensor(valid),)
            pstate, pm = pstep(pstate, port_batch, *args)
            out[opt, name] = (
                (jax.tree_util.tree_leaves(jstate.params), int(jstate.step),
                 {k: float(v) for k, v in jm.items()}),
                (jax.tree_util.tree_leaves(
                    bridge.resnet_to_numpy(pstate.params)), int(pstate.step),
                 {k: float(v) for k, v in pm.items()}))
    return params, out


@pytest.mark.parametrize("valid", sorted(VALID))
@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_window_matches_jax(windows, opt, valid):
    """Parameters within 1e-5 of max(1, max |p|) of their leaf, the step
    count exactly, window metrics within 1e-4; an all-padded window runs
    nothing: metrics 0 and the parameters as they were."""
    start, out = windows
    (jp, jstep, jm), (pp, pstep, pm) = out[opt, valid]
    assert pstep == jstep == K - VALID_SKIPPED[valid]
    assert sorted(pm) == sorted(jm)
    for key in jm:
        np.testing.assert_allclose(pm[key], jm[key], rtol=0, atol=1e-4,
                                   err_msg=key)
    assert len(pp) == len(jp)
    for a, b in zip(pp, jp):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(b).max()))
    if valid == "padded":
        assert all(v == 0.0 for v in pm.values())
        for a, b in zip(pp, jax.tree_util.tree_leaves(start)):
            np.testing.assert_array_equal(a, np.asarray(b))


VALID_SKIPPED = {"full": 0, "tail": 1, "padded": K}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_window_equals_sequential_steps_exactly(opt):
    """On the CPU a window is K ``make_train_step`` steps, bit for bit:
    parameters, optimizer state and step count; its metrics are the f32
    means of the steps'."""
    _, _, cfg, port_params = resnet8_models(seed=3)
    images, labels = _super_batch(cfg.num_classes, seed=12)
    loss = functools.partial(resnet.loss_fn, config=cfg, device="cpu")
    tx = OPTIMIZERS[opt][1]()
    window_state, metrics = train.make_multi_step(
        loss, tx, steps_per_dispatch=K)(
            _port_state(port_params, tx),
            {"image": torch.from_numpy(images),
             "label": torch.from_numpy(labels)})
    state = _port_state(port_params, tx)
    step = train.make_train_step(loss, tx)
    per_step = []
    for i in range(K):
        state, m = step(state, {"image": torch.from_numpy(images[i]),
                                "label": torch.from_numpy(labels[i])})
        per_step.append(m)
    assert int(window_state.step) == int(state.step) == K
    for a, b in zip(bridge.leaves(window_state.params),
                    bridge.leaves(state.params)):
        assert torch.equal(a, b)
    for a, b in zip(bridge.leaves(window_state.opt_state),
                    bridge.leaves(state.opt_state)):
        assert torch.equal(a, b)
    for key, value in metrics.items():
        mean = torch.stack([m[key].float() for m in per_step]).sum(0) / K
        assert torch.equal(value, mean), key


def _jax_message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_steps_per_dispatch_below_one_raises_as_jax():
    want = _jax_message(lambda: jax_train.make_multi_step(
        lambda p, b: None, optax.sgd(0.1), steps_per_dispatch=0))
    with pytest.raises(ValueError) as got:
        train.make_multi_step(lambda p, b: None, optimizers.sgd(0.1),
                              steps_per_dispatch=0)
    assert str(got.value) == want


def test_super_batch_leading_axis_raises_as_jax():
    """A super-batch of two batches for a window of three."""
    images = np.zeros((2, 1, 2), np.float32)
    want = _jax_message(lambda: jax_train.make_multi_step(
        lambda p, b: (jnp.sum(p["w"] * b["x"]), {}), optax.sgd(0.1),
        steps_per_dispatch=K)(
            jax_train.create_sharded_state(
                jax.random.PRNGKey(0), lambda _: {"w": jnp.ones(2)},
                optax.sgd(0.1), mesh=None),
            {"x": images}))
    tx = optimizers.sgd(0.1)
    state = train.create_sharded_state(None, lambda _: {"w": torch.ones(2)},
                                       tx, device="cpu")
    with pytest.raises(ValueError) as got:
        train.make_multi_step(
            lambda p, b: ((p["w"] * b["x"]).sum(), {}), tx,
            steps_per_dispatch=K)(state, {"x": torch.from_numpy(images)})
    assert str(got.value) == want


@pytest.mark.parametrize("option", [
    {"mesh": object()}, {"stochastic": True}, {"accum_steps": 2},
    {"skip_nonfinite": True}, {"logical_axes": {}}, {"rules": object()},
], ids=lambda o: next(iter(o)))
def test_unported_window_options_raise_as_the_step(option):
    """The window refuses what the step refuses; ``accum_steps`` and
    ``skip_nonfinite`` are ported (held to JAX in
    ``tests/test_torch_trainer.py``) and build a window that runs."""
    if next(iter(option)) in ("accum_steps", "skip_nonfinite"):
        state = train.create_sharded_state(
            None, lambda _: {"w": torch.ones(3)}, optimizers.sgd(0.1),
            device="cpu")
        window = train.make_multi_step(
            lambda p, b: ((p["w"] * b["x"]).mean(), {}), optimizers.sgd(0.1),
            steps_per_dispatch=2, **option)
        state, metrics = window(state, {"x": torch.ones(2, 4, 3)})
        assert int(state.step) == 2
        assert all(torch.isfinite(v) for v in metrics.values())
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.6"):
        train.make_multi_step(lambda p, b: None, optimizers.sgd(0.1),
                              steps_per_dispatch=2, **option)


def test_window_on_cpu_counts_no_launch():
    """The CPU route runs the plain versions: no kernel counter moves."""
    _, _, cfg, port_params = resnet8_models(seed=3)
    images, labels = _super_batch(cfg.num_classes, seed=13)
    tx = optimizers.sgd(0.1, momentum=0.9)
    dispatch.reset_launch_counts()
    train.make_multi_step(
        functools.partial(resnet.loss_fn, config=cfg, device="cpu"), tx,
        steps_per_dispatch=K)(
            _port_state(port_params, tx),
            {"image": torch.from_numpy(images),
             "label": torch.from_numpy(labels)})
    assert not any(dispatch.launch_counts().values())


def test_capture_records_launches_for_replays(monkeypatch):
    """Launches on a stream under ``capturing_launches`` go to its record,
    from any thread (autograd runs a captured backward on its own worker
    thread), and not to the counts; a launch on another stream counts;
    each ``replay_launches`` adds the record once."""
    streams = threading.local()
    monkeypatch.setattr(dispatch, "_current_stream",
                        lambda: getattr(streams, "current", 0))
    dispatch.reset_launch_counts()

    def worker():
        streams.current = 7
        dispatch.count_launch("gn_bwd")

    with dispatch.capturing_launches(7) as record:
        streams.current = 7
        dispatch.count_launch("gn_fwd")
        dispatch.count_launch("gn_fwd")
        thread = threading.Thread(target=worker)
        thread.start()
        thread.join()
        streams.current = 0
        dispatch.count_launch("flash_fwd")
    assert record == {"gn_fwd": 2, "gn_bwd": 1}
    assert dispatch.launch_counts(["gn_fwd", "gn_bwd", "flash_fwd"]) == {
        "gn_fwd": 0, "gn_bwd": 0, "flash_fwd": 1}
    for _ in range(3):
        dispatch.replay_launches(record)
    dispatch.count_launch("gn_fwd")
    assert dispatch.launch_counts(["gn_fwd", "gn_bwd", "flash_fwd"]) == {
        "gn_fwd": 7, "gn_bwd": 3, "flash_fwd": 1}
    dispatch.reset_launch_counts()


def test_fused_resnet_setup_draws_jax_arrays(monkeypatch):
    """The fused workload's super-batch: labels ``[K, B]`` first, then
    images ``[K, B, 32, 32, 3]``, from ``default_rng(0)`` as in JAX (its
    ResNet-50 state is not built here: only the draws are compared); the
    port's window runs on it and ``fused_throughput`` counts steps."""
    monkeypatch.setattr(jax_train, "create_sharded_state",
                        lambda *a, **k: None)
    _, _, want = jax_bench.resnet_train_setup(
        imagenet_shape=False, batch_size=2, steps_per_dispatch=2)
    step, state, got = benchmarking.resnet_train_setup(
        imagenet_shape=False, batch_size=2, steps_per_dispatch=2,
        device="cpu")
    assert got["image"].shape == (2, 2, 32, 32, 3)
    np.testing.assert_array_equal(got["image"].numpy(),
                                  np.asarray(want["image"]))
    np.testing.assert_array_equal(got["label"].numpy(),
                                  np.asarray(want["label"]))
    assert step.steps_per_dispatch == 2
    rate = benchmarking.fused_throughput(step, state, got,
                                         steps_per_dispatch=2, warmup=1,
                                         iters=1)
    assert rate > 0 and int(state.step) == 4
