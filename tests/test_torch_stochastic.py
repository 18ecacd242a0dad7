"""The port's stochastic steps (threefry keys, dropout, the rng chain) against the JAX package's, on the CPU.

* ``cloud_tpu_torch.random``: ``split`` (also of a batch of keys),
  ``bits``, ``uniform`` and ``bernoulli`` equal ``jax.random``'s bit for
  bit over several keys and shapes;
* ``layers.dropout`` equals JAX's ``layers.dropout`` exactly (f32), and
  is the identity without a key or at rate 0;
* BERT TINY at ``dropout_rate=0.1``: loss within 1e-5 (relative) and
  every gradient within 1e-5 of the largest magnitude, for the same key;
* the reference's rng-chain tests against JAX: a stochastic step threads
  the key (two steps, loss, params and key), accumulation draws one key
  a micro-batch, a padded window tail keeps the chain of as many
  sequential steps, and the non-finite guard still advances it;
* ``Trainer(stochastic=True)`` fits (one step a dispatch and windows of
  2) log JAX's epoch losses within 1e-5 and end on JAX's key; eval stays
  deterministic;
* ``adamw(mask=...)`` on BERT TINY's tree against the JAX preset with
  the same mask callable (three updates on the same gradients, 1e-6);
* the key survives a checkpoint's save and restore, and the CPU drill's
  workload is stochastic.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.models import bert as jax_bert
from cloud_tpu.models import layers as jax_layers
from cloud_tpu.training import data as jax_data
from cloud_tpu.training import optimizers as jax_opt
from cloud_tpu.training import train as jax_train
from cloud_tpu.training import trainer as jax_trainer
from cloud_tpu_torch import bridge
from cloud_tpu_torch import random as random_lib
from cloud_tpu_torch.models import bert, layers
from cloud_tpu_torch.parallel import sharding
from cloud_tpu_torch.training import (check_durability, checkpoint, data,
                                      optimizers, pipeline_io, train, trainer)
from tests.helpers.torch_port import bert_tiny_models
from helpers.torch_sigterm import sigterm_restored  # noqa: F401

torch.set_num_threads(1)

SEEDS = (0, 7, 12345, 2**31 + 5)


def _key(jax_key):
    return random_lib.as_key(np.asarray(jax_key))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_equals_jax_bit_for_bit(seed):
    jkey = jax.random.PRNGKey(seed)
    key = random_lib.PRNGKey(seed)
    np.testing.assert_array_equal(random_lib.key_data(key), np.asarray(jkey))
    for num in (2, 3, 12):
        np.testing.assert_array_equal(
            random_lib.key_data(random_lib.split(key, num)),
            np.asarray(jax.random.split(jkey, num)))
    batch = jax.random.split(jkey, 4)
    np.testing.assert_array_equal(
        random_lib.key_data(random_lib.split(_key(batch), 3)),
        np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(batch)))
    for shape in ((5,), (3, 7), (2, 3, 4, 5), ()):
        np.testing.assert_array_equal(
            random_lib.key_data(random_lib.random_bits(key, shape)),
            np.asarray(jax.random.bits(jkey, shape, jnp.uint32)))
        np.testing.assert_array_equal(
            random_lib.uniform(key, shape).numpy(),
            np.asarray(jax.random.uniform(jkey, shape)))
        for p in (0.1, 0.5, 0.9):
            np.testing.assert_array_equal(
                random_lib.bernoulli(key, p, shape).numpy(),
                np.asarray(jax.random.bernoulli(jkey, p, shape)))


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
def test_dropout_equals_jax(rate):
    x = np.random.default_rng(0).normal(size=(4, 9, 16)).astype(np.float32)
    jkey = jax.random.PRNGKey(3)
    want = np.asarray(jax_layers.dropout(jkey, jnp.asarray(x), rate))
    got = layers.dropout(_key(jkey), torch.from_numpy(x), rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert layers.dropout(None, torch.from_numpy(x), rate).numpy() is not None
    np.testing.assert_array_equal(
        layers.dropout(None, torch.from_numpy(x), rate).numpy(), x)


def _bert_batch(batch=3, seq=12, seed=5):
    rng = np.random.default_rng(seed)
    mask = np.ones((batch, seq), np.int32)
    mask[1, 8:] = 0
    return {"tokens": rng.integers(0, 512, (batch, seq)).astype(np.int32),
            "label": rng.integers(0, 2, batch).astype(np.int32),
            "attention_mask": mask}


def _bert(rate=0.1, seed=2):
    jax_cfg, params, cfg, port_params = bert_tiny_models(seed=seed)
    return (dataclasses.replace(jax_cfg, dropout_rate=rate), params,
            dataclasses.replace(cfg, dropout_rate=rate), port_params)


def test_bert_dropout_loss_and_grads_equal_jax():
    jax_cfg, params, cfg, port_params = _bert()
    batch = _bert_batch()
    jkey = jax.random.PRNGKey(9)
    (want_loss, _), want = jax.value_and_grad(
        functools.partial(jax_bert.loss_fn, cfg=jax_cfg, rng=jkey),
        has_aux=True)(params, batch)
    tparams = bridge.map_leaves(port_params, lambda t: t.requires_grad_(True))
    loss, _ = bert.loss_fn(tparams, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, cfg,
                           rng=_key(jkey), device="cpu")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    got = jax.tree_util.tree_leaves(bridge.bert_to_numpy(bridge.map_leaves(
        tparams, lambda t: torch.zeros_like(t) if t.grad is None
        else t.grad)))
    want = jax.tree_util.tree_leaves(want)
    scale = max(np.abs(np.asarray(w)).max() for w in want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=1e-5 * scale)


def _jax_state(params, tx, train_rng=7):
    return jax_train.create_sharded_state(
        None, lambda _: params, tx, mesh=None,
        train_rng=jax.random.PRNGKey(train_rng))


def _port_state(port_params, tx, train_rng=7):
    return train.create_sharded_state(
        None, lambda _: bridge.map_leaves(port_params, torch.clone), tx,
        train_rng=np.asarray(jax.random.PRNGKey(train_rng)), device="cpu")


def _tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _assert_params_close(got, want, rel=1e-5):
    got = jax.tree_util.tree_leaves(bridge.bert_to_numpy(got))
    want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rel * max(1.0, np.abs(b).max()))


def test_stochastic_train_step_threads_rng():
    jax_cfg, params, cfg, port_params = _bert()
    jtx, tx = optax.adam(1e-3), optimizers.adam(1e-3, mu_dtype=None)
    jstep = jax_train.make_train_step(
        functools.partial(jax_bert.loss_fn, cfg=jax_cfg), jtx,
        stochastic=True)
    step = train.make_train_step(
        functools.partial(bert.loss_fn, cfg=cfg, device="cpu"), tx,
        stochastic=True)
    batch = _bert_batch(batch=4)
    jstate, state = _jax_state(params, jtx), _port_state(port_params, tx)
    losses = []
    for _ in range(2):
        before = state.rng.clone()
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, _tbatch(batch))
        assert not torch.equal(state.rng, before)
        np.testing.assert_array_equal(state.rng.numpy(),
                                      np.asarray(jstate.rng))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        losses.append(float(m["loss"]))
    # Same batch, fresh dropout masks: different losses.
    assert losses[0] != losses[1]
    _assert_params_close(state.params, jstate.params)


def test_stochastic_without_rng_raises():
    _, _, cfg, port_params = _bert()
    tx = optimizers.sgd(0.1)
    state = train.create_sharded_state(None, lambda _: port_params, tx,
                                       device="cpu")
    step = train.make_train_step(
        functools.partial(bert.loss_fn, cfg=cfg, device="cpu"), tx,
        stochastic=True)
    with pytest.raises(ValueError, match="train_rng"):
        step(state, _tbatch(_bert_batch()))


def test_stochastic_accumulation_uses_distinct_keys():
    jax_cfg, params, cfg, port_params = _bert(rate=0.3)
    jtx, tx = optax.sgd(0.1), optimizers.sgd(0.1)
    half = {"tokens": np.asarray([[1, 2, 3, 4]] * 2, np.int32),
            "label": np.asarray([0, 1], np.int32)}
    doubled = {k: np.concatenate([v, v]) for k, v in half.items()}
    _, jm = jax_train.make_train_step(
        functools.partial(jax_bert.loss_fn, cfg=jax_cfg), jtx,
        stochastic=True, accum_steps=2)(_jax_state(params, jtx), doubled)
    state, m = train.make_train_step(
        functools.partial(bert.loss_fn, cfg=cfg, device="cpu"), tx,
        stochastic=True, accum_steps=2)(_port_state(port_params, tx),
                                        _tbatch(doubled))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    # Both micro-batches under one key would give one half-batch's loss.
    single, _ = bert.loss_fn(
        port_params, _tbatch(half), cfg, device="cpu",
        rng=random_lib.split(random_lib.split(_key(
            jax.random.PRNGKey(7)))[1], 2)[0])
    assert float(m["loss"]) != float(single)


def test_stochastic_tail_preserves_rng_chain():
    """The skipped padded slot consumes no split: 3 padded-window steps
    end with the key of 3 sequential ones, and with JAX's."""
    jax_cfg, params, cfg, port_params = _bert(rate=0.2)
    jtx, tx = optax.adam(1e-3), optimizers.adam(1e-3, mu_dtype=None)
    batches = [{"tokens": np.full((2, 4), 1 + i, np.int32),
                "label": np.asarray([0, 1], np.int32)} for i in range(3)]
    loss = functools.partial(bert.loss_fn, cfg=cfg, device="cpu")
    seq = _port_state(port_params, tx)
    single = train.make_train_step(loss, tx, stochastic=True)
    for b in batches:
        seq, _ = single(seq, _tbatch(b))
    stacked, valid = sharding.pad_batch(
        pipeline_io.stack_batches(batches), 4)
    fused, _ = train.make_multi_step(loss, tx, steps_per_dispatch=4,
                                     stochastic=True)(
        _port_state(port_params, tx), _tbatch(stacked), valid)
    assert torch.equal(seq.rng, fused.rng)
    jfused, _ = jax_train.make_multi_step(
        functools.partial(jax_bert.loss_fn, cfg=jax_cfg), jtx,
        steps_per_dispatch=4, stochastic=True)(
            _jax_state(params, jtx), stacked, jnp.asarray(valid))
    np.testing.assert_array_equal(fused.rng.numpy(), np.asarray(jfused.rng))
    _assert_params_close(fused.params, jfused.params)


def test_guard_still_advances_the_chain():
    jax_cfg, params, cfg, port_params = _bert()
    jtx, tx = optax.sgd(0.1), optimizers.sgd(0.1)
    batch = _bert_batch()

    def poisoned(loss_fn):
        def fn(p, b, **kw):
            loss, m = loss_fn(p, b, **kw)
            return loss * np.nan, m
        return fn

    jstate, jm = jax_train.make_train_step(
        poisoned(functools.partial(jax_bert.loss_fn, cfg=jax_cfg)), jtx,
        stochastic=True, skip_nonfinite=True)(_jax_state(params, jtx), batch)
    state, m = train.make_train_step(
        poisoned(functools.partial(bert.loss_fn, cfg=cfg, device="cpu")), tx,
        stochastic=True, skip_nonfinite=True)(_port_state(port_params, tx),
                                              _tbatch(batch))
    assert float(m["nonfinite"]) == float(jm["nonfinite"]) == 1.0
    start = _key(jax.random.PRNGKey(7))
    assert not torch.equal(state.rng, start)
    np.testing.assert_array_equal(state.rng.numpy(), np.asarray(jstate.rng))
    for a, b in zip(bridge.leaves(state.params),
                    bridge.leaves(port_params)):
        assert torch.equal(a.detach(), b)


def _bert_dataset(module, n=16, seq=8):
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, n)
    tokens = np.where(labels[:, None] == 1, rng.integers(256, 512, (n, seq)),
                      rng.integers(1, 256, (n, seq))).astype(np.int32)
    return module.ArrayDataset({"tokens": tokens,
                                "label": labels.astype(np.int32)},
                               batch_size=4, shuffle=True, seed=3)


@pytest.mark.parametrize("k", [1, 2])
def test_stochastic_fit_equals_jax(k):
    jax_cfg, params, cfg, port_params = _bert()
    jtr = jax_trainer.Trainer(
        functools.partial(jax_bert.loss_fn, cfg=jax_cfg), optax.adam(1e-3),
        init_fn=lambda _: params, stochastic=True)
    jtr.init_state(jax.random.PRNGKey(4))
    tr = trainer.Trainer(
        functools.partial(bert.loss_fn, cfg=cfg, device="cpu"),
        optimizers.adam(1e-3, mu_dtype=None),
        init_fn=lambda _: bridge.map_leaves(port_params, torch.clone),
        stochastic=True, device="cpu")
    tr.init_state(torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(tr.state.rng.numpy(),
                                  np.asarray(jtr.state.rng))
    want = jtr.fit(_bert_dataset(jax_data), epochs=2, steps_per_dispatch=k,
                   validation_data=_bert_dataset(jax_data))
    got = tr.fit(_bert_dataset(data), epochs=2, steps_per_dispatch=k,
                 validation_data=_bert_dataset(data))
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(got.history[key], want.history[key],
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_array_equal(tr.state.rng.numpy(),
                                  np.asarray(jtr.state.rng))


def test_eval_is_deterministic():
    _, _, cfg, port_params = _bert()
    tr = trainer.Trainer(
        functools.partial(bert.loss_fn, cfg=cfg, device="cpu"),
        optimizers.sgd(0.1), init_fn=lambda _: port_params,
        stochastic=True, device="cpu")
    tr.init_state(torch.Generator().manual_seed(0))
    key = tr.state.rng.clone()
    runs = [tr.evaluate(_bert_dataset(data), prefetch=0) for _ in range(2)]
    assert runs[0] == runs[1]
    assert torch.equal(tr.state.rng, key)  # eval draws no key


def _decay_mask(params):
    """No decay on biases, LayerNorm parameters or embeddings (works on
    the JAX tree and the port's)."""
    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path) for v in tree]
        return not ({"bias", "scale", "table"} & set(path))
    return walk(params, ())


def test_adamw_mask_equals_the_jax_preset():
    """Three updates of BERT TINY's tree on the same gradients (drawn
    from a numpy seed), the JAX preset and the port's with one mask
    callable: params and both moments within 1e-6."""
    _, params, cfg, port_params = _bert()
    jtx = jax_opt.adamw(1e-2, weight_decay=0.1, mask=_decay_mask)
    tx = optimizers.adamw(1e-2, weight_decay=0.1, mask=_decay_mask)
    rng = np.random.default_rng(0)
    jparams = jax.tree_util.tree_map(np.asarray, params)
    jstate = jtx.init(jparams)
    tparams = bridge.map_leaves(port_params, torch.clone)
    tstate = tx.init(tparams)
    assert not all(tx._decay_flags) and any(tx._decay_flags)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.normal(size=p.shape).astype(np.float32), jparams)
        updates, jstate = jtx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tx.update_(bridge.leaves(tparams), bridge.leaves(
            bridge.bert_to_torch(grads, cfg, device="cpu")), tstate)
    adam = jstate[0]
    for got, want in ((tparams, jparams), (tstate["mu"], adam.mu),
                      (tstate["nu"], adam.nu)):
        got = jax.tree_util.tree_leaves(bridge.bert_to_numpy(got))
        want = jax.tree_util.tree_leaves(want)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=0,
                                       atol=1e-6)


def test_rng_leaf_survives_save_and_restore(tmp_path):
    _, _, cfg, port_params = _bert()
    tx = optimizers.sgd(0.1)
    state = _port_state(port_params, tx)
    state, _ = train.make_train_step(
        functools.partial(bert.loss_fn, cfg=cfg, device="cpu"), tx,
        stochastic=True)(state, _tbatch(_bert_batch()))
    manager = checkpoint.CheckpointManager(str(tmp_path), device="cpu")
    manager.save(1, state, force=True)
    manager.wait()
    fresh = _port_state(port_params, tx, train_rng=99)
    restored = manager.restore(1, template=fresh)
    assert restored.rng.dtype == torch.int64
    assert torch.equal(restored.rng, state.rng)
    manager.close()


def test_cpu_drill_is_stochastic():
    """The drill's workload draws its input noise from the rng chain: its
    Trainer is stochastic, and two keys give two losses on one batch."""
    tr, dataset, _ = check_durability._build("mnist", "cpu")
    assert tr.stochastic and tr.state.rng is not None
    batch = {k: torch.from_numpy(v) for k, v in next(iter(dataset())).items()}
    losses = {float(tr.loss_fn(tr.state.params, batch,
                               rng=random_lib.PRNGKey(s))[0].detach())
              for s in (1, 2)}
    assert len(losses) == 2
