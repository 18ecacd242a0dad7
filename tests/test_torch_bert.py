"""The port's BERT against the JAX package's, on the CPU.

BERT TINY in f32 from the JAX package's own weights: logits, loss and
every gradient of ``bert.loss_fn`` against ``jax.value_and_grad`` of the
JAX ``bert.loss_fn``, with an attention mask (padded tails, no sample
fully masked) and segment ids, and without either; logits at 1e-4,
loss at 1e-5 relative, gradients at 1e-5 of the largest magnitude.  The
weight bridge round-trips, the CPU path launches no kernel, and the
options the port does not have raise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import bert as jax_bert
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import bert
from cloud_tpu_torch.ops import dispatch
from tests.helpers.torch_port import bert_tiny_models

torch.set_num_threads(2)

BATCH, SEQ = 3, 24


def _batch(extras):
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 512, (BATCH, SEQ)).astype(np.int32),
             "label": rng.integers(0, 2, BATCH).astype(np.int32)}
    if extras:
        mask = np.ones((BATCH, SEQ), np.int32)
        mask[1, 15:] = 0
        mask[2, 5:] = 0
        batch["attention_mask"] = mask
        batch["segment_ids"] = (np.arange(SEQ)[None, :] >= 10).astype(
            np.int32).repeat(BATCH, 0)
    return batch


@pytest.mark.parametrize("extras", [False, True])
def test_logits_loss_and_grads_match_jax(extras):
    jax_cfg, params, cfg, port_params = bert_tiny_models(seed=2)
    batch = _batch(extras)
    (want_loss, want_m), want = jax.jit(jax.value_and_grad(
        functools.partial(jax_bert.loss_fn, cfg=jax_cfg), has_aux=True))(
            params, batch)
    want_logits = jax_bert.apply(
        params, batch["tokens"], jax_cfg,
        attention_mask=batch.get("attention_mask"),
        segment_ids=batch.get("segment_ids"))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = bert.apply(port_params, tbatch["tokens"], cfg,
                        attention_mask=tbatch.get("attention_mask"),
                        segment_ids=tbatch.get("segment_ids"), device="cpu")
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=1e-4)
    leaves = bridge.map_leaves(port_params,
                               lambda t: t.requires_grad_(True))
    loss, metrics = bert.loss_fn(leaves, tbatch, cfg, device="cpu")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    assert float(metrics["accuracy"]) == float(want_m["accuracy"])
    # Without segment ids the segment table is unused: zero grad in JAX.
    got = bridge.bert_to_numpy(bridge.map_leaves(
        leaves, lambda t: torch.zeros_like(t) if t.grad is None else t.grad))
    want_leaves = jax.tree_util.tree_leaves(want)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    scale = max(np.abs(np.asarray(w)).max() for w in want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                   atol=1e-5 * scale)


def test_bridge_round_trip_and_init_tree():
    _, params, cfg, port_params = bert_tiny_models(seed=2)
    back = bridge.bert_to_numpy(port_params)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    fresh = bridge.init_bert(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    shapes = jax.tree_util.tree_map(np.shape, bridge.bert_to_numpy(fresh))
    assert shapes == jax.tree_util.tree_map(np.shape, back)
    assert "bias" not in fresh["layers"][0]["att"]["q"]
    assert "bias" in fresh["layers"][0]["wi"]


def test_cpu_path_launches_no_kernel():
    _, _, cfg, port_params = bert_tiny_models(seed=2)
    dispatch.reset_launch_counts()
    batch = {k: torch.from_numpy(v) for k, v in _batch(True).items()}
    loss, _ = bert.loss_fn(bridge.map_leaves(
        port_params, lambda t: t.requires_grad_(True)), batch, cfg,
        device="cpu")
    loss.backward()
    assert all(n == 0 for n in dispatch.launch_counts().values())


def test_dropout_is_not_ported():
    _, _, cfg, port_params = bert_tiny_models(seed=2)
    batch = {k: torch.from_numpy(v) for k, v in _batch(False).items()}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        bert.loss_fn(port_params, batch,
                     dataclasses.replace(cfg, dropout_rate=0.1),
                     rng=torch.Generator(), device="cpu")
