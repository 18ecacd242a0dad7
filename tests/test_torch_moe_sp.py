"""The MoE CloudLM under ``sp`` (``models/moe.py`` with
``parallel/tensor_parallel.py``), on gloo ranks on the CPU, against the
JAX package's one-device step.

MoE TINY (2 layers, 4 experts, top 2, f32) with ``capacity_factor=0.5``
(capacity 8 of a row's 64 choices over the global T = 32) and a z-loss:
one ``sgd(1.0)`` step on random tokens under ``{sp: 2}`` with the ring,
the zig-zag ring and Ulysses, and under ``{sp: 2, ep: 2}`` (the ring, 4
ranks).  Each rank routes its block of the sequence as JAX routes the
whole: capacity from the global T, slot positions offset by the choices
of the chunks before it in sequence order.  Loss, aux, grad norm and the
gradient are held to JAX's as the other mesh arms are
(``test_torch_train_mesh._hold``).  The capacity drops choices, and the
test asserts that a rank-local cumsum would have dropped others: some
choice's drop differs between the global prefix and the block's own
cumsum, so routing each block alone would change the loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.models import moe as jax_moe
from cloud_tpu.models import transformer as jax_tf
from helpers.torch_port import model_inputs, run_ranks
from test_torch_train_mesh import _RANK_MODEL, _hold, _jax_step, _saved

torch.set_num_threads(1)

#: (arm, mesh sizes, config fields).
ARMS = (("ring", {"sp": 2}, {}),
        ("zigzag", {"sp": 2}, {"zigzag_sp": True}),
        ("ulysses", {"sp": 2}, {"ulysses_sp": True}),
        ("ring ep", {"sp": 2, "ep": 2}, {}))

_SPY = """
from cloud_tpu_torch.models import moe as moe_lib

_real_slots = moe_lib._slot_positions
ROUTING = {}


def _spy(flat_mask, ctx=None):
    pos = _real_slots(flat_mask, ctx)
    if ctx is not None:
        cfg_moe = CURRENT[0]
        c = moe_lib._capacity(
            flat_mask.shape[1] // cfg_moe.top_k * ctx.sp_size, cfg_moe)
        chosen = flat_mask > 0
        local = torch.cumsum(flat_mask, dim=1) - flat_mask
        dropped = chosen & (pos >= c)
        alone = chosen & (local >= c)
        stats = ROUTING.setdefault(CURRENT[1], [0, 0])
        stats[0] += int(dropped.sum())
        stats[1] += int((dropped != alone).sum())
    return pos


moe_lib._slot_positions = _spy
CURRENT = [None, None]
"""

_ARMS = """
cfg, params = model("moe")
batch = {"tokens": IN["tokens"], "loss_mask": IN["loss_mask"]}
for name, sizes, fields in ARMS:
    if int(np.prod(list(sizes.values()))) != WORLD:
        continue
    mesh = MeshSpec(sizes).build(devices=["cpu"] * WORLD)
    arm_cfg = dataclasses.replace(cfg, **fields)
    CURRENT[:] = [arm_cfg.moe, name]
    one_step(name, arm_cfg, params, mesh, batch, optimizers.sgd(1.0))
    OUT[name]["routing"] = ROUTING[name]
"""


@pytest.fixture(scope="module")
def moe_model():
    cfg = jax_tf.TINY.scaled(
        dtype=jnp.float32, num_layers=2,
        moe=jax_moe.MoeConfig(num_experts=4, top_k=2, capacity_factor=0.5,
                              z_loss_weight=1e-3))
    params = jax.tree_util.tree_map(
        np.asarray, jax_tf.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 256, (2, 32)).astype(np.int32),
             "loss_mask": (rng.random((2, 32)) < 0.8).astype(np.float32)}
    return cfg, params, batch


@pytest.mark.parametrize("world", [2, 4])
def test_moe_under_sp_matches_the_one_device_step(moe_model, tmp_path,
                                                  world):
    cfg, params, batch = moe_model
    want_m, want_p, _ = _jax_step(cfg, params, batch, optax.sgd(1.0))
    outs = run_ranks(
        "import dataclasses\n" + f"OUTDIR = {str(tmp_path)!r}\n"
        + f"ARMS = {ARMS!r}\n" + _RANK_MODEL + _SPY + _ARMS, world,
        files={**model_inputs(cfg, params, prefix="moe"), **batch})
    arms = [a for a, sizes, _ in ARMS
            if int(np.prod(list(sizes.values()))) == world]
    assert arms
    for name in arms:
        got = _saved(tmp_path, name)
        dropped = differs = 0
        for out in outs:
            _hold(name, got, want_p, params, want_m, out[name])
            dropped += out[name]["routing"][0]
            differs += out[name]["routing"][1]
        # Capacity binds, and a rank routing its block alone would drop
        # other choices than the whole sequence's routing does.
        assert dropped > 0, name
        assert differs > 0, name
