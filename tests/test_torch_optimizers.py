"""The port's Adam and AdamW against optax and the JAX package's presets, on the CPU.

Three updates on identical numpy gradients, f32 parameters, from the
same start: ``optimizers.adamw(lr, mu_dtype=None)`` against
``optax.adamw(lr)``, and the presets with bf16 mu
(``optimizers.adamw``/``adam`` against
``cloud_tpu.training.optimizers.adamw``/``adam``), parameters and both
moments at atol 1e-6.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.training import optimizers as jax_opt
from cloud_tpu_torch import bridge
from cloud_tpu_torch.training import optimizers

torch.set_num_threads(1)


def _tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32),
                  "d": (1e-3 * rng.standard_normal((2, 2))).astype(
                      np.float32)}}


CASES = {
    "optax.adamw": (lambda: optax.adamw(3e-2),
                    lambda: optimizers.adamw(3e-2, mu_dtype=None)),
    "adamw bf16 mu": (lambda: jax_opt.adamw(3e-2, weight_decay=0.1),
                      lambda: optimizers.adamw(3e-2, weight_decay=0.1)),
    "adam bf16 mu": (lambda: jax_opt.adam(3e-2, eps=1e-6),
                     lambda: optimizers.adam(3e-2, eps=1e-6)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_updates_match(case):
    make_jax, make_port = CASES[case]
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    tx = make_jax()
    jp, jstate = params, tx.init(params)
    port = make_port()
    tp = bridge.map_leaves(params, lambda a: torch.from_numpy(a.copy()))
    tstate = port.init(tp)
    for g in grads:
        updates, jstate = tx.update(g, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        port.update_(tp, bridge.map_leaves(g, torch.from_numpy), tstate)
    assert tstate["count"] == 3
    adam_state = jstate[0]
    for got, want in ((tp, jp), (tstate["mu"], adam_state.mu),
                      (tstate["nu"], adam_state.nu)):
        got = bridge.leaves(got)
        want = jax.tree_util.tree_leaves(want)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            b = np.asarray(b)
            assert a.dtype == (torch.bfloat16 if b.dtype.name == "bfloat16"
                               else torch.float32)
            np.testing.assert_allclose(a.float().numpy(),
                                       b.astype(np.float32), rtol=0,
                                       atol=1e-6)


def test_adamw_mask_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optimizers.adamw(1e-3, mask=lambda p: p)
