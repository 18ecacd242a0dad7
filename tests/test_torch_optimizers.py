"""The port's Adam and AdamW against optax and the JAX package's presets, on the CPU.

Three updates on identical numpy gradients, f32 parameters, from the
same start: ``optimizers.adamw(lr, mu_dtype=None)`` against
``optax.adamw(lr)``, and the presets with bf16 mu
(``optimizers.adamw``/``adam`` against
``cloud_tpu.training.optimizers.adamw``/``adam``), parameters and both
moments at atol 1e-6; ``adamw(mask=...)`` (a tree of bools, and a
callable of the parameters) against ``optax.adamw(mask=...)``.
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


#: Weight decay on ``a`` and ``b/d`` only.
MASK = {"a": True, "b": {"c": False, "d": True}}


def _decay_matrices(params):
    """Decay the 2-d leaves (works on JAX and torch trees alike)."""
    if isinstance(params, dict):
        return {k: _decay_matrices(v) for k, v in params.items()}
    return len(params.shape) > 1


CASES = {
    "optax.adamw": (lambda: optax.adamw(3e-2),
                    lambda: optimizers.adamw(3e-2, mu_dtype=None)),
    "adamw bf16 mu": (lambda: jax_opt.adamw(3e-2, weight_decay=0.1),
                      lambda: optimizers.adamw(3e-2, weight_decay=0.1)),
    "adam bf16 mu": (lambda: jax_opt.adam(3e-2, eps=1e-6),
                     lambda: optimizers.adam(3e-2, eps=1e-6)),
    "adamw mask tree": (
        lambda: optax.adamw(3e-2, weight_decay=0.1, mask=MASK),
        lambda: optimizers.adamw(3e-2, weight_decay=0.1, mu_dtype=None,
                                 mask=MASK)),
    "adamw mask callable": (
        lambda: jax_opt.adamw(3e-2, weight_decay=0.1, mask=_decay_matrices),
        lambda: optimizers.adamw(3e-2, weight_decay=0.1,
                                 mask=_decay_matrices)),
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
    if not hasattr(adam_state, "mu"):  # a mask adds a level to the chain
        adam_state = adam_state[0]
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
    """``adamw(mask=...)`` is ported (held to optax in
    ``test_three_updates_match``); a mask whose leaves do not match the
    parameters' raises, and so does an update before ``init``."""
    params = {"a": torch.zeros(2), "b": torch.zeros(3)}
    with pytest.raises(ValueError, match="mask has 1 leaves"):
        optimizers.adamw(1e-3, mask={"a": True}).init(params)
    with pytest.raises(ValueError, match="init"):
        optimizers.adamw(1e-3, mask={"a": True, "b": False}).update_(
            params, params, {"count": torch.zeros((), dtype=torch.int32),
                             "mu": params, "nu": params})
