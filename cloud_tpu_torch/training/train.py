"""Train state and step (port of ``cloud_tpu/training/train.py``, one card).

``make_train_step(loss_fn, optimizer)`` returns ``step(state, batch) ->
(state, metrics)`` with the JAX package's metrics (the loss function's,
plus ``grad_norm``, optax's global norm).  The JAX step is jitted and
donates its input state; here the step runs eagerly and the optimizer
updates the parameters and its state in place under ``torch.no_grad()``,
so, as with donation, the state passed in must not be used again.

Only the single-card, deterministic, one-micro-batch step is ported:
meshes, stochastic steps (dropout rngs), gradient accumulation,
non-finite quarantine and fused multi-step windows raise
``NotImplementedError`` (ROADMAP.md A.6).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.bridge import leaves, map_leaves

_LATER = "comes with the training slice of the port (ROADMAP.md A.6)"


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor
    params: Any
    opt_state: Any
    #: PRNG state of stochastic steps; always None in the port so far.
    rng: Any = None


def _refuse(**options) -> None:
    for name, used in options.items():
        if used:
            raise NotImplementedError(f"{name} {_LATER}")


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all tensors together."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def create_sharded_state(rng, init_fn: Callable[[Any], Any], optimizer,
                         mesh=None, logical_axes=None, rules=None,
                         train_rng=None, *, device=None) -> TrainState:
    """``init_fn(rng) -> params`` on ``device`` (``cuda`` by default),
    made trainable, with the optimizer's state and a step count of 0."""
    _refuse(mesh=mesh is not None, logical_axes=logical_axes is not None,
            rules=rules is not None, train_rng=train_rng is not None)
    device = resolve_device(device)
    params = map_leaves(init_fn(rng),
                        lambda t: t.detach().to(device).requires_grad_(True))
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=device),
                      params=params, opt_state=optimizer.init(params))


def make_train_step(
    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]],
    optimizer,
    *,
    logical_axes=None,
    rules=None,
    mesh=None,
    stochastic: bool = False,
    accum_steps: int = 1,
    skip_nonfinite: bool = False,
):
    """Build ``step(state, batch) -> (state, metrics)``;
    ``loss_fn(params, batch) -> (loss, metrics)``.  Metrics stay on the
    device (no host sync inside the step)."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    _refuse(mesh=mesh is not None, logical_axes=logical_axes is not None,
            rules=rules is not None, stochastic=stochastic,
            **{"accum_steps > 1": accum_steps > 1},
            skip_nonfinite=skip_nonfinite)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params = leaves(state.params)
        with torch.enable_grad():
            loss, metrics = loss_fn(state.params, batch)
            # A leaf the loss does not read gets a zero gradient, as in JAX.
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        optimizer.update_(params, grads, state.opt_state)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=state.opt_state, rng=state.rng), metrics

    return step


def make_multi_step(*args, **kwargs):
    """Fused multi-step windows are not ported yet."""
    raise NotImplementedError(f"make_multi_step {_LATER}")
