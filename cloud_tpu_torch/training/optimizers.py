"""Optimizers of the port (counterparts of the optax transforms the JAX package uses).

An optimizer here has ``init(params) -> opt_state`` and
``update_(params, grads, opt_state)``, which updates the parameters and
the state in place (the port's stand-in for the JAX step's buffer
donation).  Each runs as a few multi-tensor launches over all leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from cloud_tpu_torch.bridge import leaves, map_leaves


@dataclasses.dataclass(frozen=True)
class SGD:
    """``optax.sgd(learning_rate, momentum)``: with momentum,
    ``trace = g + momentum * trace`` (from zeros), then
    ``p <- p - learning_rate * trace``."""

    learning_rate: float
    momentum: Optional[float] = None

    def init(self, params) -> Dict[str, Any]:
        if not self.momentum:
            return {}
        return {"trace": map_leaves(
            params, lambda p: torch.zeros_like(p, requires_grad=False))}

    @torch.no_grad()
    def update_(self, params, grads, opt_state) -> None:
        p, g = leaves(params), leaves(grads)
        step = g
        if self.momentum:
            step = leaves(opt_state["trace"])
            torch._foreach_mul_(step, self.momentum)
            torch._foreach_add_(step, g)
        torch._foreach_add_(p, step, alpha=-self.learning_rate)


def sgd(learning_rate: float, momentum: Optional[float] = None) -> SGD:
    return SGD(learning_rate, momentum)
