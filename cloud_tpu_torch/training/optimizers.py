"""Optimizers of the port (counterparts of the optax transforms the JAX package uses).

An optimizer here has ``init(params) -> opt_state`` and
``update_(params, grads, opt_state)``, which updates the parameters and
the state in place (the port's stand-in for the JAX step's buffer
donation).  Each runs as a few multi-tensor launches over all leaves.

:func:`adamw` and :func:`adam` have the signatures of the JAX package's
presets (``cloud_tpu/training/optimizers.py``): the first moment is
stored in ``mu_dtype`` (bf16 by default; ``None`` keeps the parameter's
type, which is ``optax.adamw``'s own default) and the second in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
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


@dataclasses.dataclass(frozen=True)
class Adam:
    """optax's ``scale_by_adam``, then ``add_decayed_weights`` (every
    leaf, no mask), then ``-learning_rate``:
    ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``, both
    bias-corrected with the incremented count, ``u = mu_hat /
    (sqrt(nu_hat) + eps) + weight_decay p``, ``p -= learning_rate u``.
    mu is updated in f32 and stored in ``mu_dtype``; as in optax, its
    decay ``b1 * mu`` is taken in the stored type (``b1`` rounded to it
    first, JAX's weak typing).  The count is a host integer: the step
    never waits on the device for it."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    mu_dtype: Optional[torch.dtype] = torch.bfloat16

    def init(self, params) -> Dict[str, Any]:
        def zeros(p, dtype=None):
            return torch.zeros_like(p, dtype=dtype, requires_grad=False)

        return {"count": 0,
                "mu": map_leaves(params, lambda p: zeros(p, self.mu_dtype)),
                "nu": map_leaves(params, zeros)}

    @torch.no_grad()
    def update_(self, params, grads, opt_state) -> None:
        p, g = leaves(params), [t.float() for t in leaves(grads)]
        mu, nu = leaves(opt_state["mu"]), leaves(opt_state["nu"])
        opt_state["count"] += 1
        count = np.float32(opt_state["count"])
        # f32 bias corrections, as optax computes 1 - decay**count.
        bc1 = float(np.float32(1) - np.float32(self.b1) ** count)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** count)
        # mu = b1 mu + (1 - b1) g; f32 moments update in place, with one
        # scratch list reused below (and the update itself): two
        # parameter-sized temporaries in all.
        b1 = float(torch.tensor(self.b1, dtype=mu[0].dtype)) if mu else 0.0
        low = bool(mu) and mu[0].dtype != torch.float32
        if low:
            new_mu = [t.float() for t in torch._foreach_mul(mu, b1)]
        else:
            torch._foreach_mul_(mu, b1)
            new_mu = mu
        tmp = torch._foreach_mul(g, 1 - self.b1)
        torch._foreach_add_(new_mu, tmp)
        # nu = b2 nu + (1 - b2) g^2
        torch._foreach_copy_(tmp, g)
        torch._foreach_mul_(tmp, g)
        torch._foreach_mul_(tmp, 1 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, tmp)
        # u = (mu / bc1) / (sqrt(nu / bc2) + eps) + weight_decay p
        torch._foreach_copy_(tmp, nu)
        torch._foreach_div_(tmp, bc2)
        torch._foreach_sqrt_(tmp)
        torch._foreach_add_(tmp, self.eps)
        update = torch._foreach_div(new_mu, bc1)
        torch._foreach_div_(update, tmp)
        if self.weight_decay:
            torch._foreach_copy_(tmp, p)
            torch._foreach_mul_(tmp, self.weight_decay)
            torch._foreach_add_(update, tmp)
        torch._foreach_mul_(update, -self.learning_rate)
        torch._foreach_add_(p, update)
        if low:
            torch._foreach_copy_(mu, new_mu)


def adamw(learning_rate: float, *, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4,
          mu_dtype: Optional[torch.dtype] = torch.bfloat16,
          mask=None) -> Adam:
    """AdamW with the first moment stored in ``mu_dtype`` (default bf16;
    ``None`` keeps it in the parameter's type, as ``optax.adamw``)."""
    if mask is not None:
        raise NotImplementedError(
            "adamw(mask=...) is not ported yet (ROADMAP.md A.6)")
    return Adam(learning_rate, b1=b1, b2=b2, eps=eps,
                weight_decay=weight_decay, mu_dtype=mu_dtype)


def adam(learning_rate: float, *, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8,
         mu_dtype: Optional[torch.dtype] = torch.bfloat16) -> Adam:
    """Adam with the first moment stored in ``mu_dtype`` (default bf16)."""
    return Adam(learning_rate, b1=b1, b2=b2, eps=eps, mu_dtype=mu_dtype)
