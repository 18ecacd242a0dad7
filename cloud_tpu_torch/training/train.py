"""Train state, step and multi-step window (port of ``cloud_tpu/training/train.py``, one card).

``make_train_step(loss_fn, optimizer)`` returns ``step(state, batch) ->
(state, metrics)`` with the JAX package's metrics (the loss function's,
plus ``grad_norm``, optax's global norm).  The JAX step is jitted and
donates its input state; here the step runs eagerly and the optimizer
updates the parameters and its state in place under ``torch.no_grad()``,
so, as with donation, the state passed in must not be used again.

``make_multi_step(..., steps_per_dispatch=K)`` fuses K steps into one
dispatch, as the JAX package's ``lax.scan`` window does: on the card the
K step bodies are captured once as one CUDA graph and every call replays
it (see :func:`make_multi_step`).

Only the single-card, deterministic, one-micro-batch step is ported:
meshes, stochastic steps (dropout rngs), gradient accumulation and
non-finite quarantine raise ``NotImplementedError`` (ROADMAP.md A.6).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.bridge import leaves, map_leaves
from cloud_tpu_torch.ops import dispatch

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


def _step_body(loss_fn, optimizer, *, logical_axes, rules, mesh, stochastic,
               accum_steps, skip_nonfinite):
    """The step's work, shared by the step and the window: gradients, the
    metrics, and the optimizer's in-place update of the parameters and its
    state.  Returns ``body(state, batch) -> metrics``; the step count is
    the caller's."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    _refuse(mesh=mesh is not None, logical_axes=logical_axes is not None,
            rules=rules is not None, stochastic=stochastic,
            **{"accum_steps > 1": accum_steps > 1},
            skip_nonfinite=skip_nonfinite)

    def body(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        params = leaves(state.params)
        with torch.enable_grad():
            loss, metrics = loss_fn(state.params, batch)
            # A leaf the loss does not read gets a zero gradient, as in JAX.
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        optimizer.update_(params, grads, state.opt_state)
        return metrics

    return body


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
    body = _step_body(loss_fn, optimizer, logical_axes=logical_axes,
                      rules=rules, mesh=mesh, stochastic=stochastic,
                      accum_steps=accum_steps, skip_nonfinite=skip_nonfinite)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        metrics = body(state, batch)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=state.opt_state, rng=state.rng), metrics

    return step


def _state_leaves(state: TrainState):
    return [state.step, *leaves(state.params), *leaves(state.opt_state)]


def _slot(super_batch, i: int):
    """Batch ``i`` of a super-batch (views)."""
    return map_leaves(super_batch, lambda x: x[i])


def _window(body, state: TrainState, super_batch, run) -> Dict:
    """The step bodies of the window slots in ``run``, in order, the step
    count advanced in place after each; returns each metric's f32 sum over
    the slots that ran."""
    sums: Dict[str, torch.Tensor] = {}
    per_step = []
    for i in run:
        per_step.append(body(state, _slot(super_batch, i)))
        with torch.no_grad():
            state.step.add_(1)
    for key in per_step[0]:
        sums[key] = torch.stack([m[key].float() for m in per_step]).sum(0)
    return sums


class _MultiStep:
    """The window ``make_multi_step`` returns (see there).  ``captures``,
    ``replays`` and ``warmup_steps`` count its graph work on the card."""

    def __init__(self, body, loss_fn, steps_per_dispatch: int):
        self._body = body
        self._loss_fn = loss_fn
        self.steps_per_dispatch = steps_per_dispatch
        #: Slots run (a tuple of indices) -> (graph, metric sums, launches).
        self._graphs: Dict[tuple, tuple] = {}
        #: The state whose tensors are the graphs' static buffers, and the
        #: static super-batch the graphs read.
        self._state: Optional[TrainState] = None
        self._batch = None
        self._stream = None
        self._metric_shapes: Optional[Dict[str, torch.Size]] = None
        self.captures = 0
        self.replays = 0
        self.warmup_steps = 0

    def __call__(self, state: TrainState, super_batch, valid=None):
        k = self.steps_per_dispatch
        batch_leaves = leaves(super_batch)
        if batch_leaves and batch_leaves[0].shape[0] != k:
            raise ValueError(
                f"super_batch leading axis {batch_leaves[0].shape[0]} != "
                f"steps_per_dispatch={k}"
            )
        if valid is None:
            run, n_valid = tuple(range(k)), float(k)
        else:
            # The window's one host read of the mask (a [K] vector).
            v = np.asarray(valid.detach().cpu() if torch.is_tensor(valid)
                           else valid, np.float32).reshape(-1)
            if v.shape != (k,):
                raise ValueError(f"valid must be [{k}], got {v.shape}")
            run = tuple(int(i) for i in np.flatnonzero(v > 0))
            n_valid = float(max(np.float32(v.sum()), np.float32(1.0)))
        if not run:  # every slot padded: nothing runs, the state passes
            return state, self._zero_metrics(state, super_batch)
        if state.step.device.type == "cuda":
            state, sums = self._replay(state, super_batch, run)
        elif state.step.device.type == "cpu":
            sums = _window(self._body, state, super_batch, run)
        else:
            raise ValueError(f"make_multi_step: unsupported device "
                             f"{state.step.device}")
        self._metric_shapes = {key: s.shape for key, s in sums.items()}
        return state, {key: s / n_valid for key, s in sums.items()}

    def _zero_metrics(self, state, super_batch):
        if self._metric_shapes is None:
            with torch.no_grad():
                _, metrics = self._loss_fn(state.params,
                                           _slot(super_batch, 0))
            self._metric_shapes = {key: v.shape for key, v in metrics.items()}
            self._metric_shapes["grad_norm"] = torch.Size(())
        return {key: torch.zeros(shape, dtype=torch.float32,
                                 device=state.step.device)
                for key, shape in self._metric_shapes.items()}

    # -- the card ----------------------------------------------------------

    def _bind(self, state: TrainState, super_batch) -> None:
        """Make ``state``'s values and ``super_batch`` the graphs' inputs:
        the first state becomes the static buffers; a later one that is
        not it is copied into them, and so is every super-batch."""
        if self._state is None:
            self._state = state
            self._stream = torch.cuda.Stream(state.step.device)
            self._batch = map_leaves(super_batch, lambda x: torch.empty_like(
                x, device=state.step.device))
        static, given = _state_leaves(self._state), _state_leaves(state)
        if any(a is not b for a, b in zip(static, given)) or (
                len(static) != len(given)):
            if len(static) != len(given) or any(
                    a.shape != b.shape or a.dtype != b.dtype
                    for a, b in zip(static, given)):
                raise ValueError(
                    "make_multi_step: the state's structure differs from "
                    "the one its CUDA graphs were captured on")
            with torch.no_grad():
                for a, b in zip(static, given):
                    a.copy_(b)
        dst, src = leaves(self._batch), leaves(super_batch)
        if len(dst) != len(src) or any(
                a.shape != b.shape or a.dtype != b.dtype
                for a, b in zip(dst, src)):
            raise ValueError(
                "make_multi_step: the super-batch's shapes differ from the "
                "ones its CUDA graphs were captured on")
        for a, b in zip(dst, src):
            if a is not b:
                a.copy_(b, non_blocking=True)

    def _capture(self, run) -> tuple:
        """Warm up once on a copy of the state (libraries built and loaded,
        cuBLAS and cuDNN set up on the capture stream), then capture the
        window's step bodies on the static state as one graph."""
        device = self._state.step.device
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(device))
        if not self.warmup_steps:
            with torch.cuda.stream(stream):
                warm = TrainState(
                    step=self._state.step.clone(),
                    params=map_leaves(self._state.params, lambda p: p.detach(
                    ).clone().requires_grad_(p.requires_grad)),
                    opt_state=map_leaves(self._state.opt_state, torch.clone))
                _window(self._body, warm, self._batch, run[:1])
                del warm
            self.warmup_steps += 1
        torch.cuda.current_stream(device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        try:
            with dispatch.capturing_launches(stream.cuda_stream) as launches:
                with torch.cuda.graph(graph, stream=stream):
                    sums = _window(self._body, self._state, self._batch, run)
        except Exception as exc:
            raise RuntimeError(
                f"make_multi_step: capturing the {len(run)}-step window as "
                f"a CUDA graph failed: {exc}") from exc
        self.captures += 1
        return graph, sums, launches

    def _replay(self, state: TrainState, super_batch, run):
        self._bind(state, super_batch)
        entry = self._graphs.get(run)
        if entry is None:
            entry = self._graphs[run] = self._capture(run)
        graph, sums, launches = entry
        graph.replay()
        dispatch.replay_launches(launches)
        self.replays += 1
        out = self._state
        return TrainState(step=out.step, params=out.params,
                          opt_state=out.opt_state, rng=state.rng), sums


def make_multi_step(
    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]],
    optimizer,
    *,
    steps_per_dispatch: int,
    logical_axes=None,
    rules=None,
    mesh=None,
    stochastic: bool = False,
    accum_steps: int = 1,
    skip_nonfinite: bool = False,
):
    """Fuse ``steps_per_dispatch`` (K) train steps into one dispatch.

    ``multi_step(state, super_batch, valid=None) -> (state, metrics)``:
    ``super_batch`` stacks K batches on a new leading axis; the K steps
    run the step body of :func:`make_train_step` in order, so the
    parameter trajectory is K sequential steps'; ``metrics`` are the
    window's f32 means (per-step values are not returned), as in JAX.
    ``valid``, JAX's float ``[K]`` mask for a zero-padded tail, skips the
    slots where it is 0: no step body runs there, the state (parameters,
    optimizer state, step count) passes through, and the metrics are sums
    over the valid slots divided by ``max(sum(valid), 1)``.

    The state's tensors are updated in place (the counterpart of JAX's
    donation): the state passed in must not be used again.

    On the card (a CUDA state) the window's step bodies are captured once
    as one ``torch.cuda.CUDAGraph`` and each call replays it: one launch
    from the host for K steps.  The first state passed becomes the
    graph's static buffers; a call with another state copies its values
    in, and every call copies ``super_batch`` into the static batch.
    Before the first capture one step runs on a copy of the state, on the
    capture stream, so nothing is built, loaded or set up inside the
    capture.  A failed capture raises ``RuntimeError``: there is no eager
    fallback on the card.  Since a graph cannot branch on the device,
    ``valid`` is read on the host once a call, and each set of valid
    slots gets its own graph, captured at its first use (a full window
    and a dataset's tail: two graphs).  Kernel launch counts
    (``ops.dispatch``) gain the captured launches on every replay and
    nothing for the capture.  On a CPU state the same step bodies run
    eagerly.
    """
    if steps_per_dispatch < 1:
        raise ValueError(
            f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}"
        )
    body = _step_body(loss_fn, optimizer, logical_axes=logical_axes,
                      rules=rules, mesh=mesh, stochastic=stochastic,
                      accum_steps=accum_steps, skip_nonfinite=skip_nonfinite)
    return _MultiStep(body, loss_fn, steps_per_dispatch)
