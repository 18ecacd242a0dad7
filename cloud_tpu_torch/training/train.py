"""Train state, step and multi-step window (port of ``cloud_tpu/training/train.py``).

``make_train_step(loss_fn, optimizer)`` returns ``step(state, batch) ->
(state, metrics)`` with the JAX package's metrics (the loss function's,
plus ``grad_norm``, optax's global norm).  The JAX step is jitted and
donates its input state; here the step runs eagerly and the optimizer
updates the parameters and its state in place under ``torch.no_grad()``,
so, as with donation, the state passed in must not be used again.

``make_multi_step(..., steps_per_dispatch=K)`` fuses K steps into one
dispatch, as the JAX package's ``lax.scan`` window does: on the card the
K step bodies are captured once as one CUDA graph and every call replays
it (see :func:`make_multi_step`).  ``make_eval_step`` is the forward
only.  ``training.compile_cache`` captures a step, a window or an eval
step ahead of its first call through the same capture path
(:class:`_Graphed`).

All take gradient accumulation (``accum_steps``), the on-device
non-finite guard (``skip_nonfinite``) and stochastic steps
(``stochastic``): the state's ``rng`` is a threefry key
(``cloud_tpu_torch.random``) that every step splits as JAX does,
``next_rng, step_rng = split(state.rng)``, handing ``rng=step_rng`` to
the loss.

Under a mesh (``mesh``, ``logical_axes``, ``rules``), one process per
rank (``parallel/``): :func:`create_sharded_state` cuts the parameters
(and so the optimizer's moments) by the rules, and the step writes out
what GSPMD inserts in the JAX package, in an order fixed by the program
(:class:`_MeshLayout`): leaves split over ``fsdp`` are all-gathered
before the forward pass; after ``backward()`` each gradient is
reduce-scattered over ``fsdp`` (or summed over it, for a replicated
leaf) and summed over ``dp`` and ``sp`` in f32 (``grad_sync``), nothing
over ``tp``, ``pp`` or ``ep``; ``grad_norm`` sums each leaf's squares
over the axes that split it.  Under ``pp`` each rank holds its pipeline
stage's layers (``parallel/pipeline.py``), under ``ep`` its experts.
The loss must return its rank's share of the global loss (the
``loss_fn`` of CloudLM, BERT, ViT, MNIST and ResNet does, marked
``mesh_loss``), so the summed gradients are the global loss's.
:func:`make_hybrid_dp_train_step` is the JAX package's replicated
data-parallel step with the two-level gradient sum.  ``Trainer.fit``
under a mesh runs these steps eagerly; the window, compile-ahead and the
windowed pipelines under a mesh of more than one rank are queued
(ROADMAP.md A.2): their CUDA graphs cannot capture gloo's host-side
collectives.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cloud_tpu_torch import random as random_lib
from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.bridge import leaves, map_leaves
from cloud_tpu_torch.monitoring import profiler
from cloud_tpu_torch.ops import dispatch
from cloud_tpu_torch.parallel import collectives, sharding
from cloud_tpu_torch.parallel import mesh as mesh_lib

#: Why the window, fit, compile-ahead and the pipelines refuse a mesh.
_MESH_LATER = ("is queued under ROADMAP.md A.2: a step under a mesh runs "
               "its collectives from the host (gloo, or NCCL between "
               "cards), and the one-step and window CUDA graphs of this "
               "path cannot capture gloo's host-side collectives")


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor
    params: Any
    opt_state: Any
    #: Threefry key (int64 ``[2]``, ``cloud_tpu_torch.random``) of
    #: stochastic steps, a leaf like any other; None for deterministic
    #: training.  Each step consumes a fresh split.
    rng: Any = None


def refuse_unported(*, mesh=None, logical_axes=None, rules=None,
                    feature: str = "this entry point") -> None:
    """Raise ``NotImplementedError`` for a mesh option of an entry point
    that does not run under a mesh yet, naming its queued item."""
    for name, value in (("mesh", mesh), ("logical_axes", logical_axes),
                        ("rules", rules)):
        if value is not None:
            raise NotImplementedError(
                f"{feature} with {name}= (under a mesh) {_MESH_LATER}")


def mesh_loss(fn):
    """Mark ``fn`` as a loss that, under a mesh, returns its rank's share
    of the global loss (its numerator over the weight total of every
    rank): the only kind a step under a mesh takes."""
    fn.mesh_loss = True
    return fn


def _is_mesh_loss(fn) -> bool:
    while True:
        if getattr(fn, "mesh_loss", False):
            return True
        if not isinstance(fn, functools.partial):
            return False
        fn = fn.func


def param_shardings(mesh, logical_axes, rules=None):
    """Each leaf's ``PartitionSpec`` under ``rules``, a tree congruent
    with ``logical_axes`` (a leaf's axes a tuple): the JAX package's
    ``NamedSharding`` tree without the placement, which the port makes by
    cutting (``parallel.sharding.shard_tree``).  A layer's leaf under a
    ``sharding.LayerStack`` gets its stacked leaf's spec, the ``layers``
    assignment (``pp`` under pipeline rules) first.
    ``sharding.split_dims`` names the mesh axes a leaf is cut over on
    ``mesh``."""
    mesh_lib.check_mesh(mesh)
    rules = rules or sharding.DEFAULT_RULES

    def walk(axes, stacked=False):
        if isinstance(axes, dict):
            return {k: walk(v, stacked) for k, v in axes.items()}
        if isinstance(axes, list):
            stacked = stacked or isinstance(axes, sharding.LayerStack)
            return [walk(v, stacked) for v in axes]
        if stacked:  # the stacked leaf's spec, its layer dim first
            return sharding.PartitionSpec(rules.rules.get("layers"),
                                          *rules.spec(*axes))
        return rules.spec(*axes)

    return walk(logical_axes)


def shard_batch(batch, mesh, rules=None, batch_axis: str = "batch", *,
                stacked: bool = False, pad_to: Optional[int] = None):
    """A batch as the step under ``mesh`` takes it.  As in the JAX
    package's multi-process contract, ``batch`` is THIS process's rows:
    those of its data coordinate (``dp`` x ``fsdp``); ranks that differ
    only in ``tp``, ``sp``, ``pp`` or ``ep`` are given equal rows (each
    takes its ``sp`` block of the sequence itself).  Under a pipeline
    (``pp`` > 1, ``layers`` -> ``pp``) a rank's rows are
    ``parallel.pipeline.microbatch_rows(mesh, global_batch, M)``: its
    share of every global microbatch, as the JAX package groups them (a
    dense loss is indifferent to the grouping; an MoE model's auxiliary
    loss is not).  Leaves become tensors on the rank's device.
    ``pad_to=N`` zero-pads the batch dim (dim 1 of a
    ``stacked`` super-batch) to N first and returns ``(batch, valid)``,
    ``valid`` a float32 ``[N]`` mask of real rows.  Without a mesh the
    batch comes back as it is."""
    del rules, batch_axis  # the rows are already this rank's
    if pad_to is not None:
        batch, valid = sharding.pad_batch(batch, pad_to,
                                          axis=1 if stacked else 0)
        return shard_batch(batch, mesh, stacked=stacked), valid
    if mesh is None:
        return batch
    mesh_lib.check_mesh(mesh)
    return map_leaves(batch, lambda x: torch.as_tensor(
        np.asarray(x) if not isinstance(x, torch.Tensor) else x,
        device=mesh.device))


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm of all tensors together."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def create_sharded_state(rng, init_fn: Callable[[Any], Any], optimizer,
                         mesh=None, logical_axes=None, rules=None,
                         train_rng=None, *, device=None) -> TrainState:
    """``init_fn(rng) -> params`` on ``device`` (``cuda`` by default; the
    mesh's device for this rank under a mesh), made trainable, with the
    optimizer's state, a step count of 0 and ``train_rng`` (a key's
    uint32 words, or None) as the state's key.

    Under ``mesh`` with ``logical_axes``, the parameters are this rank's
    shards as ``rules`` cut them (``parallel.sharding.shard_tree``), so
    the optimizer's moments are born as shards too: a pipeline stage's
    block of layers (``layers`` -> ``pp``), a rank's experts (``expert``
    -> ``ep``), fsdp and tp slices.  The full tree is
    initialized first (from ``rng``, the same on every rank) and then
    cut: a 124M-parameter CloudLM fits one card whole; models that do
    not would need a sharded init, which the port has not.  A mesh with
    ``tp`` > 1 needs ``logical_axes`` (the layers take shards)."""
    mesh_lib.check_mesh(mesh)
    if mesh is not None:
        if logical_axes is None and mesh.axis_size(mesh_lib.AXIS_TP) > 1:
            raise ValueError("a mesh with tp > 1 needs logical_axes= (each "
                             "rank holds its shard of the heads)")
        device = mesh.device if device is None else device
    device = resolve_device(device)
    params = map_leaves(init_fn(rng), lambda t: t.detach().to(device))
    if mesh is not None and logical_axes is not None:
        params = sharding.shard_tree(params, logical_axes, mesh,
                                     rules or sharding.DEFAULT_RULES)
    params = map_leaves(params, lambda t: t.requires_grad_(True))
    key = None if train_rng is None else random_lib.as_key(train_rng,
                                                            device=device)
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=device),
                      params=params, opt_state=optimizer.init(params),
                      rng=key)


def _grads(loss_fn, params, batch, rng=None):
    """The loss function's metrics (detached) and the gradients of its
    loss with respect to every leaf of ``params``; ``rng`` goes to the
    loss when given."""
    kwargs = {} if rng is None else {"rng": rng}
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch, **kwargs)
        # A leaf the loss does not read gets a zero gradient, as in JAX.
        grads = torch.autograd.grad(loss, leaves(params), allow_unused=True,
                                    materialize_grads=True)
    return {k: v.detach() for k, v in metrics.items()}, list(grads)


def _accumulated_grads(loss_fn, params, batch, accum_steps: int, rng=None):
    """Mean metrics and gradients over ``accum_steps`` equal micro-batches
    (batch dim 0 must divide), summed in f32 and the mean gradient cast to
    each parameter's dtype, as the JAX step's ``lax.scan`` does.  A step
    key is split ``accum_steps`` ways, one key a micro-batch."""

    def to_micro(x):
        if x.shape[0] % accum_steps:
            raise ValueError(
                f"batch dim {x.shape[0]} not divisible by "
                f"accum_steps={accum_steps}"
            )
        return x.reshape((accum_steps, x.shape[0] // accum_steps)
                         + tuple(x.shape[1:]))

    micro = map_leaves(batch, to_micro)
    keys = None if rng is None else random_lib.split(rng, accum_steps)
    sum_g = [torch.zeros_like(p, dtype=torch.float32)
             for p in leaves(params)]
    sum_m: Dict[str, torch.Tensor] = {}
    for i in range(accum_steps):
        metrics, grads = _grads(loss_fn, params, _slot(micro, i),
                                None if keys is None else keys[i])
        torch._foreach_add_(sum_g, [g.float() for g in grads])
        for key, value in metrics.items():
            value = value.float()
            sum_m[key] = value if key not in sum_m else sum_m[key] + value
    inv = 1.0 / accum_steps
    grads = [(g * inv).to(p.dtype) for g, p in zip(sum_g, leaves(params))]
    return {k: v * inv for k, v in sum_m.items()}, grads


def _guarded_update(optimizer, params, grads, opt_state,
                    finite: torch.Tensor) -> None:
    """The optimizer's update where ``finite`` (a 0-d bool on the device)
    is true; elsewhere every parameter and optimizer slot keeps its value
    bit for bit.  A true select against a copy of the old values, the
    counterpart of the JAX step's ``lax.cond``: an arithmetic blend would
    spread NaN through ``0 * inf``, and a host branch would wait on the
    device and could not be captured.  Costs one copy of the parameters
    and the optimizer state while the step runs."""
    state = list(params) + leaves(opt_state)
    with torch.no_grad():
        old = [t.clone() for t in state]
        optimizer.update_(params, grads, opt_state)
        for new, prev in zip(state, old):
            new.copy_(torch.where(finite, new, prev))


def _axes_leaves(params, axes, mesh, rules) -> List[tuple]:
    """``(logical axes, stack axes)`` of each leaf of ``params`` in
    :func:`leaves`' order (``axes`` congruent with the full params, a
    leaf's axes a tuple).  A layer list whose axes are a
    ``sharding.LayerStack`` cut over ``pp`` on ``mesh`` holds this rank's
    block of layers: its leaves' stack axes are the axes it is cut over
    (``()`` elsewhere)."""
    if isinstance(params, dict):
        return [a for k in sorted(params)
                for a in _axes_leaves(params[k], axes[k], mesh, rules)]
    if isinstance(params, (list, tuple)):
        stack: tuple = ()
        if isinstance(axes, sharding.LayerStack):
            stack, start, stop = sharding.layer_stack_cut(mesh, rules,
                                                          len(axes))
            if stack and stack != (mesh_lib.AXIS_PP,):
                raise ValueError(
                    f"the layer list is cut over {stack}: the port's step "
                    "cuts it over pp alone")
            axes = axes[start:stop]
        if len(params) != len(axes):
            raise ValueError(f"{len(params)} params for {len(axes)} "
                             "logical axes trees")
        return [(leaf_axes, stack or leaf_stack) for p, ax in
                zip(params, axes) for leaf_axes, leaf_stack in
                _axes_leaves(p, ax, mesh, rules)]
    return [(tuple(axes), ())]


def _with_leaves(tree, flat):
    """``tree`` with its leaves replaced, in :func:`leaves`' order, by
    the items of the iterator ``flat``."""
    if isinstance(tree, dict):
        new = {k: _with_leaves(tree[k], flat) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_with_leaves(v, flat) for v in tree]
    return next(flat)


class _MeshLayout:
    """How each parameter leaf lies on the mesh, and the collectives of a
    step under it, every one issued in leaf order (the same on every
    rank; never from inside autograd):

    - :meth:`gather`: a leaf split over ``fsdp`` all-gathered whole
      (uneven extents as ``shard_bounds`` cut them);
    - :meth:`sync`: each full gradient reduce-scattered over ``fsdp``
      back to the leaf's shard (an all-reduce and this rank's slice where
      the dim does not divide), or summed over ``fsdp`` for a leaf it
      does not split, then summed over ``dp`` and ``sp``, all in f32;
      nothing over ``tp``, whose ranks hold their own shards;
    - :meth:`global_norm`: each leaf's squared norm summed over the axes
      that split it (one all-reduce of a small vector per axis).

    A leaf dim may be cut over ``fsdp``, ``tp`` or ``ep`` (an expert
    leaf's dim 0) alone; a pipeline stage's layers are a block of the
    layer list (``pp``), not a dim cut.  ``pp`` and ``ep`` are not summed
    over: their ranks hold the same rows and different params, and the
    layers' own collectives give each replicated leaf its whole gradient
    (``parallel/pipeline.py``, ``models/moe.py``); both count in
    ``grad_norm`` for the leaves they split, so the norm and the
    non-finite flag are the same on every rank.  The optimizer's update
    of a stage's layers and a rank's experts is elementwise, as for fsdp
    shards."""

    def __init__(self, mesh, rules, logical_axes, params):
        self.mesh = mesh
        fsdp, tp, ep = mesh_lib.AXIS_FSDP, mesh_lib.AXIS_TP, mesh_lib.AXIS_EP
        flat = leaves(params)
        rules = rules or sharding.DEFAULT_RULES
        axes = (_axes_leaves(params, logical_axes, mesh, rules)
                if logical_axes is not None else [((), ())] * len(flat))
        self.fsdp_dims: List[Optional[int]] = []
        self.split: List[frozenset] = []
        for leaf, (leaf_axes, stack) in zip(flat, axes):
            dims = sharding.split_dims(mesh, leaf_axes, rules)
            for dim, cut in dims.items():
                if len(cut) > 1 or cut[0] not in (fsdp, tp, ep):
                    raise ValueError(
                        f"a param dim with logical axes {leaf_axes} is cut "
                        f"over {cut}: the port's step cuts a param dim "
                        "over fsdp, tp or ep alone")
            self.fsdp_dims.append(next((d for d, cut in dims.items()
                                        if cut == (fsdp,)), None))
            self.split.append(frozenset(c[0] for c in dims.values())
                              | frozenset(stack))
        data = [a for a in (mesh_lib.AXIS_DP, fsdp, mesh_lib.AXIS_SP)
                if mesh.axis_size(a) > 1]
        self.sync_axes = [tuple(a for a in data if not (a == fsdp and d is
                                                        not None))
                          for d in self.fsdp_dims]
        # Every member's extent of each fsdp-cut dim, exchanged once.
        cut = [(i, leaf.shape[d]) for i, (leaf, d) in
               enumerate(zip(flat, self.fsdp_dims)) if d is not None]
        self.sizes: Dict[int, List[int]] = {}
        if cut:
            extents = torch.tensor([e for _, e in cut], dtype=torch.int64,
                                   device=flat[0].device)
            table = collectives.all_gather(extents, fsdp, tiled=False,
                                           mesh=mesh).tolist()
            for j, (i, _) in enumerate(cut):
                self.sizes[i] = [row[j] for row in table]
        self.fsdp = fsdp
        self.norm_axes = [a for a in (mesh_lib.AXIS_PP, fsdp, ep, tp)
                          if mesh.axis_size(a) > 1]

    def gather(self, params):
        """``params`` with every fsdp-cut leaf whole (a new trainable
        tensor; the other leaves as they are)."""
        def leaf(i, p):
            d = self.fsdp_dims[i]
            if d is None:
                return p
            return collectives.all_gather(
                p.detach(), self.fsdp, gather_dim=d, sizes=self.sizes[i],
                mesh=self.mesh).requires_grad_(True)

        return _with_leaves(params, iter(
            [leaf(i, p) for i, p in enumerate(leaves(params))]))

    def sync(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Full gradients -> this rank's shards, summed over the data."""
        mesh, out = self.mesh, []
        for i, g in enumerate(grads):
            dtype, g = g.dtype, g.float()
            d = self.fsdp_dims[i]
            if d is not None:
                sizes = self.sizes[i]
                if len(set(sizes)) == 1:
                    g = collectives.reduce_scatter_sum(
                        g, self.fsdp, scatter_dim=d, mesh=mesh)
                else:
                    index = mesh.axis_index(self.fsdp)
                    g = collectives.all_reduce_sum(
                        g, self.fsdp, mesh=mesh).narrow(
                            d, sum(sizes[:index]), sizes[index])
            if self.sync_axes[i]:
                g = collectives.grad_sync(g, self.sync_axes[i], mean=False,
                                          mesh=mesh)
            out.append(g.to(dtype))
        return out

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The L2 norm of the whole logical gradient, on every rank."""
        sq = torch.stack([g.float().square().sum() for g in grads])
        for axis in self.norm_axes:
            cut = torch.tensor([axis in s for s in self.split],
                               device=sq.device)
            total = collectives.all_reduce_sum(torch.where(cut, sq, 0.0), axis,
                                           mesh=self.mesh)
            sq = torch.where(cut, total, sq)
        return torch.sqrt(sq.sum())


def _step_body(loss_fn, optimizer, *, logical_axes, rules, mesh, stochastic,
               accum_steps, skip_nonfinite):
    """The step's work, shared by the step and the window: the rng split
    (stochastic steps), gradients (accumulated over micro-batches when
    ``accum_steps`` > 1), the metrics, and the optimizer's in-place update
    of the parameters and its state, behind the non-finite guard when
    ``skip_nonfinite``.  Returns ``body(state, batch) -> metrics``; the
    step count is the caller's.

    A stochastic body advances ``state.rng`` in place to ``next_rng``
    before the update, so the chain moves on also when the guard skips
    the update, as the JAX step's does.

    ``skip_nonfinite=True`` skips the update on the device when the grad
    norm or the ``loss`` metric is not finite: the parameters and every
    optimizer slot keep their values (the step count still advances, the
    batch was consumed) and ``metrics["nonfinite"]`` is ``1.0 - finite``.
    No host sync is added.

    Under ``mesh`` the gradients come from parameters gathered over
    ``fsdp`` and are synced to shards after the backward
    (:class:`_MeshLayout`, built at the first call); ``accum_steps``
    micro-batches accumulate locally and sync once."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    mesh_lib.check_mesh(mesh)
    if mesh is not None and not _is_mesh_loss(loss_fn):
        raise ValueError(
            "under a mesh the step takes a loss marked train.mesh_loss (one "
            "that returns its rank's share of the global loss, as the "
            "loss_fn of CloudLM, BERT, ViT, MNIST and ResNet does)")
    layouts: List[_MeshLayout] = []

    def layout_of(params) -> Optional[_MeshLayout]:
        if mesh is None:
            return None
        if not layouts:
            layouts.append(_MeshLayout(mesh, rules, logical_axes, params))
        return layouts[0]

    def split_rng(state: TrainState):
        if not stochastic:
            return None
        if state.rng is None:
            raise ValueError(
                "stochastic=True needs a state built with train_rng")
        keys = random_lib.split(state.rng)
        with torch.no_grad():
            state.rng.copy_(keys[0])
        return keys[1]

    def body(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        step_rng = split_rng(state)
        layout = layout_of(state.params)
        params = state.params if layout is None else layout.gather(
            state.params)
        if accum_steps > 1:
            metrics, grads = _accumulated_grads(loss_fn, params, batch,
                                                accum_steps, step_rng)
        else:
            metrics, grads = _grads(loss_fn, params, batch, step_rng)
        if layout is None:
            metrics["grad_norm"] = global_norm(grads)
        else:
            grads = layout.sync(grads)
            metrics["grad_norm"] = layout.global_norm(grads)
        params = leaves(state.params)
        if not skip_nonfinite:
            optimizer.update_(params, grads, state.opt_state)
            return metrics
        finite = torch.isfinite(metrics["grad_norm"])
        loss = metrics.get("loss")
        if loss is not None:
            finite = finite & torch.all(torch.isfinite(loss))
        _guarded_update(optimizer, params, grads, state.opt_state, finite)
        metrics["nonfinite"] = 1.0 - finite.float()
        return metrics

    return body


def _state_leaves(state: TrainState):
    rng = [] if state.rng is None else [state.rng]
    return [state.step, *leaves(state.params), *leaves(state.opt_state),
            *rng]


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


def _one_step(body, state: TrainState, batch, _key=None) -> Dict:
    """One step body with the step count advanced in place (the captured
    form of :func:`make_train_step`)."""
    metrics = body(state, batch)
    with torch.no_grad():
        state.step.add_(1)
    return metrics


def _eval_metrics(loss_fn, state: TrainState, batch, _key=None) -> Dict:
    with torch.no_grad():
        _, metrics = loss_fn(state.params, batch)
    return {k: v.detach() for k, v in metrics.items()}


def _same_specs(what: str, static, given) -> None:
    if len(static) != len(given) or any(
            a.shape != b.shape or a.dtype != b.dtype
            for a, b in zip(static, given)):
        raise ValueError(f"{what} differ from the ones its CUDA graphs were "
                         "captured on")


class _Graphed:
    """The port's one CUDA-graph capture path: the window
    (:func:`make_multi_step`), and the step and eval step that
    ``training.compile_cache`` captures ahead.

    ``fn(state, batch, key) -> outputs`` runs the work on ``state`` in
    place.  The first state :meth:`prepare` or :meth:`run` sees becomes
    the graphs' static state (its tensors are the graphs' buffers); a
    later state that is not it is copied into it, leaf by leaf, and every
    batch is copied into a static batch.  Each ``key`` gets one graph,
    captured at its first use (or ahead, by :meth:`capture`): a window's
    key is its set of valid slots.  Before the first capture, one
    warm-up runs eagerly on the capture stream (``warm_key(key)``; on a
    copy of the state when ``fn`` mutates it), so nothing is built,
    loaded or set up inside a capture.  ``captures``, ``replays`` and
    ``warmup_steps`` count the work; kernel launch counts
    (``ops.dispatch``) gain the captured launches on every replay and
    nothing at capture."""

    def __init__(self, fn, *, what: str, mutates: bool = True,
                 warm_key=lambda key: key):
        self._fn = fn
        self._what = what
        self._mutates = mutates
        self._warm_key = warm_key
        #: key -> (graph, outputs, launches a replay).
        self._graphs: Dict[Any, tuple] = {}
        self.state: Optional[TrainState] = None
        self._batch = None
        self._stream = None
        self.captures = 0
        self.replays = 0
        self.warmup_steps = 0

    def prepare(self, state: TrainState, batch) -> None:
        """Take ``state`` as the static state and allocate the static
        batch (zeros) with ``batch``'s shapes and dtypes (tensors or
        ``compile_cache.TensorSpec`` leaves), unless already prepared."""
        if self.state is not None:
            return
        device = state.step.device
        self.state = state
        self._stream = torch.cuda.Stream(device)
        self._batch = map_leaves(batch, lambda x: torch.zeros(
            tuple(x.shape), dtype=x.dtype, device=device))

    def bind(self, state: TrainState, batch) -> None:
        """Make ``state``'s values and ``batch`` the graphs' inputs."""
        self.prepare(state, batch)
        static, given = _state_leaves(self.state), _state_leaves(state)
        if state is not self.state:
            _same_specs(f"{self._what}: the state's shapes", static, given)
            with torch.no_grad():
                for a, b in zip(static, given):
                    if a is not b:
                        a.copy_(b)
        dst, src = leaves(self._batch), leaves(batch)
        _same_specs(f"{self._what}: the batch's shapes", dst, src)
        for a, b in zip(dst, src):
            if a is not b:
                a.copy_(b, non_blocking=True)

    def warm_up(self, key) -> None:
        """One eager run of the work on the capture stream (libraries
        built and loaded, cuBLAS and cuDNN set up), once."""
        if self.warmup_steps:
            return
        device = self.state.step.device
        self._stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self._stream):
            warm = self.state
            if self._mutates:
                warm = TrainState(
                    step=self.state.step.clone(),
                    params=map_leaves(self.state.params, lambda p: p.detach(
                    ).clone().requires_grad_(p.requires_grad)),
                    opt_state=map_leaves(self.state.opt_state, torch.clone),
                    rng=None if self.state.rng is None
                    else self.state.rng.clone())
            self._fn(warm, self._batch, self._warm_key(key))
            del warm
        self.warmup_steps += 1
        torch.cuda.current_stream(device).wait_stream(self._stream)

    def capture(self, key) -> tuple:
        """Capture the work for ``key`` on the static state as one graph.

        The capture is ``thread_local``: other threads of the process keep
        working on the card while it runs (the Trainer's prefetch thread
        allocates pinned memory and copies on its own stream, a checkpoint
        writer waits on its snapshot's event, the compile-ahead worker
        captures while the main thread replays), and under the default
        global mode any such call from any thread invalidates the capture.
        Autograd's backward thread launches onto the capture stream and is
        captured as before."""
        self.warm_up(key)
        device = self.state.step.device
        torch.cuda.current_stream(device).wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        try:
            with dispatch.capturing_launches(
                    self._stream.cuda_stream) as launches:
                with torch.cuda.graph(graph, stream=self._stream,
                                      capture_error_mode="thread_local"):
                    outputs = self._fn(self.state, self._batch, key)
        except Exception as exc:
            raise RuntimeError(
                f"{self._what}: capturing {key!r} as a CUDA graph failed: "
                f"{exc}") from exc
        self.captures += 1
        entry = self._graphs[key] = (graph, outputs, launches)
        return entry

    def run(self, state: TrainState, batch, key):
        """Bind, capture ``key`` at its first use, replay; the graph's
        outputs (overwritten by its next replay)."""
        self.bind(state, batch)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self.capture(key)
        graph, outputs, launches = entry
        graph.replay()
        dispatch.replay_launches(launches)
        self.replays += 1
        return outputs


class _GraphedStep:
    """A step or eval step replayed from its :class:`_Graphed` (what
    ``compile_cache.aot_compile`` returns on the card).  Metrics come
    back as copies, so a caller may hold them past the next replay."""

    def __init__(self, graphed: _Graphed, *, train: bool):
        self.graphed = graphed
        self._train = train

    @property
    def static_state(self):
        return self.graphed.state

    def __call__(self, state: TrainState, batch):
        profiler.safe_point()
        out = self.graphed.run(state, batch, None)
        metrics = {k: v.clone() for k, v in out.items()}
        if self._train:
            return self.graphed.state, metrics
        return metrics


class _TrainStep:
    """The step ``make_train_step`` returns (see there)."""

    def __init__(self, body, mesh=None):
        self._body = body
        self.mesh = mesh

    def __call__(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        profiler.safe_point()
        metrics = self._body(state, batch)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=state.opt_state, rng=state.rng), metrics

    def graph_artifact(self):
        """``(artifact, graphed, key)`` for a capture ahead of use."""
        refuse_unported(mesh=self.mesh, feature="compile-ahead of a step")
        graphed = _Graphed(functools.partial(_one_step, self._body),
                           what="make_train_step")
        return _GraphedStep(graphed, train=True), graphed, None


class _EvalStep:
    """The eval step ``make_eval_step`` returns (see there)."""

    def __init__(self, loss_fn, mesh=None, logical_axes=None, rules=None):
        self._loss_fn = loss_fn
        self.mesh = mesh
        self._layout = (mesh, rules, logical_axes)
        self._layouts: List[_MeshLayout] = []

    def __call__(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        profiler.safe_point()
        if self.mesh is None:
            return _eval_metrics(self._loss_fn, state, batch)
        if not self._layouts:
            self._layouts.append(_MeshLayout(*self._layout, state.params))
        with torch.no_grad():
            _, metrics = self._loss_fn(
                self._layouts[0].gather(state.params), batch)
        return {k: v.detach() for k, v in metrics.items()}

    def graph_artifact(self):
        refuse_unported(mesh=self.mesh, feature="compile-ahead of an "
                        "eval step")
        graphed = _Graphed(functools.partial(_eval_metrics, self._loss_fn),
                           what="make_eval_step", mutates=False)
        return _GraphedStep(graphed, train=False), graphed, None


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
    device (no host sync inside the step).

    ``stochastic=True`` threads the state's key through the loss:
    ``loss_fn(params, batch, rng=...)`` gets a fresh split every step
    (dropout), and the state must have been created with a ``train_rng``
    (``create_sharded_state(..., train_rng=key)``).

    Under ``mesh`` (a ``parallel.mesh.Mesh``; this process is one rank),
    ``state`` is :func:`create_sharded_state`'s with the same ``mesh``,
    ``logical_axes`` and ``rules``, ``batch`` this rank's rows
    (:func:`shard_batch`), and ``loss_fn`` a ``mesh_loss`` (CloudLM's
    ``loss_fn`` with ``mesh=``, ``rules=``); see :class:`_MeshLayout` for
    the collectives.  Every rank's metrics are the global values."""
    return _TrainStep(_step_body(
        loss_fn, optimizer, logical_axes=logical_axes, rules=rules,
        mesh=mesh, stochastic=stochastic, accum_steps=accum_steps,
        skip_nonfinite=skip_nonfinite), mesh)


class _MultiStep:
    """The window ``make_multi_step`` returns (see there).  ``captures``,
    ``replays`` and ``warmup_steps`` count its graph work on the card."""

    def __init__(self, body, loss_fn, steps_per_dispatch: int,
                 guarded: bool):
        self._body = body
        self._loss_fn = loss_fn
        self._guarded = guarded
        self.steps_per_dispatch = steps_per_dispatch
        self._graphed = _Graphed(functools.partial(_window, body),
                                 what="make_multi_step",
                                 warm_key=lambda run: run[:1])
        self._metric_shapes: Optional[Dict[str, torch.Size]] = None

    captures = property(lambda self: self._graphed.captures)
    replays = property(lambda self: self._graphed.replays)
    warmup_steps = property(lambda self: self._graphed.warmup_steps)

    @property
    def static_state(self):
        return self._graphed.state

    def graph_artifact(self):
        """``(artifact, graphed, key)`` for a capture ahead of use: a
        window of its own (fresh graphs) and its full set of slots."""
        window = _MultiStep(self._body, self._loss_fn,
                            self.steps_per_dispatch, self._guarded)
        return window, window._graphed, tuple(range(self.steps_per_dispatch))

    def __call__(self, state: TrainState, super_batch, valid=None):
        profiler.safe_point()
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
            sums = self._graphed.run(state, super_batch, run)
            state = self._graphed.state
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
            if self._guarded:
                self._metric_shapes["nonfinite"] = torch.Size(())
        return {key: torch.zeros(shape, dtype=torch.float32,
                                 device=state.step.device)
                for key, shape in self._metric_shapes.items()}


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
    parameter trajectory (and a stochastic step's rng chain) is K
    sequential steps'; ``metrics`` are the window's f32 means (per-step
    values are not returned), as in JAX.  ``valid``, JAX's float ``[K]``
    mask for a zero-padded tail, skips the slots where it is 0: no step
    body runs there, the state (parameters, optimizer state, step count,
    key) passes through, and the metrics are sums over the valid slots
    divided by ``max(sum(valid), 1)``.

    The state's tensors are updated in place (the counterpart of JAX's
    donation): the state passed in must not be used again.

    On the card (a CUDA state) the window's step bodies are captured once
    as one ``torch.cuda.CUDAGraph`` and each call replays it: one launch
    from the host for K steps (:class:`_Graphed`).  The first state
    passed becomes the graph's static buffers and is what every call
    returns; a call with another state copies its values in, and every
    call copies ``super_batch`` into the static batch.  A failed capture
    raises ``RuntimeError``: there is no eager fallback on the card.
    Since a graph cannot branch on the device, ``valid`` is read on the
    host once a call, and each set of valid slots gets its own graph,
    captured at its first use (a full window and a dataset's tail: two
    graphs).  On a CPU state the same step bodies run eagerly.
    """
    if steps_per_dispatch < 1:
        raise ValueError(
            f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}"
        )
    refuse_unported(mesh=mesh, logical_axes=logical_axes, rules=rules,
                    feature="make_multi_step (the window)")
    body = _step_body(loss_fn, optimizer, logical_axes=logical_axes,
                      rules=rules, mesh=mesh, stochastic=stochastic,
                      accum_steps=accum_steps, skip_nonfinite=skip_nonfinite)
    return _MultiStep(body, loss_fn, steps_per_dispatch, skip_nonfinite)


def make_eval_step(loss_fn: Callable[..., Tuple[torch.Tensor, Dict]], *,
                   mesh=None, logical_axes=None, rules=None):
    """``eval_step(state, batch) -> metrics``: the loss function's metrics
    on ``state.params``, forward only (no gradients, no rng: eval is
    deterministic).  Under ``mesh`` (the port's addition: the JAX step
    reads the layout off its arrays), the parameters cut over ``fsdp``
    are gathered whole first, as the train step does."""
    mesh_lib.check_mesh(mesh)
    return _EvalStep(loss_fn, mesh, logical_axes, rules)


def make_hybrid_dp_train_step(loss_fn, optimizer, *, mesh,
                              dcn_axis: str = "dp", ici_axis: str = "fsdp"):
    """Data-parallel step with the explicit two-level gradient sum of a
    mesh split over slow links (the JAX package's, ``shard_map`` there):
    parameters are REPLICATED; each rank computes its local loss (a mean
    over its own rows, ``batch`` being them) and gradients, sums the
    gradients with ``hierarchical_all_reduce_sum`` (reduce-scatter over
    ``ici_axis``, all-reduce over ``dcn_axis``, all-gather) and divides
    by the data-parallel size, then applies the same update on every
    rank.  Metrics (the loss's and ``"loss"``) are averaged over the
    ranks the same way; there is no ``grad_norm``, as in JAX."""
    mesh_lib.check_mesh(mesh)
    n_data = mesh.axis_size(dcn_axis) * mesh.axis_size(ici_axis)

    def body(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        params = leaves(state.params)
        with torch.enable_grad():
            loss, metrics = loss_fn(state.params, batch)
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
        grads = [collectives.hierarchical_all_reduce_sum(
            g, ici_axis=ici_axis, dcn_axis=dcn_axis, mesh=mesh) / n_data
            for g in grads]
        optimizer.update_(params, grads, state.opt_state)
        return {key: collectives.all_reduce_sum(
            value.detach(), (ici_axis, dcn_axis), mesh=mesh) / n_data
            for key, value in {"loss": loss, **metrics}.items()}

    return _TrainStep(body, mesh)
