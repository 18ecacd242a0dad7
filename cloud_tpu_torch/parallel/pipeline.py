"""GPipe pipeline parallelism over the ``pp`` mesh axis (port of
``cloud_tpu/parallel/pipeline.py``).

The layer stack is cut into ``pp`` contiguous stages: stage ``s`` holds
layers ``[s L/pp, (s+1) L/pp)``, the block the JAX package's
``PartitionSpec(pp)`` on the stacked layer dim gives
(:func:`stage_bounds`; ``sharding.LayerStack`` cuts the params so).  The
batch is cut into M microbatches that flow through the stages.

The JAX package runs the schedule as a shift register inside
``shard_map``: every stage computes at every one of ``M + pp - 1``
ticks, garbage in the bubble ticks routed to a scratch row, and the
backward is autograd's transpose of the ticks.  Here every stage is a
process, and :func:`pipeline` is one ``torch.autograd.Function`` with an
explicit schedule (the ring's idiom, ``parallel/ring_attention.py``):

- **forward**: for microbatch k = 0 .. M-1, stage s receives k's carry
  from stage s-1 (stage 0 reads microbatch k itself), runs its layers
  with autograd recording into a graph of its own, keeps that graph, and
  sends the carry on to stage s+1;
- **backward**: for k = M-1 .. 0, stage s receives k's cotangent from
  stage s+1 (the last stage takes its own), runs ``torch.autograd.grad``
  through k's graph, sums its layers' gradients, and sends the input's
  cotangent to stage s-1.

Each step posts its send (the previous microbatch's) with its receive
and waits on both (``collectives.exchange``).  Exactly M microbatches x
L/pp layers run on every stage: the bubble computes nothing, and the
JAX package's wrap-around hop from the last stage to stage 0 (which
carries nothing used) is not made.

The pipeline's replicated ends follow the JAX package's transposes, so
no replicated value is summed over ``pp``: the output is the last
stage's, broadcast to every stage (JAX's zero-elsewhere ``psum``), whose
backward feeds only the last stage's cotangent into the schedule (every
stage holds the same one); the microbatches' cotangent exists on stage
0 and is broadcast to every stage (the ``psum`` that transposes JAX's
``pvary``).  A model's embedding and head therefore get the same whole
gradient on every stage.

The collectives inside a stage's layers (the TP pair, an MoE layer's
data sums and expert exchange) run inside this schedule, in its order,
the same on every rank of their groups (which lie within one stage).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from cloud_tpu_torch.parallel import collectives
from cloud_tpu_torch.parallel import mesh as mesh_lib


def num_stages(mesh, axis: str = mesh_lib.AXIS_PP) -> int:
    if mesh is None:
        return 1
    return mesh.axis_size(axis)


def stage_bounds(num_layers: int, mesh, axis: str = mesh_lib.AXIS_PP
                 ) -> Tuple[int, int]:
    """``[start, stop)`` of this rank's stage's layers: the contiguous
    block of ``num_layers / pp`` (``ValueError`` unless it divides, as
    in the JAX package)."""
    pp = num_stages(mesh, axis)
    if num_layers % pp:
        raise ValueError(f"Layer count {num_layers} not divisible by "
                         f"pp={pp}")
    per = num_layers // pp
    stage = mesh.axis_index(axis) if pp > 1 else 0
    return stage * per, (stage + 1) * per


def microbatch_rows(mesh, global_batch: int, num_microbatches: int
                    ) -> np.ndarray:
    """The global batch rows this rank holds under a pipeline, in order.

    The JAX package reshapes the GLOBAL batch ``[b, ...]`` to ``[M,
    b/M, ...]`` and splits dim 1 over the data axes (``dp`` x ``fsdp``),
    so global microbatch k is rows ``[k b/M, (k+1) b/M)``; a rank's local
    microbatch k must be its data slice of that block.  This rank's rows
    are those slices for k = 0 .. M-1 (with M = 1, the contiguous data
    slice ``shard_batch`` documents), so ``local.reshape(M, -1, ...)`` is
    its share of every global microbatch."""
    m = num_microbatches
    if global_batch % m:
        raise ValueError(
            f"Global batch {global_batch} not divisible by "
            f"num_microbatches={m}")
    data = (mesh.axis_size(mesh_lib.AXIS_DP)
            * mesh.axis_size(mesh_lib.AXIS_FSDP))
    index = (mesh.axis_index(mesh_lib.AXIS_DP)
             * mesh.axis_size(mesh_lib.AXIS_FSDP)
             + mesh.axis_index(mesh_lib.AXIS_FSDP))
    per_mb = global_batch // m
    if per_mb % data:
        raise ValueError(
            f"a microbatch of {per_mb} rows does not split over the "
            f"{data} data ranks (dp x fsdp)")
    per = per_mb // data
    return np.concatenate([
        np.arange(k * per_mb + index * per, k * per_mb + (index + 1) * per)
        for k in range(m)])


# --- small tree helpers: the carry is a tuple/list/dict of tensors --------

def _leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, flat):
    """``tree`` with its leaves replaced, in :func:`_leaves`' order, by
    the items of the iterator ``flat``."""
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], flat) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, flat) for v in tree)
    return next(flat)


def _run_layers(layer_fn, layers, carry):
    for layer_params in layers:
        carry = layer_fn(layer_params, carry)
    return carry


def _sequential(layer_fn: Callable[[Any, Any], Any], stacked_params,
                microbatches):
    """``pp == 1``: the whole layer list (``stacked_params``, one params
    tree a layer) run on each microbatch in turn, the results stacked
    (the JAX package's ``lax.map`` of the scanned stack)."""
    flat = _leaves(microbatches)
    m = flat[0].shape[0]
    outs = [_leaves(_run_layers(layer_fn, stacked_params,
                                _rebuild(microbatches,
                                         iter([x[k] for x in flat]))))
            for k in range(m)]
    return _rebuild(microbatches, iter(
        [torch.stack([o[i] for o in outs]) for i in range(len(flat))]))


class _Schedule:
    """The pieces of one :func:`pipeline` call its Function needs."""

    def __init__(self, layer_fn, stage_params, microbatches, mesh, axis):
        self.layer_fn = layer_fn
        self.params_tree = stage_params
        self.carry_tree = microbatches
        self.mesh = mesh
        self.axis = axis
        self.pp = mesh.axis_size(axis)
        self.stage = mesh.axis_index(axis)

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.pp - 1

    def step(self, send, recv_like, *, forward: bool):
        """One step's exchange: ``send`` to the next stage (the previous
        one, backward) posted with the receive of ``recv_like`` from the
        previous stage (the next one, backward)."""
        ahead, behind = self.stage + 1, self.stage - 1
        to, frm = (ahead, behind) if forward else (behind, ahead)
        return collectives.exchange(send, self.axis, send_to=to,
                                    recv_like=recv_like, recv_from=frm,
                                    mesh=self.mesh)

    def forward(self, mbs, params, *, keep: bool):
        """The forward schedule.  Returns (this stage's outputs by
        microbatch on the last stage, else None; the kept graphs: per
        microbatch the carry's input leaves and output leaves)."""
        layers = _rebuild(self.params_tree, iter(params))
        m = mbs[0].shape[0]
        graphs, outs, pending = [], [], []
        for k in range(m):
            # The previous microbatch's carry goes on to the next stage
            # while this one's arrives from the previous stage.
            got = self.step(pending if not self.last else [],
                            [x[k] for x in mbs] if not self.first else [],
                            forward=True)
            carry_in = [x[k] for x in mbs] if self.first else got
            with torch.set_grad_enabled(keep):
                leaves_in = [c.detach().requires_grad_(
                    keep and c.is_floating_point()) for c in carry_in]
                out = _leaves(_run_layers(
                    self.layer_fn, layers,
                    _rebuild(self.carry_tree, iter(leaves_in))))
            if keep:
                graphs.append((leaves_in, out))
            pending = [o.detach() for o in out]
            if self.last:
                outs.append(pending)
        if not self.last:
            self.step(pending, [], forward=True)
        return outs if self.last else None, graphs

    def replicate(self, outs, mbs):
        """The last stage's outputs, stacked by microbatch, broadcast to
        every stage."""
        stacked = ([torch.stack([o[i] for o in outs])
                    for i in range(len(mbs))] if self.last
                   else [torch.empty_like(x) for x in mbs])
        return [collectives.broadcast_from(x, self.axis, root=self.pp - 1,
                                           mesh=self.mesh)
                for x in stacked]


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd node: inputs are the microbatch
    leaves then the stage's param leaves; outputs the replicated
    results."""

    @staticmethod
    def forward(ctx, run: _Schedule, n_carry: int, *tensors):
        mbs, params = list(tensors[:n_carry]), list(tensors[n_carry:])
        aliases = [p.detach().requires_grad_(p.requires_grad)
                   for p in params]
        outs, graphs = run.forward(mbs, aliases, keep=True)
        ctx.run, ctx.graphs, ctx.aliases = run, graphs, aliases
        ctx.mb_specs = [(x.shape, x.dtype, x.device) for x in mbs]
        return tuple(run.replicate(outs, mbs))

    @staticmethod
    def backward(ctx, *grad_outs):
        run, graphs, aliases = ctx.run, ctx.graphs, ctx.aliases
        m = len(graphs)
        like = [torch.empty(s[1:], dtype=d, device=dev)
                for s, d, dev in ctx.mb_specs]
        trainable = [a for a in aliases if a.requires_grad]
        sums = [torch.zeros_like(a, dtype=torch.float32) for a in trainable]
        in_grads, pending = [None] * m, []
        for k in reversed(range(m)):
            # Microbatch k's output cotangent arrives from the next stage
            # while k+1's input cotangent goes back to the previous one.
            got = run.step(pending if not run.first else [],
                           like if not run.last else [], forward=False)
            g_out = [g[k] for g in grad_outs] if run.last else got
            leaves_in, out = graphs[k]
            pairs = [(o, g) for o, g in zip(out, g_out) if o.requires_grad]
            wrt = [x for x in leaves_in if x.requires_grad] + trainable
            grads = torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True) if pairs else [None] * len(wrt)
            grads = iter(grads)
            g_in = [(next(grads) if x.requires_grad else None)
                    for x in leaves_in]
            g_in = [torch.zeros_like(x) if g is None else g
                    for g, x in zip(g_in, leaves_in)]
            for total, g in zip(sums, grads):
                if g is not None:
                    total.add_(g.float())
            graphs[k] = None  # free microbatch k's graph
            pending = g_in
            if run.first:
                in_grads[k] = g_in
        if not run.first:
            run.step(pending, [], forward=False)
        # The microbatches' cotangent exists on stage 0: every stage gets
        # it (the transpose of JAX's pvary), so the layers before the
        # pipeline see the same cotangent everywhere.
        d_mbs = [collectives.broadcast_from(
            torch.stack([g[i] for g in in_grads]) if run.first
            else torch.empty(s, dtype=d, device=dev),
            run.axis, root=0, mesh=run.mesh)
            for i, (s, d, dev) in enumerate(ctx.mb_specs)]
        sums = iter(sums)
        d_params = [next(sums).to(a.dtype) if a.requires_grad else None
                    for a in aliases]
        ctx.graphs = None
        grads = d_mbs + d_params
        return (None, None, *(g if need else None for g, need in
                              zip(grads, ctx.needs_input_grad[2:])))


def pipeline(layer_fn: Callable[[Any, Any], Any], stage_params,
             microbatches, *, mesh, axis: str = mesh_lib.AXIS_PP):
    """Run microbatches through a pipelined layer stack.

    Args:
      layer_fn: ``layer_fn(one_layer_params, carry) -> carry``, one layer
        on one microbatch's carry (a tuple/list/dict of tensors, shapes
        and types kept).
      stage_params: THIS stage's layers, a list of params trees
        (:func:`stage_bounds` of the whole list); with ``pp`` 1 the whole
        list.
      microbatches: a carry tree whose leaves have leading dim M; leaf
        ``[k]`` is microbatch k's, the same on every stage.
      mesh: this rank's mesh (``parallel.mesh.Mesh``).

    Returns a tree congruent with ``microbatches``: each microbatch's
    carry after all L layers, the same on every stage.  Differentiable
    in the microbatches and the params (see the module docstring);
    without autograd (``torch.no_grad()``) the forward schedule alone
    runs and keeps no graph.
    """
    pp = num_stages(mesh, axis)
    if pp <= 1:
        return _sequential(layer_fn, stage_params, microbatches)
    # The backward (autograd's thread) sends over the forward's groups.
    run = _Schedule(layer_fn, stage_params, microbatches,
                    mesh_lib.routed(mesh), axis)
    mbs, params = _leaves(microbatches), _leaves(stage_params)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in mbs + params):
        outs = _Pipeline.apply(run, len(mbs), *mbs, *params)
    else:
        last, _ = run.forward(mbs, params, keep=False)
        outs = run.replicate(last, mbs)
    return _rebuild(microbatches, iter(outs))
