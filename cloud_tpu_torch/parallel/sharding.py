"""Logical-axis sharding rules (port of ``cloud_tpu/parallel/sharding.py``).

Models name tensor dims with *logical* axes (``batch``, ``embed``,
``heads`` ...); a :class:`ShardingRules` table maps them to mesh axes.
The JAX package hands the resulting ``PartitionSpec`` to GSPMD, which
places the arrays and inserts the collectives.  The port has one process
per rank, so the rules decide which slice of a full tensor a rank keeps
(:func:`shard_tensor`, :func:`shard_tree`) and the tensor-parallel layers
(``models/layers.py``, ``models/transformer.py``) call the collectives
themselves.  :func:`shard_constraint` is therefore a no-op here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from cloud_tpu_torch.parallel import mesh as mesh_lib

#: A logical axis maps to one mesh axis, a tuple of mesh axes (the tensor
#: dimension is sharded over their product), or None (replicated).
MeshAxisAssignment = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per-dim mesh-axis assignments, ``jax.sharding.PartitionSpec``'s
    shape: a tuple of ``None``, an axis name or a tuple of them."""

    def __new__(cls, *parts: MeshAxisAssignment):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: Dict[str, MeshAxisAssignment]

    def assignment(self, logical_axis: Optional[str]) -> MeshAxisAssignment:
        if logical_axis is None:
            return None
        if logical_axis not in self.rules:
            raise KeyError(
                f"No sharding rule for logical axis {logical_axis!r}; "
                f"known axes: {sorted(self.rules)}"
            )
        return self.rules[logical_axis]

    def spec(self, *logical_axes: Optional[str]) -> PartitionSpec:
        """PartitionSpec for a tensor whose dims carry these logical axes."""
        return PartitionSpec(*(self.assignment(a) for a in logical_axes))

    def extended(self, **overrides: MeshAxisAssignment) -> "ShardingRules":
        merged = dict(self.rules)
        merged.update(overrides)
        return ShardingRules(merged)


#: Default logical-axis table: ``batch`` over every data-parallel axis;
#: parameters shard ``embed`` over fsdp and head/mlp/vocab dims over tp;
#: ``seq`` is the ring-attention axis.
DEFAULT_RULES = ShardingRules(
    {
        "batch": (mesh_lib.AXIS_DP, mesh_lib.AXIS_FSDP),
        "expert_batch": (mesh_lib.AXIS_DP, mesh_lib.AXIS_FSDP, mesh_lib.AXIS_EP),
        "seq": mesh_lib.AXIS_SP,
        "embed": mesh_lib.AXIS_FSDP,
        # Activations shard on batch, never on the param-sharding axis.
        "act_embed": None,
        "heads": mesh_lib.AXIS_TP,
        "kv": None,
        "mlp": mesh_lib.AXIS_TP,
        "vocab": mesh_lib.AXIS_TP,
        "expert": mesh_lib.AXIS_EP,
        "layers": None,
        "stage": mesh_lib.AXIS_PP,
    }
)


def logical_to_mesh_axes(
    logical_axes: Tuple[Optional[str], ...],
    rules: ShardingRules = DEFAULT_RULES,
) -> PartitionSpec:
    return rules.spec(*logical_axes)


def mesh_axes(assignment: MeshAxisAssignment) -> Tuple[str, ...]:
    """An assignment as a tuple of mesh axis names (``()`` replicated)."""
    if assignment is None:
        return ()
    return assignment if isinstance(assignment, tuple) else (assignment,)


def shard_count_and_index(mesh, assignment: MeshAxisAssignment
                          ) -> Tuple[int, int]:
    """How many shards a dim assigned to ``assignment`` is cut into, and
    which of them this rank keeps: the axes' sizes multiply, the first
    axis major (``NamedSharding``'s order)."""
    count, index = 1, 0
    for axis in mesh_axes(assignment):
        size = mesh.axis_size(axis)
        count *= size
        index = index * size + mesh.axis_index(axis)
    return count, index


def shard_bounds(size: int, count: int, index: int) -> Tuple[int, int]:
    """``[start, stop)`` of shard ``index`` of ``count`` over ``size``
    elements, as ``torch.tensor_split`` cuts them: the first ``size %
    count`` shards hold one element more (a vocabulary that ``tp`` does
    not divide, e.g. 32000 over 3)."""
    base, extra = divmod(size, count)
    start = index * base + min(index, extra)
    return start, start + base + (1 if index < extra else 0)


def shard_tensor(x: torch.Tensor, logical_axes: Tuple[Optional[str], ...],
                 mesh, rules: ShardingRules = DEFAULT_RULES) -> torch.Tensor:
    """This rank's slice of the full tensor ``x`` whose dims carry
    ``logical_axes``: each dim assigned to mesh axes is cut by
    :func:`shard_bounds`.  A view where no dim is cut, else a copy (so
    the full tensor can be freed)."""
    if len(logical_axes) != x.dim():
        raise ValueError(
            f"{len(logical_axes)} logical axes {logical_axes} for a "
            f"{x.dim()}-d tensor of shape {tuple(x.shape)}"
        )
    out, cut = x, False
    for dim, axis in enumerate(logical_axes):
        count, index = shard_count_and_index(mesh, rules.assignment(axis))
        if count == 1:
            continue
        start, stop = shard_bounds(x.shape[dim], count, index)
        out, cut = out.narrow(dim, start, stop - start), True
    return out.contiguous().clone() if cut else out


class LayerStack(list):
    """The logical axes of a model's layer list, one tree per layer: the
    port's form of the JAX package's stacked leading dim, whose logical
    axis is ``layers``.  Where the rules map ``layers`` to a mesh axis
    (``pp``: a pipeline stage's layers), :func:`shard_tree` keeps this
    rank's contiguous block of the list and :func:`gather_tree` assembles
    the list whole; elsewhere the list is replicated."""


def layer_stack_cut(mesh, rules: ShardingRules, num_layers: int
                    ) -> Tuple[Tuple[str, ...], int, int]:
    """``(axes, start, stop)``: the nontrivial mesh axes a layer list of
    ``num_layers`` is cut over under ``rules`` (``rules.rules.get
    ("layers")``, as the JAX package reads it: a table with no
    ``layers`` entry keeps the list whole), and this rank's block
    ``[start, stop)``.  The count must divide (``ValueError``, the JAX
    pipeline's message); the list may be cut over one axis."""
    from cloud_tpu_torch.parallel import pipeline

    axes = tuple(a for a in mesh_axes(rules.rules.get("layers"))
                 if mesh.axis_size(a) > 1)
    if not axes:
        return (), 0, num_layers
    if len(axes) > 1:
        raise ValueError(f"rules map 'layers' to {axes}: a layer list is "
                         "cut over one mesh axis (pp)")
    return (axes, *pipeline.stage_bounds(num_layers, mesh, axes[0]))


def split_dims(mesh, logical_axes: Tuple[Optional[str], ...],
               rules: ShardingRules = DEFAULT_RULES
               ) -> Dict[int, Tuple[str, ...]]:
    """Each cut dim of a tensor with ``logical_axes`` -> the nontrivial
    mesh axes it is cut over (first axis major)."""
    out = {}
    for dim, axis in enumerate(logical_axes):
        axes = tuple(a for a in mesh_axes(rules.assignment(axis))
                     if mesh.axis_size(a) > 1)
        if axes:
            out[dim] = axes
    return out


def gather_tensor(x: torch.Tensor, logical_axes: Tuple[Optional[str], ...],
                  mesh, rules: ShardingRules = DEFAULT_RULES) -> torch.Tensor:
    """The inverse of :func:`shard_tensor`: the full tensor from every
    rank's slice, each cut dim all-gathered over its axes (the minor axis
    first; uneven extents exchanged first).  A collective call on every
    rank of the cut axes."""
    from cloud_tpu_torch.parallel import collectives

    for dim, axes in split_dims(mesh, logical_axes, rules).items():
        for axis in reversed(axes):
            extent = torch.tensor([x.shape[dim]], dtype=torch.int64,
                                  device=x.device)
            sizes = collectives.all_gather(extent, axis, mesh=mesh).tolist()
            x = collectives.all_gather(x, axis, gather_dim=dim, sizes=sizes,
                                       mesh=mesh)
    return x


def gather_tree(shard, axes, mesh, rules: ShardingRules = DEFAULT_RULES):
    """:func:`gather_tensor` over a tree of tensors, ``axes`` congruent
    with it (a leaf's axes a tuple); leaves in sorted-key order.  A layer
    list cut by its :class:`LayerStack` (this rank's block) comes back
    whole: each rank first gathers its own block, then every layer is
    broadcast from the member that holds it."""
    if isinstance(axes, LayerStack):
        cut, start, stop = layer_stack_cut(mesh, rules, len(axes))
        if not cut:
            return [gather_tree(p, a, mesh, rules)
                    for p, a in zip(shard, axes)]
        own = [gather_tree(p, a, mesh, rules)
               for p, a in zip(shard, axes[start:stop])]
        return [_broadcast_tree(own[j % len(own)], cut[0], j // len(own),
                                mesh) for j in range(len(axes))]
    if isinstance(shard, (list, tuple)):
        return [gather_tree(p, a, mesh, rules) for p, a in zip(shard, axes)]
    return {name: (gather_tree(shard[name], axes[name], mesh, rules)
                   if isinstance(shard[name], (dict, list, tuple))
                   else gather_tensor(shard[name], tuple(axes[name]), mesh,
                                      rules))
            for name in sorted(shard)}


def _broadcast_tree(tree, axis: str, root: int, mesh):
    """Every member of ``axis`` gets member ``root``'s tree (the members'
    trees alike in structure, shapes and types); leaves in sorted-key
    order."""
    from cloud_tpu_torch.parallel import collectives

    if isinstance(tree, dict):
        return {k: _broadcast_tree(tree[k], axis, root, mesh)
                for k in sorted(tree)}
    return collectives.broadcast_from(tree, axis, root=root, mesh=mesh)


def shard_tree(params, axes, mesh, rules: ShardingRules = DEFAULT_RULES):
    """:func:`shard_tensor` over a params tree, ``axes`` congruent with it
    (dicts and lists; a leaf's axes a tuple).  A layer list whose axes
    are a :class:`LayerStack` keeps this rank's block of layers
    (:func:`layer_stack_cut`).  Weight-only int8 leaves follow their
    float leaf's axes: ``X_q`` takes ``X``'s, and ``X_scale`` takes them
    with ``None`` on its size-1 dims (a row-split kernel's
    per-output-column scale stays whole on every rank)."""
    if isinstance(axes, LayerStack):
        _, start, stop = layer_stack_cut(mesh, rules, len(params))
        params, axes = params[start:stop], axes[start:stop]
    if isinstance(params, (list, tuple)):
        return [shard_tree(p, a, mesh, rules) for p, a in zip(params, axes)]
    out = {}
    for name, value in params.items():
        if isinstance(value, (dict, list, tuple)):
            out[name] = shard_tree(value, axes[name], mesh, rules)
            continue
        if name in axes:
            leaf_axes = axes[name]
        elif name.endswith("_q"):
            leaf_axes = axes[name[:-2]]
        elif name.endswith("_scale"):
            leaf_axes = tuple(None if n == 1 else a for n, a in
                              zip(value.shape, axes[name[:-6]]))
        else:
            raise KeyError(f"no logical axes for param leaf {name!r}")
        out[name] = shard_tensor(value, tuple(leaf_axes), mesh, rules)
    return out


def pad_batch(batch, pad_to: int, *, axis: int = 0):
    """Zero-pad every leaf of a HOST batch along ``axis``; returns
    ``(padded, valid)``, ``valid`` a float32 ``[pad_to]`` mask with 1.0
    on real rows.  Leaves without the axis pass through; leaves that
    have it must agree on its length.  Tensors come back to the host as
    numpy, as the JAX package's device arrays do."""
    if pad_to < 1:
        raise ValueError(f"pad_to must be >= 1, got {pad_to}")
    leaves = _leaves(batch)
    lengths = {
        int(np.shape(_host(leaf))[axis])
        for leaf in leaves
        if len(np.shape(_host(leaf))) > axis
    }
    if not lengths:
        raise ValueError(
            f"pad_batch: no leaf has axis {axis} to pad (leaf shapes: "
            f"{[np.shape(_host(leaf)) for leaf in leaves]})"
        )
    if len(lengths) > 1:
        raise ValueError(
            f"pad_batch: leaves disagree on axis {axis} length "
            f"({sorted(lengths)}); a consistent batch axis is required "
            "to pad unambiguously"
        )
    n = lengths.pop()
    if n > pad_to:
        raise ValueError(
            f"batch axis {axis} has {n} rows, more than pad_to={pad_to}"
        )
    valid = np.zeros((pad_to,), np.float32)
    valid[:n] = 1.0
    if n == pad_to:
        return batch, valid

    def pad(x):
        x = np.asarray(_host(x))
        if x.ndim <= axis:
            return x  # no batch axis: side data rides along unpadded
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad_to - n)
        return np.pad(x, widths)

    return _map(batch, pad), valid


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _leaves(v)]
    return [tree]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def shard_constraint(x, *logical_axes: Optional[str],
                     rules: ShardingRules = DEFAULT_RULES, mesh=None):
    """A no-op: the JAX package's ``with_sharding_constraint`` asks GSPMD
    for a layout; the port's tensor-parallel layers hold each rank's
    shard explicitly and call the collectives where GSPMD would insert
    them."""
    return x
