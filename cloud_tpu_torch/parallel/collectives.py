"""Named-axis collectives (port of the group-based half of
``cloud_tpu/parallel/collectives.py``).

The JAX package's wrappers run inside ``shard_map`` over ``lax``
collectives.  Here every rank is a process: each function takes a mesh
axis name and runs the ``torch.distributed`` collective on this rank's
group for that axis (``Mesh.group``), on the global mesh unless
``mesh=`` is given.  An axis of size 1 needs no communication: the value
comes back as it is (a copy where the JAX function returns a new array).
A tuple of axes reduces over each in turn.

The route of each collective depends only on the mesh's backend and the
tensor's device, never on a failure.  gloo takes CUDA tensors in
``all_reduce``, ``broadcast``, ``all_gather``, ``reduce_scatter`` and
``barrier`` (checked on an H100 host with torch 2.11, two ranks sharing
the card); its point-to-point sends of CUDA tensors are not relied on, so
on gloo with CUDA tensors ``ring_permute`` is an ``all_reduce`` of a
zero-padded buffer (each rank's block at its own offset; adding zeros is
exact) and the pipeline's :func:`exchange` stages its tensors through
host memory.  ``all_to_all_seq_heads`` uses ``all_to_all_single`` on
every backend.  :func:`exchange` and :func:`broadcast_from` move
sub-f32 floats as f32 (the JAX package's ``_psum_f32``; exact both
ways).

Every collective with a payload runs under a ``collective/<name>`` span
carrying its payload bytes and axis (``monitoring/tracing.py``); the
walk is skipped when tracing is off.  None of these functions is
differentiable; ``parallel/autograd.py`` wraps the ones a training
step's backward needs.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from cloud_tpu_torch.monitoring import tracing
from cloud_tpu_torch.parallel import mesh as mesh_lib

AxisNames = Union[str, Sequence[str]]


def _payload_bytes(x) -> int:
    """Stored bytes of a tensor or a nested dict/list of them."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(_payload_bytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_payload_bytes(v) for v in x)
    return 0


def _span(name: str, x, axis):
    """Collective span carrying payload size and axis."""
    if not tracing.enabled():
        return tracing.span(name)
    return tracing.span(name, payload_bytes=_payload_bytes(x), axis=str(axis))


def _mesh(mesh):
    mesh = mesh if mesh is not None else mesh_lib.get_global_mesh()
    if mesh is None:
        raise ValueError(
            "no mesh: pass mesh= or install one (parallel.use_mesh)")
    return mesh


def _axes(axis: AxisNames):
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _zero_padded_route(mesh, x: torch.Tensor) -> bool:
    """True where ``ring_permute`` goes through an all-reduce: gloo and a
    CUDA tensor."""
    return mesh.backend == "gloo" and x.device.type == "cuda"


def _host_staged_route(mesh, x: torch.Tensor) -> bool:
    """True where :func:`exchange` sends and receives through host
    memory: gloo and a CUDA tensor."""
    return mesh.backend == "gloo" and x.device.type == "cuda"


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` as f32 when it is a float narrower than f32, else ``x``."""
    if x.is_floating_point() and torch.finfo(x.dtype).bits < 32:
        return x.float()
    return x


def _all_reduce(x: torch.Tensor, mesh, axis: str, op=dist.ReduceOp.SUM):
    group = mesh.group(axis)
    out = x.clone()
    if group is not None:
        dist.all_reduce(out, op=op, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, axis: AxisNames, *, mesh=None):
    mesh = _mesh(mesh)
    with _span("collective/all_reduce_sum", x, axis):
        for name in _axes(axis):
            x = _all_reduce(x, mesh, name)
        return x


def all_reduce_mean(x: torch.Tensor, axis: AxisNames, *, mesh=None):
    mesh = _mesh(mesh)
    with _span("collective/all_reduce_mean", x, axis):
        n = 1
        for name in _axes(axis):
            x = _all_reduce(x, mesh, name)
            n *= mesh.axis_size(name)
        return x / n


def all_gather(x: torch.Tensor, axis: str, *, gather_dim: int = 0,
               tiled: bool = True, sizes: Sequence[int] = None, mesh=None):
    """Every member's ``x`` along ``gather_dim``, in axis order
    (``tiled=False``: stacked along a new ``gather_dim``).
    ``sizes`` gives each member's extent along ``gather_dim`` when the
    blocks are uneven (a vocabulary ``tp`` does not divide); by default
    every member holds ``x.shape[gather_dim]``."""
    mesh = _mesh(mesh)
    with _span("collective/all_gather", x, axis):
        if not tiled:
            x = x.unsqueeze(gather_dim)
        n = mesh.axis_size(axis)
        group = mesh.group(axis)
        if group is None:
            return x.clone()
        dim = gather_dim % x.dim()
        sizes = list(sizes) if sizes is not None else [x.shape[dim]] * n
        width = max(sizes)
        if x.shape[dim] < width:  # equal blocks on the wire, cut after
            pad = list(x.shape)
            pad[dim] = width - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                         dim=dim)


def reduce_scatter_sum(x: torch.Tensor, axis: str, *, scatter_dim: int = 0,
                       mesh=None):
    """The sum over ``axis``, cut into equal blocks along
    ``scatter_dim``; this member keeps its own block."""
    mesh = _mesh(mesh)
    with _span("collective/reduce_scatter_sum", x, axis):
        n = mesh.axis_size(axis)
        if x.shape[scatter_dim] % n:
            raise ValueError(
                f"reduce_scatter dim {scatter_dim} (size "
                f"{x.shape[scatter_dim]}) must divide by axis {axis!r} "
                f"size {n}")
        group = mesh.group(axis)
        if group is None:
            return x.clone()
        block = x.shape[scatter_dim] // n
        parts = [p.contiguous() for p in torch.split(x, block, scatter_dim)]
        out = torch.empty_like(parts[mesh.axis_index(axis)])
        dist.reduce_scatter(out, parts, group=group)
        return out


def ring_permute(x: torch.Tensor, axis: str, *, shift: int = 1, mesh=None):
    """Send this member's ``x`` to the member ``shift`` places on along
    ``axis`` (cyclically); returns what arrived from ``shift`` places
    back."""
    mesh = _mesh(mesh)
    with _span("collective/ring_permute", x, axis):
        n = mesh.axis_size(axis)
        group = mesh.group(axis)
        if group is None or shift % n == 0:
            return x.clone()
        index = mesh.axis_index(axis)
        src = (index - shift) % n
        if _zero_padded_route(mesh, x):
            buf = x.new_zeros((n,) + tuple(x.shape))
            buf[index] = x
            dist.all_reduce(buf, group=group)
            return buf[src].clone()
        ranks = mesh.group_ranks[axis]
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x.contiguous(),
                          ranks[(index + shift) % n], group=group),
               dist.P2POp(dist.irecv, out, ranks[src], group=group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


def hierarchical_all_reduce_sum(x: torch.Tensor, *, ici_axis: str,
                                dcn_axis: str, scatter_dim: int = 0,
                                mesh=None):
    """Two-level all-reduce for a mesh split over slow links: a
    reduce-scatter over ``ici_axis`` (the fast links), an all-reduce of
    the ``1/ici``-sized shard over ``dcn_axis``, then an all-gather over
    ``ici_axis``; only the shard crosses the slow links.  Where
    ``scatter_dim`` does not divide by the ``ici_axis`` size, a flat sum
    over both axes (the JAX package's indivisible route)."""
    mesh = _mesh(mesh)
    with _span("collective/hierarchical_all_reduce_sum", x,
               (ici_axis, dcn_axis)):
        n = mesh.axis_size(ici_axis)
        if x.dim() == 0 or x.shape[scatter_dim] % n:
            out = x
            for name in (ici_axis, dcn_axis):
                out = _all_reduce(out, mesh, name)
            return out
        shard = reduce_scatter_sum(x, ici_axis, scatter_dim=scatter_dim,
                                   mesh=mesh)
        shard = _all_reduce(shard, mesh, dcn_axis)
        return all_gather(shard, ici_axis, gather_dim=scatter_dim,
                          mesh=mesh)


def grad_sync(grads, axis: AxisNames, *, mean: bool = True,
              accum_dtype=torch.float32, mesh=None):
    """Sum (``mean=False``) or mean of a gradient tree (nested dicts and
    lists of tensors) over ``axis``: floating leaves narrower than
    ``accum_dtype`` are reduced in it and cast back (a bf16 sum on the
    wire loses low-order bits at every add).  Leaves are reduced one by
    one in the tree's order (dict keys sorted), the same on every rank."""
    mesh = _mesh(mesh)
    axes = _axes(axis)
    width = torch.finfo(accum_dtype).bits

    def sync(g):
        dtype = g.dtype
        if dtype.is_floating_point and torch.finfo(dtype).bits < width:
            g = g.to(accum_dtype)
        n = 1
        for name in axes:
            g = _all_reduce(g, mesh, name)
            n *= mesh.axis_size(name)
        if mean:
            g = g / n
        return g.to(dtype)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(tree[k]) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return sync(tree)

    with _span("collective/grad_sync", grads, axis):
        return walk(grads)


def all_to_all_seq_heads(x: torch.Tensor, axis: str, *, seq_dim: int = 1,
                         heads_dim: int = 2, to_heads: bool = True,
                         mesh=None):
    """Re-shard attention activations between the sequence-parallel and
    the head-parallel layout with one all-to-all (Ulysses): with
    ``to_heads`` a ``[B, T/n, H, D]`` block becomes ``[B, T, H/n, D]``
    (every position of this member's head group, blocks in axis order),
    and ``to_heads=False`` inverts it.  The split dim must divide by the
    axis size (``ValueError`` as in the JAX package)."""
    split, concat = ((heads_dim, seq_dim) if to_heads
                     else (seq_dim, heads_dim))
    mesh = _mesh(mesh)
    n = mesh.axis_size(axis)
    if x.shape[split] % n:
        raise ValueError(
            f"all_to_all split dim {split} (size {x.shape[split]}) must "
            f"divide by axis {axis!r} size {n}"
        )
    with _span("collective/all_to_all_seq_heads", x, axis):
        group = mesh.group(axis)
        if group is None:
            return x.clone()
        # Chunk j of the split dim goes to member j: move the chunks to a
        # leading dim, exchange, and lay what arrived along ``concat`` in
        # member order.
        parts = x.unflatten(split, (n, x.shape[split] // n))
        send = parts.movedim(split, 0).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        # recv[j] is member j's chunk, shaped as x with split cut to 1/n.
        return torch.cat(list(recv.unbind(0)), dim=concat)


def axis_index(axis: str, *, mesh=None) -> int:
    return _mesh(mesh).axis_index(axis)


def axis_size(axis: str, *, mesh=None) -> int:
    return _mesh(mesh).axis_size(axis)


def barrier(axis: AxisNames, *, mesh=None):
    """Synchronization point over ``axis`` (a psum of a zero, as in the
    JAX package)."""
    mesh = _mesh(mesh)
    zero = torch.zeros((), dtype=torch.int32, device=mesh.device)
    for name in _axes(axis):
        zero = _all_reduce(zero, mesh, name)
    return zero


def broadcast_from(x: torch.Tensor, axis: str, *, root: int = 0, mesh=None):
    """Every member of ``axis`` gets member ``root``'s value (a float
    narrower than f32 travels as f32)."""
    mesh = _mesh(mesh)
    with _span("collective/broadcast_from", x, axis):
        group = mesh.group(axis)
        if group is None:
            return x.clone()
        out = _wide(x).clone()
        dist.broadcast(out, src=mesh.group_ranks[axis][root], group=group)
        return out.to(x.dtype)


def exchange(send: Sequence[torch.Tensor], axis: str, *,
             send_to: Optional[int] = None,
             recv_like: Sequence[torch.Tensor] = (),
             recv_from: Optional[int] = None, mesh=None):
    """One step of a point-to-point schedule on ``axis``: the tensors of
    ``send`` go to the member at axis index ``send_to`` while tensors
    shaped and typed like those of ``recv_like`` arrive from
    ``recv_from``.  Every send and receive is posted before any is waited
    on (a rank blocked in a send to a neighbour that is itself blocked in
    a send to it would deadlock on gloo).  Either half may be empty.
    Floats narrower than f32 travel as f32; on gloo with CUDA tensors
    both halves go through host memory.  Returns the received tensors, in
    ``recv_like``'s order, on its devices."""
    mesh = _mesh(mesh)
    send, recv_like = list(send), list(recv_like)
    if not send and not recv_like:
        return []
    with _span("collective/exchange", send + recv_like, axis):
        group = mesh.group(axis)
        if group is None:
            raise ValueError(f"exchange over axis {axis!r} of size 1")
        ranks = mesh.group_ranks[axis]
        staged = _host_staged_route(mesh, (send + recv_like)[0])
        where = torch.device("cpu") if staged else None
        outgoing = [_wide(x).to(where or x.device).contiguous()
                    for x in send]
        incoming = [torch.empty(tuple(x.shape), dtype=_wide(x).dtype,
                                device=where or x.device)
                    for x in recv_like]
        ops = ([dist.P2POp(dist.isend, x, ranks[send_to], group=group)
                for x in outgoing]
               + [dist.P2POp(dist.irecv, x, ranks[recv_from], group=group)
                  for x in incoming])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [got.to(device=like.device, dtype=like.dtype)
                for got, like in zip(incoming, recv_like)]


def host_local_mean(tree):
    """The mean of every tensor leaf of a nested dict/list (this rank's
    values; the JAX package's is jit-level over the global arrays)."""
    if isinstance(tree, dict):
        return {k: host_local_mean(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_local_mean(v) for v in tree)
    x = torch.as_tensor(tree)
    return x.mean() if x.is_floating_point() else x.float().mean()
