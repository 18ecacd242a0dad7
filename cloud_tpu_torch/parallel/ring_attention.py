"""Ring attention: exact attention over sequence blocks spread along the
``sp`` mesh axis (port of ``cloud_tpu/parallel/ring_attention.py``).

Each rank holds one sequence block of q, k and v.  The k/v block (and
its key mask) travels around the ring, ``ring_permute`` one member on at
every hop, while each rank folds the block it holds into an online
softmax: K5 through ``flash_attention_with_lse``'s forward gives the
block's out and lse, and :func:`_merge_partials` merges them.  With
contiguous causal blocks, past blocks attend fully, the diagonal block
applies the in-block causal mask, and future blocks launch nothing (the
JAX package's ``lax.cond`` skip, merged there with weight 0).
:func:`ring_attention_balanced` takes the zig-zag layout
(:func:`zigzag_indices`): rank i holds chunks i and 2n-1-i of a 2n-chunk
split, so every rank folds the same causal work at every hop (three
square c x c calls on the diagonal hop, two on every other).

The whole ring is one ``torch.autograd.Function``.  JAX differentiates
through the lse merge; here the backward runs the ring again in the same
order of hops: at each hop K6/K7 (``flash_attention``'s backward
kernels, or their plain version on the CPU) take q, the block, dO and
the MERGED out and lse with that hop's causality.  That is the gradient
of the merge (``p = exp(s - lse)`` over the merged lse, ``delta =
rowsum(dO * out)`` over the merged out), equal to JAX's up to rounding.
dq accumulates on its rank in f32; dk/dv accumulate in f32 and ride the
ring with their block, arriving home after n hops.  Every collective of
the forward and the backward is issued by this module in an order fixed
by the program, never by autograd's scheduler: the ranks of a causal
ring build different graphs (future blocks are skipped), and two ranks
issuing collectives in different orders would pair the wrong tensors.

:func:`fold_hop` and :func:`hop_grads` are the work of one hop, apart
from the rotation: a caller can drive every rank's hops in one process.
Rows with no valid key in a block get lse about ``NEG_INF`` there and
merge with weight exactly 0; their cotangents are zero where the loss
drops them (ROADMAP C1).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from cloud_tpu_torch.ops import flash_attention as flash_lib
from cloud_tpu_torch.parallel import collectives
from cloud_tpu_torch.parallel import mesh as mesh_lib

NEG_INF = -1e30  # large-but-finite: fully-masked rows stay NaN-free


def _merge_partials(o_acc, lse_acc, o_new, lse_new):
    """Online-softmax merge of two attention partials: ``o_*`` ``[B, T,
    H, D]`` f32, each normalized within its own partial, ``lse_*`` their
    ``[B, H, T]`` log-sum-exps."""
    lse = torch.logaddexp(lse_acc, lse_new)
    w_acc = torch.exp(lse_acc - lse).transpose(1, 2)[..., None]
    w_new = torch.exp(lse_new - lse).transpose(1, 2)[..., None]
    return o_acc * w_acc + o_new * w_new, lse


def zigzag_indices(seq_len: int, n: int, *, inverse: bool = False,
                   device=None) -> torch.Tensor:
    """Gather indices of the zig-zag layout over ``n`` ring ranks: the
    sequence splits into 2n chunks and rank i holds chunks (i, 2n-1-i);
    ``x[:, zigzag_indices(T, n)]`` lays a sequence out so that contiguous
    blocks of it are the ranks' blocks, ``inverse=True`` undoes it.
    Positions fed to RoPE go through the same permutation (tokens keep
    their global positions)."""
    if seq_len % (2 * n):
        raise ValueError(
            f"zig-zag layout needs seq_len divisible by 2*n; got "
            f"T={seq_len}, n={n}"
        )
    chunk = seq_len // (2 * n)
    order = []
    for i in range(n):
        order += [i, 2 * n - 1 - i]
    forward = torch.cat([torch.arange(c * chunk, (c + 1) * chunk,
                                      device=device) for c in order])
    if not inverse:
        return forward
    inv = torch.empty_like(forward)
    inv[forward] = torch.arange(seq_len, device=device)
    return inv


def block_chunks(n: int, rank: int, *, zigzag: bool
                 ) -> Tuple[Tuple[int, ...], int]:
    """``(ids, count)``: the sequence splits into ``count`` equal chunks
    and rank ``rank`` of ``n`` holds chunks ``ids``, in the order its block
    lays them out: chunk ``rank`` of ``n``, or under the zig-zag layout
    (:func:`zigzag_indices`) chunks ``rank`` and ``2n - 1 - rank`` of
    ``2n``."""
    if zigzag:
        return (rank, 2 * n - 1 - rank), 2 * n
    return (rank,), n


def hop_calls(src_idx: int, my_idx: int, *, causal: bool,
              zigzag: bool) -> List[Tuple[int, int, bool]]:
    """The attention calls of one hop: ``(q segment, k/v segment,
    causal)`` for each, in order.  A contiguous block is one segment; a
    zig-zag block two (chunks my_idx and 2n-1-my_idx).  A future block
    of the causal contiguous ring has none."""
    if zigzag:
        if src_idx == my_idx:  # q_lo's diagonal; q_hi sees lo, then its own
            return [(0, 0, True), (1, 0, False), (1, 1, True)]
        if src_idx < my_idx:  # chunk src is past both; 2n-1-src future
            return [(0, 0, False), (1, 0, False)]
        return [(1, 0, False), (1, 1, False)]  # both between lo and hi
    if not causal:
        return [(0, 0, False)]
    if src_idx > my_idx:
        return []
    return [(0, 0, src_idx == my_idx)]


def _segments(x: torch.Tensor, zigzag: bool, dim: int = 1):
    if not zigzag:
        return [x]
    c = x.shape[dim] // 2
    return [x.narrow(dim, 0, c), x.narrow(dim, c, c)]


def new_partials(q: torch.Tensor, *, zigzag: bool):
    """Empty accumulators ``[(o, lse)]``, one per q segment: o zeros in
    f32, lse ``NEG_INF``."""
    b, _, h, d = q.shape
    return [(torch.zeros((b, s.shape[1], h, d), dtype=torch.float32,
                         device=q.device),
             torch.full((b, h, s.shape[1]), NEG_INF, dtype=torch.float32,
                        device=q.device))
            for s in _segments(q, zigzag)]


def fold_hop(partials, q, k_blk, v_blk, m_blk, src_idx: int, my_idx: int,
             *, causal: bool, zigzag: bool):
    """Fold the block that originated at ``src_idx`` into ``partials``
    (:func:`new_partials`): K5 (or its plain version on the CPU) once per
    call of :func:`hop_calls`, each merged into its q segment's
    accumulator.  Returns the new accumulators."""
    fwd = flash_lib._by_device(q, flash_lib._reference_with_lse,
                               flash_lib._flash_kernel)
    qs, ks, vs = (_segments(x, zigzag) for x in (q, k_blk, v_blk))
    partials = list(partials)
    for qi, ki, call_causal in hop_calls(src_idx, my_idx, causal=causal,
                                         zigzag=zigzag):
        out, lse = fwd(qs[qi], ks[ki], vs[ki], causal=call_causal,
                       mask=m_blk)
        partials[qi] = _merge_partials(*partials[qi], out.float(), lse)
    return partials


def merged(partials) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merged ``(out [B, T, H, D] f32, lse [B, H, T])`` of the
    accumulators, segments in order."""
    return (torch.cat([o for o, _ in partials], dim=1),
            torch.cat([l for _, l in partials], dim=2))


def hop_grads(dq, q, k_blk, v_blk, m_blk, do, out, lse, src_idx: int,
              my_idx: int, *, causal: bool, zigzag: bool):
    """One hop of the backward: K6/K7 (or their plain version on the CPU)
    once per call of :func:`hop_calls` on q's segment, the block's, dO's
    and the merged out's and lse's.  Adds the dq terms to ``dq`` (f32, q's
    shape) in place and returns the block's ``(dk, dv)`` terms in f32
    (zeros where the hop has no call)."""
    bwd = flash_lib._by_device(q, flash_lib._bwd_reference,
                               flash_lib._bwd_kernels)
    qs, ks, vs, dos, outs, dqs = (_segments(x, zigzag)
                                  for x in (q, k_blk, v_blk, do, out, dq))
    lses = _segments(lse, zigzag, dim=2)
    dk = torch.zeros(k_blk.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dks, dvs = _segments(dk, zigzag), _segments(dv, zigzag)
    for qi, ki, call_causal in hop_calls(src_idx, my_idx, causal=causal,
                                         zigzag=zigzag):
        gq, gk, gv = bwd(qs[qi], ks[ki], vs[ki], m_blk, dos[qi], outs[qi],
                         lses[qi], causal=call_causal)
        dqs[qi].add_(gq.float())
        dks[ki].add_(gk.float())
        dvs[ki].add_(gv.float())
    return dk, dv


def _rotate(x, axis, mesh):
    return None if x is None else collectives.ring_permute(x, axis,
                                                           mesh=mesh)


class _Ring(torch.autograd.Function):
    """The ring's forward and its explicit backward ring (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, mesh, axis, causal, zigzag):
        n, my = mesh.axis_size(axis), mesh.axis_index(axis)
        partials = new_partials(q, zigzag=zigzag)
        kv, m = torch.stack([k, v]), mask
        for i in range(n):
            src = (my - i) % n
            partials = fold_hop(partials, q, kv[0], kv[1], m, src, my,
                                causal=causal, zigzag=zigzag)
            if i < n - 1:  # the last block needs no rotation
                kv, m = _rotate(kv, axis, mesh), _rotate(m, axis, mesh)
        out, lse = merged(partials)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        # The backward's thread sends over the groups the forward used.
        ctx.args = (mesh_lib.routed(mesh), axis, causal, zigzag)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, out, lse = ctx.saved_tensors
        mesh, axis, causal, zigzag = ctx.args
        n, my = mesh.axis_size(axis), mesh.axis_index(axis)
        do = do.contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kv, m = torch.stack([k, v]), mask
        dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
        for i in range(n):
            src = (my - i) % n
            dk, dv = hop_grads(dq, q, kv[0], kv[1], m, do, out, lse, src,
                               my, causal=causal, zigzag=zigzag)
            dkv[0].add_(dk)
            dkv[1].add_(dv)
            if i < n - 1:
                kv, m = _rotate(kv, axis, mesh), _rotate(m, axis, mesh)
            # The block's dk/dv travel with it: after the n-th hop they
            # are home.
            dkv = _rotate(dkv, axis, mesh)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None, None, None, None)


def _check(q, k, v, mesh, axis):
    if not (q.shape == k.shape == v.shape and q.dim() == 4):
        raise ValueError(
            "ring attention takes local q/k/v blocks of one [B, T_local, H, "
            f"D] shape; got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    return mesh if mesh is not None else collectives._mesh(None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: str = mesh_lib.AXIS_SP, *, causal: bool = True,
                   mask: Optional[torch.Tensor] = None,
                   mesh=None) -> torch.Tensor:
    """Exact attention over sequence blocks spread along ``axis``.

    ``q``, ``k``, ``v``: this rank's blocks ``[B, T_local, H, D]``, block
    i holding global positions ``[i*T_local, (i+1)*T_local)``; ``causal``
    masks in global positions; ``mask``: this rank's ``[B, T_local]``
    slice of the global key-padding mask (nonzero = attend), which rides
    the ring with its K/V block.  Returns the local output block in q's
    dtype, differentiable in q, k and v."""
    mesh = _check(q, k, v, mesh, axis)
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.int32).contiguous()
    return _Ring.apply(q, k, v, mask, mesh, axis, causal, False)


def ring_attention_balanced(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, axis: str = mesh_lib.AXIS_SP,
                            *, mesh=None) -> torch.Tensor:
    """Causal ring attention with the same work on every rank at every
    hop: the local blocks must hold zig-zag chunks (:func:`zigzag_indices`),
    rank i's first half global chunk i and its second half chunk 2n-1-i.
    Every sub-call is a square c x c call."""
    mesh = _check(q, k, v, mesh, axis)
    if q.shape[1] % 2:
        raise ValueError("zig-zag local block must hold two equal chunks")
    return _Ring.apply(q, k, v, None, mesh, axis, True, True)
