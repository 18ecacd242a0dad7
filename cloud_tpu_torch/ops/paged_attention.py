"""Paged decode attention: a hand-written CUDA kernel plus its plain version.

Port of ``cloud_tpu/ops/paged_attention.py``.  Queries ``q [B, Tq, H, hd]``
attend over KV read in place through a per-row block table: page ``p`` of
row ``b`` (positions ``[p*bt, (p+1)*bt)``) reads prefix-pool block
``table[b, p]`` when that entry is ``>= 0`` and the slot row itself when it
is ``-1``.  Key ``j`` is valid for query ``t`` iff ``j < cur_len[b] + t``.

``cache_l`` / ``pool_l`` are KV-leaf dicts ``{"k": ..., "v": ...}`` shaped
``[B, S, H, hd]`` / ``[NB, bt, H, hd]``, exactly as in the JAX package.

Dispatch is by device alone: CPU tensors take :func:`_reference` (a
term-for-term port of the jnp reference), CUDA tensors launch
``csrc/paged_attention.cu`` (see its header for the design and what bounds
it) or raise.  int8 (``kv_quant``) leaves are not supported yet and raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from cloud_tpu_torch.ops import dispatch

NEG_INF = -1e30

#: Page size used when no prefix pool rides along.
DEFAULT_PAGE_TOKENS = 128

#: Head dims and the largest query count the kernel is compiled for.
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_MAX_TQ = 64


def _gather_paged(slot_leaf, pool_leaf, block_table):
    """The virtual KV a block table describes: position ``j`` of row ``b``
    reads ``pool_leaf[table[b, j // bt], j % bt]`` when that entry is
    ``>= 0``, else ``slot_leaf[b, j]``; positions past the table's page
    coverage read the slot row."""
    b, s = slot_leaf.shape[:2]
    if pool_leaf is None or block_table is None:
        return slot_leaf
    bt = pool_leaf.shape[1]
    n_pages = block_table.shape[1]
    j = torch.arange(s, device=slot_leaf.device)
    page = j // bt
    in_pages = page < n_pages
    table = block_table.to(device=slot_leaf.device, dtype=torch.long)
    blk = torch.where(
        in_pages[None, :],
        table[:, torch.clamp(page, max=n_pages - 1)],
        torch.full((), -1, dtype=torch.long, device=slot_leaf.device),
    )  # [B, S]
    gathered = pool_leaf[torch.clamp(blk, min=0), (j % bt)[None, :]]
    sel = (blk >= 0).reshape(b, s, *([1] * (slot_leaf.dim() - 2)))
    return torch.where(sel, gathered, slot_leaf)


def _reference(q, cache_l, cur_len, pool_l, block_table):
    """The plain version: f32 scores and softmax over the block-table
    gather, chunk-causal mask with the finite NEG_INF."""
    k_cache = _gather_paged(
        cache_l["k"], None if pool_l is None else pool_l["k"], block_table
    )
    v_cache = _gather_paged(
        cache_l["v"], None if pool_l is None else pool_l["v"], block_table
    )
    s = k_cache.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q.float(), k_cache.float()
    ) * scale
    cur_len = cur_len.to(device=q.device, dtype=torch.long)
    valid = torch.arange(s, device=q.device)[None, None, :] < (
        cur_len[:, None, None]
        + torch.arange(q.shape[1], device=q.device)[None, :, None]
    )
    scores = torch.where(valid[:, None, :, :], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v_cache.float())
    return out.to(q.dtype)


def _fit_page(s: int, bt: Optional[int]) -> Optional[int]:
    """The pool's block_tokens when a pool rides along, else the largest
    multiple of 8 at or below ``min(DEFAULT_PAGE_TOKENS, S)``."""
    if bt is not None:
        return bt
    fitted = min(DEFAULT_PAGE_TOKENS, s)
    fitted -= fitted % 8
    return fitted if fitted >= 8 else None


_fn = None


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = dispatch.load("paged_attention").paged_attention
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p,
                       i, i, i, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _paged_kernel(q, cache_l, cur_len, pool_l, block_table):
    """Launch ``paged_attention.cu`` on CUDA tensors."""
    if "k_scale" in cache_l or cache_l["k"].dtype == torch.int8:
        raise NotImplementedError(
            "int8 (kv_quant) K/V in the paged kernel comes with the kv_quant "
            "slice of the port (ROADMAP.md)"
        )
    slot_k, slot_v = cache_l["k"], cache_l["v"]
    b, tq, h, d = q.shape
    s = slot_k.shape[1]
    if slot_k.shape != (b, s, h, d) or slot_v.shape != slot_k.shape:
        raise ValueError(
            f"slot leaves must be [B, S, H, hd] matching q {tuple(q.shape)}; "
            f"got {tuple(slot_k.shape)}, {tuple(slot_v.shape)}"
        )
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {KERNEL_HEAD_DIMS}")
    if tq > KERNEL_MAX_TQ:
        raise ValueError(f"Tq {tq} above the kernel's {KERNEL_MAX_TQ}")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == slot_k.dtype == slot_v.dtype):
        raise TypeError(
            f"paged kernel takes float32 or bfloat16 q and K/V of one type; "
            f"got {q.dtype}, {slot_k.dtype}, {slot_v.dtype}"
        )
    tensors = [q, slot_k, slot_v]
    pool_k = pool_v = None
    bt = None
    if pool_l is not None:
        pool_k, pool_v = pool_l["k"], pool_l["v"]
        if pool_k.dtype != q.dtype or pool_k.shape[2:] != (h, d):
            raise ValueError(
                f"pool leaves must be [NB, bt, {h}, {d}] of {q.dtype}; got "
                f"{tuple(pool_k.shape)} of {pool_k.dtype}"
            )
        bt = pool_k.shape[1]
        tensors += [pool_k, pool_v]
    bt = _fit_page(s, bt) or s
    if any(x.device != q.device for x in tensors):
        raise ValueError("q, cache and pool must lie on one device")
    q, slot_k, slot_v = (x.contiguous() for x in (q, slot_k, slot_v))
    if pool_k is not None:
        pool_k, pool_v = pool_k.contiguous(), pool_v.contiguous()
    table = None
    n_tab = 0
    if block_table is not None:
        table = block_table.to(device=q.device, dtype=torch.int32).contiguous()
        n_tab = table.shape[1]
    lens = cur_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel_fn()(
        q.data_ptr(), slot_k.data_ptr(), slot_v.data_ptr(),
        None if pool_k is None else pool_k.data_ptr(),
        None if pool_v is None else pool_v.data_ptr(),
        None if table is None else table.data_ptr(),
        lens.data_ptr(), out.data_ptr(),
        b, tq, h, d, s, bt, n_tab, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), q.device.index, stream,
    )
    dispatch.check("paged_attention", rc)
    dispatch.count_launch("paged_attention")
    return out


def _paged(q, cache_l, cur_len, *, pool_l, block_table):
    if q.device.type == "cpu":
        if "k_scale" in cache_l:
            raise NotImplementedError(
                "int8 (kv_quant) K/V comes with the kv_quant slice of the "
                "port (ROADMAP.md)"
            )
        return _reference(q, cache_l, cur_len, pool_l, block_table)
    if q.device.type == "cuda":
        return _paged_kernel(q, cache_l, cur_len, pool_l, block_table)
    raise ValueError(f"paged attention: unsupported device {q.device}")


def paged_decode_attention(q, cache_l, cur_len, *, pool_l=None,
                           block_table: Optional[torch.Tensor] = None):
    """Single-token decode attention (``[B, 1, H, hd]`` queries) over a
    block-table view of slot rows and pool blocks; key ``j`` of row ``b``
    is valid iff ``j < cur_len[b]``.  ``block_table=None`` (or no pool)
    reads slot rows only."""
    return _paged(q, cache_l, cur_len, pool_l=pool_l,
                  block_table=block_table)


def paged_chunk_attention(q, cache_l, cur_len, *, pool_l=None,
                          block_table: Optional[torch.Tensor] = None):
    """Chunk-causal paged attention: query ``t`` sits at cache position
    ``cur_len - 1 + t`` and sees keys ``j < cur_len + t``."""
    return _paged(q, cache_l, cur_len, pool_l=pool_l,
                  block_table=block_table)


def paged_verify_attention(q, cache_l, cur_len, *, pool_l=None,
                           block_table: Optional[torch.Tensor] = None):
    """Speculative verify-window attention; mask-wise the chunk shape."""
    return _paged(q, cache_l, cur_len, pool_l=pool_l,
                  block_table=block_table)
