"""Paged decode attention: hand-written CUDA kernels plus their plain version.

Port of ``cloud_tpu/ops/paged_attention.py``.  Queries ``q [B, Tq, H, hd]``
attend over KV read in place through a per-row block table: page ``p`` of
row ``b`` (positions ``[p*bt, (p+1)*bt)``) reads prefix-pool block
``table[b, p]`` when that entry is ``>= 0`` and the slot row itself when it
is ``-1``.  Key ``j`` is valid for query ``t`` iff ``j < cur_len[b] + t``.

``cache_l`` / ``pool_l`` are KV-leaf dicts ``{"k": ..., "v": ...}`` shaped
``[B, S, H, hd]`` / ``[NB, bt, H, hd]``, exactly as in the JAX package.  A
``kv_quant`` cache stores ``k``/``v`` as int8 with f32 ``k_scale``/``v_scale``
leaves ``[B, S, H, 1]`` (pool ``[NB, bt, H, 1]``); slot and pool must agree.

Dispatch is by device alone: CPU tensors take :func:`_reference` (a
term-for-term port of the jnp reference, post-scale int8 algebra included),
CUDA tensors launch ``csrc/paged_attention.cu`` (see its header for the
design and what bounds it) or raise: K8 (``paged_attention``) for K/V of
q's type, K8q (``paged_attention_int8``) for int8 K/V.  Each call splits a
row's live pages across :func:`plan_splits` blocks (flash-decoding) and
merges their partials in a second, small kernel: two kernels a call, one
launch counted.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from cloud_tpu_torch.ops import dispatch

NEG_INF = -1e30

#: Page size used when no prefix pool rides along.
DEFAULT_PAGE_TOKENS = 128

#: Head dims and the largest query count the kernel is compiled for.
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
KERNEL_MAX_TQ = 64

#: Blocks per SM the split aims for, and the most splits a row takes.
SPLIT_BLOCKS_PER_SM = 4
MAX_SPLITS = 64


def plan_splits(b: int, h: int, s: int, bt: int, sms: int) -> int:
    """How many blocks share a (row, head)'s pages: enough that
    ``b * h * n`` blocks give every one of ``sms`` SMs
    :data:`SPLIT_BLOCKS_PER_SM`, but no more than the ``ceil(s / bt)``
    pages of a row (no split narrower than a page) or :data:`MAX_SPLITS`.
    Static shapes only: the lengths live on the card and are never read
    here."""
    want = -(-SPLIT_BLOCKS_PER_SM * sms // (b * h))
    return max(1, min(want, -(-s // bt), MAX_SPLITS))


def split_pages(n_live: int, n_split: int, split: int) -> Tuple[int, int]:
    """Pages ``[first, end)`` of split ``split`` when a row has ``n_live``
    live pages: its even share, as the kernel computes it."""
    return split * n_live // n_split, (split + 1) * n_live // n_split


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    gather, chunk-causal mask with the finite NEG_INF; int8 leaves fold
    ``k_scale`` into the scores before the mask and ``v_scale`` into the
    softmax weights."""
    def gather(name):
        return _gather_paged(
            cache_l[name], None if pool_l is None else pool_l[name],
            block_table)

    def fold(scores_like, kv_scale):
        # [B, S, H, 1] -> [B, H, 1, S] broadcast over the query dim.
        return scores_like * kv_scale.permute(0, 2, 3, 1)

    k_cache, v_cache = gather("k"), gather("v")
    s = k_cache.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum(
        "bqhd,bkhd->bhqk", q.float(), k_cache.float()
    ) * scale
    if "k_scale" in cache_l:
        scores = fold(scores, gather("k_scale"))
    cur_len = cur_len.to(device=q.device, dtype=torch.long)
    valid = torch.arange(s, device=q.device)[None, None, :] < (
        cur_len[:, None, None]
        + torch.arange(q.shape[1], device=q.device)[None, :, None]
    )
    scores = torch.where(valid[:, None, :, :], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    if "v_scale" in cache_l:
        weights = fold(weights, gather("v_scale"))
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v_cache.float())
    return out.to(q.dtype)


def _check_precision(cache_l, pool_l) -> bool:
    """Whether the K/V are int8 (``kv_quant``); raise if the slot leaves
    and the pool's disagree, or int8 leaves come without their scales."""
    quantized = "k_scale" in cache_l
    for where, leaves in (("slot", cache_l), ("pool", pool_l)):
        if leaves is None:
            continue
        has_scales = "k_scale" in leaves and "v_scale" in leaves
        is_int8 = leaves["k"].dtype == torch.int8
        if has_scales != quantized or is_int8 != quantized:
            raise TypeError(
                f"paged attention: {where} leaves "
                f"{'are' if is_int8 else 'are not'} int8 "
                f"{'with' if has_scales else 'without'} k_scale/v_scale, "
                f"but the slot row is {'int8' if quantized else 'full precision'}"
                f": slot and pool must both be int8 with scales, or neither"
            )
    return quantized


def _fit_page(s: int, bt: Optional[int]) -> Optional[int]:
    """The pool's block_tokens when a pool rides along, else the largest
    multiple of 8 at or below ``min(DEFAULT_PAGE_TOKENS, S)``."""
    if bt is not None:
        return bt
    fitted = min(DEFAULT_PAGE_TOKENS, s)
    fitted -= fitted % 8
    return fitted if fitted >= 8 else None


_fns = {}


def _kernel_fn(name):
    """The typed C entry point ``name`` of the paged library: K8
    (``paged_attention``) or K8q (``paged_attention_int8``)."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(dispatch.load("paged_attention"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        pointers = 10 if name == "paged_attention" else 14
        fn.argtypes = [p] * pointers + [i] * 8 + [ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _aligned(x):
    """``x`` contiguous and starting on 16 bytes (the kernel copies K/V
    rows in 16-byte ``cp.async`` pieces): itself, or a copy."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _paged_kernel(q, cache_l, cur_len, pool_l, block_table):
    """Launch ``paged_attention.cu`` on CUDA tensors: K8, or K8q when the
    K/V are int8."""
    quantized = _check_precision(cache_l, pool_l)
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
    kv_dtype = torch.int8 if quantized else q.dtype
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            kv_dtype == slot_k.dtype == slot_v.dtype):
        raise TypeError(
            f"paged kernel takes float32 or bfloat16 q and K/V of q's type "
            f"or int8; got {q.dtype}, {slot_k.dtype}, {slot_v.dtype}"
        )
    names = ("k", "v", "k_scale", "v_scale") if quantized else ("k", "v")
    slot = [cache_l[n] for n in names]
    if quantized:
        for x in slot[2:]:
            if x.dtype != torch.float32 or x.shape != (b, s, h, 1):
                raise TypeError(
                    f"slot scales must be float32 [B, S, H, 1] = "
                    f"{(b, s, h, 1)}; got {x.dtype} {tuple(x.shape)}")
    pool = None
    bt = None
    if pool_l is not None:
        pool = [pool_l[n] for n in names]
        nb, bt = pool[0].shape[:2]
        if (pool[0].dtype != kv_dtype or pool[0].shape[2:] != (h, d)
                or pool[1].shape != pool[0].shape):
            raise ValueError(
                f"pool leaves must be [NB, bt, {h}, {d}] of {kv_dtype}; got "
                f"{tuple(pool[0].shape)} of {pool[0].dtype}"
            )
        if quantized and any(x.dtype != torch.float32
                             or x.shape != (nb, bt, h, 1) for x in pool[2:]):
            raise TypeError(f"pool scales must be float32 [NB, bt, H, 1] = "
                            f"{(nb, bt, h, 1)}")
    bt = _fit_page(s, bt) or s
    tensors = [q] + slot + (pool or [])
    if any(x.device != q.device for x in tensors):
        raise ValueError("q, cache and pool must lie on one device")
    q = q.contiguous()
    slot = [_aligned(x) for x in slot]
    pool = None if pool is None else [_aligned(x) for x in pool]
    table = None
    n_tab = 0
    if block_table is not None:
        table = block_table.to(device=q.device, dtype=torch.int32).contiguous()
        n_tab = table.shape[1]
    lens = cur_len.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(q)
    n_split = plan_splits(b, h, s, bt, _sm_count(q.device.index))
    # The splits' partials: (m, l) then acc[hd] of each, f32, one block.
    parts = b * tq * h * n_split
    work = torch.empty(parts * (d + 2), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    pool_ptrs = ([None] * len(names) if pool is None
                 else [x.data_ptr() for x in pool])
    name = "paged_attention_int8" if quantized else "paged_attention"
    rc = _kernel_fn(name)(
        q.data_ptr(), *(x.data_ptr() for x in slot), *pool_ptrs,
        None if table is None else table.data_ptr(),
        lens.data_ptr(), out.data_ptr(), work.data_ptr(),
        work.data_ptr() + 4 * 2 * parts,
        b, tq, h, d, s, bt, n_tab, n_split, 1.0 / math.sqrt(d),
        int(q.dtype == torch.bfloat16), q.device.index, stream,
    )
    dispatch.check("paged_attention", rc)
    dispatch.count_launch(name)
    return out


def _paged(q, cache_l, cur_len, *, pool_l, block_table):
    if q.device.type == "cpu":
        _check_precision(cache_l, pool_l)
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
