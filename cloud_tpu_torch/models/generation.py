"""Autoregressive generation for CloudLM (port of ``cloud_tpu/models/generation.py``).

Prefill runs the prompt through every layer with the flash-attention
kernel and writes each layer's K/V into a ``[L, B, S, H, hd]`` cache;
decode appends one position per step and attends through the paged
kernel (``ops/paged_attention``).  The JAX package's single ``lax.scan``
becomes a Python loop over steps and layers, and its immutable cache
threaded through the scan becomes one cache updated in place: every
writer here stores into the cache tensors it was given and returns them.

The batch programs (:func:`prefill_program`, :func:`decode_program`) are
the batch scheduler's device work; the slot-grid programs
(:func:`insert_slot_program`, :func:`decode_chunk_program`) the
continuous scheduler's; the prefix-pool programs
(:func:`init_prefix_pool`, :func:`copy_prefix_program`,
:func:`save_prefix_program`, the block downloads and uploads) and the
chunked-prefill programs (:func:`prefill_chunk_program`,
:func:`finalize_slot_program`) serve the prefix KV cache and chunked
prefill; the speculative programs (:func:`draft_chunk_program`,
:func:`verify_chunk_program`, :func:`draft_prefill_slot_program`) serve
draft-and-verify decoding.  Greedy outputs are token-identical to
:func:`generate`.
:func:`beam_search` decodes the same cache with a live and a finished
hypothesis set.

``kv_quant=True`` stores the cache as int8 with per-(position, head) f32
scales (``k_scale``/``v_scale`` ``[L, B, S, H, 1]``), quantized where it is
written; every reader folds the scales in with the post-scale algebra
(the int8 kernel K8q on the card).  Weight-only int8 params
(``models/quantization.py``) run through every entry point as they are.
An MoE CloudLM routes each program's tokens at that program's ``T`` (the
bucket, the chunk, the verify window, 1 in decode), as the JAX package's
programs do.

Tensor parallelism: params cut to one rank's shard
(``parallel/tensor_parallel.py``) carry their ``TensorParallel`` under
``params["tp"]``, and every program then runs the rank's heads (a cache
of ``H / tp`` heads, ``init_slot_cache(..., tp=)``), sums the row-split
layers over ``tp`` and gathers the logits before sampling, so every rank
samples the same tokens from the same logits.  A slice that also spans
``sp`` (``TensorParallel.sp_size`` > 1) holds the same shard and the
whole cache on every ``sp`` member and runs every program whole there,
except a one-shot prefill (:func:`_prefill_forward`: an insert, a batch,
a draft's prefill) of a width ``sp`` divides: each member embeds,
projects and runs the MLP on its contiguous block of the prompt, attends
through ``parallel.ring_attention`` (K5 once per hop that has work) and
gathers every layer's K/V over ``sp`` before they are written, and the
next-token logits come from the member holding the last prompt position
(a sum with zeros).  Other widths run whole on every member; no program
pads the sequence (an MoE layer's capacity follows the width).

Randomness comes from an explicit ``torch.Generator``; the JAX package's
``jax.random`` bits are not reproduced, so sampled runs agree with it in
distribution (the same filtered support), not draw for draw.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import layers, quantization, transformer
from cloud_tpu_torch.models import moe as moe_lib
from cloud_tpu_torch.ops import flash_attention as flash_lib
from cloud_tpu_torch.ops import paged_attention as paged_lib
from cloud_tpu_torch.parallel import collectives, ring_attention
from cloud_tpu_torch.parallel import mesh as mesh_lib

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """Sampling hyperparameters.  ``temperature=0`` is greedy (argmax);
    ``repetition_penalty`` / ``top_k`` / ``top_p`` apply in that order;
    ``eos_id`` stops a sequence (the eos itself is emitted, ``pad_id``
    after it); ``min_new_tokens`` masks eos for that many tokens."""

    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_id: Optional[int] = None
    pad_id: int = 0
    repetition_penalty: float = 1.0
    min_new_tokens: int = 0


def filter_logits(logits, sample: SampleConfig, *, seen=None, allow_eos=None):
    """Everything :func:`sample_logits` does before its draw: repetition
    penalty and eos gating, then (non-greedy) temperature, top-k, top-p.
    Tokens left at ``-inf`` are outside the support."""
    if sample.repetition_penalty != 1.0 and seen is not None:
        penalized = torch.where(
            logits > 0, logits / sample.repetition_penalty,
            logits * sample.repetition_penalty,
        )
        logits = torch.where(seen, penalized, logits)
    if sample.eos_id is not None and allow_eos is not None:
        logits = logits.clone()
        eos_col = logits[:, sample.eos_id]
        logits[:, sample.eos_id] = torch.where(
            allow_eos, eos_col, torch.full_like(eos_col, -math.inf)
        )
    if sample.temperature == 0.0:
        return logits
    logits = logits / sample.temperature
    if sample.top_k is not None:
        kth = torch.topk(logits, sample.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -math.inf, logits)
    if sample.top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cumulative = torch.cumsum(probs, dim=-1)
        keep = cumulative - probs < sample.top_p
        keep[..., 0] = True  # the top token always survives
        threshold = torch.where(keep, sorted_logits, math.inf).amin(
            dim=-1, keepdim=True
        )
        logits = torch.where(logits < threshold, -math.inf, logits)
    return logits


def sample_logits(logits, sample: SampleConfig, *, generator=None, seen=None,
                  allow_eos=None):
    """One sampling step: logits ``[B, V]`` f32 -> token ids ``[B]``."""
    logits = filter_logits(logits, sample, seen=seen, allow_eos=allow_eos)
    if sample.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def _init_cache(config, b: int, s: int, device, kv_quant: bool = False,
                tp=None):
    """Zeroed KV cache ``{"k", "v"}`` of ``[L, B, S, H, hd]``; with
    ``kv_quant`` the K/V are int8 and ``k_scale``/``v_scale`` (ones, f32)
    ``[L, B, S, H, 1]`` ride beside them.  Under ``tp`` (a
    ``TensorParallel``) ``H`` is the rank's share of the heads."""
    heads = config.num_heads if tp is None else tp.local_heads(
        config.num_heads)
    shape = (config.num_layers, b, s, heads, config.head_dim)
    if not kv_quant:
        return {"k": torch.zeros(shape, dtype=config.dtype, device=device),
                "v": torch.zeros(shape, dtype=config.dtype, device=device)}
    scale_shape = shape[:-1] + (1,)
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=device),
        "k_scale": torch.ones(scale_shape, dtype=torch.float32, device=device),
        "v": torch.zeros(shape, dtype=torch.int8, device=device),
        "v_scale": torch.ones(scale_shape, dtype=torch.float32, device=device),
    }


def _quantize_kv(x):
    """Per-(..., head) vector int8: ``(q, scale [..., 1])``.  No host
    sync, so it can sit on the decode path."""
    return quantization.quantize_unchecked(x, axis=-1)


def _kv_leaf_updates(k_raw, v_raw, config, quantized: bool):
    """Cache-leaf values for raw k/v activations: ``{"k", "v"}`` in the
    cache dtype, or int8 plus per-(position, head) scales for a quantized
    cache.  The one spelling shared by every cache writer."""
    if quantized:
        k_q, k_sc = _quantize_kv(k_raw)
        v_q, v_sc = _quantize_kv(v_raw)
        return {"k": k_q, "k_scale": k_sc, "v": v_q, "v_scale": v_sc}
    return {"k": k_raw.to(config.dtype), "v": v_raw.to(config.dtype)}


def _cache_attention(q, cache_l, cur_len, *, chunk_causal: bool = False):
    """Plain attention of ``q [B, Tq, H, hd]`` over a layer cache
    ``[B, S, H, hd]``: key j of row i is valid iff ``j < cur_len[i]``
    (``+ t`` for query t with ``chunk_causal``).  An int8 cache folds
    ``k_scale`` into the scores and ``v_scale`` into the softmax weights
    (post-scale).  CPU tensors only: on the card every cache read goes
    through the paged kernels."""
    if q.device.type != "cpu":
        raise RuntimeError(
            "_cache_attention is the plain CPU version; CUDA tensors read "
            "the cache through ops.paged_attention"
        )

    def fold(scores_like, kv_scale):
        # [B, S, H, 1] -> [B, H, 1, S] broadcast over the query dim.
        return scores_like * kv_scale.permute(0, 2, 3, 1)

    k_cache, v_cache = cache_l["k"], cache_l["v"]
    s = k_cache.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * scale
    if "k_scale" in cache_l:
        scores = fold(scores, cache_l["k_scale"])
    cur_len = cur_len.long()
    pos = torch.arange(s, device=q.device)
    if chunk_causal:
        valid = pos[None, None, :] < (
            cur_len[:, None, None]
            + torch.arange(q.shape[1], device=q.device)[None, :, None]
        )
        scores = torch.where(valid[:, None, :, :], scores, NEG_INF)
    else:
        valid = pos[None, :] < cur_len[:, None]
        scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    if "v_scale" in cache_l:
        weights = fold(weights, cache_l["v_scale"])
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v_cache.float())
    return out.to(q.dtype)


def prepare_params(params, config):
    """The params with every layer matrix stored once in the compute dtype
    (``dense_apply`` and ``materialize_matrix`` would cast it on every
    call; the numbers are the same).  int8 ``*_q`` leaves stay int8.  Norm
    scales, the embedding, the head and an MoE router (applied in f32)
    keep their type."""
    def cast(tree):
        return {k: v if k.endswith("_q") or k == "router"
                else cast(v) if isinstance(v, dict) else v.to(config.dtype)
                for k, v in tree.items()}

    out = dict(params)
    out["layers"] = [dict(layer, att=cast(layer["att"]), mlp=cast(layer["mlp"]))
                     for layer in params["layers"]]
    return out


def _mlp(layer_params, y, config, tp=None):
    """The layer's MLP: dense SwiGLU (hidden units split under ``tp``),
    or the MoE MLP (its auxiliary loss dropped; each expert's hidden
    units split under ``tp``), routed at the call's ``T`` as the JAX
    package routes it (a split prefill's block as part of the whole
    width)."""
    if config.moe is not None:
        return moe_lib.moe_mlp_apply(layer_params["mlp"], y, config.moe,
                                     ctx=tp, aux=False)[0]
    return layers.mlp_block_apply(layer_params["mlp"], y, tp=tp)


def _write_rows(leaf, rows, write_pos, values):
    """``leaf[rows, write_pos] = values`` in place, where rows whose
    ``write_pos`` is out of range ``[0, S)`` keep their bytes (JAX's
    drop-mode scatter).  Written without a host sync: such rows rewrite
    their own current value at a clamped index."""
    s = leaf.shape[1]
    keep = (write_pos >= 0) & (write_pos < s)
    idx = write_pos.clamp(0, s - 1).long()
    old = leaf[rows, idx]
    mask = keep.reshape(-1, *([1] * (values.dim() - 1)))
    leaf[rows, idx] = torch.where(mask, values.to(leaf.dtype), old)


def _decode_layer(layer_params, x, cache_l, cur_len, config, write_pos=None,
                  paged=None, tp=None):
    """One block on a single-token slice ``x [B, 1, D]``: writes this
    step's k/v (int8 and scales for a quantized cache) at ``cur_len`` (or
    ``write_pos``; out-of-range suppresses the row's write) into the cache
    in place, then attends over the valid prefix through the paged
    kernel."""
    b = x.shape[0]
    y = layers.rmsnorm_apply(layer_params["ln1"], x)
    q, k_new, v_new = transformer.qkv_project(
        layer_params["att"], y, cur_len[:, None], config
    )
    rows = torch.arange(b, device=x.device)
    wp = cur_len if write_pos is None else write_pos
    updates = _kv_leaf_updates(k_new[:, 0], v_new[:, 0], config,
                               "k_scale" in cache_l)
    for name, value in updates.items():
        _write_rows(cache_l[name], rows, wp, value)
    paged = paged or {}
    attended = paged_lib.paged_decode_attention(
        q, cache_l, cur_len + 1, pool_l=paged.get("pool_l"),
        block_table=paged.get("block_table"),
    )
    x = x + layers.row_parallel_dense(layer_params["att"]["out"],
                                      attended.reshape(b, 1, -1), tp)
    y = layers.rmsnorm_apply(layer_params["ln2"], x)
    return x + _mlp(layer_params, y, config, tp)


def _prefill_layer(layer_params, x, positions, prompt_mask, config, tp=None):
    """One block on the prompt buffer ``[B, T, D]``: causal flash
    attention with the padding mask key-side; returns the block's k/v.
    Under a split prefill (``tp.seq_split``) ``x`` is the rank's ``sp``
    block and attention runs the causal ring over the blocks."""
    b, t, _ = x.shape
    y = layers.rmsnorm_apply(layer_params["ln1"], x)
    q, k, v = transformer.qkv_project(layer_params["att"], y, positions,
                                      config)
    if tp is not None and tp.seq_split:
        attended = ring_attention.ring_attention(
            q, k, v, causal=True, mask=prompt_mask, mesh=tp.mesh)
    else:
        attended = flash_lib.flash_attention(q, k, v, causal=True,
                                             mask=prompt_mask)
    x = x + layers.row_parallel_dense(layer_params["att"]["out"],
                                      attended.reshape(b, t, -1), tp)
    y = layers.rmsnorm_apply(layer_params["ln2"], x)
    return x + _mlp(layer_params, y, config, tp), k, v


def _final_logits(params, x, config):
    x = layers.rmsnorm_apply(params["ln_f"], x)
    return transformer.lm_logits(params, x, config)


def _prefill_forward(params, prompt_tokens, prompt_lens, config):
    """The prompt forward pass: per-layer k/v lists (each ``[B, T, H,
    hd]``) and the next-token logits ``[B, V]`` at each row's last real
    prompt position.  On a slice whose ``sp`` divides ``T`` the pass runs
    split over ``sp`` (:func:`_split_prefill_forward`)."""
    b, t_prompt = prompt_tokens.shape
    device = prompt_tokens.device
    positions = torch.arange(t_prompt, device=device).expand(b, t_prompt)
    prompt_mask = (positions < prompt_lens[:, None]).to(torch.int32)
    tp = params.get("tp")
    if tp is not None and tp.splits_seq(t_prompt):
        return _split_prefill_forward(params, prompt_tokens, prompt_lens,
                                      positions, prompt_mask, config, tp)
    x = layers.embedding_apply(params["embed"], prompt_tokens,
                               dtype=config.dtype, tp=tp)
    x = x * math.sqrt(config.dim)
    ks, vs = [], []
    for layer_params in params["layers"]:
        x, k, v = _prefill_layer(layer_params, x, positions, prompt_mask,
                                 config, tp)
        ks.append(k)
        vs.append(v)
    last_x = x[torch.arange(b, device=device), prompt_lens.long() - 1]
    logits0 = _final_logits(params, last_x[:, None], config)[:, 0]
    return ks, vs, logits0


def _split_prefill_forward(params, prompt_tokens, prompt_lens, positions,
                           prompt_mask, config, tp):
    """:func:`_prefill_forward` split over ``sp``: this rank runs its
    contiguous block ``tp.seq_bounds(T)`` of the prompt through every
    layer (the ring over the blocks, an MoE layer routing the block as
    part of the whole width), then gathers every layer's K/V over ``sp``
    (the cache is replicated over ``sp``) and sums each row's last
    position's activation over ``sp`` (the rank holding it gives the row,
    the others zeros: exact) before the logits.  Every rank issues the
    same collectives in the same order, whatever its block."""
    b, t_prompt = prompt_tokens.shape
    start, stop = tp.seq_bounds(t_prompt)
    block = dataclasses.replace(tp, seq_split=True)
    x = layers.embedding_apply(params["embed"], prompt_tokens[:, start:stop],
                               dtype=config.dtype, tp=tp)
    x = x * math.sqrt(config.dim)
    ks, vs = [], []
    for layer_params in params["layers"]:
        x, k, v = _prefill_layer(layer_params, x, positions[:, start:stop],
                                 prompt_mask[:, start:stop], config, block)
        ks.append(k)
        vs.append(v)
    kv = collectives.all_gather(  # [2, L, B, T, H, hd]
        torch.stack([torch.stack(ks), torch.stack(vs)]), mesh_lib.AXIS_SP,
        gather_dim=3, mesh=tp.mesh)
    last = prompt_lens.long() - 1
    mine = (last >= start) & (last < stop)
    rows = torch.arange(b, device=x.device)
    last_x = torch.where(mine[:, None],
                         x[rows, (last - start).clamp(0, stop - start - 1)],
                         torch.zeros((), dtype=x.dtype, device=x.device))
    last_x = collectives.all_reduce_sum(last_x, mesh_lib.AXIS_SP,
                                        mesh=tp.mesh)
    logits0 = _final_logits(params, last_x[:, None], config)[:, 0]
    return list(kv[0]), list(kv[1]), logits0


def _write_prefill(cache, k_pref, v_pref, row0: int, config):
    """Store a prefill's per-layer k/v into ``cache`` rows ``[row0,
    row0 + B)`` at positions ``[0, T)``, in place (quantized first when
    the cache is int8)."""
    quantized = "k_scale" in cache
    for layer, (k, v) in enumerate(zip(k_pref, v_pref)):
        b, t = k.shape[:2]
        for name, value in _kv_leaf_updates(k, v, config, quantized).items():
            cache[name][layer, row0:row0 + b, :t] = value
    return cache


def _prefill(params, prompt_tokens, prompt_lens, config, s,
             kv_quant: bool = False):
    b = prompt_tokens.shape[0]
    cache = _init_cache(config, b, s, prompt_tokens.device, kv_quant=kv_quant,
                        tp=params.get("tp"))
    k_pref, v_pref, logits0 = _prefill_forward(params, prompt_tokens,
                                               prompt_lens, config)
    return _write_prefill(cache, k_pref, v_pref, 0, config), logits0


def _decode_step(params, cache, token, cur_len, config, write_pos=None,
                 pool=None, block_table=None):
    """One single-token step for every row: embed ``token [B]``, run the
    layers against the cache (k/v written in place), return the cache and
    the next-token logits ``[B, V]``."""
    tp = params.get("tp")
    x = layers.embedding_apply(params["embed"], token[:, None],
                               dtype=config.dtype, tp=tp)
    x = x * math.sqrt(config.dim)
    for layer, layer_params in enumerate(params["layers"]):
        cache_l = {name: leaf[layer] for name, leaf in cache.items()}
        paged = {"block_table": block_table}
        if pool is not None:
            paged["pool_l"] = {name: leaf[layer]
                               for name, leaf in pool.items()}
        x = _decode_layer(layer_params, x, cache_l, cur_len, config,
                          write_pos=write_pos, paged=paged, tp=tp)
    return cache, _final_logits(params, x, config)[:, 0]


def _decode_tokens(params, cache, logits0, prompt_lens, config, *,
                   max_new_tokens, sample, generator):
    """From a filled cache and the prefill logits to ``(tokens [B, N],
    num_generated [B])`` — eos included where sampled, pad after it."""
    b = logits0.shape[0]
    device = logits0.device
    track_seen = sample.repetition_penalty != 1.0
    need_min = sample.eos_id is not None and sample.min_new_tokens > 0
    allow0 = torch.zeros((b,), dtype=torch.bool, device=device) if need_min else None
    token = sample_logits(logits0, sample, generator=generator,
                          allow_eos=allow0).to(torch.int32)
    rows_b = torch.arange(b, device=device)
    seen = None
    if track_seen:
        seen = torch.zeros((b, config.vocab_size), dtype=torch.bool,
                           device=device)
        seen[rows_b, token.long()] = True
    cur_len = prompt_lens.to(torch.int32)
    post_eos = torch.zeros((b,), dtype=torch.bool, device=device)
    pad = torch.full((b,), sample.pad_id, dtype=torch.int32, device=device)
    emitted = []
    for i in range(max_new_tokens - 1):
        cache, logits = _decode_step(params, cache, token, cur_len, config)
        allow = (
            torch.full((b,), i + 1 >= sample.min_new_tokens, device=device)
            if need_min else None
        )
        next_tok = sample_logits(logits, sample, generator=generator,
                                 seen=seen, allow_eos=allow).to(torch.int32)
        done = post_eos
        if sample.eos_id is not None:
            done = post_eos | (token == sample.eos_id)
        next_tok = torch.where(done, pad, next_tok)
        if track_seen:
            seen[rows_b, next_tok.long()] = True
        cur_len = cur_len + torch.where(post_eos, 0, 1).to(torch.int32)
        emitted.append(torch.where(post_eos, pad, token))
        token, post_eos = next_tok, done
    emitted.append(torch.where(post_eos, pad, token))
    final_len = cur_len + torch.where(post_eos, 0, 1).to(torch.int32)
    return torch.stack(emitted, dim=1), final_len - prompt_lens.to(torch.int32)


def _check_inference_supported(config, rules, mesh, what: str):
    """The inference entry points' guard, as the JAX package's: a
    pipelined (pp) or zig-zag layout is training-only.  ``mesh`` None
    reads the installed global mesh."""
    mesh = mesh if mesh is not None else mesh_lib.get_global_mesh()
    if transformer._is_pipelined(config, rules, mesh):
        raise ValueError(
            f"{what} runs the scanned layer stack; pp pipelining is "
            "training-only (drop the layers->pp rule for inference)"
        )
    if (mesh is not None and config.zigzag_sp
            and mesh.axis_size(mesh_lib.AXIS_SP) > 1):
        raise ValueError(f"zigzag_sp is training-only; disable it for {what}")


def generate(params, prompt_tokens, prompt_lens, config, *,
             max_new_tokens: int,
             sample: SampleConfig = SampleConfig(temperature=0.0),
             generator: Optional[torch.Generator] = None,
             kv_quant: bool = False, device=None, rules=None,
             mesh=None) -> Dict[str, Any]:
    """Generate ``max_new_tokens`` continuations for a batch of prompts.

    ``prompt_tokens`` ``[B, T_prompt]`` left-aligned ids, ``prompt_lens``
    ``[B]`` true lengths (clamped to ``[1, T_prompt]``); ``generator``
    is required unless greedy; ``kv_quant`` stores the cache int8.
    Returns ``tokens [B, N]``, ``sequences
    [B, T_prompt + N]`` (prompt and generation stitched at each row's
    true length) and ``num_generated [B]`` (eos included), as int32
    tensors on ``device``.  ``rules`` and ``mesh`` (default: the
    installed global mesh) are checked as the JAX package checks them: a
    pipelined or zig-zag layout raises ``ValueError``.
    """
    _check_inference_supported(config, rules, mesh, "generation")
    device = resolve_device(device)
    if sample.temperature != 0.0 and generator is None:
        raise ValueError("non-greedy sampling needs a torch.Generator")
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    prompt_tokens = torch.as_tensor(prompt_tokens, device=device).to(torch.int32)
    b, t_prompt = prompt_tokens.shape
    prompt_lens = torch.as_tensor(prompt_lens, device=device).to(
        torch.int32).clamp(1, t_prompt)
    cols = torch.arange(t_prompt, device=device)[None, :]
    prompt_clean = torch.where(cols < prompt_lens[:, None], prompt_tokens,
                               sample.pad_id)
    if max_new_tokens == 0:
        return {"tokens": torch.zeros((b, 0), dtype=torch.int32, device=device),
                "sequences": prompt_clean,
                "num_generated": torch.zeros((b,), dtype=torch.int32,
                                             device=device)}
    with torch.no_grad():
        cache, logits0 = _prefill(params, prompt_tokens, prompt_lens, config,
                                  t_prompt + max_new_tokens,
                                  kv_quant=kv_quant)
        tokens, num_generated = _decode_tokens(
            params, cache, logits0, prompt_lens, config,
            max_new_tokens=max_new_tokens, sample=sample, generator=generator,
        )
    sequences = torch.cat([
        prompt_clean,
        torch.full((b, max_new_tokens), sample.pad_id, dtype=torch.int32,
                   device=device),
    ], dim=1)
    gen_cols = prompt_lens[:, None].long() + torch.arange(
        max_new_tokens, device=device)[None, :]
    rows = torch.arange(b, device=device)[:, None].expand_as(gen_cols)
    sequences[rows, gen_cols] = tokens
    return {"tokens": tokens, "sequences": sequences,
            "num_generated": num_generated}


def prefill_program(params, prompt_tokens, prompt_lens, config, *,
                    max_new_tokens: int, kv_quant: bool = False):
    """The batch scheduler's first half: prefill a padded prompt bucket
    ``[B, bucket_len]`` (flash attention) into a fresh cache of
    ``bucket_len + max_new_tokens`` positions.  Returns ``(cache,
    logits0)``; feed both to :func:`decode_program`."""
    with torch.no_grad():
        t_prompt = prompt_tokens.shape[1]
        device = prompt_tokens.device
        prompt_lens = torch.as_tensor(prompt_lens, device=device).to(
            torch.int32).clamp(1, t_prompt)
        return _prefill(params, prompt_tokens.to(torch.int32), prompt_lens,
                        config, t_prompt + max_new_tokens, kv_quant=kv_quant)


def decode_program(params, cache, logits0, prompt_lens, config, *,
                   max_new_tokens: int,
                   sample: SampleConfig = SampleConfig(temperature=0.0),
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
    """The batch scheduler's second half: decode ``max_new_tokens`` from
    a :func:`prefill_program` cache (``max_new_tokens - 1`` decode steps,
    each through the paged kernel).  Returns ``tokens [B, N]`` and
    ``num_generated [B]``."""
    with torch.no_grad():
        t_prompt = cache["k"].shape[2] - max_new_tokens
        prompt_lens = torch.as_tensor(prompt_lens, device=logits0.device).to(
            torch.int32).clamp(1, t_prompt)
        tokens, num_generated = _decode_tokens(
            params, cache, logits0, prompt_lens, config,
            max_new_tokens=max_new_tokens, sample=sample, generator=generator)
    return {"tokens": tokens, "num_generated": num_generated}


# --------------------------------------------------------------------------
# Continuous batching: the slot-grid programs.  A persistent grid of
# ``num_slots`` decode slots over a ``max_len`` KV cache; requests are
# prefilled into a free slot (:func:`insert_slot_program`) and every active
# slot advances ``chunk_size`` tokens per :func:`decode_chunk_program`.


def init_slot_cache(config, num_slots: int, max_len: int, *, device=None,
                    kv_quant: bool = False, tp=None):
    """The persistent decode grid: zeroed ``[L, num_slots, max_len, H,
    hd]`` K/V (int8 plus scales with ``kv_quant``), allocated once and
    updated in place by every program; the programs follow its type.
    Under ``tp`` the grid holds the rank's heads."""
    return _init_cache(config, num_slots, max_len, resolve_device(device),
                       kv_quant=kv_quant, tp=tp)


def init_slot_state(config, num_slots: int, *,
                    sample: SampleConfig = SampleConfig(temperature=0.0),
                    device=None):
    """Per-slot scheduler state: ``pos`` (filled KV length), ``tok`` (last
    sampled, unconsumed token), ``remaining``, ``emitted``, ``active``,
    plus ``seen`` ``[num_slots, vocab]`` under a repetition penalty."""
    device = resolve_device(device)

    def full(value, dtype):
        return torch.full((num_slots,), value, dtype=dtype, device=device)

    state = {
        "pos": full(0, torch.int32),
        "tok": full(sample.pad_id, torch.int32),
        "remaining": full(0, torch.int32),
        "emitted": full(0, torch.int32),
        "active": full(False, torch.bool),
    }
    if sample.repetition_penalty != 1.0:
        state["seen"] = torch.zeros((num_slots, config.vocab_size),
                                    dtype=torch.bool, device=device)
    return state


def insert_slot_program(params, cache, state, prompt_tokens, prompt_len,
                        slot: int, max_new_tokens: int, config, *,
                        sample: SampleConfig = SampleConfig(temperature=0.0),
                        generator: Optional[torch.Generator] = None):
    """Prefill one request (``prompt_tokens [1, bucket_len]``) into row
    ``slot`` of the grid: its k/v land in the slot's cache row (in place),
    its first token is sampled from the prefill logits, and the slot state
    is armed.  On a slice whose ``sp`` divides ``bucket_len`` the prefill
    runs split over ``sp`` (:func:`_split_prefill_forward`), else whole on
    every ``sp`` member.  Returns ``(cache, state, first_token)``."""
    with torch.no_grad():
        t_prompt = prompt_tokens.shape[1]
        prompt_len = max(1, min(int(prompt_len), t_prompt))
        device = cache["k"].device
        prompt_tokens = prompt_tokens.to(device=device, dtype=torch.int32)
        lens = torch.full((1,), prompt_len, dtype=torch.int32, device=device)
        k_pref, v_pref, logits0 = _prefill_forward(params, prompt_tokens,
                                                   lens, config)
        _write_prefill(cache, k_pref, v_pref, int(slot), config)
        state, tok0 = _arm_slot(state, logits0, prompt_len, int(slot),
                                max_new_tokens, config, sample=sample,
                                generator=generator)
    return cache, state, tok0


def _arm_slot(state, logits0, prompt_len: int, slot: int, max_new_tokens,
              config, *, sample: SampleConfig, generator):
    """Sample a just-prefilled slot's first token and write its state."""
    device = logits0.device
    need_min = sample.eos_id is not None and sample.min_new_tokens > 0
    allow0 = torch.zeros((1,), dtype=torch.bool, device=device) if need_min else None
    tok0 = sample_logits(logits0, sample, generator=generator,
                         allow_eos=allow0).to(torch.int32)[0]
    active0 = torch.tensor(int(max_new_tokens) > 1, device=device)
    if sample.eos_id is not None:
        active0 = active0 & (tok0 != sample.eos_id)
    state = dict(state)
    state["pos"] = state["pos"].clone()
    state["pos"][slot] = prompt_len
    state["tok"] = state["tok"].clone()
    state["tok"][slot] = tok0
    state["remaining"] = state["remaining"].clone()
    state["remaining"][slot] = int(max_new_tokens) - 1
    state["emitted"] = state["emitted"].clone()
    state["emitted"][slot] = 1
    state["active"] = state["active"].clone()
    state["active"][slot] = active0
    if "seen" in state:
        state["seen"] = state["seen"].clone()
        state["seen"][slot] = False
        state["seen"][slot, tok0.long()] = True
    return state, tok0


def decode_chunk_program(params, cache, state, config, *, chunk_size: int,
                         sample: SampleConfig = SampleConfig(temperature=0.0),
                         generator: Optional[torch.Generator] = None,
                         pool=None, block_table=None,
                         with_summary: bool = False):
    """Advance every active slot by up to ``chunk_size`` tokens.

    Each step consumes every slot's carried token at its own ``pos``,
    samples the next and emits it where the slot was active; a slot whose
    ``remaining`` hits zero or that samples eos deactivates mid-chunk.
    Inactive slots write nothing to the cache.  Returns ``(cache, state,
    tokens, valid)`` with ``[num_slots, chunk_size]`` emissions, plus a
    ``[emitted_count, active_count]`` int32 summary with
    ``with_summary``.  No host sync happens inside: the caller reads the
    results once per chunk.
    """
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    num_slots = state["tok"].shape[0]
    device = state["tok"].device
    track_seen = sample.repetition_penalty != 1.0
    need_min = sample.eos_id is not None and sample.min_new_tokens > 0
    rows = torch.arange(num_slots, device=device)
    s = cache["k"].shape[2]
    pad = torch.full((num_slots,), sample.pad_id, dtype=torch.int32,
                     device=device)
    toks, valids = [], []
    with torch.no_grad():
        for _ in range(chunk_size):
            active = state["active"]
            write_pos = torch.where(active, state["pos"], s)
            cache, logits = _decode_step(
                params, cache, state["tok"], state["pos"], config,
                write_pos=write_pos, pool=pool, block_table=block_table,
            )
            allow = state["emitted"] >= sample.min_new_tokens if need_min else None
            tok = sample_logits(logits, sample, generator=generator,
                                seen=state.get("seen"),
                                allow_eos=allow).to(torch.int32)
            tok = torch.where(active, tok, pad)
            stride = active.to(torch.int32)
            new_state = dict(state)
            new_state["pos"] = state["pos"] + stride
            new_state["remaining"] = state["remaining"] - stride
            new_state["emitted"] = state["emitted"] + stride
            finished = new_state["remaining"] <= 0
            if sample.eos_id is not None:
                finished = finished | (tok == sample.eos_id)
            new_state["active"] = active & ~finished
            new_state["tok"] = torch.where(active, tok, state["tok"])
            if track_seen:
                new_state["seen"] = state["seen"].clone()
                new_state["seen"][rows, tok.long()] = True
            state = new_state
            toks.append(tok)
            valids.append(active)
    toks = torch.stack(toks, dim=1)
    valid = torch.stack(valids, dim=1)
    if with_summary:
        summary = torch.stack([valid.sum(), state["active"].sum()]).to(
            torch.int32)
        return cache, state, toks, valid, summary
    return cache, state, toks, valid


# --------------------------------------------------------------------------
# Prefix caching and chunked prefill.  A prompt's K/V at positions [0, n)
# depend only on its tokens there, so requests that share a prefix can share
# its K/V: the engine keeps a pool of K/V blocks (:func:`init_prefix_pool`)
# keyed on the host by token prefixes (``serving/prefix_cache.py``), copies
# the longest cached prefix into a slot row (:func:`copy_prefix_program`)
# or hands its blocks to the paged kernel through the block table, prefills
# only the rest in bounded chunks (:func:`prefill_chunk_program`), arms the
# slot from the last chunk's logits (:func:`finalize_slot_program`) and
# saves the prompt's new full blocks to the pool
# (:func:`save_prefix_program`).  Every program updates the cache or pool it
# is given in place and returns it.


def init_prefix_pool(config, num_blocks: int, block_tokens: int, *,
                     device=None, kv_quant: bool = False, tp=None):
    """The shared-prefix block pool: a zeroed cache of ``[L, num_blocks,
    block_tokens, H, hd]`` leaves, the slot cache's structure (int8 plus
    scales with ``kv_quant``; the rank's heads under ``tp``)."""
    return _init_cache(config, num_blocks, block_tokens,
                       resolve_device(device), kv_quant=kv_quant, tp=tp)


def copy_prefix_program(cache, pool, block_ids, slot: int):
    """Copy pool blocks into the head of row ``slot``: block ``i`` lands at
    positions ``[i * bt, (i + 1) * bt)``.  Ids out of range are clipped
    (padding past a hit; the bytes it copies are overwritten by the
    suffix prefill or masked)."""
    with torch.no_grad():
        for name, leaf in cache.items():
            pool_leaf = pool[name]
            nb, bt = pool_leaf.shape[1:3]
            ids = torch.as_tensor(block_ids, dtype=torch.long).clamp(
                0, nb - 1).to(pool_leaf.device)
            gathered = pool_leaf.index_select(1, ids)  # [L, n, bt, H, w]
            l, n = gathered.shape[:2]
            leaf[:, int(slot), :n * bt] = gathered.reshape(
                l, n * bt, *gathered.shape[3:])
    return cache


def save_prefix_program(pool, cache, slot: int, block_ids):
    """The reverse copy: positions ``[i * bt, (i + 1) * bt)`` of row
    ``slot`` into pool block ``block_ids[i]``.  An id out of range (the
    ``SKIP_BLOCK`` sentinel) skips its block, so cached blocks are never
    rewritten."""
    with torch.no_grad():
        ids = torch.as_tensor(block_ids, dtype=torch.long)
        for name, pool_leaf in pool.items():
            nb, bt = pool_leaf.shape[1:3]
            keep = torch.nonzero((ids >= 0) & (ids < nb))[:, 0]
            if keep.numel() == 0:
                continue
            leaf = cache[name]
            n = ids.shape[0]
            blocks = leaf[:, int(slot), :n * bt].reshape(
                leaf.shape[0], n, bt, *leaf.shape[3:])
            dev = pool_leaf.device
            pool_leaf[:, ids[keep].to(dev)] = blocks[:, keep.to(dev)]
    return pool


def _host_buffer(like, shape):
    """An empty host tensor for a device-to-host copy: pinned when the
    source is on the card, so the copy runs on the stream without
    blocking the host."""
    return torch.empty(shape, dtype=like.dtype,
                       pin_memory=like.device.type == "cuda")


def _device_ids(ids: torch.Tensor, device) -> torch.Tensor:
    """Host ids on ``device``: on the card through pinned memory, in
    stream order (a pageable copy would synchronise the stream)."""
    if device.type == "cuda":
        return ids.pin_memory().to(device, non_blocking=True)
    return ids


def download_prefix_blocks(pool, blocks, *, tp=None):
    """Pool rows ``blocks [N]`` as host tensors ``[N, L, bt, H, hd]`` per
    leaf (scales too for an int8 pool), copied on the current stream into
    pinned memory: the caller synchronises before it reads them.  Ids
    out of range are clipped.  Exactly the rows asked for are gathered
    (the reference pads a batch to one compiled shape; eager PyTorch has
    no such need).  Under ``tp`` (a pool of the rank's heads) every
    member's heads are gathered in head order first (a collective call):
    the rows hold every head, as one card's do."""
    with torch.no_grad():
        out = {}
        for name, leaf in pool.items():
            ids = _device_ids(torch.as_tensor(blocks, dtype=torch.long).clamp(
                0, leaf.shape[1] - 1), leaf.device)
            rows = leaf.index_select(1, ids).transpose(0, 1)
            if tp is not None and tp.size > 1:
                rows = collectives.all_gather(rows, tp.axis, gather_dim=3,
                                              mesh=tp.mesh)
            host = _host_buffer(leaf, rows.shape)
            host.copy_(rows, non_blocking=host.is_pinned())
            out[name] = host
    return out


def download_prefix_block(pool, block: int):
    """One pool row as host tensors ``[L, bt, H, hd]`` per leaf (see
    :func:`download_prefix_blocks`): the payload of a block the host
    tier demotes."""
    return {name: leaf[0] for name, leaf in
            download_prefix_blocks(pool, [int(block)]).items()}


def upload_prefix_blocks(pool, payloads, blocks, *, tp=None):
    """Write host payloads (leaves ``[N, L, bt, H, hd]``) into pool rows
    ``blocks [N]``, on the current stream; an id out of range is dropped.
    Rows in pinned memory (when every id is kept) reach the card in
    stream order.  Under ``tp`` the payloads hold every head and the
    rank writes its own.  Returns the pool."""
    with torch.no_grad():
        ids = torch.as_tensor(blocks, dtype=torch.long)
        for name, leaf in pool.items():
            keep = torch.nonzero((ids >= 0) & (ids < leaf.shape[1]))[:, 0]
            if keep.numel() == 0:
                continue
            rows = torch.as_tensor(payloads[name])
            if tp is not None and tp.size > 1:
                heads = leaf.shape[3]
                rows = rows[:, :, :, tp.index * heads:(tp.index + 1) * heads]
            if keep.numel() != ids.numel():
                rows = rows[keep]
            rows = rows.to(leaf.device, non_blocking=True)
            leaf[:, _device_ids(ids[keep], leaf.device)] = rows.to(
                leaf.dtype).transpose(0, 1)
    return pool


def upload_prefix_block(pool, payload, block: int):
    """Write one demoted block's payload (leaves ``[L, bt, H, hd]``) back
    into pool row ``block`` (a swap-in).  Returns the pool."""
    with torch.no_grad():
        for name, leaf in pool.items():
            leaf[:, int(block)].copy_(payload[name], non_blocking=True)
    return pool


def prefill_chunk_program(params, cache, chunk_tokens, start: int,
                          chunk_len: int, slot: int, config, *, pool=None,
                          block_table=None):
    """Prefill one bounded chunk of a prompt into row ``slot``:
    ``chunk_tokens [1, c]`` covers prompt positions ``[start, start +
    chunk_len)`` (padded to ``c``).  Each layer writes the chunk's K/V into
    the row (positions past the row are dropped), then attends
    chunk-causally over it through the paged kernel with ``Tq = c``:
    query ``t`` sees keys below ``start + 1 + t``, the filled prefix (a
    copied hit, earlier chunks) and the chunk itself.  With
    ``block_table`` and ``pool`` the row's leading pages read pool blocks
    in place (an attached hit).  Returns ``(cache, logits [1, V])``, the
    logits at the chunk's last real token."""
    with torch.no_grad():
        device = cache["k"].device
        chunk_tokens = torch.as_tensor(chunk_tokens).to(device=device,
                                                        dtype=torch.int32)
        c = chunk_tokens.shape[1]
        start, slot = int(start), int(slot)
        s = cache["k"].shape[2]
        end = min(start + c, s)
        positions = (start + torch.arange(c, device=device))[None, :]
        cur_len = torch.full((1,), start + 1, dtype=torch.int32,
                             device=device)
        table_row = (None if block_table is None
                     else block_table[slot:slot + 1])
        quantized = "k_scale" in cache
        tp = params.get("tp")
        x = layers.embedding_apply(params["embed"], chunk_tokens,
                                   dtype=config.dtype, tp=tp)
        x = x * math.sqrt(config.dim)
        for layer, layer_params in enumerate(params["layers"]):
            y = layers.rmsnorm_apply(layer_params["ln1"], x)
            q, k_new, v_new = transformer.qkv_project(
                layer_params["att"], y, positions, config)
            updates = _kv_leaf_updates(k_new[0], v_new[0], config, quantized)
            for name, value in updates.items():
                cache[name][layer, slot, start:end] = value[:end - start]
            row = {name: leaf[layer, slot:slot + 1]
                   for name, leaf in cache.items()}
            pool_l = (None if pool is None or table_row is None
                      else {name: leaf[layer] for name, leaf in pool.items()})
            attended = paged_lib.paged_chunk_attention(
                q, row, cur_len, pool_l=pool_l, block_table=table_row)
            x = x + layers.row_parallel_dense(layer_params["att"]["out"],
                                              attended.reshape(1, c, -1), tp)
            y = layers.rmsnorm_apply(layer_params["ln2"], x)
            x = x + _mlp(layer_params, y, config, tp)
        last = min(max(int(chunk_len) - 1, 0), c - 1)
        logits = _final_logits(params, x[:, last:last + 1], config)[:, 0]
    return cache, logits


def finalize_slot_program(state, logits0, prompt_len: int, slot: int,
                          max_new_tokens: int, config, *,
                          sample: SampleConfig = SampleConfig(temperature=0.0),
                          generator: Optional[torch.Generator] = None):
    """Arm row ``slot`` from a chunked prefill's last logits, exactly as
    :func:`insert_slot_program` arms it after its one-shot prefill.
    Returns ``(state, first_token)``."""
    with torch.no_grad():
        return _arm_slot(state, logits0, int(prompt_len), int(slot),
                         max_new_tokens, config, sample=sample,
                         generator=generator)


# --------------------------------------------------------------------------
# Speculative decoding: draft and verify on the slot grid.  A small draft
# model proposes a ``spec_k``-token window per active slot over its own slot
# cache (:func:`draft_chunk_program`); the target scores every window
# position in one forward, K8 at Tq = ``spec_k`` (:func:`verify_chunk_program`),
# and commits the prefix the draft got right plus the target's own token
# at the first miss.  Every committed token is the target's argmax, so the
# output is token-identical to plain greedy decoding.


def _write_window(leaf, rows, positions, active, values):
    """``leaf[row, positions[row, t]] = values[row, t]`` in place for the
    active rows, dropping positions out of ``[0, S)`` (JAX's drop-mode
    scatter), without a host sync.  A dropped write rewrites the row's
    current value at ``positions[row, 0] - 1``, which no kept write of the
    row touches, so no index takes two different values."""
    s = leaf.shape[1]
    keep = active[:, None] & (positions >= 0) & (positions < s)
    spare = (positions[:, :1] - 1).clamp(0, s - 1)
    idx = torch.where(keep, positions, spare).long()
    row_idx = rows[:, None].expand_as(idx)
    old = leaf[row_idx, idx]
    mask = keep.reshape(*keep.shape, *([1] * (values.dim() - 2)))
    leaf[row_idx, idx] = torch.where(mask, values.to(leaf.dtype), old)


def draft_chunk_program(params, cache, state, config, *, spec_k: int):
    """Propose a ``spec_k``-token verify window for every slot with the
    draft model: ``spec_k`` greedy single-token steps over the draft's own
    slot cache (``_decode_step``, K8 at Tq 1).  Returns ``(cache,
    window)`` with ``window [num_slots, spec_k]``: column 0 is each slot's
    carried token (``state["tok"]``), the rest the draft's proposals.
    Each step writes its token's K/V into the draft cache (inactive slots
    write nothing), so after a verify commits a prefix the draft cache
    already holds every committed position; the last step's proposal is
    dropped (that step exists to write the last window token's K/V).
    ``state`` is read only: the verify owns every state transition."""
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    s = cache["k"].shape[2]
    active = state["active"]
    tok, pos = state["tok"], state["pos"]
    consumed = []
    with torch.no_grad():
        for _ in range(spec_k):
            write_pos = torch.where(active, pos, s)
            cache, logits = _decode_step(params, cache, tok, pos, config,
                                         write_pos=write_pos)
            consumed.append(tok)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            pos = pos + 1
    return cache, torch.stack(consumed, dim=1)


def verify_chunk_program(params, cache, state, window, config, *,
                         sample: SampleConfig = SampleConfig(temperature=0.0),
                         pool=None, block_table=None,
                         with_summary: bool = False):
    """Score a draft window for every slot in one target forward and
    commit the accepted prefix.

    ``window [num_slots, spec_k]`` is what :func:`draft_chunk_program`
    returns.  Each layer writes the window's K/V at positions ``pos ..
    pos + spec_k - 1`` of each active slot and attends chunk-causally over
    the row through the paged kernel (``paged_verify_attention``, K8 or
    K8q at Tq = ``spec_k``; with ``block_table`` and ``pool``, attached
    prefix pages read pool blocks), so the logits after window position
    ``i`` are those of consuming ``window[:, :i + 1]`` one token at a
    time.  The target's greedy tokens ``g`` gate acceptance: draft token
    ``window[:, i]`` is accepted while it equals ``g[:, i - 1]``, and the
    committed emissions are ``g_0 .. g_a``, at least one per active slot.
    Emissions stop at eos and at the slot's ``remaining`` budget as in
    :func:`decode_chunk_program`; ``pos`` advances by the commit count,
    which is the rewind: rows written past it are masked and overwritten
    by the next window.  Greedy only (``temperature`` 0, no repetition
    penalty).  Returns ``(cache, state, tokens, valid)`` shaped as
    :func:`decode_chunk_program`'s, plus its ``[emitted_count,
    active_count]`` summary with ``with_summary``.
    """
    if sample.temperature != 0.0 or sample.repetition_penalty != 1.0:
        raise ValueError(
            "speculative decoding requires greedy sampling "
            "(temperature=0, repetition_penalty=1); token-identical "
            "non-greedy speculation needs rejection resampling"
        )
    with torch.no_grad():
        num_slots, k = window.shape
        device = window.device
        window = window.to(torch.int32)
        active, pos = state["active"], state["pos"]
        rows = torch.arange(num_slots, device=device)
        steps = torch.arange(k, device=device)
        positions = pos[:, None] + steps[None, :]  # [slots, k]
        quantized = "k_scale" in cache
        tp = params.get("tp")
        x = layers.embedding_apply(params["embed"], window, dtype=config.dtype,
                                   tp=tp)
        x = x * math.sqrt(config.dim)
        for layer, layer_params in enumerate(params["layers"]):
            y = layers.rmsnorm_apply(layer_params["ln1"], x)
            q, k_new, v_new = transformer.qkv_project(layer_params["att"], y,
                                                      positions, config)
            cache_l = {name: leaf[layer] for name, leaf in cache.items()}
            for name, value in _kv_leaf_updates(k_new, v_new, config,
                                                quantized).items():
                _write_window(cache_l[name], rows, positions, active, value)
            pool_l = (None if pool is None or block_table is None
                      else {name: leaf[layer] for name, leaf in pool.items()})
            attended = paged_lib.paged_verify_attention(
                q, cache_l, pos + 1, pool_l=pool_l, block_table=block_table)
            x = x + layers.row_parallel_dense(
                layer_params["att"]["out"],
                attended.reshape(num_slots, k, -1), tp)
            y = layers.rmsnorm_apply(layer_params["ln2"], x)
            x = x + _mlp(layer_params, y, config, tp)
        logits = _final_logits(params, x, config)  # [slots, k, V]

        # Greedy emission per window position, with the sequential path's
        # eos gate: emission i is sampled when the slot has emitted
        # ``emitted + i`` tokens.
        allow = None
        if sample.eos_id is not None and sample.min_new_tokens > 0:
            allow = (state["emitted"][:, None] + steps[None, :]
                     >= sample.min_new_tokens).reshape(-1)
        g = sample_logits(logits.reshape(num_slots * k, -1), sample,
                          allow_eos=allow).to(torch.int32).reshape(
                              num_slots, k)
        # Emission i commits iff every draft token before it matched the
        # target's choice, within the budget, up to and including an eos.
        emit_ok = torch.ones((num_slots, k), dtype=torch.bool, device=device)
        if k > 1:
            match = (window[:, 1:] == g[:, :-1]).to(torch.int32)
            emit_ok[:, 1:] = torch.cumprod(match, dim=1).bool()
        emit_ok &= steps[None, :] < state["remaining"][:, None]
        if sample.eos_id is not None:
            is_eos = (g == sample.eos_id).to(torch.int32)
            emit_ok &= (torch.cumsum(is_eos, dim=1) - is_eos) == 0
        emit_ok &= active[:, None]
        valid = torch.cumprod(emit_ok.to(torch.int32), dim=1).bool()

        toks = torch.where(valid, g, sample.pad_id).to(torch.int32)
        n = valid.sum(dim=1).to(torch.int32)  # commit count; 0 if inactive
        last_tok = torch.gather(toks, 1,
                                (n - 1).clamp(min=0)[:, None].long())[:, 0]
        new_state = dict(state)
        new_state["pos"] = pos + n
        new_state["remaining"] = state["remaining"] - n
        new_state["emitted"] = state["emitted"] + n
        finished = new_state["remaining"] <= 0
        if sample.eos_id is not None:
            finished = finished | ((n > 0) & (last_tok == sample.eos_id))
        new_state["active"] = active & ~finished
        new_state["tok"] = torch.where(n > 0, last_tok, state["tok"])
    if with_summary:
        summary = torch.stack([valid.sum(), new_state["active"].sum()]).to(
            torch.int32)
        return cache, new_state, toks, valid, summary
    return cache, new_state, toks, valid


def draft_prefill_slot_program(params, cache, prompt_tokens, prompt_len,
                               slot: int, config):
    """Prefill one request's prompt (``[1, bucket_len]``) into row ``slot``
    of the draft model's cache: :func:`insert_slot_program` without the
    sampling (the first token comes from the target).  Always a one-shot
    flash-attention prefill of the whole prompt (split over ``sp`` as
    :func:`insert_slot_program`'s, for a head-sharded draft), whatever the
    target side did (a prefix hit, chunks).  Returns the cache."""
    with torch.no_grad():
        t_prompt = prompt_tokens.shape[1]
        prompt_len = max(1, min(int(prompt_len), t_prompt))
        device = cache["k"].device
        prompt_tokens = prompt_tokens.to(device=device, dtype=torch.int32)
        lens = torch.full((1,), prompt_len, dtype=torch.int32, device=device)
        k_pref, v_pref, _ = _prefill_forward(params, prompt_tokens, lens,
                                             config)
        return _write_prefill(cache, k_pref, v_pref, int(slot), config)


# --------------------------------------------------------------------------
# Beam search.


def _top_k(x, k: int):
    """``jax.lax.top_k``: the ``k`` largest along the last axis, in
    descending order, ties broken towards the lower index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def beam_search(params, prompt_tokens, prompt_lens, config, *,
                num_beams: int, max_new_tokens: int,
                length_penalty: float = 1.0, eos_id: Optional[int] = None,
                pad_id: int = 0, kv_quant: bool = False,
                device=None, rules=None, mesh=None) -> Dict[str, Any]:
    """Beam decoding: the highest-scoring continuation per prompt.

    Prefill runs once per prompt; the cache is tiled to ``B * K`` rows
    (beam-major within each prompt) and reordered along the beam
    dimension, in place and scales included, after every step.  Two
    hypothesis sets, as in the JAX package: live beams advance at raw
    summed log-prob; a beam that samples ``eos_id`` moves to a finished
    set scored ``sum_logprob / num_tokens ** length_penalty``.  Each step
    expands ``2K`` candidates so the live set stays full when ``K`` of
    them finish at once; the answer is the best penalized hypothesis of
    both sets.

    Returns ``tokens [B, max_new_tokens]`` (the best hypothesis, pad after
    eos), ``scores [B]`` (its length-penalized log-prob) and
    ``num_generated [B]`` (eos included), on ``device``.  ``rules`` and
    ``mesh`` are checked as in :func:`generate`.
    """
    _check_inference_supported(config, rules, mesh, "beam_search")
    device = resolve_device(device)
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    if max_new_tokens < 1:
        raise ValueError("beam_search needs max_new_tokens >= 1")
    prompt_tokens = torch.as_tensor(prompt_tokens, device=device).to(
        torch.int32)
    b, t_prompt = prompt_tokens.shape
    k = num_beams
    vocab = config.vocab_size
    prompt_lens = torch.as_tensor(prompt_lens, device=device).to(
        torch.int32).clamp(1, t_prompt)
    neg_inf = torch.tensor(NEG_INF, dtype=torch.float32, device=device)

    def penalize(sum_logprob, n):
        return sum_logprob / torch.clamp(n.float(), min=1.0) ** length_penalty

    def take(x, idx):  # take_along_axis on dim 1, trailing dims kept
        return torch.gather(
            x, 1, idx.reshape(*idx.shape, *([1] * (x.dim() - 2))).expand(
                *idx.shape, *x.shape[2:]))

    with torch.no_grad():
        cache, logits0 = _prefill(params, prompt_tokens, prompt_lens, config,
                                  t_prompt + max_new_tokens,
                                  kv_quant=kv_quant)
        cache = {name: leaf.repeat_interleave(k, dim=1)
                 for name, leaf in cache.items()}  # [L, B*K, S, H, ...]
        cur_len = prompt_lens.repeat_interleave(k)

        scores_l, tok0 = _top_k(torch.log_softmax(logits0, dim=-1), k)
        token = tok0.to(torch.int32)
        hist_l = torch.full((b, k, max_new_tokens), pad_id, dtype=torch.int32,
                            device=device)
        hist_l[:, :, 0] = token
        n_l = torch.ones((b, k), dtype=torch.int32, device=device)
        hist_f = torch.full_like(hist_l, pad_id)
        scores_f = neg_inf.expand(b, k).clone()
        n_f = torch.zeros_like(n_l)
        if eos_id is not None:
            seed_eos = token == eos_id
            scores_f = torch.where(seed_eos, penalize(scores_l, n_l),
                                   scores_f)
            hist_f = torch.where(seed_eos[:, :, None], hist_l, hist_f)
            n_f = torch.where(seed_eos, n_l, n_f)
            scores_l = torch.where(seed_eos, neg_inf, scores_l)

        rows = torch.arange(b, device=device)[:, None] * k
        for i in range(max_new_tokens - 1):
            cache, step_logits = _decode_step(
                params, cache, token.reshape(b * k), cur_len, config)
            logprobs = torch.log_softmax(step_logits, dim=-1).reshape(
                b, k, vocab)
            total = scores_l[:, :, None] + logprobs  # [B, K, V]
            cand_scores, flat_idx = _top_k(total.reshape(b, k * vocab),
                                           2 * k)
            cand_parent = flat_idx // vocab  # [B, 2K]
            cand_tok = (flat_idx % vocab).to(torch.int32)
            cand_hist = take(hist_l, cand_parent).clone()
            cand_hist[:, :, i + 1] = cand_tok
            cand_n = torch.gather(n_l, 1, cand_parent) + 1
            if eos_id is not None:
                cand_eos = cand_tok == eos_id
                merged_scores = torch.cat([
                    scores_f,
                    torch.where(cand_eos, penalize(cand_scores, cand_n),
                                neg_inf),
                ], dim=1)  # [B, K + 2K]
                scores_f, f_idx = _top_k(merged_scores, k)
                hist_f = take(torch.cat([hist_f, cand_hist], dim=1), f_idx)
                n_f = torch.gather(torch.cat([n_f, cand_n], dim=1), 1, f_idx)
                cand_scores = torch.where(cand_eos, neg_inf, cand_scores)
            scores_l, l_idx = _top_k(cand_scores, k)  # [B, K]
            token = torch.gather(cand_tok, 1, l_idx)
            hist_l = take(cand_hist, l_idx)
            n_l = torch.gather(cand_n, 1, l_idx)
            flat_parent = (rows + torch.gather(cand_parent, 1, l_idx)
                           ).reshape(b * k)
            for leaf in cache.values():
                leaf.copy_(leaf.index_select(1, flat_parent))
            cur_len = cur_len[flat_parent] + 1

        all_scores = torch.cat([scores_f, penalize(scores_l, n_l)], dim=1)
        all_hist = torch.cat([hist_f, hist_l], dim=1)
        all_n = torch.cat([n_f, n_l], dim=1)
        best = torch.argmax(all_scores, dim=-1)[:, None]  # [B, 1]
    return {"tokens": take(all_hist, best)[:, 0],
            "scores": torch.gather(all_scores, 1, best)[:, 0],
            "num_generated": torch.gather(all_n, 1, best)[:, 0]}
