"""Autoregressive generation for CloudLM (port of ``cloud_tpu/models/generation.py``).

Prefill runs the prompt through every layer with the flash-attention
kernel and writes each layer's K/V into a ``[L, B, S, H, hd]`` cache;
decode appends one position per step and attends through the paged
kernel (``ops/paged_attention``).  The JAX package's single ``lax.scan``
becomes a Python loop over steps and layers, and its immutable cache
threaded through the scan becomes one cache updated in place: every
writer here stores into the cache tensors it was given and returns them.

The slot-grid programs (:func:`insert_slot_program`,
:func:`decode_chunk_program`) are the continuous-batching engine's
device work.  Greedy outputs are token-identical to :func:`generate`.

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
from cloud_tpu_torch.models import layers, transformer
from cloud_tpu_torch.ops import flash_attention as flash_lib
from cloud_tpu_torch.ops import paged_attention as paged_lib

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


def _check_kv_quant(kv_quant: bool) -> None:
    if kv_quant:
        raise NotImplementedError(
            "kv_quant (int8 KV cache) comes with the kv_quant slice of the "
            "port (ROADMAP.md)"
        )


def _init_cache(config, b: int, s: int, device, kv_quant: bool = False):
    """Zeroed KV cache ``{"k", "v"}`` of ``[L, B, S, H, hd]``."""
    _check_kv_quant(kv_quant)
    shape = (config.num_layers, b, s, config.num_heads, config.head_dim)
    return {"k": torch.zeros(shape, dtype=config.dtype, device=device),
            "v": torch.zeros(shape, dtype=config.dtype, device=device)}


def _cache_attention(q, cache_l, cur_len, *, chunk_causal: bool = False):
    """Plain attention of ``q [B, Tq, H, hd]`` over a layer cache
    ``[B, S, H, hd]``: key j of row i is valid iff ``j < cur_len[i]``
    (``+ t`` for query t with ``chunk_causal``).  CPU tensors only: on
    the card every cache read goes through the paged kernel."""
    if q.device.type != "cpu":
        raise RuntimeError(
            "_cache_attention is the plain CPU version; CUDA tensors read "
            "the cache through ops.paged_attention"
        )
    k_cache, v_cache = cache_l["k"], cache_l["v"]
    s = k_cache.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_cache.float()) * scale
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
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v_cache.float())
    return out.to(q.dtype)


def prepare_params(params, config):
    """The params with every layer matrix stored once in the compute dtype
    (``dense_apply`` would cast it on every call; the numbers are the
    same).  Norm scales, the embedding and the head keep their type."""
    def cast(dense):
        return {k: v.to(config.dtype) for k, v in dense.items()}

    out = dict(params)
    out["layers"] = [
        dict(layer,
             att={k: cast(v) for k, v in layer["att"].items()},
             mlp={k: cast(v) for k, v in layer["mlp"].items()})
        for layer in params["layers"]
    ]
    return out


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
                  paged=None):
    """One block on a single-token slice ``x [B, 1, D]``: writes this
    step's k/v at ``cur_len`` (or ``write_pos``; out-of-range suppresses
    the row's write) into the cache in place, then attends over the valid
    prefix through the paged kernel."""
    b = x.shape[0]
    y = layers.rmsnorm_apply(layer_params["ln1"], x)
    q, k_new, v_new = transformer.qkv_project(
        layer_params["att"], y, cur_len[:, None], config
    )
    rows = torch.arange(b, device=x.device)
    wp = cur_len if write_pos is None else write_pos
    _write_rows(cache_l["k"], rows, wp, k_new[:, 0])
    _write_rows(cache_l["v"], rows, wp, v_new[:, 0])
    paged = paged or {}
    attended = paged_lib.paged_decode_attention(
        q, cache_l, cur_len + 1, pool_l=paged.get("pool_l"),
        block_table=paged.get("block_table"),
    )
    x = x + layers.dense_apply(layer_params["att"]["out"],
                               attended.reshape(b, 1, -1))
    y = layers.rmsnorm_apply(layer_params["ln2"], x)
    return x + layers.mlp_block_apply(layer_params["mlp"], y)


def _prefill_layer(layer_params, x, positions, prompt_mask, config):
    """One block on the prompt buffer ``[B, T, D]``: causal flash
    attention with the padding mask key-side; returns the block's k/v."""
    b, t, _ = x.shape
    y = layers.rmsnorm_apply(layer_params["ln1"], x)
    q, k, v = transformer.qkv_project(layer_params["att"], y, positions,
                                      config)
    attended = flash_lib.flash_attention(q, k, v, causal=True,
                                         mask=prompt_mask)
    x = x + layers.dense_apply(layer_params["att"]["out"],
                               attended.reshape(b, t, -1))
    y = layers.rmsnorm_apply(layer_params["ln2"], x)
    return x + layers.mlp_block_apply(layer_params["mlp"], y), k, v


def _final_logits(params, x, config):
    x = layers.rmsnorm_apply(params["ln_f"], x)
    return transformer.lm_logits(params, x, config)


def _prefill_forward(params, prompt_tokens, prompt_lens, config):
    """The prompt forward pass: per-layer k/v lists (each ``[B, T, H,
    hd]``) and the next-token logits ``[B, V]`` at each row's last real
    prompt position."""
    b, t_prompt = prompt_tokens.shape
    device = prompt_tokens.device
    positions = torch.arange(t_prompt, device=device).expand(b, t_prompt)
    prompt_mask = (positions < prompt_lens[:, None]).to(torch.int32)
    x = layers.embedding_apply(params["embed"], prompt_tokens,
                               dtype=config.dtype)
    x = x * math.sqrt(config.dim)
    ks, vs = [], []
    for layer_params in params["layers"]:
        x, k, v = _prefill_layer(layer_params, x, positions, prompt_mask,
                                 config)
        ks.append(k)
        vs.append(v)
    last_x = x[torch.arange(b, device=device), prompt_lens.long() - 1]
    logits0 = _final_logits(params, last_x[:, None], config)[:, 0]
    return ks, vs, logits0


def _write_prefill(cache, k_pref, v_pref, row0: int, config):
    """Store a prefill's per-layer k/v into ``cache`` rows ``[row0,
    row0 + B)`` at positions ``[0, T)``, in place."""
    for layer, (k, v) in enumerate(zip(k_pref, v_pref)):
        b, t = k.shape[:2]
        cache["k"][layer, row0:row0 + b, :t] = k.to(config.dtype)
        cache["v"][layer, row0:row0 + b, :t] = v.to(config.dtype)
    return cache


def _prefill(params, prompt_tokens, prompt_lens, config, s):
    b = prompt_tokens.shape[0]
    cache = _init_cache(config, b, s, prompt_tokens.device)
    k_pref, v_pref, logits0 = _prefill_forward(params, prompt_tokens,
                                               prompt_lens, config)
    return _write_prefill(cache, k_pref, v_pref, 0, config), logits0


def _decode_step(params, cache, token, cur_len, config, write_pos=None,
                 pool=None, block_table=None):
    """One single-token step for every row: embed ``token [B]``, run the
    layers against the cache (k/v written in place), return the cache and
    the next-token logits ``[B, V]``."""
    x = layers.embedding_apply(params["embed"], token[:, None],
                               dtype=config.dtype)
    x = x * math.sqrt(config.dim)
    for layer, layer_params in enumerate(params["layers"]):
        cache_l = {"k": cache["k"][layer], "v": cache["v"][layer]}
        paged = {"block_table": block_table}
        if pool is not None:
            paged["pool_l"] = {"k": pool["k"][layer], "v": pool["v"][layer]}
        x = _decode_layer(layer_params, x, cache_l, cur_len, config,
                          write_pos=write_pos, paged=paged)
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


def generate(params, prompt_tokens, prompt_lens, config, *,
             max_new_tokens: int,
             sample: SampleConfig = SampleConfig(temperature=0.0),
             generator: Optional[torch.Generator] = None,
             kv_quant: bool = False, device=None) -> Dict[str, Any]:
    """Generate ``max_new_tokens`` continuations for a batch of prompts.

    ``prompt_tokens`` ``[B, T_prompt]`` left-aligned ids, ``prompt_lens``
    ``[B]`` true lengths (clamped to ``[1, T_prompt]``); ``generator``
    is required unless greedy.  Returns ``tokens [B, N]``, ``sequences
    [B, T_prompt + N]`` (prompt and generation stitched at each row's
    true length) and ``num_generated [B]`` (eos included), as int32
    tensors on ``device``.
    """
    transformer.check_supported(config)
    _check_kv_quant(kv_quant)
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
                                  t_prompt + max_new_tokens)
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


# --------------------------------------------------------------------------
# Continuous batching: the slot-grid programs.  A persistent grid of
# ``num_slots`` decode slots over a ``max_len`` KV cache; requests are
# prefilled into a free slot (:func:`insert_slot_program`) and every active
# slot advances ``chunk_size`` tokens per :func:`decode_chunk_program`.


def init_slot_cache(config, num_slots: int, max_len: int, *, device=None,
                    kv_quant: bool = False):
    """The persistent decode grid: zeroed ``[L, num_slots, max_len, H,
    hd]`` K/V, allocated once and updated in place by every program."""
    return _init_cache(config, num_slots, max_len, resolve_device(device),
                       kv_quant=kv_quant)


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
    is armed.  Returns ``(cache, state, first_token)``."""
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
