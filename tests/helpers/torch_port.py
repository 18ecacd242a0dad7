"""Shared rig for the PyTorch port's parity tests (``tests/test_torch_*.py``).

The JAX package's own ``init`` makes the weights; ``cloud_tpu_torch.bridge``
carries them across, so both sides compute with the same numbers.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cloud_tpu.models import bert as jax_bert
from cloud_tpu.models import generation as jax_gen
from cloud_tpu.models import quantization as jax_quant
from cloud_tpu.models import resnet as jax_resnet
from cloud_tpu.models import transformer as jax_tf
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import bert, resnet, transformer

#: Smallest top-2 logit gap along a greedy path for it to count as
#: tie-free: below it, f32 summation order alone could flip an argmax.
TIE_GAP = 1e-3


def port_config(jax_cfg, dtype=torch.float32):
    fields = ("vocab_size", "num_layers", "dim", "num_heads", "head_dim",
              "mlp_hidden", "max_seq_len", "rope_base", "tied_embeddings",
              "remat", "remat_policy", "fused_ce")
    return transformer.TransformerConfig(
        dtype=dtype, **{f: getattr(jax_cfg, f) for f in fields})


def tiny_models(seed=0, num_layers=2, quantized=False):
    """(jax_cfg, jax_params, port_cfg, port_params): TINY in f32; with
    ``quantized``, the JAX ``quantize_params`` tree on both sides."""
    jax_cfg = jax_tf.TINY.scaled(dtype=jnp.float32, num_layers=num_layers)
    params = jax_tf.init(jax.random.PRNGKey(seed), jax_cfg)
    if quantized:
        params = jax_quant.quantize_params(params)
    cfg = port_config(jax_cfg)
    return jax_cfg, params, cfg, bridge.to_torch(params, cfg, device="cpu")


def min_greedy_gap(jax_cfg, params, prompts, lens, max_new_tokens):
    """The smallest top-2 logit gap at every greedy step of JAX
    ``generate`` on these prompts (re-scored by a full forward pass)."""
    out = jax_gen.generate(params, jnp.asarray(prompts), jnp.asarray(lens),
                           jax_cfg, max_new_tokens=max_new_tokens)
    seqs = np.asarray(out["sequences"])
    logits, _ = jax_tf.apply(params, jnp.asarray(seqs), jax_cfg)
    logits = np.asarray(logits)
    gaps = []
    for row, n in enumerate(lens):
        for pos in range(n - 1, n - 1 + max_new_tokens):
            top2 = np.sort(logits[row, pos])[-2:]
            gaps.append(top2[1] - top2[0])
    return float(min(gaps)), np.asarray(out["tokens"])


def min_quantized_greedy_gap(jax_cfg, params, prompts, lens,
                             max_new_tokens):
    """The smallest top-2 logit gap at every greedy step of JAX
    ``generate(..., kv_quant=True)``, read off its own decode path (the
    int8 cache changes the logits, so a full forward pass cannot re-score
    it): its ``_prefill`` and ``_decode_step``, step by step."""
    from cloud_tpu.parallel.sharding import DEFAULT_RULES

    cache, logits = jax_gen._prefill(
        params, jnp.asarray(prompts), jnp.asarray(lens), jax_cfg,
        prompts.shape[1] + max_new_tokens, DEFAULT_RULES, None,
        kv_quant=True)
    cur_len = jnp.asarray(lens)
    gaps, tokens = [], []
    for step in range(max_new_tokens):
        top2 = np.sort(np.asarray(logits), axis=-1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        tokens.append(np.asarray(token))
        if step + 1 < max_new_tokens:
            cache, logits = jax_gen._decode_step(
                params, cache, token, cur_len, jax_cfg, DEFAULT_RULES, None)
            cur_len = cur_len + 1
    return float(np.min(gaps)), np.stack(tokens, axis=1)


def tie_free_prompts(jax_cfg, params, *, batch, max_len, max_new_tokens,
                     seed=0, tries=50, min_len=1, kv_quant=False):
    """Seeded random prompts whose JAX greedy path (with an int8 KV cache
    for ``kv_quant``) is tie-free; returns ``(prompts [B, max_len], lens
    [B], jax_tokens [B, N])``."""
    gap_fn = min_quantized_greedy_gap if kv_quant else min_greedy_gap
    for attempt in range(tries):
        rng = np.random.default_rng(seed + attempt)
        lens = rng.integers(min_len, max_len + 1, batch).astype(np.int32)
        prompts = rng.integers(1, jax_cfg.vocab_size,
                               (batch, max_len)).astype(np.int32)
        gap, tokens = gap_fn(jax_cfg, params, prompts, lens, max_new_tokens)
        if gap > TIE_GAP:
            return prompts, lens, tokens
    raise AssertionError("no tie-free prompt set found")


def resnet_port_config(jax_cfg, dtype=torch.float32):
    return resnet.ResNetConfig(
        stage_sizes=tuple(jax_cfg.stage_sizes), width=jax_cfg.width,
        num_classes=jax_cfg.num_classes, num_groups=jax_cfg.num_groups,
        dtype=dtype)


@functools.lru_cache(maxsize=None)
def _jax_resnet8(seed):
    jax_cfg = dataclasses.replace(jax_resnet.RESNET8_CIFAR, dtype=jnp.float32)
    params = jax.jit(jax_resnet.init, static_argnums=1)(
        jax.random.PRNGKey(seed), jax_cfg)
    return jax_cfg, jax.tree_util.tree_map(np.asarray, params)


def resnet8_models(seed=0):
    """(jax_cfg, jax_params, port_cfg, port_params): RESNET8_CIFAR in f32,
    fresh port params on the CPU (the JAX side is made once per seed)."""
    jax_cfg, params = _jax_resnet8(seed)
    return (jax_cfg, params, resnet_port_config(jax_cfg),
            bridge.resnet_to_torch(params, device="cpu"))


def image_batch(batch, hw, num_classes, seed=0):
    """Synthetic f32 NHWC images and int labels from a numpy seed."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, batch).astype(np.int32)
    images = rng.standard_normal((batch, hw, hw, 3)).astype(np.float32)
    return images, labels


@functools.lru_cache(maxsize=None)
def _jax_bert_tiny(seed):
    jax_cfg = dataclasses.replace(jax_bert.TINY, dtype=jnp.float32)
    params = jax.jit(jax_bert.init, static_argnums=1)(
        jax.random.PRNGKey(seed), jax_cfg)
    return jax_cfg, jax.tree_util.tree_map(np.asarray, params)


def bert_tiny_models(seed=0):
    """(jax_cfg, jax_params, port_cfg, port_params): BERT TINY in f32,
    fresh port params on the CPU (the JAX side is made once per seed)."""
    jax_cfg, params = _jax_bert_tiny(seed)
    fields = ("vocab_size", "num_layers", "dim", "num_heads", "mlp_hidden",
              "max_seq_len", "num_classes", "dropout_rate", "remat")
    cfg = bert.BertConfig(dtype=torch.float32,
                          **{f: getattr(jax_cfg, f) for f in fields})
    return (jax_cfg, params, cfg,
            bridge.bert_to_torch(params, cfg, device="cpu"))
