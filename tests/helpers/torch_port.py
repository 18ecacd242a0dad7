"""Shared rig for the PyTorch port's parity tests (``tests/test_torch_*.py``).

The JAX package's own ``init`` makes the weights; ``cloud_tpu_torch.bridge``
carries them across, so both sides compute with the same numbers.
:func:`run_port_side` runs the port's side of a comparison in a child
process that never imports JAX, on inputs and weights passed as numpy.
"""

import dataclasses
import functools
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cloud_tpu.models import bert as jax_bert
from cloud_tpu.models import generation as jax_gen
from cloud_tpu.models import mnist as jax_mnist
from cloud_tpu.models import quantization as jax_quant
from cloud_tpu.models import resnet as jax_resnet
from cloud_tpu.models import transformer as jax_tf
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import bert, mnist, resnet, transformer

#: Smallest top-2 logit gap along a greedy path for it to count as
#: tie-free: below it, f32 summation order alone could flip an argmax.
TIE_GAP = 1e-3
#: The same under an int8 KV cache: an ulp between two products of the
#: same row can flip one int8 rounding of the cache, which moves logits by
#: far more than 1e-3.
QUANT_TIE_GAP = 1e-2


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


def greedy_gaps(jax_cfg, params, prompts, lens, max_new_tokens):
    """Each row's smallest top-2 logit gap along the greedy path of JAX
    ``generate`` on these prompts (re-scored by a full forward pass), and
    the tokens of that path."""
    out = jax_gen.generate(params, jnp.asarray(prompts), jnp.asarray(lens),
                           jax_cfg, max_new_tokens=max_new_tokens)
    seqs = np.asarray(out["sequences"])
    logits, _ = jax_tf.apply(params, jnp.asarray(seqs), jax_cfg)
    logits = np.asarray(logits)
    gaps = np.empty(len(lens))
    for row, n in enumerate(lens):
        top2 = np.sort(logits[row, n - 1:n - 1 + max_new_tokens], axis=-1)
        gaps[row] = (top2[:, -1] - top2[:, -2]).min()
    return gaps, np.asarray(out["tokens"])


def min_greedy_gap(jax_cfg, params, prompts, lens, max_new_tokens):
    """The smallest top-2 logit gap at every greedy step of JAX
    ``generate`` on these prompts, and the tokens."""
    gaps, tokens = greedy_gaps(jax_cfg, params, prompts, lens,
                               max_new_tokens)
    return float(gaps.min()), tokens


def quantized_greedy_gaps(jax_cfg, params, prompts, lens, max_new_tokens):
    """Each row's smallest top-2 logit gap at every greedy step of JAX
    ``generate(..., kv_quant=True)``, read off its own decode path (the
    int8 cache changes the logits, so a full forward pass cannot re-score
    it): its ``_prefill`` and ``_decode_step``, step by step; and the
    tokens."""
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
    return np.min(np.stack(gaps, axis=1), axis=1), np.stack(tokens, axis=1)


def min_quantized_greedy_gap(jax_cfg, params, prompts, lens,
                             max_new_tokens):
    """The smallest top-2 logit gap at every greedy step of JAX
    ``generate(..., kv_quant=True)`` on these prompts, and the tokens."""
    gaps, tokens = quantized_greedy_gaps(jax_cfg, params, prompts, lens,
                                         max_new_tokens)
    return float(gaps.min()), tokens


def tie_free_rows(jax_cfg, params, lens, max_new_tokens, *, seed,
                  kv_quant=False, per_len=8, low=1):
    """One seeded random prompt of each length in ``lens`` whose JAX
    greedy path (with an int8 KV cache for ``kv_quant``, at
    :data:`QUANT_TIE_GAP`) is tie-free: a list of 1-D int32 prompts."""
    gap_fn = quantized_greedy_gaps if kv_quant else greedy_gaps
    limit = QUANT_TIE_GAP if kv_quant else TIE_GAP
    rng = np.random.default_rng(seed)
    want = sorted(set(int(n) for n in lens))
    cand_lens = np.repeat(np.asarray(want, np.int32), per_len)
    cands = rng.integers(low, jax_cfg.vocab_size,
                         (len(cand_lens), max(want))).astype(np.int32)
    gaps, _ = gap_fn(jax_cfg, params, cands, cand_lens, max_new_tokens)
    pools = {n: [cands[i, :n] for i in range(len(cand_lens))
                 if cand_lens[i] == n and gaps[i] > limit] for n in want}
    out = []
    for n in lens:
        if not pools[int(n)]:
            raise AssertionError(f"no tie-free prompt of length {n}")
        out.append(pools[int(n)].pop(0))
    return out


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


def mnist_models(seed=0, hidden_dim=16):
    """(jax_cfg, jax_params, port_cfg, port_params): MNIST with a narrow
    hidden layer, JAX's init as numpy and fresh port params on the CPU."""
    jax_cfg = jax_mnist.MnistConfig(hidden_dim=hidden_dim)
    params = jax.tree_util.tree_map(
        np.asarray, jax_mnist.init(jax.random.PRNGKey(seed), jax_cfg))
    cfg = mnist.MnistConfig(hidden_dim=hidden_dim)
    return jax_cfg, params, cfg, bridge.mnist_to_torch(params, device="cpu")


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


REPO = pathlib.Path(__file__).resolve().parents[2]

#: What every child of :func:`run_port_side` runs before its script: JAX
#: blocked, one intra-op thread, the inputs as ``IN``, the outputs to fill as
#: ``OUT``, and ``port_model()`` for the weights :func:`model_inputs` sent.
#: One thread, because with two, in a fresh process on a loaded host, the
#: OpenMP worker's first ``exp`` after an MKL matrix product now and then
#: came out ~1e-4 off (f32 and f64 alike, on the worker's half of the
#: tensor only): the cause of the paged-chunk and flash-backward flakes.
_PRELUDE = """
import json
import sys
sys.modules["jax"] = None
import numpy as np
import torch
torch.set_num_threads(1)
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import transformer
IN = dict(np.load(sys.argv[1], allow_pickle=False))
OUT = {}


def tree(prefix):
    out = {}
    for key, value in IN.items():
        if key.startswith(prefix + "/"):
            node = out
            parts = key[len(prefix) + 1:].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = value
    return out


def port_model(prefix="params", dtype=torch.float32):
    fields = json.loads(str(IN[prefix + ".config"]))
    cfg = transformer.TransformerConfig(dtype=dtype, **fields)
    return cfg, bridge.to_torch(tree(prefix), cfg, device="cpu")
"""


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, f"{prefix}/{key}", out)
    else:
        out[prefix] = np.asarray(tree)
    return out


def model_inputs(jax_cfg, params, prefix="params"):
    """The JAX weights and config as flat numpy inputs of
    :func:`run_port_side` (``port_model(prefix)`` rebuilds them there)."""
    fields = {f: getattr(jax_cfg, f) for f in (
        "vocab_size", "num_layers", "dim", "num_heads", "head_dim",
        "mlp_hidden", "max_seq_len", "rope_base", "tied_embeddings")}
    out = _flatten(jax.tree_util.tree_map(np.asarray, params), prefix, {})
    out[prefix + ".config"] = np.asarray(json.dumps(fields))
    return out


def run_port_side(script, inputs, workdir, *, timeout=600):
    """Run ``script`` after :data:`_PRELUDE` in a child Python that never
    imports JAX, on ``inputs`` (a dict of numpy arrays, ``IN`` there);
    returns the dict the script left in ``OUT``."""
    workdir = pathlib.Path(workdir)
    np.savez(workdir / "in.npz", **inputs)
    code = _PRELUDE + script + "\nnp.savez(sys.argv[2], **OUT)\n"
    proc = subprocess.run(
        [sys.executable, "-c", code, str(workdir / "in.npz"),
         str(workdir / "out.npz")], cwd=str(REPO),
        env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True,
        text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(workdir / "out.npz") as out:
        return dict(out)
