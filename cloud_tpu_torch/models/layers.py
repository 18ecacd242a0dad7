"""Functional layers over parameter dicts (port of ``cloud_tpu/models/layers.py``).

Parameters are plain dicts of tensors with the JAX package's names and
layouts (dense kernels ``[in, out]``).  Compute runs in the dtype of the
activations; a weight is cast to it where it is used, as in the JAX
package, so f32 master weights and weights stored once in the compute
dtype give the same numbers.  Weight-only int8 leaves (``kernel_q`` /
``table_q`` with their ``*_scale``, ``models/quantization.py``) take the
JAX package's post-scale route: the int8 matrix feeds the product and the
per-channel scale applies to its small output.

Under tensor parallelism (``parallel/tensor_parallel.py``) the params are
one rank's shard: :func:`row_parallel_dense` sums a row-split layer's
partial products over ``tp``, :func:`embedding_apply` assembles a
vocab-split lookup, and every other function runs on the shard as it
runs on the full params.  In training (a ``TrainContext``) those sums
and the column-split inputs (``tp.copy``) are differentiable, and
:func:`sharded_attention` routes attention over the ``sp`` axis: Ulysses'
all-to-all or the ring (``parallel/ring_attention.py``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from cloud_tpu_torch import random as random_lib

#: Remat policies of the JAX package's layer stacks.
REMAT_POLICIES = ("none", "full", "dots")

#: The products "dots" saves: matrix products with no batch dimension,
#: ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``.  A dense
#: projection of ``[B, T, D]`` reaches the dispatcher as ``aten.mm`` (or
#: ``addmm``); batched products (``aten.bmm``: attention's plain version,
#: the MoE dispatch, expert and combine einsums) are recomputed, as are
#: the elementwise ops and the flash kernels, as JAX recomputes the
#: ``pallas_call``.
_DOTS_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS_SAVED:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(body, enabled: bool = True, policy: str = "full"):
    """Wrap a layer body with the named remat policy, as
    ``cloud_tpu/models/layers.py``'s ``remat_wrap``: "full" keeps only the
    layer's inputs and recomputes the layer in the backward pass
    (``torch.utils.checkpoint``, non-reentrant); "dots" also keeps the
    outputs of the matrix products with no batch dimension and recomputes
    the rest (selective checkpointing, :data:`_DOTS_SAVED`); "none" (or
    ``enabled`` False) keeps every activation.  Numbers are the same under
    every policy.  Without autograd (serving, ``torch.no_grad()``) the body
    runs plain."""
    if not enabled or policy == "none":
        return body
    if policy not in ("full", "dots"):
        raise ValueError(
            f"remat policy must be one of {REMAT_POLICIES}, got {policy!r}"
        )
    extra = ({"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)}
        if policy == "dots" else {})

    def wrapped(*args, **kwargs):
        if not torch.is_grad_enabled():
            return body(*args, **kwargs)
        # The layer bodies draw random numbers only from the threefry keys
        # they are given (``dropout``), never from torch's generator, so
        # the recomputation draws the same masks without the generator's
        # state being saved (reading it is not allowed inside a CUDA graph
        # capture, ``train.make_multi_step``).
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False, **extra, **kwargs)

    return wrapped


def dense_axes(in_axis: Optional[str], out_axis: Optional[str],
               use_bias: bool = True):
    """Logical axes of a dense layer's params (the JAX package's)."""
    axes = {"kernel": (in_axis, out_axis)}
    if use_bias:
        axes["bias"] = (out_axis,)
    return axes


def encoder_block_axes():
    """Logical axes of one BERT/ViT encoder block (the JAX package's
    ``layers.encoder_block_axes``): q/k/v split by heads, ``out`` by its
    input heads, ``wi`` by hidden units, ``wo`` by its input units."""
    return {
        "att": {"q": dense_axes("embed", "heads", use_bias=False),
                "k": dense_axes("embed", "heads", use_bias=False),
                "v": dense_axes("embed", "heads", use_bias=False),
                "out": dense_axes("heads", "embed", use_bias=False)},
        "ln1": {"scale": (None,), "bias": (None,)},
        "wi": dense_axes("embed", "mlp"),
        "wo": dense_axes("mlp", "embed"),
        "ln2": {"scale": (None,), "bias": (None,)},
    }


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, *,
               use_bias: bool = True):
    """Kernel ``[in, out]``, truncated normal in [-2, 2] scaled by
    1/sqrt(in), and a zero bias, as ``cloud_tpu/models/layers.py``'s
    ``dense_init``; on the generator's device."""
    w = torch.empty((in_dim, out_dim), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    params = {"kernel": w * (1.0 / math.sqrt(in_dim))}
    if use_bias:
        params["bias"] = torch.zeros((out_dim,), dtype=torch.float32,
                                     device=generator.device)
    return params


def materialize_matrix(params, name: str, dtype):
    """The (possibly int8-quantized) matrix ``name`` at compute width:
    ``{name}_q * {name}_scale`` for a quantized leaf."""
    if f"{name}_q" in params:
        return (params[f"{name}_q"].to(dtype)
                * params[f"{name}_scale"].to(dtype))
    return params[name].to(dtype)


def dense_apply(params, x, *, dtype=None):
    """``x @ kernel (+ bias)`` in ``dtype`` (default: x's).  An int8 kernel
    takes the post-scale route, ``(x @ q) * scale``, with the per-output
    scale ``[1, out]`` applied to the product."""
    dtype = dtype or x.dtype
    if "kernel_q" in params:
        q = params["kernel_q"].to(dtype)
        scale = params["kernel_scale"].squeeze(-2).to(dtype)
        y = torch.matmul(x.to(dtype), q) * scale
    else:
        y = torch.matmul(x.to(dtype), params["kernel"].to(dtype))
    if "bias" in params:
        y = y + params["bias"].to(dtype)
    return y


def row_parallel_dense(params, x, tp=None):
    """A dense layer whose input dim is split over ``tp`` (``att.out``,
    ``mlp.wo``): the local product's partial sums are summed over ``tp``
    in f32 and rounded to x's type once (one card's product accumulates
    in f32 and rounds once too); an int8 kernel's scale and any bias
    apply once, after the sum.  With ``tp=None`` (or a ``tp`` of one
    rank), :func:`dense_apply`."""
    if tp is None or tp.size == 1:
        return dense_apply(params, x)
    name = "kernel_q" if "kernel_q" in params else "kernel"
    y = tp.reduce(torch.matmul(x.float(), params[name].float()))
    if name == "kernel_q":
        y = y * params["kernel_scale"].squeeze(-2).float()
    y = y.to(x.dtype)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def embedding_apply(params, token_ids, *, dtype=torch.float32, tp=None):
    """Table lookup; rows are gathered first and cast after (the same
    numbers as casting the whole table, without touching all of it).  An
    int8 table gathers int8 rows and scales them by their per-row scale.
    With ``tp`` (a ``parallel.tensor_parallel.TensorParallel``) splitting
    the vocabulary, the table is this rank's rows: ids outside them look
    up zeros, and one sum over ``tp`` assembles every row (adding zeros
    is exact)."""
    ids = token_ids.long()
    if tp is None or not tp.vocab_split:
        return _lookup(params, ids, dtype)
    local = ids - tp.vocab_start
    inside = (local >= 0) & (local < tp.vocab_sizes[tp.index])
    rows = _lookup(params, torch.where(inside, local, 0), dtype)
    # Summed in f32 (exact: one rank contributes each row).
    rows = torch.where(inside[..., None], rows, 0).float()
    return tp.reduce(rows).to(dtype)


def _lookup(params, ids, dtype):
    if "table_q" in params:
        rows = params["table_q"][ids].to(dtype)
        return rows * params["table_scale"][ids].to(dtype)
    return params["table"][ids].to(dtype)


def layernorm_apply(params, x, *, eps: float = 1e-6):
    """LayerNorm with f32 statistics (population variance, as ``jnp.var``)
    whatever the activations' type."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def dropout(rng, x, rate: float, start=None, full=None):
    """Inverted dropout, as ``cloud_tpu/models/layers.py``'s: the identity
    when ``rng`` is None or ``rate`` is 0 (the eval and deterministic
    path), else ``where(mask, x / keep, 0)`` with ``mask =
    bernoulli(rng, keep, x.shape)`` drawn as ``jax.random`` draws it
    (``cloud_tpu_torch.random``), ``keep = 1 - rate``.  Under a mesh ``x``
    is the block at ``start`` of a global activation of shape ``full``,
    and its mask that block of the global mask."""
    if rng is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = random_lib.bernoulli(rng, keep, x.shape, start=start, full=full)
    scale = torch.full((), keep, dtype=x.dtype, device=x.device)
    return torch.where(mask, x / scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def rmsnorm_apply(params, x, *, eps: float = 1e-6):
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * params["scale"]).to(x.dtype)


def rotary_embedding(x, positions, *, base: float = 10000.0):
    """RoPE applied to ``[..., T, H, D]`` with positions ``[..., T]``."""
    dim = x.shape[-1]
    half = dim // 2
    freqs = base ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions[..., :, None].float() * freqs  # [..., T, half]
    angles = angles[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_block_apply(params, x, *, tp=None):
    """Gated (SwiGLU) MLP; under ``tp`` the hidden units are split
    (``wi``/``wg`` column-split behind one ``tp.copy``, ``wo``
    row-split)."""
    if tp is not None:
        x = tp.copy(x)
    h = F.silu(dense_apply(params["wi"], x)) * dense_apply(params["wg"], x)
    return row_parallel_dense(params["wo"], h, tp)


def classification_loss(logits, labels, mesh, *, replicas: int = 1):
    """Softmax cross-entropy and accuracy of ``logits`` ``[B, classes]``
    against ``labels`` ``[B]`` (MNIST's, ResNet's, BERT's and ViT's loss):
    the batch means without ``mesh``; under a ``mesh`` the loss is this
    rank's summed NLL over the global row count (rows split over ``dp`` x
    ``fsdp``) and over ``replicas``, the number of ranks whose gradients
    the step sums over the same rows (the ``sp`` ranks), and the
    metrics are the global means."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    log_probs = torch.log_softmax(logits, dim=-1)
    nll = -torch.take_along_dim(log_probs, labels[:, None], dim=-1)
    correct = (torch.argmax(logits, -1) == labels).float()
    if mesh is None:
        loss = torch.mean(nll)
        return loss, {"loss": loss.detach(), "accuracy": torch.mean(correct)}
    from cloud_tpu_torch.parallel import collectives

    total = collectives.sum_over_rows(
        torch.tensor(float(labels.shape[0]), device=logits.device), mesh)
    num = nll.sum()
    return num / (total * replicas), {
        "loss": collectives.sum_over_rows(num.detach(), mesh) / total,
        "accuracy": collectives.sum_over_rows(correct.sum(), mesh) / total,
    }


def ulysses_eligible(num_heads: int, mesh, rules=None) -> bool:
    """Whether Ulysses' seq<->head all-to-all exists on ``mesh``: the
    local head group (``num_heads`` over the ``heads`` axes' shards) must
    divide by the ``sp`` size (as ``cloud_tpu/models/layers.py``'s)."""
    from cloud_tpu_torch.parallel import mesh as mesh_lib

    if mesh is None:
        return False
    sp = mesh.axis_size(mesh_lib.AXIS_SP)
    if sp <= 1:
        return False
    return (num_heads // _heads_shards(mesh, rules)) % sp == 0


def _heads_shards(mesh, rules) -> int:
    """How many shards the ``heads`` axis is cut into on ``mesh``."""
    from cloud_tpu_torch.parallel import sharding

    count = 1
    for axis in sharding.mesh_axes(
            (rules or sharding.DEFAULT_RULES).assignment("heads")):
        count *= mesh.axis_size(axis)
    return count


def sharded_attention(q, k, v, *, causal: bool, mask=None, rules=None,
                      mesh=None, zigzag: bool = False,
                      ulysses: bool = False):
    """Mesh-aware attention over a rank's ``[B, T_local, H_local, D]``
    blocks (``cloud_tpu/models/layers.py``'s routing):

    - ``sp`` > 1 and ``ulysses`` with a head group that divides by
      ``sp``: one all-to-all of q, k and v stacked to ``[B, T, H/sp, D]``,
      K5-K7 over the whole sequence, one all-to-all back; an ineligible
      head group falls through to the ring, as in the JAX package;
    - ``sp`` > 1 otherwise: the zig-zag ring when ``zigzag`` and
      ``causal`` (a padding mask raises: the permuted layout has no mask
      plumbing), else the contiguous ring with the key mask riding it;
    - otherwise (no mesh, or ``sp`` 1): ``flash_attention`` directly.

    ``mask`` is this rank's ``[B, T_local]`` slice of the key-padding
    mask (Ulysses gathers it whole over ``sp``)."""
    from cloud_tpu_torch.ops import flash_attention as flash_lib
    from cloud_tpu_torch.parallel import autograd as autograd_lib
    from cloud_tpu_torch.parallel import collectives
    from cloud_tpu_torch.parallel import mesh as mesh_lib
    from cloud_tpu_torch.parallel import ring_attention as ring_lib

    mesh = mesh if mesh is not None else mesh_lib.get_global_mesh()
    sp = mesh.axis_size(mesh_lib.AXIS_SP) if mesh is not None else 1
    if sp > 1 and ulysses and ulysses_eligible(
            q.shape[2] * _heads_shards(mesh, rules), mesh, rules):
        qkv = autograd_lib.seq_to_heads(torch.stack([q, k, v]), mesh,
                                        seq_dim=2, heads_dim=3)
        if mask is not None:
            mask = collectives.all_gather(mask, mesh_lib.AXIS_SP,
                                          gather_dim=1, mesh=mesh)
        out = flash_lib.flash_attention(qkv[0], qkv[1], qkv[2],
                                        causal=causal, mask=mask)
        return autograd_lib.heads_to_seq(out, mesh)
    if sp > 1:
        if zigzag and mask is not None:
            raise ValueError(
                "padding masks are unsupported with zigzag_sp (the "
                "zig-zag layout is for unpadded pretraining batches); "
                "disable config.zigzag_sp for masked data"
            )
        if zigzag and causal:
            return ring_lib.ring_attention_balanced(q, k, v, mesh=mesh)
        return ring_lib.ring_attention(q, k, v, causal=causal, mask=mask,
                                       mesh=mesh)
    return flash_lib.flash_attention(q, k, v, causal=causal, mask=mask)
