"""Tensor parallelism for CloudLM (and, in training, BERT's and ViT's
encoder blocks, split the same way): one rank's shard of the params and
the collectives its layers call.

The JAX package shards CloudLM's params by the rules table and lets GSPMD
insert the collectives; here each rank holds its shard (:func:`shard_lm`)
and the layers call the collectives where GSPMD puts them:

- ``q``/``k``/``v`` and the MLP's ``wi``/``wg`` are column-split (heads
  and hidden units over ``tp``): each rank projects its own, no
  communication;
- ``att.out`` and ``mlp.wo`` are row-split: a local product, then one
  sum over ``tp`` (:meth:`TensorParallel.reduce`), the bias added once
  after it (``layers.row_parallel_dense``);
- the embedding table is vocab-split: a masked local lookup, then the
  same sum (rows outside the shard add zeros, which is exact);
- the head (or the tied table) is vocab-split: local logits, then one
  gather along the vocabulary (:meth:`TensorParallel.gather_vocab`), the
  sampling boundary.

Weight-only int8 leaves split as their float kernels do; a row-split
kernel's per-output-column scale stays whole on every rank.  An MoE
layer's experts split their hidden units the same way (``wi``/``wg`` by
column, ``wo`` by row, the router whole; ``expert`` is not split on a
serving slice).  The shard carries its :class:`TensorParallel` under the
params' ``"tp"`` key, which every program reads; a params tree without
the key runs the one-card code unchanged.

A serving slice may also span ``sp`` (``mesh_shape=(tp, sp)``): every
``sp`` member holds the same ``tp`` shard and the whole KV cache, and
runs every program whole except a one-shot prefill, whose sequence it
splits into contiguous blocks (``models/generation.py``).  The context
of such a prefill says so (``seq_split``), which tells an MoE layer to
route its block as part of the whole sequence.

Training under a mesh uses :class:`TrainContext` (:func:`train_context`),
a :class:`TensorParallel` that also knows the data axes (``dp``,
``fsdp``), ``sp``, the pipeline's ``pp`` and the experts' ``ep``, and
whose collectives are differentiable (``parallel/autograd.py``):
Megatron's conjugate pair ``copy`` / ``reduce``, the vocabulary gather
with a slice for its transpose, and an MoE layer's expert exchange and
routing-statistics sum.  CloudLM's ``loss_fn`` builds it from ``mesh=``
and ``rules=``; under training rules ``embed`` may split over ``fsdp``
(the step gathers those leaves whole before the forward pass,
``training/train.py``), ``layers`` over ``pp`` (a stage's block of the
layer list, ``parallel/pipeline.py``) and ``expert`` over ``ep``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cloud_tpu_torch.parallel import autograd as autograd_lib
from cloud_tpu_torch.parallel import collectives
from cloud_tpu_torch.parallel import mesh as mesh_lib
from cloud_tpu_torch.parallel import sharding

#: The logical axes CloudLM's params carry, and what the layers need of
#: each under a mesh: split over ``tp`` or not split at all.
_MUST_SPLIT = ("heads", "mlp")
_MAY_SPLIT = ("vocab",)
_MUST_NOT_SPLIT = ("embed",)


@dataclasses.dataclass(frozen=True, eq=False)
class TensorParallel:
    """What a rank's layers need of the mesh: its ``tp`` group and, when
    the vocabulary is split, every member's vocabulary extent in axis
    order (uneven when ``tp`` does not divide it)."""

    mesh: object
    vocab_sizes: Optional[Tuple[int, ...]] = None
    #: Whether the activations are this rank's ``sp`` block of the
    #: sequence (a split prefill) rather than the whole of it.
    seq_split: bool = False
    #: Whether an ``sp`` block is laid out in the zig-zag order
    #: (``zigzag_sp``, training only): two chunks of the sequence, not one.
    zigzag: bool = False

    axis = mesh_lib.AXIS_TP
    #: A serving slice never splits an MoE layer's experts.
    experts_split = False

    @property
    def size(self) -> int:
        return self.mesh.axis_size(self.axis)

    @property
    def index(self) -> int:
        return self.mesh.axis_index(self.axis)

    @property
    def vocab_split(self) -> bool:
        return self.vocab_sizes is not None

    @property
    def vocab_start(self) -> int:
        return sum(self.vocab_sizes[:self.index])

    def local_heads(self, num_heads: int) -> int:
        return num_heads // self.size

    @property
    def sp_size(self) -> int:
        return self.mesh.axis_size(mesh_lib.AXIS_SP)

    @property
    def sp_index(self) -> int:
        return self.mesh.axis_index(mesh_lib.AXIS_SP)

    def seq_bounds(self, t: int) -> Tuple[int, int]:
        """``[start, stop)`` of this rank's contiguous ``sp`` block of a
        sequence of ``t`` positions; ``t`` must divide by ``sp``, as the
        ring's blocks must."""
        sp = self.sp_size
        if t % sp:
            raise ValueError(f"seq_len {t} does not divide by sp={sp}")
        block = t // sp
        return self.sp_index * block, (self.sp_index + 1) * block

    def splits_seq(self, t: int) -> bool:
        """Whether a serving prefill of width ``t`` runs split over ``sp``:
        ``sp`` > 1 divides it (other widths run whole on every member,
        never padded)."""
        return self.sp_size > 1 and t % self.sp_size == 0

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every member's ``x`` (a row-split product's partial
        sums, a masked lookup)."""
        return collectives.all_reduce_sum(x, self.axis, mesh=self.mesh)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """The input of column-split projections: ``x`` itself (serving
        runs no backward; :class:`TrainContext` sums its cotangent)."""
        return x

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Vocab-split logits ``[..., V_local]`` -> replicated ``[..., V]``."""
        return collectives.all_gather(logits, self.axis,
                                      gather_dim=logits.dim() - 1,
                                      sizes=self.vocab_sizes, mesh=self.mesh)

    def __repr__(self):
        return (f"TensorParallel(tp={self.size}, index={self.index}, "
                f"sp={self.sp_size}, seq_split={self.seq_split}, "
                f"vocab_sizes={self.vocab_sizes})")


@dataclasses.dataclass(frozen=True, eq=False)
class TrainContext(TensorParallel):
    """A training rank's view of the mesh: :class:`TensorParallel`'s
    ``tp`` split with differentiable collectives, plus the axes the data
    differ on (``dp``, ``fsdp``, ``sp``) for the global loss, the
    pipeline's ``pp`` coordinate and the experts' ``ep`` split.  Ranks
    that differ only in ``pp`` or ``ep`` hold the same rows."""

    rules: sharding.ShardingRules = sharding.DEFAULT_RULES
    #: A training rank always holds its ``sp`` block of the sequence.
    seq_split: bool = True

    #: The axes over which ranks hold different rows or positions.
    loss_axes = (mesh_lib.AXIS_DP, mesh_lib.AXIS_FSDP, mesh_lib.AXIS_SP)

    @property
    def pp_size(self) -> int:
        return self.mesh.axis_size(mesh_lib.AXIS_PP)

    @property
    def data_size(self) -> int:
        """How many ranks hold different rows (``dp`` x ``fsdp``)."""
        return (self.mesh.axis_size(mesh_lib.AXIS_DP)
                * self.mesh.axis_size(mesh_lib.AXIS_FSDP))

    @property
    def data_index(self) -> int:
        """This rank's data coordinate over ``dp`` x ``fsdp`` (the block of
        the global batch its rows are, ``train.shard_batch``)."""
        return (self.mesh.axis_index(mesh_lib.AXIS_DP)
                * self.mesh.axis_size(mesh_lib.AXIS_FSDP)
                + self.mesh.axis_index(mesh_lib.AXIS_FSDP))

    def sum_over_seq(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every ``sp`` member's ``x`` forward, and of every
        member's cotangent backward: a value each member computes its part
        of and every member then uses (a pooled sequence, the first
        position's features)."""
        return autograd_lib.copy_to(
            autograd_lib.reduce_from(x, mesh_lib.AXIS_SP, self.mesh),
            mesh_lib.AXIS_SP, self.mesh)

    @property
    def expert_axes(self) -> Tuple[str, ...]:
        """The nontrivial mesh axes the experts are cut over (``ep``)."""
        return tuple(a for a in sharding.mesh_axes(
            self.rules.rules.get("expert")) if self.mesh.axis_size(a) > 1)

    @property
    def experts_split(self) -> bool:
        return bool(self.expert_axes)

    def expert_bounds(self, num_experts: int) -> Tuple[int, int]:
        """``[start, stop)`` of this rank's experts, cut as
        ``sharding.shard_bounds`` cuts them (an uneven count too)."""
        count, index = sharding.shard_count_and_index(
            self.mesh, self.expert_axes)
        return sharding.shard_bounds(num_experts, count, index)

    def copy_experts(self, x: torch.Tensor) -> torch.Tensor:
        """An MoE layer's input to this rank's experts: ``x`` forward, its
        cotangent summed over the expert axes backward."""
        return autograd_lib.copy_to(x, self.expert_axes, self.mesh)

    def reduce_experts(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every expert shard's partial output forward, the
        cotangent as it is backward."""
        return autograd_lib.reduce_from(x, self.expert_axes, self.mesh)

    def sum_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks that hold different tokens (rows over
        ``dp`` x ``fsdp``, positions over ``sp``) forward, the identity
        backward (an MoE layer's routing statistics).  Under remat "full"
        the layer's recompute issues it again inside the backward pass;
        that keeps one order because every rank walks the same layers in
        the same reverse order."""
        return autograd_lib.reduce_from(x, self.loss_axes, self.mesh)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return autograd_lib.reduce_from_tp(x, self.mesh)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return autograd_lib.copy_to_tp(x, self.mesh)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        return autograd_lib.gather_vocab(logits, self.mesh,
                                         self.vocab_sizes)

    def sum_over_data(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over every axis the data differ on (not
        differentiable: a loss's weight total or its reported value)."""
        return collectives.all_reduce_sum(x, self.loss_axes, mesh=self.mesh)

    def __repr__(self):
        return (f"TrainContext(mesh={self.mesh.shape}, "
                f"vocab_sizes={self.vocab_sizes})")


def check_rules(mesh, rules: sharding.ShardingRules, *,
                training: bool = False) -> bool:
    """Whether ``rules`` splits the vocabulary over ``tp``; raises
    ``ValueError`` for a table the tensor-parallel layers cannot run:
    heads and mlp must be split over ``tp`` (the KV cache shards by head),
    vocab over ``tp`` or not at all, and embed and expert not at all;
    ``training`` lets embed split over ``fsdp``, layers over ``pp`` and
    expert over ``ep`` (each or not at all).  No axis may use another
    nontrivial mesh axis."""
    def split_axes(logical):
        return tuple(a for a in sharding.mesh_axes(rules.assignment(logical))
                     if mesh.axis_size(a) > 1)

    embed_ok = (mesh_lib.AXIS_FSDP,) if training else ()
    if not training and split_axes("expert"):
        raise ValueError(
            f"rules map 'expert' to {rules.assignment('expert')!r} on a "
            f"mesh of shape {mesh.shape}: a serving slice splits an MoE "
            "layer's hidden units over tp, never its experts")
    if training:
        for logical, allowed in (("layers", mesh_lib.AXIS_PP),
                                 ("expert", mesh_lib.AXIS_EP)):
            axes = tuple(a for a in sharding.mesh_axes(
                rules.rules.get(logical)) if mesh.axis_size(a) > 1)
            if axes and axes != (allowed,):
                raise ValueError(
                    f"rules map {logical!r} to {rules.rules.get(logical)!r} "
                    f"on a mesh of shape {mesh.shape}: training splits "
                    f"{logical} over {allowed} or not at all")
    for logical in _MUST_SPLIT + _MAY_SPLIT + _MUST_NOT_SPLIT:
        axes = split_axes(logical)
        allowed = (embed_ok if logical in _MUST_NOT_SPLIT
                   else (mesh_lib.AXIS_TP,))
        if any(a not in allowed for a in axes) or len(axes) > 1 or (
                logical in _MUST_SPLIT and not axes
                and mesh.axis_size(mesh_lib.AXIS_TP) > 1):
            raise ValueError(
                f"rules map {logical!r} to {rules.assignment(logical)!r} on "
                f"a mesh of shape {mesh.shape}: the tensor-parallel layers "
                "split heads and mlp over tp, vocab over tp or not at all, "
                "and embed " + ("over fsdp or not at all" if training
                                else "not at all"))
    return bool(split_axes("vocab"))


def context(mesh, config, rules=sharding.DEFAULT_RULES) -> TensorParallel:
    """The :class:`TensorParallel` of CloudLM ``config`` on a serving
    ``mesh`` (``tp``, and ``sp`` over which ranks hold the same shard):
    ``tp`` must divide the head count (the KV cache shards by head); the
    vocabulary, the MLP and an MoE layer's experts' hidden units may
    split unevenly."""
    tp = mesh.axis_size(mesh_lib.AXIS_TP)
    if config.num_heads % tp:
        raise ValueError(
            f"mesh tp={tp} does not divide num_heads={config.num_heads}: "
            "the KV cache shards by attention head")
    return TensorParallel(mesh=mesh, vocab_sizes=_vocab_sizes(
        mesh, config, check_rules(mesh, rules)))


def _vocab_sizes(mesh, config, split: bool):
    if not split:
        return None
    tp = mesh.axis_size(mesh_lib.AXIS_TP)
    return tuple(stop - start for start, stop in
                 (sharding.shard_bounds(config.vocab_size, tp, i)
                  for i in range(tp)))


def train_context(mesh, config, rules=sharding.DEFAULT_RULES
                  ) -> TrainContext:
    """The :class:`TrainContext` of ``config`` on ``mesh`` (CloudLM's, or
    an encoder's: BERT's and ViT's, whose heads and MLP split as
    CloudLM's, BERT's token table over the vocabulary, ViT without one):
    ``tp`` must divide the head count, and an MoE model's expert shards
    may not outnumber its experts."""
    moe = getattr(config, "moe", None)
    tp = mesh.axis_size(mesh_lib.AXIS_TP)
    if config.num_heads % tp:
        raise ValueError(
            f"mesh tp={tp} does not divide num_heads={config.num_heads}")
    split = check_rules(mesh, rules, training=True)
    vocab = split and getattr(config, "vocab_size", None) is not None
    ctx = TrainContext(mesh=mesh, rules=rules,
                       vocab_sizes=_vocab_sizes(mesh, config, vocab),
                       zigzag=bool(getattr(config, "zigzag_sp", False)))
    if moe is not None:
        count, _ = sharding.shard_count_and_index(mesh, ctx.expert_axes)
        if count > moe.num_experts:
            raise ValueError(
                f"{count} expert shards for {moe.num_experts} "
                "experts: every shard needs one")
    return ctx


def mesh_context(config, mesh=None, rules=None) -> Optional[TrainContext]:
    """The :func:`train_context` of ``mesh`` (or the installed global mesh)
    when it has more than one rank, else None (an encoder's loss runs its
    one-card path then)."""
    mesh = mesh_lib.effective_mesh(
        mesh if mesh is not None else mesh_lib.get_global_mesh())
    if mesh is None:
        return None
    return train_context(mesh, config, rules or sharding.DEFAULT_RULES)


def shard_lm(params, config, mesh, rules=sharding.DEFAULT_RULES):
    """This rank's shard of full CloudLM params (the port's layout), with
    its :func:`context` under ``"tp"``: heads, MLP hidden units (an MoE
    layer's per expert; int8 scales with their columns) and the
    vocabulary cut over ``tp``, the same on every ``sp`` member."""
    from cloud_tpu_torch.models import transformer

    ctx = context(mesh, config, rules)
    shard = sharding.shard_tree(
        {k: v for k, v in params.items() if k != "tp"},
        transformer.param_logical_axes(config), mesh, rules)
    shard["tp"] = ctx
    return shard
