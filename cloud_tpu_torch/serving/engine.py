"""Serving engine (port of ``cloud_tpu/serving/engine.py``).

Two schedulers, as in the JAX engine.

``scheduler="continuous"`` (the default): iteration-level scheduling over
a persistent decode grid, a static ``(num_slots, max_len)`` KV cache plus
per-slot ``{pos, tok, remaining, emitted, active}`` state that live on the
device for the engine's whole life.  Between decode chunks the scheduler
thread retires finished slots (per-request ``max_new_tokens`` spent, or
eos sampled), resolves their futures, and prefills queued requests into
the freed slots: with a one-shot insert (``generation.insert_slot_program``,
flash-attention prefill), or, with the prefix cache or chunked prefill
armed, as a prefill task that the loop advances one chunk per pass
(``generation.prefill_chunk_program``, chunk-causal attention through the
paged kernel at ``Tq`` = the chunk width) and arms from its last chunk's
logits (``generation.finalize_slot_program``).  Each decode chunk
(``generation.decode_chunk_program``) advances every active slot by up to
``chunk_tokens`` tokens, reading the cache through the paged kernel and a
per-slot block table.

The prefix KV cache (``prefix_cache_blocks``): a pool of K/V blocks keyed
on the host by token prefixes (``serving/prefix_cache.py``).  A request
whose prompt starts with a cached prefix pins its blocks and prefills only
the rest.  ``decode_kernel="xla"`` (the default) copies the hit into the
slot row (``generation.copy_prefix_program``); ``"pallas"`` and ``"auto"``
attach it: the slot's block table points at the pool blocks and the paged
kernel reads them in place.  A prefilled prompt saves its new full blocks
to the pool.  ``prefix_dram_blocks`` adds the host-memory tier: a block
evicted from the pool demotes to pinned host memory (downloaded on the
current stream, synchronised once a burst) and a later hit swaps it back
in (uploaded on the current stream, not synchronised).

``scheduler="batch"``: requests wait per prompt bucket until a batch is
full (``batch_buckets[-1]``) or its head has waited ``flush_deadline_s``;
the batch pads to the smallest batch bucket that holds it, is prefilled
in one ``generation.prefill_program`` (flash attention) and decoded to
``max_new_tokens`` by ``generation.decode_program`` (the paged kernel);
every request of the batch resolves when the batch does.

Speculative decoding (``draft=DraftConfig(...)``, continuous scheduler,
greedy): each decode round, a small draft model proposes a ``spec_k``-token
window per active slot over its own slot cache
(``generation.draft_chunk_program``, the paged kernel at Tq 1), and the
target scores the whole window in one forward
(``generation.verify_chunk_program``, the paged kernel at Tq = ``spec_k``)
and commits the accepted prefix.  Every committed token is the target's
own argmax, so the output is the non-speculative output; the draft only
decides how many tokens one round commits.  A slot that will decode first
gets its prompt prefilled into the draft's cache row
(``generation.draft_prefill_slot_program``, one-shot, whatever the target
did).  ``stats()`` counts the rounds and the proposed and accepted
tokens; ``health()`` carries the acceptance over the last 64 rounds.

Pipelined scheduling (``pipeline_depth=2``, continuous scheduler): decode
chunk (or speculative round) N+1 is enqueued on the stream before chunk
N's emissions are read.  Each dispatched chunk joins an in-flight ring
with its own pinned host buffer, filled by a non-blocking copy enqueued
right after the chunk, and a CUDA event recorded after the copy; the
drain waits on the oldest entry's event, then commits its emissions, so
slot mutations apply one pass stale.  The device-side ``active`` mask
keeps a chunk dispatched for a slot that already finished emitting only
masked rows, and every later write to the slot (an insert, a block-table
row) is enqueued on the same stream after it: outputs stay
token-identical to depth 1.  ``serve/dispatch_gap`` and
``serve/host_bubble`` spans record the host gap between dispatches and the
wait paid at each drain.

QoS and streaming (``qos=QosConfig(...)``, ``submit(priority=,
stream=, on_token=)``; ``serving/qos.py``): slot admission by SLO slack
and weighted fairness debt, class-ordered brownout shedding, and per-token
delivery to a ``TokenStream`` or an ``on_token`` hook as chunks commit.
Request tracing (``submit(trace=TraceContext)``): every span a request
touches carries its ``trace_id`` while a ``monitoring.tracing`` collector
is active.  The dispatch watchdog (``dispatch_timeout_s``): every device
dispatch, with the host wait for its results, runs under a deadline; a
dispatch past it fails its requests with :class:`DispatchTimeoutError`
and leaves the engine unhealthy.

Disaggregated serving (``role="prefill"``/``"decode"``, ``set_role``,
``submit(handoff_export=True)`` / ``submit(handoff=payload)``; the fleet's
two-leg route, ``fleet/disagg.py``): a prefill leg exports the prompt's
pinned prefix chain after its save (one gather of the pool rows into
pinned host memory, waited on before the payload leaves), and a decode
leg seeds its prefix trie with the payload's blocks, uploads the ones it
did not hold in one pinned batch, and admits the request as an ordinary
prefix hit.

``ServeConfig(kv_quant=True)`` keeps the grid (and pool) int8 with
per-(position, head) scales; the decode attention then runs the int8
kernel K8q.  Weight-only int8 params (``models/quantization
.quantize_params``) are served as they are.

The host synchronises with the card once per insert or finalize (its
first token), once per decode chunk, speculative round or batch (its
emissions) and once per demotion burst, never per token.  Greedy outputs
are token-identical to a direct ``generation.generate`` call per request.

Serving on a slice (``ServeConfig(mesh_shape=(tp, sp))``,
``layout="auto"``, or ``mesh=`` a ``parallel.mesh.Mesh`` with ``tp`` and
``sp`` axes; ``serving/slice.py``): one process per rank, rank 0 the
caller's engine.  Each rank holds its shard of the params
(``parallel/tensor_parallel.py``: heads, MLP hidden units, an MoE
layer's experts' hidden units and the vocabulary over ``tp``; the same
shard on every ``sp`` member) and a grid and pool of its own heads
(whole over ``sp``, as the JAX engine replicates the cache there);
before each device dispatch rank 0 broadcasts the program and its host
arguments, and the followers (spawned by rank 0, or the caller's other
ranks running :meth:`ServingEngine.follow`) run the same program on
their shards.  A one-shot prefill whose width ``sp`` divides runs split
over ``sp`` (the causal ring over the prompt's blocks, the K/V gathered
over ``sp``; ``stats()["sp_prefills"]``), any other width whole on every
member (``sp_whole_prefills``), and every other program whole on every
member.  The one reshard a forward pass makes is the logits' gather
before sampling; rank 0's host pull of the sampled tokens is spanned as
``serve/reshard``.  Greedy outputs stay token-identical to
``generation.generate``.

On a slice the followers also run the speculative draft (head-sharded
as the target when ``tp`` divides its heads, else replicated on every
rank), keep their heads' blocks of the prefix cache's host tier (rank 0's
manager decides every demotion and swap-in; each plan carries the block
ids), export their heads of a KV handoff payload to rank 0 (which
gathers every head, in head order) and import theirs from one, and take
a second decode chunk in flight (``pipeline_depth=2``) in dispatch order.

The engine takes every field, keyword and method of the JAX engine.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import logging
import threading
import time
import weakref
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cloud_tpu_torch import bridge
from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import generation, quantization
from cloud_tpu_torch.monitoring import metrics, tracing
from cloud_tpu_torch.ops import dispatch
from cloud_tpu_torch.parallel import distributed as dist_lib
from cloud_tpu_torch.parallel import mesh as mesh_lib
from cloud_tpu_torch.parallel import planner, sharding, tensor_parallel
from cloud_tpu_torch.serving import qos as qos_lib
from cloud_tpu_torch.serving import slice as slice_lib
from cloud_tpu_torch.serving.prefix_cache import (
    SKIP_BLOCK,
    PrefixCacheManager,
    PrefixHit,
)
from cloud_tpu_torch.serving.qos import QosConfig, TokenStream
from cloud_tpu_torch.utils import faults

logger = logging.getLogger(__name__)

#: Scheduler-thread name (prefix match in tests' thread-leak guards).
SERVE_SCHEDULER_THREAD_NAME = "cloud-tpu-torch-serve-scheduler"
#: Warmup worker's name (the same prefix, so the same guards see it).
SERVE_WARMUP_THREAD_NAME = SERVE_SCHEDULER_THREAD_NAME + "-warmup"
#: Watchdog-supervised dispatch threads (``dispatch_timeout_s`` set), in
#: the same prefix family as the scheduler.
SERVE_DISPATCH_THREAD_NAME = "cloud-tpu-torch-serve-dispatch"
#: The kernel libraries the serving path launches (K5, K8/K8q).
SERVING_LIBRARIES = ("flash_fwd", "paged_attention")
#: The serving slice of an engine without a serving mesh: one card
#: (``health()``'s ``slice_shape``/``slice_chips``, what the JAX engine
#: reports without a mesh).
SLICE_SHAPE, SLICE_CHIPS = (1, 1), 1
#: The KV handoff counters of ``stats()`` and ``health()``.
HANDOFF_KEYS = ("handoff_exports", "handoff_export_blocks",
                "handoff_imports", "handoff_import_blocks")


class QueueFullError(RuntimeError):
    """Typed rejection under ``admission="reject"``: the waiting set is at
    ``max_queue`` — shed the request or retry with backoff."""


class EngineClosedError(RuntimeError):
    """The engine is closed (or closing): the request was not admitted."""


class DeadlineExceededError(RuntimeError):
    """The request's ``deadline_s`` expired while it waited in the queue."""


class DispatchTimeoutError(RuntimeError):
    """A device dispatch, with the host wait for its results, exceeded
    ``dispatch_timeout_s``: the watchdog failed the in-flight requests and
    marked the engine unhealthy instead of wedging the scheduler."""


@dataclasses.dataclass(frozen=True)
class DraftConfig:
    """The draft half of draft-and-verify speculative decoding.

    ``config`` is a ``models.transformer.TransformerConfig``, typically
    fewer layers than the target's (its vocabulary must be the target's:
    acceptance compares token ids); ``params`` the draft's weights (port
    tree, ``bridge``).  ``spec_k`` is the verify window: the tokens the
    target consumes, and can commit, per round; the draft proposes
    ``spec_k - 1`` of them.  Greedy only.
    """

    config: object
    #: Not in the repr: a params tree in a logged config would dump whole
    #: weight tensors.
    params: object = dataclasses.field(repr=False, default=None)
    spec_k: int = 4

    def __post_init__(self):
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if self.params is None:
            raise ValueError(
                "DraftConfig needs the draft model's params — without "
                "them the first proposal dispatch would die deep in the "
                "scheduler thread instead of here"
            )


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs, with the JAX engine's names, defaults and validation.

    ``prompt_buckets`` are the padded prompt lengths (a request lands in
    the smallest bucket that fits it); the slot cache holds
    ``prompt_buckets[-1] + max_new_tokens`` positions per slot;
    ``chunk_tokens`` is the scheduling quantum.  Under
    ``scheduler="batch"``, ``batch_buckets`` are the batch sizes and
    ``flush_deadline_s`` bounds how long the head of a bucket's queue waits
    for co-batching.  ``prefix_cache_blocks`` blocks of
    ``prefix_block_tokens`` tokens arm the prefix cache,
    ``prefix_dram_blocks`` its host tier, ``prefill_chunk_tokens`` chunked
    prefill.  Every ``decode_kernel`` value reads the cache through the
    paged kernel; ``"pallas"`` and ``"auto"`` also attach prefix hits
    through the block table instead of copying them.  ``draft`` arms
    speculative decoding (:class:`DraftConfig`).  ``warmup`` builds the
    kernels and runs the serving programs once at construction
    (``ServingEngine.wait_ready``).  ``dispatch_timeout_s`` arms the
    dispatch watchdog, ``qos`` priority scheduling (a
    ``serving.qos.QosConfig``, continuous scheduler), ``pipeline_depth=2``
    pipelined scheduling (continuous scheduler).  ``role`` is the
    disaggregated-serving role (``"prefill"``/``"decode"`` need the
    continuous scheduler and the prefix cache; the KV handoff moves
    prefix-pool blocks); ``prefix_summary_ttl_s`` bounds the age of the
    prefix cache's router summary (``health()["cached_prefixes"]``).
    """

    max_new_tokens: int = 32
    prompt_buckets: Tuple[int, ...] = (32, 128, 512)
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    flush_deadline_s: float = 0.01
    max_queue: int = 256
    admission: str = "block"
    scheduler: str = "continuous"
    num_slots: Optional[int] = None
    chunk_tokens: int = 8
    prefix_cache_blocks: int = 0
    prefix_block_tokens: int = 16
    prefix_dram_blocks: int = 0
    prefill_chunk_tokens: Optional[int] = None
    draft: Optional[DraftConfig] = None
    sample: "generation.SampleConfig" = None  # type: ignore[assignment]
    kv_quant: bool = False
    warmup: bool = False
    seed: int = 0
    dispatch_timeout_s: Optional[float] = None
    mesh_shape: Optional[Tuple[int, int]] = None
    layout: str = "explicit"
    hbm_bytes_per_chip: Optional[int] = None
    qos: Optional[QosConfig] = None
    decode_kernel: str = "xla"
    role: str = "both"
    prefix_summary_ttl_s: Optional[float] = None
    pipeline_depth: int = 1

    def __post_init__(self):
        if self.sample is None:
            object.__setattr__(self, "sample",
                               generation.SampleConfig(temperature=0.0))
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}"
            )
        for name in ("prompt_buckets", "batch_buckets"):
            buckets = tuple(getattr(self, name))
            object.__setattr__(self, name, buckets)
            if not buckets or any(b < 1 for b in buckets):
                raise ValueError(f"{name} must be non-empty and positive")
            if list(buckets) != sorted(set(buckets)):
                raise ValueError(
                    f"{name} must be strictly increasing, got {buckets}"
                )
        if self.admission not in ("block", "reject"):
            raise ValueError(
                f"admission must be 'block' or 'reject', "
                f"got {self.admission!r}"
            )
        if self.scheduler not in ("continuous", "batch"):
            raise ValueError(
                f"scheduler must be 'continuous' or 'batch', "
                f"got {self.scheduler!r}"
            )
        if self.num_slots is None:
            object.__setattr__(self, "num_slots", self.batch_buckets[-1])
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {self.num_slots}")
        if self.chunk_tokens < 1:
            raise ValueError(
                f"chunk_tokens must be >= 1, got {self.chunk_tokens}"
            )
        if self.prefix_cache_blocks < 0:
            raise ValueError(
                f"prefix_cache_blocks must be >= 0, got "
                f"{self.prefix_cache_blocks}"
            )
        if self.prefix_block_tokens < 1:
            raise ValueError(
                f"prefix_block_tokens must be >= 1, got "
                f"{self.prefix_block_tokens}"
            )
        if self.prefix_dram_blocks < 0:
            raise ValueError(
                f"prefix_dram_blocks must be >= 0, got "
                f"{self.prefix_dram_blocks}"
            )
        if self.prefix_dram_blocks and not self.prefix_cache_blocks:
            raise ValueError(
                "prefix_dram_blocks (the host-DRAM tier) needs "
                "prefix_cache_blocks > 0 — there is no HBM pool to "
                "demote from or swap back into"
            )
        if (self.prefill_chunk_tokens is not None
                and self.prefill_chunk_tokens < 1):
            raise ValueError(
                f"prefill_chunk_tokens must be >= 1 or None, got "
                f"{self.prefill_chunk_tokens}"
            )
        if self.scheduler == "batch" and (
            self.prefix_cache_blocks or self.prefill_chunk_tokens is not None
        ):
            raise ValueError(
                "prefix_cache_blocks / prefill_chunk_tokens need the "
                "continuous scheduler (slot-grid prefill); the batch "
                "path has no per-slot cache rows to reuse"
            )
        if self.draft is not None:
            if self.scheduler != "continuous":
                raise ValueError(
                    "draft= (speculative decoding) needs the continuous "
                    "scheduler — the verify program is a slot-grid "
                    "dispatch"
                )
            if self.sample.temperature != 0.0:
                raise ValueError(
                    "draft= (speculative decoding) requires greedy "
                    f"sampling; got temperature={self.sample.temperature}"
                    " (token-identical non-greedy speculation needs "
                    "rejection resampling)"
                )
            if self.sample.repetition_penalty != 1.0:
                raise ValueError(
                    "draft= (speculative decoding) does not compose with "
                    "repetition_penalty: the verify window's emissions "
                    "would each need the penalty state of the emissions "
                    "before them"
                )
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.flush_deadline_s < 0:
            raise ValueError("flush_deadline_s must be >= 0")
        if self.dispatch_timeout_s is not None and self.dispatch_timeout_s <= 0:
            raise ValueError(
                f"dispatch_timeout_s must be > 0 or None, "
                f"got {self.dispatch_timeout_s}"
            )
        if self.qos is not None:
            if not isinstance(self.qos, QosConfig):
                raise ValueError(
                    f"qos must be a serving.qos.QosConfig, got "
                    f"{type(self.qos).__name__}"
                )
            if self.scheduler != "continuous":
                raise ValueError(
                    "qos= (priority scheduling) needs the continuous "
                    "scheduler — slot admission is where the class "
                    "order is enforced; the batch path forms batches "
                    "by bucket, not by request"
                )
        if self.decode_kernel not in ("auto", "pallas", "xla"):
            raise ValueError(
                f"decode_kernel must be 'auto', 'pallas', or 'xla', "
                f"got {self.decode_kernel!r}"
            )
        if self.role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"role must be 'prefill', 'decode', or 'both', "
                f"got {self.role!r}"
            )
        if self.role != "both" and (
            self.scheduler != "continuous" or not self.prefix_cache_blocks
        ):
            raise ValueError(
                "role= (disaggregated serving) needs the continuous "
                "scheduler and prefix_cache_blocks > 0 — the KV handoff "
                "exports/imports prefix-pool blocks"
            )
        if (self.prefix_summary_ttl_s is not None
                and self.prefix_summary_ttl_s <= 0):
            raise ValueError(
                f"prefix_summary_ttl_s must be > 0 or None, got "
                f"{self.prefix_summary_ttl_s}"
            )
        if self.decode_kernel != "xla" and self.scheduler != "continuous":
            raise ValueError(
                "decode_kernel= (paged decode attention) needs the "
                "continuous scheduler — the block table pages slot rows "
                "of the persistent grid; the batch path re-prefills a "
                "fresh cache per batch"
            )
        if self.pipeline_depth not in (1, 2):
            raise ValueError(
                f"pipeline_depth must be 1 or 2, got "
                f"{self.pipeline_depth!r}"
            )
        if self.pipeline_depth > 1 and self.scheduler != "continuous":
            raise ValueError(
                "pipeline_depth=2 (pipelined scheduling) needs the "
                "continuous scheduler — the in-flight ring overlaps "
                "chunk dispatches on the persistent slot grid; the "
                "batch path has no standing state to dispatch against"
            )
        if self.layout not in ("explicit", "auto"):
            raise ValueError(
                f"layout must be 'explicit' or 'auto', got {self.layout!r}"
            )
        if self.mesh_shape is not None:
            shape = tuple(int(v) for v in self.mesh_shape)
            if len(shape) != 2 or any(v < 1 for v in shape):
                raise ValueError(
                    f"mesh_shape must be a (tp, sp) pair of positive "
                    f"ints, got {self.mesh_shape!r}"
                )
            object.__setattr__(self, "mesh_shape", shape)
        if (self.hbm_bytes_per_chip is not None
                and self.hbm_bytes_per_chip < 1):
            raise ValueError(
                f"hbm_bytes_per_chip must be >= 1 or None, got "
                f"{self.hbm_bytes_per_chip}"
            )


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One resolved request: ``tokens`` is its generated row of length
    ``max_new_tokens`` (eos included where sampled, pad after it);
    ``num_generated`` counts real tokens; ``batch_size`` is the grid's
    ``num_slots`` (continuous) or the padded batch (batch scheduler);
    ``trace_id`` is the request's ``TraceContext`` id, if it carried one;
    ``handoff`` the KV handoff payload a ``submit(handoff_export=True)``
    request exported (``fleet/disagg.py`` describes its shape), else
    None."""

    tokens: np.ndarray
    num_generated: int
    bucket_len: int
    batch_size: int
    latency_seconds: float
    ttft_seconds: float = 0.0
    trace_id: Optional[str] = None
    handoff: Optional[dict] = None


#: eq=False: requests leave the middle of a queue by identity (QoS
#: admission, brownout shed).
@dataclasses.dataclass(eq=False)
class _Request:
    prompt: np.ndarray
    prompt_len: int
    max_new_tokens: int
    bucket_len: int
    future: Future
    submitted: float  # perf_counter
    deadline: Optional[float] = None
    #: QoS class (resolved at submit with QoS armed; inert without).
    priority: Optional[str] = None
    #: Per-token delivery (``submit(stream=True)``), fed as chunks commit.
    stream: Optional[TokenStream] = None
    #: ``on_token(index, token)``, called from the scheduler thread.
    on_token: Optional[object] = None
    trace: Optional[tracing.TraceContext] = None
    #: Disaggregated prefill leg: export the prompt's prefix chain after
    #: its prefill (``ServeResult.handoff``).
    handoff_export: bool = False
    #: Disaggregated decode leg: a payload to seed the prefix trie with
    #: before this request's own lookup.
    handoff: Optional[dict] = None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline

    @property
    def trace_id(self) -> Optional[str]:
        return self.trace.trace_id if self.trace is not None else None


def _trace_attrs(request: _Request, **attrs) -> dict:
    """Span attributes plus the request's ``trace_id`` when it carries a
    trace context."""
    if request.trace is not None:
        attrs["trace_id"] = request.trace.trace_id
    return attrs


@dataclasses.dataclass
class _Slot:
    """Host mirror of one claimed slot (scheduler thread only).
    ``prefix_nodes`` are the prefix-cache blocks it holds references on
    (the hit it reads, the blocks it saved), released when it retires;
    ``streamed`` counts the tokens delivered to its request's stream or
    hook."""

    request: _Request
    tokens: List[int]
    prefix_nodes: List[object] = dataclasses.field(default_factory=list)
    first_token_ts: Optional[float] = None
    streamed: int = 0
    #: The exported handoff payload (``handoff_export`` requests), carried
    #: to ``_retire_slot``, which puts it on the result.
    handoff: Optional[dict] = None


@dataclasses.dataclass
class _PrefillTask:
    """A request mid-prefill (chunked prefill or a prefix hit): its slot is
    claimed and tabled, decode has not started.  ``next_pos`` is the first
    prompt position not prefilled yet; the loop advances the oldest task
    one ``chunk_width`` chunk per pass."""

    request: _Request
    slot: int
    chunk_width: int
    next_pos: int
    #: The acquired prefix hit, or None for a cold prefill.
    hit: Optional[PrefixHit] = None


@dataclasses.dataclass
class _InflightChunk:
    """One dispatched, not yet drained chunk of the pipelined scheduler's
    ring (``pipeline_depth=2``; scheduler thread only).  ``host`` is its
    own host buffer (pinned on the card) receiving ``[tokens, valid,
    summary]`` as one flat int32 copy enqueued right after the chunk, and
    ``event`` (None on the CPU, where the copy has run) is recorded after
    that copy.  A slot with a row here is never free: it retires at the
    drain."""

    host: torch.Tensor
    event: Optional[object]
    #: Emission width: ``chunk_tokens`` (decode) or ``spec_k`` (verify).
    width: int
    #: ``"chunk"`` or ``"verify"``: the span name and the stats at drain.
    kind: str
    #: Active slots at dispatch (the verify's acceptance denominator).
    active: int
    span_attrs: dict
    dispatch_start: float
    dispatch_end: float


class _DeferredPayload:
    """A demoted block's host bytes, downloaded when its burst ends
    (``ServingEngine._demote_burst``).  On a slice the bytes are each
    rank's heads, kept by every rank under ``tag``
    (``ServingEngine._tier``)."""

    __slots__ = ("value", "filled", "tag", "__weakref__")

    def __init__(self, tag: Optional[int] = None):
        self.value = None
        self.filled = False
        self.tag = tag


def _resolve_payload(payload):
    """A demoted block's host tensors (a burst's placeholder unwrapped)."""
    if isinstance(payload, _DeferredPayload):
        if not payload.filled:
            raise RuntimeError(
                "deferred demote payload read before its burst flushed")
        return payload.value
    return payload


def _check_quantized_leaves(tree, path="params"):
    """Every ``*_q`` leaf is int8 with its ``*_scale`` beside it: a
    malformed tree fails here, not in the scheduler thread."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            if key.endswith("_q") and isinstance(value, torch.Tensor):
                scale = tree.get(f"{key[:-2]}_scale")
                if value.dtype != torch.int8 or scale is None:
                    raise ValueError(
                        f"{path}/{key}: an int8 weight needs dtype int8 and "
                        f"its {key[:-2]}_scale leaf (quantize_params makes "
                        f"both); got {value.dtype}"
                        f"{'' if scale is not None else ' and no scale'}")
            _check_quantized_leaves(value, f"{path}/{key}")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            _check_quantized_leaves(value, f"{path}/{i}")


def _signature(x):
    """What a JAX retrace keys on, for a program argument: a tensor's
    shape, dtype and device; a container's structure; any other value
    itself (static arguments)."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype), str(x.device))
    if isinstance(x, dict):
        return tuple((key, _signature(x[key])) for key in sorted(x))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    if isinstance(x, torch.Generator):
        return ("generator", str(x.device))
    return repr(x)


class ServingEngine:
    """In-process serving over ``generation``: the continuous scheduler,
    or the batch scheduler with ``scheduler="batch"``.  Construct,
    ``submit()`` from any thread, ``close()`` when done (or use as a
    context manager).  Runs on ``device`` (default ``cuda``).

    Under a serving mesh (``ServeConfig.mesh_shape``/``layout="auto"``, or
    ``mesh=`` a ``parallel.mesh.Mesh`` whose nontrivial axes are ``tp``
    and ``sp``) the engine is one rank of a serving slice (``serving/
    slice.py``) on the mesh's device.  ``params`` are the full params
    (each rank cuts its shard by ``rules``, default
    ``parallel.sharding.DEFAULT_RULES``) or a shard that carries its
    ``"tp"`` context (``bridge.to_torch_shard``).  Rank 0 serves; on every
    other rank of a caller's mesh, construct the engine the same way and
    call :meth:`follow`."""

    def __init__(self, params, config, serve_config: Optional[ServeConfig] = None,
                 *, rules=None, mesh=None, device=None, start: bool = True):
        _check_quantized_leaves(params)
        self.config = config
        self.serve_config = cfg = serve_config or ServeConfig()
        self.rules = rules if rules is not None else sharding.DEFAULT_RULES
        self.mesh = mesh if mesh is not None else mesh_lib.get_global_mesh()
        #: The tensor-parallel context of the programs (None: one card).
        self._tp = None
        #: The slice's plan channel (a slice of more than one rank).
        self._link: Optional[slice_lib.ControlLink] = None
        #: Followers this engine spawned (``mesh_shape``/``layout``).
        self._spawned: Optional[slice_lib.SpawnedSlice] = None
        #: A rank of a slice other than 0: it runs ``follow()``.
        self._follower = False
        self._slice_shape, self._slice_chips = self._resolve_serving_mesh(
            params, device)
        self.params = generation.prepare_params(self._place_params(params),
                                                config)
        if self._slice_chips > 1:
            self._link = slice_lib.ControlLink(self.mesh,
                                               leader=not self._follower)
        self._params_signature = _signature(self.params)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(cfg.seed)
        metrics.gauge_set("serve/slice_chips", self._slice_chips)
        #: Logits of the last prefill chunk (what its finalize samples).
        self._chunk_logits = None
        #: The batch scheduler's prefilled batch, awaiting its decode.
        self._batch_prefilled = None

        self._cond = threading.Condition()
        #: bucket_len -> FIFO of waiting requests (guarded by _cond).
        self._pending: Dict[int, collections.deque] = {}
        self._waiting = 0
        self._closed = False
        self._draining = True
        self._thread: Optional[threading.Thread] = None
        #: Why the engine is unhealthy (watchdog fire, scheduler crash).
        self._unhealthy_reason: Optional[str] = None
        #: Dispatch threads the watchdog gave up on, joined by close().
        self._orphan_dispatches: List[threading.Thread] = []
        self._last_dispatch_ts: Optional[float] = None
        #: Timeline lane the scheduler stamps its spans with (None: the
        #: process's own row).
        self._trace_lane: Optional[int] = None
        #: Rows of the batch on the device (batch scheduler).
        self._inflight_rows = 0
        self._stats_lock = threading.Lock()
        self._stats = {
            "requests": 0, "completed": 0, "failed": 0, "rejected": 0,
            "batches": 0, "slots": 0, "real_rows": 0,
            "generated_tokens": 0,
            "decode_slot_steps": 0, "useful_decode_tokens": 0,
            "inserts": 0, "retires": 0, "expired": 0, "chunks": 0,
            "prefill_chunks": 0, "prefix_hits": 0, "prefix_misses": 0,
            "prefix_attaches": 0,
            "shed": 0, "watchdog_timeouts": 0, "traced": 0,
            "brownout_shed": 0,
            # The port's own additions: host wall time of decode chunks
            # (depth 1: dispatch through the host copy of their emissions;
            # depth 2: the dispatch call plus the wait at its drain), the
            # one-shot inserts (one flash-attention prefill each; the
            # other inserts are armed by a chunked prefill's finalize),
            # the decode steps the batch scheduler ran, the prefill chunks
            # by width, and the whole-stream synchronisations of the host
            # tier (one per demotion burst).  On a slice spanning sp, the
            # one-shot prefills (inserts and batches) split over sp and
            # those of a width sp does not divide, run whole.
            "chunk_seconds": 0.0, "oneshot_inserts": 0,
            "sp_prefills": 0, "sp_whole_prefills": 0,
            "batch_decode_steps": 0,
            "prefill_chunk_widths": {},
            "stream_syncs": 0,
            # Speculative decoding (0 with draft=None): spec_chunks are
            # verify rounds, spec_emitted the tokens they committed,
            # spec_proposed/spec_accepted the draft tokens offered and
            # committed; acceptance is their quotient.
            "spec_chunks": 0, "spec_emitted": 0,
            "spec_proposed": 0, "spec_accepted": 0, "draft_prefills": 0,
            # Disaggregated serving's KV handoff (0 without handoff
            # submits).
            **dict.fromkeys(HANDOFF_KEYS, 0),
        }
        #: Disaggregated-serving role, advertised in health()/stats() for
        #: the fleet's router (a replica may restamp it: ``set_role``).
        self._role = cfg.role
        #: QoS: None keeps admission FIFO.  Per-class counters are zeros
        #: without it.
        self._qos = cfg.qos
        self._qos_sched = (qos_lib.QosScheduler(self._qos) if self._qos
                           else None)
        self._class_names = (tuple(self._qos.classes) if self._qos
                             else qos_lib.DEFAULT_PRIORITIES)
        self._class_completed = {c: 0 for c in self._class_names}
        self._class_shed = {c: 0 for c in self._class_names}
        self._qps = metrics.WindowedRate("serve/qps", window=16)
        self._tokens_rate = metrics.WindowedRate("serve/tokens_per_sec",
                                                 window=256)
        #: Rolling dispatch->dispatch host gaps (ms) between chunks.
        self._dispatch_gaps: collections.deque = collections.deque(maxlen=512)
        self._last_chunk_dispatch_end: Optional[float] = None
        #: The distinct argument signatures the decode-chunk and verify
        #: programs were dispatched with (``chunk_traces``,
        #: ``verify_traces``).
        self._signatures: Dict[str, set] = {"chunk": set(), "verify": set()}

        self._continuous = cfg.scheduler == "continuous"
        #: Effective pipelining depth (1 on the batch scheduler).
        self._pipe_depth = cfg.pipeline_depth if self._continuous else 1
        #: Dispatched, not yet drained chunks, oldest first (scheduler
        #: thread only; always empty at depth 1).
        self._inflight: collections.deque = collections.deque()
        self._slot_table: List[Optional[_Slot]] = []
        self._free_slots: List[int] = []
        self._active_slots: set = set()
        self._prefill_tasks: collections.deque = collections.deque()
        self._prefix: Optional[PrefixCacheManager] = None
        self._prefix_pool = None
        #: Open demotion burst: demote downloads wait here and run at its
        #: end (scheduler thread only).
        self._demote_batch: Optional[List[tuple]] = None
        #: Prefix hits attach pool blocks through the block table
        #: (``decode_kernel`` "pallas"/"auto") instead of being copied.
        self._paged = cfg.decode_kernel != "xla"
        #: Speculative decoding: the draft's params and slot cache, and
        #: (accepted, proposed) of the last 64 rounds for health().
        self._spec = cfg.draft is not None
        self._draft_params = None
        self._draft_cache = None
        #: The last draft round's verify window (every rank of a slice).
        self._window = None
        self._accept_window: collections.deque = collections.deque(maxlen=64)
        #: A slice's host tier: every rank's host copy of its heads of each
        #: demoted block, by the tag rank 0's placeholder carries; the tags
        #: whose placeholder rank 0's manager has dropped since the last
        #: plan (sent with the next one).
        self._tier: Dict[int, dict] = {}
        self._tier_tags = itertools.count()
        self._tier_dropped: List[int] = []
        if self._continuous:
            self._max_len = cfg.prompt_buckets[-1] + cfg.max_new_tokens
            # The grid is updated in place by every program (the JAX
            # engine donates it through each dispatch to the same effect).
            self._grid_cache = generation.init_slot_cache(
                config, cfg.num_slots, self._max_len, device=self.device,
                kv_quant=cfg.kv_quant, tp=self._tp)
            self._slot_state = generation.init_slot_state(
                config, cfg.num_slots, sample=cfg.sample, device=self.device)
            #: Page p of slot b reads pool block ``table[b, p]`` (>= 0) or
            #: the slot row (-1); every decode and prefill chunk reads the
            #: cache through the paged kernel with it.
            self._n_pages = -(-self._max_len // cfg.prefix_block_tokens)
            self._block_table = torch.full(
                (cfg.num_slots, self._n_pages), -1, dtype=torch.int32,
                device=self.device)
            self._slot_table = [None] * cfg.num_slots
            self._free_slots = list(range(cfg.num_slots))[::-1]
            if cfg.prefix_cache_blocks:
                self._prefix = PrefixCacheManager(
                    cfg.prefix_cache_blocks, cfg.prefix_block_tokens,
                    dram_blocks=cfg.prefix_dram_blocks,
                    demote_fn=(self._demote_block if cfg.prefix_dram_blocks
                               else None),
                    summary_ttl_s=cfg.prefix_summary_ttl_s)
                self._prefix_pool = generation.init_prefix_pool(
                    config, cfg.prefix_cache_blocks, cfg.prefix_block_tokens,
                    device=self.device, kv_quant=cfg.kv_quant, tp=self._tp)
            if self._spec:
                self._init_draft()
        self._warmup_thread: Optional[threading.Thread] = None
        #: A slice's warmup runs on its scheduler thread, first, in
        #: lockstep with the followers; set when it has run.
        self._warmup_done = threading.Event()
        self._slice_warmup = cfg.warmup and self._link is not None
        if cfg.warmup and self._link is None:
            self._warmup_thread = threading.Thread(
                target=self._warmup, daemon=True,
                name=SERVE_WARMUP_THREAD_NAME)
            self._warmup_thread.start()
        if start:
            self.start()

    # -- the serving slice -------------------------------------------------

    def _resolve_serving_mesh(self, params, device
                              ) -> Tuple[Tuple[int, int], int]:
        """The replica's slice ``((tp, sp), chips)`` and its device, as the
        JAX engine resolves it: without ``mesh_shape``/``layout="auto"`` a
        caller's mesh is honoured (its ``tp x sp`` extent; a mesh with
        other axes is no serving slice), and no mesh is the one-card
        engine; with them, the slice spans the first ``tp * sp`` visible
        devices (``parallel.mesh.visible_devices``: the cards, or one
        rank per core on the CPU), the layout planned by
        ``parallel.planner.plan_serve_layout`` for ``layout="auto"``."""
        cfg = self.serve_config
        wants = cfg.layout == "auto" or (
            cfg.mesh_shape is not None and cfg.mesh_shape != (1, 1))
        self._spawn_devices = None
        #: The programs run on a tensor-parallel shard.
        self._sharded = False
        if not wants:
            if self.mesh is None:
                self.device = resolve_device(device)
                return SLICE_SHAPE, SLICE_CHIPS
            if not isinstance(self.mesh, mesh_lib.Mesh):
                raise TypeError(
                    f"mesh= takes a cloud_tpu_torch.parallel.mesh.Mesh "
                    f"(MeshSpec.build), got {type(self.mesh).__name__}")
            axes = set(self.mesh.spec.nontrivial_axes())
            serving = {mesh_lib.AXIS_TP, mesh_lib.AXIS_SP}
            if axes - serving:
                if axes & serving:
                    raise ValueError(
                        f"a serving mesh spans tp (and sp) only; got axes "
                        f"{sorted(axes)}")
                # A training mesh reaching the engine is no slice.
                self.device = resolve_device(device)
                return SLICE_SHAPE, SLICE_CHIPS
            if device is not None and resolve_device(device) != (
                    self.mesh.device):
                raise ValueError(
                    f"device={device} disagrees with the mesh's device "
                    f"{self.mesh.device} for rank {self.mesh.rank}")
            self.device = resolve_device(self.mesh.device)
            tp = self.mesh.axis_size(mesh_lib.AXIS_TP)
            sp = self.mesh.axis_size(mesh_lib.AXIS_SP)
            self._follower = self.mesh.rank != 0
            self._sharded = True
            return (tp, sp), tp * sp
        if self.mesh is not None:
            raise ValueError(
                "pass either an explicit mesh= or "
                "ServeConfig.mesh_shape/layout='auto', not both — the "
                "engine builds its own serving mesh from the config"
            )
        self.device = resolve_device(device)
        devices = mesh_lib.visible_devices(self.device.type)
        bound = len(devices)
        if cfg.mesh_shape is not None:
            want = cfg.mesh_shape[0] * cfg.mesh_shape[1]
            if want > bound:
                raise ValueError(
                    f"mesh_shape={cfg.mesh_shape} needs {want} "
                    f"device(s); only {bound} visible"
                )
        num_heads = int(self.config.num_heads)
        if cfg.layout == "auto":
            draft_bytes = 0
            if cfg.draft is not None:
                draft_bytes = quantization.param_bytes(cfg.draft.params) + (
                    self._kv_bytes_estimate(cfg.draft.config,
                                            include_prefix=False))
            plan = planner.plan_serve_layout(
                num_heads=num_heads,
                num_devices=(
                    cfg.mesh_shape[0] * cfg.mesh_shape[1]
                    if cfg.mesh_shape is not None else bound
                ),
                param_bytes=quantization.param_bytes(params),
                kv_bytes=self._kv_bytes_estimate(),
                draft_bytes=draft_bytes,
                hbm_bytes_per_chip=cfg.hbm_bytes_per_chip,
            )
            tp, sp = plan.tp, plan.sp
            logger.info("serving layout auto-picked: %s", plan.description)
        else:
            tp, sp = cfg.mesh_shape
            if num_heads % tp:
                raise ValueError(
                    f"mesh_shape tp={tp} does not divide "
                    f"num_heads={num_heads}: the slot KV cache shards "
                    "by attention head, so the tensor-parallel degree "
                    "must divide the model's head count"
                )
        chips = tp * sp
        if chips <= 1:
            return SLICE_SHAPE, SLICE_CHIPS
        if self.device.type == "cuda":
            devices = [torch.device("cuda", i) for i in range(chips)]
            self.device = devices[0]
        self._spawn_devices = devices[:chips]
        self._sharded = True
        return (tp, sp), chips

    def _kv_bytes_estimate(self, model_config=None,
                           include_prefix: bool = True) -> int:
        """Total KV bytes the engine will allocate (slot grid + prefix
        pool for the continuous scheduler, the largest batch cell
        otherwise): the planner's auto-layout input, an estimate, not an
        allocator.  ``model_config`` sizes another model's cache over the
        same grid (the speculative draft, no prefix pool)."""
        cfg = self.serve_config
        c = model_config if model_config is not None else self.config
        itemsize = 1 if cfg.kv_quant else torch.empty(
            (), dtype=c.dtype).element_size()
        per_pos = 2 * c.num_layers * c.num_heads * (
            c.head_dim * itemsize + (4 if cfg.kv_quant else 0))
        max_len = cfg.prompt_buckets[-1] + cfg.max_new_tokens
        if cfg.scheduler == "continuous":
            positions = cfg.num_slots * max_len
            if include_prefix:
                positions += cfg.prefix_cache_blocks * cfg.prefix_block_tokens
        else:
            positions = cfg.batch_buckets[-1] * max_len
        return per_pos * positions

    def _place_params(self, params):
        """The params this rank serves, on its device: the caller's, or
        under a serving mesh this rank's shard with its ``"tp"`` context
        (cut here from full params, or given as a shard).  A
        ``mesh_shape``/``layout`` slice cuts every rank's shard on the
        host over the mesh ``{sp, tp}`` and spawns the followers with
        theirs."""
        def to_device(tree):
            return bridge.map_leaves(tree, lambda t: t.to(self.device))

        if not self._sharded:
            return to_device(params)
        full = {k: v for k, v in params.items() if k != "tp"}
        if self._spawn_devices is not None:
            tp, sp = self._slice_shape
            spec = mesh_lib.MeshSpec({mesh_lib.AXIS_SP: sp,
                                      mesh_lib.AXIS_TP: tp})
            backend = dist_lib.backend_for(self.device)
            host = bridge.map_leaves(full, lambda t: t.detach().cpu())
            shards = [
                {k: v for k, v in tensor_parallel.shard_lm(
                    host, self.config, view, self.rules).items() if k != "tp"}
                for view in slice_lib.shard_views(spec, self._spawn_devices,
                                                  backend)]
            follower_cfg = dataclasses.replace(
                self.serve_config, mesh_shape=None, layout="explicit",
                hbm_bytes_per_chip=None)
            if follower_cfg.draft is not None:
                # Each follower cuts (or copies) its own draft from these.
                follower_cfg = dataclasses.replace(
                    follower_cfg, draft=dataclasses.replace(
                        follower_cfg.draft, params=bridge.map_leaves(
                            {k: v for k, v in follower_cfg.draft.params.items()
                             if k != "tp"}, lambda t: t.detach().cpu())))
            self.mesh, self._spawned = slice_lib.spawn_slice(
                shards, self.config, follower_cfg, self.rules,
                self._spawn_devices, backend, spec)
            own = shards[0]
        elif "tp" in params:
            own = full
        else:
            own = {k: v for k, v in tensor_parallel.shard_lm(
                full, self.config, self.mesh, self.rules).items()
                if k != "tp"}
        self._tp = tensor_parallel.context(self.mesh, self.config, self.rules)
        own = to_device(own)
        own["tp"] = self._tp
        return own

    def _lockstep(self, op: str, **args):
        """Run device program ``op`` (``_op_<op>``) on ``args`` (host
        values); on a slice's rank 0, tell the followers to run it first.
        On a slice any failure leaves the ranks out of step: it raises
        :class:`~cloud_tpu_torch.serving.slice.SliceError`."""
        fn = getattr(self, "_op_" + op)
        if self._link is None:
            return fn(**args)
        try:
            self._link.send(op, args)
            return fn(**args)
        except Exception as exc:
            dead = self._spawned.dead() if self._spawned is not None else None
            raise slice_lib.SliceError(
                f"serving slice failed in {op!r}"
                + (f" ({dead})" if dead else "") + f": {exc!r}") from exc

    def follow(self) -> None:
        """Serve rank 0's plans on this rank until rank 0 closes the
        slice: the whole life of a rank other than 0 of a caller's mesh
        (spawned followers run it themselves).  Raises when rank 0's
        connection breaks."""
        if not self._follower:
            raise RuntimeError(
                "follow() runs on the ranks of a serving slice other than 0")
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        try:
            with torch.no_grad():
                while True:
                    op, args = self._link.recv()
                    if op == "stop":
                        return
                    getattr(self, "_op_" + op)(**args)
        finally:
            self._closed = True

    def _reshard(self, what: str):
        """The span of a slice's host pull of sampled tokens (the
        sampling boundary's reshard); nothing on one card."""
        if self._slice_chips > 1:
            return tracing.span("serve/reshard", what=what,
                                chips=self._slice_chips)
        return contextlib.nullcontext()

    def _init_draft(self) -> None:
        """Arm draft-and-verify: check the draft against the target, put
        its params on the device and give it a slot cache of the grid's
        shape (int8 with ``kv_quant``, as the target's)."""
        cfg = self.serve_config
        dcfg = cfg.draft.config
        if int(dcfg.vocab_size) != int(self.config.vocab_size):
            raise ValueError(
                f"draft vocab_size={dcfg.vocab_size} != target "
                f"vocab_size={self.config.vocab_size}: acceptance "
                "compares token ids, so the two models must share a "
                "vocabulary"
            )
        _check_quantized_leaves(cfg.draft.params, "draft.params")
        tp = cfg.draft.params.get("tp")
        full = {k: v for k, v in cfg.draft.params.items() if k != "tp"}
        if self._draft_sharded and tp is None:
            # Head-sharded as the target: this rank's shard of the draft
            # (cut here from full params, or given as a shard), its grid
            # of this rank's heads, the target's collectives.
            full = tensor_parallel.shard_lm(
                bridge.map_leaves(full, lambda t: t.detach().cpu()), dcfg,
                self.mesh, self.rules)
            tp = full.pop("tp")
        params = bridge.map_leaves(full, lambda t: t.to(self.device))
        if tp is not None:
            params["tp"] = tp
        self._draft_params = generation.prepare_params(params, dcfg)
        self._draft_cache = self._new_draft_cache()

    @property
    def _draft_sharded(self) -> bool:
        """On a slice, whether the draft is head-sharded as the target
        (``tp`` divides its heads, as the JAX engine decides); otherwise
        every rank holds the whole draft and runs it unsharded."""
        return (self._slice_chips > 1 and self.serve_config.draft is not None
                and int(self.serve_config.draft.config.num_heads)
                % self._slice_shape[0] == 0)

    def _new_draft_cache(self):
        """A zeroed draft slot cache of the grid's shape (the rank's heads
        when the draft is head-sharded)."""
        cfg = self.serve_config
        return generation.init_slot_cache(
            cfg.draft.config, cfg.num_slots, self._max_len,
            device=self.device, kv_quant=cfg.kv_quant,
            tp=self._draft_params.get("tp"))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServingEngine":
        """Launch the scheduler thread (idempotent; a follower has none:
        it runs :meth:`follow`)."""
        if self._follower:
            return self
        with self._cond:
            if self._closed:
                raise EngineClosedError("engine already closed")
            if self._thread is not None:
                return self
            self._thread = threading.Thread(
                target=self._scheduler_loop, daemon=True,
                name=SERVE_SCHEDULER_THREAD_NAME,
            )
            self._thread.start()
        return self

    def _warmup(self) -> None:
        """Build the serving kernels, then run each program once at the
        engine's shapes on scratch state with its own generator, thrown
        away after, so no request's slot, cache, pool or sampling state is
        touched and no token changes.  Continuous: one insert per prompt
        bucket (without chunked prefill), one prefill chunk per chunk
        width and its finalize (with the prefix cache or chunked prefill),
        and one decode chunk (with a draft: one draft prefill per prompt
        bucket, one draft chunk and one verify instead), dispatched as the
        scheduler dispatches them.  Batch: each batch bucket once, at the
        largest prompt bucket.  A failure is logged; the programs then run
        cold."""
        try:
            self._op_warmup()
        except Exception:  # noqa: BLE001 — logged; serving still works
            logger.exception("serving warmup failed; programs run cold")

    def _op_warmup(self) -> None:
        """The warmup's device work (:meth:`_warmup`), on every rank of a
        slice in lockstep."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            dispatch.build_all(SERVING_LIBRARIES)
        cfg = self.serve_config
        generator = torch.Generator(device=self.device)
        with torch.no_grad():
            if not self._continuous:
                bucket_len = cfg.prompt_buckets[-1]
                for batch_size in cfg.batch_buckets:
                    tokens = torch.ones((batch_size, bucket_len),
                                        dtype=torch.int32,
                                        device=self.device)
                    lens = torch.full((batch_size,), bucket_len,
                                      dtype=torch.int32,
                                      device=self.device)
                    cache, logits0 = generation.prefill_program(
                        self.params, tokens, lens, self.config,
                        max_new_tokens=cfg.max_new_tokens,
                        kv_quant=cfg.kv_quant)
                    generation.decode_program(
                        self.params, cache, logits0, lens, self.config,
                        max_new_tokens=cfg.max_new_tokens,
                        sample=cfg.sample, generator=generator,
                    )["tokens"].cpu()
                return
            cache = generation.init_slot_cache(
                self.config, cfg.num_slots, self._max_len,
                device=self.device, kv_quant=cfg.kv_quant, tp=self._tp)
            state = generation.init_slot_state(
                self.config, cfg.num_slots, sample=cfg.sample,
                device=self.device)
            table = torch.full_like(self._block_table, -1)
            if cfg.prefill_chunk_tokens is None:
                for bucket_len in cfg.prompt_buckets:
                    tokens = torch.ones((1, bucket_len),
                                        dtype=torch.int32)
                    cache, state, _ = generation.insert_slot_program(
                        self.params, cache, state, tokens, bucket_len,
                        0, cfg.max_new_tokens, self.config,
                        sample=cfg.sample, generator=generator)
            for width in self._chunk_widths():
                tokens = torch.ones((1, width), dtype=torch.int32)
                cache, logits = generation.prefill_chunk_program(
                    self.params, cache, tokens, 0, width, 0,
                    self.config, block_table=table)
                state, _ = generation.finalize_slot_program(
                    state, logits, width, 0, cfg.max_new_tokens,
                    self.config, sample=cfg.sample, generator=generator)
            if self._spec:
                dcfg = cfg.draft.config
                draft_cache = self._new_draft_cache()
                for bucket_len in cfg.prompt_buckets:
                    generation.draft_prefill_slot_program(
                        self._draft_params, draft_cache,
                        torch.ones((1, bucket_len), dtype=torch.int32),
                        bucket_len, 0, dcfg)
                _, window = generation.draft_chunk_program(
                    self._draft_params, draft_cache, state, dcfg,
                    spec_k=cfg.draft.spec_k)
                toks = self._verify_program(cache, state, window,
                                            table)[2]
            else:
                toks = self._chunk_program(cache, state, generator,
                                           table)[2]
            toks.cpu()  # the card has run it

    def _chunk_widths(self) -> Tuple[int, ...]:
        """The prefill-chunk widths this engine dispatches: the chunk
        width with chunked prefill, each prompt bucket (a suffix after a
        hit) with only the prefix cache, none otherwise."""
        cfg = self.serve_config
        if cfg.prefill_chunk_tokens is not None:
            return (cfg.prefill_chunk_tokens,)
        return cfg.prompt_buckets if self._prefix is not None else ()

    def wait_ready(self, timeout: Optional[float] = None) -> None:
        """Block until the warmup has run (no-op without
        ``warmup=True``)."""
        if self._warmup_thread is not None:
            self._warmup_thread.join(timeout)
        elif self._slice_warmup and not self._follower:
            self._warmup_done.wait(timeout)

    def set_trace_lane(self, lane: Optional[int]) -> None:
        """Adopt a timeline lane (``tracing.register_lane``): the
        scheduler thread stamps its spans with ``pid=lane`` from its next
        pass on (None: the process's own row)."""
        self._trace_lane = lane

    def set_role(self, role: str) -> None:
        """Adopt a disaggregated-serving role (``"prefill"``, ``"decode"``
        or ``"both"``), advertised through ``health()``/``stats()`` for
        the fleet's router and validated as the ``ServeConfig`` field is.
        The fleet's replica calls it after building the engine."""
        if role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"role must be 'prefill', 'decode' or 'both', got {role!r}"
            )
        if role != "both" and (not self._continuous
                               or not self.serve_config.prefix_cache_blocks):
            raise ValueError(
                "role= (disaggregated serving) needs the continuous "
                "scheduler and prefix_cache_blocks > 0 — the KV handoff "
                "exports/imports prefix-pool blocks"
            )
        self._role = role

    @property
    def chunk_traces(self) -> int:
        """How many distinct argument signatures (shapes, dtypes, device,
        static keywords) the decode-chunk program was dispatched with in
        the engine's life: what a JAX retrace counts.  1 after any amount
        of traffic means one program served the run; 0 on the batch
        scheduler and when speculating."""
        return len(self._signatures["chunk"])

    @property
    def verify_traces(self) -> int:
        """The same count for the speculative verify program (0 with
        ``draft=None``)."""
        return len(self._signatures["verify"])

    def close(self, drain: bool = True, timeout: Optional[float] = None
              ) -> None:
        """Stop the engine: no more admissions.  ``drain=True`` serves every
        admitted request first; ``drain=False`` fails waiting and in-flight
        requests with :class:`EngineClosedError`.  Joins the scheduler,
        the warmup worker and any dispatch the watchdog gave up on (a
        finite hang unwinds here; a wedged one is left after a bounded
        join)."""
        with self._cond:
            self._closed = True
            self._draining = drain
            if not drain or self._thread is None:
                self._fail_pending_locked(
                    EngineClosedError("engine closed before dispatch"))
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout)
        self.wait_ready(timeout)
        for orphan in self._orphan_dispatches:
            orphan.join(timeout if timeout is not None else 60.0)
        self._orphan_dispatches = [
            t for t in self._orphan_dispatches if t.is_alive()]
        self._close_slice(thread is None or not thread.is_alive())
        now = time.perf_counter()
        self._qps.flush(now)
        self._tokens_rate.flush(now)

    def _close_slice(self, quiet: bool) -> None:
        """Rank 0 of a slice: tell the followers to stop (once, and only
        when no dispatch of ours can still be running: ``quiet``), then
        join the followers it spawned and drop its process group."""
        link, self._link = self._link, None
        if link is None or self._follower:
            self._link = link
            return
        if quiet and not self._orphan_dispatches:
            try:
                link.send("stop", {})
            except Exception:  # noqa: BLE001 — a dead follower: logged
                logger.exception("could not stop the serving slice")
        if self._spawned is not None:
            self._spawned.close()

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- submission --------------------------------------------------------

    @property
    def max_prompt_len(self) -> int:
        return self.serve_config.prompt_buckets[-1]

    def submit(self, prompt, *, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None,
               priority: Optional[str] = None, stream: bool = False,
               on_token=None, trace: Optional[tracing.TraceContext] = None,
               handoff_export: bool = False,
               handoff: Optional[dict] = None):
        """Enqueue one prompt (1-D token ids, length 1 ..
        ``prompt_buckets[-1]``); returns a Future of :class:`ServeResult`,
        or with ``stream=True`` a ``serving.qos.TokenStream`` fed per
        committed token (the batch scheduler delivers at completion).
        ``max_new_tokens`` may be below the engine-wide budget.  Blocks or
        raises :class:`QueueFullError` at ``max_queue`` per the admission
        policy; ``deadline_s`` bounds the queue wait.  ``priority`` names
        the request's QoS class (with ``qos`` armed it orders admission;
        without, it is type-checked and inert); ``on_token(index, token)``
        is called from the scheduler thread as tokens commit; ``trace``
        (a ``monitoring.tracing.TraceContext``) stamps the request's spans
        and result with its id.  ``handoff_export=True`` marks a
        disaggregated prefill leg: the prompt's cached prefix blocks ride
        out on ``ServeResult.handoff``; ``handoff=<payload>`` a decode leg:
        the payload's blocks seed the prefix cache before the request's
        lookup, which then sees an ordinary hit.  Both need the continuous
        scheduler and the prefix cache."""
        cfg = self.serve_config
        if self._follower:
            raise RuntimeError(
                "this rank follows rank 0 of its serving slice: submit to "
                "rank 0's engine")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        if (handoff_export or handoff is not None) and self._prefix is None:
            raise ValueError(
                "handoff_export/handoff need the continuous scheduler "
                "and prefix_cache_blocks > 0 — the KV handoff moves "
                "prefix-pool blocks"
            )
        if self._qos is not None:
            priority = self._qos.resolve_priority(priority)
        else:
            priority = qos_lib.validate_priority(priority)
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1:
            raise ValueError(
                f"prompt must be 1-D token ids, got shape {prompt.shape}"
            )
        n = int(prompt.shape[0])
        if not 1 <= n <= self.max_prompt_len:
            raise ValueError(
                f"prompt length {n} outside [1, {self.max_prompt_len}] "
                f"(prompt_buckets={cfg.prompt_buckets})"
            )
        m = cfg.max_new_tokens if max_new_tokens is None else int(
            max_new_tokens)
        if not 1 <= m <= cfg.max_new_tokens:
            raise ValueError(
                f"max_new_tokens {m} outside [1, {cfg.max_new_tokens}]"
            )
        bucket_len = next(b for b in cfg.prompt_buckets if b >= n)
        submitted = time.perf_counter()
        token_stream = TokenStream() if stream else None
        request = _Request(
            prompt=prompt, prompt_len=n, max_new_tokens=m,
            bucket_len=bucket_len, future=Future(), submitted=submitted,
            deadline=None if deadline_s is None else submitted + deadline_s,
            priority=priority, stream=token_stream, on_token=on_token,
            trace=trace, handoff_export=handoff_export, handoff=handoff,
        )
        if token_stream is not None:
            token_stream.trace_id = request.trace_id
            # Every resolution (retire, shed, crash, close) goes through
            # the future: its callback closes the stream with the same
            # outcome and back-fills tokens the chunks did not deliver.
            request.future.add_done_callback(
                token_stream._complete_from_future)
        with self._cond:
            if self._closed:
                raise EngineClosedError("engine is closed")
            if self._waiting >= cfg.max_queue:
                if cfg.admission == "reject":
                    with self._stats_lock:
                        self._stats["rejected"] += 1
                    metrics.counter_inc("serve/rejected")
                    raise QueueFullError(
                        f"serving queue full ({cfg.max_queue} waiting); "
                        "retry with backoff or raise max_queue"
                    )
                while self._waiting >= cfg.max_queue and not self._closed:
                    self._cond.wait()
                if self._closed:
                    raise EngineClosedError("engine closed while blocked "
                                            "on admission")
            self._pending.setdefault(bucket_len, collections.deque()).append(
                request)
            self._waiting += 1
            self._cond.notify_all()
        with self._stats_lock:
            self._stats["requests"] += 1
            if trace is not None:
                self._stats["traced"] += 1
        metrics.counter_inc("serve/requests")
        return token_stream if token_stream is not None else request.future

    # -- queue -------------------------------------------------------------

    def _fail_pending_locked(self, exc: BaseException) -> None:
        failed = 0
        for queue_ in self._pending.values():
            while queue_:
                request = queue_.popleft()
                self._waiting -= 1
                failed += 1
                try:
                    request.future.set_exception(exc)
                except InvalidStateError:  # pragma: no cover - cancelled
                    pass
        if failed:
            with self._stats_lock:
                self._stats["failed"] += failed

    def _shed_expired_locked(self, now: float) -> None:
        shed = 0
        shed_classes: List[str] = []
        for queue_ in self._pending.values():
            if not queue_ or not any(r.expired(now) for r in queue_):
                continue
            kept = collections.deque()
            while queue_:
                request = queue_.popleft()
                if not request.expired(now):
                    kept.append(request)
                    continue
                self._waiting -= 1
                shed += 1
                if request.priority is not None:
                    shed_classes.append(request.priority)
                tracing.record_span(
                    "serve/shed", request.submitted, now,
                    **_trace_attrs(request, bucket=request.bucket_len,
                                   reason="deadline"))
                try:
                    request.future.set_exception(DeadlineExceededError(
                        f"request shed after waiting "
                        f"{now - request.submitted:.3f}s; deadline_s="
                        f"{request.deadline - request.submitted:.3f}"
                    ))
                except InvalidStateError:  # pragma: no cover - cancelled
                    pass
            queue_.extend(kept)
        if shed:
            metrics.counter_inc("serve/deadline_exceeded", shed)
            with self._stats_lock:
                self._stats["shed"] += shed
                if self._qos is not None:
                    for name in shed_classes:
                        self._class_shed[name] += 1
            self._cond.notify_all()

    def _shed_brownout_locked(self, now: float) -> None:
        """Class-aware load shedding (no-op unless
        ``qos.brownout_queue_depth`` is armed): while more requests wait
        than the brownout depth allows, shed the lowest-weight class
        first, newest first within a class (``qos.brownout_victims``),
        with :class:`~cloud_tpu_torch.serving.qos.BrownoutShedError`."""
        if (self._qos is None or self._qos.brownout_queue_depth is None
                or self._waiting <= self._qos.brownout_queue_depth):
            return
        waiting_at_trigger = self._waiting
        excess = waiting_at_trigger - self._qos.brownout_queue_depth
        victims = qos_lib.brownout_victims(
            (r for queue_ in self._pending.values() for r in queue_),
            excess, self._qos)
        for request in victims:
            self._pending[request.bucket_len].remove(request)
            self._waiting -= 1
            tracing.record_span(
                "serve/shed", request.submitted, now,
                **_trace_attrs(request, bucket=request.bucket_len,
                               reason="brownout",
                               priority=request.priority))
            try:
                request.future.set_exception(qos_lib.BrownoutShedError(
                    f"request shed under brownout: {waiting_at_trigger}"
                    f" waiting > brownout_queue_depth="
                    f"{self._qos.brownout_queue_depth} and "
                    f"{request.priority!r} is the lowest class still "
                    "queued"
                ))
            except InvalidStateError:  # pragma: no cover - cancelled
                pass
        if victims:
            metrics.counter_inc("serve/brownout_shed", len(victims))
            with self._stats_lock:
                self._stats["shed"] += len(victims)
                self._stats["brownout_shed"] += len(victims)
                for request in victims:
                    self._class_shed[request.priority] += 1
            self._cond.notify_all()

    def _pop_inserts_locked(self, inserts) -> None:
        """Claim one free slot per waiting request: oldest submit first
        across every bucket, or with QoS armed ``QosScheduler.select``'s
        pick (SLO slack, then weighted fairness debt) over the whole
        waiting set, charged to its class."""
        now = time.perf_counter()
        self._shed_expired_locked(now)
        if self._qos_sched is not None:
            self._shed_brownout_locked(now)
        popped = False
        while self._free_slots:
            if self._qos_sched is not None:
                request = self._qos_sched.select(
                    (r for queue_ in self._pending.values() for r in queue_),
                    now)
            else:
                request = min((q[0] for q in self._pending.values() if q),
                              key=lambda r: r.submitted, default=None)
            if request is None:
                break
            self._pending[request.bucket_len].remove(request)
            if self._qos_sched is not None:
                self._qos_sched.charge(
                    request.priority, self._qos.request_cost(
                        request.prompt_len, request.max_new_tokens))
            inserts.append((request, self._free_slots.pop()))
            self._waiting -= 1
            popped = True
        if popped:
            self._cond.notify_all()

    def _pop_batch_locked(self, now: float) -> Optional[List[_Request]]:
        """The batch-formation policy, the JAX engine's: (1) the bucket
        whose head has waited ``flush_deadline_s``, oldest head first;
        (2) any bucket with a full largest batch; (3) when a closed engine
        drains, anything left.  Up to a largest batch is taken from the
        chosen bucket."""
        self._shed_expired_locked(now)
        cfg = self.serve_config
        max_batch = cfg.batch_buckets[-1]
        chosen = None
        for queue_ in self._pending.values():
            if queue_ and now - queue_[0].submitted >= cfg.flush_deadline_s:
                if chosen is None or queue_[0].submitted < chosen[0].submitted:
                    chosen = queue_
        if chosen is None:
            chosen = next((q for q in self._pending.values()
                           if len(q) >= max_batch), None)
        if chosen is None and self._closed and self._draining:
            chosen = next((q for q in self._pending.values() if q), None)
        if chosen is None:
            return None
        batch = []
        while chosen and len(batch) < max_batch:
            batch.append(chosen.popleft())
        return batch

    def _earliest_deadline_locked(self) -> Optional[float]:
        """When the batch scheduler must wake next: the earliest flush
        deadline or request deadline."""
        flush = self.serve_config.flush_deadline_s
        deadlines = []
        for queue_ in self._pending.values():
            if queue_:
                deadlines.append(queue_[0].submitted + flush)
                deadlines.extend(r.deadline for r in queue_
                                 if r.deadline is not None)
        return min(deadlines) if deadlines else None

    # -- watchdog ----------------------------------------------------------

    def _watchdog_fire(self, label: str) -> DispatchTimeoutError:
        """Mark the engine unhealthy for ``label`` and count it; returns
        the error for the caller to raise."""
        timeout = self.serve_config.dispatch_timeout_s
        self._unhealthy_reason = (
            f"{label} exceeded dispatch_timeout_s={timeout}")
        metrics.counter_inc("serve/watchdog_timeouts")
        with self._stats_lock:
            self._stats["watchdog_timeouts"] += 1
        return DispatchTimeoutError(self._unhealthy_reason)

    def _supervised(self, label: str, fn):
        """Run one device dispatch under the watchdog (a plain call
        without ``dispatch_timeout_s``).  ``fn`` must end in the host wait
        for what it dispatched (a kernel launch returns at once; a wedged
        program shows at the wait).  It runs on a short-lived thread; past
        the budget the scheduler raises :class:`DispatchTimeoutError`
        (failing the dispatch's requests, then the engine through the
        crash path) and leaves the thread to ``close()``."""
        timeout = self.serve_config.dispatch_timeout_s
        self._last_dispatch_ts = time.perf_counter()
        if timeout is None:
            return fn()
        box: dict = {}
        done = threading.Event()
        device = self.device

        def runner():
            try:
                if device.type == "cuda":
                    torch.cuda.set_device(device)
                with torch.no_grad():
                    box["result"] = fn()
            except BaseException as exc:  # noqa: BLE001 — rethrown below
                box["error"] = exc
            finally:
                done.set()

        thread = threading.Thread(target=runner, daemon=True,
                                  name=SERVE_DISPATCH_THREAD_NAME)
        thread.start()
        if not done.wait(timeout):
            self._orphan_dispatches.append(thread)
            raise self._watchdog_fire(label)
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["result"]

    # -- scheduler ---------------------------------------------------------

    def _scheduler_loop(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.no_grad():
                if self._slice_warmup:
                    try:
                        self._lockstep("warmup")
                    finally:
                        self._warmup_done.set()
                if self._continuous:
                    self._continuous_loop()
                else:
                    self._batch_loop()
        except BaseException as exc:  # noqa: BLE001 — must not die silently
            logger.exception("serving scheduler crashed")
            if self._unhealthy_reason is None:
                self._unhealthy_reason = f"scheduler crashed: {exc!r}"
            with self._cond:
                self._closed = True
                self._fail_pending_locked(exc)
                self._cond.notify_all()
            if self._continuous:
                self._dispose_inflight()
                self._fail_live_slots(exc)

    def _batch_loop(self) -> None:
        """Form a batch (``_pop_batch_locked``), serve it, repeat; a failed
        batch fails its requests only, a watchdog timeout the engine."""
        while True:
            if self._trace_lane is not None:
                tracing.set_thread_lane(self._trace_lane)
            with self._cond:
                while True:
                    now = time.perf_counter()
                    batch = self._pop_batch_locked(now)
                    if batch is not None:
                        self._waiting -= len(batch)
                        self._cond.notify_all()  # admission space freed
                        break
                    if self._closed:
                        return
                    deadline = self._earliest_deadline_locked()
                    self._cond.wait(None if deadline is None
                                    else max(deadline - now, 1e-4))
            self._inflight_rows = len(batch)
            try:
                self._dispatch(batch)
            except Exception as exc:  # noqa: BLE001 — per-batch failure
                logger.exception("serving dispatch failed")
                metrics.counter_inc("serve/batch_errors")
                with self._stats_lock:
                    self._stats["failed"] += len(batch)
                for request in batch:
                    try:
                        request.future.set_exception(exc)
                    except InvalidStateError:  # pragma: no cover
                        pass
                if isinstance(exc, (DispatchTimeoutError,
                                    slice_lib.SliceError)):
                    # The next dispatch would hang the same way, or the
                    # slice's ranks are out of step.
                    raise
            finally:
                self._inflight_rows = 0

    def _dispatch(self, batch: List[_Request]) -> None:
        """Serve one batch: pad it to its batch bucket, prefill it
        (``prefill_program``), decode it (``decode_program``), copy the
        tokens to the host once, resolve every request."""
        cfg = self.serve_config
        bucket_len = batch[0].bucket_len
        n = len(batch)
        batch_size = next(b for b in cfg.batch_buckets if b >= n)
        form_start = time.perf_counter()
        for request in batch:
            tracing.record_span(
                "serve/queue_wait", request.submitted, form_start,
                **_trace_attrs(request, bucket=bucket_len))
        with tracing.span("serve/batch_form", bucket=bucket_len, rows=n,
                          batch=batch_size):
            tokens = np.zeros((batch_size, bucket_len), np.int32)
            lens = np.ones((batch_size,), np.int32)
            for i, request in enumerate(batch):
                tokens[i, :request.prompt_len] = request.prompt
                lens[i] = request.prompt_len

        def prefill():
            faults.fault_point("serve.prefill")
            self._lockstep("batch_prefill", tokens=tokens, lens=lens)

        with tracing.span("serve/prefill", bucket=bucket_len,
                          batch=batch_size):
            self._supervised("serve/prefill", prefill)

        def decode():
            faults.fault_point("serve.decode")
            out = self._lockstep("batch_decode")
            # The batch's one host sync: tokens and counts in one copy (a
            # wedged prefill shows here too: it runs before on the stream).
            with self._reshard("batch_tokens"):
                return torch.cat(
                    [out["tokens"], out["num_generated"][:, None]],
                    dim=1).to(torch.int32).cpu().numpy()

        with tracing.span("serve/decode", bucket=bucket_len,
                          batch=batch_size):
            host = self._supervised("serve/decode", decode)
        done = time.perf_counter()
        results = []
        generated = 0
        for i, request in enumerate(batch):
            m = request.max_new_tokens
            num = int(min(host[i, -1], m))
            generated += num
            result = ServeResult(
                tokens=host[i, :m].copy(), num_generated=num,
                bucket_len=bucket_len, batch_size=batch_size,
                latency_seconds=done - request.submitted,
                # The batch's tokens arrive all at once.
                ttft_seconds=done - request.submitted,
                trace_id=request.trace_id,
            )
            metrics.distribution_record("serve/latency_seconds",
                                        result.latency_seconds)
            if request.trace is not None:
                attrs = {"ttft_s": round(result.ttft_seconds, 6),
                         "tokens": num, "trace_id": request.trace.trace_id}
                if request.priority is not None:
                    attrs["priority"] = request.priority
                tracing.record_span("serve/request", request.submitted, done,
                                    **attrs)
            results.append(result)
        # Counted before the futures resolve, so a caller woken by one
        # sees its batch in stats().
        metrics.counter_inc("serve/batches")
        metrics.counter_inc("serve/generated_tokens", generated)
        metrics.gauge_set("serve/batch_occupancy", n / batch_size)
        self._qps.add(done, n)
        self._tokens_rate.add(done, generated)
        with self._stats_lock:
            self._stats["batches"] += 1
            self._stats["slots"] += batch_size
            self._stats["real_rows"] += n
            self._stats["completed"] += n
            self._stats["generated_tokens"] += generated
            self._stats["decode_slot_steps"] += batch_size * cfg.max_new_tokens
            self._stats["useful_decode_tokens"] += generated
            self._stats["batch_decode_steps"] += cfg.max_new_tokens - 1
            self._count_sp_prefill(bucket_len)
        for request, result in zip(batch, results):
            try:
                request.future.set_result(result)
            except InvalidStateError:  # pragma: no cover - cancelled
                pass

    def _op_batch_prefill(self, tokens: np.ndarray, lens: np.ndarray
                          ) -> None:
        """Prefill a padded batch (``prefill_program``) and keep its cache
        and first logits for :meth:`_op_batch_decode`."""
        lens_t = torch.from_numpy(lens).to(self.device)
        cache, logits0 = generation.prefill_program(
            self.params, torch.from_numpy(tokens).to(self.device), lens_t,
            self.config, max_new_tokens=self.serve_config.max_new_tokens,
            kv_quant=self.serve_config.kv_quant)
        self._batch_prefilled = (cache, logits0, lens_t)

    def _op_batch_decode(self):
        """Decode the prefilled batch to ``max_new_tokens``
        (``decode_program``)."""
        cfg = self.serve_config
        (cache, logits0, lens_t), self._batch_prefilled = (
            self._batch_prefilled, None)
        return generation.decode_program(
            self.params, cache, logits0, lens_t, self.config,
            max_new_tokens=cfg.max_new_tokens, sample=cfg.sample,
            generator=self._generator)

    def _continuous_loop(self) -> None:
        """Fill free slots from the queue, advance at most one prefill
        chunk, run one decode chunk, retire what finished, repeat: however
        long an arriving prompt, in-flight decode waits at most one
        prefill chunk.  At depth 2 the decode chunk is dispatched before
        the one before it drains."""
        while True:
            # Re-read each pass: a lane may be set after the thread starts.
            if self._trace_lane is not None:
                tracing.set_thread_lane(self._trace_lane)
            inserts: List[Tuple[_Request, int]] = []
            abort = False
            with self._cond:
                while True:
                    if self._closed and not self._draining:
                        abort = True
                        break
                    self._pop_inserts_locked(inserts)
                    if (inserts or self._active_slots or self._prefill_tasks
                            or self._inflight):
                        break
                    if self._closed:
                        return  # draining and nothing left to serve
                    self._cond.wait()
            if abort:
                self._prefill_tasks.clear()
                self._dispose_inflight()
                self._fail_live_slots(EngineClosedError(
                    "engine closed without draining in-flight requests"))
                return
            for idx, (request, slot) in enumerate(inserts):
                try:
                    self._admit_request(request, slot)
                except BaseException as exc:
                    # Popped but maybe not tabled yet: invisible to the
                    # crash handler, so fail them here before it runs.
                    failed = 0
                    for req, _ in inserts[idx:]:
                        try:
                            req.future.set_exception(exc)
                            failed += 1
                        except InvalidStateError:  # pragma: no cover
                            pass
                    if failed:
                        with self._stats_lock:
                            self._stats["failed"] += failed
                    raise
            if self._prefill_tasks:
                self._advance_prefill()
            if self._active_slots:
                if self._pipe_depth > 1:
                    # Dispatch ahead only while some slot can outlive the
                    # work in flight (its budget is known on the host; eos
                    # can only end it sooner).
                    if self._predict_survivors():
                        if self._spec:
                            self._dispatch_spec_chunk_async()
                        else:
                            self._dispatch_chunk_async()
                elif self._spec:
                    self._dispatch_spec_chunk()
                else:
                    self._dispatch_chunk()
            # The drain half (the ring is always empty at depth 1): keep
            # depth - 1 chunks in flight while a slot can outlive them,
            # else drain dry, so an idle engine and a graceful close see
            # every emission committed.
            while len(self._inflight) > (
                    self._pipe_depth - 1
                    if self._active_slots and self._predict_survivors()
                    else 0):
                self._drain_inflight()

    def _admit_request(self, request: _Request, slot: int) -> None:
        """Route a popped request into its claimed slot.  Without the
        prefix cache and chunked prefill: the one-shot insert.  Otherwise
        look up the longest cached prefix and pin it (with the host tier:
        swap its demoted blocks back in; an acquire that fails falls back
        to a cold prefill), copy or attach the hit, and queue a prefill
        task for the rest of the prompt."""
        cfg = self.serve_config
        use_chunks = cfg.prefill_chunk_tokens is not None
        self._set_table_row(slot, ())  # fresh claim: every page is the slot's
        # A decode leg seeds its payload's blocks first, so the lookup
        # below hits them; the seed's references drop once the acquire
        # holds its own.
        seed_held: List[object] = []
        if request.handoff is not None and self._prefix is not None:
            seed_held = self._import_handoff(request)
        hit = None
        held: List[object] = []
        swapin_plan = None
        if self._prefix is not None:
            with tracing.span(
                    "serve/prefix_lookup",
                    **_trace_attrs(request, bucket=request.bucket_len,
                                   slot=slot)) as lookup:
                candidate = self._prefix.match(request.prompt.tolist())
                faults.fault_point("serve.prefix_acquire")
                if candidate:
                    if cfg.prefix_dram_blocks:
                        with self._demote_burst():
                            swapin_plan = self._prefix.acquire_swapin(
                                candidate)
                        if swapin_plan is not None:
                            hit = candidate
                            held.extend(candidate.nodes)
                    elif self._prefix.acquire(candidate):
                        hit = candidate
                        held.extend(candidate.nodes)
                lookup.set_attribute("hit", hit is not None)
                lookup.set_attribute("hit_tokens",
                                     hit.tokens if hit is not None else 0)
                lookup.set_attribute("dram", bool(swapin_plan))
            if hit is not None:
                metrics.counter_inc("serve/prefix_hits")
                metrics.counter_inc("serve/prefix_hit_tokens", hit.tokens)
            else:
                metrics.counter_inc("serve/prefix_misses")
            with self._stats_lock:
                self._stats["prefix_hits" if hit is not None
                            else "prefix_misses"] += 1
        if seed_held:
            self._prefix.release(seed_held)
        if hit is None and not use_chunks:
            self._insert_request(request, slot)
            return
        tracing.record_span(
            "serve/queue_wait", request.submitted, time.perf_counter(),
            **_trace_attrs(request, bucket=request.bucket_len, slot=slot))
        # Tabled before any dispatch: a crash mid-prefill fails it too.
        self._slot_table[slot] = _Slot(request=request, tokens=[],
                                       prefix_nodes=held)
        if swapin_plan:
            self._dispatch_swapin(slot, swapin_plan, request)
        if hit is not None and hit.tokens:
            if self._paged:
                self._attach_prefix(request, slot, hit)
            else:
                self._dispatch_copy(request, slot, hit)
        width = cfg.prefill_chunk_tokens if use_chunks else request.bucket_len
        self._prefill_tasks.append(_PrefillTask(
            request=request, slot=slot, chunk_width=width,
            next_pos=hit.tokens if hit is not None else 0, hit=hit))

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, copied in stream order:
        through pinned memory and a non-blocking copy on the card (a
        pageable copy would synchronise the stream, draining the chunks
        in flight); the array itself on the CPU."""
        host = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _set_table_row(self, slot: int, blocks) -> None:
        """Point the leading pages of ``slot`` at pool ``blocks``, the
        rest at the slot row (stream-ordered after every dispatch that
        read the old row).  On a slice the plan is sent under the
        watchdog: a follower that hangs stalls it."""
        def send():
            self._lockstep("table_row", slot=slot,
                           blocks=[int(b) for b in blocks])

        if self._link is None:
            send()
        else:
            self._supervised("serve/table_row", send)

    def _op_table_row(self, slot: int, blocks: List[int]) -> None:
        row = np.full((self._n_pages,), -1, np.int32)
        row[:len(blocks)] = blocks
        self._block_table[slot] = self._to_device(row)

    def _attach_prefix(self, request: _Request, slot: int,
                       hit: PrefixHit) -> None:
        """The attach route's whole hit: the slot's leading pages read
        the hit's pool blocks in place, pinned until the slot retires."""
        with tracing.span("serve/prefix_attach",
                          **_trace_attrs(request, slot=slot,
                                         blocks=len(hit.blocks),
                                         tokens=hit.tokens)):
            self._set_table_row(slot, hit.blocks)
        metrics.counter_inc("serve/prefix_attached_blocks", len(hit.blocks))
        with self._stats_lock:
            self._stats["prefix_attaches"] += 1

    def _dispatch_copy(self, request: _Request, slot: int,
                       hit: PrefixHit) -> None:
        """The copy route: the hit's pool blocks into the head of the slot
        row, the id vector padded with the hit's last block."""
        n_blocks = request.bucket_len // self.serve_config.prefix_block_tokens
        blocks = hit.blocks
        ids = np.full((n_blocks,), blocks[-1], np.int32)
        ids[:len(blocks)] = blocks

        def copy():
            self._lockstep("copy", slot=slot, ids=ids)

        with tracing.span("serve/prefix_copy",
                          **_trace_attrs(request, slot=slot,
                                         blocks=len(blocks),
                                         tokens=hit.tokens)):
            self._supervised("serve/prefix_copy", copy)

    def _op_copy(self, slot: int, ids: np.ndarray) -> None:
        self._grid_cache = generation.copy_prefix_program(
            self._grid_cache, self._prefix_pool, self._to_device(ids), slot)

    def _paged_kwargs(self) -> dict:
        """The block table, and the pool where hits attach through it."""
        if self._paged and self._prefix_pool is not None:
            return {"pool": self._prefix_pool,
                    "block_table": self._block_table}
        return {"block_table": self._block_table}

    def _advance_prefill(self) -> None:
        """One prefill chunk of the oldest mid-prefill request; its last
        chunk's logits arm the slot (``_finalize_insert``)."""
        task = self._prefill_tasks[0]
        request = task.request
        width, start = task.chunk_width, task.next_pos
        clen = min(request.prompt_len - start, width)
        tokens = np.zeros((1, width), np.int32)
        tokens[0, :clen] = request.prompt[start:start + clen]

        def prefill():
            faults.fault_point("serve.prefill")
            self._lockstep("prefill_chunk", tokens=tokens, start=start,
                           clen=clen, slot=task.slot)

        with tracing.span("serve/prefill_chunk",
                          **_trace_attrs(request, bucket=request.bucket_len,
                                         slot=task.slot, start=start,
                                         tokens=clen)):
            self._supervised("serve/prefill_chunk", prefill)
        task.next_pos = start + clen
        metrics.counter_inc("serve/prefill_chunks")
        with self._stats_lock:
            self._stats["prefill_chunks"] += 1
            widths = self._stats["prefill_chunk_widths"]
            widths[width] = widths.get(width, 0) + 1
        if task.next_pos >= request.prompt_len:
            self._prefill_tasks.popleft()
            self._finalize_insert(task)

    def _op_prefill_chunk(self, tokens: np.ndarray, start: int, clen: int,
                          slot: int) -> None:
        """One prefill chunk into ``slot``; its logits wait for the
        finalize of the prompt's last chunk."""
        self._grid_cache, self._chunk_logits = (
            generation.prefill_chunk_program(
                self.params, self._grid_cache, self._to_device(tokens),
                start, clen, slot, self.config, **self._paged_kwargs()))

    def _finalize_insert(self, task: _PrefillTask) -> None:
        """Arm a fully prefilled slot from its last chunk's logits, save
        the prompt's new prefix blocks, activate or retire it."""
        request, slot = task.request, task.slot

        def finalize():
            tok0 = self._lockstep(
                "finalize", prompt_len=request.prompt_len, slot=slot,
                max_new_tokens=request.max_new_tokens)
            with self._reshard("finalize_tok0"):
                return int(tok0)  # the finalize's one host sync

        with tracing.span("serve/prefill_finalize",
                          **_trace_attrs(request, slot=slot)):
            tok0 = self._supervised("serve/prefill_finalize", finalize)
        entry = self._slot_table[slot]
        entry.tokens = [tok0]
        entry.first_token_ts = time.perf_counter()
        self._feed_entry(entry)
        self._save_prefix_blocks(request, slot, already=task.hit)
        self._export_handoff(request, slot)
        self._activate_or_retire(slot, request, tok0)

    def _op_finalize(self, prompt_len: int, slot: int, max_new_tokens: int):
        self._slot_state, tok0 = generation.finalize_slot_program(
            self._slot_state, self._chunk_logits, prompt_len, slot,
            max_new_tokens, self.config, sample=self.serve_config.sample,
            generator=self._generator)
        self._chunk_logits = None
        return tok0

    def _insert_request(self, request: _Request, slot: int) -> None:
        tracing.record_span(
            "serve/queue_wait", request.submitted, time.perf_counter(),
            **_trace_attrs(request, bucket=request.bucket_len, slot=slot))
        tokens = np.zeros((1, request.bucket_len), np.int32)
        tokens[0, :request.prompt_len] = request.prompt

        def insert():
            faults.fault_point("serve.prefill")
            tok0 = self._lockstep(
                "insert", tokens=tokens, prompt_len=request.prompt_len,
                slot=slot, max_new_tokens=request.max_new_tokens)
            with self._reshard("insert_tok0"):
                return int(tok0)  # the insert's one host sync

        with tracing.span("serve/prefill",
                          **_trace_attrs(request, bucket=request.bucket_len,
                                         slot=slot)):
            tok0 = self._supervised("serve/prefill", insert)
        entry = _Slot(request=request, tokens=[tok0],
                      first_token_ts=time.perf_counter())
        self._slot_table[slot] = entry
        with self._stats_lock:
            self._stats["oneshot_inserts"] += 1
            self._count_sp_prefill(request.bucket_len)
        self._feed_entry(entry)
        self._save_prefix_blocks(request, slot)
        self._export_handoff(request, slot)
        self._activate_or_retire(slot, request, tok0)

    def _count_sp_prefill(self, width: int) -> None:
        """Count a one-shot prefill of ``width`` on a slice spanning
        ``sp``: split over it, or whole (caller holds ``_stats_lock``)."""
        if self._tp is not None and self._tp.sp_size > 1:
            key = ("sp_prefills" if self._tp.splits_seq(width)
                   else "sp_whole_prefills")
            self._stats[key] += 1

    def _op_insert(self, tokens: np.ndarray, prompt_len: int, slot: int,
                   max_new_tokens: int):
        """The one-shot insert (``insert_slot_program``) into ``slot``."""
        self._grid_cache, self._slot_state, tok0 = (
            generation.insert_slot_program(
                self.params, self._grid_cache, self._slot_state,
                self._to_device(tokens), prompt_len, slot, max_new_tokens,
                self.config, sample=self.serve_config.sample,
                generator=self._generator))
        return tok0

    def _activate_or_retire(self, slot: int, request: _Request,
                            tok0: int) -> None:
        """After a slot's prefill: count the insert, then decode on, or
        retire at once when the first token ends the request (the
        programs' ``active0`` gate)."""
        with self._stats_lock:
            self._stats["inserts"] += 1
            self._stats["decode_slot_steps"] += 1  # the prefill emission
            self._stats["useful_decode_tokens"] += 1
        metrics.counter_inc("serve/slot_inserts")
        eos = self.serve_config.sample.eos_id
        if request.max_new_tokens == 1 or (eos is not None and tok0 == eos):
            self._retire_slot(slot)
        else:
            if self._spec:
                # The slot will decode: the draft needs its prompt K/V
                # before the next proposal round.
                self._dispatch_draft_prefill(request, slot)
            self._active_slots.add(slot)

    def _save_prefix_blocks(self, request: _Request, slot: int,
                            already: Optional[PrefixHit] = None) -> None:
        """Save a just-prefilled prompt's new full blocks to the pool (no-op
        without the prefix cache).  The slot holds references on every
        block of its prompt's chain until it retires.  With a chunk in
        flight (depth 2) the save runs after it on the stream: counted as
        a deferred save."""
        if self._prefix is None:
            return
        cfg = self.serve_config
        if self._inflight:
            self._prefix.note_deferred_save()
        if already is None:
            already = PrefixHit(nodes=(), tokens=0)
        with self._demote_burst():
            held, created, evicted = self._prefix.insert(
                request.prompt.tolist(), already)
        if evicted:
            metrics.counter_inc("serve/prefix_evictions", evicted)
        self._slot_table[slot].prefix_nodes.extend(held)
        if not created:
            return
        n_blocks = request.bucket_len // cfg.prefix_block_tokens
        ids = np.full((n_blocks,), SKIP_BLOCK, np.int32)
        created_set = {id(node) for node in created}
        base = already.tokens // cfg.prefix_block_tokens
        for i, node in enumerate(held):
            if id(node) in created_set:
                ids[base + i] = node.block

        def save():
            self._lockstep("save", slot=slot, ids=ids)

        with tracing.span("serve/prefix_save", slot=slot,
                          blocks=len(created)):
            self._supervised("serve/prefix_save", save)
        metrics.counter_inc("serve/prefix_saved_blocks", len(created))

    def _op_save(self, slot: int, ids: np.ndarray) -> None:
        self._prefix_pool = generation.save_prefix_program(
            self._prefix_pool, self._grid_cache, slot, ids)

    # -- the KV handoff (disaggregated serving) ----------------------------

    def _export_handoff(self, request: _Request, slot: int) -> None:
        """Build a just-prefilled slot's handoff payload (no-op unless the
        request asked with ``handoff_export``).  Runs right after the
        prefix save: the slot's ``prefix_nodes`` are the prompt's whole
        root-down chain, pinned until it retires, so the rows hold still
        while one gather copies them into pinned host memory; the wait
        for that copy ends the dispatch, so the payload is complete
        before it leaves the scheduler.  One host copy per block (a
        payload must not keep the whole gather alive once a host pool
        keeps a few of its blocks); it rides out on
        ``ServeResult.handoff``."""
        if not request.handoff_export or self._prefix is None:
            return
        cfg = self.serve_config
        entry = self._slot_table[slot]
        nodes = list(entry.prefix_nodes)
        payload = {
            "version": 1,
            "block_tokens": cfg.prefix_block_tokens,
            "covered_tokens": len(nodes) * cfg.prefix_block_tokens,
            "keys": [tuple(node.key) for node in nodes],
            "payloads": [],
        }
        if nodes:
            blocks = [int(node.block) for node in nodes]

            def export():
                host = self._lockstep("export", blocks=blocks)
                self._wait_enqueued()
                return [{name: leaf[i].clone() for name, leaf in host.items()}
                        for i in range(len(blocks))]

            with tracing.span(
                    "serve/kv_handoff",
                    **_trace_attrs(request, direction="export", slot=slot,
                                   blocks=len(nodes))):
                payload["payloads"] = self._supervised("serve/kv_handoff",
                                                       export)
        entry.handoff = payload
        with self._stats_lock:
            self._stats["handoff_exports"] += 1
            self._stats["handoff_export_blocks"] += len(nodes)
        metrics.counter_inc("serve/handoff_exports")
        metrics.counter_inc("serve/handoff_export_blocks", len(nodes))

    def _op_export(self, blocks: List[int]):
        """Pool rows ``blocks`` as host tensors with every head: on a
        slice each rank's heads are gathered over ``tp`` in head order
        within ``sp`` index 0 (rank 0 keeps the payload; the other ``sp``
        members hold the same rows and take no part)."""
        if self._tp is not None and self._tp.sp_index != 0:
            return None
        return generation.download_prefix_blocks(self._prefix_pool, blocks,
                                                 tp=self._tp)

    def _op_import(self, blocks: List[int], payloads: dict) -> None:
        """Host payloads with every head into pool rows ``blocks``: on a
        slice each rank writes its heads."""
        self._prefix_pool = generation.upload_prefix_blocks(
            self._prefix_pool, payloads, blocks, tp=self._tp)

    def _import_handoff(self, request: _Request) -> List[object]:
        """Seed the prefix trie with a handoff payload's blocks, so the
        request's lookup (just after, in ``_admit_request``) sees an
        ordinary hit: attached through the block table on the paged
        route, copied otherwise.  Only the blocks the trie did not hold
        are uploaded, stacked into one pinned buffer and copied in stream
        order under one supervised dispatch.  Returns the seeded nodes,
        each holding one reference the caller drops once its acquire has
        pinned the hit.  A payload of another block size imports nothing
        and a hole truncates it: the suffix prefill covers the rest."""
        cfg = self.serve_config
        payload = request.handoff
        if int(payload.get("block_tokens") or 0) != cfg.prefix_block_tokens:
            return []
        keys = list(payload.get("keys") or ())
        payloads = list(payload.get("payloads") or ())
        usable = 0
        for i, key in enumerate(keys):
            if (i < len(payloads) and payloads[i] is not None
                    and len(key) == cfg.prefix_block_tokens):
                usable += 1
            else:
                break
        if not usable:
            return []
        with tracing.span(
                "serve/kv_handoff",
                **_trace_attrs(request, direction="import",
                               blocks=usable)) as span:
            with self._demote_burst():
                held, created = self._prefix.seed_blocks(keys[:usable])
            span.set_attribute("seeded", len(held))
            span.set_attribute("uploaded", len(created))
            if created:
                created_ids = {id(node) for node in created}
                uploads = [(int(node.block), payloads[i])
                           for i, node in enumerate(held)
                           if id(node) in created_ids]

                def upload():
                    stacked = {
                        name: self._stack_host([p[name] for _, p in uploads])
                        for name in self._prefix_pool}
                    self._lockstep("import", blocks=[b for b, _ in uploads],
                                   payloads=stacked)

                self._supervised("serve/kv_handoff", upload)
        with self._stats_lock:
            self._stats["handoff_imports"] += 1
            self._stats["handoff_import_blocks"] += len(held)
        metrics.counter_inc("serve/handoff_imports")
        metrics.counter_inc("serve/handoff_import_blocks", len(held))
        return held

    def _stack_host(self, rows) -> torch.Tensor:
        """Host rows stacked into one tensor, pinned on the card (so its
        copy to the device runs in stream order)."""
        first = torch.as_tensor(rows[0])
        out = torch.empty((len(rows),) + tuple(first.shape),
                          dtype=first.dtype,
                          pin_memory=self.device.type == "cuda")
        for i, row in enumerate(rows):
            out[i].copy_(torch.as_tensor(row))
        return out

    def _wait_enqueued(self) -> None:
        """Wait for the work enqueued so far on the current stream (an
        event recorded now: what other replicas' threads enqueue later on
        a shared stream is not waited for)."""
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            event.synchronize()

    # -- the host tier -----------------------------------------------------

    def _sync_stream(self) -> None:
        """The host tier's whole-stream synchronisation (one a demotion
        burst, counted in ``stats()["stream_syncs"]``): at depth 2 it also
        waits for the chunks in flight."""
        with self._stats_lock:
            self._stats["stream_syncs"] += 1
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _demote_block(self, block: int):
        """The manager's ``demote_fn``: pool row ``block``'s bytes to
        pinned host memory before the row is reused.  Inside a burst the
        download waits for the burst's end (a placeholder stands in);
        outside one it runs and is synchronised here, under the
        watchdog."""
        metrics.counter_inc("serve/prefix_demotions")
        if self._demote_batch is not None or self._link is not None:
            deferred = _DeferredPayload()
            if self._link is not None:
                deferred.tag = next(self._tier_tags)
                weakref.finalize(deferred, self._tier_dropped.append,
                                 deferred.tag)
            if self._demote_batch is None:
                self._flush_demotes([(int(block), deferred)])
            else:
                self._demote_batch.append((int(block), deferred))
            return deferred

        def download():
            payload = generation.download_prefix_block(self._prefix_pool,
                                                       block)
            self._sync_stream()
            return payload

        with tracing.span("serve/prefix_demote", block=int(block)):
            return self._supervised("serve/prefix_demote", download)

    @contextlib.contextmanager
    def _demote_burst(self):
        """Scope one allocation burst of the prefix cache: its demotions
        download together at the end, synchronised once, before the save
        or swap-in that reuses their rows is dispatched."""
        if self._demote_batch is not None:
            yield
            return
        batch: List[tuple] = []
        self._demote_batch = batch
        try:
            yield
        finally:
            self._demote_batch = None
            if batch:
                self._flush_demotes(batch)

    def _flush_demotes(self, batch: List[tuple]) -> None:
        def download():
            if self._link is not None:
                self._lockstep("demote", blocks=[b for b, _ in batch],
                               tags=[d.tag for _, d in batch],
                               drop=self._take_dropped())
            else:
                for block, deferred in batch:
                    deferred.value = generation.download_prefix_block(
                        self._prefix_pool, block)
                self._sync_stream()
            for _, deferred in batch:
                deferred.filled = True

        with tracing.span("serve/prefix_demote", blocks=len(batch)):
            self._supervised("serve/prefix_demote", download)

    def _take_dropped(self) -> List[int]:
        """The host-tier tags dropped since the last slice plan."""
        dropped, self._tier_dropped[:] = list(self._tier_dropped), []
        return dropped

    def _op_demote(self, blocks: List[int], tags: List[int],
                   drop: List[int]) -> None:
        """A slice's demotion burst: each rank copies its heads of pool
        rows ``blocks`` to host memory under ``tags`` (after forgetting
        the ``drop`` tags), synchronised once."""
        for tag in drop:
            self._tier.pop(tag, None)
        for block, tag in zip(blocks, tags):
            self._tier[tag] = generation.download_prefix_block(
                self._prefix_pool, block)
        self._sync_stream()

    def _op_swapin(self, blocks: List[int], tags: List[int],
                   drop: List[int]) -> None:
        """A slice's swap-in: each rank uploads its heads of the tagged
        host blocks into pool rows ``blocks``."""
        for tag in drop:
            self._tier.pop(tag, None)
        for block, tag in zip(blocks, tags):
            self._prefix_pool = generation.upload_prefix_block(
                self._prefix_pool, self._tier.pop(tag), block)

    def _dispatch_swapin(self, slot: int, plan, request: _Request) -> None:
        """Upload a promotion plan's host payloads into their fresh pool
        rows, on the current stream (not synchronised: what reads the rows
        runs after the copies on the same stream)."""
        tokens = len(plan) * self.serve_config.prefix_block_tokens

        def upload():
            if self._link is not None:
                self._lockstep("swapin", blocks=[int(b) for _, b, _ in plan],
                               tags=[p.tag for _, _, p in plan],
                               drop=self._take_dropped())
                return self._prefix_pool
            pool = self._prefix_pool
            for _node, block, payload in plan:
                pool = generation.upload_prefix_block(
                    pool, _resolve_payload(payload), block)
            return pool

        with tracing.span("serve/prefix_swapin",
                          **_trace_attrs(request, slot=slot,
                                         blocks=len(plan), tokens=tokens)):
            self._prefix_pool = self._supervised("serve/prefix_swapin",
                                                 upload)
        metrics.counter_inc("serve/prefix_swapins")
        metrics.counter_inc("serve/prefix_swapin_blocks", len(plan))

    # -- decode ------------------------------------------------------------

    def _note_dispatch_gap(self, start: float) -> None:
        """Record the host gap since the last decode dispatch ended (a
        ``serve/dispatch_gap`` span at depth 2 only) and stamp this
        dispatch's start."""
        self._last_dispatch_ts = start
        last = self._last_chunk_dispatch_end
        if last is None:
            return
        with self._stats_lock:
            self._dispatch_gaps.append((start - last) * 1000.0)
        if self._pipe_depth > 1:
            tracing.record_span("serve/dispatch_gap", last, start)

    def _chunk_program(self, cache, state, generator, table):
        """One decode chunk of the grid, its argument signature recorded
        (``chunk_traces``)."""
        cfg = self.serve_config
        kwargs = dict(self._paged_kwargs(), block_table=table,
                      chunk_size=cfg.chunk_tokens, sample=cfg.sample,
                      with_summary=self._pipe_depth > 1)
        self._signatures["chunk"].add((
            self._params_signature, _signature((cache, state, generator)),
            _signature(kwargs), _signature(self.config)))
        return generation.decode_chunk_program(
            self.params, cache, state, self.config, generator=generator,
            **kwargs)

    def _verify_program(self, cache, state, window, table):
        """One speculative verify of the grid, its argument signature
        recorded (``verify_traces``)."""
        cfg = self.serve_config
        kwargs = dict(self._paged_kwargs(), block_table=table,
                      sample=cfg.sample, with_summary=self._pipe_depth > 1)
        self._signatures["verify"].add((
            self._params_signature, _signature((cache, state, window)),
            _signature(kwargs), _signature(self.config)))
        return generation.verify_chunk_program(
            self.params, cache, state, window, self.config, **kwargs)

    @staticmethod
    def _emissions_to_host(toks, valid):
        """A decode dispatch's one host sync: tokens and validity in one
        copy."""
        host = torch.stack([toks, valid.to(torch.int32)]).cpu().numpy()
        return host[0], host[1].astype(bool)

    def _active_trace_map(self) -> Optional[Dict[str, str]]:
        """slot -> trace_id of the traced requests a grid dispatch serves
        (the ``traces`` attribute of its span), or None."""
        if not tracing.enabled():
            return None
        traces = {}
        for slot in sorted(self._active_slots):
            entry = self._slot_table[slot]
            if entry is not None and entry.request.trace is not None:
                traces[str(slot)] = entry.request.trace.trace_id
        return traces or None

    def _span_attrs(self, **attrs) -> dict:
        traces = self._active_trace_map()
        if traces:
            attrs["traces"] = traces
        return attrs

    def _dispatch_chunk(self) -> None:
        cfg = self.serve_config
        num_slots, chunk = cfg.num_slots, cfg.chunk_tokens
        span_attrs = self._span_attrs(slots=num_slots, chunk=chunk,
                                      active=len(self._active_slots))
        if self._slice_chips > 1:
            span_attrs["slice"] = (
                f"{self._slice_shape[0]}x{self._slice_shape[1]}")
            span_attrs["slice_chips"] = self._slice_chips
        start = time.perf_counter()
        self._note_dispatch_gap(start)

        def decode():
            faults.fault_point("serve.chunk")
            toks, valid = self._lockstep("chunk")
            self._last_chunk_dispatch_end = time.perf_counter()
            with self._reshard("chunk_tokens"):
                return self._emissions_to_host(toks, valid)

        with tracing.span("serve/chunk", **span_attrs) as chunk_span:
            toks, valid = self._supervised("serve/chunk", decode)
            emitted = int(valid.sum())
            occupancy = emitted / float(num_slots * chunk)
            chunk_span.set_attribute("tokens", emitted)
            chunk_span.set_attribute("occupancy", round(occupancy, 4))
        metrics.counter_inc("serve/chunks")
        metrics.gauge_set("serve/slot_occupancy", occupancy)
        with self._stats_lock:
            self._stats["chunk_seconds"] += time.perf_counter() - start
            self._stats["chunks"] += 1
            self._stats["decode_slot_steps"] += num_slots * chunk
            self._stats["useful_decode_tokens"] += emitted
        self._commit_emissions(toks, valid, chunk)

    def _op_chunk(self):
        """One decode chunk of the grid: ``(tokens, valid)`` on the device,
        and at depth 2 the chunk's summary."""
        out = self._chunk_program(self._grid_cache, self._slot_state,
                                  self._generator, self._block_table)
        self._grid_cache, self._slot_state = out[:2]
        return out[2:]

    def _feed_entry(self, entry: _Slot) -> None:
        """Deliver a slot's not yet streamed tokens to its request's stream
        and ``on_token`` hook (up to the request's budget, so the streamed
        view is the final row's prefix).  A hook that raises is logged
        and dropped."""
        request = entry.request
        if request.stream is None and request.on_token is None:
            return
        limit = min(len(entry.tokens), request.max_new_tokens)
        while entry.streamed < limit:
            i = entry.streamed
            token = entry.tokens[i]
            if request.stream is not None:
                request.stream.feed(i, token)
            if request.on_token is not None:
                try:
                    request.on_token(i, token)
                except Exception:  # noqa: BLE001 — a consumer's bug must
                    # not take the scheduler (and every other slot) down.
                    logger.exception("on_token hook failed")
                    request.on_token = None
            entry.streamed = i + 1

    def _commit_emissions(self, toks, valid, width: int) -> None:
        """Append each active slot's valid emissions (host arrays
        ``[num_slots, width]``), stream them, and retire the slots that
        finished."""
        eos = self.serve_config.sample.eos_id
        for slot in sorted(self._active_slots):
            entry = self._slot_table[slot]
            for i in range(width):
                if not valid[slot, i]:
                    break
                entry.tokens.append(int(toks[slot, i]))
            self._feed_entry(entry)
            hit_eos = eos is not None and entry.tokens[-1] == eos
            if hit_eos or len(entry.tokens) >= entry.request.max_new_tokens:
                self._retire_slot(slot)

    def _draft_round(self) -> None:
        """The draft's proposal for every slot (``serve/draft``), under
        the watchdog: the verify window, kept on every rank of a slice
        for the verify that follows (``_op_verify``)."""
        cfg = self.serve_config

        def draft():
            faults.fault_point("serve.draft")
            self._lockstep("draft")

        with tracing.span("serve/draft", slots=cfg.num_slots,
                          spec_k=cfg.draft.spec_k,
                          active=len(self._active_slots)):
            self._supervised("serve/draft", draft)

    def _op_draft(self) -> None:
        cfg = self.serve_config
        self._draft_cache, self._window = generation.draft_chunk_program(
            self._draft_params, self._draft_cache, self._slot_state,
            cfg.draft.config, spec_k=cfg.draft.spec_k)

    def _op_verify(self):
        """The target's verify of the last draft window: ``(tokens,
        valid)`` on the device, and at depth 2 the round's summary."""
        out = self._verify_program(self._grid_cache, self._slot_state,
                                   self._window, self._block_table)
        self._grid_cache, self._slot_state = out[:2]
        self._window = None
        return out[2:]

    def _count_round(self, emitted: int, active_n: int) -> Tuple[int, int]:
        """Stats of one committed verify round: every active slot commits
        at least the target's token at the first miss; the surplus is
        accepted draft tokens.  Returns (accepted, proposed)."""
        cfg = self.serve_config
        k = cfg.draft.spec_k
        accepted = max(emitted - active_n, 0)
        proposed = active_n * (k - 1)
        metrics.counter_inc("serve/spec_chunks")
        metrics.counter_inc("serve/spec_accepted_tokens", accepted)
        metrics.gauge_set("serve/slot_occupancy",
                          emitted / float(cfg.num_slots * k))
        with self._stats_lock:
            self._accept_window.append((accepted, proposed))
            self._stats["spec_chunks"] += 1
            self._stats["spec_emitted"] += emitted
            self._stats["spec_accepted"] += accepted
            self._stats["spec_proposed"] += proposed
            self._stats["decode_slot_steps"] += cfg.num_slots * k
            self._stats["useful_decode_tokens"] += emitted
        metrics.gauge_set("serve/spec_accept_rate",
                          self._rolling_acceptance())
        return accepted, proposed

    def _dispatch_spec_chunk(self) -> None:
        """One draft-and-verify round: the draft proposes a ``spec_k``
        window per slot over its own cache, the target scores the window
        in one forward and commits the accepted prefix; one host copy of
        the emissions, handled as a decode chunk's."""
        cfg = self.serve_config
        num_slots, k = cfg.num_slots, cfg.draft.spec_k
        active_n = len(self._active_slots)
        start = time.perf_counter()
        self._note_dispatch_gap(start)
        self._draft_round()

        def verify():
            faults.fault_point("serve.verify")
            toks, valid = self._lockstep("verify")
            self._last_chunk_dispatch_end = time.perf_counter()
            with self._reshard("verify_tokens"):
                return self._emissions_to_host(toks, valid)

        with tracing.span("serve/verify", **self._span_attrs(
                slots=num_slots, spec_k=k, active=active_n)) as verify_span:
            toks, valid = self._supervised("serve/verify", verify)
            emitted = int(valid.sum())
            accepted, proposed = self._count_round(emitted, active_n)
            verify_span.set_attribute("tokens", emitted)
            verify_span.set_attribute("accepted", accepted)
            verify_span.set_attribute("proposed", proposed)
            verify_span.set_attribute(
                "occupancy", round(emitted / float(num_slots * k), 4))
        with self._stats_lock:
            self._stats["chunk_seconds"] += time.perf_counter() - start
        self._commit_emissions(toks, valid, k)

    # -- pipelined scheduling (pipeline_depth=2) ---------------------------

    def _predict_survivors(self) -> bool:
        """Without a device sync: can any active slot still be decoding
        after every chunk in the ring lands?  The host knows each slot's
        remaining budget and each ring entry's width; eos only ends a slot
        sooner, so True can at worst let a partly dead chunk through (its
        rows masked on the device), never hold back a live one."""
        pending = sum(rec.width for rec in self._inflight)
        for slot in self._active_slots:
            entry = self._slot_table[slot]
            if entry is None:  # pragma: no cover - retire races
                continue
            if entry.request.max_new_tokens - len(entry.tokens) > pending:
                return True
        return False

    def _start_host_copy(self, toks, valid, summary):
        """Enqueue a dispatched chunk's emissions to its own host buffer:
        one flat int32 ``[tokens, valid, summary]``, pinned and
        non-blocking on the card with an event recorded after it (the
        next chunk never writes this buffer); on the CPU the values
        themselves.  Returns (host, event)."""
        flat = torch.cat([toks.reshape(-1).to(torch.int32),
                          valid.reshape(-1).to(torch.int32),
                          summary.reshape(-1).to(torch.int32)])
        if flat.device.type != "cuda":
            return flat, None
        host = torch.empty(flat.shape, dtype=torch.int32, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _dispatch_chunk_async(self) -> None:
        """The dispatch half of a pipelined decode pass: enqueue one chunk
        and its host copy, push it on the ring; no host wait.  Its stats
        and span come at its drain: a disposed chunk is never counted."""
        cfg = self.serve_config
        span_attrs = self._span_attrs(slots=cfg.num_slots,
                                      chunk=cfg.chunk_tokens,
                                      active=len(self._active_slots))
        start = time.perf_counter()
        self._note_dispatch_gap(start)

        def decode():
            faults.fault_point("serve.chunk")
            return self._start_host_copy(*self._lockstep("chunk"))

        host, event = self._supervised("serve/chunk", decode)
        end = time.perf_counter()
        self._last_chunk_dispatch_end = end
        self._inflight.append(_InflightChunk(
            host=host, event=event, width=cfg.chunk_tokens, kind="chunk",
            active=len(self._active_slots), span_attrs=span_attrs,
            dispatch_start=start, dispatch_end=end))

    def _dispatch_spec_chunk_async(self) -> None:
        """A pipelined draft-and-verify round: draft and verify enqueue
        back to back (the verify reads the window on the device) and the
        verify's emissions ride the ring as a decode chunk's do."""
        cfg = self.serve_config
        active_n = len(self._active_slots)
        start = time.perf_counter()
        self._note_dispatch_gap(start)
        self._draft_round()
        span_attrs = self._span_attrs(slots=cfg.num_slots,
                                      spec_k=cfg.draft.spec_k,
                                      active=active_n)

        def verify():
            faults.fault_point("serve.verify")
            return self._start_host_copy(*self._lockstep("verify"))

        host, event = self._supervised("serve/verify", verify)
        end = time.perf_counter()
        self._last_chunk_dispatch_end = end
        self._inflight.append(_InflightChunk(
            host=host, event=event, width=cfg.draft.spec_k, kind="verify",
            active=active_n, span_attrs=span_attrs, dispatch_start=start,
            dispatch_end=end))

    def _wait_copy(self, rec: _InflightChunk, budget: Optional[float]) -> None:
        """Wait for a ring entry's host copy (its chunk ran before it on
        the stream): on its event, polled against ``budget`` seconds when
        given (a wedged chunk raises :class:`DispatchTimeoutError`)."""
        if rec.event is None:
            return
        if budget is None:
            rec.event.synchronize()
            return
        deadline = time.perf_counter() + budget
        while not rec.event.query():
            if time.perf_counter() > deadline:
                raise self._watchdog_fire(f"serve/{rec.kind}")
            time.sleep(50e-6)

    def _drain_inflight(self) -> None:
        """The drain half of a pipelined pass: wait for the oldest ring
        entry's emissions (the wait, ``serve/host_bubble``, overlaps the
        device running the chunk dispatched after it), then count and
        commit them as the synchronous path does.  Its
        ``serve/chunk``/``serve/verify`` span covers dispatch to drain."""
        rec = self._inflight.popleft()
        cfg = self.serve_config
        num_slots = cfg.num_slots
        wait0 = time.perf_counter()
        self._wait_copy(rec, cfg.dispatch_timeout_s)
        host = rec.host.numpy()
        wait1 = time.perf_counter()
        tracing.record_span("serve/host_bubble", wait0, wait1,
                            kind=rec.kind, width=rec.width)
        n = num_slots * rec.width
        toks = host[:n].reshape(num_slots, rec.width)
        valid = host[n:2 * n].reshape(num_slots, rec.width).astype(bool)
        emitted = int(host[2 * n])
        occupancy = emitted / float(n)
        attrs = dict(rec.span_attrs, tokens=emitted,
                     occupancy=round(occupancy, 4))
        if rec.kind == "verify":
            attrs["accepted"], attrs["proposed"] = self._count_round(
                emitted, rec.active)
            tracing.record_span("serve/verify", rec.dispatch_start, wait1,
                                **attrs)
        else:
            tracing.record_span("serve/chunk", rec.dispatch_start, wait1,
                                **attrs)
            metrics.counter_inc("serve/chunks")
            metrics.gauge_set("serve/slot_occupancy", occupancy)
            with self._stats_lock:
                self._stats["chunks"] += 1
                self._stats["decode_slot_steps"] += n
                self._stats["useful_decode_tokens"] += emitted
        with self._stats_lock:
            self._stats["chunk_seconds"] += (
                rec.dispatch_end - rec.dispatch_start + wait1 - wait0)
        self._commit_emissions(toks, valid, rec.width)

    def _dispose_inflight(self) -> None:
        """Drop the ring without committing (abort and crash paths), after
        each entry's chunk and copy have completed (bounded by the
        watchdog's budget when armed), so nothing keeps running against
        state being torn down.  Errors are logged: the slots' futures are
        failed by the caller."""
        while self._inflight:
            rec = self._inflight.popleft()
            try:
                self._wait_copy(rec, self.serve_config.dispatch_timeout_s)
            except Exception:  # noqa: BLE001
                logger.exception("disposing in-flight chunk failed")

    def _dispatch_draft_prefill(self, request: _Request, slot: int) -> None:
        """The prompt of a just-armed slot into the draft's cache row, so
        the next proposal round attends over real context."""
        tokens = np.zeros((1, request.bucket_len), np.int32)
        tokens[0, :request.prompt_len] = request.prompt

        def prefill():
            faults.fault_point("serve.draft_prefill")
            self._lockstep("draft_prefill", tokens=tokens,
                           prompt_len=request.prompt_len, slot=slot)

        with tracing.span("serve/draft_prefill", bucket=request.bucket_len,
                          slot=slot):
            self._supervised("serve/draft_prefill", prefill)
        metrics.counter_inc("serve/draft_prefills")
        with self._stats_lock:
            self._stats["draft_prefills"] += 1

    def _op_draft_prefill(self, tokens: np.ndarray, prompt_len: int,
                          slot: int) -> None:
        self._draft_cache = generation.draft_prefill_slot_program(
            self._draft_params, self._draft_cache, self._to_device(tokens),
            prompt_len, slot, self.serve_config.draft.config)

    def _rolling_acceptance(self) -> float:
        """Acceptance over the last 64 rounds (``health()``; ``stats()``
        has the cumulative quotient)."""
        with self._stats_lock:
            accepted = sum(a for a, _ in self._accept_window)
            proposed = sum(p for _, p in self._accept_window)
        return accepted / proposed if proposed else 0.0

    def _retire_slot(self, slot: int, exc: Optional[BaseException] = None
                     ) -> None:
        """Free a slot, drop its prefix references (its table row first)
        and resolve its request's future with the result (the emitted row
        padded to the request's length) or ``exc``."""
        cfg = self.serve_config
        entry = self._slot_table[slot]
        self._slot_table[slot] = None
        self._active_slots.discard(slot)
        self._set_table_row(slot, ())
        if entry.prefix_nodes and self._prefix is not None:
            self._prefix.release(entry.prefix_nodes)
        with self._cond:
            self._free_slots.append(slot)
        request = entry.request
        if exc is not None:
            try:
                request.future.set_exception(exc)
            except InvalidStateError:
                return
            with self._stats_lock:
                self._stats["failed"] += 1
            return
        m = request.max_new_tokens
        num = min(len(entry.tokens), m)
        row = np.full((m,), cfg.sample.pad_id, np.int32)
        row[:num] = entry.tokens[:num]
        done = time.perf_counter()
        first = entry.first_token_ts or done
        result = ServeResult(
            tokens=row, num_generated=num, bucket_len=request.bucket_len,
            batch_size=cfg.num_slots,
            latency_seconds=done - request.submitted,
            ttft_seconds=first - request.submitted,
            trace_id=request.trace_id, handoff=entry.handoff,
        )
        metrics.distribution_record("serve/latency_seconds",
                                    result.latency_seconds)
        metrics.counter_inc("serve/slot_retires")
        metrics.counter_inc("serve/generated_tokens", num)
        eos = cfg.sample.eos_id
        hit_eos = eos is not None and num > 0 and int(row[num - 1]) == eos
        if not hit_eos:
            metrics.counter_inc("serve/slot_expired")
        self._qps.add(done, 1)
        self._tokens_rate.add(done, num)
        with self._stats_lock:
            self._stats["retires"] += 1
            if not hit_eos:
                self._stats["expired"] += 1
            self._stats["completed"] += 1
            self._stats["generated_tokens"] += num
            if self._qos is not None:
                self._class_completed[request.priority] += 1
        if self._qos is not None or request.trace is not None:
            # A terminal span per request with QoS armed (per-class TTFT)
            # or when the request is traced (its lifecycle's end).
            attrs = {"ttft_s": round(result.ttft_seconds, 6), "tokens": num}
            if request.priority is not None:
                attrs["priority"] = request.priority
            tracing.record_span("serve/request", request.submitted, done,
                                **_trace_attrs(request, **attrs))
        try:
            request.future.set_result(result)
        except InvalidStateError:  # pragma: no cover - cancelled
            pass

    def _fail_live_slots(self, exc: BaseException) -> None:
        for slot, entry in enumerate(self._slot_table):
            if entry is not None:
                self._retire_slot(slot, exc=exc)

    # -- observability -----------------------------------------------------

    def health(self) -> dict:
        """Readiness/liveness snapshot, with the JAX engine's key names for
        the keys the port fills."""
        with self._cond:
            waiting = self._waiting
            closed = self._closed
            thread = self._thread
            free_slots = len(self._free_slots)
            class_backlog = self._class_backlog_locked()
        live = thread is not None and thread.is_alive()
        reason = self._unhealthy_reason
        if reason is None and self._spawned is not None:
            reason = self._spawned.dead()
        last = self._last_dispatch_ts
        snap = {
            "healthy": reason is None,
            "ready": live and not closed and reason is None,
            "live": live,
            "reason": reason,
            "closed": closed,
            "waiting": waiting,
            "queue_depth": waiting,
            "active_slots": (self.serve_config.num_slots - free_slots
                             if self._continuous else self._inflight_rows),
            "num_slots": self.serve_config.num_slots,
            # The slice this replica spans: (tp, sp) and its cards.
            "slice_shape": self._slice_shape,
            "slice_chips": self._slice_chips,
            "orphaned_dispatches": len(self._orphan_dispatches),
            "last_dispatch_age_s": (
                None if last is None else time.perf_counter() - last),
            "spec_acceptance_rate": (
                self._rolling_acceptance() if self._spec else 0.0),
            "spec_k": self.serve_config.draft.spec_k if self._spec else 0,
            "class_backlog": class_backlog,
            "decode_kernel": self.serve_config.decode_kernel,
            "role": self._role,
            "pipeline_depth": self._pipe_depth,
            "dispatch_gap_ms": self._dispatch_gap_mean(),
            "device": str(self.device),
        }
        with self._stats_lock:
            for key in HANDOFF_KEYS:
                snap[key] = self._stats[key]
        snap.update(self._prefix_snapshot())
        if self._continuous:
            snap["free_slots"] = free_slots
        return snap

    def _class_backlog_locked(self) -> Dict[str, int]:
        """Waiting requests per QoS class (zeros without QoS)."""
        backlog = {name: 0 for name in self._class_names}
        if self._qos is not None:
            for queue_ in self._pending.values():
                for request in queue_:
                    backlog[request.priority] += 1
        return backlog

    def _prefix_snapshot(self) -> dict:
        """The prefix-cache keys of ``health()`` and ``stats()``, the JAX
        engine's: zeros when the cache (or its host tier) is off."""
        prefix = self._prefix.stats() if self._prefix is not None else None

        def get(key):
            return prefix[key] if prefix else 0

        return {
            "prefix_cache_blocks": get("blocks_in_use"),
            "prefix_hit_tokens": get("hit_tokens"),
            "evictions": get("evictions"),
            "prefix_dram_blocks": get("dram_blocks_in_use"),
            "prefix_dram_hits": get("dram_hits"),
            "prefix_dram_hit_tokens": get("dram_hit_tokens"),
            "prefix_dram_demotions": get("demotions"),
            "prefix_dram_evictions": get("dram_evictions"),
            "prefix_dram_swapin_failures": get("swapin_failures"),
            "prefix_deferred_saves": get("deferred_saves"),
            "cached_prefixes": (self._prefix.hot_prefixes()
                                if self._prefix is not None else {}),
        }

    def stats(self) -> dict:
        """Counters plus ``mean_batch_occupancy`` (real rows / dispatched
        rows, batch scheduler), ``mean_slot_occupancy`` (useful emitted
        tokens / dispatched token slots, both schedulers), per-class
        counts, dispatch-gap percentiles and the prefix-cache keys."""
        with self._stats_lock:
            snap = dict(self._stats)
            snap["prefill_chunk_widths"] = dict(snap["prefill_chunk_widths"])
            snap["class_completed"] = dict(self._class_completed)
            snap["class_shed"] = dict(self._class_shed)
            gaps = list(self._dispatch_gaps)
        snap["role"] = self._role
        snap["slice_shape"] = self._slice_shape
        snap["slice_chips"] = self._slice_chips
        with self._cond:
            snap["class_backlog"] = self._class_backlog_locked()
        snap["mean_batch_occupancy"] = (
            snap["real_rows"] / snap["slots"] if snap["slots"] else 0.0)
        snap["mean_slot_occupancy"] = (
            snap["useful_decode_tokens"] / snap["decode_slot_steps"]
            if snap["decode_slot_steps"] else 0.0
        )
        snap["spec_acceptance_rate"] = (
            snap["spec_accepted"] / snap["spec_proposed"]
            if snap["spec_proposed"] else 0.0)
        snap["pipeline_depth"] = self._pipe_depth
        snap["dispatch_gap_ms_p50"] = (
            float(np.percentile(gaps, 50)) if gaps else 0.0)
        snap["dispatch_gap_ms_p99"] = (
            float(np.percentile(gaps, 99)) if gaps else 0.0)
        snap.update(self._prefix_snapshot())
        return snap

    def _dispatch_gap_mean(self) -> float:
        with self._stats_lock:
            gaps = list(self._dispatch_gaps)
        return float(sum(gaps) / len(gaps)) if gaps else 0.0
