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

``ServeConfig(kv_quant=True)`` keeps the grid (and pool) int8 with
per-(position, head) scales; the decode attention then runs the int8
kernel K8q.  Weight-only int8 params (``models/quantization
.quantize_params``) are served as they are.

The host synchronises with the card once per insert or finalize (its
first token), once per decode chunk, speculative round or batch (its
emissions) and once per demotion burst, never per token.  Greedy outputs
are token-identical to a direct ``generation.generate`` call per request.

The engine takes every field, keyword and method of the JAX engine; each
value whose feature the port does not have yet raises
``NotImplementedError`` naming the ROADMAP.md item that brings it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cloud_tpu_torch import bridge
from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import generation, transformer
from cloud_tpu_torch.ops import dispatch
from cloud_tpu_torch.serving.prefix_cache import (
    SKIP_BLOCK,
    PrefixCacheManager,
    PrefixHit,
)

logger = logging.getLogger(__name__)

#: Scheduler-thread name (prefix match in tests' thread-leak guards).
SERVE_SCHEDULER_THREAD_NAME = "cloud-tpu-torch-serve-scheduler"
#: Warmup worker's name (the same prefix, so the same guards see it).
SERVE_WARMUP_THREAD_NAME = SERVE_SCHEDULER_THREAD_NAME + "-warmup"
#: The kernel libraries the serving path launches (K5, K8/K8q).
SERVING_LIBRARIES = ("flash_fwd", "paged_attention")


class QueueFullError(RuntimeError):
    """Typed rejection under ``admission="reject"``: the waiting set is at
    ``max_queue`` — shed the request or retry with backoff."""


class EngineClosedError(RuntimeError):
    """The engine is closed (or closing): the request was not admitted."""


class DeadlineExceededError(RuntimeError):
    """The request's ``deadline_s`` expired while it waited in the queue."""


def _later(feature: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not in the PyTorch port yet: it comes with "
        f"ROADMAP.md section A, item {item}"
    )


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
    (``ServingEngine.wait_ready``).
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
    qos: Optional[object] = None
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
        if (self.hbm_bytes_per_chip is not None
                and self.hbm_bytes_per_chip < 1):
            raise ValueError(
                f"hbm_bytes_per_chip must be >= 1 or None, got "
                f"{self.hbm_bytes_per_chip}"
            )
        self._refuse_later_features()

    def _refuse_later_features(self):
        if self.qos is not None:
            raise _later("qos= (priority scheduling)", "4e")
        if self.pipeline_depth != 1:
            raise _later("pipeline_depth=2 (pipelined scheduling)", "4f")
        if self.dispatch_timeout_s is not None:
            raise _later("dispatch_timeout_s (the dispatch watchdog)", "4f")
        if self.prefix_summary_ttl_s is not None:
            raise _later("prefix_summary_ttl_s (the prefix cache's router "
                         "summary)", "4a/5")
        if self.role != "both":
            raise _later(f"role={self.role!r} (disaggregated serving)", "5")
        if self.layout == "auto" or (
                self.mesh_shape is not None
                and tuple(self.mesh_shape) != (1, 1)):
            raise _later("mesh_shape/layout='auto' (multi-card serving)", "6")
        if self.hbm_bytes_per_chip is not None:
            raise _later("hbm_bytes_per_chip (multi-card serving)", "6")


@dataclasses.dataclass(frozen=True)
class ServeResult:
    """One resolved request: ``tokens`` is its generated row of length
    ``max_new_tokens`` (eos included where sampled, pad after it);
    ``num_generated`` counts real tokens; ``batch_size`` is the grid's
    ``num_slots`` (continuous) or the padded batch (batch scheduler)."""

    tokens: np.ndarray
    num_generated: int
    bucket_len: int
    batch_size: int
    latency_seconds: float
    ttft_seconds: float = 0.0


@dataclasses.dataclass(eq=False)
class _Request:
    prompt: np.ndarray
    prompt_len: int
    max_new_tokens: int
    bucket_len: int
    future: Future
    submitted: float  # perf_counter
    deadline: Optional[float] = None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


@dataclasses.dataclass
class _Slot:
    """Host mirror of one claimed slot (scheduler thread only).
    ``prefix_nodes`` are the prefix-cache blocks it holds references on
    (the hit it reads, the blocks it saved), released when it retires."""

    request: _Request
    tokens: List[int]
    prefix_nodes: List[object] = dataclasses.field(default_factory=list)
    first_token_ts: Optional[float] = None


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


class _DeferredPayload:
    """A demoted block's host bytes, downloaded when its burst ends
    (``ServingEngine._demote_burst``)."""

    __slots__ = ("value", "filled")

    def __init__(self):
        self.value = None
        self.filled = False


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




class ServingEngine:
    """In-process serving over ``generation``: the continuous scheduler,
    or the batch scheduler with ``scheduler="batch"``.  Construct,
    ``submit()`` from any thread, ``close()`` when done (or use as a
    context manager).  Runs on ``device`` (default ``cuda``).  ``rules``
    and ``mesh`` (sharded serving) take ``None`` only."""

    def __init__(self, params, config, serve_config: Optional[ServeConfig] = None,
                 *, rules=None, mesh=None, device=None, start: bool = True):
        if rules is not None or mesh is not None:
            raise _later("rules=/mesh= (sharded serving)", "6")
        self.device = resolve_device(device)
        transformer.check_supported(config)
        _check_quantized_leaves(params)
        self.config = config
        self.serve_config = cfg = serve_config or ServeConfig()
        self.params = generation.prepare_params(
            bridge.map_leaves(params, lambda t: t.to(self.device)), config)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(cfg.seed)

        self._cond = threading.Condition()
        #: bucket_len -> FIFO of waiting requests (guarded by _cond).
        self._pending: Dict[int, collections.deque] = {}
        self._waiting = 0
        self._closed = False
        self._draining = True
        self._thread: Optional[threading.Thread] = None
        self._unhealthy_reason: Optional[str] = None
        self._last_dispatch_ts: Optional[float] = None
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
            "shed": 0,
            # The port's own additions: host wall time of decode chunks
            # (dispatch through the host copy of their emissions), the
            # one-shot inserts (one flash-attention prefill each; the
            # other inserts are armed by a chunked prefill's finalize),
            # the decode steps the batch scheduler ran, and the prefill
            # chunks by width.
            "chunk_seconds": 0.0, "oneshot_inserts": 0,
            "batch_decode_steps": 0,
            "prefill_chunk_widths": {},
            # Speculative decoding (0 with draft=None): spec_chunks are
            # verify rounds, spec_emitted the tokens they committed,
            # spec_proposed/spec_accepted the draft tokens offered and
            # committed; acceptance is their quotient.
            "spec_chunks": 0, "spec_emitted": 0,
            "spec_proposed": 0, "spec_accepted": 0, "draft_prefills": 0,
        }
        #: Rolling dispatch->dispatch host gaps (ms) between chunks.
        self._dispatch_gaps: collections.deque = collections.deque(maxlen=512)
        self._last_chunk_dispatch_end: Optional[float] = None

        self._continuous = cfg.scheduler == "continuous"
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
        self._accept_window: collections.deque = collections.deque(maxlen=64)
        if self._continuous:
            self._max_len = cfg.prompt_buckets[-1] + cfg.max_new_tokens
            # The grid is updated in place by every program (the JAX
            # engine donates it through each dispatch to the same effect).
            self._grid_cache = generation.init_slot_cache(
                config, cfg.num_slots, self._max_len, device=self.device,
                kv_quant=cfg.kv_quant)
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
                               else None))
                self._prefix_pool = generation.init_prefix_pool(
                    config, cfg.prefix_cache_blocks, cfg.prefix_block_tokens,
                    device=self.device, kv_quant=cfg.kv_quant)
            if self._spec:
                self._init_draft()
        self._warmup_thread: Optional[threading.Thread] = None
        if cfg.warmup:
            self._warmup_thread = threading.Thread(
                target=self._warmup, daemon=True,
                name=SERVE_WARMUP_THREAD_NAME)
            self._warmup_thread.start()
        if start:
            self.start()

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
        transformer.check_supported(dcfg)
        _check_quantized_leaves(cfg.draft.params, "draft.params")
        self._draft_params = generation.prepare_params(
            bridge.map_leaves(cfg.draft.params,
                              lambda t: t.to(self.device)), dcfg)
        self._draft_cache = generation.init_slot_cache(
            dcfg, cfg.num_slots, self._max_len, device=self.device,
            kv_quant=cfg.kv_quant)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServingEngine":
        """Launch the scheduler thread (idempotent)."""
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
        bucket, one draft chunk and one verify instead).  Batch: each batch
        bucket once, at the largest prompt bucket.  A failure is logged;
        the programs then run cold."""
        try:
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
                    device=self.device, kv_quant=cfg.kv_quant)
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
                    draft_cache = generation.init_slot_cache(
                        dcfg, cfg.num_slots, self._max_len,
                        device=self.device, kv_quant=cfg.kv_quant)
                    for bucket_len in cfg.prompt_buckets:
                        generation.draft_prefill_slot_program(
                            self._draft_params, draft_cache,
                            torch.ones((1, bucket_len), dtype=torch.int32),
                            bucket_len, 0, dcfg)
                    _, window = generation.draft_chunk_program(
                        self._draft_params, draft_cache, state, dcfg,
                        spec_k=cfg.draft.spec_k)
                    _, _, toks, _ = generation.verify_chunk_program(
                        self.params, cache, state, window, self.config,
                        sample=cfg.sample, block_table=table)
                else:
                    _, _, toks, _ = generation.decode_chunk_program(
                        self.params, cache, state, self.config,
                        chunk_size=cfg.chunk_tokens, sample=cfg.sample,
                        generator=generator, block_table=table)
                toks.cpu()  # the card has run it
        except Exception:  # noqa: BLE001 — logged; serving still works
            logger.exception("serving warmup failed; programs run cold")

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

    def set_trace_lane(self, lane: Optional[int]) -> None:
        """Timeline lanes are not ported: only ``None`` (no lane)."""
        if lane is not None:
            raise _later("set_trace_lane (request tracing)", "4e")

    def set_role(self, role: str) -> None:
        """Disaggregated roles are not ported: only ``"both"``."""
        if role not in ("prefill", "decode", "both"):
            raise ValueError(
                f"role must be 'prefill', 'decode' or 'both', got {role!r}"
            )
        if role != "both":
            raise _later(f"set_role({role!r}) (disaggregated serving)", "5")

    @property
    def chunk_traces(self) -> int:
        raise _later("chunk_traces (the JAX engine's compile count)", "4e")

    @property
    def verify_traces(self) -> int:
        raise _later("verify_traces (the JAX engine's compile count of the "
                     "speculative verify)", "4e")

    def close(self, drain: bool = True, timeout: Optional[float] = None
              ) -> None:
        """Stop the engine: no more admissions.  ``drain=True`` serves every
        admitted request first; ``drain=False`` fails waiting and in-flight
        requests with :class:`EngineClosedError`.  Joins the scheduler and
        the warmup worker."""
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
               on_token=None, trace=None, handoff_export: bool = False,
               handoff: Optional[dict] = None) -> Future:
        """Enqueue one prompt (1-D token ids, length 1 ..
        ``prompt_buckets[-1]``); returns a Future of :class:`ServeResult`.
        ``max_new_tokens`` may be below the engine-wide budget.  Blocks or
        raises :class:`QueueFullError` at ``max_queue`` per the admission
        policy; ``deadline_s`` bounds the queue wait.  The QoS and handoff
        keywords take their defaults only."""
        if (priority is not None or stream or on_token is not None
                or trace is not None):
            raise _later("submit(priority=, stream=, on_token=, trace=) "
                         "(QoS, streaming and request tracing)", "4e")
        if handoff_export or handoff is not None:
            raise _later("submit(handoff_export=, handoff=) (disaggregated "
                         "serving)", "5")
        cfg = self.serve_config
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
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
        request = _Request(
            prompt=prompt, prompt_len=n, max_new_tokens=m,
            bucket_len=bucket_len, future=Future(), submitted=submitted,
            deadline=None if deadline_s is None else submitted + deadline_s,
        )
        with self._cond:
            if self._closed:
                raise EngineClosedError("engine is closed")
            if self._waiting >= cfg.max_queue:
                if cfg.admission == "reject":
                    with self._stats_lock:
                        self._stats["rejected"] += 1
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
        return request.future

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
        for queue_ in self._pending.values():
            kept = collections.deque()
            while queue_:
                request = queue_.popleft()
                if not request.expired(now):
                    kept.append(request)
                    continue
                self._waiting -= 1
                shed += 1
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
            with self._stats_lock:
                self._stats["shed"] += shed
            self._cond.notify_all()

    def _pop_inserts_locked(self, inserts) -> None:
        """Claim one free slot per waiting request, oldest submit first
        across every bucket."""
        self._shed_expired_locked(time.perf_counter())
        popped = False
        while self._free_slots:
            oldest_queue = None
            for queue_ in self._pending.values():
                if queue_ and (oldest_queue is None or queue_[0].submitted
                               < oldest_queue[0].submitted):
                    oldest_queue = queue_
            if oldest_queue is None:
                break
            inserts.append((oldest_queue.popleft(), self._free_slots.pop()))
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

    # -- scheduler ---------------------------------------------------------

    def _scheduler_loop(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.no_grad():
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
            self._fail_live_slots(exc)

    def _batch_loop(self) -> None:
        """Form a batch (``_pop_batch_locked``), serve it, repeat; a failed
        batch fails its requests only."""
        while True:
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
                with self._stats_lock:
                    self._stats["failed"] += len(batch)
                for request in batch:
                    try:
                        request.future.set_exception(exc)
                    except InvalidStateError:  # pragma: no cover
                        pass
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
        tokens = np.zeros((batch_size, bucket_len), np.int32)
        lens = np.ones((batch_size,), np.int32)
        for i, request in enumerate(batch):
            tokens[i, :request.prompt_len] = request.prompt
            lens[i] = request.prompt_len
        self._last_dispatch_ts = time.perf_counter()
        lens_t = torch.from_numpy(lens).to(self.device)
        cache, logits0 = generation.prefill_program(
            self.params, torch.from_numpy(tokens).to(self.device), lens_t,
            self.config, max_new_tokens=cfg.max_new_tokens,
            kv_quant=cfg.kv_quant)
        out = generation.decode_program(
            self.params, cache, logits0, lens_t, self.config,
            max_new_tokens=cfg.max_new_tokens, sample=cfg.sample,
            generator=self._generator)
        # The batch's one host sync: tokens and counts in one copy.
        host = torch.cat([out["tokens"], out["num_generated"][:, None]],
                         dim=1).to(torch.int32).cpu().numpy()
        done = time.perf_counter()
        results = []
        generated = 0
        for i, request in enumerate(batch):
            m = request.max_new_tokens
            num = int(min(host[i, -1], m))
            generated += num
            results.append(ServeResult(
                tokens=host[i, :m].copy(), num_generated=num,
                bucket_len=bucket_len, batch_size=batch_size,
                latency_seconds=done - request.submitted,
                # The batch's tokens arrive all at once.
                ttft_seconds=done - request.submitted,
            ))
        # Counted before the futures resolve, so a caller woken by one
        # sees its batch in stats().
        with self._stats_lock:
            self._stats["batches"] += 1
            self._stats["slots"] += batch_size
            self._stats["real_rows"] += n
            self._stats["completed"] += n
            self._stats["generated_tokens"] += generated
            self._stats["decode_slot_steps"] += batch_size * cfg.max_new_tokens
            self._stats["useful_decode_tokens"] += generated
            self._stats["batch_decode_steps"] += cfg.max_new_tokens - 1
        for request, result in zip(batch, results):
            try:
                request.future.set_result(result)
            except InvalidStateError:  # pragma: no cover - cancelled
                pass

    def _continuous_loop(self) -> None:
        """Fill free slots from the queue, advance at most one prefill
        chunk, run one decode chunk, retire what finished, repeat: however
        long an arriving prompt, in-flight decode waits at most one
        prefill chunk."""
        while True:
            inserts: List[Tuple[_Request, int]] = []
            abort = False
            with self._cond:
                while True:
                    if self._closed and not self._draining:
                        abort = True
                        break
                    self._pop_inserts_locked(inserts)
                    if inserts or self._active_slots or self._prefill_tasks:
                        break
                    if self._closed:
                        return  # draining and nothing left to serve
                    self._cond.wait()
            if abort:
                self._prefill_tasks.clear()
                self._fail_live_slots(EngineClosedError(
                    "engine closed without draining in-flight requests"))
                return
            for idx, (request, slot) in enumerate(inserts):
                try:
                    self._admit_request(request, slot)
                except BaseException as exc:
                    # Popped but maybe not tabled yet: invisible to the
                    # crash handler, so fail them here before it runs.
                    for req, _ in inserts[idx:]:
                        try:
                            req.future.set_exception(exc)
                        except InvalidStateError:  # pragma: no cover
                            pass
                    raise
            if self._prefill_tasks:
                self._advance_prefill()
            if self._active_slots:
                if self._spec:
                    self._dispatch_spec_chunk()
                else:
                    self._dispatch_chunk()

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
        hit = None
        held: List[object] = []
        swapin_plan = None
        if self._prefix is not None:
            candidate = self._prefix.match(request.prompt.tolist())
            if candidate:
                if cfg.prefix_dram_blocks:
                    with self._demote_burst():
                        swapin_plan = self._prefix.acquire_swapin(candidate)
                    if swapin_plan is not None:
                        hit = candidate
                        held.extend(candidate.nodes)
                elif self._prefix.acquire(candidate):
                    hit = candidate
                    held.extend(candidate.nodes)
            with self._stats_lock:
                self._stats["prefix_hits" if hit is not None
                            else "prefix_misses"] += 1
        if hit is None and not use_chunks:
            self._insert_request(request, slot)
            return
        # Tabled before any dispatch: a crash mid-prefill fails it too.
        self._slot_table[slot] = _Slot(request=request, tokens=[],
                                       prefix_nodes=held)
        if swapin_plan:
            self._dispatch_swapin(swapin_plan)
        if hit is not None and hit.tokens:
            if self._paged:
                self._attach_prefix(slot, hit)
            else:
                self._dispatch_copy(request, slot, hit)
        width = cfg.prefill_chunk_tokens if use_chunks else request.bucket_len
        self._prefill_tasks.append(_PrefillTask(
            request=request, slot=slot, chunk_width=width,
            next_pos=hit.tokens if hit is not None else 0, hit=hit))

    def _set_table_row(self, slot: int, blocks) -> None:
        """Point the leading pages of ``slot`` at pool ``blocks``, the
        rest at the slot row (stream-ordered after every dispatch that
        read the old row)."""
        row = torch.full((self._n_pages,), -1, dtype=torch.int32)
        row[:len(blocks)] = torch.as_tensor(list(blocks), dtype=torch.int32)
        self._block_table[slot].copy_(row)

    def _attach_prefix(self, slot: int, hit: PrefixHit) -> None:
        """The attach route's whole hit: the slot's leading pages read
        the hit's pool blocks in place, pinned until the slot retires."""
        self._set_table_row(slot, hit.blocks)
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
        self._last_dispatch_ts = time.perf_counter()
        self._grid_cache = generation.copy_prefix_program(
            self._grid_cache, self._prefix_pool, ids, slot)

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
        self._last_dispatch_ts = time.perf_counter()
        self._grid_cache, logits = generation.prefill_chunk_program(
            self.params, self._grid_cache, torch.from_numpy(tokens), start,
            clen, task.slot, self.config, **self._paged_kwargs())
        task.next_pos = start + clen
        with self._stats_lock:
            self._stats["prefill_chunks"] += 1
            widths = self._stats["prefill_chunk_widths"]
            widths[width] = widths.get(width, 0) + 1
        if task.next_pos >= request.prompt_len:
            self._prefill_tasks.popleft()
            self._finalize_insert(task, logits)

    def _finalize_insert(self, task: _PrefillTask, logits) -> None:
        """Arm a fully prefilled slot from its last chunk's logits, save
        the prompt's new prefix blocks, activate or retire it."""
        request, slot = task.request, task.slot
        self._slot_state, tok0 = generation.finalize_slot_program(
            self._slot_state, logits, request.prompt_len, slot,
            request.max_new_tokens, self.config,
            sample=self.serve_config.sample, generator=self._generator)
        tok0 = int(tok0)  # the finalize's one host sync
        entry = self._slot_table[slot]
        entry.tokens = [tok0]
        entry.first_token_ts = time.perf_counter()
        self._save_prefix_blocks(request, slot, already=task.hit)
        self._activate_or_retire(slot, request, tok0)

    def _insert_request(self, request: _Request, slot: int) -> None:
        tokens = np.zeros((1, request.bucket_len), np.int32)
        tokens[0, :request.prompt_len] = request.prompt
        self._last_dispatch_ts = time.perf_counter()
        self._grid_cache, self._slot_state, tok0 = (
            generation.insert_slot_program(
                self.params, self._grid_cache, self._slot_state,
                torch.from_numpy(tokens), request.prompt_len, slot,
                request.max_new_tokens, self.config,
                sample=self.serve_config.sample, generator=self._generator,
            )
        )
        tok0 = int(tok0)  # the insert's one host sync
        self._slot_table[slot] = _Slot(request=request, tokens=[tok0],
                                       first_token_ts=time.perf_counter())
        with self._stats_lock:
            self._stats["oneshot_inserts"] += 1
        self._save_prefix_blocks(request, slot)
        self._activate_or_retire(slot, request, tok0)

    def _activate_or_retire(self, slot: int, request: _Request,
                            tok0: int) -> None:
        """After a slot's prefill: count the insert, then decode on, or
        retire at once when the first token ends the request (the
        programs' ``active0`` gate)."""
        with self._stats_lock:
            self._stats["inserts"] += 1
            self._stats["decode_slot_steps"] += 1  # the prefill emission
            self._stats["useful_decode_tokens"] += 1
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
        block of its prompt's chain until it retires."""
        if self._prefix is None:
            return
        cfg = self.serve_config
        if already is None:
            already = PrefixHit(nodes=(), tokens=0)
        with self._demote_burst():
            held, created, _ = self._prefix.insert(request.prompt.tolist(),
                                                   already)
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
        self._last_dispatch_ts = time.perf_counter()
        self._prefix_pool = generation.save_prefix_program(
            self._prefix_pool, self._grid_cache, slot, ids)

    # -- the host tier -----------------------------------------------------

    def _sync_stream(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _demote_block(self, block: int):
        """The manager's ``demote_fn``: pool row ``block``'s bytes to
        pinned host memory before the row is reused.  Inside a burst the
        download waits for the burst's end (a placeholder stands in);
        outside one it runs and is synchronised here."""
        if self._demote_batch is not None:
            deferred = _DeferredPayload()
            self._demote_batch.append((int(block), deferred))
            return deferred
        payload = generation.download_prefix_block(self._prefix_pool, block)
        self._sync_stream()
        return payload

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
        for block, deferred in batch:
            deferred.value = generation.download_prefix_block(
                self._prefix_pool, block)
        self._sync_stream()
        for _, deferred in batch:
            deferred.filled = True

    def _dispatch_swapin(self, plan) -> None:
        """Upload a promotion plan's host payloads into their fresh pool
        rows, on the current stream (not synchronised: what reads the rows
        runs after the copies on the same stream)."""
        self._last_dispatch_ts = time.perf_counter()
        for _node, block, payload in plan:
            self._prefix_pool = generation.upload_prefix_block(
                self._prefix_pool, _resolve_payload(payload), block)

    # -- decode ------------------------------------------------------------

    def _note_dispatch(self) -> float:
        """Record the host gap since the last decode dispatch ended; returns
        this dispatch's start."""
        start = time.perf_counter()
        if self._last_chunk_dispatch_end is not None:
            with self._stats_lock:
                self._dispatch_gaps.append(
                    (start - self._last_chunk_dispatch_end) * 1000.0)
        self._last_dispatch_ts = start
        return start

    @staticmethod
    def _emissions_to_host(toks, valid):
        """A decode dispatch's one host sync: tokens and validity in one
        copy."""
        host = torch.stack([toks, valid.to(torch.int32)]).cpu().numpy()
        return host[0], host[1].astype(bool)

    def _dispatch_chunk(self) -> None:
        cfg = self.serve_config
        num_slots, chunk = cfg.num_slots, cfg.chunk_tokens
        start = self._note_dispatch()
        self._grid_cache, self._slot_state, toks, valid = (
            generation.decode_chunk_program(
                self.params, self._grid_cache, self._slot_state, self.config,
                chunk_size=chunk, sample=cfg.sample,
                generator=self._generator, **self._paged_kwargs(),
            )
        )
        self._last_chunk_dispatch_end = time.perf_counter()
        toks, valid = self._emissions_to_host(toks, valid)
        emitted = int(valid.sum())
        with self._stats_lock:
            self._stats["chunk_seconds"] += time.perf_counter() - start
            self._stats["chunks"] += 1
            self._stats["decode_slot_steps"] += num_slots * chunk
            self._stats["useful_decode_tokens"] += emitted
        self._commit_emissions(toks, valid, chunk)

    def _commit_emissions(self, toks, valid, width: int) -> None:
        """Append each active slot's valid emissions (host arrays
        ``[num_slots, width]``) and retire the slots that finished."""
        eos = self.serve_config.sample.eos_id
        for slot in sorted(self._active_slots):
            entry = self._slot_table[slot]
            for i in range(width):
                if not valid[slot, i]:
                    break
                entry.tokens.append(int(toks[slot, i]))
            hit_eos = eos is not None and entry.tokens[-1] == eos
            if hit_eos or len(entry.tokens) >= entry.request.max_new_tokens:
                self._retire_slot(slot)

    def _dispatch_spec_chunk(self) -> None:
        """One draft-and-verify round: the draft proposes a ``spec_k``
        window per slot over its own cache, the target scores the window
        in one forward and commits the accepted prefix; one host copy of
        the emissions, handled as a decode chunk's."""
        cfg = self.serve_config
        num_slots, k = cfg.num_slots, cfg.draft.spec_k
        active_n = len(self._active_slots)
        start = self._note_dispatch()
        self._draft_cache, window = generation.draft_chunk_program(
            self._draft_params, self._draft_cache, self._slot_state,
            cfg.draft.config, spec_k=k)
        self._grid_cache, self._slot_state, toks, valid = (
            generation.verify_chunk_program(
                self.params, self._grid_cache, self._slot_state, window,
                self.config, sample=cfg.sample, **self._paged_kwargs()))
        self._last_chunk_dispatch_end = time.perf_counter()
        toks, valid = self._emissions_to_host(toks, valid)
        emitted = int(valid.sum())
        # Every active slot commits at least the target's token at the
        # first miss; the surplus is accepted draft tokens.
        accepted = max(emitted - active_n, 0)
        proposed = active_n * (k - 1)
        with self._stats_lock:
            self._accept_window.append((accepted, proposed))
            self._stats["chunk_seconds"] += time.perf_counter() - start
            self._stats["spec_chunks"] += 1
            self._stats["spec_emitted"] += emitted
            self._stats["spec_accepted"] += accepted
            self._stats["spec_proposed"] += proposed
            self._stats["decode_slot_steps"] += num_slots * k
            self._stats["useful_decode_tokens"] += emitted
        self._commit_emissions(toks, valid, k)

    def _dispatch_draft_prefill(self, request: _Request, slot: int) -> None:
        """The prompt of a just-armed slot into the draft's cache row, so
        the next proposal round attends over real context."""
        tokens = np.zeros((1, request.bucket_len), np.int32)
        tokens[0, :request.prompt_len] = request.prompt
        self._last_dispatch_ts = time.perf_counter()
        self._draft_cache = generation.draft_prefill_slot_program(
            self._draft_params, self._draft_cache, torch.from_numpy(tokens),
            request.prompt_len, slot, self.serve_config.draft.config)
        with self._stats_lock:
            self._stats["draft_prefills"] += 1

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
        )
        eos = cfg.sample.eos_id
        hit_eos = eos is not None and num > 0 and int(row[num - 1]) == eos
        with self._stats_lock:
            self._stats["retires"] += 1
            if not hit_eos:
                self._stats["expired"] += 1
            self._stats["completed"] += 1
            self._stats["generated_tokens"] += num
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
        live = thread is not None and thread.is_alive()
        reason = self._unhealthy_reason
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
            "last_dispatch_age_s": (
                None if last is None else time.perf_counter() - last),
            "decode_kernel": self.serve_config.decode_kernel,
            "pipeline_depth": 1,
            "spec_acceptance_rate": (
                self._rolling_acceptance() if self._spec else 0.0),
            "spec_k": self.serve_config.draft.spec_k if self._spec else 0,
            "dispatch_gap_ms": self._dispatch_gap_mean(),
            "device": str(self.device),
        }
        snap.update(self._prefix_snapshot())
        if self._continuous:
            snap["free_slots"] = free_slots
        return snap

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
        tokens / dispatched token slots, both schedulers), dispatch-gap
        percentiles and the prefix-cache keys."""
        with self._stats_lock:
            snap = dict(self._stats)
            snap["prefill_chunk_widths"] = dict(snap["prefill_chunk_widths"])
            gaps = list(self._dispatch_gaps)
        snap["mean_batch_occupancy"] = (
            snap["real_rows"] / snap["slots"] if snap["slots"] else 0.0)
        snap["mean_slot_occupancy"] = (
            snap["useful_decode_tokens"] / snap["decode_slot_steps"]
            if snap["decode_slot_steps"] else 0.0
        )
        snap["spec_acceptance_rate"] = (
            snap["spec_accepted"] / snap["spec_proposed"]
            if snap["spec_proposed"] else 0.0)
        snap["pipeline_depth"] = 1
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
