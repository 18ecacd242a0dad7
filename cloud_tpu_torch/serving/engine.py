"""Continuous-batching serving engine (port of ``cloud_tpu/serving/engine.py``).

Iteration-level scheduling over a persistent decode grid: a static
``(num_slots, max_len)`` KV cache plus per-slot ``{pos, tok, remaining,
emitted, active}`` state live on the device for the engine's whole life.
Between decode chunks the scheduler thread retires finished slots
(per-request ``max_new_tokens`` spent, or eos sampled), resolves their
futures, and prefills queued requests into the freed slots with a
one-shot insert (``generation.insert_slot_program``: flash-attention
prefill, K/V written into the slot's cache row, first token sampled).
Each chunk (``generation.decode_chunk_program``) advances every active
slot by up to ``chunk_tokens`` tokens, reading the cache through the
paged-attention kernel with a block table of all ``-1`` (every page reads
the slot row: this slice has no prefix pool).

``ServeConfig(kv_quant=True)`` keeps the grid int8 with per-(position,
head) scales: inserts quantize the prompt's K/V, every decode step
quantizes its own, and the decode attention runs the int8 kernel K8q.
Weight-only int8 params (``models/quantization.quantize_params``) are
served as they are.

The host synchronises with the card once per insert (its first token) and
once per chunk (the chunk's emissions), never per token.  Greedy outputs
are token-identical to a direct ``generation.generate`` call per request.

The port has the continuous scheduler with depth 1, one-shot inserts,
``kv_quant``, int8 weights and ``warmup`` (kernels built and one throwaway
insert per prompt bucket and one decode chunk run on a worker thread,
``wait_ready()`` to block on it).  The engine takes every field, keyword
and method of the JAX engine; each value whose feature the port does not
have yet raises ``NotImplementedError`` naming the ROADMAP.md item that
brings it.
"""

from __future__ import annotations

import collections
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
class ServeConfig:
    """Engine knobs, with the JAX engine's names, defaults and validation.

    ``prompt_buckets`` are the padded prompt lengths (a request lands in
    the smallest bucket that fits it); the slot cache holds
    ``prompt_buckets[-1] + max_new_tokens`` positions per slot;
    ``chunk_tokens`` is the scheduling quantum.  ``decode_kernel`` keeps
    the JAX values: in this slice every setting reads the slot rows
    through the paged kernel (there is no prefix pool to attach).
    ``warmup`` builds the kernels and runs the serving programs once at
    construction (``ServingEngine.wait_ready``).  ``flush_deadline_s`` is
    stored for the batch scheduler, which is not ported yet.
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
    draft: Optional[object] = None
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
        if (self.prefill_chunk_tokens is not None
                and self.prefill_chunk_tokens < 1):
            raise ValueError(
                f"prefill_chunk_tokens must be >= 1 or None, got "
                f"{self.prefill_chunk_tokens}"
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
        if self.pipeline_depth not in (1, 2):
            raise ValueError(
                f"pipeline_depth must be 1 or 2, got "
                f"{self.pipeline_depth!r}"
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
        if self.scheduler == "batch":
            raise _later("scheduler='batch' (the batch-synchronous path)",
                         "4g")
        if self.prefix_cache_blocks or self.prefix_dram_blocks:
            raise _later("prefix_cache_blocks/prefix_dram_blocks (the prefix "
                         "cache and its pool attach through the paged "
                         "kernel)", "4a")
        if self.prefill_chunk_tokens is not None:
            raise _later("prefill_chunk_tokens (chunked prefill through the "
                         "paged kernel with Tq > 1)", "4b")
        if self.draft is not None:
            raise _later("draft= (speculative decoding)", "4c")
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
    ``num_slots``."""

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
    """Host mirror of one live decode slot (scheduler thread only)."""

    request: _Request
    tokens: List[int]
    first_token_ts: Optional[float] = None


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
    """In-process continuous-batching server over ``generation``.
    Construct, ``submit()`` from any thread, ``close()`` when done (or use
    as a context manager).  Runs on ``device`` (default ``cuda``).
    ``rules`` and ``mesh`` (sharded serving) take ``None`` only."""

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
        self._stats_lock = threading.Lock()
        self._stats = {
            "requests": 0, "completed": 0, "failed": 0, "rejected": 0,
            "generated_tokens": 0,
            "decode_slot_steps": 0, "useful_decode_tokens": 0,
            "inserts": 0, "retires": 0, "expired": 0, "chunks": 0,
            "shed": 0,
            # Host wall time of decode chunks, dispatch through the host
            # copy of their emissions (the port's own addition).
            "chunk_seconds": 0.0,
        }
        #: Rolling dispatch->dispatch host gaps (ms) between chunks.
        self._dispatch_gaps: collections.deque = collections.deque(maxlen=512)
        self._last_chunk_dispatch_end: Optional[float] = None

        self._max_len = cfg.prompt_buckets[-1] + cfg.max_new_tokens
        # The grid is updated in place by every insert and chunk (the JAX
        # engine donates it through each dispatch to the same effect).
        self._grid_cache = generation.init_slot_cache(
            config, cfg.num_slots, self._max_len, device=self.device,
            kv_quant=cfg.kv_quant)
        self._slot_state = generation.init_slot_state(
            config, cfg.num_slots, sample=cfg.sample, device=self.device)
        #: Every page of every slot reads the slot row (no prefix pool in
        #: this slice); the decode attention goes through the paged kernel.
        n_pages = -(-self._max_len // cfg.prefix_block_tokens)
        self._block_table = torch.full((cfg.num_slots, n_pages), -1,
                                       dtype=torch.int32, device=self.device)
        self._slot_table: List[Optional[_Slot]] = [None] * cfg.num_slots
        self._free_slots = list(range(cfg.num_slots))[::-1]
        self._active_slots: set = set()
        self._warmup_thread: Optional[threading.Thread] = None
        if cfg.warmup:
            self._warmup_thread = threading.Thread(
                target=self._warmup, daemon=True,
                name=SERVE_WARMUP_THREAD_NAME)
            self._warmup_thread.start()
        if start:
            self.start()

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
        engine's shapes: one insert per prompt bucket and one decode chunk,
        on a scratch grid with its own generator that are thrown away, so
        no request's slot, cache or sampling state is touched and no token
        changes.  A failure is logged; the programs then run cold."""
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
                dispatch.build_all(SERVING_LIBRARIES)
            cfg = self.serve_config
            cache = generation.init_slot_cache(
                self.config, cfg.num_slots, self._max_len, device=self.device,
                kv_quant=cfg.kv_quant)
            state = generation.init_slot_state(
                self.config, cfg.num_slots, sample=cfg.sample,
                device=self.device)
            generator = torch.Generator(device=self.device)
            with torch.no_grad():
                for bucket_len in cfg.prompt_buckets:
                    tokens = torch.ones((1, bucket_len), dtype=torch.int32)
                    cache, state, _ = generation.insert_slot_program(
                        self.params, cache, state, tokens, bucket_len, 0,
                        cfg.max_new_tokens, self.config, sample=cfg.sample,
                        generator=generator)
                _, _, toks, _ = generation.decode_chunk_program(
                    self.params, cache, state, self.config,
                    chunk_size=cfg.chunk_tokens, sample=cfg.sample,
                    generator=generator, block_table=self._block_table)
                toks.cpu()  # the card has run it
        except Exception:  # noqa: BLE001 — logged; serving still works
            logger.exception("serving warmup failed; programs run cold")

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
        raise _later("chunk_traces (the JAX engine's compile count)", "4c/4e")

    @property
    def verify_traces(self) -> int:
        raise _later("verify_traces (speculative decoding)", "4c/4e")

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

    # -- scheduler ---------------------------------------------------------

    def _scheduler_loop(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.no_grad():
                self._continuous_loop()
        except BaseException as exc:  # noqa: BLE001 — must not die silently
            logger.exception("serving scheduler crashed")
            if self._unhealthy_reason is None:
                self._unhealthy_reason = f"scheduler crashed: {exc!r}"
            with self._cond:
                self._closed = True
                self._fail_pending_locked(exc)
                self._cond.notify_all()
            self._fail_live_slots(exc)

    def _continuous_loop(self) -> None:
        """Fill free slots from the queue, run one decode chunk, retire
        what finished, repeat."""
        while True:
            inserts: List[Tuple[_Request, int]] = []
            abort = False
            with self._cond:
                while True:
                    if self._closed and not self._draining:
                        abort = True
                        break
                    self._pop_inserts_locked(inserts)
                    if inserts or self._active_slots:
                        break
                    if self._closed:
                        return  # draining and nothing left to serve
                    self._cond.wait()
            if abort:
                self._fail_live_slots(EngineClosedError(
                    "engine closed without draining in-flight requests"))
                return
            for idx, (request, slot) in enumerate(inserts):
                try:
                    self._insert_request(request, slot)
                except BaseException as exc:
                    # Popped but not yet tabled: invisible to the crash
                    # handler, so fail them here before it runs.
                    for req, _ in inserts[idx:]:
                        try:
                            req.future.set_exception(exc)
                        except InvalidStateError:  # pragma: no cover
                            pass
                    raise
            if self._active_slots:
                self._dispatch_chunk()

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
            self._stats["inserts"] += 1
            self._stats["decode_slot_steps"] += 1  # the prefill emission
            self._stats["useful_decode_tokens"] += 1
        eos = self.serve_config.sample.eos_id
        if request.max_new_tokens == 1 or (eos is not None and tok0 == eos):
            self._retire_slot(slot)  # mirrors the program's active0 gate
        else:
            self._active_slots.add(slot)

    def _dispatch_chunk(self) -> None:
        cfg = self.serve_config
        num_slots, chunk = cfg.num_slots, cfg.chunk_tokens
        start = time.perf_counter()
        if self._last_chunk_dispatch_end is not None:
            with self._stats_lock:
                self._dispatch_gaps.append(
                    (start - self._last_chunk_dispatch_end) * 1000.0)
        self._last_dispatch_ts = start
        self._grid_cache, self._slot_state, toks, valid = (
            generation.decode_chunk_program(
                self.params, self._grid_cache, self._slot_state, self.config,
                chunk_size=chunk, sample=cfg.sample,
                generator=self._generator, block_table=self._block_table,
            )
        )
        self._last_chunk_dispatch_end = time.perf_counter()
        # The chunk's one host sync: tokens and validity in one copy.
        host = torch.stack([toks, valid.to(torch.int32)]).cpu().numpy()
        toks, valid = host[0], host[1].astype(bool)
        emitted = int(valid.sum())
        with self._stats_lock:
            self._stats["chunk_seconds"] += time.perf_counter() - start
            self._stats["chunks"] += 1
            self._stats["decode_slot_steps"] += num_slots * chunk
            self._stats["useful_decode_tokens"] += emitted
        eos = cfg.sample.eos_id
        for slot in sorted(self._active_slots):
            entry = self._slot_table[slot]
            for i in range(chunk):
                if not valid[slot, i]:
                    break
                entry.tokens.append(int(toks[slot, i]))
            hit_eos = eos is not None and entry.tokens[-1] == eos
            if hit_eos or len(entry.tokens) >= entry.request.max_new_tokens:
                self._retire_slot(slot)

    def _retire_slot(self, slot: int, exc: Optional[BaseException] = None
                     ) -> None:
        """Free a slot and resolve its request's future with the result
        (the emitted row padded to the request's length) or ``exc``."""
        cfg = self.serve_config
        entry = self._slot_table[slot]
        self._slot_table[slot] = None
        self._active_slots.discard(slot)
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
        the keys this slice fills."""
        with self._cond:
            waiting = self._waiting
            closed = self._closed
            thread = self._thread
            free_slots = len(self._free_slots)
        live = thread is not None and thread.is_alive()
        reason = self._unhealthy_reason
        last = self._last_dispatch_ts
        return {
            "healthy": reason is None,
            "ready": live and not closed and reason is None,
            "live": live,
            "reason": reason,
            "closed": closed,
            "waiting": waiting,
            "queue_depth": waiting,
            "active_slots": self.serve_config.num_slots - free_slots,
            "num_slots": self.serve_config.num_slots,
            "free_slots": free_slots,
            "last_dispatch_age_s": (
                None if last is None else time.perf_counter() - last),
            "decode_kernel": self.serve_config.decode_kernel,
            "pipeline_depth": 1,
            "dispatch_gap_ms": self._dispatch_gap_mean(),
            "device": str(self.device),
        }

    def stats(self) -> dict:
        """Counters plus ``mean_slot_occupancy`` (useful emitted tokens /
        dispatched token slots) and dispatch-gap percentiles."""
        with self._stats_lock:
            snap = dict(self._stats)
            gaps = list(self._dispatch_gaps)
        snap["mean_slot_occupancy"] = (
            snap["useful_decode_tokens"] / snap["decode_slot_steps"]
            if snap["decode_slot_steps"] else 0.0
        )
        snap["pipeline_depth"] = 1
        snap["dispatch_gap_ms_p50"] = (
            float(np.percentile(gaps, 50)) if gaps else 0.0)
        snap["dispatch_gap_ms_p99"] = (
            float(np.percentile(gaps, 99)) if gaps else 0.0)
        return snap

    def _dispatch_gap_mean(self) -> float:
        with self._stats_lock:
            gaps = list(self._dispatch_gaps)
        return float(sum(gaps) / len(gaps)) if gaps else 0.0
