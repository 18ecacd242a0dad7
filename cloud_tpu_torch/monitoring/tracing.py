"""Host-side span tracing (port of ``cloud_tpu/monitoring/tracing.py``).

A span is a named host-side phase (``serve/chunk``, ``serve/prefill``
...) opened as a context manager (:func:`span`) or recorded after the
fact from two ``time.perf_counter()`` readings (:func:`record_span`).
Every finished span goes two ways:

* a ``span/<name>`` distribution in the metrics registry
  (``monitoring.metrics``);
* an in-process timeline ring buffer with running per-name aggregates,
  exportable as Chrome trace-event JSON (:func:`dump_timeline`, open in
  ``chrome://tracing`` or Perfetto; :func:`merge_timelines` joins several
  sources on one clock).

Disabled is the default and costs one function call: without an active
collector :func:`span` returns a shared no-op context manager.  Enable
with :func:`enable` or the :func:`collecting` context manager.

While a trace of the port's profiler runs (``monitoring.profiler``, which
calls :func:`xprof_trace_started` / :func:`xprof_trace_stopped`, a depth
count as in the reference), every span also enters a
``torch.profiler.record_function`` range of its name, so the trace shows
``step/compute`` and the rest beside the kernels.  Outside a trace a span
costs nothing more.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

from cloud_tpu_torch.monitoring import metrics

#: Wall-clock unix seconds of job submission, stamped into a launched job's
#: environment, so the first step can compute the true submit-to-first-step
#: latency across machines.
ENV_SUBMIT_TS = "CLOUD_TPU_SUBMIT_TS"

#: Gauge published once per submit mark by the first completed train step
#: (``Trainer.fit``).
SUBMIT_TO_FIRST_STEP_GAUGE = "run/submit_to_first_step_seconds"

_DEFAULT_CAPACITY = 100_000


class _NoopSpan:
    """Shared do-nothing span: what :func:`span` returns while disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set_attribute(self, key: str, value: Any) -> None:
        return None


_NOOP = _NoopSpan()

_tls = threading.local()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


# --- trace context (request identity) -------------------------------------

#: Process-unique trace-id suffixes (``next`` on a count is atomic in
#: CPython, so minting needs no lock).
_trace_ids = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """The identity of one request: every span the request touches stamps
    ``trace_id``.  ``parent_id`` optionally links to an enclosing span
    (0 = root)."""

    trace_id: str
    parent_id: int = 0


def new_trace_context(parent_id: int = 0) -> Optional[TraceContext]:
    """A fresh :class:`TraceContext`, or None while tracing is off (the
    field then rides inert: no span gains attributes from it)."""
    if _collector is None:
        return None
    return TraceContext(
        trace_id=f"{os.getpid():x}-{next(_trace_ids):x}",
        parent_id=parent_id,
    )


# --- timeline lanes (several engines' rows in one process) -----------------

#: Lane ids start far above any plausible OS pid, so a lane row never
#: collides with the process's own.
_LANE_BASE = 1 << 24

_lane_lock = threading.Lock()
_lane_labels: Dict[int, str] = {}
_next_lane = _LANE_BASE


def register_lane(label: str) -> int:
    """Allocate a timeline lane: a synthetic Chrome-trace ``pid`` row with
    a label.  Threads adopt it with :func:`set_thread_lane`."""
    global _next_lane
    with _lane_lock:
        lane = _next_lane
        _next_lane += 1
        _lane_labels[lane] = str(label)
        return lane


def lane_label(lane: int) -> Optional[str]:
    with _lane_lock:
        return _lane_labels.get(lane)


def set_thread_lane(lane: Optional[int]) -> None:
    """Stamp spans finished on this thread with ``pid=lane`` (None resets
    to ``os.getpid()``).  Thread-local."""
    _tls.lane = lane


def current_thread_lane() -> Optional[int]:
    return getattr(_tls, "lane", None)


def _event_pid() -> int:
    lane = getattr(_tls, "lane", None)
    return lane if lane is not None else os.getpid()


class TimelineCollector:
    """Bounded in-process buffer of finished spans plus running aggregates
    (which are never dropped, so :func:`aggregates` stays exact after the
    ring evicts)."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._evicted = 0
        self._aggregates: Dict[str, dict] = {}
        self._next_id = 1
        # Chrome-trace ts is microseconds on an arbitrary epoch: anchor it
        # so dumped timelines start near zero.
        self.epoch = time.perf_counter()

    def next_span_id(self) -> int:
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
            return span_id

    def add(self, event: dict, duration_s: float) -> None:
        with self._lock:
            self._events.append(event)
            if len(self._events) > self.capacity:
                drop = len(self._events) - self.capacity
                del self._events[:drop]
                self._evicted += drop
            agg = self._aggregates.setdefault(
                event["name"],
                {"count": 0, "total_seconds": 0.0, "max_seconds": 0.0},
            )
            agg["count"] += 1
            agg["total_seconds"] += duration_s
            if duration_s > agg["max_seconds"]:
                agg["max_seconds"] = duration_s

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def aggregates(self) -> Dict[str, dict]:
        with self._lock:
            return {
                name: {
                    **agg,
                    "mean_seconds": agg["total_seconds"] / agg["count"],
                }
                for name, agg in self._aggregates.items()
            }

    @property
    def evicted(self) -> int:
        return self._evicted

    def snapshot(self) -> dict:
        """One consistent cut for :func:`merge_timelines`: epoch, events,
        evicted count."""
        with self._lock:
            return {
                "epoch": self.epoch,
                "events": list(self._events),
                "evicted": self._evicted,
            }


_collector: Optional[TimelineCollector] = None
_collector_lock = threading.Lock()

_submit_perf: Optional[float] = None
_submit_consumed = False

# Incremented/decremented by monitoring.profiler around its traces;
# nonzero => spans mirror themselves as torch.profiler ranges.
_xprof_depth = 0


class Span:
    """A live span: times itself, records on exit.  Not reentrant."""

    __slots__ = ("name", "attributes", "span_id", "parent_id",
                 "_collector", "_start", "_annotation")

    def __init__(self, name: str, collector: TimelineCollector,
                 attributes: Optional[Dict[str, Any]]):
        self.name = name
        self.attributes = attributes
        self._collector = collector
        self.span_id = collector.next_span_id()
        self.parent_id = 0
        self._start = 0.0
        self._annotation = None

    def set_attribute(self, key: str, value: Any) -> None:
        if self.attributes is None:
            self.attributes = {}
        self.attributes[key] = value

    def __enter__(self):
        stack = _stack()
        if stack:
            self.parent_id = stack[-1].span_id
        stack.append(self)
        if _xprof_depth:
            try:
                import torch.profiler

                self._annotation = torch.profiler.record_function(self.name)
                self._annotation.__enter__()
            except Exception:  # noqa: BLE001 — tracing never kills the job
                self._annotation = None
        self._start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter()
        if self._annotation is not None:
            try:
                self._annotation.__exit__(exc_type, exc, tb)
            except Exception:  # noqa: BLE001 — tracing never kills the job
                pass
            self._annotation = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        else:  # pragma: no cover - misnested exit (generator finalization)
            try:
                stack.remove(self)
            except ValueError:
                pass
        duration = end - self._start
        collector = self._collector
        args = {"span_id": self.span_id, "parent_id": self.parent_id}
        if self.attributes:
            args.update(self.attributes)
        if exc_type is not None:
            args["error"] = exc_type.__name__
        collector.add(
            {
                "name": self.name,
                "ph": "X",
                "ts": (self._start - collector.epoch) * 1e6,
                "dur": duration * 1e6,
                "pid": _event_pid(),
                "tid": threading.get_ident(),
                "args": args,
            },
            duration,
        )
        metrics.distribution_record(f"span/{self.name}", duration)
        return False


# --- lifecycle -------------------------------------------------------------


def enabled() -> bool:
    """Cheap predicate for call sites that compute span attributes."""
    return _collector is not None


def enable(capacity: int = _DEFAULT_CAPACITY) -> TimelineCollector:
    """Install the process-wide collector (idempotent)."""
    global _collector
    with _collector_lock:
        if _collector is None:
            _collector = TimelineCollector(capacity)
        return _collector


def disable() -> None:
    global _collector
    with _collector_lock:
        _collector = None


def active() -> Optional[TimelineCollector]:
    return _collector


class collecting:
    """Context manager: a fresh collector for a block, the previous one
    restored after; ``with tracing.collecting() as c:`` gives
    ``c.events()`` and ``c.aggregates()``."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self.capacity = capacity
        self._previous: Optional[TimelineCollector] = None

    def __enter__(self) -> TimelineCollector:
        global _collector
        with _collector_lock:
            self._previous = _collector
            _collector = TimelineCollector(self.capacity)
            return _collector

    def __exit__(self, exc_type, exc, tb):
        global _collector
        with _collector_lock:
            _collector = self._previous
        return False


# --- the span API ----------------------------------------------------------


def span(name: str, **attributes: Any):
    """Open a span: ``with tracing.span("serve/chunk", slots=8): ...``.
    A shared no-op while no collector is active."""
    collector = _collector
    if collector is None:
        return _NOOP
    return Span(name, collector, attributes or None)


def record_span(name: str, start: float, end: float,
                **attributes: Any) -> None:
    """Record an already-measured interval (two ``perf_counter()``
    readings) as a finished span with no parent: for phases whose ends
    live on different threads (a request's queue wait) or that are known
    only in retrospect (a pipelined chunk's dispatch-to-drain interval,
    the host wait at its drain, the gap between two dispatches).  No-op
    while tracing is disabled."""
    collector = _collector
    if collector is None:
        return
    duration = max(0.0, end - start)
    args: Dict[str, Any] = {"span_id": collector.next_span_id(),
                            "parent_id": 0}
    args.update(attributes)
    collector.add(
        {
            "name": name,
            "ph": "X",
            "ts": (start - collector.epoch) * 1e6,
            "dur": duration * 1e6,
            "pid": _event_pid(),
            "tid": threading.get_ident(),
            "args": args,
        },
        duration,
    )
    metrics.distribution_record(f"span/{name}", duration)


def traced(fn=None, *, name: Optional[str] = None):
    """Decorator form: ``@tracing.traced`` or ``@tracing.traced(name=...)``.

    The span is named after the function (``module.qualname``) unless
    ``name`` is given.  Disabled-mode overhead is one extra call frame.
    """
    if fn is None:
        return functools.partial(traced, name=name)
    span_name = name or f"{fn.__module__.split('.')[-1]}.{fn.__qualname__}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if _collector is None:
            return fn(*args, **kwargs)
        with span(span_name):
            return fn(*args, **kwargs)

    return wrapper


def current_span() -> Optional[Span]:
    stack = _stack()
    return stack[-1] if stack else None


# --- timeline export -------------------------------------------------------


def timeline_events() -> List[dict]:
    collector = _collector
    return collector.events() if collector is not None else []


def aggregates() -> Dict[str, dict]:
    """Per-name ``{count, total_seconds, mean_seconds, max_seconds}``."""
    collector = _collector
    return collector.aggregates() if collector is not None else {}


def dump_timeline(path: str) -> str:
    """Write the active collector's spans as Chrome trace-event JSON."""
    collector = _collector
    events = collector.events() if collector is not None else []
    meta = [
        {
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "name": "process_name",
            "args": {"name": label},
        }
        for pid, label in sorted(
            (pid, lane_label(pid))
            for pid in {e["pid"] for e in events}
        )
        if label is not None
    ]
    meta += [
        {
            "ph": "M",
            "pid": pid,
            "tid": tid,
            "name": "thread_name",
            "args": {"name": _thread_name(tid)},
        }
        for pid, tid in sorted({(e["pid"], e["tid"]) for e in events})
    ]
    doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    if collector is not None and collector.evicted:
        doc["otherData"] = {"evicted_events": collector.evicted}
    return _write_timeline(doc, path)


def _write_timeline(doc: dict, path: str) -> str:
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return path


def merge_timelines(sources: Iterable[dict], path: str) -> str:
    """Merge span snapshots into one Chrome-trace JSON file.

    Each source is ``{"label", "epoch", "events", "evicted"?, "pid"?}``
    (:meth:`TimelineCollector.snapshot` plus a label; ``pid`` defaults to
    the source's position).  Every source becomes a labelled ``pid``
    lane, and each event's ``ts`` is shifted by its source's epoch offset
    against the earliest epoch, so all sources share one clock.
    """
    sources = list(sources)
    epochs = [float(s["epoch"]) for s in sources]
    base = min(epochs) if epochs else 0.0
    merged: List[dict] = []
    meta: List[dict] = []
    evicted = 0
    for index, source in enumerate(sources):
        pid = int(source.get("pid", index))
        offset_us = (float(source["epoch"]) - base) * 1e6
        meta.append({
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "name": "process_name",
            "args": {"name": str(source["label"])},
        })
        tids = set()
        for event in source["events"]:
            event = dict(event)
            event["pid"] = pid
            ts = event.get("ts")
            if isinstance(ts, (int, float)):
                event["ts"] = ts + offset_us
            if isinstance(event.get("tid"), int):
                tids.add(event["tid"])
            merged.append(event)
        meta += [
            {
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "name": "thread_name",
                "args": {"name": _thread_name(tid)},
            }
            for tid in sorted(tids)
        ]
        evicted += int(source.get("evicted") or 0)
    doc = {"traceEvents": meta + merged, "displayTimeUnit": "ms"}
    if evicted:
        doc["otherData"] = {"evicted_events": evicted}
    return _write_timeline(doc, path)


def _thread_name(tid: int) -> str:
    for thread in threading.enumerate():
        if thread.ident == tid:
            return thread.name
    return f"thread-{tid}"


# --- submit-to-first-step --------------------------------------------------


def mark_submit() -> None:
    """Record "a job was submitted now" (the JAX package's ``run()`` calls
    it; a script can too).  Arms :func:`record_submit_to_first_step`; a
    later mark re-arms (a new submission in the same process supersedes
    the old pending mark)."""
    global _submit_perf, _submit_consumed
    _submit_perf = time.perf_counter()
    _submit_consumed = False


def record_submit_to_first_step() -> Optional[float]:
    """Publish ``run/submit_to_first_step_seconds`` once per submit mark.

    Called by the trainer after its first dispatched train step.  The
    elapsed time comes from (in priority order):

    1. ``CLOUD_TPU_SUBMIT_TS`` — a wall-clock submit stamp threaded
       through the job's environment, the true cross-machine latency;
    2. the in-process :func:`mark_submit` monotonic mark.

    Returns the recorded seconds, or None when nothing is pending.
    """
    global _submit_consumed
    if _submit_consumed:
        return None
    elapsed: Optional[float] = None
    env_ts = os.environ.get(ENV_SUBMIT_TS)
    if env_ts:
        try:
            elapsed = max(0.0, time.time() - float(env_ts))
        except ValueError:
            elapsed = None
    if elapsed is None and _submit_perf is not None:
        elapsed = time.perf_counter() - _submit_perf
    if elapsed is None:
        return None
    _submit_consumed = True
    metrics.gauge_set(SUBMIT_TO_FIRST_STEP_GAUGE, elapsed)
    collector = _collector
    if collector is not None:
        collector.add(
            {
                "name": SUBMIT_TO_FIRST_STEP_GAUGE,
                "ph": "X",
                "ts": (time.perf_counter() - collector.epoch) * 1e6
                - elapsed * 1e6,
                "dur": elapsed * 1e6,
                "pid": _event_pid(),
                "tid": threading.get_ident(),
                "args": {"span_id": collector.next_span_id(), "parent_id": 0},
            },
            elapsed,
        )
    return elapsed


def clear_submit() -> None:
    """Disarm a pending submit mark (a submission that failed before it
    started must not leave a mark for a later, unrelated ``fit()`` in the
    same process to consume)."""
    global _submit_perf, _submit_consumed
    _submit_perf = None
    _submit_consumed = False


def _reset_submit_state_for_tests() -> None:
    clear_submit()


# --- profiler mirroring (driven by monitoring.profiler) -------------------


def xprof_trace_started() -> None:
    global _xprof_depth
    _xprof_depth += 1


def xprof_trace_stopped() -> None:
    global _xprof_depth
    _xprof_depth = max(0, _xprof_depth - 1)
