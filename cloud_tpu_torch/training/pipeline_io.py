"""Pipelined input engine: device prefetch and multi-step windowing (port
of ``cloud_tpu/training/pipeline_io.py``).

* :func:`prefetch_to_device` — a background thread runs host-side decode
  and the host-to-device copy up to ``size`` batches ahead of the
  consumer (double-buffering by default), so host input and device
  compute overlap instead of alternating.  Works for any zero-arg-callable
  dataset (``data.ArrayDataset``, plain generators).
* :func:`prefetch_windows` / :func:`iter_windows` — the input side of the
  fused multi-step dispatch (``train.make_multi_step``): group K
  consecutive batches, stack them into one super-batch with a leading
  step axis, and place it on the device (in the background thread for the
  prefetching variant).  A short tail window (dataset exhausted
  mid-window) is zero-padded to the full window shape with a per-step
  validity mask, so the consumer replays the window's graph for the
  valid slots instead of falling back to single steps.

Placement on the card: a host batch is copied into pinned memory, then to
the device with ``non_blocking`` copies (a pageable copy would synchronise
the stream).  The background worker copies on a side stream of its own
and records an event after the copies; when the consumer takes the batch
(on its own thread) its current stream waits on that event, and each
tensor is marked as used by that stream (``record_stream``), so the
caching allocator does not hand the memory out again while a step still
reads it.  A pinned staging buffer is freed only once its copy has run
(the caching host allocator waits on the copy).  On the CPU a batch
becomes CPU tensors.

The consumer-facing wait is spanned as ``step/prefetch_wait``: with the
queue warm it is ~0 (input is not the bottleneck); when it dominates the
step, the host pipeline — not the device — is the thing to fix.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.bridge import leaves, map_leaves
from cloud_tpu_torch.monitoring import metrics, tracing
from cloud_tpu_torch.parallel import mesh as mesh_lib
from cloud_tpu_torch.parallel import sharding

#: Thread-name prefix for every background prefetch worker, so tests (and
#: operators reading py-spy dumps) can find — and assert the absence of —
#: leaked workers via ``threading.enumerate()``.
PREFETCH_THREAD_NAME = "cloud-tpu-prefetch"


class PrefetchIterator:
    """Drains a background thread that decodes and places batches.

    ``place(item)`` runs on the worker; ``deliver(placed)`` runs on the
    consumer's thread when :meth:`__next__` hands the item over (the
    device placement makes the consumer's stream wait for the worker's
    copies there).  Abandoning the iterator mid-epoch (``steps_per_epoch``
    breaks out of the loop) must not leak the worker: ``close()`` — also
    wired to GC via ``__del__`` — sets a stop flag the worker checks
    around its bounded ``put``, so the thread exits.
    """

    _DONE = object()

    def __init__(self, source: Iterator, place: Callable, size: int,
                 deliver: Optional[Callable] = None):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, size))
        self._stop = threading.Event()
        self._exhausted = False
        self._deliver = deliver
        # The worker must NOT capture ``self``: the Thread object would
        # then keep the iterator alive, ``__del__`` could never fire for
        # an abandoned iterator, and the worker (blocked on its bounded
        # put) would leak forever.  It closes over only the queue, the
        # stop flag, and this one-slot error box.
        self._error_box: list = []
        out_queue, stop, error_box = self._queue, self._stop, self._error_box
        done = self._DONE

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out_queue.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in source:
                    if not put(place(batch)):
                        return
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                error_box.append(exc)
            finally:
                close = getattr(source, "close", None)
                if close is not None:
                    close()
                put(done)

        self._thread = threading.Thread(
            target=worker, daemon=True, name=PREFETCH_THREAD_NAME
        )
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        # Exhausted stays exhausted: a consumer that iterates again must
        # get StopIteration, not a forever-block on the empty queue.
        if self._exhausted:
            raise StopIteration
        # The get() is the consumer's actual input-wait: ~0 while the
        # worker keeps the queue warm, the full host-pipeline latency when
        # input is the bottleneck.
        with tracing.span("step/prefetch_wait"):
            item = self._queue.get()
        if item is self._DONE:
            self._exhausted = True
            self._thread.join()
            if self._error_box:
                raise self._error_box[0]
            raise StopIteration
        return item if self._deliver is None else self._deliver(item)

    def close(self) -> None:
        self._stop.set()
        # Unblock a worker stuck on a full queue, then let it finish.
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __del__(self):
        if getattr(self, "_thread", None) is not None and self._thread.is_alive():
            self.close()


class _Staged:
    """A placed item whose copies were issued on a worker's side stream:
    the item, the event recorded after its copies, and the device."""

    __slots__ = ("item", "event", "device")

    def __init__(self, item, event, device):
        self.item, self.event, self.device = item, event, device


def _host_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))


def _to_device(x, device: torch.device) -> torch.Tensor:
    """One leaf on ``device``: a tensor already there passes through; on
    the card a host leaf goes through a pinned buffer and a
    ``non_blocking`` copy on the current stream."""
    x = _host_tensor(x)
    if x.device == device:
        return x
    if device.type != "cuda" or x.device.type != "cpu":
        return x.to(device)
    pinned = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    pinned.copy_(x)
    return pinned.to(device, non_blocking=True)


def place_batch(batch, device=None):
    """Place a host batch (nested dicts/lists of numpy arrays or tensors)
    on ``device`` (``cuda`` by default), in the current stream's order;
    leaves already there pass through.  The port's ``shard_batch`` without
    a mesh."""
    device = resolve_device(device)
    return map_leaves(batch, lambda x: _to_device(x, device))


def _place_window(item, device: torch.device):
    """``place_batch`` of a window's ``(n, payload, valid)``: a stacked
    payload, or each batch of a ragged one; ``valid`` stays on the host
    (the window reads it there)."""
    n, payload, valid = item
    if valid is None:
        return n, [place_batch(b, device) for b in payload], None
    return n, place_batch(payload, device), valid


def _deliver(staged: _Staged):
    """On the consumer's thread: its current stream waits on the worker's
    copies, and each device tensor is marked used by that stream."""
    stream = torch.cuda.current_stream(staged.device)
    stream.wait_event(staged.event)
    for t in leaves(staged.item):
        if torch.is_tensor(t) and t.device.type == "cuda":
            t.record_stream(stream)
    return staged.item


def _placer(device: torch.device, window: Optional[int]):
    """The worker's ``place`` (a batch, or a window of K host batches,
    stacked first) and the consumer's ``deliver`` for one iterator; on the
    card the copies go on a side stream of the iterator's own."""
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def place_item(item):
        if window is None:
            metrics.counter_inc("data/host_to_device_batches")
            return place_batch(item, device)
        item = _window_item(item, window)
        metrics.counter_inc("data/host_to_device_batches", item[0])
        return _place_window(item, device)

    if stream is None:
        return place_item, None

    def place(item):
        with torch.cuda.stream(stream):
            placed = place_item(item)
            event = torch.cuda.Event()
            event.record(stream)
        return _Staged(placed, event, device)

    return place, _deliver


def _device_of(mesh, device) -> torch.device:
    """``device``, else the mesh's device for this rank, else ``cuda``."""
    mesh_lib.check_mesh(mesh)
    if mesh is not None and device is None:
        device = mesh.device
    return resolve_device(device)


def prefetch_to_device(
    dataset: Callable[[], Iterator],
    *,
    mesh=None,
    rules=None,
    size: int = 2,
    limit: Optional[int] = None,
    device=None,
) -> Callable[[], Iterator]:
    """Wrap a dataset so batches are transferred ahead of consumption.

    A background thread runs host-side decode and the copy to ``device``
    (``cuda`` by default; ``"cpu"`` makes CPU tensors) up to ``size``
    batches ahead: device compute and host input overlap instead of
    alternating.  Returns the same zero-arg-callable contract, so it drops
    into ``Trainer.fit`` (placement passes already-placed tensors through).

    ``limit`` caps batches per iterator: the trainer threads
    ``steps_per_epoch`` through so the worker never decodes and transfers
    batches past the epoch budget only to have them discarded.
    Under ``mesh`` (a ``parallel.mesh.Mesh``; this process is one rank)
    the batches are this rank's rows, as ``train.shard_batch`` takes them,
    placed on the mesh's device; ``rules`` changes nothing (the rows are
    already the rank's).
    """
    del rules  # the rows are already this rank's (train.shard_batch)
    device = _device_of(mesh, device)

    def factory():
        source = iter(dataset())
        if limit is not None:
            source = _bounded(source, limit)
        place, deliver = _placer(device, None)
        return PrefetchIterator(source, place, size, deliver)

    factory._cloud_tpu_prefetched = True  # Trainer: don't double-wrap
    _forward_data_state(factory, dataset)
    return factory


def _bounded(source: Iterator, limit: int) -> Iterator:
    """islice that also closes the underlying iterator when dropped.

    Checks the budget BEFORE pulling: the worker must never block in (or
    spend decode on) a next() whose result the budget already excludes.
    """
    try:
        taken = 0
        while taken < limit:
            try:
                item = next(source)
            except StopIteration:
                return
            taken += 1
            yield item
    finally:
        close = getattr(source, "close", None)
        if close is not None:
            close()


def _forward_data_state(factory, dataset) -> None:
    """Expose the wrapped dataset's exactly-once resume hooks on the
    factory, so a pre-wrapped dataset handed to ``Trainer.fit`` can still
    be fast-forwarded by a restored iterator state."""
    for name in ("state_dict", "load_state_dict"):
        hook = getattr(dataset, name, None)
        if hook is not None:
            setattr(factory, name, hook)


def is_prefetched(dataset) -> bool:
    """True for factories already wrapped by :func:`prefetch_to_device` /
    :func:`prefetch_windows` (the Trainer must not stack a second worker
    thread — and a second redundant placement — on top)."""
    return bool(getattr(dataset, "_cloud_tpu_prefetched", False))


def stack_batches(batches: Sequence[dict]):
    """Stack K host batches into one super-batch with a leading step axis.

    Leaves must be host arrays (the windowing pipelines stack BEFORE
    placement; stacking device tensors would pull them back to host).
    """
    if not batches:
        raise ValueError("stack_batches needs at least one batch")
    first = batches[0]
    if isinstance(first, dict):
        return {k: stack_batches([b[k] for b in batches]) for k in first}
    if isinstance(first, (list, tuple)):
        return [stack_batches([b[i] for b in batches])
                for i in range(len(first))]
    return np.stack([np.asarray(x) for x in batches])


def windowed(source: Iterator, k: int, limit: Optional[int] = None) -> Iterator[List]:
    """Group ``source`` into lists of up to ``k`` consecutive batches.

    The final window may be short (dataset exhausted mid-window).
    ``limit`` caps the TOTAL number of batches taken — the trainer threads
    ``steps_per_epoch`` through here so a fused window never overshoots
    the epoch's step budget (a stacked super-batch cannot be un-pulled).
    """
    if k < 1:
        raise ValueError(f"window size must be >= 1, got {k}")
    buf: List = []
    taken = 0
    try:
        if limit is not None and limit <= 0:
            return
        for batch in source:
            buf.append(batch)
            taken += 1
            exhausted = limit is not None and taken >= limit
            if len(buf) == k or exhausted:
                yield buf
                buf = []
            if exhausted:
                return
        if buf:
            yield buf
    finally:
        close = getattr(source, "close", None)
        if close is not None:
            close()


def _window_item(window: List, k: int) -> Tuple[int, object, object]:
    """A window (list of host batches) as ``(n_steps, payload, valid)``,
    still on the host.

    ``payload`` is normally a stacked super-batch with leading axis
    exactly ``k``: a tail window shorter than k is zero-padded up to the
    window shape and ``valid`` (float32 ``[k]``, on the host: the window
    reads it there) marks the real steps, so the consumer replays the
    window for its valid slots (``train.make_multi_step``'s ``valid``).

    A RAGGED window — batches whose own leaf shapes differ, e.g. a
    ``drop_remainder=False`` dataset's short final batch — cannot stack:
    it becomes ``(n, [per-step batches], None)`` and the consumer runs
    those as single steps (``valid is None`` is the marker).
    """
    n = len(window)

    def signature(batch):
        return [np.shape(leaf) for leaf in leaves(batch)]

    first_sig = signature(window[0])
    if any(signature(b) != first_sig for b in window[1:]):
        return n, list(window), None
    stacked, valid = sharding.pad_batch(stack_batches(window), k)
    return n, stacked, valid


def prefetch_windows(
    dataset: Callable[[], Iterator],
    steps_per_dispatch: int,
    *,
    mesh=None,
    rules=None,
    size: int = 2,
    limit: Optional[int] = None,
    device=None,
) -> Callable[[], Iterator]:
    """Background-prefetched K-step windows for the fused dispatch path.

    The worker thread gathers ``steps_per_dispatch`` host batches, stacks
    them into one super-batch (leading step axis), and places it on
    ``device`` ``size`` windows ahead of the consumer.  Yields
    ``(n_steps, payload, valid)``; a short tail window arrives zero-padded
    to the full window shape with ``valid`` marking its real steps (see
    :func:`_window_item`), padded on the worker thread, off the dispatch
    path.

    Under ``mesh`` (this process is one rank) the dataset yields this
    rank's rows, as ``train.shard_batch`` takes them, and the payload
    stacks them in ``shard_batch(..., stacked=True)``'s layout (the K
    steps first), placed on the mesh's device unless ``device`` is
    given; ``rules`` changes nothing (the rows are already the rank's).
    Every rank's dataset must yield as many batches, so that the ranks'
    windows, and their tails' masks, agree (``train.make_multi_step``
    checks the masks).
    """
    del rules  # the rows are already this rank's (train.shard_batch)
    device = _device_of(mesh, device)

    def factory():
        place, deliver = _placer(device, steps_per_dispatch)
        return PrefetchIterator(
            windowed(iter(dataset()), steps_per_dispatch, limit), place,
            size, deliver)

    factory._cloud_tpu_prefetched = True
    _forward_data_state(factory, dataset)
    return factory


def iter_windows(
    dataset: Callable[[], Iterator],
    steps_per_dispatch: int,
    *,
    mesh=None,
    rules=None,
    limit: Optional[int] = None,
    device=None,
) -> Callable[[], Iterator]:
    """Synchronous sibling of :func:`prefetch_windows` (``prefetch=0``):
    the same ``(n_steps, payload, valid)`` stream, no background thread,
    copies in the caller's stream order (under ``mesh`` as there)."""
    del rules  # the rows are already this rank's (train.shard_batch)
    device = _device_of(mesh, device)

    def factory():
        for window in windowed(iter(dataset()), steps_per_dispatch, limit):
            yield _place_window(_window_item(window, steps_per_dispatch),
                                device)

    _forward_data_state(factory, dataset)
    return factory
