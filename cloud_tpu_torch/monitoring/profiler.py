"""Tracing / profiling on ``torch.profiler`` (port of
``cloud_tpu/monitoring/profiler.py``).

The JAX package captures ``jax.profiler`` traces for XProf; the port
captures ``torch.profiler`` traces (host ops and, on the card, every CUDA
kernel through CUPTI) as Chrome trace-event JSON, viewable in Perfetto,
``chrome://tracing`` or TensorBoard's PyTorch profiler plugin.  The same
entry styles:

* explicit API — :func:`trace` (a context manager), :func:`start_trace` /
  :func:`stop_trace`, :func:`annotate` / :func:`annotate_function`
  (``torch.profiler.record_function`` ranges) and
  :func:`save_device_memory_profile` (a ``torch.cuda.memory`` snapshot);
* env-gated auto-start — :func:`maybe_start_server_from_env`, called by
  the container bootstrap, gated on ``CLOUD_TPU_PROFILER_PORT``;
* Trainer callback — :class:`ProfilerCallback` traces a window of
  training steps with one ``ProfilerStep#<n>`` range per traced step (the
  name torch's own step markers carry).

While a trace runs, every ``monitoring.tracing`` span opened inside it is
mirrored as a range of its name (``tracing.xprof_trace_started``).

Traces land in ``<logdir>/plugins/profile/<run>/<host>_<pid>.pt.trace.json``
(the TensorBoard layout the JAX package's traces use);
:func:`last_trace_path` names the newest one this process wrote.

**The profiler server differs from XProf's.**  ``jax.profiler.start_server``
serves XProf's capture protocol, which torch does not speak.  The port's
:func:`start_server` keeps the contract "capture a trace from a live
process without restarting it" with the smallest counterpart: an HTTP
endpoint, ``GET /capture?duration_ms=N``, that profiles the whole process
for N ms into :func:`default_logdir` and answers ``{"trace": <path>}``
(:func:`request_capture` is its client).  It listens on ``localhost`` by
default; a remote capture goes through a tunnel to the host.

**Where a capture starts and stops.**  ``torch.profiler`` must be
started and stopped on one thread, and not beside a thread that runs
ops: stopping it from the server's thread during a backward pass aborts
the process, and stopping it on another thread than the one that
started it crashes.  So a capture is handed to the thread that runs the
steps: every step of ``training.train`` calls :func:`safe_point` before
its work, and while such calls keep coming, the capture starts at one
and stops at the first one ``duration_ms`` later (or at the end of
``Trainer.fit``, which calls ``safe_point(last=True)``).  A process that
runs no step loop (none seen for :data:`SAFE_POINT_QUIET_S`) is captured
on the server's thread.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import socket
import tempfile
import threading
import time
from typing import Optional

import torch

from cloud_tpu_torch.monitoring import tracing

logger = logging.getLogger(__name__)

#: Setting this env var in the job spec turns the profiler server on in
#: every remote host process (deploy.py forwards it to the bootstrap).
#: Value = port to listen on.
ENV_PROFILER_PORT = "CLOUD_TPU_PROFILER_PORT"

#: Where ProfilerCallback / trace() write when no logdir is given.
ENV_PROFILER_LOGDIR = "CLOUD_TPU_PROFILER_LOGDIR"

#: The longest on-demand capture the server takes.
MAX_CAPTURE_MS = 60_000

#: A step loop that has not reached :func:`safe_point` for this long is
#: taken to have stopped: the server then captures on its own thread.
SAFE_POINT_QUIET_S = 10.0

_lock = threading.Lock()
_active = None  # (torch.profiler.profile, logdir) of the running trace
_last_trace: Optional[str] = None
_server = None  # (ThreadingHTTPServer, thread)
_capture_lock = threading.Lock()
_pending = None  # the _Capture handed to the step loop, until it is done
_safe_seen = float("-inf")  # time.monotonic() of the last safe_point()


def default_logdir() -> str:
    return os.environ.get(
        ENV_PROFILER_LOGDIR,
        os.path.join(tempfile.gettempdir(), "cloud_tpu_profile"))


def last_trace_path() -> Optional[str]:
    """The trace file this process wrote last, or None."""
    return _last_trace


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _trace_path(logdir: str) -> str:
    run = time.strftime("%Y_%m_%d_%H_%M_%S") + f"_{time.time_ns() % 10**9:09d}"
    out = os.path.join(logdir, "plugins", "profile", run)
    os.makedirs(out, exist_ok=True)
    return os.path.join(out, f"{socket.gethostname()}_{os.getpid()}"
                             ".pt.trace.json")


def start_trace(logdir: Optional[str] = None) -> str:
    """Start a process-wide trace into ``logdir``; one at a time."""
    global _active
    logdir = logdir or default_logdir()
    with _lock:
        if _active is not None:
            raise RuntimeError("a profiler trace is already running")
        prof = torch.profiler.profile(activities=_activities())
        prof.start()
        _active = (prof, logdir)
    tracing.xprof_trace_started()
    return logdir


def stop_trace() -> str:
    """Stop the running trace, write it, and return the trace file's path.
    Work queued on the card is waited for first, so it lies inside the
    trace."""
    global _active, _last_trace
    with _lock:
        if _active is None:
            raise RuntimeError("no profiler trace is running")
        prof, logdir = _active
        _active = None
    try:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = _trace_path(logdir)
        prof.export_chrome_trace(path)
    finally:
        tracing.xprof_trace_stopped()
    _last_trace = path
    return path


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Capture a trace of the enclosed block to ``logdir`` (yields the
    logdir, as the JAX package's; :func:`last_trace_path` names the
    file)."""
    logdir = start_trace(logdir)
    try:
        yield logdir
    finally:
        stop_trace()


def annotate(name: str):
    """Named range visible on the trace's timeline."""
    return torch.profiler.record_function(name)


def annotate_function(fn=None, *, name: Optional[str] = None):
    """Decorator form of :func:`annotate` (default name: the function's
    qualified name)."""
    if fn is None:
        return functools.partial(annotate_function, name=name)
    label = name or getattr(fn, "__qualname__", repr(fn))

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    return wrapped


def save_device_memory_profile(path: Optional[str] = None, *,
                               device=None) -> str:
    """Write a ``torch.cuda.memory`` snapshot of the card's allocator
    (segments and blocks, a pickle ``torch.cuda.memory._snapshot()`` format
    that PyTorch's memory viewer reads) to ``path``.  ``device`` resolves
    as every entry point's: the card, or the CPU when asked for, which has
    no device allocator and writes an empty snapshot of the same shape."""
    import pickle

    from cloud_tpu_torch._device import resolve_device

    dev = resolve_device(device)
    path = path or os.path.join(default_logdir(), "memory.pickle")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if dev.type == "cuda":
        snapshot = torch.cuda.memory._snapshot(dev)
    else:
        snapshot = {"segments": [], "device_traces": []}
    with open(path, "wb") as f:
        pickle.dump(snapshot, f)
    return path


class ProfilerCallback:
    """Trainer callback: trace steps ``[start_step, start_step+num_steps)``.

    The JAX package's window: the trace starts at the end of step
    ``start_step - 1`` and stops at the end of step
    ``start_step + num_steps - 1``, once per fit(); each traced step runs
    inside a ``ProfilerStep#<step>`` range.
    """

    def __init__(self, logdir: Optional[str] = None, *, start_step: int = 2,
                 num_steps: int = 3):
        if num_steps < 1:
            raise ValueError("num_steps must be >= 1")
        self.logdir = logdir or default_logdir()
        self.start_step = start_step
        self.num_steps = num_steps
        self._tracing = False
        self._done = False
        self._step_span = None
        #: The trace file of the last window, once written.
        self.trace_path: Optional[str] = None

    # Callback protocol (training.trainer.Callback) -------------------
    def on_train_begin(self, trainer) -> None:
        self._done = False

    def _close_step(self) -> None:
        if self._step_span is not None:
            self._step_span.__exit__(None, None, None)
            self._step_span = None

    def _stop(self) -> None:
        self.trace_path = stop_trace()
        self._tracing = False
        self._done = True
        logger.info("profiler: wrote trace to %s", self.trace_path)

    def on_step_end(self, step: int, logs, trainer) -> None:
        self._close_step()
        if self._tracing and step >= self.start_step + self.num_steps - 1:
            self._stop()  # waits for the card's queued work first
        elif (not self._done and not self._tracing
              and step >= self.start_step - 1):
            start_trace(self.logdir)
            self._tracing = True
        if self._tracing:
            self._step_span = torch.profiler.record_function(
                f"ProfilerStep#{step + 1}")
            self._step_span.__enter__()

    def on_train_end(self, trainer) -> None:
        self._close_step()
        if self._tracing:  # fit() ended before the window closed
            self._stop()

    def on_epoch_begin(self, epoch: int, trainer) -> None: ...
    def on_epoch_end(self, epoch: int, logs, trainer) -> None: ...


# --- the on-demand capture server -----------------------------------------


class _Capture:
    """A capture the server hands to the step loop's thread."""

    def __init__(self, duration_s: float, logdir: Optional[str]):
        self.duration_s = duration_s
        self.logdir = logdir
        self.started: Optional[float] = None  # when the loop started it
        self.path: Optional[str] = None
        self.error: Optional[RuntimeError] = None
        self.done = threading.Event()


def safe_point(*, last: bool = False) -> None:
    """Mark a point between two steps on the thread that runs them: a
    pending server capture starts or stops its trace here (see the
    module's docstring).  ``last``: the loop ends here, so a capture it
    started stops now, short of its duration.  Costs a clock read when
    nothing is pending."""
    global _pending, _safe_seen
    _safe_seen = time.monotonic()
    req = _pending
    if req is None:
        return
    with _capture_lock:
        if _pending is not req:  # withdrawn by the server meanwhile
            return
        try:
            if req.started is None:
                if last:
                    return
                start_trace(req.logdir)
                req.started = time.monotonic()
                return
            if (not last and time.monotonic() - req.started
                    < req.duration_s):
                return
            req.path = stop_trace()
        except RuntimeError as exc:  # a trace of the caller's is running
            req.error = exc
        _pending = None
        req.done.set()


def _capture_here(duration_s: float, logdir: Optional[str]) -> str:
    start_trace(logdir)
    try:
        time.sleep(duration_s)
    finally:
        path = stop_trace()
    return path


def _loop_is_live() -> bool:
    return time.monotonic() - _safe_seen < SAFE_POINT_QUIET_S


def capture(duration_ms: float, logdir: Optional[str] = None) -> str:
    """Trace the whole process for ``duration_ms`` and return the trace
    file's path (what the server runs per request): on the step loop's
    thread while one reaches :func:`safe_point`, else on this thread.
    Raises ``RuntimeError`` if another trace runs, or if the loop went
    quiet inside the capture it started (that trace then stops at the
    loop's next safe point)."""
    global _pending
    duration_s = max(0.0, duration_ms) / 1e3
    if not _loop_is_live():
        return _capture_here(duration_s, logdir)
    req = _Capture(duration_s, logdir)
    with _capture_lock:
        if _pending is not None:
            raise RuntimeError("a profiler capture is already pending")
        _pending = req
    while not req.done.wait(0.05):
        if _loop_is_live():
            continue
        with _capture_lock:
            if req.done.is_set():
                break
            if req.started is not None:  # only the loop's thread may stop
                raise RuntimeError(
                    "the step loop went quiet inside its capture; the "
                    "trace stops at its next step")
            _pending = None  # the loop stopped before it started: here
        return _capture_here(duration_s, logdir)
    if req.error is not None:
        raise req.error
    return req.path


def _handler_class():
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, status: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server's hook name
            url = urlparse(self.path)
            if url.path != "/capture":
                self._reply(404, {"error": f"unknown path {url.path}"})
                return
            query = parse_qs(url.query)
            try:
                duration = float(query.get("duration_ms", ["1000"])[0])
            except ValueError:
                self._reply(400, {"error": "duration_ms must be a number"})
                return
            duration = min(max(duration, 0.0), MAX_CAPTURE_MS)
            try:
                path = capture(duration)
            except RuntimeError as exc:  # a trace is already running
                self._reply(409, {"error": str(exc)})
                return
            self._reply(200, {"trace": path, "duration_ms": duration})

        def log_message(self, fmt, *args):
            logger.info("profiler server: " + fmt, *args)

    return Handler


def start_server(port: int = 9012, *, host: str = "localhost"):
    """Start the on-demand capture server (idempotent per process); returns
    the bound ``(host, port)`` (``port=0`` picks a free one)."""
    global _server
    if _server is None:
        from http.server import ThreadingHTTPServer

        httpd = ThreadingHTTPServer((host, int(port)), _handler_class())
        httpd.daemon_threads = True
        thread = threading.Thread(target=httpd.serve_forever,
                                  name="cloud-tpu-profiler-server",
                                  daemon=True)
        thread.start()
        _server = (httpd, thread)
        logger.info("profiler server listening on %s:%d",
                    *httpd.server_address[:2])
    return _server[0].server_address[:2]


def stop_server() -> None:
    global _server
    if _server is not None:
        httpd, thread = _server
        _server = None
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def request_capture(port: int, duration_ms: float = 1000.0, *,
                    host: str = "localhost", timeout: float = 120.0) -> dict:
    """Ask a running server for one capture; returns its JSON answer."""
    from urllib.request import urlopen

    url = f"http://{host}:{int(port)}/capture?duration_ms={duration_ms}"
    with urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def maybe_start_server_from_env() -> bool:
    """Env-gated auto-start; called by ``core.bootstrap`` on every host."""
    port = os.environ.get(ENV_PROFILER_PORT)
    if not port:
        return False
    try:
        start_server(int(port))
    except Exception:  # noqa: BLE001 — a busy port must not kill the job
        logger.exception("profiler server failed to start")
        return False
    return True
