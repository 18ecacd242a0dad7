"""Compile-ahead: steps captured as CUDA graphs before their first call, a
registry of them, and a persistent kernel cache (port of
``cloud_tpu/training/compile_cache.py``).

The port runs eagerly, so there is no XLA executable to compile.  What a
first step pays on the card instead is the ``nvcc`` build and load of
the kernel libraries (``ops/dispatch.py``), cuBLAS and cuDNN set-up, the
caching allocator's first segments, and, for a window, its CUDA-graph
capture.  The port's "compiled step" is therefore the step captured as
one ``torch.cuda.CUDAGraph`` over static state and batch buffers, through
the capture path the windows use (``train._Graphed``):

* **Registry** — :func:`get_or_compile` keys :func:`aot_compile`'s
  artifacts by (step identity, context, the specs of its inputs: shape,
  dtype, device and ``requires_grad`` of every leaf), so a second fit
  over the same shapes replays the graphs it already has.  Each compile
  is spanned as ``compile/lower`` (one warm-up step on a copy of the
  state, on the capture stream: libraries built and loaded, cuBLAS and
  cuDNN set up) and ``compile/backend_compile`` (the capture).
* **Compile-ahead** — :func:`start_compile_ahead` captures a fit's
  steps on a worker thread while the prefetch thread warms, and hands
  the trainer :class:`AotStep` wrappers that dispatch through the
  artifact when the inputs match its specs and revert for good to the
  plain step on the first mismatch.  A failure is logged and kept in
  :attr:`CompileAhead.error`, never raised.
* **Persistent kernel cache** — :func:`maybe_enable_persistent_cache`
  builds and loads the kernel libraries under
  ``CLOUD_TPU_COMPILE_CACHE=<dir>`` instead of the package's ``build/``,
  after a one-time child-process probe (build or find the smallest
  library there, load it, run its kernel once against its plain version)
  whose pass a marker file in the directory records, keyed by the torch,
  CUDA and ``nvcc`` versions.  A second process or a fresh container
  then skips ``nvcc``.  The JAX package's jaxlib blocklist,
  ``CLOUD_TPU_COMPILE_CACHE_FORCE`` and ``_MIN_SECS`` guard XLA's
  executable (de)serialization and its compile-time threshold; an
  ``nvcc`` library has neither, so they have no counterpart here.

On a CPU state nothing is captured: the artifact is the eager step bound
to its specs, so the registry, the spec check and the worker behave as on
the card.  Under a mesh of more than one rank (one process per rank) the
artifact is the eager step bound to its specs too (a CUDA graph cannot
capture gloo's host-side collectives): ``compile/lower`` runs it once on
a copy of the state and a zero batch of the specs (``train._Warm``), on
the card or the CPU, which pays the first step's set-up ahead and leaves
its result unchanged.  The worker of :func:`start_compile_ahead` then
sends its collectives over axis groups of its own
(``parallel.mesh.worker_mesh``), never the main thread's.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import subprocess
import sys
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.monitoring import metrics, tracing
from cloud_tpu_torch.ops import dispatch
from cloud_tpu_torch.parallel import mesh as mesh_lib
from cloud_tpu_torch.training import train as train_lib

logger = logging.getLogger(__name__)

#: Directory of the persistent kernel cache; unset/"off" disables.
ENV_COMPILE_CACHE = "CLOUD_TPU_COMPILE_CACHE"

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# --------------------------------------------------------------------------
# Specs


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """What a step needs to know of an input ahead of it: the
    counterpart of ``jax.ShapeDtypeStruct``.  ``device`` None is a host
    array (a window's ``valid`` mask stays on the host)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: Optional[torch.device] = None
    requires_grad: bool = False


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty((0,), np.dtype(dtype))).dtype


def _spec(x, device=None) -> TensorSpec:
    """The spec of a leaf: a tensor keeps its device, a host array (or
    anything with ``.shape``/``.dtype``) gets ``device``."""
    if isinstance(x, TensorSpec):
        return x
    if torch.is_tensor(x):
        return TensorSpec(tuple(x.shape), x.dtype, x.device,
                          bool(x.requires_grad))
    if not (hasattr(x, "shape") and hasattr(x, "dtype")):
        x = np.asarray(x)
    return TensorSpec(tuple(int(d) for d in x.shape), _torch_dtype(x.dtype),
                      device)


def _map(tree, fn):
    """``fn`` over the leaves of dicts, lists and TrainStates (None
    stays None)."""
    if isinstance(tree, train_lib.TrainState):
        return train_lib.TrainState(**{
            f.name: _map(getattr(tree, f.name), fn)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return None if tree is None else fn(tree)


def _structure(tree):
    if isinstance(tree, train_lib.TrainState):
        return ("state",) + tuple(_structure(getattr(tree, f.name))
                                  for f in dataclasses.fields(tree))
    if isinstance(tree, dict):
        return ("dict",) + tuple((str(k), _structure(tree[k]))
                                 for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return ("list",) + tuple(_structure(v) for v in tree)
    return None if tree is None else "*"


def _flat(tree) -> list:
    """The leaves, in :func:`_structure`'s order (dict keys sorted)."""
    if isinstance(tree, train_lib.TrainState):
        return [x for f in dataclasses.fields(tree)
                for x in _flat(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [] if tree is None else [tree]


def abstract_state(state):
    """The TrainState's tree of :class:`TensorSpec` (shapes, dtypes,
    devices and ``requires_grad`` preserved)."""
    return _map(state, _spec)


def abstract_batch(batch, mesh=None, rules=None, *, stacked: bool = False,
                   batch_axis: str = "batch", device=None):
    """The batch's tree of :class:`TensorSpec` AS THE STEP WILL SEE IT:
    tensors keep their devices, host leaves (a concrete batch or a
    ``batch_spec`` of anything with ``.shape``/``.dtype``) get ``device``
    (``cuda`` by default; the mesh's device for this rank under
    ``mesh``), where the trainer places them.

    Under ``mesh`` the batch is this rank's rows, as ``train.shard_batch``
    takes them (the JAX package's multi-process contract: each rank's
    dataset yields its own rows), so the specs are the rows' shapes;
    ``stacked=True`` marks a window's super-batch, its leading axis the K
    steps (``shard_batch(..., stacked=True)``), whose rows are the rank's
    in every slot.  ``rules`` and ``batch_axis`` name how the global batch
    was cut into rows and change no spec."""
    del rules, stacked, batch_axis  # the rows are already this rank's
    mesh_lib.check_mesh(mesh)
    if mesh is not None and device is None:
        device = mesh.device
    device = resolve_device(device)

    def spec(x):
        if isinstance(x, TensorSpec) and x.device is None:
            return dataclasses.replace(x, device=device)
        return _spec(x, device)

    return _map(batch, spec)


def _args_key(args) -> Tuple:
    """Hashable identity of a step's inputs: their structure and every
    leaf's spec."""
    return (_structure(args), tuple(
        (s.shape, str(s.dtype), str(s.device), s.requires_grad)
        for s in (_spec(x) for x in _flat(list(args)))))


def context_key(*, mesh=None, rules=None, donation: Tuple[int, ...] = (),
                steps_per_dispatch: int = 1) -> Tuple:
    """The non-spec half of a registry key: the mesh (its axis sizes, this
    rank's coordinates and its backend), the sharding rules, the
    donation signature (the arguments a step updates in place) and K
    (the window's width)."""
    mesh_lib.check_mesh(mesh)
    mesh_key = None
    if mesh is not None:
        mesh_key = (tuple(mesh.shape.items()), tuple(sorted(
            mesh.coords.items())), mesh.backend)
    rules_key = None
    if rules is not None:
        rules_key = tuple(sorted(rules.rules.items()))
    return (mesh_key, rules_key, tuple(donation), int(steps_per_dispatch))


def _materialize(tree):
    """Zeros for every :class:`TensorSpec` leaf (on its device, with its
    ``requires_grad``); tensors pass as they are."""

    def leaf(x):
        if isinstance(x, TensorSpec):
            return torch.zeros(x.shape, dtype=x.dtype, device=x.device
                               ).requires_grad_(x.requires_grad)
        return x

    return _map(tree, leaf)


# --------------------------------------------------------------------------
# Artifacts and the registry


def aot_compile(step, *args, label: str = "step"):
    """The step's artifact for inputs like ``args`` (concrete tensors,
    :class:`TensorSpec` trees, or a mix), spanned ``compile/lower`` and
    ``compile/backend_compile``.

    ``step`` is one of the port's steps (``make_train_step``,
    ``make_multi_step``, ``make_eval_step``).  On a CUDA state the step
    is warmed up once on a copy of the state and captured as a CUDA
    graph: a concrete state becomes the graph's static state, a spec
    tree gives zeros, and the batch gets static buffers of its own.  A
    K-step window is captured for its full set of slots (a tail's slots
    get their graph at first use).  On a CPU state the step is bound as
    it is.  Under a mesh of more than one rank (``step.eager``) the step
    is bound as it is after one warm-up on a copy of the state (a
    collective: every rank compiles the same steps in the same order).
    The artifact is called like the step, with inputs matching ``args``'
    specs (:class:`AotStep` checks them)."""
    first = _flat(args[0])
    device = getattr(first[0], "device", None) if first else None
    arg_keys = tuple(_args_key((a,)) for a in args)
    eager = getattr(step, "eager", False)
    if not eager and (device is None or torch.device(device).type != "cuda"):
        with tracing.span("compile/lower", fn=label):
            pass
        with tracing.span("compile/backend_compile", fn=label):
            artifact = train_lib._Bound(step)
        artifact.arg_keys = arg_keys
        return artifact
    if not hasattr(step, "graph_artifact"):
        raise TypeError(
            f"aot_compile: {label} is not a step of training.train "
            "(make_train_step, make_multi_step or make_eval_step)")
    artifact, graphed, key = step.graph_artifact()
    # The static batch is allocated from the batch's shapes and dtypes.
    graphed.prepare(_materialize(args[0]), args[1])
    with tracing.span("compile/lower", fn=label):
        graphed.warm_up(key)
    with tracing.span("compile/backend_compile", fn=label):
        graphed.capture(key)
    artifact.arg_keys = arg_keys
    return artifact


_registry: Dict[Tuple, Tuple[Any, Any]] = {}
_registry_lock = threading.Lock()

#: Registry bound: an entry holds STRONG refs to the step (its closure,
#: optimizer) and its artifact (a graph's static state, batch and private
#: memory pool), so an unbounded registry would grow linearly in a
#: long-lived process that keeps building Trainers (a tuner loop).
#: FIFO-evict past this; an evicted fit captures once more.
REGISTRY_MAX_ENTRIES = 64


def get_or_compile(step, args, *, context: Tuple = (), label: str = "step"):
    """Registry-memoized :func:`aot_compile`.

    The key is (step identity, context, the specs of ``args``); the entry
    holds a strong ref to ``step`` so a recycled ``id()`` can never alias
    a dead step's artifact.  Bounded at :data:`REGISTRY_MAX_ENTRIES`
    (FIFO); :func:`clear_registry` drops everything."""
    key = (id(step), context, _args_key(args))
    with _registry_lock:
        entry = _registry.get(key)
    if entry is not None and entry[0] is step:
        metrics.counter_inc("compile/registry_hit")
        return entry[1]
    metrics.counter_inc("compile/registry_miss")
    compiled = aot_compile(step, *args, label=label)
    with _registry_lock:
        while len(_registry) >= REGISTRY_MAX_ENTRIES:
            _registry.pop(next(iter(_registry)))
        _registry[key] = (step, compiled)
    return compiled


def clear_registry() -> None:
    with _registry_lock:
        _registry.clear()


def registry_size() -> int:
    with _registry_lock:
        return len(_registry)


class AotStep:
    """Dispatch wrapper: the artifact when the inputs match its specs, the
    plain step otherwise.

    The specs are checked before anything is copied into a graph's static
    buffers (a state that IS the graph's static state skips its own
    check: only the batch's few leaves are compared).  The first mismatch
    reverts this wrapper to the plain step for good (shapes are stable
    within a fit; a mismatch means the caller moved on to other shapes)."""

    __slots__ = ("step", "label", "_compiled")

    def __init__(self, step, label: str = "step"):
        self.step = step
        self.label = label
        self._compiled = None

    @property
    def compiled(self):
        return self._compiled

    def attach(self, compiled) -> None:
        self._compiled = compiled

    def _mismatch(self, compiled, args) -> Optional[str]:
        want = compiled.arg_keys
        if len(args) != len(want):
            return f"{len(args)} arguments, compiled for {len(want)}"
        for i, (arg, key) in enumerate(zip(args, want)):
            if i == 0 and arg is not None and arg is compiled.static_state:
                continue
            if _args_key((arg,)) != key:
                return f"argument {i}'s specs differ"
        return None

    def __call__(self, *args):
        compiled = self._compiled
        if compiled is not None:
            why = self._mismatch(compiled, args)
            if why is None:
                return compiled(*args)
            logger.warning(
                "compile-ahead artifact for %s rejected its inputs (%s); "
                "falling back to the plain step", self.label, why,
            )
            self._compiled = None
        return self.step(*args)


# --------------------------------------------------------------------------
# Background compile-ahead


class CompileAhead:
    """A fit's background-compile plan: AotStep wrappers + the worker.

    ``wait(label)`` blocks until that ONE job has compiled (spanned as
    ``compile/ahead_wait``: with prefetch warming in parallel this is ~0
    by the time the first batch arrives, which is the point); jobs queued
    after it (the eval step rides behind the train step) keep compiling
    in the background and never delay the first dispatch.  ``wait()``
    with no label joins the whole worker.  A compile failure is recorded
    in ``error`` and logged, never raised: the wrappers stay on the plain
    step."""

    def __init__(self, steps: Dict[str, AotStep]):
        self.steps = steps
        self.error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._done = {label: threading.Event() for label in steps}

    def _launch(self, jobs, device, mesh=None) -> None:
        # Under a mesh the worker's collectives go through groups of its
        # own, made here on every rank, in order, before it starts.
        side = None if mesh is None else mesh_lib.worker_mesh(mesh)

        def worker():
            if device is not None and device.type == "cuda":
                # The device is a property of the thread.
                torch.cuda.set_device(device)
            if side is None:
                run_jobs()
            else:
                with mesh_lib.route(mesh, side):
                    run_jobs()

        def run_jobs():
            for aot_step, args, ctx in jobs:
                try:
                    if callable(args):
                        # Deferred specs (the eval job peeking the
                        # validation data's first batch): resolved HERE,
                        # off the main thread, after the jobs before it.
                        args = args()
                    if args is None:
                        continue  # the thunk found nothing to compile
                    aot_step.attach(get_or_compile(
                        aot_step.step, args, context=ctx,
                        label=aot_step.label,
                    ))
                except Exception as exc:  # noqa: BLE001 — advisory only
                    self.error = exc
                    logger.warning(
                        "compile-ahead of %s failed (%r); that step runs "
                        "its plain form instead", aot_step.label, exc,
                    )
                finally:
                    self._done[aot_step.label].set()

        self._thread = threading.Thread(
            target=worker, daemon=True, name="cloud-tpu-compile-ahead"
        )
        self._thread.start()

    def wait(self, label: Optional[str] = None,
             timeout: Optional[float] = None) -> None:
        if label is not None:
            event = self._done.get(label)
            if event is None or event.is_set():
                return
            with tracing.span("compile/ahead_wait", fn=label):
                event.wait(timeout)
            return
        thread = self._thread
        if thread is None or not thread.is_alive():
            return
        with tracing.span("compile/ahead_wait"):
            thread.join(timeout)


def start_compile_ahead(jobs, *, device=None, mesh=None) -> CompileAhead:
    """Launch a background compile of ``jobs``.

    ``jobs`` is a list of ``(AotStep, args, context_key)`` triples,
    compiled strictly in order on one worker thread (``device``, when
    given, is made the worker's current card).  ``args`` may instead be
    a zero-arg callable, resolved on the worker right before that job
    (return None to skip the job), for specs that themselves cost a
    blocking peek, like the eval step's validation batch.

    Under ``mesh`` (a mesh of more than one rank; this process is one
    rank, and every rank starts the same jobs) each job's warm-up runs
    a step under the mesh on the worker while the main thread goes on
    (restoring shards, stepping, validating, each with collectives).  On
    one set of groups two threads' collectives could pair differently on
    different ranks, so the worker's go through a second set of axis
    groups (``parallel.mesh.worker_mesh``, made here, on every rank in
    the same order, before the worker starts; ``parallel.mesh.route``
    sends every collective over ``mesh`` from the worker's thread
    through them).  A failed job is logged and kept in
    :attr:`CompileAhead.error`; the other ranks' workers then wait out
    their groups' timeout on its collectives."""
    steps = {job[0].label: job[0] for job in jobs}
    plan = CompileAhead(steps)
    plan._launch(jobs, None if device is None else torch.device(device),
                 mesh_lib.effective_mesh(mesh))
    return plan


# --------------------------------------------------------------------------
# Persistent kernel cache

_persist_lock = threading.Lock()
_persist_state: Dict[str, Any] = {"checked": False, "enabled": False,
                                  "dir": None}

#: The child probe: build (or find) the smallest kernel library, K5's,
#: under the cache directory, load it, run it once at a tiny shape
#: against its plain version, and print the marker.  A crash, a failed
#: build or a wrong answer is a nonzero exit or a missing marker.
_PROBE_SOURCE = """
import sys
import torch
from cloud_tpu_torch.ops import dispatch, flash_attention

dispatch.set_build_dir(sys.argv[1])
dispatch.load("flash_fwd")
gen = torch.Generator().manual_seed(0)
q, k, v = (torch.randn(1, 64, 2, 64, generator=gen).cuda() for _ in range(3))
got = flash_attention.flash_attention(q, k, v, causal=True)
want, _ = flash_attention._reference_with_lse(q, k, v, causal=True, mask=None)
torch.cuda.synchronize()
err = float((got.float() - want.float()).abs().max())
assert err <= 1e-4, f"K5 against its plain version: {err}"
print("CLOUD_TPU_CACHE_PROBE_OK")
"""

_PROBE_OK_MARKER = "CLOUD_TPU_CACHE_PROBE_OK"


def _probe_marker_path(cache_dir: str) -> str:
    return os.path.join(
        cache_dir,
        f".cloud_tpu_torch_probe_ok-torch{torch.__version__}"
        f"-cuda{torch.version.cuda}-nvcc"
        + "".join(c if c.isalnum() or c in ".-_" else "_"
                  for c in dispatch.nvcc_version()),
    )


def _run_probe_child(cache_dir: str, timeout: float) -> Tuple[int, str]:
    """Run the probe in a child; returns (returncode, output).  Any crash
    is a nonzero returncode here, not a dead training job."""
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _PROBE_SOURCE, cache_dir],
            capture_output=True, text=True, timeout=timeout, env=env,
        )
    except subprocess.TimeoutExpired:
        return -1, "probe timed out"
    except OSError as exc:
        return -1, f"probe failed to launch: {exc}"
    return proc.returncode, (proc.stdout or "") + (proc.stderr or "")


def _decide(enabled: bool, cache_dir: str) -> bool:
    with _persist_lock:
        _persist_state.update(checked=True, enabled=enabled, dir=cache_dir)
    return enabled


def maybe_enable_persistent_cache(cache_dir: Optional[str] = None, *,
                                  probe_timeout: float = 120.0) -> bool:
    """Build and load the kernel libraries under the cache directory iff
    the probe passed there.

    Reads ``CLOUD_TPU_COMPILE_CACHE`` (or the explicit ``cache_dir``);
    unset / empty / ``off`` / ``0`` / ``false`` means disabled, and this
    is a cheap no-op (libraries build where they always do), safe to call
    from every ``Trainer.fit``.  The decision is made once per process
    and cached; pass a different explicit ``cache_dir`` to re-decide.
    Enablement needs the one-time child-process probe to pass, or the
    marker a passing probe left in the directory for these torch, CUDA
    and ``nvcc`` versions (which is what gives a second process its warm
    start without probing again)."""
    explicit = cache_dir is not None
    if cache_dir is None:
        cache_dir = os.environ.get(ENV_COMPILE_CACHE, "")
    if not cache_dir or cache_dir.strip().lower() in ("off", "0", "false"):
        return False
    with _persist_lock:
        if _persist_state["checked"] and (
                not explicit or _persist_state["dir"] == cache_dir):
            return _persist_state["enabled"]
    try:
        os.makedirs(cache_dir, exist_ok=True)
    except OSError as exc:
        logger.warning("kernel cache dir %s unusable: %s", cache_dir, exc)
        return _decide(False, cache_dir)
    marker = _probe_marker_path(cache_dir)
    if not os.path.exists(marker):
        with tracing.span("compile/cache_probe"):
            rc, out = _run_probe_child(cache_dir, probe_timeout)
        if rc != 0 or _PROBE_OK_MARKER not in out:
            logger.warning(
                "persistent kernel cache DISABLED: probe failed (rc=%s): %s",
                rc, out.strip()[-500:],
            )
            metrics.counter_inc("compile/cache_probe_failed")
            return _decide(False, cache_dir)
        # Several ranks of one host may probe into one directory at once:
        # the marker lands whole by a rename, as the libraries do.
        tmp = f"{marker}.tmp-{os.getpid()}-{threading.get_ident()}"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(out.strip()[-200:] + "\n")
            os.replace(tmp, marker)
        except OSError:
            pass  # the marker is an optimization; the next process probes
    dispatch.set_build_dir(cache_dir)
    logger.info("persistent kernel cache enabled at %s", cache_dir)
    metrics.counter_inc("compile/cache_enabled")
    return _decide(True, cache_dir)


def persistent_cache_enabled() -> bool:
    with _persist_lock:
        return bool(_persist_state["enabled"])


def _reset_persistent_state_for_tests() -> None:
    """Forget the once-per-process decision and build where the package
    builds by default."""
    with _persist_lock:
        was_enabled = _persist_state["enabled"]
        _persist_state.update(checked=False, enabled=False, dir=None)
    if was_enabled:
        dispatch.set_build_dir(None)
