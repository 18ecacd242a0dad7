"""Keras-fit-parity training loop with an explicit callback protocol (port
of ``cloud_tpu/training/trainer.py``).

``Trainer.fit`` runs epochs, steps, validation, History and Callback
hooks over the port's step (``train.make_train_step``) or its K-step
window (``train.make_multi_step``, a CUDA graph on one card), fed by the
prefetch pipeline (``pipeline_io``), with the preemption drain, the
exactly-once data position and the non-finite guard of the JAX
package's trainer, stochastic steps (dropout from the state's rng
chain) and ``fit(compile_ahead=True)`` (the steps captured as CUDA
graphs on a worker thread while the prefetch thread warms,
``training.compile_cache``).  Its entry points run on the card unless
the Trainer is built with ``device="cpu"``.

Under a mesh (``mesh``, ``logical_axes``, ``rules``; one process per
rank, ``parallel/``), ``fit`` runs the step under a mesh
(``train.make_train_step(mesh=...)``): each rank's dataset yields its
own rows (the JAX package's multi-process contract: ``train.shard_batch``),
prefetched to the rank's device, with validation, callbacks and
accumulation as on one card; ``CheckpointCallback`` saves each rank's
shards and restores straight into them (``training.checkpoint``).  The
loss must be a ``train.mesh_loss`` (CloudLM's, BERT's, ViT's, MNIST's and
ResNet's are).  Windows (``steps_per_dispatch`` > 1) stack the rank's
rows of K batches (``pipeline_io.prefetch_windows`` under the mesh) into
the window under the mesh, whose K step bodies run from the host with
their collectives between them (no CUDA graph: one cannot capture gloo's
host-side collectives); the callbacks, the drain, the data position and
the non-finite guard keep one card's window cadence.  Compile-ahead
warms the step under the mesh up once on a worker whose collectives go
through axis groups of their own (``training.compile_cache``).  A mesh
whose every axis has size 1 is the single-process step (each collective
over it is the identity), so ``fit`` takes that whole path, its CUDA
graphs included.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from cloud_tpu_torch import random as random_lib
from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.bridge import map_leaves
from cloud_tpu_torch.monitoring import metrics as metrics_lib
from cloud_tpu_torch.monitoring import profiler, tracing
from cloud_tpu_torch.parallel import mesh as mesh_lib
from cloud_tpu_torch.training import compile_cache, pipeline_io, preemption
from cloud_tpu_torch.training import train as train_lib
from cloud_tpu_torch.utils import faults

logger = logging.getLogger(__name__)



class _PeekedIterator:
    """An iterator with its first item already pulled (compile-ahead peeks
    one batch to derive its specs, then the epoch loop must still consume
    it).  Delegates ``close`` so prefetch workers are joined."""

    _EMPTY = object()  # the peek found the source already exhausted

    def __init__(self, first, rest):
        self._first = first if first is not None else self._EMPTY
        self._rest = rest

    def __iter__(self):
        return self

    def __next__(self):
        first = self._first
        if first is self._EMPTY:
            # Never re-pull an exhausted source (a drained prefetch queue
            # has no more DONE sentinels to deliver).
            raise StopIteration
        if first is not None:
            # Hand the peeked item over WITHOUT keeping a reference: for
            # K>1 it is a whole placed super-batch.
            self._first = None
            return first
        return next(self._rest)

    def close(self):
        close = getattr(self._rest, "close", None)
        if close is not None:
            close()


class Callback:
    """Hook protocol (subset of Keras Callback the reference workloads use).

    ``on_step_end`` receives metrics as *device tensors* (materializing
    them with ``float()`` costs a host sync — do it sparingly);
    ``on_epoch_end`` logs are already host floats.

    Cadence: with ``fit(steps_per_dispatch=K)`` and K > 1, ``on_step_end``
    fires once per fused K-step window — ``step`` is the global step at the
    window's end and ``logs`` are the window's on-device metric means.
    ``K=1`` (the default) keeps the exact per-step cadence.
    """

    def on_train_begin(self, trainer: "Trainer") -> None: ...
    def on_train_end(self, trainer: "Trainer") -> None: ...
    def on_epoch_begin(self, epoch: int, trainer: "Trainer") -> None: ...
    def on_epoch_end(self, epoch: int, logs: Dict[str, float],
                     trainer: "Trainer") -> None: ...
    def on_step_end(self, step: int, logs: Dict[str, float],
                    trainer: "Trainer") -> None: ...


class History(Callback):
    """Accumulates per-epoch metric means (Keras History analogue)."""

    def __init__(self):
        self.history: Dict[str, List[float]] = {}

    def on_epoch_end(self, epoch, logs, trainer):
        for key, value in logs.items():
            self.history.setdefault(key, []).append(float(value))


class _StepBoundaryMixin:
    """Shared cadence tracking for every-N-steps callbacks.

    With ``fit(steps_per_dispatch=K)`` the ``on_step_end`` hook only sees
    every K-th step number, so "every N steps" must mean "this window
    CROSSED a multiple of N" — a plain ``step % N`` would fire only at
    multiples of lcm(K, N).  For K=1 :meth:`_crossed` reduces to
    ``step % N == 0`` exactly.
    """

    _prev_step: Optional[int] = None

    def _seed_prev_step(self, trainer) -> None:
        state = getattr(trainer, "state", None)
        self._prev_step = int(state.step) if state is not None else None

    def _crossed(self, step: int, every_n: int) -> bool:
        prev = self._prev_step if self._prev_step is not None else step - 1
        self._prev_step = step
        return step // every_n > prev // every_n


class ProgressLogger(_StepBoundaryMixin, Callback):
    """Logs metrics every ``every_n_steps`` steps (window-aware)."""

    def __init__(self, every_n_steps: int = 50):
        self.every_n_steps = every_n_steps

    def on_train_begin(self, trainer):
        self._seed_prev_step(trainer)

    def on_step_end(self, step, logs, trainer):
        if self._crossed(step, self.every_n_steps):
            rendered = " ".join(
                f"{k}={float(v):.4f}" for k, v in sorted(logs.items())
            )
            logger.info("step %d: %s", step, rendered)


def _copy_state(state: train_lib.TrainState, device) -> train_lib.TrainState:
    """A copy of ``state`` on ``device``, each leaf keeping its dtype and
    ``requires_grad``."""

    def copy(t):
        if not torch.is_tensor(t):
            return t
        return t.detach().to(device, copy=True).requires_grad_(
            t.requires_grad)

    return train_lib.TrainState(
        step=copy(state.step), params=map_leaves(state.params, copy),
        opt_state=map_leaves(state.opt_state, copy),
        rng=None if state.rng is None else copy(state.rng))


class EarlyStopping(Callback):
    """Stop training when a monitored metric stops improving.

    Keras-parity semantics: ``monitor`` reads the epoch logs (use
    ``val_``-prefixed keys for validation metrics), ``patience`` counts
    non-improving epochs, ``restore_best_state`` reinstates the best
    TrainState on stop.  The snapshot of each *improving* epoch is a host
    copy (sparing device memory; the optimizer updates the live state in
    place, so a reference would not do); the restore puts it back on the
    device it came from.
    """

    def __init__(self, monitor: str = "val_loss", *, min_delta: float = 0.0,
                 patience: int = 0, mode: str = "auto",
                 restore_best_state: bool = False):
        if mode not in ("auto", "min", "max"):
            raise ValueError(f"mode must be auto|min|max, got {mode!r}")
        self.monitor = monitor
        self.min_delta = abs(min_delta)
        self.patience = patience
        self.restore_best_state = restore_best_state
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self._sign = 1.0 if mode == "max" else -1.0
        self._best = -float("inf")
        self._wait = 0
        self._best_state = None
        self._best_device = None
        self.stopped_epoch: Optional[int] = None

    def on_train_begin(self, trainer):
        self._best = -float("inf")
        self._wait = 0
        self._best_state = None
        self._best_device = None
        self.stopped_epoch = None

    def on_epoch_end(self, epoch, logs, trainer):
        if self.monitor not in logs:
            logger.warning(
                "EarlyStopping: %r not in epoch logs %s", self.monitor,
                sorted(logs),
            )
            return
        current = self._sign * float(logs[self.monitor])
        if current > self._best + self.min_delta:
            self._best = current
            self._wait = 0
            if self.restore_best_state:
                self._best_device = trainer.state.step.device
                self._best_state = _copy_state(trainer.state, "cpu")
        else:
            self._wait += 1
            if self._wait > self.patience:
                self.stopped_epoch = epoch
                trainer.stop_training = True

    def on_train_end(self, trainer):
        if self.restore_best_state and self._best_state is not None:
            trainer.state = _copy_state(self._best_state, self._best_device)


class TerminateOnNaN(_StepBoundaryMixin, Callback):
    """Stop training the step a non-finite loss appears (Keras parity).

    Checks every step by default, like Keras — the cost is one host sync
    per check, which serializes host and device; long runs that would
    rather amortize it can raise ``check_every_n_steps`` at the price of
    detecting a NaN up to that many steps late.  The stop reason lands in
    ``self.stopped_step`` and a log line.
    """

    def __init__(self, *, check_every_n_steps: int = 1):
        self.check_every_n_steps = max(1, check_every_n_steps)
        self.stopped_step: Optional[int] = None

    def on_train_begin(self, trainer):
        self.stopped_step = None
        self._seed_prev_step(trainer)

    def on_step_end(self, step, logs, trainer):
        if not self._crossed(step, self.check_every_n_steps):
            return
        loss = logs.get("loss")
        if loss is None:
            return
        if not np.isfinite(float(loss)):
            self.stopped_step = step
            trainer.stop_training = True
            logger.error(
                "TerminateOnNaN: non-finite loss %s at step %d; stopping",
                float(loss), step,
            )


class LambdaCallback(Callback):
    """Ad-hoc hooks."""

    def __init__(self, on_epoch_end: Optional[Callable] = None,
                 on_step_end: Optional[Callable] = None):
        self._on_epoch_end = on_epoch_end
        self._on_step_end = on_step_end

    def on_epoch_end(self, epoch, logs, trainer):
        if self._on_epoch_end:
            self._on_epoch_end(epoch, logs, trainer)

    def on_step_end(self, step, logs, trainer):
        if self._on_step_end:
            self._on_step_end(step, logs, trainer)


class Trainer:
    """Owns the step functions and the epoch loop.

    Args:
      loss_fn: ``loss_fn(params, batch) -> (loss, metrics_dict)``.
      optimizer: an optimizer of ``training.optimizers``.
      init_fn: ``init_fn(generator) -> params`` (used by ``init_state``).
      mesh: a ``parallel.mesh.Mesh`` (this process is one rank), or None
        for one card; the state lives on the mesh's device.
      logical_axes: params-congruent tree of logical axis tuples (how the
        rules cut each leaf over the mesh); unused without a mesh of more
        than one rank.
      rules: logical->mesh axis table (default ``DEFAULT_RULES``).
      stochastic: thread the state's threefry key through every train
        step: ``loss_fn(params, batch, rng=...)`` (dropout).  Eval steps
        stay deterministic (no rng passed).  ``init_state`` derives the
        training key from its generator's seed.
      accum_steps: gradient accumulation — each train step splits its
        batch into this many micro-batches and applies ONE optimizer
        update with the mean gradient (``train.make_train_step``).
      nonfinite_guard: build the step functions with the on-device
        non-finite guard: a step whose loss/grads go NaN/Inf skips its
        optimizer update on the device (params and optimizer state keep
        their values, the step counter still advances) and reports
        ``metrics["nonfinite"]``.  fit() counts skips
        (``train/nonfinite_skips``) and — with
        ``rollback_after_nonfinite`` — rolls a persistently diverged run
        back to its last verified checkpoint before stopping.
      device: where the state lives and batches go (``cuda`` by default,
        ``"cpu"`` when asked).
    """

    def __init__(
        self,
        loss_fn,
        optimizer,
        init_fn=None,
        *,
        mesh=None,
        logical_axes=None,
        rules=None,
        stochastic: bool = False,
        accum_steps: int = 1,
        nonfinite_guard: bool = False,
        device=None,
    ):
        self._mesh = mesh_lib.effective_mesh(mesh)
        self.mesh = mesh
        self.logical_axes = logical_axes
        self.rules = rules
        if mesh is not None:
            if (device is not None
                    and torch.device(device).type != mesh.device.type):
                raise ValueError(
                    f"device={device} is not the mesh's device {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.stochastic = stochastic
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.init_fn = init_fn
        self.accum_steps = accum_steps
        self.nonfinite_guard = nonfinite_guard
        self.state: Optional[train_lib.TrainState] = None
        #: The last fit's compile-ahead plan (``compile_cache.CompileAhead``:
        #: its AotStep wrappers and ``error``), or None.
        self.compile_plan = None
        self.stop_training = False
        #: True when the last fit() ended by preemption drain (the
        #: process-wide stop event, ``training.preemption``) rather than
        #: data exhaustion or a callback stop.
        self.drained = False
        #: The exactly-once data position, updated at every CONSUMPTION
        #: boundary (a batch counts as consumed only once its state
        #: update was dispatched — prefetched-but-unconsumed batches are
        #: not marked done).  ``CheckpointCallback`` saves this alongside
        #: the TrainState; a restore sets ``_resume_data_state`` and the
        #: next fit() fast-forwards the dataset to match.
        self.data_state: Dict[str, int] = {"epoch": 0, "batches_consumed": 0}
        self._resume_data_state: Optional[Dict[str, int]] = None
        self._data_seed: Optional[int] = None
        self._layout = dict(mesh=self._mesh, rules=rules, logical_axes=(
            logical_axes if self._mesh is not None else None))
        self._train_step = train_lib.make_train_step(
            loss_fn, optimizer, stochastic=stochastic,
            accum_steps=accum_steps, skip_nonfinite=nonfinite_guard,
            **self._layout,
        )
        self._eval_step = train_lib.make_eval_step(loss_fn, **self._layout)
        # Fused K-step windows, built lazily per K: a window keeps its
        # CUDA graphs, so reusing it across epochs and fits captures once.
        self._multi_steps: Dict[int, Any] = {}

    def _drain_if_requested(self, step: int) -> bool:
        """Preemption-drain check, called at every dispatch boundary.

        When the process-wide stop event (``training.preemption`` — set
        by a SIGTERM handler) is up, flip ``stop_training`` so the epoch
        loop exits cleanly and ``on_train_end`` fires — that's where
        ``CheckpointCallback`` saves the CURRENT step and waits the write
        out, bounding lost work to one dispatch window.  Recorded once per
        fit as a ``preempt/drain`` span + counter.
        """
        if not preemption.stop_requested():
            return False
        if not self.drained:
            self.drained = True
            metrics_lib.counter_inc("preempt/drains")
            now = time.perf_counter()
            tracing.record_span(
                "preempt/drain", now, now, step=step,
                reason=preemption.stop_reason() or "",
            )
            logger.warning(
                "preemption drain at step %d (%s): stopping to checkpoint",
                step, preemption.stop_reason(),
            )
        self.stop_training = True
        return True

    @staticmethod
    def _dataset_epoch(train_data, default: int) -> int:
        """The dataset-ABSOLUTE epoch its next iterator will use
        (``state_dict()['epoch']``), or ``default`` for datasets without
        resume hooks.  The saved position records absolute epochs: a
        dataset instance that was already iterated before this fit (a
        warmup fit on the same instance) has its shuffle order keyed by
        its own counter, not by this fit's epoch index."""
        fn = getattr(train_data, "state_dict", None)
        if fn is None:
            return default
        try:
            return int(fn().get("epoch", default))
        except Exception:  # noqa: BLE001 — positions degrade, fits don't
            logger.debug("dataset state_dict() failed", exc_info=True)
            return default

    @staticmethod
    def _dataset_seed(train_data):
        """The dataset's shuffle seed (``state_dict()['seed']``), or None
        for datasets without resume hooks.  Saved with the position: an
        epoch/batch index only names the right batches under the shuffle
        order it was recorded in."""
        fn = getattr(train_data, "state_dict", None)
        if fn is None:
            return None
        try:
            seed = fn().get("seed")
            return None if seed is None else int(seed)
        except Exception:  # noqa: BLE001 — positions degrade, fits don't
            logger.debug("dataset state_dict() failed", exc_info=True)
            return None

    def _position(self, epoch: int, consumed: int) -> Dict[str, int]:
        """A data_state dict: position plus (when known) the shuffle seed
        the position is valid under."""
        pos = {"epoch": int(epoch), "batches_consumed": int(consumed)}
        if self._data_seed is not None:
            pos["seed"] = self._data_seed
        return pos

    def _apply_data_resume(self, train_data, base_epoch: int) -> "tuple":
        """Consume a restored iterator state (set by a checkpoint resume
        with ``resume_data=True``): fast-forward the dataset and return
        ``(start_epoch, resume_skip)`` for the epoch loop.  The saved
        epoch is dataset-absolute; ``base_epoch`` (the dataset's counter
        at this fit's start) converts it back to this fit's budget
        position.  A dataset without ``load_state_dict`` logs and restarts
        its stream, never an error."""
        resume = self._resume_data_state
        self._resume_data_state = None
        if not resume:
            return 0, 0
        loader = getattr(train_data, "load_state_dict", None)
        if loader is None:
            logger.warning(
                "checkpoint carried iterator state %s but the dataset has "
                "no load_state_dict(); the data stream restarts from "
                "scratch (exactly-once resume needs a resumable dataset)",
                resume,
            )
            return 0, 0
        try:
            loader(dict(resume))
            abs_epoch = int(resume.get("epoch", 0))
            start_epoch = abs_epoch - base_epoch
            if start_epoch < 0:
                logger.warning(
                    "restored iterator state %s is behind the dataset's "
                    "current epoch %d; clamping to this fit's first epoch",
                    resume, base_epoch,
                )
                start_epoch = 0
            resume_skip = int(resume.get("batches_consumed", 0))
        except Exception:  # noqa: BLE001 — a broken fast-forward must
            # degrade to a fresh stream, not kill the recovered job.
            logger.exception(
                "could not fast-forward dataset to %s; the data stream "
                "restarts from scratch", resume,
            )
            return 0, 0
        logger.info(
            "resuming data stream at epoch %d, batch %d (exactly-once)",
            abs_epoch, resume_skip,
        )
        return start_epoch, resume_skip

    def _nonfinite_check(self, metrics, n_steps: int, step: int,
                         rollback_after: Optional[int], callbacks) -> bool:
        """Count on-device non-finite skips; roll back or stop on a
        persistent streak.  Returns True when a rollback replaced
        ``self.state`` (the caller re-reads its step counter).

        Costs one host sync per dispatch window — only when the Trainer
        was built with ``nonfinite_guard=True``.  Also marks the window
        (``self._window_nonfinite``) so the epoch accumulator can exclude
        it: the guard keeps NaN out of the *state*, but the window's
        loss/grad metrics ARE NaN, and one poisoned window folded into the
        running sums would turn the whole epoch's logged means NaN.
        """
        self._window_nonfinite = False
        if not self.nonfinite_guard:
            return False
        flag = metrics.get("nonfinite")
        if flag is None:
            return False
        frac = float(flag)  # host sync — the guard's price
        if frac <= 0.0:
            self._nonfinite_streak = 0
            return False
        self._window_nonfinite = True
        skipped = max(1, int(round(frac * n_steps)))
        metrics_lib.counter_inc("train/nonfinite_skips", skipped)
        now = time.perf_counter()
        tracing.record_span("train/nonfinite_skip", now, now, step=step,
                            skipped=skipped)
        self._nonfinite_streak += 1
        logger.warning(
            "non-finite metrics at step %d: %d state update(s) skipped on "
            "device (consecutive bad windows: %d)",
            step, skipped, self._nonfinite_streak,
        )
        if not rollback_after or self._nonfinite_streak < rollback_after:
            return False
        if self._fit_rollbacks >= 1:
            logger.error(
                "non-finite streak persists after a rollback; stopping "
                "training at step %d", step,
            )
            self.stop_training = True
            return False
        provider = next(
            (cb for cb in callbacks if hasattr(cb, "rollback_state")), None
        )
        rolled = False
        if provider is not None:
            try:
                rolled = bool(provider.rollback_state(self))
            except Exception:  # noqa: BLE001 — fall through to terminate
                logger.exception("rollback to last checkpoint failed")
        if not rolled:
            logger.error(
                "%d consecutive non-finite windows and no checkpoint to "
                "roll back to; stopping training at step %d",
                self._nonfinite_streak, step,
            )
            self.stop_training = True
            return False
        self._fit_rollbacks += 1
        self._nonfinite_streak = 0
        metrics_lib.counter_inc("train/rollbacks")
        now = time.perf_counter()
        tracing.record_span("train/rollback", now, now, from_step=step,
                            to_step=int(self.state.step))
        logger.warning(
            "rolled back from step %d to verified checkpoint step %d after "
            "%d consecutive non-finite windows; continuing on fresh data",
            step, int(self.state.step), rollback_after,
        )
        return True

    def _multi_step_for(self, steps_per_dispatch: int):
        fn = self._multi_steps.get(steps_per_dispatch)
        if fn is None:
            fn = train_lib.make_multi_step(
                self.loss_fn, self.optimizer,
                steps_per_dispatch=steps_per_dispatch,
                stochastic=self.stochastic, accum_steps=self.accum_steps,
                skip_nonfinite=self.nonfinite_guard, **self._layout,
            )
            self._multi_steps[steps_per_dispatch] = fn
        return fn

    @staticmethod
    def _accumulate(sums: Dict[str, Any], metrics: Dict[str, Any],
                    n_steps: int) -> None:
        """Fold one step's (or one window's mean) metrics into running
        on-device f32 sums — a few scalar adds per window instead of an
        epoch-long list of device tensors."""
        for key, value in metrics.items():
            contrib = value.float() if torch.is_tensor(value) else (
                torch.tensor(value, dtype=torch.float32))
            if n_steps != 1:
                contrib = contrib * n_steps
            prev = sums.get(key)
            sums[key] = contrib if prev is None else prev + contrib

    @staticmethod
    def _host_means(sums: Dict[str, Any], count: int) -> Dict[str, float]:
        """One host read of the running sums, each divided by ``count``."""
        return {k: float(np.mean(v.detach().cpu().numpy()) / max(count, 1))
                for k, v in sums.items()}

    def init_state(self, rng) -> train_lib.TrainState:
        """A fresh state from ``init_fn(rng)`` (``rng``: a
        ``torch.Generator``) on the Trainer's device.  A stochastic
        Trainer's key is derived as the JAX package's ``init_state``
        derives it from ``PRNGKey(seed)``: the second half of its split,
        with ``seed`` the generator's seed."""
        if self.init_fn is None:
            raise ValueError("Trainer needs init_fn to create state")
        train_rng = None
        if self.stochastic:
            if not isinstance(rng, torch.Generator):
                raise ValueError("a stochastic Trainer's init_state needs a "
                                 "seeded torch.Generator")
            train_rng = random_lib.split(
                random_lib.PRNGKey(rng.initial_seed()))[1]
        self.state = train_lib.create_sharded_state(
            rng, self.init_fn, self.optimizer, mesh=self._mesh,
            logical_axes=(self.logical_axes if self._mesh is not None
                          else None),
            rules=self.rules, train_rng=train_rng, device=self.device,
        )
        return self.state

    def _place(self, batch):
        return pipeline_io.place_batch(batch, self.device)

    def fit(
        self,
        train_data: Callable[[], Iterable],
        *,
        epochs: int = 1,
        steps_per_epoch: Optional[int] = None,
        validation_data: Optional[Callable[[], Iterable]] = None,
        callbacks: Optional[List[Callback]] = None,
        state: Optional[train_lib.TrainState] = None,
        steps_per_dispatch: int = 1,
        prefetch: int = 2,
        compile_ahead: bool = False,
        batch_spec=None,
        rollback_after_nonfinite: Optional[int] = None,
    ) -> History:
        """Run the training loop (under the Trainer's mesh, installed as the
        global mesh for the loss, as the JAX trainer runs its steps in its
        mesh's context).

        ``train_data``/``validation_data`` are zero-arg callables returning a
        fresh batch iterator per epoch (re-iterable datasets).

        ``prefetch`` > 0 (default 2: double-buffering) runs host gather +
        the copy to the device in a background thread that many batches
        ahead, for train AND validation data — pass 0 to keep the fully
        synchronous loop.  Datasets already wrapped in
        ``pipeline_io.prefetch_to_device`` are not wrapped twice.

        ``steps_per_dispatch=K`` > 1 fuses K train steps into ONE dispatch
        (``train.make_multi_step``: on one card one CUDA-graph replay,
        under a mesh of more than one rank K bodies from the host): K
        consecutive batches are stacked into a super-batch, so per-step
        host overhead (launches, callback fan-out) amortizes K-fold.  The
        parameter trajectory is unchanged; ``on_step_end`` fires once per
        window with window-MEAN metrics.  A dataset tail shorter than K is
        zero-padded to the window shape and dispatched with its padded
        slots skipped (the window's ``valid`` mask; on the card that slot
        set gets a graph of its own, captured at its first use).  ``K=1``
        preserves exact per-step semantics.

        ``compile_ahead=True`` captures this fit's steps (the train step
        or the K-step window, plus the eval step when ``validation_data``
        is given) as CUDA graphs on a background thread WHILE the
        prefetcher warms (``training.compile_cache``), so the first
        dispatch replays a ready graph instead of building and setting
        up synchronously; first-step latency still lands in the
        ``run/submit_to_first_step_seconds`` gauge.  The specs come from
        the first prefetched batch, or from ``batch_spec`` (a tree like
        one HOST batch, of anything with ``.shape``/``.dtype``) when the
        pipeline is slow to produce its first batch.  Artifacts are
        memoized in ``compile_cache``'s registry, and a failure to compile
        ahead degrades to the plain step, never an error.  On the CPU
        nothing is captured (the plain steps run, through the same
        wrappers).

        Under a mesh of more than one rank nothing is captured: the
        artifacts are the eager steps under the mesh, each warmed up once
        on the worker (``compile/lower``) over axis groups of its own;
        the first dispatch waits for the train step's warm-up, and fit
        joins the worker before it returns.  Every rank must pass the
        same ``compile_ahead`` and data shapes.

        ``rollback_after_nonfinite=K`` (requires a Trainer built with
        ``nonfinite_guard=True``): after K CONSECUTIVE dispatch windows
        whose on-device guard skipped a non-finite update, the trainer
        asks its checkpoint callback to roll ``state`` back to the last
        verified checkpoint (``train/rollbacks``) and continues on fresh
        data; a second K-streak — or no callback able to roll back —
        stops training.

        Exactly-once resume: when a checkpoint restore handed back a
        saved iterator state (``CheckpointCallback(resume_data=True)``),
        fit fast-forwards ``train_data`` via its ``load_state_dict`` to
        the restored epoch/batch position and continues the ORIGINAL
        epochs budget from there: the trajectory is the uninterrupted
        run's.
        """
        with self._mesh_context():
            return self._fit(
                train_data, epochs=epochs, steps_per_epoch=steps_per_epoch,
                validation_data=validation_data, callbacks=callbacks,
                state=state, steps_per_dispatch=steps_per_dispatch,
                prefetch=prefetch, compile_ahead=compile_ahead,
                batch_spec=batch_spec,
                rollback_after_nonfinite=rollback_after_nonfinite)

    def _mesh_context(self):
        """The Trainer's mesh installed as the global mesh, or nothing."""
        import contextlib

        if self.mesh is None:
            return contextlib.nullcontext()
        return mesh_lib.use_mesh(self.mesh)

    def _fit(self, train_data, *, epochs, steps_per_epoch, validation_data,
             callbacks, state, steps_per_dispatch, prefetch, compile_ahead,
             batch_spec, rollback_after_nonfinite) -> History:
        if steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}"
            )
        if rollback_after_nonfinite is not None:
            if rollback_after_nonfinite < 1:
                raise ValueError(
                    "rollback_after_nonfinite must be >= 1, got "
                    f"{rollback_after_nonfinite}"
                )
            if not self.nonfinite_guard:
                raise ValueError(
                    "rollback_after_nonfinite needs a Trainer built with "
                    "nonfinite_guard=True (the on-device skip supplies the "
                    "signal the rollback trigger counts)"
                )
        # Env-gated persistent kernel cache (CLOUD_TPU_COMPILE_CACHE): a
        # once-per-process probe + enable, a cheap no-op when unset.
        compile_cache.maybe_enable_persistent_cache()
        if state is not None:
            self.state = state
        if self.state is None:
            raise ValueError("No TrainState; call init_state() or pass state=")
        callbacks = list(callbacks or [])
        callbacks = self._with_runtime_metrics(callbacks)
        history = History()
        callbacks.append(history)
        self.stop_training = False
        self.drained = False
        self._nonfinite_streak = 0
        self._window_nonfinite = False
        self._fit_rollbacks = 0

        # on_train_begin runs BEFORE the data pipeline is wired: a
        # CheckpointCallback restore may replace self.state AND hand back
        # the checkpoint's iterator state, which must fast-forward the
        # dataset before any wrapper pulls from it.
        for cb in callbacks:
            cb.on_train_begin(self)

        k = steps_per_dispatch
        # The dataset's epoch counter at fit start: saved positions are
        # recorded dataset-ABSOLUTE (base + fit-relative).
        base_epoch = self._dataset_epoch(train_data, 0)
        start_epoch, resume_skip = self._apply_data_resume(
            train_data, base_epoch,
        )
        # Read AFTER the resume: load_state_dict may have adopted the
        # checkpoint's seed.
        self._data_seed = self._dataset_seed(train_data)
        self.data_state = self._position(base_epoch + start_epoch,
                                         resume_skip)

        if k > 1 and pipeline_io.is_prefetched(train_data):
            raise ValueError(
                "steps_per_dispatch > 1 stacks HOST batches into a "
                "super-batch; pass the unwrapped dataset (fit prefetches "
                "whole windows itself)"
            )

        def build_source(limit):
            if k == 1:
                if prefetch > 0 and not pipeline_io.is_prefetched(train_data):
                    return pipeline_io.prefetch_to_device(
                        train_data, size=prefetch, limit=limit,
                        device=self.device,
                    )
                return train_data
            if prefetch > 0:
                return pipeline_io.prefetch_windows(
                    train_data, k, mesh=self._mesh, size=prefetch,
                    limit=limit, device=self.device,
                )
            return pipeline_io.iter_windows(
                train_data, k, mesh=self._mesh, limit=limit,
                device=self.device,
            )

        source = build_source(steps_per_epoch)
        # A mid-epoch resume epoch has a smaller remaining step budget:
        # its (one-shot) source must cap at what the interrupted epoch
        # has left.
        if resume_skip and steps_per_epoch is not None:
            first_source = build_source(max(steps_per_epoch - resume_skip, 0))
        else:
            first_source = source
        multi_step = self._multi_step_for(k) if k > 1 else None

        # Compile-ahead: start the background capture (against specs from
        # batch_spec or a peeked first batch) BEFORE the epoch loop, so it
        # overlaps the prefetcher warming.  The step callables are swapped
        # for AotStep wrappers that dispatch through the ready graphs.
        train_step = self._train_step
        eval_step = None
        aot_plan = None
        peeked_iter = None
        # Captured BEFORE the compile-ahead peek creates the first
        # epoch's iterator (which advances the dataset's counter).
        peeked_abs_epoch = self._dataset_epoch(
            train_data, base_epoch + start_epoch,
        )
        if compile_ahead:
            aot_plan, peeked_iter = self._launch_compile_ahead(
                k, first_source, batch_spec,
                validation_data=validation_data, multi_step=multi_step,
            )
            if aot_plan is not None:
                if k == 1:
                    train_step = aot_plan.steps["train_step"]
                else:
                    multi_step = aot_plan.steps["multi_step"]
                eval_step = aot_plan.steps.get("eval_step")
        self.compile_plan = aot_plan

        step = int(self.state.step)
        # The first dispatch of this fit() is spanned separately (the
        # kernels' libraries load, a window captures its graph) and
        # publishes the run/submit_to_first_step_seconds gauge when a
        # submit mark is pending.
        first_dispatch = True
        for epoch in range(start_epoch, epochs):
            if self.stop_training:
                break
            for cb in callbacks:
                cb.on_epoch_begin(epoch, self)
            # Running f32 sums on the device instead of an epoch-long
            # list of per-step tensors.
            epoch_sums: Dict[str, Any] = {}
            epoch_steps = 0
            epoch_start = time.perf_counter()
            if peeked_iter is not None:
                # First epoch with compile-ahead: the specs' peek already
                # started this epoch's iterator (prefetch warm underneath).
                data_iter, peeked_iter = peeked_iter, None
                abs_epoch = peeked_abs_epoch
            else:
                # Dataset-absolute epoch of the iterator about to be
                # created (read before __call__ advances the counter).
                abs_epoch = self._dataset_epoch(train_data, epoch)
                data_iter = iter(
                    (first_source if epoch == start_epoch else source)()
                )
            # A resumed first epoch starts mid-stream: the consumed-batch
            # counter picks up at the restored position (the dataset's
            # fast-forward already skipped those batches).
            epoch_consumed = resume_skip if epoch == start_epoch else 0
            try:
                if k == 1:
                    i = epoch_consumed
                    while steps_per_epoch is None or i < steps_per_epoch:
                        with tracing.span("step/data"):
                            # Chaos seam: an injected plan can fail/hang
                            # or corrupt the iterator pull here.
                            batch = faults.fault_point(
                                "data.next", next(data_iter, None)
                            )
                        if batch is None:
                            break
                        if first_dispatch and aot_plan is not None:
                            # Wait for the TRAIN graph only: its capture
                            # has been overlapping prefetch warm-up, and
                            # the eval capture keeps going behind it.
                            aot_plan.wait("train_step")
                        compute_span = (
                            "step/first_compile" if first_dispatch
                            else "step/compute"
                        )
                        with tracing.span(compute_span):
                            faults.fault_point("train.dispatch")
                            batch = self._place(batch)
                            self.state, metrics = train_step(
                                self.state, batch
                            )
                        if first_dispatch:
                            first_dispatch = False
                            tracing.record_submit_to_first_step()
                        step += 1
                        i += 1
                        # Consumed = state update dispatched: prefetched
                        # batches the device never saw stay un-consumed.
                        self.data_state = self._position(abs_epoch, i)
                        if self._nonfinite_check(
                            metrics, 1, step, rollback_after_nonfinite,
                            callbacks,
                        ):
                            step = int(self.state.step)
                        # Metrics stay on the device: callbacks pay the
                        # sync only if they materialize them.  A
                        # quarantined window's NaN metrics are excluded
                        # from the epoch sums.
                        if not self._window_nonfinite:
                            self._accumulate(epoch_sums, metrics, 1)
                            epoch_steps += 1
                        with tracing.span("step/callbacks"):
                            for cb in callbacks:
                                cb.on_step_end(step, metrics, self)
                        self._drain_if_requested(step)
                        if self.stop_training:
                            break
                else:
                    while True:
                        with tracing.span("step/data"):
                            item = faults.fault_point(
                                "data.next", next(data_iter, None)
                            )
                        if item is None:
                            break
                        # Every window — tail included — goes through the
                        # one window: a short window arrives zero-padded
                        # to K with `valid` marking its real steps.  The
                        # only single-step route left is a RAGGED window
                        # (valid None: per-batch shapes differ, so no
                        # stacking is possible).
                        n, payload, valid = item
                        if (first_dispatch and aot_plan is not None
                                and self._mesh is not None):
                            # Under a mesh no backward may run beside
                            # the worker's warm-up step (on the card
                            # autograd's one thread would serve both).
                            aot_plan.wait("multi_step")
                        if valid is None:
                            compute_span = (
                                "step/first_compile" if first_dispatch
                                else "step/compute"
                            )
                            with tracing.span(compute_span, steps=n):
                                ragged: Dict[str, Any] = {}
                                for batch in payload:
                                    self.state, m = self._train_step(
                                        self.state, self._place(batch)
                                    )
                                    self._accumulate(ragged, m, 1)
                                metrics = {
                                    key: value / n
                                    for key, value in ragged.items()
                                }
                        else:
                            if first_dispatch and aot_plan is not None:
                                # Only a fused dispatch replays the
                                # window's graph; a ragged first window
                                # must not stall on it.
                                aot_plan.wait("multi_step")
                            compute_span = (
                                "step/first_compile" if first_dispatch
                                else "step/fused_compute"
                            )
                            with tracing.span(compute_span, steps=n):
                                faults.fault_point("train.dispatch")
                                self.state, metrics = multi_step(
                                    self.state, payload, valid
                                )
                        if first_dispatch:
                            first_dispatch = False
                            tracing.record_submit_to_first_step()
                        step += n
                        epoch_consumed += n
                        self.data_state = self._position(
                            abs_epoch, epoch_consumed,
                        )
                        if self._nonfinite_check(
                            metrics, n, step, rollback_after_nonfinite,
                            callbacks,
                        ):
                            step = int(self.state.step)
                        if not self._window_nonfinite:
                            self._accumulate(epoch_sums, metrics, n)
                            epoch_steps += n
                        with tracing.span("step/callbacks"):
                            for cb in callbacks:
                                cb.on_step_end(step, metrics, self)
                        self._drain_if_requested(step)
                        if self.stop_training:
                            break
            finally:
                # An abandoned prefetch iterator (steps_per_epoch break,
                # stop_training, an exception) must join its worker thread
                # rather than leak it; plain generators close the same way.
                close = getattr(data_iter, "close", None)
                if close is not None:
                    close()
            if not self.stop_training:
                # The epoch ran to its boundary: the resume position rolls
                # over to the next epoch's start.  An early stop (drain,
                # NaN terminate) keeps the mid-epoch position instead.
                self.data_state = self._position(abs_epoch + 1, 0)
            logs = self._host_means(epoch_sums, epoch_steps)
            logs["epoch_seconds"] = time.perf_counter() - epoch_start
            # A drain is racing a preemption grace window: skip the
            # epoch's validation pass and get to the checkpoint save.
            if validation_data is not None and not self.drained:
                val = self.evaluate(validation_data, prefetch=prefetch,
                                    step_fn=eval_step)
                logs.update({f"val_{k_}": v for k_, v in val.items()})
            for cb in callbacks:
                cb.on_epoch_end(epoch, logs, self)
        if peeked_iter is not None:
            # The epoch loop never ran (a resumed position past the epochs
            # budget): the peek's iterator still owns a prefetch worker.
            peeked_iter.close()
        if aot_plan is not None and self._mesh is not None:
            # The worker's collectives end before fit returns: a caller
            # may tear the process group down after it.
            aot_plan.wait()
        # A server capture this loop started stops here, on its thread.
        profiler.safe_point(last=True)
        for cb in callbacks:
            cb.on_train_end(self)
        return history

    def evaluate(self, data: Callable[[], Iterable], *,
                 prefetch: int = 2, step_fn=None) -> Dict[str, float]:
        """Mean metrics of ``step_fn`` (the eval step by default; fit passes
        the compile-ahead :class:`compile_cache.AotStep` wrapper) over one
        pass of ``data``."""
        with self._mesh_context():
            return self._evaluate(data, prefetch=prefetch, step_fn=step_fn)

    def _evaluate(self, data, *, prefetch, step_fn) -> Dict[str, float]:
        step_fn = step_fn if step_fn is not None else self._eval_step
        source = data
        if prefetch > 0 and not pipeline_io.is_prefetched(data):
            source = pipeline_io.prefetch_to_device(
                data, size=prefetch, device=self.device,
            )
        sums: Dict[str, Any] = {}
        count = 0
        data_iter = iter(source())
        try:
            for batch in data_iter:
                metrics = step_fn(self.state, self._place(batch))
                self._accumulate(sums, metrics, 1)
                count += 1
        finally:
            close = getattr(data_iter, "close", None)
            if close is not None:
                close()
        return self._host_means(sums, count)

    def _launch_compile_ahead(self, k, source, batch_spec, *,
                              validation_data, multi_step):
        """Derive the specs and start the background capture.

        Returns ``(plan, peeked_iter)``.  ``peeked_iter`` is non-None when
        the first batch/window of the first epoch was pulled to derive
        specs: the epoch loop must consume it (the prefetcher keeps
        warming meanwhile, which is the window the capture overlaps).
        The eval step's specs come from a peek at ``validation_data``'s
        own first batch, deferred onto the compile worker after the train
        job.  The train and eval graphs take the trainer's state as their
        static state.  Any failure here degrades to the plain steps."""
        peeked = None
        try:
            state = self.state
            if batch_spec is not None:
                if k > 1:
                    batch_spec = compile_cache._map(
                        batch_spec, lambda x: compile_cache.TensorSpec(
                            (k,) + tuple(x.shape),
                            compile_cache._torch_dtype(x.dtype)))
                batch_specs = compile_cache.abstract_batch(
                    batch_spec, stacked=k > 1, device=self.device,
                    **self._spec_layout())
            else:
                it = iter(source())
                first = next(it, None)
                peeked = _PeekedIterator(first, it)
                if first is None:
                    return None, peeked  # empty dataset: nothing to compile
                if k == 1:
                    batch_specs = compile_cache.abstract_batch(
                        first, device=self.device, **self._spec_layout())
                else:
                    _, payload, first_valid = first
                    if first_valid is None:
                        # Ragged first window: no stacked specs.
                        return None, peeked
                    batch_specs = compile_cache.abstract_batch(
                        payload, stacked=True, device=self.device,
                        **self._spec_layout())
            ctx = compile_cache.context_key(donation=(0,),
                                            steps_per_dispatch=k,
                                            **self._spec_layout())
            if k == 1:
                jobs = [(compile_cache.AotStep(self._train_step, "train_step"),
                         (state, batch_specs), ctx)]
            else:
                valid = compile_cache.TensorSpec((k,), torch.float32)
                jobs = [(compile_cache.AotStep(multi_step, "multi_step"),
                         (state, batch_specs, valid), ctx)]
            if validation_data is not None:
                eval_ctx = compile_cache.context_key(steps_per_dispatch=1,
                                                     **self._spec_layout())

                def eval_args():
                    # On the compile worker, after the train job.
                    val_batch = self._peek_one_batch(validation_data)
                    if val_batch is None:
                        return None
                    return (state, compile_cache.abstract_batch(
                        val_batch, device=self.device,
                        **self._spec_layout()))

                jobs.append((compile_cache.AotStep(self._eval_step,
                                                   "eval_step"),
                             eval_args, eval_ctx))
            return (compile_cache.start_compile_ahead(
                jobs, device=self.device, mesh=self._mesh), peeked)
        except Exception:  # noqa: BLE001 — compile-ahead is advisory
            logger.warning(
                "compile-ahead setup failed; falling back to the plain "
                "steps", exc_info=True,
            )
            return None, peeked

    def _spec_layout(self) -> Dict[str, Any]:
        """The mesh and rules of compile-ahead's specs and keys (none on
        one card)."""
        if self._mesh is None:
            return {}
        return {"mesh": self._mesh, "rules": self.rules}

    @staticmethod
    def _peek_one_batch(dataset):
        """One batch from a fresh iterator of a re-iterable dataset (the
        fit() data contract), closing any worker it spawned."""
        it = iter(dataset())
        try:
            return next(it, None)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()

    @staticmethod
    def _with_runtime_metrics(callbacks: List[Callback]) -> List[Callback]:
        """Install the default metrics producer: every fit() records steps
        / loss / step-time / epochs into ``monitoring.metrics``.  Opt out
        with ``CLOUD_TPU_RUNTIME_METRICS=0``; a user-passed
        ``MetricsCallback`` (any prefix) suppresses the default one.
        """
        if os.environ.get("CLOUD_TPU_RUNTIME_METRICS", "1") == "0":
            return callbacks
        from cloud_tpu_torch import monitoring

        if any(
            isinstance(cb, monitoring.MetricsCallback) for cb in callbacks
        ):
            return callbacks
        return callbacks + [monitoring.MetricsCallback()]
