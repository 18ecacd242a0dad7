"""Minimal tuner engine: Trial/Objective/Oracle/Tuner (port of
``cloud_tpu/tuner/engine.py``).

The self-contained replacement for the KerasTuner engine classes the
reference built on (kerastuner.engine.oracle/tuner — not available in this
stack).  Kept to the surface the reference exercised: trial lifecycle,
objective tracking, best-trial queries, and a search loop that fits a
hypermodel-built Trainer per trial.
"""

from __future__ import annotations

import dataclasses
import enum
import gc
import logging
import random
from typing import Any, Callable, Dict, List, Optional

from cloud_tpu_torch.monitoring import tracing
from cloud_tpu_torch.tuner.hyperparameters import HyperParameters

logger = logging.getLogger(__name__)


class TrialStatus(str, enum.Enum):
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    INFEASIBLE = "INFEASIBLE"
    STOPPED = "STOPPED"


@dataclasses.dataclass
class Objective:
    name: str = "loss"
    direction: str = "min"  # or "max"

    def better(self, a: float, b: float) -> bool:
        return a < b if self.direction == "min" else a > b


@dataclasses.dataclass
class Trial:
    trial_id: str
    hyperparameters: HyperParameters
    status: TrialStatus = TrialStatus.RUNNING
    score: Optional[float] = None
    measurements: List[Dict[str, float]] = dataclasses.field(default_factory=list)


class Oracle:
    """Trial source/sink. Subclasses: RandomSearchOracle, CloudOracle."""

    def __init__(self, objective: Objective, max_trials: int = 10):
        self.objective = objective
        self.max_trials = max_trials
        self.trials: Dict[str, Trial] = {}

    def create_trial(self, tuner_id: str) -> Optional[Trial]:
        raise NotImplementedError

    def update_trial(self, trial: Trial, metrics: Dict[str, float],
                     step: int = 0) -> TrialStatus:
        trial.measurements.append({"step": step, **metrics})
        return TrialStatus.RUNNING

    def end_trial(self, trial: Trial,
                  status: TrialStatus = TrialStatus.COMPLETED) -> None:
        trial.status = status
        # Early-stopped trials still produced valid objective values.
        scoreable = status in (TrialStatus.COMPLETED, TrialStatus.STOPPED)
        if scoreable and trial.measurements:
            values = [
                m[self.objective.name]
                for m in trial.measurements
                if self.objective.name in m
            ]
            if values:
                trial.score = (
                    min(values) if self.objective.direction == "min"
                    else max(values)
                )

    def get_best_trials(self, num_trials: int = 1) -> List[Trial]:
        done = [
            t for t in self.trials.values()
            if t.status in (TrialStatus.COMPLETED, TrialStatus.STOPPED)
            and t.score is not None
        ]
        done.sort(
            key=lambda t: t.score, reverse=self.objective.direction == "max"
        )
        return done[:num_trials]


class RandomSearchOracle(Oracle):
    """Local random search over a declared space (offline baseline)."""

    def __init__(self, objective: Objective, hyperparameters: HyperParameters,
                 max_trials: int = 10, seed: int = 0):
        super().__init__(objective, max_trials)
        self.hyperparameters = hyperparameters
        self._rng = random.Random(seed)
        self._counter = 0

    def create_trial(self, tuner_id: str) -> Optional[Trial]:
        if self._counter >= self.max_trials:
            return None
        self._counter += 1
        values = self.hyperparameters.sample(self._rng)
        trial = Trial(
            trial_id=f"{self._counter:04d}",
            hyperparameters=self.hyperparameters.copy_with_values(values),
        )
        self.trials[trial.trial_id] = trial
        return trial


class Tuner:
    """Search loop: create trial -> build -> fit -> report, until exhausted.

    ``hypermodel(hp) -> Trainer`` (any object with ``fit(...) -> History``
    and, if state is needed, its own init).  ``search(**fit_kwargs)`` passes
    through to ``fit``; per-epoch objective values are reported to the
    oracle, supporting Vizier early stopping.
    """

    def __init__(
        self,
        hypermodel: Callable[[HyperParameters], Any],
        oracle: Oracle,
        *,
        tuner_id: str = "tuner0",
        init_state_fn: Optional[Callable[[Any, HyperParameters], None]] = None,
    ):
        self.hypermodel = hypermodel
        self.oracle = oracle
        self.tuner_id = tuner_id
        self.init_state_fn = init_state_fn

    def search(self, **fit_kwargs) -> None:
        while True:
            trial = self.oracle.create_trial(self.tuner_id)
            if trial is None:
                logger.info("[%s] search space/budget exhausted", self.tuner_id)
                return
            try:
                self.run_trial(trial, **fit_kwargs)
            except Exception:
                logger.exception("[%s] trial %s infeasible", self.tuner_id,
                                 trial.trial_id)
                try:
                    self.oracle.end_trial(trial, TrialStatus.INFEASIBLE)
                except Exception:
                    # One unreportable trial must not abort the whole search.
                    logger.exception(
                        "[%s] failed to mark trial %s infeasible",
                        self.tuner_id, trial.trial_id,
                    )
                continue

    def run_trial(self, trial: Trial, **fit_kwargs) -> None:
        with tracing.span(
            "tuner/trial", trial_id=trial.trial_id, tuner_id=self.tuner_id
        ):
            self._run_trial(trial, **fit_kwargs)

    def _run_trial(self, trial: Trial, **fit_kwargs) -> None:
        trainer = self.hypermodel(trial.hyperparameters)
        try:
            self._fit_and_report(trainer, trial, **fit_kwargs)
        finally:
            # The next trial's Trainer must not be built while this one's
            # state (a whole model and its optimizer on the card) is alive.
            del trainer
            gc.collect()

    def _fit_and_report(self, trainer, trial: Trial, **fit_kwargs) -> None:
        objective = self.oracle.objective

        outer = self

        class _Report:  # per-epoch oracle reporting + early stop
            def on_train_begin(self, t): ...
            def on_train_end(self, t): ...
            def on_epoch_begin(self, epoch, t): ...
            def on_step_end(self, step, logs, t): ...

            def on_epoch_end(self, epoch, logs, t):
                metric_logs = {
                    k: v for k, v in logs.items() if isinstance(v, (int, float))
                }
                status = outer.oracle.update_trial(trial, metric_logs, step=epoch)
                if status == TrialStatus.STOPPED:
                    t.stop_training = True

        callbacks = list(fit_kwargs.pop("callbacks", []))
        callbacks.append(_Report())
        trainer.fit(callbacks=callbacks, **fit_kwargs)
        # update_trial may have transitioned the trial to STOPPED (service
        # early stop); preserve that instead of overwriting with COMPLETED.
        final = (
            TrialStatus.COMPLETED
            if trial.status == TrialStatus.RUNNING
            else trial.status
        )
        self.oracle.end_trial(trial, final)

    def get_best_hyperparameters(self, num_trials: int = 1) -> List[HyperParameters]:
        return [t.hyperparameters for t in self.oracle.get_best_trials(num_trials)]
