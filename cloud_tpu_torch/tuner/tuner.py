"""CloudOracle + CloudTuner: the study-service-backed search (port of
``cloud_tpu/tuner/tuner.py``).

Reference analogue: ``tuner/tuner.py`` (CloudOracle :35-322, CloudTuner
:325-377).  The oracle drives any ``StudyService`` — Vizier REST in the
cloud, the file-backed local service offline — so distributed tuning is N
worker processes with distinct ``tuner_id``s sharing one study, with all
coordination in the service (SURVEY.md §2.6 last row).
"""

from __future__ import annotations

import datetime
import logging
from typing import Optional, Union

from cloud_tpu_torch.monitoring import tracing
from cloud_tpu_torch.tuner import vizier_utils
from cloud_tpu_torch.tuner.engine import Objective, Oracle, Trial, TrialStatus, Tuner
from cloud_tpu_torch.tuner.hyperparameters import HyperParameters
from cloud_tpu_torch.tuner.study_service import StudyService, SuggestionInactiveError

logger = logging.getLogger(__name__)


def default_study_id(prefix: str = "CloudTuner_study") -> str:
    """CloudTuner_study_<timestamp> (reference tuner.py:107-112)."""
    return f"{prefix}_{datetime.datetime.now().strftime('%Y%m%d_%H%M%S')}"


class CloudOracle(Oracle):
    """Oracle whose trials come from a shared study service.

    Accepts either (objective + hyperparameters) or a prebuilt Vizier
    ``study_config`` (reference tuner.py:69-93).
    """

    def __init__(
        self,
        service: StudyService,
        objective: Optional[Union[str, Objective]] = None,
        hyperparameters: Optional[HyperParameters] = None,
        study_config: Optional[dict] = None,
        max_trials: int = 10,
    ):
        if study_config is not None:
            if objective is not None or hyperparameters is not None:
                raise ValueError(
                    "Pass either study_config or "
                    "(objective + hyperparameters), not both."
                )
            objective_obj = vizier_utils.objective_from_study_config(study_config)
        else:
            if objective is None or hyperparameters is None:
                raise ValueError(
                    "Need objective and hyperparameters (or a study_config)."
                )
            objective_obj = vizier_utils.format_objective(objective)
            study_config = vizier_utils.make_study_config(
                objective_obj, hyperparameters
            )
        super().__init__(objective_obj, max_trials)
        self.study_config = study_config
        # Keep the user's declared space when given — the study-config wire
        # format is type-lossy (Boolean -> "True"/"False" strings etc.).
        self.hyperparameters = (
            hyperparameters
            if hyperparameters is not None
            else vizier_utils.convert_study_config_to_hps(study_config)
        )
        self.service = service
        self.service.create_or_load_study(study_config)
        self._created = 0

    def create_trial(self, tuner_id: str) -> Optional[Trial]:
        if self._created >= self.max_trials:
            return None
        # Study-wide cap (reference tuner.py:143-158): the budget bounds the
        # STUDY, not each worker — N workers with only local counters would
        # run up to N x max_trials trials between them.
        if len(self.service.list_trials()) >= self.max_trials:
            return None
        # Suggestion fetch is a remote round-trip (Vizier LRO with
        # backoff): span it so tuner wall-clock attributes service wait
        # separately from trial training time.
        with tracing.span("tuner/suggest", tuner_id=tuner_id):
            suggestion = self.service.get_suggestion(client_id=tuner_id)
        if suggestion is None:
            return None
        self._created += 1
        trial_id, values = suggestion
        values = vizier_utils.coerce_values(self.hyperparameters, values)
        trial = Trial(
            trial_id=trial_id,
            hyperparameters=self.hyperparameters.copy_with_values(values),
        )
        self.trials[trial_id] = trial
        return trial

    def update_trial(self, trial: Trial, metrics, step: int = 0) -> TrialStatus:
        super().update_trial(trial, metrics, step)
        if self.objective.name not in metrics:
            return TrialStatus.RUNNING
        try:
            self.service.report_intermediate(
                trial.trial_id, step, float(metrics[self.objective.name])
            )
            if self.service.should_stop(trial.trial_id):
                trial.status = TrialStatus.STOPPED
                return TrialStatus.STOPPED
        except SuggestionInactiveError:
            trial.status = TrialStatus.STOPPED
            return TrialStatus.STOPPED
        return TrialStatus.RUNNING

    def end_trial(self, trial: Trial,
                  status: TrialStatus = TrialStatus.COMPLETED) -> None:
        super().end_trial(trial, status)
        try:
            self.service.complete_trial(
                trial.trial_id,
                trial.score,
                infeasible=status == TrialStatus.INFEASIBLE,
            )
        except Exception:
            if status != TrialStatus.STOPPED:
                raise
            # The service already terminalized an early-stopped trial;
            # completing it again may be rejected — local state is correct.
            logger.warning(
                "complete_trial after early stop rejected for %s",
                trial.trial_id, exc_info=True,
            )


class CloudTuner(Tuner):
    """Tuner wired to a CloudOracle (reference tuner.py:325-377)."""

    def __init__(
        self,
        hypermodel,
        service: StudyService,
        *,
        objective: Optional[Union[str, Objective]] = None,
        hyperparameters: Optional[HyperParameters] = None,
        study_config: Optional[dict] = None,
        max_trials: int = 10,
        tuner_id: str = "tuner0",
    ):
        oracle = CloudOracle(
            service,
            objective=objective,
            hyperparameters=hyperparameters,
            study_config=study_config,
            max_trials=max_trials,
        )
        super().__init__(hypermodel, oracle, tuner_id=tuner_id)
