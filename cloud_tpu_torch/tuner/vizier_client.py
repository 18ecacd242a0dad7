"""Vizier (CAIP Optimizer) REST client implementing StudyService (port of
``cloud_tpu/tuner/vizier_client.py``, over the port's ``utils.api_client``).

Reference analogue: ``tuner/optimizer_client.py`` — semantics carried over:
HTTP 429 on suggestion = search space exhausted (:109-121); study create
409 = already exists -> load with 3 retries (:364-443); long-running-op
polling with 1.41^n bounded exponential backoff, <=30 attempts (~10 min,
:294-348); intermediate measurements + early-stopping checks (:136-202);
complete/infeasible (:204-237).  The vendored discovery document is
replaced by direct REST over the injectable ``GcpApiSession``.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from cloud_tpu_torch.tuner.study_service import SuggestionInactiveError
from cloud_tpu_torch.utils import api_client

logger = logging.getLogger(__name__)

_BASE = "https://ml.googleapis.com/v1"
_LRO_MAX_ATTEMPTS = 30  # reference constants: ~10 min of 1.41^n backoff
_LRO_BASE_DELAY = 1.0
_LRO_BACKOFF = 1.41
_LRO_MAX_DELAY = 30.0  # per-attempt cap keeps the total bound ~10 min
_STUDY_GET_RETRIES = 3  # reference constants.py:30


class VizierStudyService:
    """StudyService over the CAIP Optimizer REST API."""

    def __init__(
        self,
        project: str,
        region: str,
        study_id: str,
        *,
        session: Optional[api_client.GcpApiSession] = None,
        sleeper: Callable[[float], None] = time.sleep,
    ):
        self.project = project
        self.region = region
        self.study_id = study_id
        self._session = session or api_client.default_session()
        self._sleep = sleeper
        #: Objective metric name; Measurement.Metric entries must carry it or
        #: the service cannot attribute values to the study objective.
        #: Learned from study_config at create time, else fetched lazily.
        self._objective: Optional[str] = None
        self._objective_fetched = False

    @property
    def _parent(self) -> str:
        return f"projects/{self.project}/locations/{self.region}"

    @property
    def _study_path(self) -> str:
        return f"{self._parent}/studies/{self.study_id}"

    # --- StudyService protocol ---

    def create_or_load_study(self, study_config: dict) -> None:
        """Race-safe create: many workers may start simultaneously
        (reference optimizer_client.py:364-443)."""
        metrics = study_config.get("metrics") or []
        if metrics:
            self._objective = metrics[0].get("metric")
        try:
            self._session.post(
                f"{_BASE}/{self._parent}/studies",
                body={"studyConfig": study_config},
                params={"studyId": self.study_id},
            )
            return
        except api_client.ApiError as e:
            if e.status != 409:  # already exists -> fall through to load
                raise
        last = None
        for _ in range(_STUDY_GET_RETRIES):
            try:
                self._session.get(f"{_BASE}/{self._study_path}")
                return
            except api_client.ApiError as e:
                last = e
                self._sleep(1.0)
        raise RuntimeError(
            f"Study {self.study_id} reported 409 on create but could not be "
            f"loaded after {_STUDY_GET_RETRIES} attempts"
        ) from last

    def get_suggestion(self, client_id: str) -> Optional[Tuple[str, Dict[str, Any]]]:
        from cloud_tpu_torch.tuner import vizier_utils

        try:
            op = self._session.post(
                f"{_BASE}/{self._study_path}/trials:suggest",
                body={"suggestionCount": 1, "clientId": client_id},
            )
        except api_client.ApiError as e:
            if e.status == 429:
                # Search space exhausted (reference :109-121).
                return None
            raise
        result = self._poll_operation(op)
        trials = result.get("trials", [])
        if not trials:
            return None
        trial = trials[0]
        trial_id = trial["name"].split("/")[-1]
        return trial_id, vizier_utils.convert_vizier_trial_to_values(trial)

    def report_intermediate(self, trial_id: str, step: int, value: float) -> None:
        # Resolve the metric name BEFORE the measurement call: a failure of
        # the study-config GET must surface as a study-access error, not be
        # mapped to SuggestionInactiveError(trial_id) below.
        entry = self._metric_entry(value)
        try:
            self._session.post(
                f"{_BASE}/{self._study_path}/trials/{trial_id}:addMeasurement",
                body={
                    "measurement": {
                        "stepCount": str(step),
                        "metrics": [entry],
                    }
                },
            )
        except api_client.ApiError as e:
            if e.status == 400:
                raise SuggestionInactiveError(trial_id) from e
            raise

    def should_stop(self, trial_id: str) -> bool:
        op = self._session.post(
            f"{_BASE}/{self._study_path}/trials/{trial_id}"
            ":checkEarlyStoppingState",
            body={},
        )
        result = self._poll_operation(op)
        if result.get("shouldStop"):
            self._session.post(
                f"{_BASE}/{self._study_path}/trials/{trial_id}:stop", body={}
            )
            return True
        return False

    def complete_trial(self, trial_id: str, final_value: Optional[float],
                       infeasible: bool = False) -> None:
        body: dict = {}
        if infeasible:
            body = {"trialInfeasible": True, "infeasibleReason": "trial failed"}
        elif final_value is not None:
            body = {
                "finalMeasurement": {
                    "metrics": [self._metric_entry(final_value)]
                }
            }
        self._session.post(
            f"{_BASE}/{self._study_path}/trials/{trial_id}:complete", body=body
        )

    def list_trials(self) -> List[dict]:
        resp = self._session.get(f"{_BASE}/{self._study_path}/trials")
        return resp.get("trials", [])

    def delete_study(self) -> None:
        self._session.delete(f"{_BASE}/{self._study_path}")

    # --- internals ---

    def _metric_entry(self, value: float) -> Dict[str, Any]:
        """Measurement.Metric with the study's objective name attached.

        Workers that loaded (rather than created) the study learn the name
        by fetching the study config once.
        """
        if self._objective is None and not self._objective_fetched:
            study = self._session.get(f"{_BASE}/{self._study_path}")
            metrics = study.get("studyConfig", {}).get("metrics") or []
            if metrics:
                self._objective = metrics[0].get("metric")
            # Remember even a no-metrics answer: without this flag every
            # measurement re-fetches the study on the reporting hot path.
            self._objective_fetched = True
        if self._objective is None:
            return {"value": value}
        return {"metric": self._objective, "value": value}

    def _poll_operation(self, operation: dict) -> dict:
        """Bounded-backoff LRO polling (reference :294-348)."""
        name = operation.get("name")
        for attempt in range(_LRO_MAX_ATTEMPTS):
            if operation.get("done"):
                if "error" in operation:
                    raise RuntimeError(f"Vizier operation failed: {operation['error']}")
                return operation.get("response", {})
            self._sleep(
                min(_LRO_MAX_DELAY, _LRO_BASE_DELAY * (_LRO_BACKOFF ** attempt))
            )
            operation = self._session.get(f"{_BASE}/{name}")
        raise TimeoutError(
            f"Vizier operation {name} not done after {_LRO_MAX_ATTEMPTS} polls"
        )
