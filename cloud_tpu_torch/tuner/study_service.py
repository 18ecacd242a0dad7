"""Study services: the seam between the oracle and trial storage/suggestion
(the port's copy of ``cloud_tpu/tuner/study_service.py``; its study files
are byte for byte the JAX package's, so workers of both packages can share
one study directory).

``StudyService`` is the injectable protocol (reference pattern: the
`_OptimizerClient` seam, optimizer_client.py:55-66).  ``LocalStudyService``
is a file-backed, multi-process-safe implementation: N tuner workers on one
machine share a study through an fcntl-locked JSON file — the offline
equivalent of the reference's Vizier-backed distributed tuning (whose
coordination was entirely server-side, SURVEY.md §2.6), and the rig its
integration test simulated with a multiprocessing.Pool
(tuner_integration_test.py:283-296).
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import random
from typing import Any, Dict, List, Optional, Protocol, Tuple

from cloud_tpu_torch.tuner import vizier_utils


class SuggestionInactiveError(RuntimeError):
    """Trial became inactive server-side (reference optimizer_client.py)."""


class StudyService(Protocol):
    def create_or_load_study(self, study_config: dict) -> None: ...

    def get_suggestion(self, client_id: str) -> Optional[Tuple[str, Dict[str, Any]]]:
        """Returns (trial_id, parameter values) or None when exhausted."""

    def report_intermediate(self, trial_id: str, step: int, value: float) -> None: ...

    def should_stop(self, trial_id: str) -> bool: ...

    def complete_trial(self, trial_id: str, final_value: Optional[float],
                       infeasible: bool = False) -> None: ...

    def list_trials(self) -> List[dict]: ...


class LocalStudyService:
    """File-backed study with random-search suggestions + median stopping.

    Safe for concurrent workers: every read-modify-write happens under an
    exclusive ``fcntl`` lock on a sidecar lockfile.
    """

    def __init__(self, study_id: str, directory: str, *,
                 max_trials: int = 10, seed: Optional[int] = None):
        self.study_id = study_id
        self.directory = directory
        self.max_trials = max_trials
        self._seed = seed
        os.makedirs(directory, exist_ok=True)
        self._path = os.path.join(directory, f"{study_id}.json")
        self._lock_path = self._path + ".lock"

    @contextlib.contextmanager
    def _locked(self):
        with open(self._lock_path, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                state = self._read()
                yield state
                tmp = self._path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(state, f)
                os.replace(tmp, self._path)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    def _read(self) -> dict:
        if not os.path.exists(self._path):
            return {"config": None, "trials": {}, "counter": 0}
        with open(self._path) as f:
            return json.load(f)

    # --- StudyService protocol ---

    def create_or_load_study(self, study_config: dict) -> None:
        # Race-safe create-or-load (reference optimizer_client.py:364-443:
        # 409 -> get with retries; here the lock makes it trivial).
        with self._locked() as state:
            if state["config"] is None:
                state["config"] = study_config

    def get_suggestion(self, client_id: str):
        with self._locked() as state:
            if state["config"] is None:
                raise RuntimeError("Study not created; call create_or_load_study")
            if state["counter"] >= self.max_trials:
                return None  # exhausted (reference maps Vizier 429 to this)
            state["counter"] += 1
            trial_id = f"{state['counter']:04d}"
            hp = vizier_utils.convert_study_config_to_hps(state["config"])
            seed = (
                self._seed + state["counter"]
                if self._seed is not None
                else None
            )
            values = hp.sample(random.Random(seed))
            state["trials"][trial_id] = {
                "id": trial_id,
                "client_id": client_id,
                "params": values,
                "status": "ACTIVE",
                "measurements": [],
                "final": None,
            }
            return trial_id, values

    def report_intermediate(self, trial_id: str, step: int, value: float) -> None:
        with self._locked() as state:
            trial = state["trials"][trial_id]
            if trial["status"] != "ACTIVE":
                raise SuggestionInactiveError(trial_id)
            trial["measurements"].append({"step": step, "value": value})

    def should_stop(self, trial_id: str) -> bool:
        """Median automated stopping (Vizier's decay-curve analogue,
        reference utils.py:63-68): stop when the trial's latest value is
        worse than the median of other trials' values at >= that step."""
        with self._locked() as state:
            goal = _goal(state["config"])
            trial = state["trials"][trial_id]
            if not trial["measurements"]:
                return False
            step = trial["measurements"][-1]["step"]
            mine = trial["measurements"][-1]["value"]
            peers = []
            for other in state["trials"].values():
                if other["id"] == trial_id:
                    continue
                values = [
                    m["value"] for m in other["measurements"] if m["step"] <= step
                ]
                if values:
                    peers.append(
                        max(values) if goal == "MAXIMIZE" else min(values)
                    )
            if len(peers) < 3:
                return False
            peers.sort()
            median = peers[len(peers) // 2]
            return mine < median if goal == "MAXIMIZE" else mine > median

    def complete_trial(self, trial_id, final_value, infeasible=False) -> None:
        with self._locked() as state:
            trial = state["trials"][trial_id]
            trial["status"] = "INFEASIBLE" if infeasible else "COMPLETED"
            trial["final"] = final_value

    def list_trials(self) -> List[dict]:
        with self._locked() as state:
            return list(state["trials"].values())

    def delete_study(self) -> None:
        with contextlib.suppress(FileNotFoundError):
            os.remove(self._path)


def _goal(study_config: dict) -> str:
    metrics = study_config.get("metrics") or [{}]
    return metrics[0].get("goal", "MINIMIZE")
