"""Hyperparameter tuning: Vizier-backed study oracle + search engine (port
of ``cloud_tpu/tuner/``).

The modules import no framework: a trial is whatever the hypermodel
builds, in the port a ``training.Trainer`` on the card (or on the CPU
when it is built with ``device="cpu"``).

Reference analogue: ``src/python/tensorflow_cloud/tuner/`` (CloudOracle/
CloudTuner over the KerasTuner engine, tuner.py:32-377).  KerasTuner is not
a dependency here; the engine (``engine.py``) is self-contained, and the
oracle speaks to a ``StudyService`` seam with two implementations: the
Vizier REST client (``vizier_client.py``) and a file-backed local service
(``study_service.py``) that supports multi-process distributed tuning
without any cloud dependency — the offline analogue of the reference's
multiprocessing-Pool integration test (tuner_integration_test.py:283-296).
"""

from cloud_tpu_torch.tuner.dispatch import dispatch_search
from cloud_tpu_torch.tuner.engine import Objective, Trial, TrialStatus, Tuner
from cloud_tpu_torch.tuner.hyperparameters import HyperParameters
from cloud_tpu_torch.tuner.study_service import LocalStudyService
from cloud_tpu_torch.tuner.tuner import CloudOracle, CloudTuner

__all__ = [
    "CloudOracle",
    "CloudTuner",
    "HyperParameters",
    "LocalStudyService",
    "Objective",
    "Trial",
    "TrialStatus",
    "Tuner",
    "dispatch_search",
]
