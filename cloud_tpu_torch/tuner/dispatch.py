"""Distributed HP search dispatch: N launcher jobs, one shared study (port
of ``cloud_tpu/tuner/dispatch.py``; the jobs go through the port's
``core.run.run``).

The reference's distributed tuning model (SURVEY.md §2.6 last row): N
independent tuner workers share one Vizier study, deduplicated by
``tuner_id``/``client_id``, all coordination server-side.  The reference
left job fan-out to the user (its CAIP-as-flock-manager test was a stub,
tuner_integration_test.py:298-301); ``dispatch_search`` closes that gap —
the "trials onto TPU workers" north-star (BASELINE.json).

Worker contract: the entry-point script receives ``--study-id <id>`` and
``--tuner-id tuner<i>`` appended to its args and must construct its
``CloudTuner(service=..., tuner_id=...)`` from them (see
tests/testdata/tuner_mnist_example.py).
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from cloud_tpu_torch.tuner.tuner import default_study_id


def _label_safe(value: str) -> str:
    """GCP label values: lowercase, [a-z0-9_-], <=63 chars (gcp.py rules)."""
    return re.sub(r"[^a-z0-9_-]", "-", value.lower())[:63]


def dispatch_search(
    n_workers: int,
    entry_point: str,
    *,
    study_id: Optional[str] = None,
    entry_point_args: Optional[List[str]] = None,
    job_labels: Optional[dict] = None,
    **run_kwargs,
) -> Tuple[str, List]:
    """Submit ``n_workers`` launcher jobs sharing one study.

    Every worker runs ``entry_point`` with ``--study-id``/--tuner-id``
    appended; remaining ``run_kwargs`` pass through to
    :func:`cloud_tpu_torch.run` unchanged (``dry_run=True`` fans out reports
    without submitting).  Returns ``(study_id, [RunReport, ...])``.
    """
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    from cloud_tpu_torch.core import run as run_lib

    study = study_id or default_study_id()
    labels = dict(job_labels or {})
    labels.setdefault("study_id", _label_safe(study))
    reports = []
    for worker in range(n_workers):
        args = list(entry_point_args or []) + [
            "--study-id", study, "--tuner-id", f"tuner{worker}",
        ]
        reports.append(
            run_lib.run(
                entry_point=entry_point,
                entry_point_args=args,
                job_labels=labels,
                **run_kwargs,
            )
        )
    return study, reports
