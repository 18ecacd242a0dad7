"""Metrics, host-side span tracing and the timeline report (port of
``cloud_tpu/monitoring``'s ``metrics``, ``tracing`` and ``report``): what
the serving engine and the fleet record, and how a timeline reads back.
The exporter and the profiler are not ported yet (ROADMAP.md section A,
item 6)."""

from cloud_tpu_torch.monitoring import tracing
from cloud_tpu_torch.monitoring.metrics import (
    WindowedRate,
    backend,
    counter_inc,
    distribution_record,
    gauge_set,
    reset,
    snapshot,
)

__all__ = [
    "WindowedRate",
    "backend",
    "counter_inc",
    "distribution_record",
    "gauge_set",
    "reset",
    "snapshot",
    "tracing",
]
