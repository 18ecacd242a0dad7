"""Metrics and host-side span tracing (port of ``cloud_tpu/monitoring``'s
``metrics`` and ``tracing``): what the serving engine records.  The
exporter, the profiler and the report CLI are not ported yet (ROADMAP.md
section A, items 5 and 6)."""

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
