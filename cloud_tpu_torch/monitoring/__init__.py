"""Metrics, host-side span tracing, the timeline report, the Cloud
Monitoring exporter and the profiler (port of ``cloud_tpu/monitoring``).

The registry is the port's native C++ library (``cpp/``, ctypes-bound,
with the pure-Python fallback), the exporter ships its snapshots to Cloud
Monitoring (``exporter.py``: the native wire client or the REST session),
and ``profiler`` captures ``torch.profiler`` traces (loaded lazily).

Also the Trainer integration: :class:`MetricsCallback` records steps/sec
and the loss into the registry (``Trainer.fit`` installs one).
"""

import time as _time

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
from cloud_tpu_torch.monitoring.exporter import (
    CloudMonitoringExporter,
    start_exporter,
    stop_exporter,
)


def __getattr__(name):
    # Lazy, as in the reference: ``monitoring.profiler`` resolves on first
    # use.  importlib, not ``from ... import``: the from-import form asks
    # the package for the attribute first, which re-enters this
    # __getattr__.
    if name == "profiler":
        import importlib

        return importlib.import_module("cloud_tpu_torch.monitoring.profiler")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class MetricsCallback:
    """Trainer callback feeding the metrics registry each step/epoch.

    ``Trainer.fit`` installs one unless ``CLOUD_TPU_RUNTIME_METRICS=0``:
    every training run produces ``train/steps``, ``train/step_time_ms``,
    ``train/steps_per_sec``, ``train/loss`` and ``train/epochs``.

    Hot-path contract: never force a device sync.  The loss gauge is
    read with a ONE-STEP LAG — by the time step N ends, step N-1's
    metrics are materialized on the device, so ``float()`` on them
    returns without stalling the stream.  Step time is host wall-clock
    between step dispatches; steps/sec is a windowed gauge (updated every
    ``window`` steps).
    """

    def __init__(self, prefix: str = "train", *, window: int = 20):
        self.prefix = prefix
        self._rate = WindowedRate(f"{prefix}/steps_per_sec", window)
        self._last_step_time = None
        self._last_step_number = None
        self._lagged_logs = None

    def _record_lagged_loss(self):
        logs = self._lagged_logs
        self._lagged_logs = None
        if not logs or "loss" not in logs:
            return
        try:
            gauge_set(f"{self.prefix}/loss", float(logs["loss"]))
        except (TypeError, ValueError):
            pass

    def on_train_begin(self, trainer):
        now = _time.perf_counter()
        self._last_step_time = now
        self._rate.restart(now)
        self._lagged_logs = None
        # Seed the step-delta base so the FIRST fused window counts all
        # its steps (resumed fits start above zero).
        self._last_step_number = None
        state = getattr(trainer, "state", None)
        if state is not None:
            try:
                self._last_step_number = int(state.step)
            except (TypeError, ValueError):
                pass
        counter_inc(f"{self.prefix}/runs")

    def on_train_end(self, trainer):
        # The final step's loss never got its lagged read; it is
        # materialized by now (the epoch loop read the epoch's metrics).
        self._record_lagged_loss()

    def on_epoch_begin(self, epoch, trainer):
        # Restart both timers: inter-epoch work (validation, epoch-end
        # callbacks, the host read of the epoch's metrics) must count
        # neither as step time nor as steps/sec window time.
        now = _time.perf_counter()
        self._last_step_time = now
        self._rate.restart(now)

    def on_step_end(self, step, logs, trainer):
        now = _time.perf_counter()
        # With fit(steps_per_dispatch=K) this hook fires once per fused
        # K-step window; the step-number delta recovers K so train/steps
        # and steps_per_sec stay per-STEP series, and step_time_ms stays
        # per-step (window wall-clock / K).
        n = 1
        if self._last_step_number is not None:
            n = max(1, step - self._last_step_number)
        self._last_step_number = step
        if self._last_step_time is not None:
            distribution_record(
                f"{self.prefix}/step_time_ms",
                (now - self._last_step_time) * 1e3 / n,
            )
        self._last_step_time = now
        counter_inc(f"{self.prefix}/steps", n)
        self._record_lagged_loss()
        self._lagged_logs = logs
        self._rate.add(now, n)

    def on_epoch_end(self, epoch, logs, trainer):
        # Publish the partial window with the LAST step's timestamp, so
        # short epochs still produce a rate and validation time is
        # excluded from it.
        if self._last_step_time is not None:
            self._rate.flush(self._last_step_time)
        counter_inc(f"{self.prefix}/epochs")
        for key, value in logs.items():
            if key == "loss":
                # train/loss is the per-step lagged gauge; writing the
                # epoch MEAN into the same series would make it
                # alternate between two different quantities.
                continue
            try:
                gauge_set(f"{self.prefix}/{key}", float(value))
            except (TypeError, ValueError):
                continue


__all__ = [
    "CloudMonitoringExporter",
    "MetricsCallback",
    "WindowedRate",
    "backend",
    "counter_inc",
    "distribution_record",
    "gauge_set",
    "reset",
    "snapshot",
    "start_exporter",
    "stop_exporter",
    "tracing",
]
