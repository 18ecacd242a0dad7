"""Cloud Monitoring exporter wiring + the Python transport (the port's copy
of ``cloud_tpu/monitoring/exporter.py``).

The primary wire client is the port's native library (``cpp/``, a copy
of the reference's ``wire_client.cc``): when it is built and libcurl
resolves, the periodic path — timer thread, snapshot, snapshot->TimeSeries
conversion, HTTP POST, OAuth token from the VM metadata server — runs in
C++.  This module keeps (a) the start/stop lifecycle and the env gates
(``CLOUD_TPU_MONITORING_ENABLED``, ``_PROJECT_ID``, ``_WIRE``,
``_INTERVAL``, ``_ALLOWLIST``), and (b) :class:`CloudMonitoringExporter`,
the Python transport used when the native path is unavailable, when a
session is injected, or with ``CLOUD_TPU_MONITORING_WIRE=python``.  The
request bodies (``custom.googleapis.com/cloud_tpu`` metric prefix,
descriptor dedup, histograms as exponential-bucket ``Distribution``s) are
the reference's.
"""

from __future__ import annotations

import ctypes
import json
import logging
import os
import threading
import time
from typing import Optional, Set

from cloud_tpu_torch.monitoring import metrics as metrics_lib
from cloud_tpu_torch.utils import api_client

logger = logging.getLogger(__name__)

_MONITORING_API = "https://monitoring.googleapis.com/v3"
METRIC_PREFIX = "custom.googleapis.com/cloud_tpu"
ENV_PROJECT = "CLOUD_TPU_MONITORING_PROJECT_ID"

#: Exponential bucket bounds matching the native registry: 2^(k-1).
_BUCKET_GROWTH = 2.0


def _now_rfc3339() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


class CloudMonitoringExporter:
    """Converts registry snapshots to CreateTimeSeries requests."""

    def __init__(self, project: Optional[str] = None,
                 session: Optional[api_client.GcpApiSession] = None):
        self.project = project or os.environ.get(ENV_PROJECT)
        if not self.project:
            raise ValueError(
                f"Set {ENV_PROJECT} (reference used "
                "TF_MONITORING_STACKDRIVER_PROJECT_ID the same way)."
            )
        self._session = session or api_client.default_session()
        self._described: Set[str] = set()  # descriptor dedup (:105-126)

    # --- conversion (pure; golden-tested) ---

    def time_series(self, snapshot: dict) -> list:
        end_time = _now_rfc3339()
        series = []
        for name, value in snapshot.get("counters", {}).items():
            series.append(self._one_series(
                name, "CUMULATIVE", {"int64Value": str(value)}, end_time
            ))
        for name, value in snapshot.get("gauges", {}).items():
            series.append(self._one_series(
                name, "GAUGE", {"doubleValue": value}, end_time
            ))
        for name, dist in snapshot.get("distributions", {}).items():
            buckets = dist["buckets"]
            series.append(self._one_series(
                name,
                "CUMULATIVE",
                {
                    "distributionValue": {
                        "count": str(dist["count"]),
                        "mean": dist["mean"],
                        "sumOfSquaredDeviation": dist["sum_squared_deviation"],
                        "bucketOptions": {
                            "exponentialBuckets": {
                                "numFiniteBuckets": len(buckets) - 2,
                                "growthFactor": _BUCKET_GROWTH,
                                "scale": 1.0,
                            }
                        },
                        "bucketCounts": [str(c) for c in buckets],
                    }
                },
                end_time,
            ))
        return series

    def _one_series(self, name, kind, value, end_time):
        interval = {"endTime": end_time}
        if kind == "CUMULATIVE":
            interval["startTime"] = _START_TIME
        return {
            "metric": {"type": f"{METRIC_PREFIX}/{name}"},
            "resource": {"type": "global", "labels": {}},
            "metricKind": kind,
            "points": [{"interval": interval, "value": value}],
        }

    # --- transport ---

    def export(self, snapshot: dict) -> None:
        series = self.time_series(snapshot)
        if not series:
            return
        self._ensure_descriptors(snapshot)
        url = f"{_MONITORING_API}/projects/{self.project}/timeSeries"
        # The API caps 200 series per call.
        for start in range(0, len(series), 200):
            self._session.post(
                url, body={"timeSeries": series[start:start + 200]}
            )

    def _ensure_descriptors(self, snapshot: dict) -> None:
        kinds = (
            [(n, "CUMULATIVE", "INT64") for n in snapshot.get("counters", {})]
            + [(n, "GAUGE", "DOUBLE") for n in snapshot.get("gauges", {})]
            + [
                (n, "CUMULATIVE", "DISTRIBUTION")
                for n in snapshot.get("distributions", {})
            ]
        )
        url = f"{_MONITORING_API}/projects/{self.project}/metricDescriptors"
        for name, kind, value_type in kinds:
            if name in self._described:
                continue
            self._session.post(url, body={
                "type": f"{METRIC_PREFIX}/{name}",
                "metricKind": kind,
                "valueType": value_type,
                "description": f"cloud_tpu framework metric {name}",
            })
            self._described.add(name)


_START_TIME = _now_rfc3339()  # process start = CUMULATIVE interval start

_sink_keepalive = None  # the ctypes callback must outlive the C thread
_python_thread: Optional[threading.Thread] = None
_python_stop = threading.Event()
_final_flush = None  # set by start_exporter; drains the last interval
_started = False  # idempotency guard covering both backends


def _env_allowlist() -> Set[str]:
    """Same contract as the native exporter (CLOUD_TPU_MONITORING_ALLOWLIST,
    ref stackdriver_config.cc:26-32); empty => export everything."""
    return {
        name
        for name in os.environ.get(
            "CLOUD_TPU_MONITORING_ALLOWLIST", ""
        ).split(",")
        if name
    }


def _filtered_snapshot(allowlist: Set[str]) -> dict:
    snap = metrics_lib.snapshot()
    if not allowlist:
        return snap
    return {
        group: {k: v for k, v in values.items() if k in allowlist}
        for group, values in snap.items()
    }


def start_exporter(project: Optional[str] = None, session=None) -> bool:
    """Start periodic export (env-gated, like REGISTER_TF_METRICS_EXPORTER +
    TF_MONITORING_STACKDRIVER_EXPORTER_ENABLED, stackdriver_exporter.cc:31-36).

    Returns True if the exporter started.  Uses the native timer thread when
    the C++ library is live, else a Python thread.
    """
    global _sink_keepalive, _python_thread, _final_flush, _started
    if os.environ.get("CLOUD_TPU_MONITORING_ENABLED", "").lower() not in (
        "1", "true",
    ):
        return False
    if _started:
        # Idempotent, matching Exporter::Start — and crucially *before*
        # constructing a second exporter, which would rebind the sink and
        # final flush onto a fresh descriptor-dedup set mid-run.
        return True

    # Preferred: the all-native wire path (no Python in the loop).  An
    # injected session is a test/transport override and forces the Python
    # exporter; CLOUD_TPU_MONITORING_WIRE=python opts out explicitly.
    if (
        metrics_lib.backend() == "native"
        and session is None
        and os.environ.get("CLOUD_TPU_MONITORING_WIRE", "native") != "python"
    ):
        lib = metrics_lib._get_registry()._lib  # type: ignore[union-attr]
        if (
            hasattr(lib, "ctpu_wire_available")
            and lib.ctpu_wire_available()
            and (project or os.environ.get(ENV_PROJECT))
        ):
            lib.ctpu_wire_set_project.argtypes = [ctypes.c_char_p]
            lib.ctpu_wire_export_snapshot.argtypes = [ctypes.c_char_p]
            if project:
                lib.ctpu_wire_set_project(project.encode())
            lib.ctpu_exporter_use_wire_client()
            lib.ctpu_exporter_config_reload()
            _started = bool(lib.ctpu_exporter_start())
            if _started:
                def native_flush() -> None:
                    rc = lib.ctpu_wire_export_snapshot(
                        json.dumps(
                            _filtered_snapshot(_env_allowlist())
                        ).encode()
                    )
                    if rc != 0:
                        logger.warning(
                            "native final metrics flush failed (status %d)",
                            rc,
                        )

                _final_flush = native_flush
                logger.info("monitoring: native C++ wire client active")
            else:
                _final_flush = None
            return _started

    exporter = CloudMonitoringExporter(project=project, session=session)

    def sink_json(payload: str) -> None:
        try:
            exporter.export(json.loads(payload))
        except Exception:
            logger.exception("metrics export failed")

    def final_flush() -> None:
        sink_json(json.dumps(_filtered_snapshot(_env_allowlist())))

    if metrics_lib.backend() == "native":
        lib = metrics_lib._get_registry()._lib  # type: ignore[union-attr]
        SINK = ctypes.CFUNCTYPE(None, ctypes.c_char_p)

        def c_sink(raw):
            sink_json(raw.decode())

        _sink_keepalive = SINK(c_sink)
        lib.ctpu_exporter_set_sink.argtypes = [SINK]
        lib.ctpu_exporter_set_sink(_sink_keepalive)
        # The C++ config singleton caches env at first touch, which may
        # predate this call (any snapshot constructs it); re-read so the
        # enable gate above and the native gate agree.
        lib.ctpu_exporter_config_reload()
        _started = bool(lib.ctpu_exporter_start())
        # Arm the final flush only for a live exporter: a failed start must
        # not leave stop_exporter() posting a snapshot through an exporter
        # that never ran.
        _final_flush = final_flush if _started else None
        return _started

    interval = int(os.environ.get("CLOUD_TPU_MONITORING_INTERVAL", "10"))
    allowlist = _env_allowlist()
    _python_stop.clear()

    def loop():
        while not _python_stop.wait(interval):
            sink_json(json.dumps(_filtered_snapshot(allowlist)))

    _python_thread = threading.Thread(target=loop, daemon=True)
    _python_thread.start()
    _started = True
    _final_flush = final_flush
    return True


def stop_exporter() -> None:
    """Stop the periodic thread and drain the final partial interval."""
    global _python_thread, _final_flush, _started
    if metrics_lib.backend() == "native":
        lib = metrics_lib._get_registry()._lib  # type: ignore[union-attr]
        lib.ctpu_exporter_stop()  # joins the C thread (exporter.cc:74-81)
    _python_stop.set()
    joined = True
    if _python_thread is not None:
        _python_thread.join(timeout=5)
        joined = not _python_thread.is_alive()
        _python_thread = None
    if _final_flush is not None:
        if joined:
            # Safe: no loop thread shares the session/exporter anymore.
            _final_flush()
        else:
            logger.warning(
                "export loop still mid-request; skipping final flush"
            )
        _final_flush = None
    _started = False
