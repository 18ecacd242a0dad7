"""The port's native metrics library and Cloud Monitoring exporter
(``cloud_tpu_torch/monitoring/cpp``, ``metrics.py``, ``exporter.py``)
against the JAX package's, on the CPU.

* The port's registry, built with ``g++`` here, gives the same snapshot
  JSON as the JAX package's library (and as the port's pure-Python
  fallback) for the same sequence of records; its C tests pass.
* ``CloudMonitoringExporter`` gives the same ``timeSeries`` and descriptor
  bodies as JAX's for the same snapshot, and so does the port's native
  wire client through an injected transport (no network anywhere).
* The env gates, idempotent start and the final flush.
* ``test_bootstrapped_run_exports_time_series`` of
  ``tests/unit/test_launcher.py`` on the port: the bootstrap in-process on
  the CPU with the deployed node's monitoring env, training the port's
  MNIST workload, exports ``train/steps`` and ``train/step_time_ms``.
"""

import ctypes
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from cloud_tpu.monitoring import exporter as jax_exporter
from cloud_tpu.monitoring import metrics as jax_metrics
from cloud_tpu_torch import monitoring
from cloud_tpu_torch.monitoring import exporter, metrics
from cloud_tpu_torch.utils import api_client
from unit.fakes import RecordingSession

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

#: One sequence of records: integer and large counters, non-finite and
#: negative gauges, distribution values across the buckets (0, below 1,
#: powers of two, the last bucket, inf/nan) and names that need escapes.
RECORDS = [
    ("counter_inc", "train/steps", 3), ("counter_inc", "train/steps", 4),
    ("counter_inc", "big", 2 ** 40), ("gauge_set", "loss", 0.125),
    ("gauge_set", "loss", 2.5), ("gauge_set", "neg", -1e-3),
    ("gauge_set", "bad", float("nan")), ("gauge_set", "huge", float("inf")),
    ("counter_inc", 'we"ird\\name\t', 1),
    *[("distribution_record", "lat_ms", v) for v in (
        0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 7.9, 8.0, 1000.0, 2.0 ** 30,
        float("inf"), float("nan"), -4.0)],
    ("distribution_record", "one", 5.0),
]


def _record(module):
    module.reset()
    for fn, name, value in RECORDS:
        getattr(module, fn)(name, value)
    snap = module.snapshot()
    module.reset()
    return snap


def test_native_registry_snapshots_equal_the_reference():
    assert metrics.backend() == "native"
    assert jax_metrics.backend() == "native"
    assert metrics.LIB_NAME != "libcloud_tpu_monitoring.so"
    got, want = _record(metrics), _record(jax_metrics)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["counters"]["train/steps"] == 7


def test_native_and_python_registries_agree():
    py = metrics._PurePythonRegistry()
    for fn, name, value in RECORDS:
        getattr(py, fn)(name, value)
    native = _record(metrics)
    py_snap = py.snapshot()
    assert py_snap["counters"] == native["counters"]
    assert py_snap["gauges"] == native["gauges"]
    assert py_snap["distributions"].keys() == native["distributions"].keys()
    for name, dist in native["distributions"].items():
        other = py_snap["distributions"][name]
        assert dist["count"] == other["count"]
        assert dist["buckets"] == other["buckets"]
        assert dist["mean"] == pytest.approx(other["mean"], rel=1e-12)


def test_native_library_c_tests_pass(tmp_path):
    cpp = tmp_path / "cpp"
    shutil.copytree(REPO / "cloud_tpu_torch" / "monitoring" / "cpp", cpp,
                    ignore=shutil.ignore_patterns("*.so", "*_test"))
    out = subprocess.run(["make", "-C", str(cpp), "test"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "registry_test: all tests passed" in out.stdout
    assert "wire_client_test: all tests passed" in out.stdout


SNAPSHOT = {
    "counters": {"steps": 7, "train/epochs": 2},
    "gauges": {"loss": 0.5, "train/steps_per_sec": 123.25},
    "distributions": {
        "lat": {"count": 2, "mean": 3.0, "sum_squared_deviation": 2.0,
                "buckets": [0, 1, 1, 0] + [0] * 20},
    },
}


def _exporter_calls(module, snapshot, monkeypatch, times=2):
    monkeypatch.setattr(module, "_now_rfc3339",
                        lambda: "2026-01-01T00:00:10Z")
    monkeypatch.setattr(module, "_START_TIME", "2026-01-01T00:00:00Z")
    session = RecordingSession()
    exp = module.CloudMonitoringExporter(project="p", session=session)
    series = exp.time_series(snapshot)
    for _ in range(times):
        exp.export(snapshot)
    return series, session.calls


def test_exporter_bodies_equal_the_reference(monkeypatch):
    got = _exporter_calls(exporter, SNAPSHOT, monkeypatch)
    want = _exporter_calls(jax_exporter, SNAPSHOT, monkeypatch)
    assert got == want
    series, calls = got
    # Descriptors once, then one timeSeries post per export.
    assert [c[1].rsplit("/", 1)[-1] for c in calls] == (
        ["metricDescriptors"] * 5 + ["timeSeries"] * 2)
    assert {s["metric"]["type"] for s in series} == {
        f"custom.googleapis.com/cloud_tpu/{n}" for n in (
            "steps", "train/epochs", "loss", "train/steps_per_sec", "lat")}
    big = {"counters": {f"m{i}": i for i in range(250)}}
    assert (_exporter_calls(exporter, big, monkeypatch, 1)
            == _exporter_calls(jax_exporter, big, monkeypatch, 1))


def test_exporter_requires_a_project(monkeypatch):
    monkeypatch.delenv(exporter.ENV_PROJECT, raising=False)
    errors = []
    for module in (exporter, jax_exporter):
        with pytest.raises(ValueError) as got:
            module.CloudMonitoringExporter(session=RecordingSession())
        errors.append(str(got.value))
    assert errors[0] == errors[1]


@pytest.fixture()
def wire():
    """The port's native wire client with a recording transport."""
    lib = metrics._get_registry()._lib
    requests = []
    transport_t = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_char_p)
    stub = transport_t(lambda url, body, auth: (
        requests.append((url.decode(), json.loads(body.decode()))), 200)[1])
    lib.ctpu_wire_reset()
    lib.ctpu_wire_set_transport.argtypes = [transport_t]
    lib.ctpu_wire_set_transport(stub)
    lib.ctpu_wire_set_project.argtypes = [ctypes.c_char_p]
    lib.ctpu_wire_export_snapshot.argtypes = [ctypes.c_char_p]
    lib.ctpu_wire_time_series_body.restype = ctypes.c_void_p
    lib.ctpu_wire_time_series_body.argtypes = [ctypes.c_char_p] * 3
    lib.ctpu_free.argtypes = [ctypes.c_void_p]
    yield lib, requests
    lib.ctpu_wire_reset()


def test_native_wire_bodies_equal_the_python_transport(wire, monkeypatch):
    lib, requests = wire
    start, end = "2026-01-01T00:00:00Z", "2026-01-01T00:00:10Z"
    ptr = lib.ctpu_wire_time_series_body(json.dumps(SNAPSHOT).encode(),
                                         start.encode(), end.encode())
    native = json.loads(ctypes.string_at(ptr).decode())
    lib.ctpu_free(ptr)
    series, _ = _exporter_calls(exporter, SNAPSHOT, monkeypatch, 0)
    by_type = {s["metric"]["type"]: s for s in native["timeSeries"]}
    assert len(by_type) == len(series)
    for s in series:
        assert by_type[s["metric"]["type"]] == s
    lib.ctpu_wire_set_project(b"wire-proj")
    assert lib.ctpu_wire_export_snapshot(json.dumps(SNAPSHOT).encode()) == 0
    assert [u.rsplit("/", 1)[-1] for u, _ in requests] == (
        ["metricDescriptors"] * 5 + ["timeSeries"])


def test_env_gates(wire, monkeypatch):
    lib, requests = wire
    monkeypatch.delenv("CLOUD_TPU_MONITORING_ENABLED", raising=False)
    assert not exporter.start_exporter(project="p",
                                       session=RecordingSession())
    # The native wire: chosen when no session is injected and a project
    # is set; the stub transport stands in for libcurl.
    monkeypatch.setenv("CLOUD_TPU_MONITORING_ENABLED", "1")
    monkeypatch.setenv(exporter.ENV_PROJECT, "wire-proj")
    monitoring.counter_inc("wire_lifecycle/steps", 2)
    try:
        assert exporter.start_exporter()
        assert exporter.start_exporter()  # idempotent
    finally:
        exporter.stop_exporter()
    assert any("wire_lifecycle/steps" in ts["metric"]["type"]
               for url, body in requests if url.endswith("/timeSeries")
               for ts in body["timeSeries"])
    # The Python wire: an injected session, the allowlist applied.
    monkeypatch.setenv("CLOUD_TPU_MONITORING_ALLOWLIST", "kept/steps")
    monkeypatch.setenv("CLOUD_TPU_MONITORING_INTERVAL", "3600")
    session = RecordingSession()
    try:
        assert exporter.start_exporter(project="p", session=session)
        flush = exporter._final_flush
        assert exporter.start_exporter(project="p",
                                       session=RecordingSession())
        assert exporter._final_flush is flush
        monitoring.counter_inc("kept/steps", 3)
        monitoring.counter_inc("dropped/steps", 3)
    finally:
        exporter.stop_exporter()
    assert exporter._final_flush is None and not exporter._started
    types = {ts["metric"]["type"] for _, _, body, _ in session.calls
             for ts in body.get("timeSeries", [])}
    assert types == {"custom.googleapis.com/cloud_tpu/kept/steps"}


def test_bootstrapped_run_exports_time_series(monkeypatch):
    """The env pair the startup script sets -> the bootstrap starts the
    exporter -> the port's MNIST workload trains a few steps on the CPU
    -> runtime time series on the (fake) wire."""
    from cloud_tpu_torch.core import bootstrap

    fake = RecordingSession()
    monkeypatch.setattr(api_client, "default_session", lambda: fake)
    monkeypatch.setenv("CLOUD_TPU_MONITORING_ENABLED", "1")
    monkeypatch.setenv("CLOUD_TPU_MONITORING_PROJECT_ID", "fake-mon-proj")
    monkeypatch.setenv("CLOUD_TPU_MONITORING_WIRE", "python")
    monkeypatch.setenv("CLOUD_TPU_MONITORING_INTERVAL", "3600")
    monkeypatch.setenv("MNIST_EXAMPLE_EPOCHS", "2")
    monkeypatch.setenv("MNIST_EXAMPLE_STEPS", "4")
    for var in ("CLOUD_TPU_RUNNING_REMOTELY", "CLOUD_TPU_COORDINATOR",
                "CLOUD_TPU_COMPILE_CACHE", "CLOUD_TPU_PROFILER_PORT",
                "CLOUD_TPU_MONITORING_ALLOWLIST"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    entry = REPO / "tests" / "helpers" / "torch_mnist_example.py"
    try:
        bootstrap.main([f"--entry-point={entry}", "--device=cpu"])
    finally:
        monitoring.stop_exporter()
        os.environ.pop(bootstrap.ENV_RUNNING_REMOTELY, None)
    ts_posts = [body for method, url, body, _ in fake.calls
                if method == "POST"
                and url.endswith("/projects/fake-mon-proj/timeSeries")]
    types = {s["metric"]["type"] for body in ts_posts
             for s in body["timeSeries"]}
    assert "custom.googleapis.com/cloud_tpu/train/steps" in types
    assert "custom.googleapis.com/cloud_tpu/train/step_time_ms" in types
    described = {body["type"] for method, url, body, _ in fake.calls
                 if url.endswith("/projects/fake-mon-proj/metricDescriptors")}
    assert "custom.googleapis.com/cloud_tpu/train/steps" in described
