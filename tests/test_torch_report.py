"""The port's timeline report (``cloud_tpu_torch/monitoring/report.py``, a
copy of the JAX package's) against the reference, on the CPU.

One synthetic timeline (fleet routing with a failover and a handoff,
engine spans of every serving phase, QoS ``serve/request`` terminals,
retries, sheds and scale events, each request stamped with a
``trace_id``) goes through both ``TraceReport`` copies: the per-request
stitching, the TTFT decomposition, every section summary, the rendered
report (its fleet section included), one request's drill-down and the
CLI's output must be equal.  A timeline the port's own tracing wrote
(a port fleet over fake engines) reads the same through both.
"""

import json

import numpy as np
import pytest

from cloud_tpu.monitoring import report as jax_report
from cloud_tpu_torch.monitoring import report as port_report
from cloud_tpu_torch.monitoring import tracing

REPORTS = (jax_report, port_report)


def _span(name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "pid": pid,
            "tid": tid, "args": args}


def synthetic_timeline():
    """Three traced requests through a two-replica fleet: ``t-a``
    colocated with a swap-in, ``t-b`` failed over once, ``t-c`` handed
    off from a prefill replica to a decode replica; plus a shed request,
    retries, scale events and shared decode chunks."""
    ev = []
    ev.append(_span("fleet/route", 0, 40, trace_id="t-a", replica=0, load=1,
                    attempt=1, occupancy=0.25, queue_s=0.002,
                    priority="interactive", cached_tokens=32))
    ev.append(_span("serve/queue_wait", 50, 300, pid=11, trace_id="t-a",
                    bucket=32, slot=0))
    ev.append(_span("serve/prefix_lookup", 360, 20, pid=11, trace_id="t-a",
                    hit=True, hit_tokens=16, dram=True))
    ev.append(_span("serve/prefix_swapin", 380, 120, pid=11, trace_id="t-a",
                    blocks=1, tokens=16))
    ev.append(_span("serve/prefill_chunk", 500, 900, pid=11, trace_id="t-a",
                    start=16, tokens=8))
    ev.append(_span("serve/prefill_finalize", 1400, 100, pid=11,
                    trace_id="t-a", slot=0))
    ev.append(_span("fleet/failover", 100, 0, trace_id="t-b", replica=0,
                    error="QueueFullError", attempt=0))
    ev.append(_span("retry/fleet.route", 90, 70, attempts=2, outcome="ok"))
    ev.append(_span("fleet/route", 110, 60, trace_id="t-b", replica=1,
                    load=0, attempt=1, occupancy=0.0, queue_s=0.004,
                    priority="batch"))
    ev.append(_span("serve/queue_wait", 200, 150, pid=12, trace_id="t-b"))
    ev.append(_span("serve/prefill", 400, 1200, pid=12, trace_id="t-b",
                    bucket=64, slot=1))
    ev.append(_span("fleet/route", 300, 30, trace_id="t-c", replica=0,
                    load=2, attempt=1, occupancy=0.5, queue_s=0.001,
                    leg="prefill"))
    ev.append(_span("serve/prefill_chunk", 400, 800, pid=11, trace_id="t-c",
                    start=0, tokens=32))
    ev.append(_span("serve/kv_handoff", 1250, 150, pid=11, trace_id="t-c",
                    direction="export", slot=1, blocks=4))
    ev.append(_span("serve/request", 300, 1200, pid=11, trace_id="t-c",
                    ttft_s=0.0011, tokens=1))
    ev.append(_span("fleet/handoff", 1520, 30, trace_id="t-c", replica=0,
                    blocks=4))
    ev.append(_span("fleet/route", 1560, 20, trace_id="t-c", replica=1,
                    load=1, attempt=2, occupancy=0.5, leg="decode"))
    ev.append(_span("serve/kv_handoff", 1600, 200, pid=12, trace_id="t-c",
                    direction="import", blocks=4, seeded=4, uploaded=3))
    ev.append(_span("serve/prefill_chunk", 1800, 300, pid=12,
                    trace_id="t-c", start=28, tokens=4))
    for i, ts in enumerate((1600, 1900, 2200, 2500)):
        ev.append(_span("serve/chunk", ts, 250, pid=11 + i % 2, active=2,
                        num_slots=4, emitted=6, occupancy=0.5,
                        traces={"0": "t-a", "1": "t-b" if i % 2 else "t-c"}))
    ev.append(_span("serve/request", 50, 2700, pid=11, trace_id="t-a",
                    ttft_s=0.0015, tokens=12, priority="interactive"))
    ev.append(_span("serve/request", 200, 2600, pid=12, trace_id="t-b",
                    ttft_s=0.0014, tokens=9, priority="batch"))
    ev.append(_span("serve/request", 1600, 1300, pid=12, trace_id="t-c",
                    ttft_s=0.0006, tokens=8))
    ev.append(_span("fleet/shed", 0, 500, reason="deadline", trace_id="t-d"))
    ev.append(_span("serve/shed", 10, 400, pid=12, bucket=32))
    ev.append(_span("fleet/restart", 2000, 300, replica=1,
                    reason="watchdog"))
    ev.append(_span("fleet/scale", 2400, 10, direction="up", replicas=3))
    ev.append(_span("fleet/scale", 2900, 10, direction="down", replicas=2))
    ev.append(_span("fault/serve.chunk", 2950, 0))
    return ev


@pytest.fixture(scope="module")
def reports():
    events = synthetic_timeline()
    return [mod.TraceReport(json.loads(json.dumps(events)))
            for mod in REPORTS]


SUMMARIES = ("request_summary", "ttft_decomposition", "fleet_summary",
             "qos_summary", "robustness_summary", "continuous_summary",
             "prefix_summary", "spec_summary", "rows", "serving_rows",
             "render")


@pytest.mark.parametrize("method", SUMMARIES)
def test_summaries_equal_the_reference(reports, method):
    want, got = (getattr(r, method)() for r in reports)
    assert got == want
    if method in ("request_summary", "ttft_decomposition", "fleet_summary",
                  "render"):
        assert got


def test_stitching_and_decomposition_read_the_handoff(reports):
    summary = reports[1].request_summary()
    assert sorted(summary) == ["t-a", "t-b", "t-c", "t-d"]
    assert summary["t-b"]["failovers"] == 1
    assert [tid for tid, row in sorted(summary.items())
            if row["complete"]] == ["t-a", "t-b", "t-c"]
    decomposition = reports[1].ttft_decomposition()
    assert decomposition["requests"] == 3
    assert decomposition["shares"]["handoff"]["p99"] > 0
    assert tuple(decomposition["shares"]) == (
        jax_report.TraceReport.TTFT_COMPONENTS)
    rendered = reports[1].render()
    assert "fleet (routing, supervision, scaling):" in rendered


@pytest.mark.parametrize("trace_id", ["t-a", "t-b", "t-c", "t-missing"])
def test_drill_down_equals_the_reference(reports, trace_id):
    want, got = (r.render_trace(trace_id) for r in reports)
    assert got == want
    assert (got is None) == (trace_id == "t-missing")


@pytest.mark.parametrize("argv", [[], ["--trace", "t-c"],
                                  ["--trace", "t-missing"]])
def test_cli_equals_the_reference(tmp_path, capsys, argv):
    path = tmp_path / "timeline.json"
    path.write_text(json.dumps({"traceEvents": synthetic_timeline()}))
    outputs = []
    for mod in REPORTS:
        rc = mod.main([str(path)] + argv)
        outputs.append((rc, capsys.readouterr().out))
    assert outputs[1] == outputs[0]
    assert outputs[1][0] == (2 if "t-missing" in argv else 0)


def test_a_port_fleet_timeline_reads_the_same(tmp_path):
    """A timeline the port's tracing wrote, through a port fleet, reads
    the same through both reports."""
    from test_torch_fleet import Factory, TracedFakeEngine, quiet_config
    from cloud_tpu_torch.fleet import Fleet

    full = TracedFakeEngine("full", max_queue=0)
    ok = TracedFakeEngine("ok")
    path = str(tmp_path / "fleet.json")
    with tracing.collecting():
        fleet = Fleet(Factory([full, ok]), quiet_config(min_replicas=2))
        try:
            for i in range(3):
                fleet.submit(np.asarray([1, 2, i], np.int32)).result(30)
            fleet.dump_timeline(path)
        finally:
            fleet.close()
    want, got = (mod.TraceReport.from_file(path) for mod in REPORTS)
    for method in ("request_summary", "ttft_decomposition", "fleet_summary",
                   "render"):
        assert getattr(got, method)() == getattr(want, method)()
    assert len(got.request_summary()) == 3
