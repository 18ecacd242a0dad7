"""The port's tracing and metrics on the CPU, against the JAX package.

``cloud_tpu_torch/monitoring/{tracing,metrics}.py`` are the port's copies
of the reference's modules (plain Python).  One script of spans (nested,
recorded after the fact, failing, on a lane), trace contexts, timeline
dumps and merges, and counter, gauge and distribution records runs through
both copies: event names, attributes, nesting and lanes, aggregates and
registry snapshots must agree (timestamps and durations aside).

Then the engine: the same requests, one at a time, through the JAX engine
and the port's on each serving path (continuous at depth 1 and 2, prefix
cache with chunked prefill, speculation, the batch scheduler, QoS with
traced requests): the same ``serve/*`` spans, as many of each, and the
same ``serve/*`` counters.
"""

import collections
import json
import os
import time

import numpy as np
import pytest
import torch

from cloud_tpu.monitoring import metrics as jax_metrics
from cloud_tpu.monitoring import tracing as jax_tracing
from cloud_tpu.serving import DraftConfig as JaxDraftConfig
from cloud_tpu.serving import QosConfig as JaxQosConfig
from cloud_tpu.serving import ServeConfig as JaxServeConfig
from cloud_tpu.serving import ServingEngine as JaxServingEngine
from cloud_tpu_torch.monitoring import metrics as port_metrics
from cloud_tpu_torch.monitoring import tracing as port_tracing
from cloud_tpu_torch.serving import DraftConfig, QosConfig, ServeConfig
from cloud_tpu_torch.serving import ServingEngine
from helpers.torch_port import tiny_models

torch.set_num_threads(1)


def _strip(event):
    """An event without its clock readings."""
    return {k: v for k, v in event.items() if k not in ("ts", "dur")}


def _script(tracing, metrics, tmp_path, tag):
    """Spans, contexts, lanes, dumps and metrics through one module pair;
    returns what the test compares."""
    out = {}
    metrics.reset()
    out["off"] = (tracing.enabled(), tracing.new_trace_context(),
                  tracing.timeline_events(), tracing.aggregates())
    with tracing.span("noop") as noop:
        noop.set_attribute("k", 1)
    lane = tracing.register_lane("replica 0")
    with tracing.collecting() as collector:
        out["on"] = tracing.enabled()
        with tracing.span("outer", a=1) as outer:
            outer.set_attribute("b", "two")
            with tracing.span("inner"):
                out["current"] = tracing.current_span().name
            t0 = time.perf_counter()
            tracing.record_span("recorded", t0, t0 + 0.001, x="y")
        try:
            with tracing.span("failing", n=3):
                raise KeyError("boom")
        except KeyError:
            pass
        ctx = tracing.new_trace_context(parent_id=7)
        out["ctx"] = (ctx.parent_id, ctx.trace_id.split("-")[0])
        tracing.set_thread_lane(lane)
        with tracing.span("laned"):
            pass
        tracing.set_thread_lane(None)
        for _ in range(3):
            tracing.record_span("repeated", t0, t0)
        events = collector.events()
        out["events"] = [_strip(e) for e in events]
        for e in out["events"]:
            if e["pid"] == lane:
                e["pid"] = tracing.lane_label(lane).split()[0]
        out["aggregates"] = {k: v["count"] for k, v in
                             collector.aggregates().items()}
        out["module_aggregates"] = {k: v["count"] for k, v in
                                    tracing.aggregates().items()}
        out["timeline_events"] = len(tracing.timeline_events())
        path = tracing.dump_timeline(str(tmp_path / f"{tag}.json"))
        doc = json.load(open(path))
        out["dump"] = sorted(
            (e["ph"], e["name"], e.get("args", {}).get("name", ""))
            for e in doc["traceEvents"] if e["ph"] == "M")
        snap = collector.snapshot()
    merged = tracing.merge_timelines(
        [dict(snap, label="a"), dict(snap, label="b", pid=9,
                                     epoch=snap["epoch"] + 1.0)],
        str(tmp_path / f"{tag}-merged.json"))
    mdoc = json.load(open(merged))
    out["merged"] = [(e["ph"], e["name"], e["pid"]) for e in
                     mdoc["traceEvents"]]
    shifted = [e["ts"] for e in mdoc["traceEvents"] if e["ph"] == "X"]
    half = len(shifted) // 2
    out["shift"] = [round(b - a, 3) for a, b in zip(shifted[:half],
                                                     shifted[half:])]
    out["after"] = (tracing.enabled(), tracing.active() is None)
    metrics.counter_inc("c", 2)
    metrics.counter_inc("c")
    metrics.gauge_set("g", 1.5)
    metrics.gauge_set("inf", float("inf"))
    for value in (0.5, 1.0, 3.0, 1e9, float("inf"), float("nan")):
        metrics.distribution_record("d", value)
    rate = metrics.WindowedRate("rate", window=2)
    for now in (0.0, 1.0, 2.0, 3.0):
        rate.add(now, 1)
    rate.flush(5.0)
    snap = metrics.snapshot()
    spans = {k: v["count"] for k, v in snap["distributions"].items()
             if k.startswith("span/")}
    snap["distributions"] = {k: v for k, v in snap["distributions"].items()
                             if not k.startswith("span/")}
    out["metrics"] = (snap, spans)
    metrics.reset()
    out["reset"] = metrics.snapshot()
    return out


def test_tracing_and_metrics_copies_answer_as_the_reference(tmp_path):
    got = _script(port_tracing, port_metrics, tmp_path, "port")
    want = _script(jax_tracing, jax_metrics, tmp_path, "jax")
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key
    assert got["ctx"][1] == f"{os.getpid():x}"
    assert port_metrics.backend() == "python"


def test_tracing_copy_keeps_the_reference_surface():
    """Every name the port lists exists in the reference with the same
    signature; the profiler hooks are left out."""
    import inspect

    names = ("TraceContext", "new_trace_context", "register_lane",
             "set_thread_lane", "span", "record_span", "TimelineCollector",
             "collecting", "enable", "disable", "enabled",
             "timeline_events", "aggregates", "dump_timeline",
             "merge_timelines")
    for name in names:
        assert (str(inspect.signature(getattr(port_tracing, name)))
                == str(inspect.signature(getattr(jax_tracing, name)))), name
    assert not hasattr(port_tracing, "xprof_trace_started")
    for name in ("WindowedRate", "counter_inc", "gauge_set",
                 "distribution_record", "snapshot", "reset", "backend"):
        assert (str(inspect.signature(getattr(port_metrics, name)))
                == str(inspect.signature(getattr(jax_metrics, name)))), name


def test_enable_disable_and_spans_across_threads():
    """``enable`` is idempotent, ``disable`` drops the collector; a span
    finished on another thread lands in the same collector without a
    parent."""
    import threading

    port_tracing.disable()
    collector = port_tracing.enable()
    try:
        assert port_tracing.enable() is collector
        with port_tracing.span("main"):
            worker = threading.Thread(
                target=lambda: port_tracing.span("worker").__enter__()
                .__exit__(None, None, None))
            worker.start()
            worker.join(10)
        events = {e["name"]: e for e in collector.events()}
        assert events["worker"]["args"]["parent_id"] == 0
        assert events["worker"]["tid"] != events["main"]["tid"]
    finally:
        port_tracing.disable()
    assert not port_tracing.enabled()


# ---------------------------------------------------------------------------
# The engine's spans and counters, path by path.

MAX_NEW = 4

PATHS = {
    "continuous": dict(),
    "depth2": dict(pipeline_depth=2),
    "prefix_chunks": dict(prefix_cache_blocks=8, prefix_block_tokens=4,
                          prefill_chunk_tokens=4),
    "spec": dict(draft="self"),
    "batch": dict(scheduler="batch", flush_deadline_s=0.0),
    "qos_traced": dict(qos="default"),
}


@pytest.fixture(scope="module")
def model():
    return tiny_models(seed=0, num_layers=1)


def _prompts():
    rng = np.random.default_rng(4)
    head = rng.integers(1, 255, 8)
    return [np.concatenate([head, rng.integers(1, 255, n)]).astype(np.int32)
            for n in (1, 3, 2)]


def _serve(side, model, path):
    """The path's requests, one at a time, through one side's engine
    under a fresh collector and registry: (span counts, counters, trace
    ids of the results)."""
    jax_cfg, params, cfg, tparams = model
    kw = dict(PATHS[path], max_new_tokens=MAX_NEW, prompt_buckets=(16,),
              batch_buckets=(1, 2), chunk_tokens=2)
    if side == "jax":
        tracing, metrics = jax_tracing, jax_metrics
        serve_cls, draft_cls, qos_cls = (JaxServeConfig, JaxDraftConfig,
                                         JaxQosConfig)
        make = lambda serve: JaxServingEngine(params, jax_cfg, serve)  # noqa
        draft_model = (jax_cfg, params)
    else:
        tracing, metrics = port_tracing, port_metrics
        serve_cls, draft_cls, qos_cls = ServeConfig, DraftConfig, QosConfig
        make = lambda serve: ServingEngine(tparams, cfg, serve,  # noqa
                                           device="cpu")
        draft_model = (cfg, tparams)
    if kw.get("draft") == "self":
        kw["draft"] = draft_cls(config=draft_model[0],
                                params=draft_model[1], spec_k=2)
    if kw.get("qos") == "default":
        kw["qos"] = qos_cls()
    metrics.reset()
    ids = []
    with tracing.collecting() as collector:
        engine = make(serve_cls(**kw))
        for prompt in _prompts():
            trace = tracing.new_trace_context() if "qos" in kw else None
            res = engine.submit(prompt, trace=trace).result(timeout=300)
            ids.append(res.trace_id == (trace and trace.trace_id))
        engine.close()
        events = collector.events()
    spans = collections.Counter(e["name"] for e in events
                                if e["name"].startswith("serve/"))
    traced = sum(1 for e in events if "trace_id" in e["args"])
    counters = {k: v for k, v in metrics.snapshot()["counters"].items()
                if k.startswith("serve/")}
    metrics.reset()
    return spans, counters, ids, traced


@pytest.mark.parametrize("path", sorted(PATHS))
def test_engine_spans_and_counters_equal_the_jax_engine(model, path):
    got = _serve("port", model, path)
    want = _serve("jax", model, path)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2] and all(got[2])
    assert got[3] == want[3]
    assert got[0]["serve/chunk" if path not in ("spec", "batch")
                  else "serve/verify" if path == "spec"
                  else "serve/decode"] > 0
