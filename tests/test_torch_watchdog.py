"""Fault injection and the dispatch watchdog of the port, on the CPU.

``cloud_tpu_torch/utils/faults.py`` is the port's copy of the reference's
chaos harness (plain Python): one script of plans (``nth``, ``every``,
``times``; raise, hang, corrupt; the env export) runs through both copies
with the same answers.

The watchdog (``dispatch_timeout_s``) follows the reference's cases
(``tests/unit/test_robustness.py``): a decode chunk hung past the budget
through the port's ``faults.inject`` fails its request with a typed
:class:`DispatchTimeoutError` inside the budget (at depth 1 and 2), the
engine reports unhealthy with the reason and ``watchdog_timeouts == 1``,
refuses new requests, and owns no thread after ``close()``; so does a hung
insert, and a hung batch decode on the batch scheduler.  Within the
budget, a watched engine serves as an unwatched one does.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from cloud_tpu.utils import faults as jax_faults
from cloud_tpu_torch.serving import (
    SERVE_SCHEDULER_THREAD_NAME,
    DispatchTimeoutError,
    EngineClosedError,
    ServeConfig,
    ServingEngine,
)
from cloud_tpu_torch.utils import faults
from helpers.torch_port import tie_free_rows, tiny_models

torch.set_num_threads(1)

THREAD_PREFIX = SERVE_SCHEDULER_THREAD_NAME.rsplit("-", 1)[0]


def _plans(mod, log):
    slept = []
    plan = [{"site": "a", "mode": "raise", "nth": 2},
            {"site": "b", "mode": "hang", "hang_s": 4.0, "every": 2,
             "times": 2},
            {"site": "c", "mode": "corrupt", "value": {"x": 1}},
            {"site": "d", "mode": "raise", "error": "transient"},
            {"site": "e", "mode": "raise", "error": "api", "nth": 1}]
    log.append(mod.fault_point("a", result=5))
    with mod.inject(plan) as active:
        log.append(json.loads(os.environ[mod.ENV_FAULT_PLAN]) == plan)
        for site in ("a", "a", "a", "b", "b", "b", "b", "b", "c", "d",
                     "e", "e"):
            try:
                log.append((site, mod.fault_point(site, result=site,
                                                  sleep=slept.append)))
            except Exception as exc:  # noqa: BLE001 — compared below
                log.append((site, type(exc).__name__, str(exc),
                            getattr(exc, "status", None)))
        log.append((active.fired(), active.calls()))
        with pytest.raises(RuntimeError, match="already active"):
            mod.inject([]).__enter__()
    log.append(slept)
    log.append(mod.ENV_FAULT_PLAN in os.environ)
    for bad in ([{"mode": "raise"}], [{"site": "x", "mode": "melt"}],
                [{"site": "x", "nth": 1, "every": 2}],
                [{"site": "x", "nth": 0}], [{"site": "x", "times": 0}],
                [{"site": "x", "when": 1}]):
        with pytest.raises(ValueError) as err:
            mod.FaultPlan(bad)
        log.append(str(err.value))
    os.environ[mod.ENV_FAULT_PLAN] = json.dumps([{"site": "z", "nth": 1}])
    try:
        log.append(mod.maybe_install_from_env())
        log.append(mod.active_plan().spec)
    finally:
        mod._clear_for_tests()
        del os.environ[mod.ENV_FAULT_PLAN]
    log.append(mod.maybe_install_from_env())


def test_fault_plan_copy_answers_as_the_reference():
    """Same triggers, firings, call counts, results, error classes (by
    name; the API classes by status) and validation messages."""
    got, want = [], []
    _plans(faults, got)
    _plans(jax_faults, want)
    rename = {"ApiTransientError": "InjectedTransientError",
              "ApiError": "InjectedApiError"}
    want = [(e[0], rename.get(e[1], e[1])) + e[2:]
            if isinstance(e, tuple) and len(e) == 4 else e for e in want]
    assert got == want
    assert issubclass(faults.InjectedTransientError, faults.FaultInjected)


def _threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(THREAD_PREFIX)]


@pytest.fixture(scope="module")
def model():
    return tiny_models(seed=0, num_layers=1)


def _watched(model, **kw):
    _, _, cfg, tparams = model
    serve = ServeConfig(**dict(dict(max_new_tokens=6, prompt_buckets=(8,),
                                    batch_buckets=(1, 2), chunk_tokens=2,
                                    dispatch_timeout_s=1.0, warmup=True),
                               **kw))
    engine = ServingEngine(tparams, cfg, serve, device="cpu")
    engine.wait_ready(timeout=300)
    return engine


@pytest.mark.parametrize("site,kw", [
    ("serve.chunk", dict()),
    ("serve.chunk", dict(pipeline_depth=2)),
    ("serve.prefill", dict()),
    ("serve.decode", dict(scheduler="batch", flush_deadline_s=0.0)),
], ids=["chunk-depth1", "chunk-depth2", "insert", "batch-decode"])
def test_hung_dispatch_fails_typed_and_marks_unhealthy(model, site, kw):
    """A dispatch hung 8 s against a 1 s budget: the request fails with
    ``DispatchTimeoutError`` within 6 s (the budget, with room for a loaded
    host, and well short of the hang), health() turns unhealthy with
    the reason, the timeout is counted once, new requests are refused,
    and close() leaves no engine thread."""
    prompt = np.asarray([5, 9, 17, 2], np.int32)
    engine = _watched(model, **kw)
    engine.submit(prompt).result(timeout=300)  # served inside the budget
    assert engine.health()["healthy"] is True
    plan = [{"site": site, "mode": "hang", "hang_s": 8.0, "nth": 1}]
    with faults.inject(plan, propagate=False):
        future = engine.submit(prompt)
        start = time.perf_counter()
        with pytest.raises(DispatchTimeoutError, match="dispatch_timeout_s"):
            future.result(timeout=30)
        assert time.perf_counter() - start < 6.0  # the budget, not the hang
        health = engine.health()
        # The scheduler fails the request, then closes the engine.
        deadline = time.monotonic() + 30
        while engine.health()["live"] and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(EngineClosedError):
            engine.submit(prompt)
        engine.close()
    assert health["healthy"] is False and health["ready"] is False
    assert "dispatch_timeout" in health["reason"]
    assert engine.stats()["watchdog_timeouts"] == 1
    assert engine.health()["orphaned_dispatches"] == 0
    assert _threads() == []


def test_watched_engine_serves_as_an_unwatched_one(model):
    """Within the budget the watchdog changes no token: JAX ``generate``'s
    rows at depth 1 and 2, and a dispatch thread per dispatch, gone after
    close()."""
    import jax.numpy as jnp

    from cloud_tpu.models import generation as jax_gen

    jax_cfg, params, _, _ = model
    prompts = tie_free_rows(jax_cfg, params, (3, 7, 5), 6, seed=41)
    batch = np.zeros((3, 7), np.int32)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    want = np.asarray(jax_gen.generate(
        params, jnp.asarray(batch), jnp.asarray([3, 7, 5]), jax_cfg,
        max_new_tokens=6)["tokens"])
    for depth in (1, 2):
        engine = _watched(model, pipeline_depth=depth, dispatch_timeout_s=60.0)
        futures = [engine.submit(p) for p in prompts]
        results = [f.result(timeout=300) for f in futures]
        engine.close()
        for row, res in zip(want, results):
            np.testing.assert_array_equal(res.tokens, row)
        assert engine.health()["healthy"]
        assert engine.stats()["watchdog_timeouts"] == 0
    assert _threads() == []
