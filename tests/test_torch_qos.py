"""The port's QoS and streaming on the CPU, against the JAX package.

``cloud_tpu_torch/serving/qos.py`` is the port's own copy of the
reference's policy module (plain Python): both copies run the same
scripted sequences (token buckets on an injected clock, admission picks
and fairness charges, brownout victims, token streams, the typed
validation) and must give the same answers and messages.

The engine cases follow the reference's (``tests/unit/test_qos.py``) on
TINY at one layer in f32 with tie-free prompts: an interactive request
jumps a queued batch flood, brownout sheds the batch class first and
typed, streamed tokens (continuous and batch scheduler, depth 1 and 2)
and ``on_token`` calls are the result's row and JAX ``generate``'s, a
stream fails typed with its future, priority tags are inert without QoS,
and ``health()`` reports the class backlog.
"""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from cloud_tpu.serving import ServeResult as JaxServeResult
from cloud_tpu.serving import qos as jax_qos
from cloud_tpu_torch.serving import (
    BrownoutShedError,
    EngineClosedError,
    PriorityClass,
    QosConfig,
    ServeConfig,
    ServeResult,
    ServingEngine,
    TokenStream,
)
from cloud_tpu_torch.serving import qos as port_qos
from helpers.torch_port import tie_free_rows, tiny_models

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# The policy: one script, both copies.


class _R:
    def __init__(self, priority, submitted):
        self.priority = priority
        self.submitted = submitted


def _buckets(mod, log):
    clock = {"t": 0.0}
    bucket = mod.TokenBucket(mod.TenantQuota(tokens_per_s=10.0,
                                             burst_tokens=30),
                             clock=lambda: clock["t"])
    log.append(bucket.try_acquire(30))
    log.append(bucket.try_acquire(1))
    clock["t"] = 2.0
    log.append(round(bucket.available(), 9))
    log.append(bucket.try_acquire(20))
    bucket.credit(7)
    log.append(round(bucket.available(), 9))
    clock["t"] = 100.0
    log.append(round(bucket.available(), 9))
    log.append(bucket.try_acquire(31))
    bucket.credit(100)
    log.append(round(bucket.available(), 9))


def _scheduler(mod, log):
    cfg = mod.QosConfig()
    sched = mod.QosScheduler(cfg)
    reqs = [_R("batch", 1.0), _R("interactive", 9.9), _R("standard", 5.0),
            _R("batch", 2.0), _R("interactive", 3.0), _R("standard", 8.0)]
    for now in (10.0, 10.0, 100.0, 100.0, 1000.0, 1000.0):
        best = sched.select(reqs, now)
        log.append((now, reqs.index(best), sched.key(best.priority,
                                                     best.submitted, now)))
        sched.charge(best.priority, cfg.request_cost(10, None))
        reqs.remove(best)
        log.append(sched.virtual_service())
    log.append(sched.select([], 5.0))
    inter = _R("interactive", 0.0)
    for _ in range(10):
        sched.select([inter], 100.0)
        sched.charge("interactive", 80)
    batch = _R("batch", 50.0)
    log.append(sched.select([inter, batch], 1000.0) is batch)
    log.append(sched.virtual_service())


def _victims(mod, log):
    reqs = [_R("interactive", 1.0), _R("batch", 2.0), _R("batch", 3.0),
            _R("standard", 4.0), _R("batch", 5.0)]
    for excess in (0, 2, 4, 5, 9):
        log.append([(v.priority, v.submitted) for v in
                    mod.brownout_victims(reqs, excess, mod.QosConfig())])
    custom = mod.QosConfig(classes={"a": mod.PriorityClass(weight=2.0),
                                    "b": mod.PriorityClass(weight=0.5)},
                           default_priority="a")
    log.append(custom.shed_order())
    log.append(mod.QosConfig().shed_order())
    log.append([mod.QosConfig(unbudgeted_decode_cost=64).request_cost(10, b)
                for b in (5, None)])
    log.append([mod.QosConfig().resolve_priority(p)
                for p in (None, "batch")])
    log.append([mod.validate_priority(p) for p in (None, "gold")])


def _stream(mod, log):
    stream = mod.TokenStream()
    for index, token in ((0, 5), (1, 7), (0, 5), (5, 99), (2, 9)):
        stream.feed(index, token)
    log.append(stream.tokens_so_far())
    future = Future()
    future.add_done_callback(stream._complete_from_future)
    future.set_result(JaxServeResult(
        tokens=np.asarray([5, 7, 9, 4], np.int32), num_generated=4,
        bucket_len=8, batch_size=1, latency_seconds=0.1))
    log.append((list(stream), stream.done(),
                stream.result(timeout=1).num_generated))
    failing = mod.TokenStream()
    failing.feed(0, 3)
    future = Future()
    future.add_done_callback(failing._complete_from_future)
    future.set_exception(mod.BrownoutShedError("shed"))
    seen = []
    try:
        for token in failing:
            seen.append(token)
    except mod.BrownoutShedError as exc:
        log.append((seen, str(exc)))


def _errors(mod, log):
    cases = [
        lambda: mod.PriorityClass(weight=0.0),
        lambda: mod.PriorityClass(slo_s=0.0),
        lambda: mod.TenantQuota(tokens_per_s=0.0, burst_tokens=10),
        lambda: mod.TenantQuota(tokens_per_s=1.0, burst_tokens=0),
        lambda: mod.QosConfig(classes={}),
        lambda: mod.QosConfig(default_priority="vip"),
        lambda: mod.QosConfig(brownout_queue_depth=0),
        lambda: mod.QosConfig(classes={"a": 1.0}),
        lambda: mod.QosConfig(quotas={"t": 5}),
        lambda: mod.QosConfig(unbudgeted_decode_cost=-1),
        lambda: mod.QosConfig().resolve_priority("vip"),
        lambda: mod.validate_priority(123),
    ]
    for case in cases:
        with pytest.raises(ValueError) as err:
            case()
        log.append(str(err.value))
    log.append([issubclass(c, RuntimeError) for c in (
        mod.QuotaExceededError, mod.BrownoutShedError)])


SCRIPTS = {"buckets": _buckets, "scheduler": _scheduler,
           "victims": _victims, "stream": _stream, "errors": _errors}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_policy_copy_answers_as_the_reference(name):
    got, want = [], []
    SCRIPTS[name](port_qos, got)
    SCRIPTS[name](jax_qos, want)
    assert got == want
    assert len(got) > 1


def test_policy_copy_keeps_the_reference_surface():
    """The same public names and constants, and the same signatures."""
    import inspect

    names = {n for n in dir(jax_qos) if not n.startswith("_")
             and getattr(getattr(jax_qos, n), "__module__", "")
             == jax_qos.__name__}
    assert names and names <= set(dir(port_qos))
    assert port_qos.DEFAULT_PRIORITIES == jax_qos.DEFAULT_PRIORITIES
    for name in names:
        ref = getattr(jax_qos, name)
        if inspect.isfunction(ref) or (inspect.isclass(ref) and not
                                       issubclass(ref, BaseException)):
            assert (str(inspect.signature(getattr(port_qos, name)))
                    == str(inspect.signature(ref))), name


# ---------------------------------------------------------------------------
# The engine.


@pytest.fixture(scope="module")
def model():
    return tiny_models(seed=0, num_layers=1)


def _engine(model, start=True, **kw):
    _, _, cfg, tparams = model
    return ServingEngine(tparams, cfg, ServeConfig(**kw), device="cpu",
                         start=start)


def _want(model, prompts, budget):
    """JAX ``generate``'s rows (one padded batch)."""
    import jax.numpy as jnp

    from cloud_tpu.models import generation as jax_gen

    jax_cfg, params, _, _ = model
    width = max(len(p) for p in prompts)
    batch = np.zeros((len(prompts), width), np.int32)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    out = jax_gen.generate(params, jnp.asarray(batch),
                           jnp.asarray([len(p) for p in prompts]), jax_cfg,
                           max_new_tokens=budget)
    return np.asarray(out["tokens"])


def test_interactive_jumps_the_queue_with_parity(model):
    """One slot, a queued batch flood, a later interactive arrival: with
    QoS the interactive request completes first, and every row equals
    JAX ``generate``."""
    prompts = tie_free_rows(model[0], model[1], (4, 4, 4, 4), 4, seed=0)
    engine = _engine(model, start=False, max_new_tokens=4,
                     prompt_buckets=(8,), batch_buckets=(1,), num_slots=1,
                     chunk_tokens=2, qos=QosConfig())
    order = []
    futures = []
    for i, prompt in enumerate(prompts[:3]):
        future = engine.submit(prompt, priority="batch")
        future.add_done_callback(lambda _f, i=i: order.append(f"batch{i}"))
        futures.append(future)
    inter = engine.submit(prompts[3], priority="interactive")
    inter.add_done_callback(lambda _f: order.append("interactive"))
    futures.append(inter)
    engine.start()
    results = [f.result(timeout=120) for f in futures]
    engine.close()
    assert order[0] == "interactive", order
    want = _want(model, prompts, 4)
    for row, res in zip(want, results):
        np.testing.assert_array_equal(res.tokens, row)
    stats = engine.stats()
    assert stats["class_completed"] == {"interactive": 1, "standard": 0,
                                        "batch": 3}
    assert stats["brownout_shed"] == 0


def test_brownout_sheds_batch_first_typed(model):
    """Six queued past a brownout depth of 2: four batch requests shed,
    typed, every interactive one served."""
    rng = np.random.default_rng(1)
    engine = _engine(model, start=False, max_new_tokens=2,
                     prompt_buckets=(8,), batch_buckets=(1,), num_slots=1,
                     chunk_tokens=1, qos=QosConfig(brownout_queue_depth=2))
    batch = [engine.submit(rng.integers(1, 255, 4).astype(np.int32),
                           priority="batch") for _ in range(4)]
    inter = [engine.submit(rng.integers(1, 255, 4).astype(np.int32),
                           priority="interactive") for _ in range(2)]
    engine.start()
    for future in inter:
        future.result(timeout=120)
    shed = 0
    for future in batch:
        try:
            future.result(timeout=120)
        except BrownoutShedError as exc:
            assert "brownout" in str(exc)
            shed += 1
    engine.close()
    assert shed == 4
    stats = engine.stats()
    assert stats["brownout_shed"] == stats["shed"] == 4
    assert stats["class_shed"] == {"interactive": 0, "standard": 0,
                                   "batch": 4}


@pytest.mark.parametrize("depth", [1, 2])
def test_streaming_identity_continuous(model, depth):
    """``stream=True`` yields exactly the result's row (and JAX
    ``generate``'s); ``on_token`` sees the same tokens in order; the
    stream's result is the future's."""
    prompt = tie_free_rows(model[0], model[1], (5,), 6, seed=31)[0]
    seen = []
    with _engine(model, max_new_tokens=6, prompt_buckets=(8,),
                 batch_buckets=(1,), num_slots=2, chunk_tokens=2,
                 pipeline_depth=depth) as engine:
        stream = engine.submit(prompt, stream=True)
        assert isinstance(stream, TokenStream)
        streamed = list(stream)
        result = stream.result(timeout=120)
        hooked = engine.submit(prompt, on_token=lambda i, t: seen.append(
            (i, t))).result(timeout=120)
        plain = engine.submit(prompt).result(timeout=120)
    want = _want(model, [prompt], 6)[0]
    assert isinstance(result, ServeResult)
    assert streamed == list(result.tokens[:result.num_generated])
    assert seen == list(enumerate(hooked.tokens[:hooked.num_generated]))
    for res in (result, hooked, plain):
        np.testing.assert_array_equal(res.tokens, want)


def test_streaming_identity_batch_scheduler(model):
    """The batch scheduler delivers a stream at completion: the same row."""
    prompt = tie_free_rows(model[0], model[1], (3,), 4, seed=32)[0]
    with _engine(model, max_new_tokens=4, prompt_buckets=(8,),
                 batch_buckets=(1,), flush_deadline_s=0.0,
                 scheduler="batch") as engine:
        stream = engine.submit(prompt, stream=True)
        streamed = list(stream)
        result = stream.result(timeout=120)
    assert streamed == list(result.tokens[:result.num_generated])
    np.testing.assert_array_equal(result.tokens, _want(model, [prompt], 4)[0])


def test_stream_failure_closes_typed(model):
    engine = _engine(model, start=False, max_new_tokens=2,
                     prompt_buckets=(8,), batch_buckets=(1,))
    stream = engine.submit(np.asarray([1, 2], np.int32), stream=True)
    engine.close(drain=False)
    with pytest.raises(EngineClosedError):
        list(stream)


def test_failing_hook_is_dropped_not_fatal(model):
    """An ``on_token`` hook that raises is logged and dropped: its
    request and the engine serve on."""
    calls = []

    def hook(index, token):
        calls.append(index)
        raise RuntimeError("consumer bug")

    with _engine(model, max_new_tokens=4, prompt_buckets=(8,),
                 batch_buckets=(1,), chunk_tokens=1) as engine:
        res = engine.submit(np.asarray([3, 1, 4], np.int32),
                            on_token=hook).result(timeout=120)
        assert engine.health()["healthy"]
    assert calls == [0] and res.num_generated == 4


def test_priority_tag_inert_without_qos(model):
    """Without QoS a tag is type-checked only: any class name passes, and
    the per-class counters stay zero."""
    engine = _engine(model, start=False, max_new_tokens=2,
                     prompt_buckets=(8,), batch_buckets=(1,))
    with pytest.raises(ValueError, match="class name"):
        engine.submit(np.asarray([1], np.int32), priority=7)
    engine.submit(np.asarray([1], np.int32), priority="gold")
    future = engine.submit(np.asarray([1, 2], np.int32),
                           priority="interactive")
    assert engine.health()["class_backlog"] == {
        "interactive": 0, "standard": 0, "batch": 0}
    engine.start()
    future.result(timeout=120)
    engine.close()
    assert engine.stats()["class_completed"] == {
        "interactive": 0, "standard": 0, "batch": 0}


def test_qos_health_reports_class_backlog(model):
    engine = _engine(model, start=False, max_new_tokens=2,
                     prompt_buckets=(8,), batch_buckets=(1,),
                     qos=QosConfig())
    engine.submit(np.asarray([1, 2], np.int32), priority="batch")
    engine.submit(np.asarray([3], np.int32), priority="batch")
    engine.submit(np.asarray([4], np.int32))  # default: standard
    health = engine.health()
    engine.close(drain=False)
    assert health["class_backlog"] == {"interactive": 0, "standard": 1,
                                       "batch": 2}
    with pytest.raises(ValueError, match="unknown priority"):
        _engine(model, start=False, qos=QosConfig()).submit(
            [1], priority="gold")


def test_custom_classes_order_admission(model):
    """A custom class map: its names are the only valid tags, and the
    tighter SLO is admitted first from a queue of both."""
    custom = QosConfig(classes={"gold": PriorityClass(weight=4.0, slo_s=0.5),
                                "bronze": PriorityClass(weight=1.0,
                                                        slo_s=10.0)},
                       default_priority="bronze")
    engine = _engine(model, start=False, max_new_tokens=2,
                     prompt_buckets=(8,), batch_buckets=(1,), num_slots=1,
                     qos=custom)
    order = []
    lock = threading.Lock()
    for name in ("bronze", "bronze", "gold"):
        engine.submit(np.asarray([5, 6], np.int32), priority=name
                      ).add_done_callback(
            lambda _f, n=name: (lock.acquire(), order.append(n),
                                lock.release()))
    time.sleep(0.01)
    engine.start()
    engine.close()
    assert order[0] == "gold"
    assert engine.stats()["class_completed"] == {"gold": 1, "bronze": 2}
