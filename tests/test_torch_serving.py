"""The port's continuous-batching engine on the CPU, against JAX ``generate``.

Two slots and mixed prompts and budgets force slot churn; every result
must be token-identical to the JAX package's greedy ``generate`` on the
same weights (TINY, f32, tie-free prompts).  Around that: eos retirement
with an eos id that cannot collide with an earlier greedy token, typed
admission errors, a clean close, and ``NotImplementedError`` for every
``ServeConfig`` feature the port does not have yet.  ``kv_quant`` with
int8 weights is held against the quantized JAX ``generate``.  The engine's
surface (``ServeConfig`` fields, constructor and ``submit`` keywords,
public methods) includes the JAX engine's; ``warmup`` changes no token.
"""

import dataclasses
import inspect
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import generation as jax_gen
from cloud_tpu.serving import ServeConfig as JaxServeConfig
from cloud_tpu.serving import ServingEngine as JaxServingEngine
from cloud_tpu_torch.models import generation, transformer
from cloud_tpu_torch.serving import (
    SERVE_SCHEDULER_THREAD_NAME,
    DeadlineExceededError,
    EngineClosedError,
    QueueFullError,
    ServeConfig,
    ServingEngine,
)
from helpers.torch_port import tie_free_prompts, tiny_models

torch.set_num_threads(2)

MAX_NEW = 8
BUDGETS = [8, 3, 5, 1, 8, 2]


@pytest.fixture(scope="module")
def models():
    return tiny_models(seed=1, num_layers=2)


@pytest.fixture(scope="module")
def prompts(models):
    jax_cfg, params, _, _ = models
    return tie_free_prompts(jax_cfg, params, batch=len(BUDGETS), max_len=14,
                            max_new_tokens=MAX_NEW, seed=200)


def _engine(tparams, cfg, **kw):
    serve = ServeConfig(max_new_tokens=MAX_NEW, prompt_buckets=(8, 16),
                        num_slots=2, chunk_tokens=3, **kw)
    return ServingEngine(tparams, cfg, serve, device="cpu")


def _scheduler_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(SERVE_SCHEDULER_THREAD_NAME)]


def test_churn_token_identical_to_jax_generate(models, prompts):
    _, _, cfg, tparams = models
    toks, lens, jax_tokens = prompts
    with _engine(tparams, cfg) as engine:
        futures = []
        for i, budget in enumerate(BUDGETS):
            futures.append(engine.submit(toks[i, :lens[i]],
                                         max_new_tokens=budget))
            if i == 2:
                time.sleep(0.05)  # staggered arrivals
        results = [f.result(timeout=120) for f in futures]
        stats = engine.stats()
    for i, (res, budget) in enumerate(zip(results, BUDGETS)):
        np.testing.assert_array_equal(res.tokens, jax_tokens[i, :budget])
        assert res.num_generated == budget
        assert res.bucket_len == (8 if lens[i] <= 8 else 16)
        assert res.batch_size == 2
    assert stats["inserts"] == stats["retires"] == stats["completed"] == 6
    assert stats["generated_tokens"] == sum(BUDGETS)
    assert stats["chunks"] >= 3 and 0 < stats["mean_slot_occupancy"] <= 1
    assert not _scheduler_threads()


def test_eos_retires_slot_early(models, prompts):
    jax_cfg, params, cfg, tparams = models
    toks, lens, jax_tokens = prompts
    # The first request whose greedy path brings a token it had not
    # emitted before: that token is the eos.
    r, idx = next((r, i) for r in range(4) for i in range(1, MAX_NEW)
                  if jax_tokens[r, i] not in jax_tokens[r, :i])
    eos = int(jax_tokens[r, idx])
    want = jax_gen.generate(
        params, jnp.asarray(toks), jnp.asarray(lens), jax_cfg,
        max_new_tokens=MAX_NEW,
        sample=jax_gen.SampleConfig(temperature=0.0, eos_id=eos))
    want_tokens = np.asarray(want["tokens"])
    want_num = np.asarray(want["num_generated"])
    sample = generation.SampleConfig(temperature=0.0, eos_id=eos)
    with _engine(tparams, cfg, sample=sample) as engine:
        futures = [engine.submit(toks[i, :lens[i]]) for i in range(4)]
        results = [f.result(timeout=120) for f in futures]
        stats = engine.stats()
    for i, res in enumerate(results):
        np.testing.assert_array_equal(res.tokens, want_tokens[i])
        assert res.num_generated == want_num[i]
    assert results[r].num_generated == idx + 1
    assert results[r].tokens[idx + 1:].tolist() == [0] * (MAX_NEW - idx - 1)
    assert stats["expired"] == sum(int(n) == MAX_NEW for n in want_num[:4])


def test_queue_full_and_closed_errors(models):
    _, _, cfg, tparams = models
    serve = ServeConfig(max_new_tokens=4, prompt_buckets=(8,), num_slots=1,
                        max_queue=2, admission="reject")
    engine = ServingEngine(tparams, cfg, serve, device="cpu", start=False)
    waiting = [engine.submit([1, 2, 3]) for _ in range(2)]
    with pytest.raises(QueueFullError):
        engine.submit([4, 5])
    assert engine.stats()["rejected"] == 1
    assert engine.health()["queue_depth"] == 2
    engine.close()
    for future in waiting:
        with pytest.raises(EngineClosedError):
            future.result(timeout=10)
    with pytest.raises(EngineClosedError):
        engine.submit([1])
    assert engine.stats()["failed"] == 2


def test_expired_deadline_is_shed_before_a_slot(models):
    _, _, cfg, tparams = models
    engine = ServingEngine(tparams, cfg, ServeConfig(
        max_new_tokens=2, prompt_buckets=(8,), num_slots=1),
        device="cpu", start=False)
    late = engine.submit([1, 2, 3], deadline_s=0.01)
    time.sleep(0.05)
    kept = engine.submit([4, 5, 6])
    engine.start()
    with pytest.raises(DeadlineExceededError):
        late.result(timeout=60)
    assert kept.result(timeout=60).num_generated == 2
    engine.close()
    assert engine.stats()["shed"] == 1


def test_close_without_drain_fails_in_flight(models, prompts):
    _, _, cfg, tparams = models
    toks, lens, _ = prompts
    engine = _engine(tparams, cfg)
    futures = [engine.submit(toks[i, :lens[i]]) for i in range(5)]
    engine.close(drain=False)
    health = engine.health()
    assert health["closed"] and not health["live"] and not health["ready"]
    for future in futures:
        assert future.done()
        if future.exception() is not None:
            assert isinstance(future.exception(), EngineClosedError)
    assert not _scheduler_threads()


def test_submit_validation(models):
    _, _, cfg, tparams = models
    engine = _engine(tparams, cfg)
    try:
        with pytest.raises(ValueError, match="prompt length"):
            engine.submit(list(range(1, 18)))
        with pytest.raises(ValueError, match="max_new_tokens"):
            engine.submit([1, 2], max_new_tokens=MAX_NEW + 1)
        with pytest.raises(ValueError, match="1-D"):
            engine.submit([[1, 2]])
    finally:
        engine.close()


@pytest.mark.parametrize("kw", [
    dict(scheduler="batch"),
    dict(prefix_cache_blocks=4),
    dict(prefix_cache_blocks=4, prefix_dram_blocks=4),
    dict(prefill_chunk_tokens=4),
    dict(draft=object()),
    dict(qos=object()),
    dict(mesh_shape=(2, 1)),
    dict(layout="auto"),
    dict(pipeline_depth=2),
    dict(role="decode"),
], ids=lambda kw: "-".join(kw))
def test_out_of_slice_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ServeConfig(**kw)


def test_int8_params_and_moe_raise(models):
    """An int8 leaf without its scale, or not int8, fails at construction
    (not in the scheduler thread); MoE layers are not ported."""
    _, _, cfg, tparams = models
    no_scale = dict(tparams, head={"kernel_q": torch.zeros(
        (cfg.dim, cfg.vocab_size), dtype=torch.int8)})
    not_int8 = dict(tparams, head={"kernel_q": torch.zeros(
        (cfg.dim, cfg.vocab_size)), "kernel_scale": torch.ones(
            (1, cfg.vocab_size))})
    for params in (no_scale, not_int8):
        with pytest.raises(ValueError, match="int8"):
            ServingEngine(params, cfg, ServeConfig(), device="cpu",
                          start=False)
    with pytest.raises(NotImplementedError, match="MoE"):
        ServingEngine(tparams, cfg.scaled(moe=object()), ServeConfig(),
                      device="cpu", start=False)


@pytest.fixture(scope="module")
def qmodels():
    return tiny_models(seed=4, num_layers=2, quantized=True)


def test_kv_quant_int8_weights_token_identical_to_jax(qmodels):
    """int8 weights served from an int8 grid: every request equals JAX's
    quantized ``generate`` (its oracle, as in the JAX engine's tests: the
    int8 cache rounds differently from the f32 one), under slot churn."""
    jax_cfg, params, cfg, tparams = qmodels
    toks, lens, jax_tokens = tie_free_prompts(
        jax_cfg, params, batch=4, max_len=14, max_new_tokens=MAX_NEW,
        seed=400, kv_quant=True)
    budgets = [MAX_NEW, 3, 6, MAX_NEW]
    with _engine(tparams, cfg, kv_quant=True) as engine:
        assert engine._grid_cache["k"].dtype == torch.int8
        assert "v_scale" in engine._grid_cache
        futures = [engine.submit(toks[i, :lens[i]], max_new_tokens=b)
                   for i, b in enumerate(budgets)]
        results = [f.result(timeout=120) for f in futures]
        stats = engine.stats()
    for i, (res, budget) in enumerate(zip(results, budgets)):
        np.testing.assert_array_equal(res.tokens, jax_tokens[i, :budget])
    assert stats["completed"] == 4
    want = jax_gen.generate(params, jnp.asarray(toks), jnp.asarray(lens),
                            jax_cfg, max_new_tokens=MAX_NEW, kv_quant=True)
    np.testing.assert_array_equal(np.asarray(want["tokens"]), jax_tokens)


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=0),
    dict(prompt_buckets=(16, 8)),
    dict(admission="drop"),
    dict(scheduler="fifo"),
    dict(num_slots=0),
    dict(chunk_tokens=0),
    dict(decode_kernel="cuda"),
    dict(pipeline_depth=3),
    dict(role="router"),
    dict(max_queue=0),
    dict(flush_deadline_s=-1.0),
    dict(dispatch_timeout_s=0.0),
    dict(prefix_summary_ttl_s=0.0),
    dict(hbm_bytes_per_chip=0),
], ids=lambda kw: "-".join(kw))
def test_validation_messages_match_jax(kw):
    with pytest.raises(ValueError) as want:
        JaxServeConfig(**kw)
    with pytest.raises(ValueError) as got:
        ServeConfig(**kw)
    assert str(got.value) == str(want.value)


def test_decode_kernel_settings_serve_identically(models, prompts):
    """Every decode_kernel value reads slot rows through the paged path."""
    _, _, cfg, tparams = models
    toks, lens, jax_tokens = prompts
    for kernel in ("auto", "pallas"):
        with _engine(tparams, cfg, decode_kernel=kernel) as engine:
            res = engine.submit(toks[1, :lens[1]]).result(timeout=120)
            assert engine.health()["decode_kernel"] == kernel
        np.testing.assert_array_equal(res.tokens, jax_tokens[1])


def test_default_device_is_cuda(models):
    _, _, cfg, tparams = models
    if torch.cuda.is_available():
        pytest.skip("this box has a card: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tparams, cfg, ServeConfig(), start=False)
    assert transformer.TINY.dtype == torch.bfloat16


def test_serve_config_fields_match_jax():
    """The same fields in the same order, so positional and keyword
    construction both carry over."""
    assert ([f.name for f in dataclasses.fields(ServeConfig)]
            == [f.name for f in dataclasses.fields(JaxServeConfig)])
    port, ref = ServeConfig(), JaxServeConfig()
    for name in ("flush_deadline_s", "warmup", "dispatch_timeout_s",
                 "hbm_bytes_per_chip", "prefix_summary_ttl_s"):
        assert getattr(port, name) == getattr(ref, name)


def _keywords(fn):
    return {name for name, p in inspect.signature(fn).parameters.items()
            if p.kind is inspect.Parameter.KEYWORD_ONLY}


def _public(cls):
    return {name for name, _ in inspect.getmembers(cls)
            if not name.startswith("_")}


def test_engine_surface_includes_jax():
    """Every keyword of the JAX engine's constructor and ``submit``, and
    every public method or property, exists in the port."""
    assert _keywords(JaxServingEngine.__init__) <= _keywords(
        ServingEngine.__init__)
    assert _keywords(JaxServingEngine.submit) <= _keywords(
        ServingEngine.submit)
    assert _public(JaxServingEngine) <= _public(ServingEngine)


def test_warmup_then_wait_ready_changes_no_token(models, prompts):
    """``warmup=True`` with ``mesh=None`` and ``wait_ready()``, as every
    serving probe of the bench builds its engine: the same tokens as
    without warmup and as JAX ``generate``."""
    _, _, cfg, tparams = models
    toks, lens, jax_tokens = prompts
    served = {}
    for warmup in (True, False):
        serve = ServeConfig(max_new_tokens=MAX_NEW, prompt_buckets=(8, 16),
                            num_slots=2, chunk_tokens=3, warmup=warmup)
        with ServingEngine(tparams, cfg, serve, mesh=None,
                           device="cpu") as engine:
            engine.wait_ready()
            if warmup:
                assert not engine._warmup_thread.is_alive()
            futures = [engine.submit(toks[i, :lens[i]]) for i in range(3)]
            served[warmup] = [f.result(timeout=120).tokens for f in futures]
            assert engine.stats()["inserts"] == 3
    for i in range(3):
        np.testing.assert_array_equal(served[True][i], jax_tokens[i])
        np.testing.assert_array_equal(served[False][i], served[True][i])
    assert not _scheduler_threads()


#: Each value of the JAX engine's surface whose feature the port lacks,
#: with the ROADMAP.md item its NotImplementedError names.
UNPORTED = {
    "ServeConfig-dispatch_timeout_s": (
        "4f", lambda e: ServeConfig(dispatch_timeout_s=1.0)),
    "ServeConfig-hbm_bytes_per_chip": (
        "6", lambda e: ServeConfig(hbm_bytes_per_chip=2**30)),
    "ServeConfig-prefix_summary_ttl_s": (
        "4a/5", lambda e: ServeConfig(prefix_summary_ttl_s=60.0)),
    "ServeConfig-flush_deadline_s-batch": (
        "4g", lambda e: ServeConfig(scheduler="batch", flush_deadline_s=0.5)),
    "engine-mesh": ("6", lambda e: ServingEngine(
        e.params, e.config, e.serve_config, mesh=object(), device="cpu",
        start=False)),
    "engine-rules": ("6", lambda e: ServingEngine(
        e.params, e.config, e.serve_config, rules=object(), device="cpu",
        start=False)),
    "submit-priority": ("4e", lambda e: e.submit([1, 2], priority="high")),
    "submit-stream": ("4e", lambda e: e.submit([1, 2], stream=True)),
    "submit-on_token": ("4e", lambda e: e.submit([1, 2], on_token=print)),
    "submit-trace": ("4e", lambda e: e.submit([1, 2], trace=object())),
    "submit-handoff_export": (
        "5", lambda e: e.submit([1, 2], handoff_export=True)),
    "submit-handoff": ("5", lambda e: e.submit([1, 2], handoff={})),
    "set_trace_lane": ("4e", lambda e: e.set_trace_lane(3)),
    "set_role": ("5", lambda e: e.set_role("decode")),
    "chunk_traces": ("4c/4e", lambda e: e.chunk_traces),
    "verify_traces": ("4c/4e", lambda e: e.verify_traces),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_values_name_their_item(models, case):
    _, _, cfg, tparams = models
    item, call = UNPORTED[case]
    engine = ServingEngine(tparams, cfg, ServeConfig(max_new_tokens=2,
                                                     prompt_buckets=(8,)),
                           device="cpu", start=False)
    try:
        with pytest.raises(NotImplementedError,
                           match=f"section A, item {item}$"):
            call(engine)
        # The defaults are accepted and change nothing.
        engine.set_trace_lane(None)
        engine.set_role("both")
        assert engine.stats()["requests"] == 0
    finally:
        engine.close()
