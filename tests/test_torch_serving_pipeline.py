"""The port's pipelined scheduling (``pipeline_depth=2``) on the CPU, against
JAX ``generate``.

With a second chunk in flight while the host schedules, greedy outputs are
token-identical to ``pipeline_depth=1`` and to the JAX package's
``generate`` (TINY at one layer, f32, tie-free prompts) under slot churn
(staggered arrivals, per-request budgets, eos mid-chunk) and composed with
every serving feature on the decode path: prefix hits with chunked
prefill, kv_quant (held to JAX ``generate(kv_quant=True)``), speculation
and the paged route's block table; sampled requests served in turn draw
the same tokens at both depths.  Around that: the dispatch-gap stats,
one decode-chunk (or verify) signature per engine, deferred prefix
save-backs counted at depth 2 only, no pipeline spans at depth 1, and
close() with a chunk in flight, graceful or not, and a crash, leaving no
ring entry and no engine thread.  (The reference's ``CLOUD_TPU_PIPELINE=0``
kill switch has no counterpart: the port has none.)
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import generation as jax_gen
from cloud_tpu_torch.models import generation
from cloud_tpu_torch.monitoring import tracing
from cloud_tpu_torch.serving import (
    SERVE_SCHEDULER_THREAD_NAME,
    DraftConfig,
    EngineClosedError,
    ServeConfig,
    ServingEngine,
)
from cloud_tpu_torch.utils import faults
from helpers.torch_port import (
    TIE_GAP,
    greedy_gaps,
    tie_free_rows,
    tiny_models,
)

torch.set_num_threads(1)

#: The engine family's thread-name prefix (scheduler, warmup, dispatch).
THREAD_PREFIX = SERVE_SCHEDULER_THREAD_NAME.rsplit("-", 1)[0]

CHURN_LENS = (3, 8, 12, 5, 7, 2, 6, 4)
CHURN_BUDGETS = (5, 2, 4, 1, 6, 3, 5, 2)
MAX_NEW = 6


def _engine_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(THREAD_PREFIX)]


@pytest.fixture(scope="module")
def model():
    return tiny_models(seed=0, num_layers=1)


def _jax_tokens(model, prompts, budget, kv_quant=False):
    """JAX ``generate``'s greedy rows for ``prompts`` (one padded batch)."""
    jax_cfg, params, _, _ = model
    width = max(len(p) for p in prompts)
    batch = np.zeros((len(prompts), width), np.int32)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    lens = np.asarray([len(p) for p in prompts], np.int32)
    out = jax_gen.generate(params, jnp.asarray(batch), jnp.asarray(lens),
                           jax_cfg, max_new_tokens=budget, kv_quant=kv_quant)
    return np.asarray(out["tokens"])


def _run(model, serve, prompts, budgets, stagger=()):
    """Submit the workload (sleeping after the ``stagger`` indices),
    resolve everything, close; returns (results, engine)."""
    _, _, cfg, tparams = model
    engine = ServingEngine(tparams, cfg, serve, device="cpu")
    futures = []
    for i, prompt in enumerate(prompts):
        futures.append(engine.submit(prompt, max_new_tokens=budgets[i]))
        if i in stagger:
            time.sleep(0.05)  # arrivals land while earlier slots decode
    results = [f.result(timeout=240) for f in futures]
    engine.close()
    return results, engine


def _both_depths(model, prompts, budgets, stagger=(), **kw):
    """The same workload through a depth-1 and a depth-2 engine, their
    rows equal; returns both (results, engine) pairs."""
    base = dict(max_new_tokens=MAX_NEW, prompt_buckets=(8, 16),
                batch_buckets=(1, 2, 4), chunk_tokens=2)
    base.update(kw)
    r1, e1 = _run(model, ServeConfig(pipeline_depth=1, **base), prompts,
                  budgets, stagger)
    r2, e2 = _run(model, ServeConfig(pipeline_depth=2, **base), prompts,
                  budgets, stagger)
    for a, b in zip(r1, r2):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.num_generated == b.num_generated
    return (r1, e1), (r2, e2)


def _assert_generate(model, prompts, budgets, results, kv_quant=False):
    want = _jax_tokens(model, prompts, max(budgets), kv_quant=kv_quant)
    for i, (budget, res) in enumerate(zip(budgets, results)):
        np.testing.assert_array_equal(res.tokens, want[i, :budget])
        assert res.num_generated == budget


@pytest.mark.parametrize("kw", [dict(pipeline_depth=3),
                                dict(pipeline_depth=0),
                                dict(scheduler="batch", pipeline_depth=2)],
                         ids=["depth3", "depth0", "batch"])
def test_depth_must_be_1_or_2_on_the_continuous_scheduler(kw):
    with pytest.raises(ValueError, match="pipeline_depth"):
        ServeConfig(**kw)


def test_churn_parity_and_gap_stats(model):
    """Staggered arrivals and mixed budgets: depth 2 token-identical to
    depth 1 and to JAX ``generate``; the gap window filled on both arms;
    one decode-chunk signature each; the same useful tokens."""
    prompts = tie_free_rows(model[0], model[1], CHURN_LENS, MAX_NEW, seed=2)
    (r1, e1), (r2, e2) = _both_depths(model, prompts, CHURN_BUDGETS,
                                      stagger=(3, 6))
    _assert_generate(model, prompts, CHURN_BUDGETS, r2)
    assert e1.chunk_traces == 1 and e2.chunk_traces == 1
    for engine, depth in ((e1, 1), (e2, 2)):
        stats, health = engine.stats(), engine.health()
        assert health["pipeline_depth"] == stats["pipeline_depth"] == depth
        assert stats["dispatch_gap_ms_p50"] > 0.0
        assert stats["dispatch_gap_ms_p99"] >= stats["dispatch_gap_ms_p50"]
        assert health["dispatch_gap_ms"] > 0.0
        assert stats["completed"] == len(prompts)
        assert not engine._inflight
    assert (e2.stats()["useful_decode_tokens"]
            == e1.stats()["useful_decode_tokens"])


def test_eos_mid_chunk_parity(model):
    """An eos landing mid-chunk retires its slot one drain late at depth
    2; the chunk dispatched for it meanwhile emits only masked rows."""
    jax_cfg, params, _, _ = model
    lens = (4, 5, 9, 4)
    prompts = tie_free_rows(jax_cfg, params, lens, MAX_NEW, seed=5)
    greedy = _jax_tokens(model, prompts, MAX_NEW)
    # An eos the first row has not emitted before its third token.
    idx = next(i for i in range(1, MAX_NEW - 2)
               if greedy[0, i] not in greedy[0, :i])
    eos = int(greedy[0, idx])
    sample = generation.SampleConfig(temperature=0.0, eos_id=eos, pad_id=0)
    budgets = (6, 6, 3, 5)
    (r1, _), (r2, _) = _both_depths(model, prompts, budgets, sample=sample)
    want = jax_gen.generate(
        params, jnp.asarray(np.stack([np.pad(p, (0, 9 - len(p)))
                                      for p in prompts])),
        jnp.asarray(lens, np.int32), jax_cfg, max_new_tokens=MAX_NEW,
        sample=jax_gen.SampleConfig(temperature=0.0, eos_id=eos, pad_id=0))
    tokens, nums = np.asarray(want["tokens"]), np.asarray(
        want["num_generated"])
    assert r2[0].num_generated == idx + 1
    for i, (budget, res) in enumerate(zip(budgets, r2)):
        n = min(int(nums[i]), budget)
        assert res.num_generated == n
        np.testing.assert_array_equal(res.tokens[:n], tokens[i, :n])


def test_prefix_hit_and_chunked_prefill_parity(model):
    """Prefix cache and chunked prefill under the ring: parity with JAX
    ``generate``, the second shared-head request still hits, and its
    save-back, behind a long filler's chunk in flight, is counted at depth
    2 only.  (The filler's first 24 tokens are tie-free and held to JAX;
    all 100 equal between the depths.)"""
    jax_cfg, params, _, _ = model
    rng = np.random.default_rng(9)
    head = rng.integers(1, jax_cfg.vocab_size, 8)
    cands = np.concatenate([np.tile(head, (32, 1)), rng.integers(
        1, jax_cfg.vocab_size, (32, 2))], axis=1).astype(np.int32)
    lens = np.tile(np.asarray([9, 10], np.int32), 16)
    gaps, greedy = greedy_gaps(jax_cfg, params, cands, lens, 4)
    seed_row, hit_row = (next(i for i in range(32) if lens[i] == n
                              and gaps[i] > TIE_GAP) for n in (9, 10))
    seed_prompt = cands[seed_row, :9]
    hit = cands[hit_row, :10]
    filler = tie_free_rows(jax_cfg, params, (6,), 24, seed=19,
                           per_len=24)[0]
    want = [greedy[seed_row], greedy[hit_row],
            _jax_tokens(model, [filler], 24)[0]]

    def run(depth):
        serve = ServeConfig(
            max_new_tokens=100, prompt_buckets=(16,), batch_buckets=(1, 2, 4),
            chunk_tokens=2, prefix_cache_blocks=8, prefix_block_tokens=4,
            prefill_chunk_tokens=4, pipeline_depth=depth)
        _, _, cfg, tparams = model
        engine = ServingEngine(tparams, cfg, serve, device="cpu")
        outs = [engine.submit(seed_prompt, max_new_tokens=4).result(
            timeout=240)]
        # The hit arrives once the filler decodes: chunks are in flight
        # at depth 2 when the hit's prompt is saved.
        chunks = engine.stats()["chunks"]
        filler_future = engine.submit(filler, max_new_tokens=100)
        deadline = time.monotonic() + 60
        while (engine.stats()["chunks"] < chunks + 1
               and time.monotonic() < deadline):
            time.sleep(0.001)
        outs.append(engine.submit(hit, max_new_tokens=4).result(timeout=240))
        outs.append(filler_future.result(timeout=240))
        stats = engine.stats()
        engine.close()
        return outs, stats

    out1, stats1 = run(1)
    out2, stats2 = run(2)
    for a, b in zip(out1, out2):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for row, res in zip(want, out2):
        np.testing.assert_array_equal(res.tokens[:len(row)], row)
    for stats in (stats1, stats2):
        assert stats["prefix_hits"] >= 1
    assert stats1["prefix_deferred_saves"] == 0
    assert stats2["prefix_deferred_saves"] >= 1


def test_kv_quant_parity(model):
    """An int8 grid under the ring, held to JAX ``generate(kv_quant=True)``
    on prompts tie-free at 1e-2."""
    lens, budgets = (3, 8, 5), (4, 3, 5)
    prompts = tie_free_rows(model[0], model[1], lens, MAX_NEW, seed=3,
                            kv_quant=True)
    (_, _), (r2, e2) = _both_depths(model, prompts, budgets, kv_quant=True)
    assert e2._grid_cache["k"].dtype == torch.int8
    _assert_generate(model, prompts, budgets, r2, kv_quant=True)


def test_speculation_parity(model):
    """Draft-and-verify through the ring: verify rounds ride the same
    ring entries as decode chunks; one verify signature, no chunk one."""
    _, _, cfg, tparams = model
    lens, budgets = (3, 6, 5), (6, 4, 6)
    prompts = tie_free_rows(model[0], model[1], lens, MAX_NEW, seed=12)
    (_, e1), (r2, e2) = _both_depths(
        model, prompts, budgets,
        draft=DraftConfig(config=cfg, params=tparams, spec_k=2))
    _assert_generate(model, prompts, budgets, r2)
    assert e1.stats()["spec_chunks"] > 0 and e2.stats()["spec_chunks"] > 0
    assert e2.verify_traces == 1 and e2.chunk_traces == 0


def test_paged_kernel_parity(model):
    """The paged route's block table composes with the ring."""
    lens, budgets = (3, 5, 8), (4, 5, 3)
    prompts = tie_free_rows(model[0], model[1], lens, MAX_NEW, seed=4)
    (_, _), (r2, e2) = _both_depths(model, prompts, budgets,
                                    decode_kernel="pallas")
    _assert_generate(model, prompts, budgets, r2)
    assert e2.health()["decode_kernel"] == "pallas"


def test_sampled_requests_in_turn_match_across_depths(model):
    """Sampling (temperature 0.8, seed 7) draws from one generator in
    dispatch order: requests served one at a time (the same dispatch
    order at both depths) get the same tokens at depth 1 and 2."""
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 255, n).astype(np.int32) for n in (4, 9, 6)]
    sample = generation.SampleConfig(temperature=0.8, top_k=20)
    rows = {}
    for depth in (1, 2):
        _, _, cfg, tparams = model
        serve = ServeConfig(max_new_tokens=MAX_NEW, prompt_buckets=(16,),
                            batch_buckets=(1, 2), chunk_tokens=2, seed=7,
                            sample=sample, pipeline_depth=depth)
        with ServingEngine(tparams, cfg, serve, device="cpu") as engine:
            rows[depth] = [engine.submit(p).result(timeout=240).tokens
                           for p in prompts]
    for a, b in zip(rows[1], rows[2]):
        np.testing.assert_array_equal(a, b)


def test_depth1_emits_no_pipeline_spans(model):
    """Under a collector, depth 1 records no ``serve/host_bubble`` or
    ``serve/dispatch_gap`` span; depth 2 records both, and its
    ``serve/chunk`` spans (one a drained chunk)."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 255, n).astype(np.int32) for n in (3, 6)]
    names = {}
    for depth in (1, 2):
        serve = ServeConfig(max_new_tokens=MAX_NEW, prompt_buckets=(8,),
                            batch_buckets=(1, 2), chunk_tokens=2,
                            pipeline_depth=depth)
        with tracing.collecting() as collector:
            _, engine = _run(model, serve, prompts, (5, 4))
        names[depth] = [e["name"] for e in collector.events()]
        assert names[depth].count("serve/chunk") == engine.stats()["chunks"]
    assert "serve/host_bubble" not in names[1]
    assert "serve/dispatch_gap" not in names[1]
    assert "serve/host_bubble" in names[2]
    assert "serve/dispatch_gap" in names[2]


def test_graceful_close_drains_inflight_ring(model):
    """close(drain=True) while chunks are in flight: every future resolves
    with its full row, the ring is empty, no engine thread is left."""
    lens = (3, 5, 7)
    prompts = tie_free_rows(model[0], model[1], lens, 8, seed=6)
    _, _, cfg, tparams = model
    serve = ServeConfig(max_new_tokens=8, prompt_buckets=(8,),
                        batch_buckets=(1, 2), chunk_tokens=2,
                        pipeline_depth=2)
    engine = ServingEngine(tparams, cfg, serve, device="cpu")
    futures = [engine.submit(p) for p in prompts]
    engine.close()
    _assert_generate(model, prompts, (8, 8, 8),
                     [f.result(timeout=240) for f in futures])
    assert not engine._inflight
    assert not _engine_threads()


def test_abort_close_with_inflight_dispatch(model):
    """close(drain=False) mid-decode at depth 2: the ring is disposed,
    live requests fail typed, the scheduler thread is gone."""
    _, _, cfg, tparams = model
    serve = ServeConfig(max_new_tokens=112, prompt_buckets=(8,),
                        batch_buckets=(1, 2), chunk_tokens=1,
                        pipeline_depth=2)
    engine = ServingEngine(tparams, cfg, serve, device="cpu")
    rng = np.random.default_rng(7)
    futures = [engine.submit(rng.integers(1, 255, n).astype(np.int32))
               for n in (3, 5, 7)]
    # Decode under way (the ring very likely holds a chunk), far from done.
    deadline = time.monotonic() + 60
    while engine.stats()["chunks"] < 2 and time.monotonic() < deadline:
        time.sleep(0.001)
    engine.close(drain=False)
    for future in futures:
        with pytest.raises(EngineClosedError):
            future.result(timeout=60)
    assert not _engine_threads()
    assert not engine._inflight


def test_scheduler_crash_disposes_ring(model):
    """A fault at the second decode chunk at depth 2 takes the engine down
    the usual way: the request fails with it, the ring is disposed,
    health() is unhealthy, no thread is left."""
    _, _, cfg, tparams = model
    serve = ServeConfig(max_new_tokens=32, prompt_buckets=(8,),
                        batch_buckets=(1, 2), chunk_tokens=2,
                        pipeline_depth=2)
    engine = ServingEngine(tparams, cfg, serve, device="cpu")
    plan = [{"site": "serve.chunk", "mode": "raise", "nth": 2}]
    try:
        with faults.inject(plan, propagate=False) as active:
            future = engine.submit(np.asarray([5, 3, 1], np.int32))
            with pytest.raises(faults.FaultInjected):
                future.result(timeout=240)
            assert active.fired() == {"serve.chunk": 1}
        deadline = time.monotonic() + 30
        while _engine_threads() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not _engine_threads()
        assert not engine._inflight
        health = engine.health()
        assert health["healthy"] is False
        assert "FaultInjected" in health["reason"]
    finally:
        engine.close(drain=False)
