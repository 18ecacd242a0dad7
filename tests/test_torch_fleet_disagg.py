"""Disaggregated prefill/decode serving in the port, on the CPU, against JAX.

* **The handoff payload.**  The port's engine and the JAX engine export
  the same prompt on the same weights (``submit(handoff_export=True)``):
  the same schema, keys and covered tokens, and KV rows equal at 1e-5
  (f32).  The port's payload, and the JAX engine's, imported into a fresh
  port engine (``submit(handoff=...)``) decode token-identical to JAX
  ``generate()``, through an ordinary prefix hit.
* **The engine's surface**: ``role``/``set_role`` and the handoff keywords
  validated as the JAX engine validates them; malformed payloads import
  less and never fail; the batched block gather and scatter the handoff
  uses equal the JAX package's.
* **The two-leg route over fakes**: prefill-only replicas serve one token
  and export, the payload crosses the shared host pool (deduplicated by
  chain key), the decode leg lands on a decode-capable replica, a dead
  decode leg re-prefills, a roleless fleet builds no handoff leg.
* **A live 1-prefill/2-decode port fleet** on the reference's weights and
  prompts (``default_rng(11)``, tie-free): token-identical to JAX
  ``generate()``, every request handed off once, the shared head
  deduplicated, roles in ``health()``, no thread left.
"""

import threading
import time
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import generation as jax_gen
from cloud_tpu.serving import ServeConfig as JaxServeConfig
from cloud_tpu.serving import ServingEngine as JaxServingEngine
from cloud_tpu_torch.fleet import Fleet, FleetConfig, disagg
from cloud_tpu_torch.models import generation
from cloud_tpu_torch.serving import (
    EngineClosedError,
    QueueFullError,
    ServeConfig,
    ServeResult,
    ServingEngine,
)
from helpers.torch_port import tiny_models
from test_torch_fleet import FakeEngine, Factory, fleet_threads, quiet_config

torch.set_num_threads(1)

BLOCK_TOKENS = 4
SERVE = dict(max_new_tokens=8, prompt_buckets=(8, 32), batch_buckets=(1, 2),
             chunk_tokens=4, prefix_cache_blocks=16,
             prefix_block_tokens=BLOCK_TOKENS)
PROMPT = np.asarray([5, 9, 17, 33, 2, 8, 13, 21, 34, 55, 89, 144, 233],
                    np.int32)


@pytest.fixture(scope="module")
def model():
    return tiny_models(0)


def jax_tokens(model, prompts, budget):
    """JAX ``generate()``'s greedy tokens for each prompt (one batch)."""
    jax_cfg, jparams, _, _ = model
    lens = [len(p) for p in prompts]
    batch = np.zeros((len(prompts), max(lens)), np.int32)
    for i, prompt in enumerate(prompts):
        batch[i, :len(prompt)] = prompt
    return np.asarray(jax_gen.generate(
        jparams, jnp.asarray(batch), jnp.asarray(lens, np.int32), jax_cfg,
        max_new_tokens=budget)["tokens"])


def port_engine(model, **overrides):
    _, _, cfg, params = model
    return ServingEngine(params, cfg, ServeConfig(**dict(SERVE, **overrides)),
                         device="cpu")


# ---------------------------------------------------------------------------
# The handoff payload against the JAX engine's.


@pytest.fixture(scope="module")
def exports(model):
    jax_cfg, jparams, _, _ = model
    payloads = {}
    engine = JaxServingEngine(jparams, jax_cfg, JaxServeConfig(**SERVE),
                              mesh=None)
    try:
        engine.set_role("prefill")
        payloads["jax"] = engine.submit(
            PROMPT, max_new_tokens=1, handoff_export=True).result(240).handoff
        jax_stats = engine.stats()
    finally:
        engine.close()
    engine = port_engine(model, role="prefill")
    try:
        result = engine.submit(PROMPT, max_new_tokens=1,
                               handoff_export=True).result(120)
        payloads["port"] = result.handoff
        port_stats, port_health = engine.stats(), engine.health()
    finally:
        engine.close()
    return payloads, jax_stats, port_stats, port_health


def test_payload_matches_the_jax_engine(exports):
    payloads, jax_stats, port_stats, port_health = exports
    want, got = payloads["jax"], payloads["port"]
    assert sorted(got) == sorted(want)
    for key in ("version", "block_tokens", "covered_tokens"):
        assert got[key] == want[key], key
    # 13 tokens in blocks of 4: 3 full blocks (the tail is never cached).
    assert got["covered_tokens"] == 12
    assert [tuple(k) for k in got["keys"]] == [tuple(k) for k in want["keys"]]
    assert len(got["payloads"]) == len(want["payloads"]) == 3
    for block_got, block_want in zip(got["payloads"], want["payloads"]):
        assert sorted(block_got) == sorted(block_want)
        for name in block_want:
            assert isinstance(block_got[name], torch.Tensor)
            assert block_got[name].device.type == "cpu"
            np.testing.assert_allclose(block_got[name].numpy(),
                                       np.asarray(block_want[name]),
                                       atol=1e-5, rtol=0)
    # One host copy per block, not views into one stacked gather.
    first = got["payloads"][0]["k"]
    assert first.untyped_storage().nbytes() == first.numel() * 4
    for key in ("handoff_exports", "handoff_export_blocks", "role"):
        assert port_stats[key] == jax_stats[key], key
    assert port_health["role"] == "prefill"
    assert port_health["handoff_exports"] == 1
    assert port_health["slice_shape"] == (1, 1)
    assert port_health["slice_chips"] == 1


@pytest.mark.parametrize("source", ["port", "jax"])
def test_import_decodes_token_identical_to_generate(model, exports, source):
    payloads = exports[0]
    want = jax_tokens(model, [PROMPT], 8)[0]
    engine = port_engine(model)
    try:
        engine.set_role("decode")
        result = engine.submit(PROMPT, max_new_tokens=8,
                               handoff=payloads[source]).result(120)
        stats, health = engine.stats(), engine.health()
    finally:
        engine.close()
    np.testing.assert_array_equal(result.tokens, want)
    assert result.handoff is None
    assert stats["prefix_hits"] == 1 and stats["prefix_misses"] == 0
    assert stats["handoff_imports"] == 1
    assert stats["handoff_import_blocks"] == 3
    assert health["role"] == "decode" and health["handoff_imports"] == 1


def test_attach_route_and_repeat_import_dedups(model, exports):
    """On the attach route the imported blocks are read in place; a
    second import of the same chain uploads nothing."""
    payload = exports[0]["port"]
    want = jax_tokens(model, [PROMPT], 8)[0]
    engine = port_engine(model, decode_kernel="pallas", role="decode")
    try:
        first = engine.submit(PROMPT, max_new_tokens=8,
                              handoff=payload).result(120)
        with_blocks = engine.stats()["prefix_cache_blocks"]
        again = engine.submit(PROMPT, max_new_tokens=8,
                              handoff=payload).result(120)
        stats = engine.stats()
    finally:
        engine.close()
    np.testing.assert_array_equal(first.tokens, want)
    np.testing.assert_array_equal(again.tokens, want)
    assert stats["prefix_attaches"] == 2
    assert stats["handoff_imports"] == 2
    assert stats["prefix_cache_blocks"] == with_blocks


def test_malformed_payloads_import_less_never_fail(model):
    prompt = PROMPT[:7]
    want = jax_tokens(model, [prompt], 6)[0]
    engine = port_engine(model)
    try:
        wrong = {"version": 1, "block_tokens": 8, "covered_tokens": 16,
                 "keys": [tuple(range(8)), tuple(range(8, 16))],
                 "payloads": [{"k": torch.zeros(2)}, {"k": torch.zeros(2)}]}
        result = engine.submit(prompt, max_new_tokens=6,
                               handoff=wrong).result(120)
        np.testing.assert_array_equal(result.tokens, want)
        assert engine.stats()["handoff_imports"] == 0
        holey = {"version": 1, "block_tokens": BLOCK_TOKENS,
                 "covered_tokens": 8,
                 "keys": [tuple(int(t) for t in prompt[:4]), ("x",) * 4],
                 "payloads": [None, None]}
        result = engine.submit(prompt, max_new_tokens=6,
                               handoff=holey).result(120)
        np.testing.assert_array_equal(result.tokens, want)
        assert engine.stats()["handoff_imports"] == 0
    finally:
        engine.close()


def test_role_and_handoff_validation(model):
    _, _, cfg, params = model
    with pytest.raises(ValueError, match="prefix_cache_blocks"):
        ServeConfig(role="prefill")
    with pytest.raises(ValueError, match="continuous"):
        ServeConfig(role="decode", scheduler="batch")
    with pytest.raises(ValueError, match="role"):
        ServeConfig(role="gpu")
    with pytest.raises(ValueError, match="prefix_summary_ttl_s"):
        ServeConfig(prefix_summary_ttl_s=0.0)
    engine = ServingEngine(params, cfg, ServeConfig(
        max_new_tokens=4, prompt_buckets=(8,), batch_buckets=(1,),
        prefix_summary_ttl_s=5.0), device="cpu", start=False)
    try:
        assert engine.health()["role"] == "both"
        with pytest.raises(ValueError, match="prefix_cache_blocks"):
            engine.submit(np.asarray([1, 2], np.int32), handoff_export=True)
        with pytest.raises(ValueError, match="prefix_cache_blocks"):
            engine.submit(np.asarray([1, 2], np.int32),
                          handoff={"keys": []})
        with pytest.raises(ValueError, match="prefix_cache_blocks"):
            engine.set_role("prefill")
        with pytest.raises(ValueError, match="role"):
            engine.set_role("gpu")
        engine.set_role("both")
    finally:
        engine.close(drain=False)


def test_batched_block_io_matches_jax():
    rng = np.random.default_rng(5)
    pool_np = {name: rng.normal(size=(2, 6, 4, 3, 5)).astype(np.float32)
               for name in ("k", "v")}
    blocks = np.asarray([0, 3, 5], np.int32)
    want = jax_gen.download_prefix_blocks(
        {n: jnp.asarray(v) for n, v in pool_np.items()}, blocks)
    got = generation.download_prefix_blocks(
        {n: torch.from_numpy(v.copy()) for n, v in pool_np.items()},
        blocks.tolist())
    for name in pool_np:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))
    rows = {name: rng.normal(size=(3, 2, 4, 3, 5)).astype(np.float32)
            for name in ("k", "v")}
    ids = np.asarray([4, 1, 6], np.int32)  # 6 is out of range: dropped
    want = jax_gen.upload_prefix_blocks(
        {n: jnp.asarray(v) for n, v in pool_np.items()},
        {n: jnp.asarray(v) for n, v in rows.items()}, ids)
    pool = {n: torch.from_numpy(v.copy()) for n, v in pool_np.items()}
    got = generation.upload_prefix_blocks(
        pool, {n: torch.from_numpy(v) for n, v in rows.items()}, ids.tolist())
    for name in pool_np:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


# ---------------------------------------------------------------------------
# The two-leg route over fakes.


def payload(num_blocks, base=0):
    return {"version": 1, "block_tokens": BLOCK_TOKENS,
            "covered_tokens": num_blocks * BLOCK_TOKENS,
            "keys": [tuple(range(base + i * BLOCK_TOKENS,
                                 base + (i + 1) * BLOCK_TOKENS))
                     for i in range(num_blocks)],
            "payloads": [np.full((3,), base + i, np.float32)
                         for i in range(num_blocks)]}


class HandoffFakeEngine(FakeEngine):
    """A fake whose ``submit`` takes the handoff keywords: a prefill leg
    resolves to a ``ServeResult`` carrying ``export_payload``; anything
    else to the routing dict with the payload it received."""

    def __init__(self, name, *, export_payload=None, **kw):
        super().__init__(name, **kw)
        self.export_payload = export_payload
        self.role_set = None

    def set_role(self, role):
        self.role_set = role

    def submit(self, prompt, *, max_new_tokens=None, deadline_s=None,
               handoff_export=False, handoff=None, **extra):
        with self._lock:
            if self.closed:
                raise EngineClosedError(f"{self.name} closed")
            if self.max_queue is not None and (
                    len(self.pending) >= self.max_queue):
                raise QueueFullError(f"{self.name} full")
            self.submits.append({"max_new_tokens": max_new_tokens,
                                 "handoff_export": handoff_export,
                                 "handoff": handoff})
            future = Future()
            if handoff_export:
                result = ServeResult(
                    tokens=np.asarray([7], np.int32), num_generated=1,
                    bucket_len=8, batch_size=1, latency_seconds=0.001,
                    ttft_seconds=0.001, handoff=self.export_payload)
            else:
                result = {"served_by": self.name, "handoff": handoff}
            if self.auto:
                future.set_result(result)
            else:
                self.pending.append(future)
            return future


def disagg_fleet(engines, roles, **overrides):
    return Fleet(Factory(engines), quiet_config(
        min_replicas=len(engines), roles=roles, **overrides))


def test_two_leg_handoff_through_the_host_pool():
    pre = HandoffFakeEngine("pre", export_payload=payload(2))
    dec = HandoffFakeEngine("dec")
    fleet = disagg_fleet([pre, dec], ("prefill", "decode"))
    try:
        result = fleet.submit(np.arange(1, 10, dtype=np.int32),
                              max_new_tokens=5).result(10)
        stats = fleet.stats()
        health = fleet.health()
    finally:
        fleet.close()
    assert result["served_by"] == "dec"
    assert pre.submits[0]["handoff_export"] is True
    assert pre.submits[0]["max_new_tokens"] == 1
    assert dec.submits[0]["max_new_tokens"] == 5
    seen = result["handoff"]
    assert seen["keys"] == payload(2)["keys"]
    assert [p.tolist() for p in seen["payloads"]] == [[0.0] * 3, [1.0] * 3]
    assert stats["handoffs"] == 1 and stats["handoff_failovers"] == 0
    assert stats["routed"] == {0: 1, 1: 1}
    assert stats["host_pool"]["puts"] == 2
    assert (pre.role_set, dec.role_set) == ("prefill", "decode")
    assert [s["role"] for s in health["replicas"]] == ["prefill", "decode"]
    assert not fleet_threads()


def test_host_pool_dedups_repeat_prefixes():
    pre = HandoffFakeEngine("pre", export_payload=payload(3))
    dec = HandoffFakeEngine("dec")
    fleet = disagg_fleet([pre, dec], ("prefill", "decode"))
    try:
        for _ in range(3):
            fleet.submit(np.arange(1, 14, dtype=np.int32)).result(10)
        pool = fleet.stats()["host_pool"]
    finally:
        fleet.close()
    assert pool["puts"] == 3 and pool["dedup_hits"] == 6
    assert pool["blocks"] == 3


def test_both_replica_serves_colocated_and_empty_export_flips():
    both = HandoffFakeEngine("both")
    dec = HandoffFakeEngine("dec")
    fleet = disagg_fleet([both, dec], ("both", "decode"))
    try:
        result = fleet.submit(np.arange(1, 6, dtype=np.int32)).result(10)
        assert result["served_by"] == "both"
        assert both.submits[0]["handoff_export"] is False
        assert fleet.stats()["handoffs"] == 0
    finally:
        fleet.close()
    pre = HandoffFakeEngine("pre", export_payload=None)
    dec = HandoffFakeEngine("dec")
    fleet = disagg_fleet([pre, dec], ("prefill", "decode"))
    try:
        result = fleet.submit(np.arange(1, 6, dtype=np.int32)).result(10)
        assert result["served_by"] == "dec"
        assert result["handoff"]["keys"] == []
        assert fleet.stats()["handoffs"] == 1
    finally:
        fleet.close()


def test_dead_decode_leg_resets_handoff_and_reprefills():
    pre = HandoffFakeEngine("pre", export_payload=payload(1))
    dead = HandoffFakeEngine("dead", auto=False)
    fleet = disagg_fleet([pre, dead], ("prefill", "decode"),
                         poll_interval_s=60.0)
    try:
        future = fleet.submit(np.arange(1, 6, dtype=np.int32))
        deadline = time.perf_counter() + 10
        while not dead.submits:
            assert time.perf_counter() < deadline
            time.sleep(0.005)
        dead.auto = True
        dead.fail_all(EngineClosedError("decode replica died"))
        result = future.result(10)
        stats = fleet.stats()
    finally:
        fleet.close()
    assert result["served_by"] == "dead"
    assert stats["handoff_failovers"] == 1
    assert stats["handoffs"] == 2
    assert len(pre.submits) == 2


def test_roleless_fleet_builds_no_handoff_legs():
    engines = [HandoffFakeEngine("a", export_payload=payload(1)),
               FakeEngine("plain")]
    fleet = Fleet(Factory(engines), quiet_config(min_replicas=2))
    try:
        for _ in range(4):
            fleet.submit(np.arange(1, 6, dtype=np.int32)).result(10)
        stats = fleet.stats()
    finally:
        fleet.close()
    assert stats["handoffs"] == 0
    assert stats["host_pool"] == {"puts": 0, "dedup_hits": 0, "gets": 0,
                                  "misses": 0, "evictions": 0, "blocks": 0}
    assert all(not s["handoff_export"] and s["handoff"] is None
               for s in engines[0].submits)


# ---------------------------------------------------------------------------
# A live disaggregated port fleet.


def test_disagg_fleet_parity_and_counters(model):
    """The reference's ``test_disagg_fleet_parity_and_counters`` on the
    port: a 1-prefill/2-decode fleet of TINY f32 engines."""
    rng = np.random.default_rng(11)
    shared = rng.integers(1, 255, 8).astype(np.int32)
    prompts = [np.concatenate([shared,
                               rng.integers(1, 255, n).astype(np.int32)])
               for n in (5, 9, 3, 13)]
    fleet = Fleet(lambda: port_engine(model), FleetConfig(
        min_replicas=3, poll_interval_s=60.0,
        roles=("prefill", "decode", "decode")))
    try:
        futures = [fleet.submit(p, max_new_tokens=6) for p in prompts]
        results = [f.result(timeout=240) for f in futures]
        stats = fleet.stats()
        health = fleet.health()
        engines = {r.id: r.engine.stats() for r in fleet.replicas()}
    finally:
        fleet.close()
    want = jax_tokens(model, prompts, 6)
    for i, result in enumerate(results):
        np.testing.assert_array_equal(result.tokens, want[i])
    assert stats["handoffs"] == len(prompts)
    assert stats["handoff_failovers"] == 0
    assert stats["completed"] == len(prompts)
    assert stats["routed"][0] == len(prompts)
    assert stats["host_pool"]["dedup_hits"] >= 2
    assert {s["replica"]: s["role"] for s in health["replicas"]} == {
        0: "prefill", 1: "decode", 2: "decode"}
    assert engines[0]["handoff_exports"] == len(prompts)
    assert engines[1]["handoff_imports"] + engines[2]["handoff_imports"] == (
        len(prompts))
    assert not fleet_threads()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("cloud-tpu-fleet")]
