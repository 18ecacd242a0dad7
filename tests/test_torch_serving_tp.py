"""The port's tensor-parallel serving on the CPU, against JAX ``generate``.

The JAX engine's ``TestShardedServing`` scenarios at tp 2, on TINY f32
(2 layers) with the reference's own weights and tie-free prompts: every
request token-identical to JAX ``generate``.  The port's side runs in
JAX-free children (``helpers/torch_port.py`` ``run_port_side``), where
``ServeConfig(mesh_shape=(tp, 1))`` makes rank 0 spawn its followers over
gloo; several scenarios share a child:

* churn through a tp-2 slice with health, stats, ``chunk_traces``,
  ``serve/reshard`` spans and the report's "slice 2x1 (2 chips)"; an int8
  KV cache; prefix hits (copy and attach routes); chunked prefill; the
  batch scheduler; bench.py's ``serving_tp`` workload replayed (0 parity
  mismatches); a 6-head TINY at tp 3 (the vocabulary split unevenly);
  the KV handoff on a slice without a prefix cache refused with the
  one-card engine's ``ValueError``; a follower killed mid-life failing
  the next request instead of hanging;
* a caller's mesh over two gloo processes (rank 1 runs ``follow()``): the
  sharded forward's logits within 1e-4 of JAX ``apply``, the engine's
  tokens, the follower's committed slot state equal to rank 0's, and a
  ``dp`` mesh that is no serving slice.

In-process: ``mesh_shape`` errors with the JAX engine's messages (heads,
devices, ``mesh=`` with ``mesh_shape``), what a slice runs reaching the
followers' spawn (``sp > 1``, an MoE model, the draft, the host tier,
``role=`` and depth 2), and ``mesh_shape=(1, 1)`` as the one-card engine.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import generation as jax_gen
from cloud_tpu.models import transformer as jax_tf
from cloud_tpu.serving import ServeConfig as JaxServeConfig
from cloud_tpu.serving import ServingEngine as JaxServingEngine
from cloud_tpu_torch.models import moe, transformer
from cloud_tpu_torch.parallel import MeshSpec
from cloud_tpu_torch.parallel import mesh as mesh_lib
from cloud_tpu_torch.serving import DraftConfig, ServeConfig, ServingEngine
from helpers.torch_port import (
    _PRELUDE,
    launch_ranks,
    model_inputs,
    run_port_side,
    tie_free_rows,
    tiny_models,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    return tiny_models(seed=3, num_layers=2)


#: Every scenario's prompt lengths: drawn tie-free in one batched call.
LENS = {"churn": [3, 7, 2, 8], "chunked": [16, 7, 11], "batch": [4, 8, 6],
        "caller": [3, 8, 5], "shared": [12], "tails": [3, 4]}
#: The most tokens a drawn prompt serves, and bench.py's workload (greedy:
#: a shorter budget's tokens are the first ones).
DRAWN_NEW, BENCH_NEW = 6, 12


def _expected(jax_cfg, params, prompts, new, *, kv_quant=False):
    """JAX ``generate``'s ``new`` greedy tokens for each prompt, in one
    batched call (prompts left-aligned, padded to 16)."""
    padded = np.zeros((len(prompts), 16), np.int32)
    for row, p in enumerate(prompts):
        padded[row, :len(p)] = p
    out = jax_gen.generate(params, jnp.asarray(padded),
                           jnp.asarray([len(p) for p in prompts], np.int32),
                           jax_cfg, max_new_tokens=new, kv_quant=kv_quant)
    return list(np.asarray(out["tokens"]))


def _bench_prompts(vocab):
    """bench.py's ``_serve_tp_main`` workload (``bench.py:1171-1186``)."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, vocab, int(rng.integers(4, 17))).astype(
        np.int32) for _ in range(8)]
    budgets = [int(rng.integers(6, 13)) for _ in prompts]
    return prompts, budgets


@pytest.fixture(scope="module")
def scenario(models):
    """The prompts of every scenario and JAX ``generate``'s tokens for
    them: the main model plain and with an int8 KV cache, and a 6-head
    TINY (tp 3)."""
    jax_cfg, params, _, _ = models
    drawn = iter(tie_free_rows(jax_cfg, params,
                               [n for lens in LENS.values() for n in lens],
                               DRAWN_NEW, seed=11))
    rows = {key: [next(drawn) for _ in lens] for key, lens in LENS.items()}
    shared = rows.pop("shared")[0]
    # Three prompts over one 8-token prefix: a miss, then two hits.
    rows["prefix"] = [shared] + [np.concatenate([shared[:8], t])
                                 for t in rows.pop("tails")]
    rows["bench"], bench_budgets = _bench_prompts(jax_cfg.vocab_size)
    rows["quant"] = tie_free_rows(jax_cfg, params, [5, 9, 3], DRAWN_NEW,
                                  seed=12, kv_quant=True)
    six_cfg = jax_tf.TINY.scaled(dtype=jnp.float32, num_layers=2,
                                 num_heads=6)
    six_params = jax_tf.init(jax.random.PRNGKey(5), six_cfg)
    rows["tp3"] = tie_free_rows(six_cfg, six_params, [4, 7], DRAWN_NEW,
                                seed=17)
    keys = [k for k in rows if k not in ("quant", "tp3")]
    flat = _expected(jax_cfg, params, [p for k in keys for p in rows[k]],
                     BENCH_NEW)
    want = {}
    for key in keys:
        want[key], flat = flat[:len(rows[key])], flat[len(rows[key]):]
    want["quant"] = _expected(jax_cfg, params, rows["quant"], DRAWN_NEW,
                              kv_quant=True)
    want["tp3"] = _expected(six_cfg, six_params, rows["tp3"], DRAWN_NEW)
    return {"rows": rows, "want": want, "bench_budgets": bench_budgets,
            "six": (six_cfg, six_params)}


# ---------------------------------------------------------------------------
# Slices spawned by mesh_shape, in one JAX-free child.

_SPAWNED = """
import time
from cloud_tpu_torch.monitoring import tracing
from cloud_tpu_torch.monitoring.report import TraceReport
from cloud_tpu_torch.serving import ServeConfig, ServingEngine

cfg, params = port_model()


def prompts(key):
    return [IN[k] for k in sorted(IN) if k.startswith(key + "/")]


def serve(serve_cfg, key, budgets, *, in_turn=False, model=(cfg, params)):
    with ServingEngine(model[1], model[0], serve_cfg, device="cpu") as eng:
        eng.wait_ready()
        rows = prompts(key)
        if in_turn:
            res = [eng.submit(p, max_new_tokens=b).result(120)
                   for p, b in zip(rows, budgets)]
        else:
            futs = [eng.submit(p, max_new_tokens=b)
                    for p, b in zip(rows, budgets)]
            res = [f.result(120) for f in futs]
        stats = eng.stats()
    for i, r in enumerate(res):
        OUT[f"{key}/tokens/{i}"] = r.tokens
    return stats

# Churn with health, stats, chunk_traces, reshard spans and the report.
with tracing.collecting() as col:
    with ServingEngine(params, cfg, ServeConfig(
            max_new_tokens=4, prompt_buckets=(8,), batch_buckets=(1, 2),
            chunk_tokens=2, mesh_shape=(2, 1)), device="cpu") as eng:
        health = eng.health()
        futs = [eng.submit(p, max_new_tokens=b)
                for p, b in zip(prompts("churn"), IN["churn_budgets"])]
        res = [f.result(120) for f in futs]
        stats = eng.stats()
        traces = eng.chunk_traces
        # The KV handoff runs on a slice (tests/test_torch_serving_slice_
        # kv.py); without a prefix cache it is refused as on one card.
        refusals = []
        for call in (lambda: eng.submit(prompts("churn")[0],
                                        handoff_export=True),
                     lambda: eng.set_role("decode")):
            try:
                call()
            except Exception as exc:  # noqa: BLE001 — recorded
                refusals.append(f"{type(exc).__name__}: {exc}")
    report = TraceReport(col.events())
for i, r in enumerate(res):
    OUT[f"churn/tokens/{i}"] = r.tokens
OUT["churn/slice_shape"] = np.asarray(health["slice_shape"])
OUT["churn/slice_chips"] = np.asarray(
    [health["slice_chips"], stats["slice_chips"], traces])
reshard = [e for e in col.events() if e.get("name") == "serve/reshard"]
OUT["churn/reshard_chips"] = np.asarray(
    [(e.get("args") or {}).get("chips", 0) for e in reshard])
summary = report.continuous_summary()
OUT["churn/report"] = np.asarray(json.dumps(
    [summary["slice"], summary["slice_chips"],
     "slice 2x1 (2 chips)" in report.render()]))
OUT["churn/refusals"] = np.asarray(json.dumps(refusals))

base = dict(max_new_tokens=6, prompt_buckets=(8, 16), num_slots=2,
            chunk_tokens=3, mesh_shape=(2, 1))
serve(ServeConfig(**base, kv_quant=True), "quant", [6, 4, 5])
for route in ("xla", "pallas"):
    stats = serve(ServeConfig(**base, prefix_cache_blocks=8,
                              prefix_block_tokens=4, decode_kernel=route),
                  f"prefix_{route}", [6, 5, 6], in_turn=True)
    OUT[f"prefix_{route}/hits"] = np.asarray(
        [stats["prefix_hits"], stats["prefix_attaches"]])
stats = serve(ServeConfig(**base, prefill_chunk_tokens=3), "chunked",
              [6, 3, 5])
OUT["chunked/prefill_chunks"] = np.asarray(stats["prefill_chunks"])
stats = serve(ServeConfig(**base, scheduler="batch", batch_buckets=(1, 2)),
              "batch", [6, 6, 6])
OUT["batch/batches"] = np.asarray(stats["batches"])

# bench.py's serving_tp workload, warmup included.
start = time.perf_counter()
serve(ServeConfig(max_new_tokens=12, prompt_buckets=(16,), chunk_tokens=4,
                  mesh_shape=(2, 1), warmup=True), "bench",
      IN["bench_budgets"])
OUT["bench/seconds"] = np.asarray(time.perf_counter() - start)

# A 6-head TINY at tp 3: the 256-token vocabulary splits 86/85/85.
six = port_model("six")
serve(ServeConfig(max_new_tokens=5, prompt_buckets=(8,), num_slots=2,
                  chunk_tokens=2, mesh_shape=(3, 1)), "tp3", [5, 5],
      model=six)

# A follower that dies fails the next request, and the health says why.
eng = ServingEngine(params, cfg, ServeConfig(
    max_new_tokens=3, prompt_buckets=(8,), mesh_shape=(2, 1)), device="cpu")
eng.submit(prompts("churn")[0]).result(120)
eng._spawned.procs[0].kill()
eng._spawned.procs[0].join(30)
start = time.perf_counter()
try:
    eng.submit(prompts("churn")[0]).result(120)
    OUT["dead/error"] = np.asarray("")
except Exception as exc:
    OUT["dead/error"] = np.asarray(type(exc).__name__ + ": " + str(exc))
OUT["dead/seconds"] = np.asarray(time.perf_counter() - start)
OUT["dead/health"] = np.asarray(str(eng.health()["reason"]))
eng.close()
"""


#: Each spawned scenario's budgets (bench.py's come with its prompts).
BUDGETS = {"churn": [1, 4, 2, 3], "quant": [6, 4, 5], "prefix": [6, 5, 6],
           "chunked": [6, 3, 5], "batch": [6, 6, 6], "tp3": [5, 5]}


def test_spawned_slices_match_jax_generate(models, scenario, tmp_path):
    jax_cfg, params, _, _ = models
    rows, want = scenario["rows"], scenario["want"]
    inputs = model_inputs(jax_cfg, params)
    inputs.update(model_inputs(*scenario["six"], prefix="six"))
    served = {"prefix_xla": "prefix", "prefix_pallas": "prefix"}
    for key in ("churn", "quant", "chunked", "batch", "bench", "tp3",
                "prefix_xla", "prefix_pallas"):
        for i, p in enumerate(rows[served.get(key, key)]):
            inputs[f"{key}/{i:02d}"] = np.asarray(p, np.int32)
    inputs["churn_budgets"] = np.asarray(BUDGETS["churn"])
    inputs["bench_budgets"] = np.asarray(scenario["bench_budgets"])
    out = run_port_side(_SPAWNED, inputs, tmp_path, timeout=600)

    for key in ("churn", "quant", "chunked", "batch", "tp3", "prefix_xla",
                "prefix_pallas"):
        rows_key = served.get(key, key)
        for i, b in enumerate(BUDGETS[rows_key]):
            np.testing.assert_array_equal(out[f"{key}/tokens/{i}"],
                                          want[rows_key][i][:b],
                                          err_msg=f"{key} request {i}")
    # bench.py's serve_tp_parity_mismatches, replayed: 0.
    mismatches = sum(
        not np.array_equal(out[f"bench/tokens/{i}"], want["bench"][i][:b])
        for i, b in enumerate(scenario["bench_budgets"]))
    assert mismatches == 0
    assert tuple(out["churn/slice_shape"]) == (2, 1)
    assert out["churn/slice_chips"].tolist() == [2, 2, 1]
    chips = out["churn/reshard_chips"]
    assert chips.size and (chips == 2).all()
    assert json.loads(str(out["churn/report"])) == ["2x1", 2, True]
    refusals = json.loads(str(out["churn/refusals"]))
    assert len(refusals) == 2 and all(
        r.startswith("ValueError: ") and "prefix_cache_blocks > 0" in r
        for r in refusals), refusals
    assert out["prefix_xla/hits"].tolist() == [2, 0]
    assert out["prefix_pallas/hits"].tolist() == [2, 2]
    assert int(out["chunked/prefill_chunks"]) >= 8
    assert int(out["batch/batches"]) >= 1
    error = str(out["dead/error"])
    assert error.startswith("SliceError") and "follower rank 1" in error
    assert float(out["dead/seconds"]) < 60
    assert "follower rank 1 exited" in str(out["dead/health"])


# ---------------------------------------------------------------------------
# A caller's mesh over two gloo processes.

_CALLER_RANK = """
import torch.distributed as dist
from cloud_tpu_torch import bridge
from cloud_tpu_torch.parallel import MeshSpec, distributed
from cloud_tpu_torch.serving import ServeConfig, ServingEngine

import datetime
dist.init_process_group("gloo", init_method="file://" + sys.argv[3],
                        world_size=2, rank=int(os.environ[
                            "CLOUD_TPU_PROCESS_ID"]),
                        timeout=datetime.timedelta(seconds=90))
assert distributed.initialize_from_env(90, device="cpu")
rank = distributed.process_index()
cfg, params = port_model()
mesh = MeshSpec({"tp": 2}).build(devices=["cpu", "cpu"])
shard = bridge.to_torch_shard(tree("params"), cfg, mesh, device="cpu")
with torch.no_grad():
    logits, _ = transformer.apply(shard, torch.from_numpy(IN["tokens"]), cfg,
                                  device="cpu")
serve = ServeConfig(max_new_tokens=5, prompt_buckets=(8,), num_slots=2,
                    chunk_tokens=2)
engine = ServingEngine(params, cfg, serve, mesh=mesh, device="cpu")
if rank == 0:
    OUT["logits"] = logits.numpy()
    futs = [engine.submit(IN[f"prompt/{i}"]) for i in range(3)]
    for i, f in enumerate(futs):
        OUT[f"tokens/{i}"] = f.result(120).tokens
    OUT["slice"] = np.asarray(engine.health()["slice_shape"])
    engine.close()
else:
    engine.follow()
for name in ("pos", "tok", "emitted", "active", "remaining"):
    OUT[f"state/{name}"] = engine._slot_state[name].numpy()
dp = MeshSpec({"dp": 2}).build(devices=["cpu", "cpu"])
plain = ServingEngine(params, cfg, serve, mesh=dp, device="cpu",
                      start=False)
OUT["dp"] = np.asarray([plain.health()["slice_chips"],
                        int("tp" in plain.params)])
plain.close()
dist.destroy_process_group()
"""


def test_caller_mesh_two_processes_logits_tokens_and_follower_state(
        models, scenario, tmp_path):
    jax_cfg, params, _, _ = models
    rng = np.random.default_rng(9)
    tokens = rng.integers(1, jax_cfg.vocab_size, (2, 8)).astype(np.int32)
    prompts = scenario["rows"]["caller"]
    inputs = model_inputs(jax_cfg, params)
    inputs["tokens"] = tokens
    for i, p in enumerate(prompts):
        inputs[f"prompt/{i}"] = p
    np.savez(tmp_path / "in.npz", **inputs)
    code = ("import os\n" + _PRELUDE + _CALLER_RANK
            + "\nnp.savez(sys.argv[2], **OUT)\n")
    # A rendezvous file of this call's own: no other call can meet it.
    done = launch_ranks(
        code, 2, lambda rank: [str(tmp_path / "in.npz"),
                               str(tmp_path / f"out{rank}.npz"),
                               str(tmp_path / "rendezvous")],
        timeout=180, env={"CLOUD_TPU_COORDINATOR": "127.0.0.1:0"})
    for rc, _, stderr in done:
        assert rc == 0, stderr[-3000:]
    outs = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(2)]
    want, _ = jax_tf.apply(params, jnp.asarray(tokens), jax_cfg)
    np.testing.assert_allclose(outs[0]["logits"], np.asarray(want),
                               rtol=0, atol=1e-4)
    for i, want in enumerate(scenario["want"]["caller"]):
        np.testing.assert_array_equal(outs[0][f"tokens/{i}"], want[:5])
    assert tuple(outs[0]["slice"]) == (2, 1)
    for name in ("pos", "tok", "emitted", "active", "remaining"):
        np.testing.assert_array_equal(outs[1][f"state/{name}"],
                                      outs[0][f"state/{name}"],
                                      err_msg=name)
    for out in outs:
        assert out["dp"].tolist() == [1, 0]


# ---------------------------------------------------------------------------
# In-process: errors, refusals and the one-card default.


@pytest.fixture
def eight_cpu_devices(monkeypatch):
    """The port sees 8 CPU ranks, as the JAX tests see 8 forced devices."""
    monkeypatch.setattr(mesh_lib, "visible_devices",
                        lambda kind: [torch.device(kind)] * 8)
    assert len(jax.devices()) == 8


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("kw", [dict(mesh_shape=(3, 1)),
                                dict(mesh_shape=(4, 4)),
                                dict(mesh_shape=(0, 1))], ids=str)
def test_mesh_shape_errors_match_jax(models, eight_cpu_devices, kw):
    jax_cfg, params, cfg, tparams = models

    def jax_side():
        JaxServingEngine(params, jax_cfg, JaxServeConfig(**kw), start=False)

    def port_side():
        ServingEngine(tparams, cfg, ServeConfig(**kw), device="cpu",
                      start=False)

    assert _raised(port_side) == _raised(jax_side)


def test_mesh_with_mesh_shape_is_the_jax_error(models, eight_cpu_devices):
    jax_cfg, params, cfg, tparams = models
    from cloud_tpu import parallel as jax_parallel

    jax_mesh = jax_parallel.MeshSpec({"tp": 1}).build(jax.devices()[:1])
    mesh = MeshSpec({"tp": 1}).build(devices=["cpu"])
    want = _raised(lambda: JaxServingEngine(
        params, jax_cfg, JaxServeConfig(mesh_shape=(2, 1)), mesh=jax_mesh,
        start=False))
    assert _raised(lambda: ServingEngine(
        tparams, cfg, ServeConfig(mesh_shape=(2, 1)), mesh=mesh,
        device="cpu", start=False)) == want


class _Spawned(Exception):
    """Raised in place of spawning a slice's followers."""


@pytest.mark.parametrize("case", ["sp", "draft", "moe", "host tier",
                                  "role", "pipeline_depth"])
def test_refusals_under_a_serving_mesh(models, eight_cpu_devices,
                                       monkeypatch, case):
    """Nothing a slice of more than one rank is given is refused any more:
    ``sp > 1`` and an MoE model (tests/test_torch_serving_sp.py,
    test_torch_serving_moe_slice.py), a draft, the host tier, ``role=``
    and depth 2 (tests/test_torch_serving_slice*.py) each get as far as
    spawning the followers, with every rank's shard cut."""
    _, _, cfg, tparams = models
    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.serving import slice as slice_lib

    def spawn(shards, *args, **kwargs):
        assert len(shards) == kw["mesh_shape"][0] * kw["mesh_shape"][1]
        raise _Spawned

    monkeypatch.setattr(slice_lib, "spawn_slice", spawn)
    kw = dict(mesh_shape=(2, 1), prompt_buckets=(8,))
    if case == "sp":
        kw["mesh_shape"] = (1, 2)
    elif case == "draft":
        kw["draft"] = DraftConfig(config=cfg, params=tparams, spec_k=2)
    elif case == "moe":
        cfg = cfg.scaled(moe=moe.MoeConfig(num_experts=4, top_k=2))
        tparams = bridge.init(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    elif case == "host tier":
        kw.update(prefix_cache_blocks=4, prefix_dram_blocks=4)
    elif case == "role":
        kw.update(prefix_cache_blocks=4, role="decode")
    else:
        kw["pipeline_depth"] = 2
    with pytest.raises(_Spawned):
        ServingEngine(tparams, cfg, ServeConfig(**kw), device="cpu",
                      start=False)


def test_one_by_one_mesh_shape_is_the_one_card_engine(models):
    _, _, cfg, tparams = models
    for serve in (ServeConfig(), ServeConfig(mesh_shape=(1, 1))):
        engine = ServingEngine(tparams, cfg, serve, device="cpu",
                               start=False)
        try:
            assert engine.mesh is None and "tp" not in engine.params
            health = engine.health()
            assert (health["slice_shape"], health["slice_chips"]) == (
                (1, 1), 1)
        finally:
            engine.close(drain=False)
