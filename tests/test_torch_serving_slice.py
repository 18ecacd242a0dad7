"""The port's tensor-parallel serving slice with a speculative draft, at
``pipeline_depth=2`` and as a fleet's replica, on the CPU, against JAX
``generate`` and the one-card port engine.

The JAX engine's speculation tests on a slice
(``tests/unit/test_serving.py`` ``test_spec_tp2_parity``: a draft of the
target's shape, head-sharded over tp 2; ``test_spec_tp2_replicated_draft
_parity``: a 3-head draft that tp 2 does not divide, replicated on every
rank) on a 1-layer TINY f32 target, the reference's own weights and
tie-free prompts.  The port's side runs in a JAX-free child
(``helpers/torch_port.py`` ``run_port_side``) where ``ServeConfig(
mesh_shape=(2, 1))`` spawns the follower over gloo.  Every scenario
serves the same requests one at a time on a slice and on one card:

* a head-sharded draft, a replicated draft, depth 2, and depth 2 with
  the sharded draft: the slice's greedy tokens equal JAX ``generate``'s,
  its counters (verify rounds, proposed and accepted tokens, draft
  prefills, chunks) equal the one-card engine's, and ``verify_traces`` is
  1;
* a ``Fleet`` whose one replica is a tp-2 slice: the tokens, the routed
  count, and ``health()["total_chips"]`` 2 (the replica's
  ``slice_chips``);
* at depth 2 with ``dispatch_timeout_s``, a follower that hangs (stopped
  with SIGSTOP) fails the next request with ``DispatchTimeoutError``
  within the watchdog's budget and marks the engine unhealthy.
"""

import jax
import numpy as np
import pytest
import torch

from cloud_tpu.models import transformer as jax_tf
from helpers.torch_port import (model_inputs, run_port_side, tie_free_rows,
                                tiny_models)
from test_torch_serving_tp import _expected

torch.set_num_threads(1)

LENS = (3, 6, 5)
BUDGETS = (6, 2, 5)
MAX_NEW = 6
#: The slice's counters held to the one-card engine's.
KEYS = ("completed", "chunks", "spec_chunks", "spec_proposed",
        "spec_accepted", "spec_emitted", "draft_prefills",
        "generated_tokens")
SCENARIOS = ("draft", "draft replicated", "depth2", "depth2 draft")

_CHILD = """
import dataclasses
from cloud_tpu_torch.fleet import Fleet, FleetConfig
from cloud_tpu_torch.serving import DraftConfig, ServeConfig, ServingEngine

cfg, params = port_model()
dcfg, dparams = port_model("draft")
d3cfg, d3params = port_model("d3")
prompts = [IN[k] for k in sorted(IN) if k.startswith("prompt/")]
budgets = [int(b) for b in IN["budgets"]]
base = ServeConfig(max_new_tokens=MAX_NEW, prompt_buckets=(8,),
                   num_slots=2, chunk_tokens=2)
draft = DraftConfig(config=dcfg, params=dparams, spec_k=3)
SERVES = {
    "draft": dataclasses.replace(base, draft=draft),
    "draft replicated": dataclasses.replace(base, draft=DraftConfig(
        config=d3cfg, params=d3params, spec_k=2)),
    "depth2": dataclasses.replace(base, pipeline_depth=2),
    "depth2 draft": dataclasses.replace(base, pipeline_depth=2,
                                        draft=draft),
}
for name, serve in SERVES.items():
    for side, shape in (("one", None), ("slice", (2, 1))):
        with ServingEngine(params, cfg, dataclasses.replace(
                serve, mesh_shape=shape), device="cpu") as eng:
            res = [eng.submit(p, max_new_tokens=b).result(120)
                   for p, b in zip(prompts, budgets)]
            stats = eng.stats()
            OUT[f"{name}/{side}/shape"] = np.asarray(
                [eng.health()["slice_chips"], eng.verify_traces,
                 int(eng._draft_sharded), stats["pipeline_depth"]])
        for i, r in enumerate(res):
            OUT[f"{name}/{side}/tokens/{i}"] = r.tokens
        OUT[f"{name}/{side}/stats"] = np.asarray([stats[k] for k in KEYS])

fleet = Fleet(lambda: ServingEngine(params, cfg, dataclasses.replace(
    base, mesh_shape=(2, 1)), device="cpu"),
    FleetConfig(min_replicas=1, max_replicas=1))
try:
    res = [fleet.submit(p, max_new_tokens=b).result(120)
           for p, b in zip(prompts, budgets)]
    health = fleet.health()
    routed = fleet.stats()["routed"]
finally:
    fleet.close()
for i, r in enumerate(res):
    OUT[f"fleet/tokens/{i}"] = r.tokens
OUT["fleet/chips"] = np.asarray(
    [health["total_chips"], health["replicas"][0]["slice_chips"],
     sum(routed.values())])
"""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jcfg, jparams, _, _ = tiny_models(seed=0, num_layers=1)
    _, draft_params, _, _ = tiny_models(seed=7, num_layers=1)
    d3cfg = jcfg.scaled(num_heads=3, head_dim=16, dim=48, mlp_hidden=96)
    d3params = jax.tree_util.tree_map(
        np.asarray, jax_tf.init(jax.random.PRNGKey(9), d3cfg))
    prompts = tie_free_rows(jcfg, jparams, list(LENS), MAX_NEW, seed=15)
    want = _expected(jcfg, jparams, prompts, MAX_NEW)
    inputs = {**model_inputs(jcfg, jparams),
              **model_inputs(jcfg, draft_params, prefix="draft"),
              **model_inputs(d3cfg, d3params, prefix="d3"),
              "budgets": np.asarray(BUDGETS)}
    for i, p in enumerate(prompts):
        inputs[f"prompt/{i}"] = np.asarray(p, np.int32)
    out = run_port_side(
        f"MAX_NEW = {MAX_NEW}\nKEYS = {KEYS!r}\n" + _CHILD, inputs,
        tmp_path_factory.mktemp("slice"), timeout=300)
    return out, [w[:b] for w, b in zip(want, BUDGETS)]


@pytest.mark.parametrize("name", SCENARIOS)
def test_slice_matches_jax_generate_and_the_one_card_engine(served, name):
    out, want = served
    for side in ("one", "slice"):
        for i, w in enumerate(want):
            np.testing.assert_array_equal(
                out[f"{name}/{side}/tokens/{i}"], w,
                err_msg=f"{name} {side} request {i}")
    np.testing.assert_array_equal(out[f"{name}/slice/stats"],
                                  out[f"{name}/one/stats"],
                                  err_msg=f"{name}: {KEYS}")
    chips, verify_traces, sharded, depth = out[f"{name}/slice/shape"]
    assert chips == 2
    assert depth == (2 if name.startswith("depth2") else 1)
    if "draft" in name:
        stats = dict(zip(KEYS, out[f"{name}/slice/stats"]))
        assert stats["spec_chunks"] > 0
        assert stats["draft_prefills"] == len(BUDGETS)
        assert verify_traces == 1
        assert sharded == (name != "draft replicated")


def test_fleet_routes_to_a_slice_replica(served):
    out, want = served
    for i, w in enumerate(want):
        np.testing.assert_array_equal(out[f"fleet/tokens/{i}"], w)
    assert out["fleet/chips"].tolist() == [2, 2, len(BUDGETS)]


_HANG = """
import os
import signal
import time
from cloud_tpu_torch.serving import ServeConfig, ServingEngine

cfg, params = port_model()
eng = ServingEngine(params, cfg, ServeConfig(
    max_new_tokens=4, prompt_buckets=(8,), num_slots=2, chunk_tokens=2,
    pipeline_depth=2, dispatch_timeout_s=5.0, mesh_shape=(2, 1)),
    device="cpu")
OUT["before"] = eng.submit(IN["prompt"]).result(120).tokens
follower = eng._spawned.procs[0]
os.kill(follower.pid, signal.SIGSTOP)
start = time.perf_counter()
try:
    eng.submit(IN["prompt"]).result(120)
    OUT["error"] = np.asarray("")
except Exception as exc:
    OUT["error"] = np.asarray(type(exc).__name__)
OUT["seconds"] = np.asarray(time.perf_counter() - start)
health = eng.health()
OUT["health"] = np.asarray([str(health["reason"]), str(health["live"])])
os.kill(follower.pid, signal.SIGKILL)
eng.close(drain=False)
"""


def test_watchdog_covers_a_hung_follower_at_depth_2(served, tmp_path):
    """A follower that stops answering holds rank 0's collective; the
    watchdog fails the request instead of waiting for the group's
    timeout."""
    jcfg, jparams, _, _ = tiny_models(seed=0, num_layers=1)
    out = run_port_side(_HANG, {**model_inputs(jcfg, jparams),
                                "prompt": np.arange(1, 6, dtype=np.int32)},
                        tmp_path, timeout=300)
    assert len(out["before"]) == 4
    assert str(out["error"]) == "DispatchTimeoutError"
    assert float(out["seconds"]) < 60
    reason, live = out["health"].tolist()
    assert "watchdog" in reason or "serve/" in reason, reason
