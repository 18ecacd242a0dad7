"""The prefix cache's host tier and the KV handoff on the port's
tensor-parallel serving slice, on the CPU, against JAX ``generate`` and
the one-card port engine.

A 2-layer TINY f32 with the reference's own weights and tie-free
prompts; the port's side runs in a JAX-free child where ``ServeConfig(
mesh_shape=(2, 1))`` spawns the follower over gloo (one slice at a time:
a slice's process group is the process's default group).

* **Host tier churn** (``prefix_cache_blocks=4``, ``prefix_dram_blocks=
  8``, 4-token blocks, the attach route): prompts A B C D A B served one
  at a time demote blocks to host memory and swap A's and B's back in.
  On the slice rank 0's manager decides every demotion and swap-in and
  each rank moves its heads' bytes: the tokens equal JAX ``generate``'s
  and the hit, demotion, eviction and swap-in counts the one-card
  engine's.
* **The KV handoff**: a prefill leg (``role="prefill"``,
  ``handoff_export=True``) on one card and on a slice; the slice's
  payload holds every head (rank 0 gathers the follower's, in head
  order) and equals the one-card payload within 1e-5.  Decode legs
  (``role="decode"``, ``submit(handoff=)``) import it: slice to one card,
  one card to slice, slice to slice, each token-identical to JAX
  ``generate`` with the one-card import's counters.
"""

import numpy as np
import pytest
import torch

from helpers.torch_port import (model_inputs, run_port_side, tie_free_rows,
                                tiny_models)
from test_torch_serving_tp import _expected

torch.set_num_threads(1)

MAX_NEW = 6
#: The host tier's counters held to the one-card engine's.
TIER_KEYS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
             "prefix_dram_hits", "prefix_dram_hit_tokens",
             "prefix_dram_demotions", "prefix_dram_evictions", "evictions",
             "stream_syncs")
HANDOFF_KEYS = ("handoff_exports", "handoff_export_blocks",
                "handoff_imports", "handoff_import_blocks", "prefix_hits")
#: Decode legs: (payload from, decode on).
LEGS = (("slice", "one"), ("one", "slice"), ("slice", "slice"))

_CHILD = """
import dataclasses
from cloud_tpu_torch.serving import ServeConfig, ServingEngine

cfg, params = port_model()
prompts = [IN[k] for k in sorted(IN) if k.startswith("prompt/")]
SHAPES = {"one": None, "slice": (2, 1)}
tier = ServeConfig(max_new_tokens=MAX_NEW, prompt_buckets=(16,),
                   num_slots=2, chunk_tokens=2, prefix_cache_blocks=4,
                   prefix_dram_blocks=8, prefix_block_tokens=4,
                   decode_kernel="pallas")
order = [0, 1, 2, 3, 0, 1]
for side, shape in SHAPES.items():
    with ServingEngine(params, cfg, dataclasses.replace(
            tier, mesh_shape=shape), device="cpu") as eng:
        res = [eng.submit(prompts[i]).result(120) for i in order]
        stats = eng.stats()
    for n, r in enumerate(res):
        OUT[f"tier/{side}/tokens/{n}"] = r.tokens
    OUT[f"tier/{side}/stats"] = np.asarray([stats[k] for k in TIER_KEYS])

handoff = ServeConfig(max_new_tokens=MAX_NEW, prompt_buckets=(16,),
                      num_slots=2, chunk_tokens=2, prefix_cache_blocks=8,
                      prefix_block_tokens=4)
payloads = {}
for side, shape in SHAPES.items():
    with ServingEngine(params, cfg, dataclasses.replace(
            handoff, mesh_shape=shape, role="prefill"), device="cpu") as eng:
        r = eng.submit(prompts[0], max_new_tokens=1,
                       handoff_export=True).result(120)
        stats = eng.stats()
    payloads[side] = r.handoff
    OUT[f"export/{side}/stats"] = np.asarray([stats[k] for k in HANDOFF_KEYS])
one, whole = payloads["one"], payloads["slice"]
OUT["export/keys"] = np.asarray(
    [one["keys"] == whole["keys"], len(one["payloads"]),
     len(whole["payloads"])])
OUT["export/err"] = np.asarray(max(
    float((a[name].float() - b[name].float()).abs().max())
    for a, b in zip(one["payloads"], whole["payloads"]) for name in a))
OUT["export/shapes"] = np.asarray(
    [list(p["k"].shape) for p in whole["payloads"]])
for source, target in [("one", "one")] + [tuple(l) for l in LEGS]:
    with ServingEngine(params, cfg, dataclasses.replace(
            handoff, mesh_shape=SHAPES[target], role="decode"),
            device="cpu") as eng:
        r = eng.submit(prompts[0], handoff=payloads[source]).result(120)
        stats = eng.stats()
    OUT[f"import/{source}-{target}/tokens"] = r.tokens
    OUT[f"import/{source}-{target}/stats"] = np.asarray(
        [stats[k] for k in HANDOFF_KEYS])
"""


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    jcfg, jparams, _, _ = tiny_models(seed=4, num_layers=2)
    prompts = tie_free_rows(jcfg, jparams, [9, 10, 9, 11], MAX_NEW, seed=23)
    want = _expected(jcfg, jparams, prompts, MAX_NEW)
    inputs = model_inputs(jcfg, jparams)
    for i, p in enumerate(prompts):
        inputs[f"prompt/{i}"] = np.asarray(p, np.int32)
    out = run_port_side(
        f"MAX_NEW = {MAX_NEW}\nTIER_KEYS = {TIER_KEYS!r}\n"
        f"HANDOFF_KEYS = {HANDOFF_KEYS!r}\nLEGS = {LEGS!r}\n" + _CHILD,
        inputs, tmp_path_factory.mktemp("slice_kv"), timeout=300)
    return out, want, jcfg


def test_host_tier_on_a_slice_matches_one_card(served):
    out, want, _ = served
    order = [0, 1, 2, 3, 0, 1]
    for side in ("one", "slice"):
        for n, i in enumerate(order):
            np.testing.assert_array_equal(
                out[f"tier/{side}/tokens/{n}"], want[i],
                err_msg=f"{side} request {n}")
    stats = dict(zip(TIER_KEYS, out["tier/one/stats"]))
    assert stats["prefix_dram_demotions"] >= 1
    assert stats["prefix_dram_hits"] >= 1  # a swap-in
    np.testing.assert_array_equal(out["tier/slice/stats"],
                                  out["tier/one/stats"],
                                  err_msg=str(TIER_KEYS))


def test_slice_exports_every_head(served):
    out, _, jcfg = served
    same_keys, n_one, n_slice = out["export/keys"].tolist()
    assert same_keys and n_one == n_slice == 2  # 9 tokens: 2 full blocks
    assert float(out["export/err"]) <= 1e-5
    for shape in out["export/shapes"]:
        assert list(shape) == [jcfg.num_layers, 4, jcfg.num_heads,
                               jcfg.head_dim]
    np.testing.assert_array_equal(out["export/slice/stats"],
                                  out["export/one/stats"])


@pytest.mark.parametrize("leg", LEGS, ids="-to-".join)
def test_handoff_legs_match_jax_generate(served, leg):
    out, want, _ = served
    source, target = leg
    np.testing.assert_array_equal(out[f"import/{source}-{target}/tokens"],
                                  want[0])
    stats = dict(zip(HANDOFF_KEYS, out[f"import/{source}-{target}/stats"]))
    assert stats["handoff_imports"] == 1 and stats["prefix_hits"] == 1
    np.testing.assert_array_equal(out[f"import/{source}-{target}/stats"],
                                  out["import/one-one/stats"])
