"""An MoE CloudLM on the port's serving slice, on the CPU, against the
JAX engine at the same shape and the one-card port engine.

MoE TINY (4 experts, top 2; 2 layers, f32) with the reference's own
weights.  An MoE layer's capacity follows the width it routes (C5), so
every prompt fills its bucket (8 or 16 tokens) and is tie-free along the
JAX decode path at that width.  The JAX engine serves them one at a time
at ``(2, 1)``, ``(1, 2)`` and ``(2, 2)`` on the 8 forced CPU devices; the
port's side runs in a JAX-free child (``helpers/torch_port.py``
``run_port_side``) where ``ServeConfig(mesh_shape=(tp, sp))`` spawns the
followers over gloo:

* at each shape the tokens equal the JAX engine's at that shape and the
  one-card port engine's, and the one-shot prefills split over ``sp``
  (``sp_prefills``): each expert's hidden units split over ``tp``, and a
  split prefill routes its block with the whole width's capacity and the
  slot prefix of the blocks before it;
* int8 weights with ``kv_quant`` at ``(2, 1)`` equal one card (and JAX's
  int8 decode path);
* the split prefill of an MoE layer on a caller's ``{sp: 2}`` and ``{sp:
  2, tp: 2}`` mesh is held per layer to JAX ``prefill_program``: K/V
  within 1e-5, the logits within 1e-4.

In-process: ``shard_lm``'s MoE shard (an ``mlp_hidden`` that tp 2 splits
unevenly, float and int8) against slicing the full params: ``wi``/``wg``
and their scales by column, ``wo`` by row with its scales whole, the
router whole, alike on every ``sp`` member.
"""

import concurrent.futures

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import generation as jax_gen
from cloud_tpu.models import transformer as jax_tf
from cloud_tpu.serving import ServeConfig as JaxServeConfig
from cloud_tpu.serving import ServingEngine as JaxServingEngine
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import moe, quantization
from cloud_tpu_torch.parallel import MeshSpec, sharding, tensor_parallel
from cloud_tpu_torch.serving import slice as slice_lib
from helpers.torch_port import (TINY_MOE, model_inputs, port_config,
                                run_port_side, tie_free_rows, tiny_models)
from test_torch_serving_sp import _on_ranks, _shape_id

torch.set_num_threads(1)

MAX_NEW = 6
SHAPES = ((2, 1), (1, 2), (2, 2))
#: Prompts fill their bucket: one of 8 tokens and one of 16; the int8
#: arm's one of 16.
BUCKETS = (8, 16)
LENS = (8, 16)
QUANT_LENS = (16,)
KEYS = ("completed", "chunks", "generated_tokens", "oneshot_inserts",
        "sp_prefills", "sp_whole_prefills")


def _rows(jcfg, jparams, lens, *, seed, kv_quant=False):
    """Tie-free prompts of ``lens``, each drawn at its own width (the
    MoE's capacity follows it)."""
    return [tie_free_rows(jcfg, jparams, [n], MAX_NEW, seed=seed + n,
                          kv_quant=kv_quant)[0] for n in lens]


_SPAWNED = """
import dataclasses
from cloud_tpu_torch.serving import ServeConfig, ServingEngine

cfg, params = port_model()
qcfg, qparams = port_model("quantized")


def rows(key):
    return [IN[k] for k in sorted(IN) if k.startswith(key + "/")]


serve = ServeConfig(max_new_tokens=MAX_NEW, prompt_buckets=BUCKETS,
                    num_slots=2, chunk_tokens=2)
for side, shape, model, key, kv_quant in (
        ("one", None, (cfg, params), "prompt", False),
        ("2x1", (2, 1), (cfg, params), "prompt", False),
        ("1x2", (1, 2), (cfg, params), "prompt", False),
        ("2x2", (2, 2), (cfg, params), "prompt", False),
        ("int8 one", None, (qcfg, qparams), "quant", True),
        ("int8 2x1", (2, 1), (qcfg, qparams), "quant", True)):
    with ServingEngine(model[1], model[0], dataclasses.replace(
            serve, mesh_shape=shape, kv_quant=kv_quant),
            device="cpu") as eng:
        res = [eng.submit(p).result(120) for p in rows(key)]
        stats = eng.stats()
    for i, r in enumerate(res):
        OUT[f"{side}/tokens/{i}"] = r.tokens
    OUT[f"{side}/stats"] = np.asarray([stats[k] for k in KEYS])
"""

_PREFILL = """
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import generation

mesh = MeshSpec(SIZES).build(devices=["cpu"] * WORLD)
cfg, _ = port_model()
shard = bridge.to_torch_shard(tree("params"), cfg, mesh, device="cpu")
cache, logits = generation.prefill_program(
    shard, torch.from_numpy(IN["tokens"]), torch.from_numpy(IN["lens"]),
    cfg, max_new_tokens=2)
OUT["k"], OUT["v"] = cache["k"].numpy(), cache["v"].numpy()
OUT["logits"] = logits.numpy()
"""
#: The caller meshes of the split prefill check.
PREFILL_SIZES = ({"sp": 2}, {"sp": 2, "tp": 2})


def _prefill_inputs(jcfg, jparams):
    rng = np.random.default_rng(41)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 16)).astype(np.int32)
    return {**model_inputs(jcfg, jparams), "tokens": tokens,
            "lens": np.asarray([16, 11], np.int32)}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """JAX's tokens and, computed beside them, the port's (futures)."""
    jcfg, jparams, _, _ = tiny_models(seed=5, num_layers=2,
                                      moe_cfg=TINY_MOE)
    _, qparams, _, _ = tiny_models(seed=5, num_layers=2, quantized=True,
                                   moe_cfg=TINY_MOE)
    prompts = _rows(jcfg, jparams, LENS, seed=50)
    quant = _rows(jcfg, qparams, QUANT_LENS, seed=60, kv_quant=True)
    inputs = {**model_inputs(jcfg, jparams),
              **model_inputs(jcfg, qparams, prefix="quantized")}
    for key, rows in (("prompt", prompts), ("quant", quant)):
        for i, p in enumerate(rows):
            inputs[f"{key}/{i:02d}"] = np.asarray(p, np.int32)
    prefill = _prefill_inputs(jcfg, jparams)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        port = {"spawned": pool.submit(
            run_port_side,
            f"MAX_NEW = {MAX_NEW}\nBUCKETS = {BUCKETS!r}\nKEYS = {KEYS!r}\n"
            + _SPAWNED, inputs, tmp_path_factory.mktemp("moe_slice"),
            timeout=300)}
        for sizes in PREFILL_SIZES:
            port[tuple(sizes.items())] = pool.submit(
                _on_ranks, f"SIZES = {sizes!r}\n" + _PREFILL,
                int(np.prod(list(sizes.values()))), prefill,
                tmp_path_factory.mktemp("moe_prefill"))
        engine = {}
        for shape in SHAPES:
            serve = JaxServeConfig(max_new_tokens=MAX_NEW,
                                   prompt_buckets=BUCKETS, num_slots=2,
                                   chunk_tokens=2, mesh_shape=shape)
            with JaxServingEngine(jparams, jcfg, serve) as eng:
                engine[shape] = [np.asarray(eng.submit(p).result(300).tokens)
                                 for p in prompts]
        quant_want = [jax_gen_tokens(jcfg, qparams, q) for q in quant]
        yield {"engine": engine, "quant": quant_want, "port": port,
               "jax": (jcfg, jparams), "prefill": prefill}


def jax_gen_tokens(jcfg, params, prompt):
    """JAX ``generate``'s greedy tokens with an int8 KV cache, the prompt
    at its own width (its bucket)."""
    out = jax_gen.generate(params, jnp.asarray(prompt)[None],
                           jnp.asarray([len(prompt)], np.int32), jcfg,
                           max_new_tokens=MAX_NEW, kv_quant=True)
    return np.asarray(out["tokens"])[0]


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_moe_slice_matches_jax_engine_and_one_card(served, shape):
    out = served["port"]["spawned"].result()
    side = _shape_id(shape)
    for i, want in enumerate(served["engine"][shape]):
        np.testing.assert_array_equal(out[f"{side}/tokens/{i}"], want,
                                      err_msg=f"{side} request {i}")
        np.testing.assert_array_equal(out[f"{side}/tokens/{i}"],
                                      out[f"one/tokens/{i}"])
    stats = dict(zip(KEYS, out[f"{side}/stats"]))
    one = dict(zip(KEYS, out["one/stats"]))
    for key in ("completed", "chunks", "generated_tokens",
                "oneshot_inserts"):
        assert stats[key] == one[key], key
    split = len(LENS) if shape[1] > 1 else 0
    assert (stats["sp_prefills"], stats["sp_whole_prefills"]) == (split, 0)


def test_int8_moe_with_kv_quant_at_tp2_matches_one_card(served):
    out = served["port"]["spawned"].result()
    for i, want in enumerate(served["quant"]):
        np.testing.assert_array_equal(out[f"int8 2x1/tokens/{i}"],
                                      out[f"int8 one/tokens/{i}"])
        np.testing.assert_array_equal(out[f"int8 one/tokens/{i}"], want)
    np.testing.assert_array_equal(out["int8 2x1/stats"],
                                  out["int8 one/stats"])


@pytest.mark.parametrize("sizes", PREFILL_SIZES,
                         ids=lambda s: "-".join(f"{k}{v}"
                                                for k, v in s.items()))
def test_moe_split_prefill_matches_jax_prefill_program(served, sizes):
    jcfg, jparams = served["jax"]
    inputs = served["prefill"]
    cache, logits = jax_gen.prefill_program(
        jparams, jnp.asarray(inputs["tokens"]), jnp.asarray(inputs["lens"]),
        jcfg, max_new_tokens=2)
    tp = sizes.get("tp", 1)
    heads = jcfg.num_heads // tp
    for rank, out in enumerate(served["port"][tuple(sizes.items())].result()):
        h0 = (rank % tp) * heads  # tp minor: rank % tp is the tp index
        for name in ("k", "v"):
            np.testing.assert_allclose(
                out[name], np.asarray(cache[name])[..., h0:h0 + heads, :],
                rtol=0, atol=1e-5, err_msg=f"rank {rank} {name}")
        np.testing.assert_allclose(out["logits"], np.asarray(logits),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_shard_lm_cuts_moe_leaves_as_slicing_the_full_params(quantized):
    """tp 2 over an mlp_hidden of 129 (65 / 64 hidden units a rank), sp 2:
    every rank's expert leaves against the full ones sliced."""
    jcfg = jax_tf.TINY.scaled(dtype=jnp.float32, num_layers=1,
                              mlp_hidden=129, moe=TINY_MOE)
    cfg = port_config(jcfg)
    params = bridge.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    if quantized:
        params = quantization.quantize_params(params)
    spec = MeshSpec({"sp": 2, "tp": 2})
    full = params["layers"][0]["mlp"]
    assert set(full) >= {"router", "wi_q" if quantized else "wi"}
    for view in slice_lib.shard_views(spec, ["cpu"] * 4, "gloo"):
        shard = tensor_parallel.shard_lm(params, cfg, view)
        ctx = shard["tp"]
        assert (ctx.size, ctx.sp_size, ctx.seq_split) == (2, 2, False)
        start, stop = sharding.shard_bounds(129, 2, ctx.index)
        mlp = shard["layers"][0]["mlp"]
        torch.testing.assert_close(mlp["router"], full["router"],
                                   rtol=0, atol=0)
        for name, leaf in full.items():
            if name == "router":
                continue
            base = name.split("_")[0]
            if base == "wo":
                want = (leaf if name.endswith("_scale")
                        else leaf[:, start:stop])
            else:
                want = leaf[..., start:stop]
            torch.testing.assert_close(mlp[name], want, rtol=0, atol=0,
                                       msg=f"{name} rank {view.rank}")
        assert mlp["wi_q" if quantized else "wi"].shape[-1] == stop - start


def test_moe_serving_context_routes_whole_widths_alone():
    """Outside a split prefill the slice's MoE layer routes the call's
    width on every rank (capacity from it, no slot offsets)."""
    spec = MeshSpec({"sp": 2})
    view = slice_lib.shard_views(spec, ["cpu"] * 2, "gloo")[1]
    cfg = moe.MoeConfig(num_experts=4, top_k=2)
    ctx = tensor_parallel.TensorParallel(mesh=view)
    assert not ctx.seq_split and not ctx.experts_split
    params = bridge.init(port_config(jax_tf.TINY.scaled(
        dtype=jnp.float32, num_layers=1, moe=TINY_MOE)),
        torch.Generator().manual_seed(4), device="cpu")["layers"][0]["mlp"]
    x = torch.randn(2, 6, 64, generator=torch.Generator().manual_seed(5))
    out, aux = moe.moe_mlp_apply(params, x, cfg, ctx=ctx, aux=False)
    want, _ = moe.moe_mlp_apply(params, x, cfg)
    assert aux is None
    torch.testing.assert_close(out, want, rtol=0, atol=0)
