"""The port's MoE CloudLM on the CPU, against the JAX package.

- ``moe_mlp_apply`` alone (4 experts, 16 wide, hidden 32) against JAX's
  with top-2 at a T where tokens are dropped (asserted), with the z-loss
  on, top-1 at capacity 2.0, and a router whose logits tie (the lower
  expert index wins, as in ``jax.lax.top_k``): output and aux within
  1e-5, gradients to the params and x within 1e-5 of their largest
  magnitude;
- the MoE CloudLM TINY (2 layers, 4 experts, top 2, f32): logits within
  1e-4, ``loss_fn``'s loss, ce, aux and every gradient (both CE branches,
  remat "full") within 1e-5 relative and 1e-5 of the largest gradient,
  three AdamW steps on JAX's trajectory within 1e-4;
- greedy ``generate`` token-identical to JAX's on prompts whose decode
  path is tie-free;
- the engine's programs (insert at the bucket's width, prefill chunks of
  4, a verify window of 3, where capacity is 2 a row) against JAX's on the
  same padded inputs: K/V within 1e-5, logits within 1e-4, tokens and
  slot state exactly;
- the engine, one request at a time (the port's side in a child process
  that never imports JAX), on the continuous route, with the prefix cache
  and chunked prefill on the copy and the attach route, token-identical
  to the JAX engine on the same route, and on the continuous route to JAX
  ``generate`` on prompts padded to the bucket (the same T, so the same
  capacity);
- int8 experts: the port's ``quantize_params`` gives JAX's leaves (one
  scale per expert and output channel) and the quantized model's logits
  equal JAX's within 1e-4.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cloud_tpu.models import generation as jax_gen
from cloud_tpu.models import moe as jax_moe
from cloud_tpu.models import quantization as jax_quant
from cloud_tpu.models import transformer as jax_tf
from cloud_tpu.serving import ServeConfig as JaxServeConfig
from cloud_tpu.serving import ServingEngine as JaxServingEngine
from cloud_tpu.training import train as jax_train
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import generation, moe, quantization, transformer
from cloud_tpu_torch.training import optimizers, train
from helpers.torch_port import (
    TINY_MOE,
    decode_path_gaps,
    model_inputs,
    port_config,
    port_moe,
    run_port_side,
    TIE_GAP,
    tiny_models,
)

torch.set_num_threads(1)

ATOL = 1e-5
MAX_NEW = 6


def _tree_close(got, want, rel, what=""):
    want_leaves = jax.tree_util.tree_leaves(want)
    got_leaves = jax.tree_util.tree_leaves(got)
    assert len(got_leaves) == len(want_leaves)
    scale = max(np.abs(np.asarray(w)).max() for w in want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=rel * scale, err_msg=what)


# ---------------------------------------------------------------------------
# moe_mlp_apply.

#: case -> (MoeConfig fields, T, zero router): "drop" drops choices past
#: capacity; "tied" zeroes the router so every gate is 1/E.
MLP_CASES = {
    "drop": (dict(num_experts=4, top_k=2), 8, False),
    "drop-zloss": (dict(num_experts=4, top_k=2, z_loss_weight=1e-3), 8,
                   False),
    "top1": (dict(num_experts=4, top_k=1, capacity_factor=2.0), 16, False),
    "tied": (dict(num_experts=4, top_k=2), 12, True),
}


def _mlp_inputs(case):
    fields, t, zero_router = MLP_CASES[case]
    jcfg = jax_moe.MoeConfig(**fields)
    params, _ = jax_moe.moe_mlp_init(jax.random.PRNGKey(3), 16, 32, jcfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    if zero_router:
        params["router"]["kernel"] = np.zeros_like(
            params["router"]["kernel"])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, t, 16)).astype(np.float32)
    cot = rng.standard_normal((2, t, 16)).astype(np.float32)
    return jcfg, params, x, cot


def _dropped(params, x, cfg):
    """How many (token, choice) pairs the port's routing drops."""
    logits = torch.from_numpy(x) @ torch.from_numpy(
        np.array(params["router"]["kernel"]))
    _, idx = moe._top_k(torch.softmax(logits, -1), cfg.top_k)
    mask = torch.nn.functional.one_hot(idx, cfg.num_experts).float()
    flat = mask.reshape(x.shape[0], -1, cfg.num_experts)
    pos = torch.cumsum(flat, 1) - flat
    c = moe._capacity(x.shape[1], cfg)
    return int(((pos >= c) & (flat > 0)).sum())


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_moe_mlp_matches_jax(case):
    jcfg, params, x, cot = _mlp_inputs(case)

    def jax_obj(p, x):
        out, aux = jax_moe.moe_mlp_apply(p, x, jcfg)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (want_out, want_aux)), (want_gp, want_gx) = jax.value_and_grad(
        jax_obj, argnums=(0, 1), has_aux=True)(params, x)
    cfg = port_moe(jcfg)
    tparams = bridge.map_leaves(
        params, lambda a: torch.from_numpy(np.array(a)).requires_grad_(True))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_mlp_apply(tparams, tx, cfg)
    ((out * torch.from_numpy(cot)).sum() + aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(aux.detach()), float(want_aux), rtol=0,
                               atol=ATOL)
    _tree_close(bridge.map_leaves(tparams, lambda t: t.grad.numpy()),
                want_gp, 1e-5, "param grads")
    _tree_close(tx.grad.numpy(), want_gx, 1e-5, "x grad")


@pytest.mark.parametrize("case", ["drop", "drop-zloss", "tied"])
def test_moe_cases_drop_tokens(case):
    """The top-2 cases run past an expert's capacity, so the parity above
    holds the dropping path."""
    jcfg, params, x, _ = _mlp_inputs(case)
    assert _dropped(params, x, port_moe(jcfg)) > 0


def test_tied_router_picks_lower_experts():
    cfg = moe.MoeConfig(num_experts=4, top_k=2)
    gates = torch.full((1, 3, 4), 0.25)
    values, idx = moe._top_k(gates, cfg.top_k)
    assert idx.tolist() == [[[0, 1]] * 3]
    np.testing.assert_array_equal(values.numpy(), np.full((1, 3, 2), 0.25))
    want = jax.lax.top_k(jnp.full((1, 3, 4), 0.25), 2)[1]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))


def test_capacity_matches_jax():
    for fields in ({}, dict(num_experts=4, top_k=2),
                   dict(num_experts=4, top_k=1, capacity_factor=2.0)):
        for t in (1, 3, 4, 24, 128, 1024):
            assert moe._capacity(t, moe.MoeConfig(**fields)) == \
                jax_moe._capacity(t, jax_moe.MoeConfig(**fields))
    assert moe.moe_mlp_axes() == jax_moe.moe_mlp_axes()


# ---------------------------------------------------------------------------
# The MoE CloudLM.


@functools.lru_cache(maxsize=None)
def _models(seed=0, quantized=False):
    """The MoE TINY models, JAX's params as numpy (a JAX train step
    donates its state's arrays)."""
    jcfg, params, cfg, tparams = tiny_models(
        seed=seed, num_layers=2, quantized=quantized, moe_cfg=TINY_MOE)
    return jcfg, jax.tree_util.tree_map(np.asarray, params), cfg, tparams


def _tokens(b=2, t=24, seed=9):
    return np.random.default_rng(seed).integers(1, 256, (b, t)).astype(
        np.int32)


def test_moe_lm_logits_match_jax():
    jcfg, params, cfg, tparams = _models()
    tokens = _tokens()
    want, want_aux = jax_tf.apply(params, jnp.asarray(tokens), jcfg)
    got, aux = transformer.apply(tparams, torch.from_numpy(tokens), cfg,
                                 device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    assert float(aux) > 0


@pytest.mark.parametrize("fused_ce", [False, True])
def test_moe_lm_loss_and_grads_match_jax(fused_ce):
    jcfg, params, _, _ = _models()
    jcfg = jcfg.scaled(remat=True, fused_ce=fused_ce)
    batch = {"tokens": _tokens()}
    (want_loss, want_m), want = jax.value_and_grad(
        functools.partial(jax_tf.loss_fn, config=jcfg), has_aux=True)(
            params, batch)
    cfg = port_config(jcfg)
    tparams = bridge.map_leaves(bridge.to_torch(params, cfg, device="cpu"),
                                lambda t: t.requires_grad_(True))
    loss, metrics = transformer.loss_fn(
        tparams, {"tokens": torch.from_numpy(batch["tokens"])}, cfg,
        device="cpu")
    loss.backward()
    for key in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(want_m[key]), rtol=1e-5,
                                   err_msg=key)
    _tree_close(bridge.to_numpy(bridge.map_leaves(tparams,
                                                  lambda t: t.grad)),
                want, 1e-5)


def test_moe_three_adamw_steps_match_jax_trajectory():
    jcfg, params, _, _ = _models()
    jcfg = jcfg.scaled(remat=True)
    batch = {"tokens": _tokens()}
    jtx = optax.adamw(1e-3)
    jstate = jax_train.create_sharded_state(
        jax.random.PRNGKey(0), lambda _: params, jtx, mesh=None)
    jstep = jax_train.make_train_step(
        functools.partial(jax_tf.loss_fn, config=jcfg), jtx)
    cfg = port_config(jcfg)
    tx = optimizers.adamw(1e-3, mu_dtype=None)
    state = train.create_sharded_state(
        None, lambda _: bridge.to_torch(params, cfg, device="cpu"), tx,
        device="cpu")
    step = train.make_train_step(
        functools.partial(transformer.loss_fn, config=cfg, device="cpu"), tx)
    tbatch = {"tokens": torch.from_numpy(batch["tokens"])}
    for i in range(3):
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, tbatch)
        for key in ("loss", "grad_norm", "aux"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, err_msg=f"{key} step {i}")


def _tie_free(jcfg, params, n, width, seed, head_len=0):
    """``n`` prompts of lengths in (width/2, width], padded to ``width``
    (their first ``head_len`` tokens shared), whose JAX decode path at
    that width is tie-free; and JAX's tokens."""
    rng = np.random.default_rng(seed)
    cands = rng.integers(1, jcfg.vocab_size, (4 * n, width)).astype(np.int32)
    cands[:, :head_len] = cands[0, :head_len]
    lens = rng.integers(width // 2 + 1, width + 1, 4 * n).astype(np.int32)
    gaps, tokens = decode_path_gaps(jcfg, params, cands, lens, MAX_NEW)
    rows = np.flatnonzero(gaps > TIE_GAP)[:n]
    assert len(rows) == n, "not enough tie-free prompts"
    return cands[rows], lens[rows], tokens[rows]


def test_moe_generate_token_identical_to_jax():
    jcfg, params, cfg, tparams = _models()
    prompts, lens, want = _tie_free(jcfg, params, 4, 12, seed=3)
    jax_tokens = jax_gen.generate(params, jnp.asarray(prompts),
                                  jnp.asarray(lens), jcfg,
                                  max_new_tokens=MAX_NEW)["tokens"]
    np.testing.assert_array_equal(np.asarray(jax_tokens), want)
    got = generation.generate(tparams, torch.from_numpy(prompts),
                              torch.from_numpy(lens), cfg,
                              max_new_tokens=MAX_NEW, device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(), want)


# ---------------------------------------------------------------------------
# The engine's programs.

GRID_SLOTS, GRID_LEN, BUCKET, SPEC_K = 3, 24, 16, 3


def _close(port_tree, jax_tree, what):
    for name, leaf in port_tree.items():
        np.testing.assert_allclose(leaf.float().numpy(),
                                   np.asarray(jax_tree[name], np.float32),
                                   rtol=0, atol=ATOL, err_msg=f"{what} {name}")


def _armed_grids():
    """Both sides' grid and state after inserting two prompts at the
    bucket's width (slot 1 never armed)."""
    jcfg, params, cfg, tparams = _models()
    prompts = _tokens(b=GRID_SLOTS, t=BUCKET, seed=31)
    jcache = jax_gen.init_slot_cache(jcfg, GRID_SLOTS, GRID_LEN)
    jstate = jax_gen.init_slot_state(jcfg, GRID_SLOTS)
    cache = generation.init_slot_cache(cfg, GRID_SLOTS, GRID_LEN,
                                       device="cpu")
    state = generation.init_slot_state(cfg, GRID_SLOTS, device="cpu")
    for slot, n in ((0, 13), (2, 7)):
        tokens = prompts[slot:slot + 1]
        jcache, jstate, _ = jax_gen.insert_slot_program(
            params, jcache, jstate, jnp.asarray(tokens), n, slot, MAX_NEW,
            jcfg)
        cache, state, _ = generation.insert_slot_program(
            tparams, cache, state, torch.from_numpy(tokens), n, slot,
            MAX_NEW, cfg)
    return (jcfg, params, jcache, jstate), (cfg, tparams, cache, state)


def test_moe_insert_program_matches_jax():
    (_, _, jcache, jstate), (_, _, cache, state) = _armed_grids()
    _close(cache, jcache, "grid after the inserts")
    for name, value in state.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(jstate[name]),
                                      err_msg=name)


def test_moe_decode_chunk_program_matches_jax():
    (jcfg, params, jcache, jstate), (cfg, tparams, cache, state) = \
        _armed_grids()
    jout = jax_gen.decode_chunk_program(params, jcache, jstate, jcfg,
                                        chunk_size=3)
    out = generation.decode_chunk_program(tparams, cache, state, cfg,
                                          chunk_size=3)
    _close(out[0], jout[0], "grid after the chunk")
    for name, value in out[1].items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(jout[1][name]),
                                      err_msg=name)
    for got, want in zip(out[2:], jout[2:]):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_moe_prefill_chunk_program_matches_jax():
    """A 13-token prompt in chunks of 4 into slot 1: each chunk routes at
    T=4 (capacity 2 a row)."""
    jcfg, params, cfg, tparams = _models()
    prompt = _tokens(b=1, t=13, seed=13)[0]
    jcache = jax_gen.init_slot_cache(jcfg, 2, GRID_LEN)
    cache = generation.init_slot_cache(cfg, 2, GRID_LEN, device="cpu")
    for start in range(0, len(prompt), 4):
        clen = min(4, len(prompt) - start)
        tokens = np.zeros((1, 4), np.int32)
        tokens[0, :clen] = prompt[start:start + clen]
        jcache, jlogits = jax_gen.prefill_chunk_program(
            params, jcache, jnp.asarray(tokens), start, clen, 1, jcfg)
        cache, logits = generation.prefill_chunk_program(
            tparams, cache, torch.from_numpy(tokens), start, clen, 1, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=0, atol=1e-4)
    _close(cache, jcache, "grid after the chunks")


def test_moe_verify_program_matches_jax():
    """One verify of a window of 3 (capacity 2 a row: choices drop)."""
    (jcfg, params, jcache, jstate), (cfg, tparams, cache, state) = \
        _armed_grids()
    rng = np.random.default_rng(7)
    window = rng.integers(1, jcfg.vocab_size, (GRID_SLOTS, SPEC_K)).astype(
        np.int32)
    window[:, 0] = np.asarray(jstate["tok"])
    jcache, jstate, jtoks, jvalid = jax_gen.verify_chunk_program(
        params, jcache, jstate, jnp.asarray(window), jcfg)
    pcache, pstate, ptoks, pvalid = generation.verify_chunk_program(
        tparams, cache, state, torch.from_numpy(window), cfg)
    np.testing.assert_array_equal(ptoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
    for name, value in pstate.items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(jstate[name]),
                                      err_msg=name)
    _close(pcache, jcache, "grid after the verify")
    assert moe._capacity(SPEC_K, cfg.moe) == 2


# ---------------------------------------------------------------------------
# The engine, one request at a time.

PREFIX = dict(prefix_cache_blocks=8, prefix_block_tokens=4,
              prefill_chunk_tokens=4)
ROUTES = {"continuous": {},
          "prefix-copy": dict(PREFIX, decode_kernel="xla"),
          "prefix-attach": dict(PREFIX, decode_kernel="pallas")}


def _serve(**kw):
    return dict(max_new_tokens=MAX_NEW, prompt_buckets=(BUCKET,),
                num_slots=2, chunk_tokens=3, **kw)


_PORT_SIDE = """
from cloud_tpu_torch.serving import ServeConfig, ServingEngine

cfg, params = port_model()
prompts = [IN["prompts"][i, :n] for i, n in enumerate(IN["lens"])]
for label, serve in json.loads(str(IN["routes"])).items():
    engine = ServingEngine(params, cfg, ServeConfig(**serve), device="cpu")
    results = [engine.submit(p).result(timeout=300) for p in prompts]
    engine.close()
    stats = engine.stats()
    OUT[label + ".tokens"] = np.stack([r.tokens for r in results])
    OUT[label + ".counts"] = np.array([stats["prefix_hits"],
                                       stats["prefill_chunks"]])
"""


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    """Prompts sharing an 8-token head, tie-free on JAX's decode path at
    the bucket's width; JAX ``generate`` on them padded to the bucket, the
    JAX engine's tokens on every route, and the port's."""
    jcfg, params, _, _ = _models()
    prompts, lens, want = _tie_free(jcfg, params, 4, BUCKET, seed=41,
                                    head_len=8)
    jax_runs = {}
    for label, kw in ROUTES.items():
        engine = JaxServingEngine(params, jcfg, JaxServeConfig(**_serve(**kw)))
        results = [engine.submit(prompts[i, :n]).result(timeout=300)
                   for i, n in enumerate(lens)]
        engine.close()
        stats = engine.stats()
        jax_runs[label] = (np.stack([r.tokens for r in results]),
                           np.array([stats["prefix_hits"],
                                     stats["prefill_chunks"]]))
    routes = {label: _serve(**kw) for label, kw in ROUTES.items()}
    got = run_port_side(_PORT_SIDE, dict(
        model_inputs(jcfg, params), prompts=prompts, lens=lens,
        routes=np.asarray(json.dumps(routes))),
        tmp_path_factory.mktemp("moe_engine"))
    return want, jax_runs, got


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_moe_engine_matches_jax_engine(engine_runs, route):
    _, jax_runs, got = engine_runs
    jax_tokens, jax_counts = jax_runs[route]
    np.testing.assert_array_equal(got[route + ".tokens"], jax_tokens)
    np.testing.assert_array_equal(got[route + ".counts"], jax_counts)
    if route != "continuous":
        assert got[route + ".counts"].min() > 0  # hits and chunks ran


def test_moe_continuous_engine_equals_generate_at_the_bucket(engine_runs):
    want, _, got = engine_runs
    np.testing.assert_array_equal(got["continuous.tokens"], want)


# ---------------------------------------------------------------------------
# int8 experts.


def test_port_quantizes_experts_as_jax():
    jcfg, params, cfg, tparams = _models()
    want = bridge.to_torch(jax_quant.quantize_params(params), cfg,
                           device="cpu")
    got = quantization.quantize_params(tparams)
    mlp = got["layers"][0]["mlp"]
    assert set(mlp) == {"router", "wi_q", "wi_scale", "wg_q", "wg_scale",
                        "wo_q", "wo_scale"}
    assert mlp["wi_q"].dtype == torch.int8
    assert tuple(mlp["wi_scale"].shape) == (4, 1, cfg.mlp_hidden)
    assert tuple(mlp["wo_scale"].shape) == (4, 1, cfg.dim)
    for a, b in zip(bridge.leaves(got), bridge.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_int8_experts_logits_match_jax():
    jcfg, qparams, cfg, tparams = _models(quantized=True)
    assert "wi_q" in qparams["layers"]["mlp"]
    tokens = _tokens()
    want, want_aux = jax_tf.apply(qparams, jnp.asarray(tokens), jcfg)
    got, aux = transformer.apply(tparams, torch.from_numpy(tokens), cfg,
                                 device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_moe_remat_policies_bit_identical():
    """Remat "none", "full" and "dots" give the MoE LM's loss, aux and
    gradients bit for bit (the expert products are batched, so "dots"
    recomputes them)."""
    jcfg, params, cfg, _ = _models()
    batch = {"tokens": torch.from_numpy(_tokens())}
    runs = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        c = cfg.scaled(remat=remat, remat_policy=policy)
        tparams = bridge.map_leaves(bridge.to_torch(params, c, device="cpu"),
                                    lambda t: t.requires_grad_(True))
        loss, metrics = transformer.loss_fn(tparams, batch, c, device="cpu")
        loss.backward()
        runs.append((float(loss.detach()), float(metrics["aux"].detach()),
                     bridge.leaves(bridge.map_leaves(tparams,
                                                     lambda t: t.grad))))
    for loss, aux, grads in runs[1:]:
        assert (loss, aux) == runs[0][:2]
        for a, b in zip(grads, runs[0][2]):
            assert torch.equal(a, b)
