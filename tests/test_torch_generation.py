"""The port's generation path against the JAX package's, on the CPU.

Greedy decoding is held token for token on TINY in f32, on seeded prompts
whose greedy path is tie-free (top-2 logit gap > 1e-3).  The slot-grid
programs are held state, tokens and cache against JAX on the same grid.
Sampling cannot match ``jax.random`` draw for draw, so it is held through
the filtered support on fixed logits.  The quantized path (JAX
``quantize_params`` weights, ``kv_quant=True``) is held the same way on
prompts that are tie-free along JAX's own quantized decode path, and
``beam_search`` against JAX's, full precision and quantized, with and
without eos.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import generation as jax_gen
from cloud_tpu_torch.models import generation
from cloud_tpu_torch.utils import benchmarking
from helpers.torch_port import tie_free_prompts, tiny_models

torch.set_num_threads(1)

N_NEW = 10


@pytest.fixture(scope="module")
def models():
    return tiny_models(seed=0, num_layers=2)


@pytest.fixture(scope="module")
def prompts(models):
    jax_cfg, params, _, _ = models
    return tie_free_prompts(jax_cfg, params, batch=3, max_len=12,
                            max_new_tokens=N_NEW, seed=100)


def test_greedy_generate_token_identical(models, prompts):
    jax_cfg, params, cfg, tparams = models
    toks, lens, jax_tokens = prompts
    want = jax_gen.generate(params, jnp.asarray(toks), jnp.asarray(lens),
                            jax_cfg, max_new_tokens=N_NEW)
    got = generation.generate(tparams, torch.from_numpy(toks),
                              torch.from_numpy(lens), cfg,
                              max_new_tokens=N_NEW, device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(), jax_tokens)
    np.testing.assert_array_equal(got["sequences"].numpy(),
                                  np.asarray(want["sequences"]))
    np.testing.assert_array_equal(got["num_generated"].numpy(),
                                  np.asarray(want["num_generated"]))


def test_greedy_generate_with_eos_matches_jax(models, prompts):
    """eos is a token of one row's greedy path that did not occur earlier
    in it, so it cannot end that row before the step that samples it."""
    jax_cfg, params, cfg, tparams = models
    toks, lens, jax_tokens = prompts
    r, idx = next((r, i) for r in range(len(jax_tokens))
                  for i in range(1, N_NEW)
                  if jax_tokens[r, i] not in jax_tokens[r, :i])
    eos = int(jax_tokens[r, idx])
    sample = generation.SampleConfig(temperature=0.0, eos_id=eos)
    want = jax_gen.generate(
        params, jnp.asarray(toks), jnp.asarray(lens), jax_cfg,
        max_new_tokens=N_NEW,
        sample=jax_gen.SampleConfig(temperature=0.0, eos_id=eos))
    got = generation.generate(tparams, torch.from_numpy(toks),
                              torch.from_numpy(lens), cfg,
                              max_new_tokens=N_NEW, sample=sample,
                              device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["num_generated"].numpy(),
                                  np.asarray(want["num_generated"]))
    assert int(got["num_generated"][r]) == idx + 1


def _compare_grid(jax_cache, jax_state, cache, state):
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jax_cache[name]), atol=1e-5)
    for name in ("pos", "tok", "remaining", "emitted", "active"):
        np.testing.assert_array_equal(state[name].numpy(),
                                      np.asarray(jax_state[name]), name)


def test_slot_programs_match_jax(models, prompts):
    """Insert two requests, decode a chunk, insert a third into the free
    slot, decode two more chunks: state, emissions and cache agree."""
    jax_cfg, params, cfg, tparams = models
    toks, lens, _ = prompts
    num_slots, bucket, max_len, chunk = 3, 16, 16 + N_NEW, 4
    budgets = [N_NEW, 5, 7]
    jcache = jax_gen.init_slot_cache(jax_cfg, num_slots, max_len)
    jstate = jax_gen.init_slot_state(jax_cfg, num_slots)
    cache = generation.init_slot_cache(cfg, num_slots, max_len, device="cpu")
    state = generation.init_slot_state(cfg, num_slots, device="cpu")

    def insert(req, slot):
        nonlocal jcache, jstate, cache, state
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :lens[req]] = toks[req, :lens[req]]
        jcache, jstate, jtok = jax_gen.insert_slot_program(
            params, jcache, jstate, jnp.asarray(padded), int(lens[req]),
            slot, budgets[req], jax_cfg)
        cache, state, tok = generation.insert_slot_program(
            tparams, cache, state, torch.from_numpy(padded), int(lens[req]),
            slot, budgets[req], cfg)
        assert int(tok) == int(jtok)

    def chunk_step():
        nonlocal jcache, jstate, cache, state
        jcache, jstate, jtoks, jvalid = jax_gen.decode_chunk_program(
            params, jcache, jstate, jax_cfg, chunk_size=chunk)
        cache, state, ptoks, pvalid, summary = generation.decode_chunk_program(
            tparams, cache, state, cfg, chunk_size=chunk, with_summary=True,
            block_table=torch.full((num_slots, 4), -1, dtype=torch.int32))
        np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(ptoks.numpy(), np.asarray(jtoks))
        assert summary.tolist() == [int(np.asarray(jvalid).sum()),
                                    int(np.asarray(jstate["active"]).sum())]
        _compare_grid(jcache, jstate, cache, state)

    insert(0, 0)
    insert(1, 2)
    _compare_grid(jcache, jstate, cache, state)
    chunk_step()
    insert(2, 1)
    chunk_step()
    chunk_step()


@pytest.mark.parametrize("chunk_causal", [False, True])
def test_cache_attention_plain_matches_jax(chunk_causal):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 3, 2, 16)).astype(np.float32)
    cache = {n: rng.standard_normal((2, 20, 2, 16)).astype(np.float32)
             for n in ("k", "v")}
    cur_len = np.array([4, 17], np.int32)
    got = generation._cache_attention(
        torch.from_numpy(q), {k: torch.from_numpy(v) for k, v in cache.items()},
        torch.from_numpy(cur_len), chunk_causal=chunk_causal)
    want = jax_gen._cache_attention(q, cache, cur_len,
                                    chunk_causal=chunk_causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(temperature=0.7, top_k=5),
    dict(temperature=1.3, top_p=0.6),
    dict(temperature=1.0, top_k=8, top_p=0.8),
])
def test_sampling_support_matches_jax(kw):
    """The set of tokens JAX draws over many keys equals the port's
    filtered support, and the port's own draws stay inside it."""
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((1, 40)) * 2.0).astype(np.float32)
    filtered = generation.filter_logits(torch.from_numpy(logits),
                                        generation.SampleConfig(**kw))
    support = set(np.flatnonzero(np.isfinite(filtered.numpy()[0])).tolist())
    keys = jax.random.split(jax.random.PRNGKey(0), 2000)
    draws = jax.vmap(lambda key: jax_gen.sample_logits(
        key, jnp.asarray(logits), jax_gen.SampleConfig(**kw)))(keys)
    assert set(np.asarray(draws).ravel().tolist()) == support
    gen = torch.Generator().manual_seed(0)
    ours = [int(generation.sample_logits(
        torch.from_numpy(logits), generation.SampleConfig(**kw),
        generator=gen)[0]) for _ in range(200)]
    assert set(ours) <= support


def test_greedy_penalty_and_eos_gate_match_jax():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((4, 30)).astype(np.float32)
    seen = rng.random((4, 30)) > 0.7
    allow = np.array([True, False, True, False])
    argmax = logits.argmax(-1)
    kw = dict(temperature=0.0, repetition_penalty=1.7,
              eos_id=int(argmax[1]), min_new_tokens=2)
    got = generation.sample_logits(
        torch.from_numpy(logits), generation.SampleConfig(**kw),
        seen=torch.from_numpy(seen), allow_eos=torch.from_numpy(allow))
    want = jax_gen.sample_logits(
        jax.random.PRNGKey(0), jnp.asarray(logits),
        jax_gen.SampleConfig(**kw), seen=jnp.asarray(seen),
        allow_eos=jnp.asarray(allow))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_non_greedy_generate_needs_generator(models):
    _, _, cfg, tparams = models
    for kv_quant in (False, True):
        with pytest.raises(ValueError, match="Generator"):
            generation.generate(
                tparams, torch.ones((1, 4), dtype=torch.int32),
                torch.tensor([4]), cfg, max_new_tokens=2,
                sample=generation.SampleConfig(temperature=1.0),
                kv_quant=kv_quant, device="cpu")


@pytest.fixture(scope="module")
def qmodels():
    return tiny_models(seed=3, num_layers=2, quantized=True)


@pytest.fixture(scope="module")
def qprompts(qmodels):
    jax_cfg, params, _, _ = qmodels
    return tie_free_prompts(jax_cfg, params, batch=3, max_len=12,
                            max_new_tokens=N_NEW, seed=300, kv_quant=True)


def test_quantized_generate_token_identical(qmodels, qprompts):
    """int8 weights and an int8 KV cache: tokens, sequences and counts
    equal JAX's ``generate(..., kv_quant=True)``."""
    jax_cfg, params, cfg, tparams = qmodels
    toks, lens, jax_tokens = qprompts
    assert tparams["layers"][0]["mlp"]["wi"]["kernel_q"].dtype == torch.int8
    want = jax_gen.generate(params, jnp.asarray(toks), jnp.asarray(lens),
                            jax_cfg, max_new_tokens=N_NEW, kv_quant=True)
    np.testing.assert_array_equal(np.asarray(want["tokens"]), jax_tokens)
    got = generation.generate(tparams, torch.from_numpy(toks),
                              torch.from_numpy(lens), cfg,
                              max_new_tokens=N_NEW, kv_quant=True,
                              device="cpu")
    np.testing.assert_array_equal(got["tokens"].numpy(), jax_tokens)
    np.testing.assert_array_equal(got["sequences"].numpy(),
                                  np.asarray(want["sequences"]))
    np.testing.assert_array_equal(got["num_generated"].numpy(),
                                  np.asarray(want["num_generated"]))


def test_quantized_insert_writes_jax_cache(qmodels, qprompts):
    """The insert quantizes the prompt's K/V as JAX does: on the same raw
    k/v the int8 leaves and scales are bit-identical; end to end (each
    side's own prefill) the scales agree to f32 rounding and an int8
    value moves by at most one step, where a k on a rounding boundary
    differs in its last bit."""
    jax_cfg, params, cfg, tparams = qmodels
    toks, lens, _ = qprompts
    bucket, max_len = 16, 16 + N_NEW
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :lens[0]] = toks[0, :lens[0]]
    jcache = jax_gen.init_slot_cache(jax_cfg, 2, max_len, kv_quant=True)
    jcache, _, jtok = jax_gen.insert_slot_program(
        params, jcache, jax_gen.init_slot_state(jax_cfg, 2),
        jnp.asarray(padded), int(lens[0]), 1, N_NEW, jax_cfg)
    cache = generation.init_slot_cache(cfg, 2, max_len, device="cpu",
                                       kv_quant=True)
    assert cache["k"].dtype == torch.int8
    assert cache["k_scale"].shape == (cfg.num_layers, 2, max_len,
                                      cfg.num_heads, 1)
    cache, _, tok = generation.insert_slot_program(
        tparams, cache, generation.init_slot_state(cfg, 2, device="cpu"),
        torch.from_numpy(padded), int(lens[0]), 1, N_NEW, cfg)
    assert int(tok) == int(jtok)
    for name in ("k", "v"):
        got, want = cache[name].numpy(), np.asarray(jcache[name])
        assert np.abs(got.astype(np.int32) - want).max() <= 1, name
        assert (got == want).mean() > 0.999, name
        np.testing.assert_allclose(cache[f"{name}_scale"].numpy(),
                                   np.asarray(jcache[f"{name}_scale"]),
                                   rtol=1e-5, err_msg=name)
    raw = np.random.default_rng(4).standard_normal(
        (2, 5, 4, 16)).astype(np.float32)
    want = jax_gen._kv_leaf_updates(jnp.asarray(raw), jnp.asarray(-raw),
                                    jax_cfg, True)
    got = generation._kv_leaf_updates(torch.from_numpy(raw),
                                      torch.from_numpy(-raw), cfg, True)
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(leaf))


def test_quantized_chunk_decode_matches_generate(qmodels, qprompts):
    """An int8 slot grid, driven insert by insert and chunk by chunk,
    emits what quantized ``generate`` emits per request."""
    _, _, cfg, tparams = qmodels
    toks, lens, jax_tokens = qprompts
    num_slots, bucket, chunk = 2, 16, 3
    cache = generation.init_slot_cache(cfg, num_slots, bucket + N_NEW,
                                       device="cpu", kv_quant=True)
    state = generation.init_slot_state(cfg, num_slots, device="cpu")
    table = torch.full((num_slots, 4), -1, dtype=torch.int32)
    emitted = {}
    for req, slot in ((0, 0), (1, 1)):
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :lens[req]] = toks[req, :lens[req]]
        cache, state, tok = generation.insert_slot_program(
            tparams, cache, state, torch.from_numpy(padded),
            int(lens[req]), slot, N_NEW, cfg)
        emitted[slot] = [int(tok)]
    while bool(state["active"].any()):
        cache, state, ptoks, valid = generation.decode_chunk_program(
            tparams, cache, state, cfg, chunk_size=chunk, block_table=table)
        for slot in emitted:
            emitted[slot] += ptoks[slot][valid[slot]].tolist()
    for req in (0, 1):
        assert emitted[req] == jax_tokens[req].tolist()


@pytest.mark.parametrize("with_eos", [False, True])
@pytest.mark.parametrize("quantized", [False, True])
def test_beam_search_matches_jax(models, prompts, qmodels, qprompts,
                                 quantized, with_eos):
    jax_cfg, params, cfg, tparams = qmodels if quantized else models
    toks, lens, _ = qprompts if quantized else prompts
    kw = dict(num_beams=3, max_new_tokens=6, length_penalty=0.8)

    def jax_beam(**extra):
        out = jax_gen.beam_search(params, jnp.asarray(toks),
                                  jnp.asarray(lens), jax_cfg,
                                  kv_quant=quantized, **kw, **extra)
        return {k: np.asarray(v) for k, v in out.items()}

    extra = {}
    if with_eos:
        # A token of row 0's best beam that did not occur before it there.
        best = jax_beam()["tokens"][0]
        idx = next(i for i in range(1, len(best))
                   if best[i] not in best[:i])
        extra = dict(eos_id=int(best[idx]))
    want = jax_beam(**extra)
    got = generation.beam_search(tparams, torch.from_numpy(toks),
                                 torch.from_numpy(lens), cfg,
                                 kv_quant=quantized, device="cpu", **kw,
                                 **extra)
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    np.testing.assert_array_equal(got["num_generated"].numpy(),
                                  want["num_generated"])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=0, atol=1e-5)
    assert np.isfinite(got["scores"].numpy()).all()
    if with_eos:
        assert int(got["num_generated"][0]) < kw["max_new_tokens"]


def test_beam_search_validation(models):
    _, _, cfg, tparams = models
    toks = torch.ones((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="num_beams"):
        generation.beam_search(tparams, toks, torch.tensor([4]), cfg,
                               num_beams=0, max_new_tokens=2, device="cpu")
    with pytest.raises(ValueError, match="max_new_tokens"):
        generation.beam_search(tparams, toks, torch.tensor([4]), cfg,
                               num_beams=2, max_new_tokens=0, device="cpu")


def test_decode_tokens_per_sec_runs_each_variant(models, qmodels):
    """The decode A/B's timing loop on the CPU: full-precision weights,
    int8 weights, and int8 weights with an int8 cache."""
    _, _, cfg, tparams = models
    _, _, _, qparams = qmodels
    prompts = torch.ones((2, 5), dtype=torch.int32)
    lens = torch.tensor([5, 3])
    for params, kv_quant in ((tparams, False), (qparams, False),
                             (qparams, True)):
        rate = benchmarking.decode_tokens_per_sec(
            params, cfg, prompts, lens, max_new_tokens=3, warmup=0, iters=1,
            kv_quant=kv_quant, device="cpu")
        assert rate > 0
