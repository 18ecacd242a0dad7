"""The port's generation path against the JAX package's, on the CPU.

Greedy decoding is held token for token on TINY in f32, on seeded prompts
whose greedy path is tie-free (top-2 logit gap > 1e-3).  The slot-grid
programs are held state, tokens and cache against JAX on the same grid.
Sampling cannot match ``jax.random`` draw for draw, so it is held through
the filtered support on fixed logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import generation as jax_gen
from cloud_tpu_torch.models import generation
from helpers.torch_port import tie_free_prompts, tiny_models

torch.set_num_threads(2)

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
    with pytest.raises(ValueError, match="Generator"):
        generation.generate(tparams, torch.ones((1, 4), dtype=torch.int32),
                            torch.tensor([4]), cfg, max_new_tokens=2,
                            sample=generation.SampleConfig(temperature=1.0),
                            device="cpu")
    with pytest.raises(NotImplementedError, match="kv_quant"):
        generation.generate(tparams, torch.ones((1, 4), dtype=torch.int32),
                            torch.tensor([4]), cfg, max_new_tokens=2,
                            kv_quant=True, device="cpu")
