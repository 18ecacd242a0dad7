"""The port's speculative decoding (draft and verify) on the CPU, against JAX.

TINY targets and drafts in f32, the JAX weights through ``bridge``:

- the programs: ``draft_prefill_slot_program``, ``draft_chunk_program``
  and ``verify_chunk_program`` against JAX's on one slot grid (an inactive
  slot, a budget shorter than the window, eos with ``min_new_tokens``):
  the same window, committed tokens, valid mask and slot state, and the
  same caches after, at atol 1e-5;
- the engine with a draft against the JAX engine with the same draft,
  requests served one at a time (the port's side in a child process that
  never imports JAX): token-identical to it and to JAX ``generate``, with
  equal round, proposal and acceptance counts; the target as its own
  draft accepts what its budgets allow;
- compositions: an int8 grid (``kv_quant``; the draft's cache is int8 too)
  against JAX ``generate(kv_quant=True)``, and the prefix cache with
  chunked prefill on both routes (the verify reads attached pool pages
  through the block table) against JAX ``generate``;
- JAX's ``ValueError`` messages for a draft with the batch scheduler,
  temperature > 0, a repetition penalty, a vocabulary mismatch and a
  malformed ``DraftConfig``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import generation as jax_gen
from cloud_tpu.serving import DraftConfig as JaxDraftConfig
from cloud_tpu.serving import ServeConfig as JaxServeConfig
from cloud_tpu.serving import ServingEngine as JaxServingEngine
from cloud_tpu_torch.models import generation
from cloud_tpu_torch.serving import DraftConfig, ServeConfig, ServingEngine
from helpers.torch_port import (
    TIE_GAP,
    greedy_gaps,
    model_inputs,
    run_port_side,
    tie_free_prompts,
    tiny_models,
)

torch.set_num_threads(1)

ATOL = 1e-5
SPEC_K = 3
MAX_NEW = 8
BUCKETS = (8, 16)


@pytest.fixture(scope="module")
def models():
    """(target, draft): each ``(jax_cfg, jax_params, port_cfg,
    port_params)``; the draft has one layer and its own seed."""
    return tiny_models(seed=21, num_layers=2), tiny_models(seed=22,
                                                           num_layers=1)


# ---------------------------------------------------------------------------
# The programs.

#: Slot grid of the program tests: (prompt length, budget) per slot, None
#: for a slot never armed.
SLOTS = ((11, MAX_NEW), None, (6, 3))
GRID_LEN = 16 + MAX_NEW


def _grids(models, which):
    """Both sides' target grid and state after arming ``SLOTS``, and the
    draft's grid after its prefills (the draft is the target itself for
    ``which="self"``)."""
    (jcfg, jparams, cfg, params), small = models
    djcfg, djparams, dcfg, dparams = ((jcfg, jparams, cfg, params)
                                      if which == "self" else small)
    rng = np.random.default_rng(31)
    prompts = rng.integers(1, jcfg.vocab_size, (len(SLOTS), 16)).astype(
        np.int32)
    jax_side = [jax_gen.init_slot_cache(jcfg, len(SLOTS), GRID_LEN),
                jax_gen.init_slot_state(jcfg, len(SLOTS)),
                jax_gen.init_slot_cache(djcfg, len(SLOTS), GRID_LEN)]
    port_side = [generation.init_slot_cache(cfg, len(SLOTS), GRID_LEN,
                                            device="cpu"),
                 generation.init_slot_state(cfg, len(SLOTS), device="cpu"),
                 generation.init_slot_cache(dcfg, len(SLOTS), GRID_LEN,
                                            device="cpu")]
    for slot, arm in enumerate(SLOTS):
        if arm is None:
            continue
        n, budget = arm
        tokens = prompts[slot:slot + 1]
        cache, state, _ = jax_gen.insert_slot_program(
            jparams, jax_side[0], jax_side[1], jnp.asarray(tokens), n, slot,
            budget, jcfg)
        draft = jax_gen.draft_prefill_slot_program(
            djparams, jax_side[2], jnp.asarray(tokens), n, slot, djcfg)
        jax_side = [cache, state, draft]
        cache, state, _ = generation.insert_slot_program(
            params, port_side[0], port_side[1], torch.from_numpy(tokens), n,
            slot, budget, cfg)
        draft = generation.draft_prefill_slot_program(
            dparams, port_side[2], torch.from_numpy(tokens), n, slot, dcfg)
        port_side = [cache, state, draft]
    return (jax_side, port_side, (djcfg, djparams, dcfg, dparams),
            (jcfg, jparams, cfg, params))


def _close(port_tree, jax_tree, what):
    for name, leaf in port_tree.items():
        np.testing.assert_allclose(leaf.float().numpy(),
                                   np.asarray(jax_tree[name], np.float32),
                                   rtol=0, atol=ATOL, err_msg=f"{what} {name}")


def _same_state(port_state, jax_state):
    for name, value in port_state.items():
        np.testing.assert_array_equal(value.numpy(),
                                      np.asarray(jax_state[name]),
                                      err_msg=name)


@pytest.mark.parametrize("which", ["small", "self"])
def test_draft_prefill_and_chunk_match_jax(models, which):
    """The draft's prefilled grid, the window (column 0 the carried token)
    and the draft grid after the round."""
    jax_side, port_side, draft, _ = _grids(models, which)
    djcfg, djparams, dcfg, dparams = draft
    _close(port_side[2], jax_side[2], "draft grid after prefill")
    jdraft, jwindow = jax_gen.draft_chunk_program(
        djparams, jax_side[2], jax_side[1], djcfg, spec_k=SPEC_K)
    pdraft, pwindow = generation.draft_chunk_program(
        dparams, port_side[2], port_side[1], dcfg, spec_k=SPEC_K)
    np.testing.assert_array_equal(pwindow.numpy(), np.asarray(jwindow))
    np.testing.assert_array_equal(pwindow[:, 0].numpy(),
                                  port_side[1]["tok"].numpy())
    _close(pdraft, jdraft, "draft grid after the round")


VERIFY_CASES = ("small", "self", "self-eos")


@pytest.mark.parametrize("case", VERIFY_CASES)
def test_verify_chunk_matches_jax(models, case):
    """Committed tokens, valid mask, slot state and target grid after one
    verify of the JAX window; with ``eos``, an eos the target emits second
    in slot 0 and ``min_new_tokens`` 2."""
    which = case.split("-")[0]
    jax_side, port_side, draft, target = _grids(models, which)
    djcfg, djparams, _, _ = draft
    jcfg, jparams, cfg, params = target
    _, window = jax_gen.draft_chunk_program(
        djparams, jax_side[2], jax_side[1], djcfg, spec_k=SPEC_K)
    jsample = jax_gen.SampleConfig(temperature=0.0)
    psample = generation.SampleConfig(temperature=0.0)
    if case.endswith("eos"):
        _, _, first, _ = jax_gen.verify_chunk_program(
            jparams, jax_side[0], jax_side[1], window, jcfg)
        eos = int(np.asarray(first)[0, 1])
        jsample = jax_gen.SampleConfig(temperature=0.0, eos_id=eos,
                                       min_new_tokens=2)
        psample = generation.SampleConfig(temperature=0.0, eos_id=eos,
                                          min_new_tokens=2)
    jcache, jstate, jtoks, jvalid = jax_gen.verify_chunk_program(
        jparams, jax_side[0], jax_side[1], window, jcfg, sample=jsample)
    pcache, pstate, ptoks, pvalid = generation.verify_chunk_program(
        params, port_side[0], port_side[1],
        torch.from_numpy(np.array(window)), cfg, sample=psample)
    np.testing.assert_array_equal(ptoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
    _same_state(pstate, jstate)
    _close(pcache, jcache, "target grid after the verify")
    assert not pvalid[1].any()  # the slot never armed commits nothing
    assert int(pvalid[2].sum()) <= SLOTS[2][1] - 1  # its budget
    if case == "self":
        # The target as its own draft: every proposal within budget is
        # accepted.
        assert pvalid[0].all()
    if case.endswith("eos"):
        assert pvalid[0].tolist() == [True, True, False]  # eos, then none


def test_window_writes_drop_out_of_range_positions():
    """The verify's cache write is JAX's drop-mode scatter: an inactive row
    keeps its bytes, an active row writes its window up to the row's end
    and drops the rest, whatever the duplicate indices do."""
    s, k = 6, 4
    leaf = torch.arange(3 * s * 2, dtype=torch.float32).reshape(3, s, 2, 1)
    pos = torch.tensor([1, 4, 2])
    active = torch.tensor([True, True, False])
    positions = pos[:, None] + torch.arange(k)[None, :]
    values = -1.0 - torch.arange(3 * k * 2, dtype=torch.float32).reshape(
        3, k, 2, 1)
    want = leaf.clone().numpy()
    for row in range(3):
        for t in range(k):
            p_ = int(positions[row, t])
            if active[row] and p_ < s:
                want[row, p_] = values[row, t].numpy()
    generation._write_window(leaf, torch.arange(3), positions, active,
                             values)
    np.testing.assert_array_equal(leaf.numpy(), want)


def test_verify_refuses_sampling_as_jax(models):
    (_, _, cfg, params), _ = models
    want = None
    try:
        jax_gen.verify_chunk_program(
            None, None, None, jnp.zeros((1, 2), jnp.int32), None,
            sample=jax_gen.SampleConfig(temperature=0.5))
    except ValueError as exc:
        want = str(exc)
    with pytest.raises(ValueError) as got:
        generation.verify_chunk_program(
            params, None, None, torch.zeros((1, 2), dtype=torch.int32), cfg,
            sample=generation.SampleConfig(temperature=0.5))
    assert want is not None and str(got.value) == want


# ---------------------------------------------------------------------------
# The engine.

#: Shared-head prompts for the prefix composition: 8-token heads (two
#: blocks of 4), served in this order of heads.
HEADS, HEAD_LEN, ORDER = 2, 8, (0, 0, 1, 0, 1)
PREFIX = dict(prefix_cache_blocks=8, prefix_block_tokens=4,
              prefill_chunk_tokens=4)
STATS = ("spec_chunks", "spec_emitted", "spec_proposed", "spec_accepted",
         "draft_prefills", "completed", "inserts")


def _serve(**kw):
    return dict(max_new_tokens=MAX_NEW, prompt_buckets=BUCKETS, num_slots=2,
                chunk_tokens=3, **kw)


def _head_prompts(jax_cfg, params):
    """Tie-free prompts ``head + 1..3-token tail`` in the order ``ORDER``."""
    rng = np.random.default_rng(41)
    heads = rng.integers(1, jax_cfg.vocab_size, (HEADS, HEAD_LEN))
    n = 30
    lens = rng.integers(HEAD_LEN + 1, HEAD_LEN + 4, n).astype(np.int32)
    cands = rng.integers(1, jax_cfg.vocab_size, (n, 16)).astype(np.int32)
    which = np.arange(n) % HEADS
    cands[:, :HEAD_LEN] = heads[which]
    gaps, tokens = greedy_gaps(jax_cfg, params, cands, lens, MAX_NEW)
    pools = {h: [i for i in range(n) if which[i] == h and gaps[i] > TIE_GAP]
             for h in range(HEADS)}
    rows = [pools[h].pop(0) for h in ORDER]
    return cands[rows], lens[rows], tokens[rows]


_PORT_SIDE = """
from cloud_tpu_torch.serving import DraftConfig, ServeConfig, ServingEngine

cfg, params = port_model()
dcfg, dparams = port_model("draft")
stats_keys = [str(k) for k in IN["stats"]]
for run in json.loads(str(IN["runs"])):
    draft = (DraftConfig(config=cfg, params=params, spec_k=run["spec_k"])
             if run["draft"] == "self" else
             DraftConfig(config=dcfg, params=dparams, spec_k=run["spec_k"]))
    engine = ServingEngine(params, cfg,
                           ServeConfig(draft=draft, **run["serve"]),
                           device="cpu")
    prompts = [IN[run["prompts"]][i, :n]
               for i, n in enumerate(IN[run["prompts"] + ".lens"])]
    results = [engine.submit(p).result(timeout=300) for p in prompts]
    health = engine.health()
    engine.close()
    stats = engine.stats()
    label = run["label"]
    OUT[label + ".tokens"] = np.stack([r.tokens for r in results])
    OUT[label + ".stats"] = np.array([stats[k] for k in stats_keys])
    OUT[label + ".rates"] = np.array([stats["spec_acceptance_rate"],
                                      health["spec_acceptance_rate"],
                                      health["spec_k"]])
    OUT[label + ".prefix"] = np.array([stats["prefix_hits"],
                                       stats["prefix_attaches"],
                                       stats["prefill_chunks"]])
    OUT[label + ".draft_int8"] = np.array(
        engine._draft_cache["k"].dtype == torch.int8)
"""

ENGINE_RUNS = {
    "small": ("plain", "small", {}),
    "self": ("plain", "self", {}),
    "kv_quant": ("quant", "small", {"kv_quant": True}),
    "prefix-xla": ("heads", "small", dict(PREFIX, decode_kernel="xla")),
    "prefix-pallas": ("heads", "small", dict(PREFIX, decode_kernel="pallas")),
}


@pytest.fixture(scope="module")
def engine_runs(models, tmp_path_factory):
    """JAX ``generate`` tokens per prompt set, the JAX engine's tokens and
    counters with each draft, and every port run."""
    (jcfg, jparams, _, _), (djcfg, djparams, _, _) = models
    plain, plain_lens, plain_want = tie_free_prompts(
        jcfg, jparams, batch=4, max_len=14, max_new_tokens=MAX_NEW, seed=500)
    quant, quant_lens, quant_want = tie_free_prompts(
        jcfg, jparams, batch=4, max_len=14, max_new_tokens=MAX_NEW, seed=600,
        kv_quant=True)
    heads, heads_lens, heads_want = _head_prompts(jcfg, jparams)
    want = {"plain": plain_want, "quant": quant_want, "heads": heads_want}
    jax_runs = {}
    for which, (cfg_, params_) in (("small", (djcfg, djparams)),
                                   ("self", (jcfg, jparams))):
        engine = JaxServingEngine(jparams, jcfg, JaxServeConfig(
            **_serve(), draft=JaxDraftConfig(config=cfg_, params=params_,
                                             spec_k=SPEC_K)))
        results = [engine.submit(plain[i, :n]).result(timeout=300)
                   for i, n in enumerate(plain_lens)]
        engine.close()
        stats = engine.stats()
        jax_runs[which] = (np.stack([r.tokens for r in results]),
                           np.array([stats[k] for k in STATS]))
    runs = [{"label": label, "prompts": prompts, "draft": draft,
             "spec_k": SPEC_K, "serve": _serve(**kw)}
            for label, (prompts, draft, kw) in ENGINE_RUNS.items()]
    inputs = dict(model_inputs(jcfg, jparams),
                  **model_inputs(djcfg, djparams, "draft"),
                  plain=plain, quant=quant, heads=heads,
                  stats=np.array(STATS), runs=np.asarray(json.dumps(runs)))
    inputs.update({"plain.lens": plain_lens, "quant.lens": quant_lens,
                   "heads.lens": heads_lens})
    got = run_port_side(_PORT_SIDE, inputs, tmp_path_factory.mktemp("spec"))
    return want, jax_runs, got


@pytest.mark.parametrize("which", ["small", "self"])
def test_spec_engine_matches_jax_engine(engine_runs, which):
    """One request at a time: the JAX engine's tokens (and JAX
    ``generate``'s) and its counters: rounds, committed, proposed and
    accepted tokens, draft prefills, completions, inserts."""
    want, jax_runs, got = engine_runs
    jax_tokens, jax_stats = jax_runs[which]
    np.testing.assert_array_equal(got[which + ".tokens"], jax_tokens)
    np.testing.assert_array_equal(got[which + ".tokens"], want["plain"])
    np.testing.assert_array_equal(got[which + ".stats"], jax_stats)
    assert got[which + ".stats"][STATS.index("spec_chunks")] > 0


def test_acceptance_rates(engine_runs):
    """``stats()`` carries accepted / proposed; ``health()`` the same
    quotient over the last rounds (all of them here) and ``spec_k``; the
    target as its own draft accepts more than the one-layer draft."""
    _, _, got = engine_runs
    for which in ("small", "self"):
        stats = dict(zip(STATS, got[which + ".stats"]))
        cumulative, rolling, spec_k = got[which + ".rates"]
        assert cumulative == pytest.approx(
            stats["spec_accepted"] / stats["spec_proposed"])
        assert rolling == pytest.approx(cumulative)
        assert spec_k == SPEC_K
    assert got["self.rates"][0] > got["small.rates"][0]


def test_spec_engine_with_kv_quant(engine_runs):
    """An int8 grid and an int8 draft grid: JAX ``generate(kv_quant=True)``
    on prompts whose quantized greedy path is tie-free."""
    want, _, got = engine_runs
    np.testing.assert_array_equal(got["kv_quant.tokens"], want["quant"])
    assert bool(got["kv_quant.draft_int8"])
    assert got["kv_quant.stats"][STATS.index("spec_chunks")] > 0


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_spec_engine_with_prefix_cache_and_chunks(engine_runs, route):
    """Shared heads one after another with 4-token prefill chunks: hits
    copied (``xla``) or attached through the block table (``pallas``, the
    verify reading pool pages), every token JAX ``generate``'s."""
    want, _, got = engine_runs
    label = "prefix-" + route
    np.testing.assert_array_equal(got[label + ".tokens"], want["heads"])
    hits, attaches, chunks = got[label + ".prefix"]
    assert hits >= 1 and chunks >= 1
    assert attaches == (hits if route == "pallas" else 0)
    assert got[label + ".stats"][STATS.index("spec_chunks")] > 0
    assert got[label + ".stats"][STATS.index("draft_prefills")] == len(ORDER)


# ---------------------------------------------------------------------------
# Validation.

DRAFT_VALIDATION = {
    "batch": dict(scheduler="batch"),
    "temperature": dict(sample="temperature"),
    "repetition_penalty": dict(sample="repetition_penalty"),
}


@pytest.mark.parametrize("case", sorted(DRAFT_VALIDATION))
def test_draft_validation_messages_match_jax(models, case):
    (jcfg, jparams, cfg, params), _ = models
    kw = dict(DRAFT_VALIDATION[case])
    jkw, pkw = dict(kw), dict(kw)
    if kw.get("sample") == "temperature":
        jkw["sample"] = jax_gen.SampleConfig(temperature=0.7)
        pkw["sample"] = generation.SampleConfig(temperature=0.7)
    elif kw.get("sample") == "repetition_penalty":
        jkw["sample"] = jax_gen.SampleConfig(temperature=0.0,
                                             repetition_penalty=1.3)
        pkw["sample"] = generation.SampleConfig(temperature=0.0,
                                                repetition_penalty=1.3)
    with pytest.raises(ValueError) as want:
        JaxServeConfig(draft=JaxDraftConfig(config=jcfg, params=jparams),
                       **jkw)
    with pytest.raises(ValueError) as got:
        ServeConfig(draft=DraftConfig(config=cfg, params=params), **pkw)
    assert str(got.value) == str(want.value)


def test_draft_vocabulary_mismatch_raises_as_jax(models):
    (jcfg, jparams, cfg, params), _ = models
    with pytest.raises(ValueError) as want:
        JaxServingEngine(jparams, jcfg, JaxServeConfig(
            draft=JaxDraftConfig(config=jcfg.scaled(vocab_size=100),
                                 params=jparams)))
    with pytest.raises(ValueError) as got:
        ServingEngine(params, cfg, ServeConfig(
            draft=DraftConfig(config=cfg.scaled(vocab_size=100),
                              params=params)), device="cpu", start=False)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(spec_k=0), dict(params=None)],
                         ids=["spec_k", "params"])
def test_draft_config_validation_matches_jax(models, kw):
    (jcfg, jparams, cfg, params), _ = models
    with pytest.raises(ValueError) as want:
        JaxDraftConfig(**dict(dict(config=jcfg, params=jparams), **kw))
    with pytest.raises(ValueError) as got:
        DraftConfig(**dict(dict(config=cfg, params=params), **kw))
    assert str(got.value) == str(want.value)
