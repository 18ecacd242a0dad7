"""The port's prefix KV cache and host tier on the CPU, against JAX.

``cloud_tpu_torch/serving/prefix_cache.py`` is the port's own copy of the
JAX package's ``PrefixCacheManager`` (plain Python): both copies run one
scripted sequence of calls per scenario (match, acquire, insert, release,
eviction, demotion to the host tier, swap-in, a swap-in that loses the
race, the router summary) and must give the same answers.

The prefix engine, both routes (the copy route, ``decode_kernel="xla"``,
and the attach route, ``"pallas"``), with and without chunked prefill and
with and without the host tier, serves tie-free prompts on a few shared
heads one after another (TINY, f32, the port's side in a child process
that never imports JAX): every request is token-identical to JAX
``generate``, and the hit, swap-in, demotion and eviction counts equal
the JAX engine's on the same sequence.

With ``kv_quant`` (int8 grid and pool, scales included): the reference's
two-tier churn (staggered, three heads through a 3-block pool and a 3-block
host tier, with demotions and host-tier evictions) and chunked prefill on
both routes, token-identical to JAX ``generate(kv_quant=True)`` on prompts
tie-free at 1e-2.

Under the engine, the port's programs (the pool's save, copy, block
downloads and uploads; chunked prefill cold and through an attached hit;
finalize; the batch prefill and decode) are held to the JAX package's on
the same weights and tokens.
"""

import inspect
import itertools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import generation as jax_gen
from cloud_tpu.serving import ServeConfig as JaxServeConfig
from cloud_tpu.serving import ServingEngine as JaxServingEngine
from cloud_tpu.serving import prefix_cache as jax_prefix
from cloud_tpu_torch.serving import prefix_cache as port_prefix
from helpers.torch_port import (
    QUANT_TIE_GAP,
    TIE_GAP,
    greedy_gaps,
    model_inputs,
    quantized_greedy_gaps,
    run_port_side,
    tiny_models,
)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# The manager: one script, both copies.


def _hit(hit):
    return {"tokens": hit.tokens, "blocks": list(hit.blocks),
            "tiers": [n.tier for n in hit.nodes]}


def _plan(plan):
    return None if plan is None else [(block, payload)
                                      for _, block, payload in plan]


def _blocks(nodes):
    return [n.block for n in nodes]


def _single_tier(mod, log):
    """Matches capped at the prompt minus one, refcounts, LRU eviction of
    unreferenced leaves, a fully pinned pool caching less, an acquire
    failing after its blocks were evicted."""
    mgr = mod.PrefixCacheManager(4, 2)
    a, b, c = [1, 2, 3, 4, 5], [1, 2, 7, 8, 9], [6, 6, 6, 6, 6, 6, 6]
    held_a, created, evicted = mgr.insert(a, mod.PrefixHit((), 0))
    log.append(("insert a", _blocks(held_a), _blocks(created), evicted))
    hit = mgr.match(b)
    log.append(("match b", _hit(hit), mgr.acquire(hit)))
    held_b, created, evicted = mgr.insert(b, hit)
    log.append(("insert b", _blocks(held_b), _blocks(created), evicted))
    mgr.release(held_a)
    held_c, created, evicted = mgr.insert(c, mod.PrefixHit((), 0))
    log.append(("insert c, pool pinned", _blocks(held_c), _blocks(created),
                evicted))
    mgr.release(list(hit.nodes) + held_b + held_c)
    stale = mgr.match(a)
    log.append(("match a", _hit(stale)))
    held_d, created, evicted = mgr.insert([9, 9, 8, 8, 7, 7, 5],
                                          mod.PrefixHit((), 0))
    log.append(("insert d", _blocks(held_d), _blocks(created), evicted,
                mgr.acquire(stale)))
    log.append(("evict_prefix", mgr.evict_prefix([9, 9, 8, 8, 7, 7, 5])))
    mgr.release(held_d)
    log.append(("evict_prefix released",
                mgr.evict_prefix([9, 9, 8, 8, 7, 7, 5])))
    log.append(("stats", mgr.stats(), mgr.blocks_in_use))


def _dram_tier(mod, log):
    """Evictions demote to the host tier and a later hit swaps them back
    in (its plan names the payload demote_fn captured); a pinned block
    never demotes; a swap-in that cannot allocate rows fails and pins
    nothing; the host tier's LRU leaf is evicted for real when it
    overflows; plain acquire refuses demoted nodes."""
    mgr = mod.PrefixCacheManager(
        3, 2, dram_blocks=3, demote_fn=lambda block: ("bytes of", block))
    empty = mod.PrefixHit((), 0)
    heads = [[h, h, h + 1, h + 1, 0] for h in (10, 20, 30, 40)]
    for head in heads[:2]:
        held, created, evicted = mgr.insert(head, empty)
        log.append(("insert", head[0], _blocks(held), _blocks(created),
                    evicted))
        mgr.release(held)
    held, created, evicted = mgr.insert(heads[2], empty)
    log.append(("insert demoting", _blocks(held), _blocks(created), evicted,
                mgr.dram_blocks_in_use))
    hit = mgr.match(heads[0])
    log.append(("match demoted", _hit(hit), mgr.acquire(hit)))
    plan = mgr.acquire_swapin(hit)
    log.append(("swap-in", _plan(plan), _hit(hit)))
    # Pool now holds the swapped-in head and the pinned third head: a
    # fourth head can take no row, and a swap-in of a demoted head fails.
    held4, created, evicted = mgr.insert(heads[3], empty)
    log.append(("insert while pinned", _blocks(held4), _blocks(created),
                evicted))
    other = mgr.match(heads[1])
    log.append(("swap-in loses the race", _hit(other),
                _plan(mgr.acquire_swapin(other))))
    mgr.release(held + list(hit.nodes) + held4)
    for head in heads:
        h = mgr.match(head)
        log.append(("match after release", head[0], _hit(h)))
    held5, created, evicted = mgr.insert([50, 50, 51, 51, 52, 52, 0], empty)
    log.append(("insert overflowing the tier", _blocks(held5),
                _blocks(created), evicted, mgr.dram_blocks_in_use))
    mgr.release(held5)
    log.append(("stats", mgr.stats(), mgr.blocks_in_use,
                mgr.dram_blocks_in_use))


def _summary(mod, log):
    """The router summary: the affinity keys of cached prompts, with the
    tokens each one holds."""
    mgr = mod.PrefixCacheManager(16, 8)
    empty = mod.PrefixHit((), 0)
    for seed in range(3):
        prompt = list(np.random.default_rng(seed).integers(1, 99, 41))
        held, _, _ = mgr.insert(prompt, empty)
        hit = mgr.match(prompt)
        log.append(("hit", seed, _hit(hit), mgr.acquire(hit),
                    mod.affinity_key(prompt)))
        mgr.release(held + list(hit.nodes))
    log.append(("hot", sorted(mgr.hot_prefixes().items())))


SCENARIOS = {"single_tier": _single_tier, "dram_tier": _dram_tier,
             "summary": _summary}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_manager_copy_answers_as_the_reference(name):
    got, want = [], []
    SCENARIOS[name](port_prefix, got)
    SCENARIOS[name](jax_prefix, want)
    assert got == want
    assert len(got) > 2


def test_manager_copy_keeps_the_reference_surface():
    """The same public names, constants and signatures."""
    for name in ("SKIP_BLOCK", "AFFINITY_PREFIX_TOKENS"):
        assert getattr(port_prefix, name) == getattr(jax_prefix, name)
    for cls in ("PrefixCacheManager", "PrefixHit"):
        port_cls, ref_cls = (getattr(m, cls) for m in (port_prefix,
                                                       jax_prefix))
        names = {n for n in dir(ref_cls) if not n.startswith("__")}
        assert names <= set(dir(port_cls))
        for n in names:
            ref = getattr(ref_cls, n)
            if callable(ref):
                assert (inspect.signature(getattr(port_cls, n))
                        == inspect.signature(ref)), n


# ---------------------------------------------------------------------------
# The prefix engine: the port against JAX generate and the JAX engine.

MAX_NEW = 6
BLOCK = 4
#: Three 12-token heads (3 blocks each) cycled through a 6-block pool:
#: evictions, and with the host tier demotions and swap-ins.
HEADS, HEAD_LEN, POOL, DRAM = 3, 12, 6, 12
ORDER = (0, 0, 1, 1, 2, 0, 1, 2, 2)
COUNTERS = ("prefix_hits", "prefix_misses", "prefix_hit_tokens",
            "evictions", "prefix_dram_hits", "prefix_dram_hit_tokens",
            "prefix_dram_demotions", "prefix_dram_evictions", "inserts",
            "prefill_chunks", "prefix_cache_blocks", "prefix_dram_blocks")

#: (chunked prefill, host tier) of the JAX engine runs; the port runs each
#: on both routes.
SETTINGS = list(itertools.product((None, 8), (False, True)))


def _serve(chunk, tier):
    return dict(max_new_tokens=MAX_NEW, prompt_buckets=(16,), num_slots=2,
                chunk_tokens=3, prefix_cache_blocks=POOL,
                prefix_block_tokens=BLOCK, prefill_chunk_tokens=chunk,
                prefix_dram_blocks=DRAM if tier else 0)


def _label(route, chunk, tier):
    return f"{route}-chunk{chunk}-{'tier' if tier else 'notier'}"


PORT_RUNS = [(route, chunk, tier) for route in ("xla", "pallas")
             for chunk, tier in SETTINGS]

_PORT_SIDE = """
from cloud_tpu_torch.serving import ServeConfig, ServingEngine

cfg, params = port_model()
prompts = [IN["prompts"][i, :n] for i, n in enumerate(IN["lens"])]
counters = [str(c) for c in IN["counters"]]
for run in json.loads(str(IN["runs"])):
    engine = ServingEngine(params, cfg, ServeConfig(**run["serve"]),
                           device="cpu")
    results = [engine.submit(p).result(timeout=300) for p in prompts]
    engine.close()
    stats = engine.stats()
    OUT[run["label"] + ".tokens"] = np.stack([r.tokens for r in results])
    OUT[run["label"] + ".counters"] = np.array([stats[c] for c in counters])
    OUT[run["label"] + ".attaches"] = np.array(stats["prefix_attaches"])
"""


def _pick_prompts(jax_cfg, params):
    """Tie-free prompts ``head + 1..3-token tail`` in the order ``ORDER``
    of heads, and JAX ``generate``'s tokens for them."""
    rng = np.random.default_rng(77)
    heads = rng.integers(1, jax_cfg.vocab_size, (HEADS, HEAD_LEN))
    n = 40
    lens = rng.integers(HEAD_LEN + 1, HEAD_LEN + 4, n).astype(np.int32)
    cands = rng.integers(1, jax_cfg.vocab_size, (n, 16)).astype(np.int32)
    which = np.arange(n) % HEADS
    cands[:, :HEAD_LEN] = heads[which]
    gaps, tokens = greedy_gaps(jax_cfg, params, cands, lens, MAX_NEW)
    pools = {h: [i for i in range(n) if which[i] == h and gaps[i] > TIE_GAP]
             for h in range(HEADS)}
    rows = [pools[h].pop(0) for h in ORDER]
    return cands[rows], lens[rows], tokens[rows]


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    jax_cfg, params, _, _ = tiny_models(seed=9, num_layers=2)
    prompts, lens, want_tokens = _pick_prompts(jax_cfg, params)
    jax_counts = {}
    for chunk, tier in SETTINGS:
        engine = JaxServingEngine(params, jax_cfg,
                                  JaxServeConfig(**_serve(chunk, tier)))
        for i, n in enumerate(lens):
            engine.submit(prompts[i, :n]).result(timeout=300)
        engine.close()
        stats = engine.stats()
        jax_counts[(chunk, tier)] = np.array([stats[c] for c in COUNTERS])
    runs = [{"label": _label(*run), "serve": dict(
        _serve(run[1], run[2]), decode_kernel=run[0])} for run in PORT_RUNS]
    inputs = dict(model_inputs(jax_cfg, params), prompts=prompts, lens=lens,
                  counters=np.array(COUNTERS), runs=np.asarray(
                      json.dumps(runs)))
    got = run_port_side(_PORT_SIDE, inputs,
                        tmp_path_factory.mktemp("prefix_engine"))
    return want_tokens, jax_counts, got


@pytest.mark.parametrize("run", PORT_RUNS, ids=lambda r: _label(*r))
def test_prefix_engine_token_identical_to_generate(engine_runs, run):
    want_tokens, _, got = engine_runs
    np.testing.assert_array_equal(got[_label(*run) + ".tokens"], want_tokens)


@pytest.mark.parametrize("run", PORT_RUNS, ids=lambda r: _label(*r))
def test_prefix_counts_equal_the_jax_engine(engine_runs, run):
    """Requests one at a time: hits, hit tokens, evictions, demotions,
    swap-ins, inserts and prefill chunks as the JAX engine counts them;
    the attach route attaches every hit, the copy route none."""
    route, chunk, tier = run
    _, jax_counts, got = engine_runs
    counts = got[_label(*run) + ".counters"]
    np.testing.assert_array_equal(counts, jax_counts[(chunk, tier)])
    stats = dict(zip(COUNTERS, counts))
    assert stats["prefix_hits"] >= 3
    assert (stats["prefix_dram_hits"] > 0) == tier
    attaches = int(got[_label(*run) + ".attaches"])
    assert attaches == (stats["prefix_hits"] if route == "pallas" else 0)


# ---------------------------------------------------------------------------
# The programs under the engine: the port's against the JAX package's.

PROGRAM_PROMPT_LEN, PROGRAM_ROW = 11, 32

_PROGRAMS_SIDE = """
from cloud_tpu_torch.models import generation
from cloud_tpu_torch.serving.prefix_cache import SKIP_BLOCK

cfg, params = port_model()
params = generation.prepare_params(params, cfg)
prompt = torch.from_numpy(IN["prompt"])
n = prompt.shape[0]
cache = generation.init_slot_cache(cfg, 2, int(IN["row"]), device="cpu")
pool = generation.init_prefix_pool(cfg, 6, 4, device="cpu")
# A cold prefill of slot 1 in chunks of 4, then its finalize.
for start in range(0, n, 4):
    clen = min(4, n - start)
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    tokens[0, :clen] = prompt[start:start + clen]
    cache, logits = generation.prefill_chunk_program(
        params, cache, tokens, start, clen, 1, cfg)
OUT["chunk_cache"] = torch.stack([cache["k"], cache["v"]]).numpy()
OUT["chunk_logits"] = logits.numpy()
state = generation.init_slot_state(cfg, 2, device="cpu")
state, tok = generation.finalize_slot_program(state, logits, n, 1, 6, cfg)
OUT["finalize_state"] = np.stack([state[k].numpy().astype(np.int32)
                                  for k in ("pos", "tok", "remaining",
                                            "emitted", "active")])
# Save its two full blocks (the first skipped), copy them into slot 0.
pool = generation.save_prefix_program(
    pool, cache, 1, np.array([SKIP_BLOCK, 3, 0], np.int32))
OUT["saved_pool"] = torch.stack([pool["k"], pool["v"]]).numpy()
cache = generation.copy_prefix_program(cache, pool, np.array([3, 0]), 0)
OUT["copied_cache"] = torch.stack([cache["k"], cache["v"]]).numpy()
# The attach route: slot 0's pages 1 and 2 read pool blocks 3 and 0; the
# chunk from position 8 attends over them through the block table.
table = torch.full((2, int(IN["row"]) // 4), -1, dtype=torch.int32)
table[0, 1], table[0, 2] = 3, 0
tokens = torch.zeros((1, 4), dtype=torch.int32)
tokens[0, :n - 8] = prompt[8:]
_, logits = generation.prefill_chunk_program(
    params, cache, tokens, 8, n - 8, 0, cfg, pool=pool, block_table=table)
OUT["attach_logits"] = logits.numpy()
# The host tier's movers.
payload = generation.download_prefix_block(pool, 3)
pool = generation.upload_prefix_block(pool, payload, 5)
rows = generation.download_prefix_blocks(pool, [0, 5])
pool = generation.upload_prefix_blocks(pool, rows, [1, 99])
OUT["moved_pool"] = torch.stack([pool["k"], pool["v"]]).numpy()
OUT["download"] = torch.stack([rows["k"], rows["v"]]).numpy()
# The batch programs on two padded prompts.
batch = torch.zeros((2, 16), dtype=torch.int32)
batch[0, :n], batch[1, :5] = prompt, prompt[:5]
lens = torch.tensor([n, 5], dtype=torch.int32)
bcache, logits0 = generation.prefill_program(params, batch, lens, cfg,
                                             max_new_tokens=6)
OUT["batch_logits"] = logits0.numpy()
OUT["batch_tokens"] = generation.decode_program(
    params, bcache, logits0, lens, cfg, max_new_tokens=6)["tokens"].numpy()
"""


@pytest.fixture(scope="module")
def program_runs(tmp_path_factory):
    jax_cfg, params, _, _ = tiny_models(seed=13, num_layers=2)
    prompt = np.random.default_rng(13).integers(
        1, jax_cfg.vocab_size, PROGRAM_PROMPT_LEN).astype(np.int32)
    n = PROGRAM_PROMPT_LEN
    want = {}
    cache = jax_gen.init_slot_cache(jax_cfg, 2, PROGRAM_ROW)
    pool = jax_gen.init_prefix_pool(jax_cfg, 6, 4)
    for start in range(0, n, 4):
        clen = min(4, n - start)
        tokens = np.zeros((1, 4), np.int32)
        tokens[0, :clen] = prompt[start:start + clen]
        cache, logits = jax_gen.prefill_chunk_program(
            params, cache, jnp.asarray(tokens), start, clen, 1, jax_cfg)
    want["chunk_cache"] = np.stack([cache["k"], cache["v"]])
    want["chunk_logits"] = np.asarray(logits)
    state = jax_gen.init_slot_state(jax_cfg, 2)
    state, _ = jax_gen.finalize_slot_program(state, logits, n, 1, 6, jax_cfg)
    want["finalize_state"] = np.stack([
        np.asarray(state[k]).astype(np.int32)
        for k in ("pos", "tok", "remaining", "emitted", "active")])
    pool = jax_gen.save_prefix_program(
        pool, cache, 1, jnp.asarray([jax_prefix.SKIP_BLOCK, 3, 0]))
    want["saved_pool"] = np.stack([pool["k"], pool["v"]])
    cache = jax_gen.copy_prefix_program(cache, pool, jnp.asarray([3, 0]), 0)
    want["copied_cache"] = np.stack([cache["k"], cache["v"]])
    table = np.full((2, PROGRAM_ROW // 4), -1, np.int32)
    table[0, 1], table[0, 2] = 3, 0
    tokens = np.zeros((1, 4), np.int32)
    tokens[0, :n - 8] = prompt[8:]
    _, logits = jax_gen.prefill_chunk_program(
        params, cache, jnp.asarray(tokens), 8, n - 8, 0, jax_cfg, pool=pool,
        block_table=jnp.asarray(table), use_pallas=False)
    want["attach_logits"] = np.asarray(logits)
    payload = jax_gen.download_prefix_block(pool, 3)
    pool = jax_gen.upload_prefix_block(pool, payload, 5)
    rows = jax_gen.download_prefix_blocks(pool, jnp.asarray([0, 5]))
    pool = jax_gen.upload_prefix_blocks(pool, rows, jnp.asarray([1, 99]))
    want["moved_pool"] = np.stack([pool["k"], pool["v"]])
    want["download"] = np.stack([rows["k"], rows["v"]])
    batch = np.zeros((2, 16), np.int32)
    batch[0, :n], batch[1, :5] = prompt, prompt[:5]
    lens = jnp.asarray([n, 5])
    bcache, logits0 = jax_gen.prefill_program(
        params, jnp.asarray(batch), lens, jax_cfg, max_new_tokens=6)
    want["batch_logits"] = np.asarray(logits0)
    want["batch_tokens"] = np.asarray(jax_gen.decode_program(
        params, bcache, logits0, lens, jax_cfg, max_new_tokens=6)["tokens"])
    got = run_port_side(_PROGRAMS_SIDE, dict(
        model_inputs(jax_cfg, params), prompt=prompt,
        row=np.array(PROGRAM_ROW)), tmp_path_factory.mktemp("programs"))
    return want, got


#: Output -> absolute tolerance (0: exact): K/V and logits at the port's
#: f32 tolerances, sampled tokens and slot state exactly.
PROGRAM_OUTPUTS = {"chunk_cache": 1e-5, "chunk_logits": 1e-4,
                   "finalize_state": 0, "saved_pool": 1e-5,
                   "copied_cache": 1e-5, "attach_logits": 1e-4,
                   "moved_pool": 1e-5, "download": 1e-5,
                   "batch_logits": 1e-4, "batch_tokens": 0}


@pytest.mark.parametrize("name", sorted(PROGRAM_OUTPUTS))
def test_programs_match_jax(program_runs, name):
    """The pool programs (save, copy, block downloads and uploads), the
    chunked-prefill programs (cold chunks, an attached hit, finalize) and
    the batch programs, on the same weights and tokens."""
    want, got = program_runs
    assert got[name].shape == want[name].shape
    np.testing.assert_allclose(got[name], want[name],
                               atol=PROGRAM_OUTPUTS[name], rtol=0)


# ---------------------------------------------------------------------------
# kv_quant through the prefix cache, its host tier and chunked prefill.

#: The reference's two-tier churn (``test_tier_churn_parity_with_kv_quant``,
#: ``tests/unit/test_serving_prefix.py``): three 9-token heads (two blocks
#: each) through a 3-block pool and a 3-block host tier, int8 grids.
QUANT_TIER_SERVE = dict(max_new_tokens=4, prompt_buckets=(16,),
                        batch_buckets=(1, 2), num_slots=2, chunk_tokens=2,
                        prefix_cache_blocks=3, prefix_block_tokens=4,
                        prefix_dram_blocks=3, kv_quant=True)
#: Chunked prefill over an int8 grid, on both routes, requests in turn.
QUANT_CHUNK_SERVE = dict(max_new_tokens=4, prompt_buckets=(16,),
                         num_slots=2, chunk_tokens=2, prefix_cache_blocks=6,
                         prefix_block_tokens=4, prefill_chunk_tokens=4,
                         kv_quant=True)

_QUANT_PORT_SIDE = """
import time
from cloud_tpu_torch.serving import ServeConfig, ServingEngine

cfg, params = port_model()
prompts = [IN["prompts"][i, :n] for i, n in enumerate(IN["lens"])]
budgets = [int(b) for b in IN["budgets"]]
for run in json.loads(str(IN["runs"])):
    engine = ServingEngine(params, cfg, ServeConfig(**run["serve"]),
                           device="cpu")
    assert engine._grid_cache["k"].dtype == torch.int8
    assert engine._prefix_pool["k_scale"].dtype == torch.float32
    if run["staggered"]:
        futures = []
        for i, p in enumerate(prompts):
            futures.append(engine.submit(p, max_new_tokens=budgets[i]))
            if i in (2, 5):
                time.sleep(0.05)
        results = [f.result(timeout=300) for f in futures]
    else:
        results = [engine.submit(p, max_new_tokens=b).result(timeout=300)
                   for p, b in zip(prompts, budgets)]
    engine.close()
    stats = engine.stats()
    OUT[run["label"] + ".tokens"] = np.stack(
        [np.pad(r.tokens, (0, 4 - len(r.tokens))) for r in results])
    OUT[run["label"] + ".stats"] = np.array([
        stats[k] for k in ("prefix_dram_demotions", "prefix_dram_evictions",
                           "prefix_hits", "prefill_chunks", "completed",
                           "prefix_attaches")])
"""


def _quant_tier_prompts(jax_cfg, params):
    """The reference's prompts (seed 33: heads, then a 2..5-token tail per
    prompt, then budgets of 2..4), a tail drawn again from the same
    stream where the int8 greedy path is not tie-free at
    ``QUANT_TIE_GAP``."""
    rng = np.random.default_rng(33)
    heads = [rng.integers(1, 255, 9).astype(np.int32) for _ in range(3)]

    def tail():
        return rng.integers(1, 255, int(rng.integers(2, 6))).astype(np.int32)

    prompts = [np.concatenate([heads[i % 3], tail()]) for i in range(9)]
    budgets = [int(rng.integers(2, 5)) for _ in prompts]
    for _ in range(30):
        batch = np.zeros((9, 14), np.int32)
        for i, p in enumerate(prompts):
            batch[i, :len(p)] = p
        lens = np.array([len(p) for p in prompts], np.int32)
        gaps, tokens = quantized_greedy_gaps(jax_cfg, params, batch, lens, 4)
        bad = [i for i in range(9) if gaps[i] <= QUANT_TIE_GAP]
        if not bad:
            return batch, lens, np.array(budgets), tokens
        for i in bad:
            prompts[i] = np.concatenate([heads[i % 3], tail()])
    raise AssertionError("no tie-free int8 prompt set")


@pytest.fixture(scope="module")
def quant_runs(tmp_path_factory):
    jax_cfg, params, _, _ = tiny_models(seed=0, num_layers=2)
    batch, lens, budgets, tokens = _quant_tier_prompts(jax_cfg, params)
    # Generate's own rows (the oracle), beside the tie check's path.
    out = jax_gen.generate(params, jnp.asarray(batch), jnp.asarray(lens),
                           jax_cfg, max_new_tokens=4, kv_quant=True)
    np.testing.assert_array_equal(np.asarray(out["tokens"]), tokens)
    runs = [{"label": "tier", "serve": QUANT_TIER_SERVE, "staggered": True}]
    runs += [{"label": f"chunks-{route}", "staggered": False,
              "serve": dict(QUANT_CHUNK_SERVE, decode_kernel=route)}
             for route in ("xla", "pallas")]
    inputs = dict(model_inputs(jax_cfg, params), prompts=batch, lens=lens,
                  budgets=budgets, runs=np.asarray(json.dumps(runs)))
    got = run_port_side(_QUANT_PORT_SIDE, inputs,
                        tmp_path_factory.mktemp("quant_prefix"))
    want = np.where(np.arange(4)[None] < budgets[:, None], tokens, 0)
    return want, got


def test_tier_churn_parity_with_kv_quant(quant_runs):
    """Staggered churn through the two int8 tiers: every request equals
    JAX ``generate(kv_quant=True)``; blocks were demoted to the host tier
    and evicted from it."""
    want, got = quant_runs
    np.testing.assert_array_equal(got["tier.tokens"], want)
    demotions, dram_evictions, _, _, completed, _ = got["tier.stats"]
    assert demotions > 0 and dram_evictions > 0
    assert completed == len(want)


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_chunked_prefill_with_kv_quant(quant_runs, route):
    """4-token prefill chunks over an int8 grid and pool, prefix hits
    copied (``xla``) or attached (``pallas``), one request at a time:
    every request equals JAX ``generate(kv_quant=True)``."""
    want, got = quant_runs
    np.testing.assert_array_equal(got[f"chunks-{route}.tokens"], want)
    _, _, hits, chunks, completed, attaches = got[f"chunks-{route}.stats"]
    assert hits >= 3 and chunks >= len(want) and completed == len(want)
    assert attaches == (hits if route == "pallas" else 0)
