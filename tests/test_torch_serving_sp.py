"""The port's sequence-parallel serving slice (``mesh_shape=(tp, sp)``) on
the CPU, against the JAX engine at the same shape, JAX ``generate`` and
the one-card port engine.

A 2-layer TINY f32 with the reference's own weights and tie-free
prompts.  The JAX engine serves every greedy prompt one at a time at
``(1, 2)`` and ``(2, 2)`` on the 8 forced CPU devices (a plain and an
int8-cache engine a shape: a greedy request's tokens do not depend on
the route the engine takes to them), and JAX ``generate`` serves them in
one batched call.  The port's side runs JAX-free:

* in one child (``helpers/torch_port.py`` ``run_port_side``), slices that
  ``ServeConfig(mesh_shape=(tp, sp))`` spawns over gloo: the continuous
  scheduler's one-shot inserts (buckets 8 and 16 split over ``sp``,
  bucket 5, which ``sp`` 2 does not divide, run whole; the engine's
  ``sp_prefills`` and ``sp_whole_prefills`` count them) at both shapes,
  and a ``Fleet`` whose one replica is a ``(1, 2)`` slice (``total_chips``
  2);
* on a caller's mesh over 2 (``{sp: 2}``) and 4 (``{sp: 2, tp: 2}``) gloo
  processes, where rank 0 serves and the others ``follow()``: chunked
  prefill with a prefix hit, the batch scheduler, ``kv_quant`` (tie gap
  1e-2), a head-sharded draft, the host tier (demotions and swap-ins),
  ``pipeline_depth=2``, the KV handoff each way (a slice's payload
  imported on one card and one card's on the slice), and a nucleus
  sampled request whose tokens every rank draws alike (each rank records
  what its own programs sampled).

Each scenario's counters equal the one-card port engine's.  The split
prefill itself (``models/generation.py`` ``_split_prefill_forward``, run
through ``prefill_program``) is held per layer to JAX ``prefill_program``
on one device at ``sp`` 2 and 4: K/V within 1e-5, the logits within
1e-4.
"""

import concurrent.futures
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import generation as jax_gen
from cloud_tpu.serving import ServeConfig as JaxServeConfig
from cloud_tpu.serving import ServingEngine as JaxServingEngine
from helpers.torch_port import (TIE_GAP, _PRELUDE, greedy_gaps, launch_ranks,
                                model_inputs, run_port_side, tie_free_rows,
                                tiny_models)
from test_torch_serving_tp import _expected

torch.set_num_threads(1)

MAX_NEW = 6
#: The slices, and the caller's mesh of each.
SHAPES = ((1, 2), (2, 2))
SIZES = {(1, 2): {"sp": 2}, (2, 2): {"sp": 2, "tp": 2}}


def _shape_id(shape):
    return "x".join(map(str, shape))

#: Prompt lengths of each scenario (one tie-free draw).
LENS = {"insert": [3, 6, 11], "batch": [4, 9], "draft": [6, 12],
        "tier": [9, 10, 9, 11], "depth2": [7, 13], "handoff": [11],
        "sampled": [8], "shared": [12], "tail": [3]}
#: The host tier's order of requests (A B C D A B).
TIER_ORDER = (0, 1, 2, 3, 0, 1)
#: The counters a slice's scenario holds to the one-card engine's.
KEYS = ("completed", "chunks", "prefix_hits", "spec_chunks",
        "spec_proposed", "spec_accepted", "spec_emitted", "draft_prefills",
        "generated_tokens", "prefill_chunks", "batches", "oneshot_inserts",
        "prefix_dram_hits", "prefix_dram_demotions", "handoff_exports",
        "handoff_export_blocks", "handoff_imports", "handoff_import_blocks")
SP_KEYS = ("sp_prefills", "sp_whole_prefills")
#: Scenarios served on the caller's mesh, each also on one card.
MESH_SCENARIOS = ("chunked", "batch", "quant", "draft", "tier", "depth2")


def _tie_free_pair(jcfg, jparams, shared, tails):
    """A prompt sharing ``shared``'s first 8 tokens (two 4-token blocks)
    whose JAX greedy path is tie-free: the first tail that gives one."""
    for tail in tails:
        prompt = np.concatenate([shared[:8], tail]).astype(np.int32)
        gaps, _ = greedy_gaps(jcfg, jparams, prompt[None],
                              np.asarray([len(prompt)], np.int32), MAX_NEW)
        if gaps[0] > TIE_GAP:
            return prompt
    raise AssertionError("no tie-free prompt over the shared head")


def _jax_engine(jcfg, jparams, prompts, shape, *, kv_quant=False):
    """The JAX engine's greedy tokens for ``prompts``, one at a time."""
    serve = JaxServeConfig(max_new_tokens=MAX_NEW, prompt_buckets=(5, 8, 16),
                           num_slots=2, chunk_tokens=2, mesh_shape=shape,
                           kv_quant=kv_quant)
    with JaxServingEngine(jparams, jcfg, serve) as eng:
        return [np.asarray(eng.submit(p).result(300).tokens)
                for p in prompts]


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The prompts of every scenario, and the tokens JAX ``generate`` and
    the JAX engine at each shape give them; the port's side starts on
    them in the background (``port``: futures of the spawned child's and
    each caller mesh's outputs) while the JAX engines run."""
    jcfg, jparams, _, _ = tiny_models(seed=2, num_layers=2)
    drawn = iter(tie_free_rows(jcfg, jparams,
                               [n for lens in LENS.values() for n in lens],
                               MAX_NEW, seed=31))
    rows = {key: [next(drawn) for _ in lens] for key, lens in LENS.items()}
    shared = rows.pop("shared")[0]
    rng = np.random.default_rng(32)
    tails = [rng.integers(1, jcfg.vocab_size, 3) for _ in range(16)]
    rows["chunked"] = [shared, _tie_free_pair(jcfg, jparams, shared,
                                              [rows.pop("tail")[0]] + tails)]
    rows["quant"] = tie_free_rows(jcfg, jparams, [5, 10], MAX_NEW, seed=33,
                                  kv_quant=True)
    dcfg, dparams, _, _ = tiny_models(seed=7, num_layers=1)
    inputs = {**model_inputs(jcfg, jparams),
              **model_inputs(dcfg, dparams, prefix="drafter")}
    for key, prompts in rows.items():
        for i, p in enumerate(prompts):
            inputs[f"{key}/{i:02d}"] = np.asarray(p, np.int32)
    prefill = _prefill_inputs(jcfg, jparams)
    with concurrent.futures.ThreadPoolExecutor(len(SHAPES) + 1) as pool:
        port = {"spawned": pool.submit(
            run_port_side,
            f"MAX_NEW = {MAX_NEW}\nKEYS = {KEYS!r}\nSP_KEYS = {SP_KEYS!r}\n"
            + _SPAWNED, {k: v for k, v in inputs.items()
                         if not k.startswith("drafter")},
            tmp_path_factory.mktemp("sp_spawned"), timeout=300)}
        for shape in SHAPES:
            port[shape] = pool.submit(
                _on_ranks,
                f"SIZES = {SIZES[shape]!r}\nMAX_NEW = {MAX_NEW}\n"
                f"KEYS = {KEYS!r}\nSP_KEYS = {SP_KEYS!r}\n"
                f"TIER_ORDER = {TIER_ORDER!r}\n" + _CALLER,
                shape[0] * shape[1], inputs,
                tmp_path_factory.mktemp("sp_caller"))
        for sp in PREFILL_SP:
            port["prefill", sp] = pool.submit(
                _on_ranks, _PREFILL, sp, prefill,
                tmp_path_factory.mktemp("sp_prefill"))
        greedy = [k for k in rows if k not in ("quant", "sampled")]
        flat = [p for k in greedy for p in rows[k]]
        want, engine = {}, {}
        gen = iter(_expected(jcfg, jparams, flat, MAX_NEW))
        for key in greedy:
            want[key] = [next(gen) for _ in rows[key]]
        want["quant"] = _expected(jcfg, jparams, rows["quant"], MAX_NEW,
                                  kv_quant=True)
        for shape in SHAPES:
            got = iter(_jax_engine(jcfg, jparams, flat, shape))
            engine[shape] = {key: [next(got) for _ in rows[key]]
                             for key in greedy}
            engine[shape]["quant"] = _jax_engine(
                jcfg, jparams, rows["quant"], shape, kv_quant=True)
        yield {"rows": rows, "want": want, "engine": engine, "port": port,
               "jax": (jcfg, jparams)}


def _same_tokens(got, *wants, what):
    for want in wants:
        np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# Slices spawned by mesh_shape, in one JAX-free child.

_SPAWNED = """
import dataclasses
from cloud_tpu_torch.fleet import Fleet, FleetConfig
from cloud_tpu_torch.serving import ServeConfig, ServingEngine

cfg, params = port_model()
prompts = [IN[k] for k in sorted(IN) if k.startswith("insert/")]
serve = ServeConfig(max_new_tokens=MAX_NEW, prompt_buckets=(5, 8, 16),
                    num_slots=2, chunk_tokens=2)
for side, shape in (("one", None), ("1x2", (1, 2)), ("2x2", (2, 2))):
    with ServingEngine(params, cfg, dataclasses.replace(
            serve, mesh_shape=shape), device="cpu") as eng:
        res = [eng.submit(p).result(120) for p in prompts]
        stats, health = eng.stats(), eng.health()
    for i, r in enumerate(res):
        OUT[f"{side}/tokens/{i}"] = r.tokens
    OUT[f"{side}/stats"] = np.asarray([stats[k] for k in KEYS + SP_KEYS])
    OUT[f"{side}/slice"] = np.asarray(
        [health["slice_chips"], *health["slice_shape"]])

fleet = Fleet(lambda: ServingEngine(params, cfg, dataclasses.replace(
    serve, mesh_shape=(1, 2)), device="cpu"),
    FleetConfig(min_replicas=1, max_replicas=1))
try:
    res = [fleet.submit(p).result(120) for p in prompts]
    health = fleet.health()
finally:
    fleet.close()
for i, r in enumerate(res):
    OUT[f"fleet/tokens/{i}"] = r.tokens
OUT["fleet/chips"] = np.asarray(
    [health["total_chips"], health["replicas"][0]["slice_chips"]])
"""


@pytest.fixture(scope="module")
def spawned(oracle):
    return oracle["port"]["spawned"].result()


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
@pytest.mark.parametrize("bucket", ["split", "whole"])
def test_one_shot_inserts_on_a_spawned_slice(oracle, spawned, shape,
                                             bucket):
    """Buckets 8 and 16 prefill split over sp; bucket 5 (sp 2 does not
    divide it) whole on every sp member.  Tokens equal the JAX engine's at
    the same shape, JAX ``generate``'s and the one-card engine's."""
    side = _shape_id(shape)
    requests = [0] if bucket == "whole" else [1, 2]
    for i in requests:
        _same_tokens(spawned[f"{side}/tokens/{i}"],
                     oracle["want"]["insert"][i],
                     oracle["engine"][shape]["insert"][i],
                     spawned[f"one/tokens/{i}"],
                     what=f"{side} request {i}")
    stats = dict(zip(KEYS + SP_KEYS, spawned[f"{side}/stats"]))
    one = dict(zip(KEYS + SP_KEYS, spawned["one/stats"]))
    assert {k: stats[k] for k in KEYS} == {k: one[k] for k in KEYS}
    assert (stats["sp_prefills"], stats["sp_whole_prefills"]) == (2, 1)
    assert (one["sp_prefills"], one["sp_whole_prefills"]) == (0, 0)
    assert spawned[f"{side}/slice"].tolist() == [shape[0] * shape[1],
                                                 *shape]


def test_fleet_of_one_sp_slice(oracle, spawned):
    for i, want in enumerate(oracle["want"]["insert"]):
        np.testing.assert_array_equal(spawned[f"fleet/tokens/{i}"], want)
    assert spawned["fleet/chips"].tolist() == [2, 2]


# ---------------------------------------------------------------------------
# A caller's mesh: rank 0 serves, the others follow.

_RANK_HEAD = """
import datetime
import os
import torch.distributed as dist
from cloud_tpu_torch.parallel import MeshSpec
RANK = int(os.environ["CLOUD_TPU_PROCESS_ID"])
WORLD = int(os.environ["CLOUD_TPU_NUM_PROCESSES"])
dist.init_process_group("gloo", init_method="file://" + sys.argv[3],
                        world_size=WORLD, rank=RANK,
                        timeout=datetime.timedelta(seconds=90))
"""


def _on_ranks(script, world, inputs, workdir, *, timeout=240):
    """``script`` on ``world`` JAX-free gloo ranks (``IN`` the inputs,
    ``RANK``/``WORLD`` set, the default group made); each rank's ``OUT``."""
    workdir = pathlib.Path(workdir)
    np.savez(workdir / "in.npz", **inputs)
    code = (_PRELUDE + _RANK_HEAD + script
            + "\ndist.destroy_process_group()\nnp.savez(sys.argv[2], **OUT)\n")
    done = launch_ranks(
        code, world, lambda rank: [str(workdir / "in.npz"),
                                   str(workdir / f"out{rank}.npz"),
                                   str(workdir / "rendezvous")],
        timeout=timeout, env={"CLOUD_TPU_COORDINATOR": "127.0.0.1:0"})
    for rank, (rc, _, stderr) in enumerate(done):
        assert rc == 0, f"rank {rank}: {stderr[-3000:]}"
    return [dict(np.load(workdir / f"out{rank}.npz")) for rank in range(world)]


_CALLER = """
import dataclasses
from cloud_tpu_torch.models.generation import SampleConfig
from cloud_tpu_torch.serving import DraftConfig, ServeConfig, ServingEngine

mesh = MeshSpec(SIZES).build(devices=["cpu"] * WORLD)
cfg, params = port_model()
dcfg, dparams = port_model("drafter")
LEADER = RANK == 0


def rows(key):
    return [IN[k] for k in sorted(IN) if k.startswith(key + "/")]


def serve_on(side, name, serve, requests, record=None):
    \"\"\"Serve ``(prompt, submit kwargs)`` one at a time on the slice (every
    rank) or on one card (rank 0 alone); rank 0 keeps the results.\"\"\"
    if side == "one" and not LEADER:
        return None
    eng = ServingEngine(params, cfg, serve, device="cpu",
                        mesh=mesh if side == "slice" else None)
    if record is not None:
        record(eng)
    if not LEADER:
        eng.follow()
        return None
    try:
        res = [eng.submit(p, **kw).result(120) for p, kw in requests]
        stats, health = eng.stats(), eng.health()
    finally:
        eng.close()
    for i, r in enumerate(res):
        OUT[f"{name}/{side}/tokens/{i}"] = r.tokens
    OUT[f"{name}/{side}/stats"] = np.asarray(
        [stats[k] for k in KEYS + SP_KEYS])
    OUT[f"{name}/{side}/slice"] = np.asarray(
        [health["slice_chips"], *health["slice_shape"]])
    return res


base = dict(max_new_tokens=MAX_NEW, num_slots=2, chunk_tokens=2)
pool = dict(prefix_block_tokens=4, decode_kernel="pallas")
SERVES = {
    "chunked": ServeConfig(**base, **pool, prompt_buckets=(16,),
                           prefix_cache_blocks=8, prefill_chunk_tokens=4),
    "batch": ServeConfig(**base, prompt_buckets=(8, 16), scheduler="batch",
                         batch_buckets=(1, 2)),
    "quant": ServeConfig(**base, prompt_buckets=(8, 16), kv_quant=True),
    "draft": ServeConfig(**base, prompt_buckets=(8, 16), draft=DraftConfig(
        config=dcfg, params=dparams, spec_k=3)),
    "tier": ServeConfig(**base, **pool, prompt_buckets=(16,),
                        prefix_cache_blocks=4, prefix_dram_blocks=8),
    "depth2": ServeConfig(**base, prompt_buckets=(8, 16), pipeline_depth=2),
}
for name, serve in SERVES.items():
    prompts = rows(name)
    if name == "tier":
        prompts = [prompts[i] for i in TIER_ORDER]
    for side in ("slice", "one"):
        serve_on(side, name, serve, [(p, {}) for p in prompts])

# The KV handoff each way: one card's payload imported on the slice, the
# slice's on one card.
handoff = ServeConfig(**base, **pool, prompt_buckets=(16,),
                      prefix_cache_blocks=8)
prompt = rows("handoff")[0]
payloads = {}
for side in ("one", "slice"):
    got = serve_on(side, f"export_{side}", dataclasses.replace(
        handoff, role="prefill"),
        [(prompt, dict(max_new_tokens=1, handoff_export=True))])
    if got is not None:
        payloads[side] = got[0].handoff
for source, side in (("one", "slice"), ("slice", "one"), ("one", "one")):
    serve_on(side, f"import_{source}", dataclasses.replace(
        handoff, role="decode"),
        [(prompt, dict(handoff=payloads.get(source)))])
if LEADER:
    one, whole = payloads["one"], payloads["slice"]
    OUT["export/keys"] = np.asarray(
        [one["keys"] == whole["keys"], len(one["payloads"]),
         len(whole["payloads"])])
    OUT["export/err"] = np.asarray(max(
        float((a[n].float() - b[n].float()).abs().max())
        for a, b in zip(one["payloads"], whole["payloads"]) for n in a))

# A nucleus-sampled request: each rank records what its programs drew.
drawn = []


def record(eng):
    insert, chunk = eng._op_insert, eng._op_chunk

    def op_insert(**kw):
        tok = insert(**kw)
        drawn.append(int(tok))
        return tok

    def op_chunk():
        out = chunk()
        toks, valid = out[0], out[1]
        drawn.extend(toks[valid].tolist())
        return out

    eng._op_insert, eng._op_chunk = op_insert, op_chunk


sampled = ServeConfig(**base, prompt_buckets=(8,), seed=5,
                      sample=SampleConfig(temperature=0.8, top_p=0.9))
serve_on("slice", "sampled", sampled, [(rows("sampled")[0], {})],
         record=record)
OUT["sampled/drawn"] = np.asarray(drawn)
"""


@pytest.fixture(scope="module", params=SHAPES, ids=_shape_id)
def caller(request, oracle):
    return request.param, oracle["port"][request.param].result()


def _served(name, count):
    if name == "tier":
        return list(TIER_ORDER)
    return list(range(count))


@pytest.mark.parametrize("name", MESH_SCENARIOS)
def test_caller_mesh_scenarios(oracle, caller, name):
    """Tokens equal the JAX engine's at the same shape, JAX ``generate``'s
    and the one-card engine's; the counters equal the one-card
    engine's."""
    shape, outs = caller
    out = outs[0]
    rows = oracle["rows"][name]
    for n, i in enumerate(_served(name, len(rows))):
        _same_tokens(out[f"{name}/slice/tokens/{n}"], oracle["want"][name][i],
                     oracle["engine"][shape][name][i],
                     out[f"{name}/one/tokens/{n}"],
                     what=f"{name} at {shape}, request {n}")
    stats = dict(zip(KEYS + SP_KEYS, out[f"{name}/slice/stats"]))
    one = dict(zip(KEYS + SP_KEYS, out[f"{name}/one/stats"]))
    assert {k: stats[k] for k in KEYS} == {k: one[k] for k in KEYS}, name
    assert out[f"{name}/slice/slice"].tolist() == [shape[0] * shape[1],
                                                   *shape]
    # One-shot prefills (the draft's excluded) of widths 8 and 16 split.
    assert stats["sp_whole_prefills"] == 0
    assert stats["sp_prefills"] == stats["oneshot_inserts"] + stats["batches"]
    if name == "chunked":
        assert stats["prefix_hits"] == 1 and stats["prefill_chunks"] == 4
        assert stats["sp_prefills"] == 0
    if name == "draft":
        assert stats["spec_chunks"] > 0
        assert stats["draft_prefills"] == len(rows)
    if name == "tier":
        assert stats["prefix_dram_demotions"] >= 1
        assert stats["prefix_dram_hits"] >= 1
    if name == "batch":
        assert stats["batches"] == len(rows)


@pytest.mark.parametrize("direction", ["one-to-slice", "slice-to-one"])
def test_caller_mesh_kv_handoff(oracle, caller, direction):
    shape, outs = caller
    out = outs[0]
    source = direction.split("-")[0]
    side = "slice" if source == "one" else "one"
    want = oracle["want"]["handoff"][0]
    _same_tokens(out[f"import_{source}/{side}/tokens/0"], want,
                 oracle["engine"][shape]["handoff"][0], what=direction)
    stats = dict(zip(KEYS + SP_KEYS, out[f"import_{source}/{side}/stats"]))
    ref = dict(zip(KEYS + SP_KEYS, out["import_one/one/stats"]))
    assert stats["handoff_imports"] == 1 and stats["prefix_hits"] == 1
    assert {k: stats[k] for k in KEYS} == {k: ref[k] for k in KEYS}
    same_keys, n_one, n_slice = out["export/keys"].tolist()
    assert same_keys and n_one == n_slice == 2  # 11 tokens: 2 full blocks
    assert float(out["export/err"]) <= 1e-5


def test_caller_mesh_sampled_request_draws_alike_on_every_rank(oracle,
                                                               caller):
    shape, outs = caller
    drawn = [out["sampled/drawn"] for out in outs]
    tokens = outs[0]["sampled/slice/tokens/0"]
    assert len(tokens) == MAX_NEW
    assert ((tokens >= 0) & (tokens < oracle["jax"][0].vocab_size)).all()
    np.testing.assert_array_equal(drawn[0], tokens)
    for rank, got in enumerate(drawn[1:], start=1):
        np.testing.assert_array_equal(got, drawn[0],
                                      err_msg=f"rank {rank} at {shape}")


# ---------------------------------------------------------------------------
# The split prefill against JAX prefill_program.

#: The split prefill's sp sizes, and its batch: two 16-token rows, row 1's
#: last real position (6) in block 0 at either size.
PREFILL_SP = (2, 4)


def _prefill_inputs(jcfg, jparams):
    rng = np.random.default_rng(40)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 16)).astype(np.int32)
    return {**model_inputs(jcfg, jparams), "tokens": tokens,
            "lens": np.asarray([16, 7], np.int32)}


_PREFILL = """
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import generation

mesh = MeshSpec({"sp": WORLD}).build(devices=["cpu"] * WORLD)
cfg, _ = port_model()
shard = bridge.to_torch_shard(tree("params"), cfg, mesh, device="cpu")
cache, logits = generation.prefill_program(
    shard, torch.from_numpy(IN["tokens"]), torch.from_numpy(IN["lens"]),
    cfg, max_new_tokens=2)
OUT["k"], OUT["v"] = cache["k"].numpy(), cache["v"].numpy()
OUT["logits"] = logits.numpy()
"""


@pytest.mark.parametrize("sp", PREFILL_SP)
def test_split_prefill_matches_jax_prefill_program(oracle, sp):
    jcfg, jparams = oracle["jax"]
    inputs = _prefill_inputs(jcfg, jparams)
    cache, logits = jax_gen.prefill_program(
        jparams, jnp.asarray(inputs["tokens"]), jnp.asarray(inputs["lens"]),
        jcfg, max_new_tokens=2)
    for out in oracle["port"]["prefill", sp].result():
        # Every rank holds the whole cache and the same logits.
        for name in ("k", "v"):
            np.testing.assert_allclose(out[name], np.asarray(cache[name]),
                                       rtol=0, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(out["logits"], np.asarray(logits),
                                   rtol=0, atol=1e-4)
