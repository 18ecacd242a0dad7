"""The port's batch scheduler (``scheduler="batch"``) on the CPU, against JAX.

The same seeded TINY weights (through ``bridge``) and tie-free prompts go
through the JAX engine's batch scheduler and the port's, the port's side
in a child process that never imports JAX.  Greedy f32 results are
token-identical to the JAX engine and to JAX ``generate``; so are the
int8-weight, int8-cache (``kv_quant``) results to their quantized JAX
counterparts.  Batches form the same way on both sides (a full largest
batch at once, the rest when ``close()`` drains the queue), so the batch
counters agree too.  In bf16 the port's batch engine equals the port's own
``generate`` on the same padded batch, and ``warmup`` changes no token.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cloud_tpu.models import generation as jax_gen
from cloud_tpu.serving import ServeConfig as JaxServeConfig
from cloud_tpu.serving import ServingEngine as JaxServingEngine
from helpers.torch_port import (
    model_inputs,
    run_port_side,
    tie_free_prompts,
    tiny_models,
)

torch.set_num_threads(1)

MAX_NEW = 6
BUCKETS = (8, 16)
#: Six prompts: four of the 16 bucket (a full largest batch), two of 8.
LENS = (12, 14, 10, 16, 5, 7)
#: Long enough that no batch flushes on its deadline inside a test.
FLUSH_S = 600.0

SERVE = dict(max_new_tokens=MAX_NEW, prompt_buckets=BUCKETS,
             batch_buckets=(1, 2, 4), flush_deadline_s=FLUSH_S,
             scheduler="batch")

_PORT_SIDE = """
from cloud_tpu_torch.models import generation
from cloud_tpu_torch.serving import ServeConfig, ServingEngine

serve = json.loads(str(IN["serve"]))
prompts = [IN["prompts"][i, :n] for i, n in enumerate(IN["lens"])]


def serve_all(params, cfg, **kw):
    engine = ServingEngine(params, cfg, ServeConfig(**serve, **kw),
                           device="cpu")
    engine.wait_ready()
    futures = [engine.submit(p) for p in prompts]
    engine.close()  # drains what is left: the partial batch
    results = [f.result(timeout=300) for f in futures]
    return results, engine.stats()


for name, kw in (("f32", {}), ("warm", {"warmup": True}),
                 ("int8", {"kv_quant": True})):
    cfg, params = port_model("qparams" if name == "int8" else "params")
    results, stats = serve_all(params, cfg, **kw)
    OUT[name + ".tokens"] = np.stack([r.tokens for r in results])
    OUT[name + ".batch_size"] = np.array([r.batch_size for r in results])
    OUT[name + ".counters"] = np.array(
        [stats[k] for k in ("batches", "slots", "real_rows", "completed",
                            "generated_tokens", "batch_decode_steps")])
    OUT[name + ".occupancy"] = np.array(stats["mean_batch_occupancy"])

cfg, params = port_model("params", dtype=torch.bfloat16)
results, _ = serve_all(params, cfg)
OUT["bf16.tokens"] = np.stack([r.tokens for r in results])
# generate() on the batch the engine ran: the four 16-bucket prompts
# padded to 16.
batch = np.zeros((4, 16), np.int32)
for i in range(4):
    batch[i, :IN["lens"][i]] = prompts[i]
OUT["bf16.generate"] = generation.generate(
    params, torch.from_numpy(batch), torch.from_numpy(IN["lens"][:4]), cfg,
    max_new_tokens=serve["max_new_tokens"], device="cpu")["tokens"].numpy()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The prompts, the JAX side's results and the port's."""
    jax_cfg, params, _, _ = tiny_models(seed=5, num_layers=2)
    _, qparams, _, _ = tiny_models(seed=5, num_layers=2, quantized=True)
    toks, _, _ = tie_free_prompts(jax_cfg, params, batch=len(LENS),
                                  max_len=16, max_new_tokens=MAX_NEW,
                                  seed=900)
    lens = np.array(LENS, np.int32)
    prompts = [toks[i, :n] for i, n in enumerate(lens)]
    want = {}
    for name, p, kw in (("f32", params, {}),
                        ("int8", qparams, {"kv_quant": True})):
        engine = JaxServingEngine(p, jax_cfg, JaxServeConfig(**SERVE, **kw))
        futures = [engine.submit(x) for x in prompts]
        engine.close()
        results = [f.result(timeout=300) for f in futures]
        stats = engine.stats()
        want[name + ".tokens"] = np.stack([r.tokens for r in results])
        want[name + ".batch_size"] = np.array([r.batch_size
                                               for r in results])
        want[name + ".counters"] = np.array(
            [stats[k] for k in ("batches", "slots", "real_rows",
                                "completed", "generated_tokens")]
            + [stats["batches"] * (MAX_NEW - 1)])
        want[name + ".occupancy"] = np.array(stats["mean_batch_occupancy"])
    padded = np.zeros((len(LENS), 16), np.int32)
    for i, n in enumerate(lens):
        padded[i, :n] = prompts[i]
    for name, p, kv_quant in (("f32", params, False), ("int8", qparams,
                                                        True)):
        want[name + ".generate"] = np.asarray(jax_gen.generate(
            p, jnp.asarray(padded), jnp.asarray(lens), jax_cfg,
            max_new_tokens=MAX_NEW, kv_quant=kv_quant)["tokens"])
    inputs = dict(model_inputs(jax_cfg, params),
                  **model_inputs(jax_cfg, qparams, "qparams"),
                  prompts=padded, lens=lens,
                  serve=np.asarray(json.dumps(SERVE)))
    got = run_port_side(_PORT_SIDE, inputs,
                        tmp_path_factory.mktemp("serving_batch"))
    return want, got


@pytest.mark.parametrize("name", ["f32", "int8"])
def test_batch_engine_token_identical_to_jax_engine_and_generate(runs, name):
    """f32: JAX's batch engine and ``generate``; int8 weights with an int8
    cache: the quantized JAX engine and ``generate(kv_quant=True)``."""
    want, got = runs
    np.testing.assert_array_equal(got[name + ".tokens"],
                                  want[name + ".tokens"])
    np.testing.assert_array_equal(got[name + ".tokens"],
                                  want[name + ".generate"])


@pytest.mark.parametrize("name", ["f32", "int8"])
def test_batches_form_as_in_jax(runs, name):
    """A full batch of four at once, the two left when the queue drains:
    the same batch sizes and counters (batches, padded rows, real rows,
    completed, generated tokens, decode steps) and occupancy as JAX."""
    want, got = runs
    np.testing.assert_array_equal(got[name + ".batch_size"],
                                  want[name + ".batch_size"])
    np.testing.assert_array_equal(got[name + ".batch_size"],
                                  [4, 4, 4, 4, 2, 2])
    np.testing.assert_array_equal(got[name + ".counters"],
                                  want[name + ".counters"])
    assert float(got[name + ".occupancy"]) == float(
        want[name + ".occupancy"]) == 1.0


def test_batch_warmup_changes_no_token(runs):
    """``warmup=True`` runs each batch bucket once before serving."""
    _, got = runs
    np.testing.assert_array_equal(got["warm.tokens"], got["f32.tokens"])
    np.testing.assert_array_equal(got["warm.counters"], got["f32.counters"])


def test_bf16_batch_engine_equals_port_generate_on_its_batch(runs):
    """In bf16 the engine computes what ``generate`` computes on the same
    padded batch, bit for bit."""
    _, got = runs
    np.testing.assert_array_equal(got["bf16.tokens"][:4],
                                  got["bf16.generate"])


def test_batch_engine_resolves_every_request(runs):
    """Every request of the f32 run resolved with ``MAX_NEW`` tokens."""
    want, got = runs
    assert got["f32.tokens"].shape == (len(LENS), MAX_NEW)
    assert int(got["f32.counters"][3]) == len(LENS)
    assert int(got["f32.counters"][4]) == len(LENS) * MAX_NEW
