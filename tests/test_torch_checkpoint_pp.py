"""Checkpoints of a state whose layer list is cut over ``pp`` (a pipeline
stage's block of layers; ``cloud_tpu_torch.training.checkpoint``), on 2
gloo ranks on the CPU.

CloudLM TINY (4 layers, f32) with an SGD momentum trace drawn from a
seed, so the optimizer's leaves are not zero and follow their parameters.
Under ``{pp: 2}`` (rules ``layers -> pp``) each rank holds two layers at
local list indices 0 and 1:

* the pp-2 save's index lists the same tree, keys, shapes and dtypes as
  one process's save of the whole state; every layer's leaves (the
  parameters' and the trace's) are one piece, written by the rank of its
  stage under the layer's global index; the rest is written once, by
  rank 0;
* four restores give the tensors bit for bit: the pp-2 save into pp 2,
  into one process (with and without a template) and into ``{fsdp: 2}``,
  and a one-process save into pp 2.
"""

import json
import os

import numpy as np
import torch

from cloud_tpu_torch.training import checkpoint
from helpers.torch_port import run_ranks

torch.set_num_threads(1)

STEP = 3

#: The state, on every rank and in the test alike.
_STATE = """
from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import transformer
from cloud_tpu_torch.parallel import sharding
from cloud_tpu_torch.training import checkpoint, train

cfg = transformer.TINY.scaled(dtype=torch.float32)
axes = transformer.param_logical_axes(cfg)
PP_RULES = sharding.DEFAULT_RULES.extended(layers="pp")


def full_state():
    params = bridge.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    trace = bridge.map_leaves(
        params, lambda p: torch.randn(p.shape, generator=gen))
    return train.TrainState(step=torch.tensor(3, dtype=torch.int32),
                            params=params, opt_state={"trace": trace},
                            rng=None)


def shard(state, mesh, rules=sharding.DEFAULT_RULES):
    cut = lambda tree: sharding.shard_tree(tree, axes, mesh, rules)
    return train.TrainState(step=state.step, params=cut(state.params),
                            opt_state={"trace": cut(state.opt_state["trace"])},
                            rng=None)


def zeros(state):
    return train.TrainState(
        step=torch.zeros_like(state.step),
        params=bridge.map_leaves(state.params, torch.zeros_like),
        opt_state=bridge.map_leaves(state.opt_state, torch.zeros_like),
        rng=None)


def same(a, b):
    return bool(torch.equal(a.step, b.step) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(
            bridge.leaves(a.params) + bridge.leaves(a.opt_state),
            bridge.leaves(b.params) + bridge.leaves(b.opt_state))))
"""

_RANKS = _STATE + """
import os

ROOT = IN["root"].item()
full = full_state()
pp = MeshSpec({"pp": 2}).build(devices=["cpu"] * 2)
pp_layout = checkpoint.StateLayout(mesh=pp, logical_axes=axes, rules=PP_RULES)
mine = shard(full, pp, PP_RULES)
OUT["layers"] = len(mine.params["layers"])
saved = checkpoint.CheckpointManager(os.path.join(ROOT, "pp"), device="cpu",
                                     layout=pp_layout)
saved.save(STEP, mine)
saved.wait()
OUT["pp into pp"] = same(saved.restore(STEP, template=zeros(mine)), mine)
fsdp = MeshSpec({"fsdp": 2}).build(devices=["cpu"] * 2)
want = shard(full, fsdp)
OUT["pp into fsdp"] = same(saved.restore(
    STEP, template=zeros(want),
    layout=checkpoint.StateLayout(mesh=fsdp, logical_axes=axes)), want)
one = checkpoint.CheckpointManager(os.path.join(ROOT, "one"), device="cpu",
                                   layout=pp_layout)
OUT["one into pp"] = same(one.restore(STEP, template=zeros(mine)), mine)
saved.close()
one.close()
"""

_NS = {"torch": torch}
exec(_STATE, _NS)


def _index(path):
    with open(os.path.join(path, str(STEP), checkpoint.INDEX_NAME)) as f:
        return json.load(f)


def test_pipeline_stage_checkpoint_round_trips(tmp_path):
    full = _NS["full_state"]()
    one = checkpoint.CheckpointManager(str(tmp_path / "one"), device="cpu")
    one.save(STEP, full)
    one.close()
    outs = run_ranks(f"STEP = {STEP}\n" + _RANKS, 2,
                     files={"root": np.asarray(str(tmp_path))})
    for out in outs:
        assert out["layers"] == 2
        assert out["pp into pp"] and out["pp into fsdp"]
        assert out["one into pp"]

    got, want = _index(tmp_path / "pp"), _index(tmp_path / "one")
    assert got["tree"] == want["tree"]
    assert [(e["key"], e["shape"], e["dtype"]) for e in got["leaves"]] == \
        [(e["key"], e["shape"], e["dtype"]) for e in want["leaves"]]
    assert got["mesh"] == {"pp": 2} and got["processes"] == 2
    layer_leaves = 0
    for i, entry in enumerate(got["leaves"]):
        key = entry["key"]
        whole = [[0, n] for n in entry["shape"]]
        assert [p["bounds"] for p in entry["pieces"]] == [whole], key
        parts = key.split("/")
        if "layers" in parts:
            layer = int(parts[parts.index("layers") + 1])
            writer = layer // 2  # the stage holding the layer
            layer_leaves += 1
        else:
            writer = 0
        assert entry["pieces"][0]["file"] == f"{i}.r{writer}.bin", key
        assert (tmp_path / "pp" / str(STEP) / f"{i}.r{writer}.bin").exists()
    # The parameters' and the trace's leaves of all 4 layers.
    n_layer = len(_NS["bridge"].leaves(full.params["layers"][0]))
    assert layer_leaves == 2 * 4 * n_layer

    reader = checkpoint.CheckpointManager(str(tmp_path / "pp"), device="cpu")
    into_one = reader.restore(STEP, template=_NS["zeros"](full))
    assert _NS["same"](into_one, full)
    free = reader.restore(STEP)
    assert _NS["same"](free, full)
    reader.close()
