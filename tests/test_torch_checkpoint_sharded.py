"""Checkpoints of a state sharded over a mesh of several ranks
(``cloud_tpu_torch.training.checkpoint``), on 2 gloo ranks on the CPU.

* CloudLM TINY (f32, SGD with momentum, so the optimizer's trace is
  sharded too) under ``{fsdp: 2}`` and under ``{tp: 2}``: one step, a
  save at step 1 (each rank writes its own pieces), a restore straight
  into the shards, one more step.  The loss and the parameters equal the
  uninterrupted run's bit for bit (the JAX package's
  ``test_restore_directly_into_sharded_layout`` holds the loss to 1e-6).
  The chief's manifest covers both ranks' files, the index records every
  leaf's global shape, logical axes, the mesh and each piece's bounds,
  and ``verify()`` says ``verified``.
* A one-process save restored into each mesh gives each rank its
  ``shard_tree`` slice; a mesh save restored into one process (with and
  without a template) gives the gathered state.
* A damaged piece of rank 1 (caught by the manifest) and a truncated
  piece of an unmanifested step (caught by rank 1's restore alone) make
  both ranks walk back to the same older step.
* A manager given no layout under a global ``{fsdp: 2}`` or ``{tp: 2}``
  mesh refuses to save and to restore; under ``{dp: 2}`` it saves every
  leaf once, from rank 0.
* With a process group and no mesh, only rank 0 writes: every piece, the
  index, the manifest and the extras sidecar.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import transformer
from cloud_tpu_torch.parallel import sharding
from cloud_tpu_torch.training import checkpoint, optimizers, train
from helpers.torch_port import run_ranks

torch.set_num_threads(1)

CFG = dataclasses.replace(transformer.TINY, dtype=torch.float32)
ARMS = ({"fsdp": 2}, {"tp": 2})

_RANKS = """
import dataclasses
import functools
import glob
import os
import types

from cloud_tpu_torch import bridge
from cloud_tpu_torch.models import transformer
from cloud_tpu_torch.parallel import sharding
from cloud_tpu_torch.training import checkpoint, optimizers, train

ROOT = IN["root"].item()
cfg = dataclasses.replace(transformer.TINY, dtype=torch.float32)
axes = transformer.param_logical_axes(cfg)
tokens = IN["tokens"]
tx = optimizers.sgd(0.1, momentum=0.9)


def flat(tree, prefix=""):
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(flat(v, key))
        else:
            out[key] = v.detach().numpy().ravel().tolist()
    return out


def clone(state):
    return train.TrainState(
        step=state.step.clone(),
        params=bridge.map_leaves(
            state.params, lambda t: t.detach().clone().requires_grad_(True)),
        opt_state=bridge.map_leaves(state.opt_state,
                                    lambda t: t.detach().clone()),
        rng=None)


for sizes in ({"fsdp": 2}, {"tp": 2}):
    name = "-".join(f"{k}{v}" for k, v in sizes.items())
    mesh = MeshSpec(sizes).build(devices=["cpu"] * WORLD)
    layout = checkpoint.StateLayout(mesh=mesh, logical_axes=axes)
    state = train.create_sharded_state(
        torch.Generator().manual_seed(0),
        lambda g: bridge.init(cfg, g, device="cpu"), tx, mesh,
        logical_axes=axes)
    step = train.make_train_step(
        functools.partial(transformer.loss_fn, config=cfg, mesh=mesh), tx,
        logical_axes=axes, mesh=mesh)
    data = mesh.axis_index("fsdp") if sizes.get("fsdp") else 0
    rows = tokens[data * 8 // mesh.axis_size("fsdp"):
                  (data + 1) * 8 // mesh.axis_size("fsdp")]
    batch = train.shard_batch({"tokens": rows}, mesh)
    state, _ = step(state, batch)
    manager = checkpoint.CheckpointManager(os.path.join(ROOT, name),
                                           device="cpu", layout=layout)
    manager.save(1, state)
    manager.wait()
    ref_state, ref = step(clone(state), batch)
    restored = manager.restore(1, template=state)
    got_state, got = step(restored, batch)
    OUT[name] = {
        "ref_loss": float(ref["loss"]), "loss": float(got["loss"]),
        "same": all(torch.equal(a, b) for a, b in zip(
            bridge.leaves(got_state.params) + bridge.leaves(
                got_state.opt_state),
            bridge.leaves(ref_state.params) + bridge.leaves(
                ref_state.opt_state))),
        "verify": manager.verify(1),
        "gathered": flat(sharding.gather_tree(state.params, axes, mesh)),
    }
    # A one-process save restored into this mesh's shards.
    onep = checkpoint.CheckpointManager(os.path.join(ROOT, "one-process"),
                                        device="cpu", layout=layout)
    fresh = train.create_sharded_state(
        torch.Generator().manual_seed(0),
        lambda g: bridge.init(cfg, g, device="cpu"), tx, mesh,
        logical_axes=axes)
    into = onep.restore(0, template=fresh)
    OUT[name]["one_process_into_mesh"] = flat(into.params)
    OUT[name]["local"] = flat(fresh.params)
    manager.close()

    # Walk-back: save at 1 and 2; damage step 2 on rank 1 only.
    for kind in ("corrupt", "unmanifested"):
        d = os.path.join(ROOT, f"{name}-{kind}")
        walk = checkpoint.CheckpointManager(d, device="cpu", layout=layout)
        s1 = clone(state)
        walk.save(1, s1)
        s2, _ = step(clone(state), batch)
        walk.save(2, s2)
        walk.wait()
        torch.distributed.barrier()
        if RANK == 1:
            piece = sorted(glob.glob(os.path.join(d, "2", "*.r1.bin")))[0]
            if kind == "corrupt":
                with open(piece, "r+b") as f:
                    f.seek(0)
                    byte = f.read(1)
                    f.seek(0)
                    f.write(bytes([byte[0] ^ 0xFF]))
            else:
                with open(piece, "r+b") as f:
                    f.truncate(4)
        if RANK == 0 and kind == "unmanifested":
            os.remove(os.path.join(d, "2", checkpoint.MANIFEST_NAME))
        torch.distributed.barrier()
        host = types.SimpleNamespace(state=train.create_sharded_state(
            torch.Generator().manual_seed(1),
            lambda g: bridge.init(cfg, g, device="cpu"), tx, mesh,
            logical_axes=axes), _mesh=mesh, logical_axes=axes, rules=None)
        ok = checkpoint.resume_trainer_state(host, walk)
        OUT[f"{name} {kind}"] = {
            "ok": ok, "step": int(host.state.step),
            "same": all(torch.equal(a, b) for a, b in zip(
                bridge.leaves(host.state.params), bridge.leaves(s1.params))),
            "steps": walk.steps(),
        }
        walk.close()

# A bare manager (no layout) under an installed global mesh: refused
# where a leaf may be a shard, every leaf replicated under dp alone.
from cloud_tpu_torch.parallel import mesh as mesh_lib

for sizes in ({"fsdp": 2}, {"tp": 2}, {"dp": 2}):
    name = "-".join(f"{k}{v}" for k, v in sizes.items())
    mesh = MeshSpec(sizes).build(devices=["cpu"] * WORLD)
    state = train.create_sharded_state(
        torch.Generator().manual_seed(0),
        lambda g: bridge.init(cfg, g, device="cpu"), tx, mesh,
        logical_axes=axes if "dp" not in sizes else None)
    bare = checkpoint.CheckpointManager(os.path.join(ROOT, f"bare-{name}"),
                                        device="cpu")
    got = {}
    with mesh_lib.use_mesh(mesh):
        for call in ("save", "restore"):
            try:
                if call == "save":
                    bare.save(1, state)
                    bare.wait()
                else:
                    bare.restore(1, template=state)
                got[call] = None
            except ValueError as exc:
                got[call] = str(exc)
    got["steps"] = bare.steps()
    bare.close()
    OUT[f"bare {name}"] = got

# C7: a process group and no mesh: process 0 alone writes.
state = train.create_sharded_state(
    torch.Generator().manual_seed(0),
    lambda g: bridge.init(cfg, g, device="cpu"), tx, device="cpu")
writes = []
real_replace, real_rename, real_open = os.replace, os.rename, open


def replace(src, dst):
    writes.append(os.path.basename(dst))
    return real_replace(src, dst)


def rename(src, dst):
    writes.append(os.path.basename(dst))
    return real_rename(src, dst)


os.replace, os.rename = replace, rename
import builtins


def spy_open(path, mode="r", *a, **k):
    if "w" in mode and str(path).endswith(".bin"):
        writes.append(os.path.basename(str(path)))
    return real_open(path, mode, *a, **k)


builtins.open = spy_open
manager = checkpoint.CheckpointManager(os.path.join(ROOT, "no-mesh"),
                                       device="cpu")
manager.save(3, state, extras={"data_state": {"epoch": 0, "batch": 3}})
manager.wait()
manager.close()
builtins.open = real_open
os.replace, os.rename = real_replace, real_rename
OUT["no mesh"] = {"writes": writes}
"""


def _flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(_flat(v, key))
        else:
            out[key] = v.detach().numpy()
    return out


def _full_state(seed=0):
    return train.create_sharded_state(
        torch.Generator().manual_seed(seed),
        lambda g: bridge.init(CFG, g, device="cpu"),
        optimizers.sgd(0.1, momentum=0.9), device="cpu")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    # The one-process checkpoint the ranks restore into their meshes.
    manager = checkpoint.CheckpointManager(str(root / "one-process"),
                                           device="cpu")
    manager.save(0, _full_state())
    manager.wait()
    manager.close()
    tokens = np.random.default_rng(0).integers(
        0, CFG.vocab_size, (8, 16)).astype(np.int64)
    outs = run_ranks(_RANKS, 2, files={"root": np.asarray(str(root)),
                                       "tokens": tokens}, timeout=400)
    return root, outs


@pytest.mark.parametrize("sizes", ARMS, ids=lambda s: "-".join(
    f"{k}{v}" for k, v in s.items()))
def test_restore_into_the_shards_continues_bit_equal(ranks, sizes):
    root, outs = ranks
    name = "-".join(f"{k}{v}" for k, v in sizes.items())
    for out in outs:
        got = out[name]
        assert got["loss"] == got["ref_loss"]
        assert got["same"], "restored step differs from the uninterrupted one"
        assert got["verify"] == "verified"
    index = json.loads((root / name / "1" / checkpoint.INDEX_NAME)
                       .read_text())
    assert index["mesh"] == sizes and index["processes"] == 2
    manifest = json.loads((root / name / "1" / checkpoint.MANIFEST_NAME)
                          .read_text())
    files = set(manifest["entries"])
    assert files == {p.name for p in (root / name / "1").iterdir()
                     if p.name != checkpoint.MANIFEST_NAME}
    assert any(f.endswith(".r1.bin") for f in files)
    cut = [leaf for leaf in index["leaves"] if len(leaf["pieces"]) == 2]
    assert cut, "no leaf was cut over the mesh"
    axis = next(iter(sizes))
    for leaf in cut:
        assert leaf["axes"] is not None
        (dim,) = [d for d, (a, b) in enumerate(zip(*[
            p["bounds"] for p in leaf["pieces"]])) if a != b]
        extent = leaf["shape"][dim]
        assert [p["bounds"][dim] for p in leaf["pieces"]] == [
            list(sharding.shard_bounds(extent, 2, i)) for i in range(2)], (
                axis, leaf["key"])
    whole = [leaf for leaf in index["leaves"] if len(leaf["pieces"]) == 1]
    assert all(p["file"].endswith(".r0.bin") for leaf in whole
               for p in leaf["pieces"])


@pytest.mark.parametrize("sizes", ARMS, ids=lambda s: "-".join(
    f"{k}{v}" for k, v in s.items()))
def test_one_process_save_restores_into_each_mesh(ranks, sizes):
    _, outs = ranks
    name = "-".join(f"{k}{v}" for k, v in sizes.items())
    for out in outs:
        got = out[name]
        assert set(got["one_process_into_mesh"]) == set(got["local"])
        for key, want in got["local"].items():
            assert got["one_process_into_mesh"][key] == want, key


@pytest.mark.parametrize("sizes", ARMS, ids=lambda s: "-".join(
    f"{k}{v}" for k, v in s.items()))
def test_mesh_save_restores_into_one_process(ranks, sizes):
    root, outs = ranks
    name = "-".join(f"{k}{v}" for k, v in sizes.items())
    gathered = outs[0][name]["gathered"]
    assert gathered == outs[1][name]["gathered"]
    manager = checkpoint.CheckpointManager(str(root / name), device="cpu")
    templated = manager.restore(1, template=_full_state(seed=5))
    free = manager.restore(1)
    for tree in (templated.params, free.params):
        got = _flat(tree)
        assert set(got) == set(gathered)
        for key, value in got.items():
            np.testing.assert_array_equal(value.ravel(),
                                          np.asarray(gathered[key],
                                                     np.float32), key)
    assert int(templated.step) == 1


@pytest.mark.parametrize("kind", ["corrupt", "unmanifested"])
@pytest.mark.parametrize("sizes", ARMS, ids=lambda s: "-".join(
    f"{k}{v}" for k, v in s.items()))
def test_a_damaged_piece_walks_both_ranks_back(ranks, sizes, kind):
    root, outs = ranks
    name = "-".join(f"{k}{v}" for k, v in sizes.items())
    for out in outs:
        got = out[f"{name} {kind}"]
        assert got["ok"] and got["step"] == 1 and got["same"], got
        assert got["steps"] == [1]
    assert os.listdir(root / f"{name}-{kind}" / checkpoint.QUARANTINE_DIRNAME)


@pytest.mark.parametrize("sizes", ARMS + ({"dp": 2},), ids=lambda s: "-".join(
    f"{k}{v}" for k, v in s.items()))
def test_a_manager_without_a_layout_refuses_a_sharded_mesh(ranks, sizes):
    """Without a layout a manager cannot tell a shard from a replica: under
    a global mesh with a nontrivial axis other than dp it refuses to save
    and to restore (rank 0 would record its shard as the whole leaf);
    under dp alone every leaf is replicated and the save lands."""
    root, outs = ranks
    name = "-".join(f"{k}{v}" for k, v in sizes.items())
    for out in outs:
        got = out[f"bare {name}"]
        if "dp" in sizes:
            assert got == {"save": None, "restore": None, "steps": [1]}
        else:
            for call in ("save", "restore"):
                assert got[call] and "layout=StateLayout" in got[call], got
            assert got["steps"] == []
    if "dp" in sizes:
        pieces = [p.name for p in (root / f"bare-{name}" / "1").glob("*.bin")]
        assert pieces and all(n.endswith(".r0.bin") for n in pieces)


def test_without_a_mesh_only_process_zero_writes(ranks):
    root, outs = ranks
    chief, other = outs[0]["no mesh"]["writes"], outs[1]["no mesh"]["writes"]
    assert other == []
    assert checkpoint.MANIFEST_NAME in chief and "3.json" in chief
    assert "3" in chief  # the temporary directory renamed to its step
    step_dir = root / "no-mesh" / "3"
    assert all(p.name.endswith(".r0.bin") for p in step_dir.glob("*.bin"))
    assert json.loads((root / "no-mesh" / checkpoint.META_DIRNAME
                       / "3.json").read_text())["data_state"]["batch"] == 3
    manager = checkpoint.CheckpointManager(str(root / "no-mesh"),
                                           device="cpu")
    assert manager.verify(3) == "verified"
    restored = manager.restore(3, template=_full_state(seed=9))
    for got, want in zip(bridge.leaves(restored.params),
                         bridge.leaves(_full_state().params)):
        assert torch.equal(got, want)
