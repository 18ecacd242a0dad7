"""The port's parallel layer against the JAX package's, on the CPU.

* **Host arithmetic, both packages.**  ``MeshSpec`` (validation, sizes,
  shapes, DCN axes, JSON), ``ShardingRules`` (``spec``, ``assignment``,
  ``extended``, ``DEFAULT_RULES``), ``pad_batch``, ``plan_mesh`` and
  ``plan_serve_layout`` over a grid of inputs: the same plans,
  descriptions, JSON and error messages as the JAX objects (the scenarios
  of ``tests/unit/test_parallel.py``, widened to a grid).
* **Collectives on gloo ranks.**  Each rank is its own JAX-free Python
  process, started with the ``CLOUD_TPU_*`` variables that
  ``parallel.distributed.initialize_from_env`` reads: every collective of
  ``parallel/collectives.py`` on 2 ranks, and on 4 ranks over the
  per-axis groups of a 2x2 ``dp`` x ``tp`` mesh and a 4-rank ``tp`` ring,
  held to numpy.
* **Sharding.**  ``shard_tensor``'s uneven cuts equal ``torch.tensor_split``
  and a rank's shards of the params reassemble the full tensors.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from cloud_tpu import parallel as jax_parallel
from cloud_tpu.core.machine_config import COMMON_MACHINE_CONFIGS as MC
from cloud_tpu.parallel import planner as jax_planner
from cloud_tpu.parallel import sharding as jax_sharding
from cloud_tpu_torch import parallel
from cloud_tpu_torch.parallel import mesh as mesh_lib
from cloud_tpu_torch.parallel import planner, sharding
from helpers.torch_port import run_ranks

REPO = pathlib.Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def _outcome(fn):
    """``("ok", value)`` or ``(exception type name, message)``."""
    try:
        return "ok", fn()
    except (ValueError, KeyError) as exc:
        return type(exc).__name__, str(exc)


# ---------------------------------------------------------------------------
# MeshSpec


SPECS = [
    ({}, {}), ({"tp": 2}, {}), ({"dp": 2, "tp": 4}, {}), ({"fsdp": 8}, {}),
    ({"pp": 2, "sp": 2, "ep": 2}, {}), ({"dp": 4, "fsdp": 2}, {"dp": 2}),
    ({"dp": 8}, {"dp": 4}), ({"tp": 1, "sp": 3}, {}),
    ({"zz": 2}, {}), ({"tp": 0}, {}), ({"dp": 4}, {"dp": 3}),
    ({"dp": 2}, {"qq": 1}), ({"dp": 2}, {"dp": 0}),
]


def _spec_view(spec):
    return (spec.dcn_axes, [spec.size(a) for a in spec.axis_names()],
            spec.num_devices, spec.axis_names(), spec.shape(),
            spec.nontrivial_axes(), spec.to_json())


@pytest.mark.parametrize("sizes,dcn", SPECS, ids=str)
def test_mesh_spec_matches_jax(sizes, dcn):
    want = _outcome(lambda: _spec_view(jax_parallel.MeshSpec(sizes, dcn)))
    got = _outcome(lambda: _spec_view(parallel.MeshSpec(sizes, dcn)))
    assert got == want
    if got[0] == "ok":
        spec = parallel.MeshSpec(sizes, dcn)
        assert parallel.MeshSpec.from_json(spec.to_json()) == spec
        assert parallel.MeshSpec.from_json(
            jax_parallel.MeshSpec(sizes, dcn).to_json()) == spec


def test_mesh_build_one_rank_and_global_registry():
    spec = parallel.MeshSpec({"tp": 1})
    mesh = spec.build(devices=["cpu"])
    assert (mesh.rank, mesh.device, mesh.backend) == (0, torch.device("cpu"),
                                                     "gloo")
    assert mesh.shape == {a: 1 for a in parallel.CANONICAL_AXES}
    assert mesh.group("tp") is None and mesh.axis_index("tp") == 0
    with pytest.raises(ValueError, match="wants 1 devices"):
        spec.build(devices=["cpu", "cpu"])
    with pytest.raises(RuntimeError, match="process group"):
        parallel.MeshSpec({"tp": 2}).build(devices=["cpu", "cpu"])
    assert parallel.get_global_mesh() is None
    with parallel.use_mesh(mesh):
        assert parallel.get_global_mesh() is mesh
    assert parallel.get_global_mesh() is None


# ---------------------------------------------------------------------------
# Sharding rules and pad_batch

LOGICAL = [(), ("batch",), ("batch", "seq", "act_embed"), ("embed", "heads"),
           ("heads", "embed"), ("embed", "mlp"), ("vocab", "embed"),
           ("layers", "embed", "vocab"), ("expert", "embed", "mlp"),
           ("expert_batch", None, "kv"), ("stage", None), ("nope",)]


@pytest.mark.parametrize("axes", LOGICAL, ids=str)
def test_rules_match_jax(axes):
    overrides = {"vocab": None, "heads": ("tp", "sp")}
    for jr, pr in ((jax_sharding.DEFAULT_RULES, sharding.DEFAULT_RULES),
                   (jax_sharding.DEFAULT_RULES.extended(**overrides),
                    sharding.DEFAULT_RULES.extended(**overrides))):
        assert jr.rules == pr.rules
        want = _outcome(lambda: tuple(jr.spec(*axes)))
        got = _outcome(lambda: tuple(pr.spec(*axes)))
        assert got == want
        assert _outcome(lambda: tuple(sharding.logical_to_mesh_axes(
            axes, pr))) == _outcome(lambda: tuple(
                jax_sharding.logical_to_mesh_axes(axes, jr)))
        for name in axes:
            assert (_outcome(lambda: pr.assignment(name))
                    == _outcome(lambda: jr.assignment(name)))
    assert sharding.shard_constraint("x", "batch") == "x"


def _batch(n):
    rng = np.random.default_rng(n)
    return {"tokens": rng.integers(0, 9, (n, 5)).astype(np.int32),
            "nested": [rng.standard_normal((n, 2, 3)).astype(np.float32)],
            "scale": np.float32(2.0)}


@pytest.mark.parametrize("n,pad_to,axis", [
    (3, 3, 0), (3, 8, 0), (1, 4, 0), (5, 4, 0), (3, 0, 0), (2, 6, 1)],
    ids=str)
def test_pad_batch_matches_jax(n, pad_to, axis):
    batch = _batch(n)
    if axis == 1:
        batch = {"x": np.ones((2, n, 3), np.float32)}
    want = _outcome(lambda: jax_sharding.pad_batch(batch, pad_to, axis=axis))
    got = _outcome(lambda: sharding.pad_batch(batch, pad_to, axis=axis))
    assert got[0] == want[0]
    if got[0] != "ok":
        assert got == want
        return
    (gb, gv), (wb, wv) = got[1], want[1]
    np.testing.assert_array_equal(gv, np.asarray(wv))

    def flat(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in flat(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in flat(v)]
        return [np.asarray(tree)]

    for g, w in zip(flat(gb), flat(wb)):
        np.testing.assert_array_equal(g, w)
    tensors = {"x": torch.ones((n, 2))}
    if n <= pad_to and axis == 0:
        padded, _ = sharding.pad_batch(tensors, pad_to)
        assert np.asarray(padded["x"]).shape == (pad_to, 2)
    assert (_outcome(lambda: sharding.pad_batch({"s": 1.0}, 2))
            == _outcome(lambda: jax_sharding.pad_batch({"s": 1.0}, 2)))
    mixed = {"a": np.ones((2, 1)), "b": np.ones((3, 1))}
    assert (_outcome(lambda: sharding.pad_batch(mixed, 4))
            == _outcome(lambda: jax_sharding.pad_batch(mixed, 4)))


# ---------------------------------------------------------------------------
# The planner


HINTS = [{}, {"prefer_fsdp": False}, {"tp": 2}, {"tp": 2, "sp": 2},
         {"tp": 3}, {"dp": 4, "fsdp": 4}, {"dp": 2}, {"fsdp": 2},
         {"dp": 1}, {"pp": 2, "ep": 2}, {"tp": 0}, {"dp": 3}]
PLAN_CASES = ([dict(num_devices=n, worker_count=w, hints=h)
               for n in (1, 2, 4, 8, 16) for w in (0, 1, 3) for h in HINTS]
              + [dict(chief_config=MC[name], worker_count=w, hints=h)
                 for name in ("CPU", "TPU", "TPU_V5E_32", "TPU_V4_8")
                 for w in (0, 1) for h in HINTS[:4]]
              + [dict(), dict(hints={"tp": 2})])


def _plan_view(mod, case):
    case = dict(case)
    if "hints" in case:
        case["hints"] = mod.ParallelismHints(**case["hints"])
    plan = mod.plan_mesh(**case)
    return (plan.to_json(), plan.total_chips, plan.total_hosts,
            plan.description, plan.spec.dcn_axes)


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_plan_mesh_matches_jax(case):
    case = PLAN_CASES[case]
    want = _outcome(lambda: _plan_view(jax_planner, case))
    got = _outcome(lambda: _plan_view(planner, case))
    assert got == want
    if got[0] == "ok":
        plan = planner.MeshPlan.from_json(got[1][0])
        assert plan.to_json() == got[1][0]
        assert planner.MeshPlan.from_json(got[1][0]) == plan


LAYOUTS = [dict(num_heads=h, num_devices=n, sp=sp, hbm_bytes_per_chip=hbm,
                param_bytes=pb, kv_bytes=kb, draft_bytes=db)
           for h in (1, 4, 6, 12) for n in (1, 2, 3, 4, 8) for sp in (1, 2)
           for hbm, pb, kb, db in ((None, 0, 0, 0),
                                   (None, 2**30, 2**29, 2**26),
                                   (3 * 2**29, 2**30, 2**29, 0),
                                   (2**28, 2**30, 2**29, 2**27),
                                   (2**20, 2**30, 2**29, 0))]
LAYOUTS += [dict(num_heads=0, num_devices=2), dict(num_heads=4, num_devices=0),
            dict(num_heads=4, num_devices=2, sp=0),
            dict(num_heads=4, num_devices=2, sp=3)]


def _layout_view(mod, case):
    layout = mod.plan_serve_layout(**case)
    return (dataclasses.astuple(layout), layout.num_chips, layout.shape,
            layout.mesh_spec().to_json())


@pytest.mark.parametrize("chunk", range(4))
def test_plan_serve_layout_matches_jax(chunk):
    for case in LAYOUTS[chunk::4]:
        want = _outcome(lambda: _layout_view(jax_planner, case))
        got = _outcome(lambda: _layout_view(planner, case))
        assert got == want, case


# ---------------------------------------------------------------------------
# Sharding a params tree


def test_shard_tensor_cuts_as_tensor_split_and_reassembles():
    x = torch.arange(10 * 6, dtype=torch.float32).reshape(10, 6)
    spec = parallel.MeshSpec({"dp": 2, "tp": 3})
    from cloud_tpu_torch.serving.slice import shard_views

    views = shard_views(spec, ["cpu"] * 6, "gloo")
    rules = sharding.DEFAULT_RULES
    for view in views:
        got = sharding.shard_tensor(x, ("vocab", "embed"), view, rules)
        want = torch.tensor_split(x, 3, dim=0)[view.axis_index("tp")]
        assert torch.equal(got, want)
        both = sharding.shard_tensor(
            x, ("vocab", "embed"), view,
            rules.extended(embed=("dp",)))
        assert torch.equal(both, torch.tensor_split(
            want, 2, dim=1)[view.axis_index("dp")])
    assert [sharding.shard_bounds(32000, 3, i) for i in range(3)] == [
        (0, 10667), (10667, 21334), (21334, 32000)]
    with pytest.raises(ValueError, match="logical axes"):
        sharding.shard_tensor(x, ("vocab",), views[0], rules)


def test_lm_shards_reassemble_the_params_int8_scales_included():
    from cloud_tpu_torch import bridge
    from cloud_tpu_torch.models import quantization, transformer
    from cloud_tpu_torch.parallel import tensor_parallel
    from cloud_tpu_torch.serving.slice import shard_views

    cfg = transformer.TINY.scaled(num_heads=8, head_dim=8, vocab_size=9000,
                                  mlp_hidden=512, num_layers=1,
                                  dtype=torch.float32)
    params = quantization.quantize_params(
        bridge.init(cfg, torch.Generator().manual_seed(0), device="cpu"))
    spec = parallel.MeshSpec({"tp": 4})
    shards = [tensor_parallel.shard_lm(params, cfg, view)
              for view in shard_views(spec, ["cpu"] * 4, "gloo")]
    assert [s["tp"].vocab_sizes for s in shards] == [(2250,) * 4] * 4
    layer = [s["layers"][0] for s in shards]
    # Column-split: heads and hidden units; row-split keeps its scale whole.
    for name, dim in (("q", 1), ("k", 1), ("v", 1), ("out", 0)):
        full = params["layers"][0]["att"][name]
        key = "kernel_q" if "kernel_q" in full else "kernel"
        assert torch.equal(torch.cat([s["att"][name][key] for s in layer],
                                     dim), full[key])
    wo = params["layers"][0]["mlp"]["wo"]
    assert torch.equal(torch.cat([s["mlp"]["wo"]["kernel_q"]
                                  for s in layer]), wo["kernel_q"])
    assert all(torch.equal(s["mlp"]["wo"]["kernel_scale"],
                           wo["kernel_scale"]) for s in layer)
    wi = params["layers"][0]["mlp"]["wi"]
    assert torch.equal(torch.cat([s["mlp"]["wi"]["kernel_scale"]
                                  for s in layer], 1), wi["kernel_scale"])
    for name in ("table_q", "table_scale"):
        assert torch.equal(torch.cat([s["embed"][name] for s in shards]),
                           params["embed"][name])
    with pytest.raises(ValueError, match="num_heads"):
        tensor_parallel.shard_lm(params, cfg.scaled(num_heads=6),
                                 shard_views(spec, ["cpu"] * 4, "gloo")[0])
    with pytest.raises(ValueError, match="rules map 'embed'"):
        tensor_parallel.shard_lm(params, cfg, shard_views(
            spec, ["cpu"] * 4, "gloo")[0],
            sharding.DEFAULT_RULES.extended(embed="tp"))


# ---------------------------------------------------------------------------
# Collectives on gloo ranks (JAX-free processes)

_TWO_RANKS = """
mesh = MeshSpec({"tp": 2}).build(devices=["cpu", "cpu"])
x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * RANK
OUT["sum"] = c.all_reduce_sum(x, "tp", mesh=mesh).tolist()
OUT["mean"] = c.all_reduce_mean(x, "tp", mesh=mesh).tolist()
OUT["gather0"] = c.all_gather(x, "tp", mesh=mesh).tolist()
OUT["gather1"] = c.all_gather(x, "tp", gather_dim=1, mesh=mesh).tolist()
OUT["stacked"] = c.all_gather(x, "tp", tiled=False, mesh=mesh).tolist()
OUT["uneven"] = c.all_gather(x[:, :2 + RANK] if RANK == 0 else x[:, :1],
                             "tp", gather_dim=1, sizes=[2, 1],
                             mesh=mesh).tolist()
OUT["scatter"] = c.reduce_scatter_sum(torch.arange(4.0) * (RANK + 1), "tp",
                                      mesh=mesh).tolist()
OUT["ring"] = c.ring_permute(x, "tp", mesh=mesh).tolist()
# The route gloo takes for CUDA tensors, forced on CPU ones.
c._zero_padded_route = lambda mesh, x: True
OUT["ring_padded"] = c.ring_permute(x, "tp", mesh=mesh).tolist()
OUT["bcast"] = c.broadcast_from(x, "tp", root=1, mesh=mesh).tolist()
OUT["index"] = [c.axis_index("tp", mesh=mesh), c.axis_size("tp", mesh=mesh)]
OUT["barrier"] = int(c.barrier("tp", mesh=mesh))
OUT["local_mean"] = float(c.host_local_mean({"a": [x]})["a"][0])
with torch.no_grad():
    from cloud_tpu_torch.parallel import use_mesh
    with use_mesh(mesh):
        OUT["global"] = c.all_reduce_sum(torch.ones(1), "tp").tolist()
"""


def test_collectives_on_two_gloo_ranks():
    outs = run_ranks(_TWO_RANKS, 2)
    xs = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
          for r in range(2)]
    for rank, out in enumerate(outs):
        assert out["chief"] == (rank == 0)
        np.testing.assert_array_equal(out["sum"], xs[0] + xs[1])
        np.testing.assert_array_equal(out["mean"], (xs[0] + xs[1]) / 2)
        np.testing.assert_array_equal(out["gather0"], np.concatenate(xs, 0))
        np.testing.assert_array_equal(out["gather1"], np.concatenate(xs, 1))
        np.testing.assert_array_equal(out["stacked"], np.stack(xs))
        np.testing.assert_array_equal(
            out["uneven"], np.concatenate([xs[0][:, :2], xs[1][:, :1]], 1))
        np.testing.assert_array_equal(
            out["scatter"], (np.arange(4.0) * 3)[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(out["ring"], xs[1 - rank])
        np.testing.assert_array_equal(out["ring_padded"], xs[1 - rank])
        np.testing.assert_array_equal(out["bcast"], xs[1])
        assert out["index"] == [rank, 2] and out["barrier"] == 0
        assert out["local_mean"] == pytest.approx(xs[rank].mean())
        assert out["global"] == [2.0]


_FOUR_RANKS = """
mesh = MeshSpec({"dp": 2, "tp": 2}).build(devices=["cpu"] * 4)
OUT["coords"] = [mesh.axis_index("dp"), mesh.axis_index("tp")]
OUT["groups"] = {a: list(r) for a, r in mesh.group_ranks.items()}
x = torch.full((2,), float(RANK))
OUT["tp_sum"] = c.all_reduce_sum(x, "tp", mesh=mesh).tolist()
OUT["dp_sum"] = c.all_reduce_sum(x, "dp", mesh=mesh).tolist()
OUT["all_sum"] = c.all_reduce_sum(x, ("dp", "tp"), mesh=mesh).tolist()
OUT["dp_gather"] = c.all_gather(x[:1], "dp", mesh=mesh).tolist()
OUT["tp_ring"] = c.ring_permute(x, "tp", mesh=mesh).tolist()
ring = MeshSpec({"tp": 4}).build(devices=["cpu"] * 4)
OUT["ring1"] = c.ring_permute(x, "tp", shift=1, mesh=ring).tolist()
OUT["ring_back"] = c.ring_permute(x, "tp", shift=-1, mesh=ring).tolist()
OUT["ring2"] = c.ring_permute(x, "tp", shift=2, mesh=ring).tolist()
OUT["scatter"] = c.reduce_scatter_sum(torch.arange(8.0) + RANK, "tp",
                                      mesh=ring).tolist()
OUT["bcast"] = c.broadcast_from(x, "tp", root=3, mesh=ring).tolist()
"""


def test_collectives_on_four_gloo_ranks_per_axis_groups():
    """A 2x2 dp x tp mesh: rank = 2 dp + tp, each axis group created by
    every rank in one order; then a 4-rank tp ring."""
    outs = run_ranks(_FOUR_RANKS, 4)
    for rank, out in enumerate(outs):
        dp, tp = divmod(rank, 2)
        assert out["coords"] == [dp, tp]
        assert out["groups"] == {"dp": [tp, 2 + tp],
                                 "tp": [2 * dp, 2 * dp + 1]}
        assert out["tp_sum"] == [float(4 * dp + 1)] * 2
        assert out["dp_sum"] == [float(2 * tp + 2)] * 2
        assert out["all_sum"] == [6.0, 6.0]
        assert out["dp_gather"] == [float(tp), float(2 + tp)]
        assert out["tp_ring"] == [float(2 * dp + 1 - tp)] * 2
        assert out["ring1"] == [float((rank - 1) % 4)] * 2
        assert out["ring_back"] == [float((rank + 1) % 4)] * 2
        assert out["ring2"] == [float((rank + 2) % 4)] * 2
        total = sum(np.arange(8.0) + r for r in range(4))
        assert out["scatter"] == total[2 * rank:2 * rank + 2].tolist()
        assert out["bcast"] == [3.0, 3.0]


def test_initialize_from_env_single_process_and_missing_fields(monkeypatch):
    from cloud_tpu_torch.parallel import distributed

    for var in (distributed.ENV_COORDINATOR, distributed.ENV_NUM_PROCESSES,
                distributed.ENV_PROCESS_ID):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_from_env(device="cpu") is False
    assert (distributed.process_index(), distributed.process_count(),
            distributed.is_chief()) == (0, 1, True)
    monkeypatch.setenv(distributed.ENV_COORDINATOR, "127.0.0.1:1")
    with pytest.raises(ValueError, match="CLOUD_TPU_NUM_PROCESSES"):
        distributed.initialize_from_env(device="cpu")
    assert distributed.backend_for("cpu") == "gloo"
    assert mesh_lib.visible_devices("cpu")


_EXIT_PROBE = """
import atexit, sys
sys.modules["jax"] = None
import torch.distributed as dist
# Registered first, so it runs after the handler initialize_from_env adds.
atexit.register(lambda: print("at exit", dist.is_initialized(), flush=True))
from cloud_tpu_torch.parallel import distributed
assert distributed.initialize_from_env(60, device="cpu")
"""


def test_a_group_made_from_env_is_destroyed_before_the_interpreter_ends():
    """A group still alive at interpreter finalization is torn down with
    its threads running: under load such a rank now and then aborted
    ("terminate called without an active exception", exit -6) after its
    work was done.  ``initialize_from_env`` destroys the group it made at
    exit, before finalization."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, CLOUD_TPU_COORDINATOR="127.0.0.1:0",
               CLOUD_TPU_NUM_PROCESSES="1", CLOUD_TPU_PROCESS_ID="0",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _EXIT_PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "at exit False"


# ---------------------------------------------------------------------------
# Training collectives: the hierarchical sum, grad_sync, the all-to-all
# and the differentiable collectives of parallel/autograd.py


_TRAINING_COLLECTIVES = """
from cloud_tpu_torch.parallel import autograd as ag
hybrid = MeshSpec({"dp": 2, "fsdp": 2}, {"dp": 2}).build(devices=["cpu"] * 4)
x = torch.arange(24, dtype=torch.float32).reshape(8, 3) * (RANK + 1)
OUT["hier"] = c.hierarchical_all_reduce_sum(
    x, ici_axis="fsdp", dcn_axis="dp", mesh=hybrid).tolist()
odd = torch.arange(6, dtype=torch.float32).reshape(3, 2) + RANK
OUT["hier_odd"] = c.hierarchical_all_reduce_sum(
    odd, ici_axis="fsdp", dcn_axis="dp", mesh=hybrid).tolist()
OUT["hier_dim1"] = c.hierarchical_all_reduce_sum(
    x.t().contiguous(), ici_axis="fsdp", dcn_axis="dp", scatter_dim=1,
    mesh=hybrid).tolist()
# bf16 leaves reduce in f32 (sums of 1 + k 2^-7 round in a bf16 add).
g = {"b": torch.full((4,), 1.0 + 2.0 ** -7 * (RANK + 1),
                     dtype=torch.float32).to(torch.bfloat16),
     "a": [torch.full((2,), float(RANK))]}
synced = c.grad_sync(g, ("dp", "fsdp"), mean=False, mesh=hybrid)
OUT["sync_dtype"] = str(synced["b"].dtype)
OUT["sync_b"] = synced["b"].float().tolist()
OUT["sync_a"] = synced["a"][0].tolist()
OUT["sync_mean"] = c.grad_sync(g, "dp", mesh=hybrid)["a"][0].tolist()

sp = MeshSpec({"sp": 4}).build(devices=["cpu"] * 4)
seq = (torch.arange(2 * 3 * 8 * 2, dtype=torch.float32)
       .reshape(2, 3, 8, 2) + 1000 * RANK)
heads = c.all_to_all_seq_heads(seq, "sp", mesh=sp)
OUT["heads"] = heads.tolist()
OUT["round"] = bool(torch.equal(
    c.all_to_all_seq_heads(heads, "sp", to_heads=False, mesh=sp), seq))
try:
    c.all_to_all_seq_heads(seq[:, :, :6], "sp", mesh=sp)
except ValueError as exc:
    OUT["a2a_error"] = str(exc)

# Backward of each differentiable collective against its transpose.
tp = MeshSpec({"dp": 2, "tp": 2}).build(devices=["cpu"] * 4)
x = torch.arange(6, dtype=torch.float32).reshape(2, 3).requires_grad_()
cot = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (RANK + 1)
OUT["copy_fwd"] = ag.copy_to_tp(x, tp).tolist()
OUT["copy_bwd"] = torch.autograd.grad(ag.copy_to_tp(x, tp), x, cot)[0].tolist()
OUT["reduce_fwd"] = ag.reduce_from_tp(x * (RANK + 1), tp).tolist()
OUT["reduce_bwd"] = torch.autograd.grad(
    ag.reduce_from_tp(x, tp), x, cot)[0].tolist()
ti = tp.axis_index("tp")
local = (torch.arange(2 * (3 - ti), dtype=torch.float32).reshape(2, 3 - ti)
         + 10 * ti).requires_grad_()
full = ag.gather_vocab(local, tp, sizes=(3, 2))
OUT["gather_fwd"] = full.tolist()
big = torch.arange(10, dtype=torch.float32).reshape(2, 5)
OUT["gather_bwd"] = torch.autograd.grad(full, local, big)[0].tolist()
s = seq.clone().requires_grad_()
out = ag.seq_to_heads(s, sp)
OUT["a2a_bwd"] = bool(torch.equal(
    torch.autograd.grad(out, s, heads)[0],
    c.all_to_all_seq_heads(heads, "sp", to_heads=False, mesh=sp)))
back = ag.heads_to_seq(heads.clone().requires_grad_(), sp)
OUT["a2a_inv"] = bool(torch.equal(back, seq))
"""


def test_training_collectives_on_four_gloo_ranks():
    """Mirrors ``tests/unit/test_parallel.py``'s hierarchical-sum,
    grad_sync and all-to-all cases on gloo ranks: the two-level sum
    equals the flat sum (the scatter route and the indivisible one),
    bf16 leaves are summed in f32, the all-to-all moves heads for
    positions and back, and each autograd collective's backward is its
    hand transpose."""
    outs = run_ranks(_TRAINING_COLLECTIVES, 4)
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    odd = np.arange(6, dtype=np.float32).reshape(3, 2)
    seqs = [np.arange(96, dtype=np.float32).reshape(2, 3, 8, 2) + 1000 * r
            for r in range(4)]
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out["hier"], x * 10)
        np.testing.assert_array_equal(out["hier_odd"], odd * 4 + 6)
        np.testing.assert_array_equal(out["hier_dim1"], (x * 10).T)
        assert out["sync_dtype"] == "torch.bfloat16"
        want_b = np.float32(sum(1.0 + 2.0 ** -7 * (r + 1) for r in range(4)))
        want_b = torch.tensor(want_b).to(torch.bfloat16).float().item()
        assert out["sync_b"] == [want_b] * 4
        assert want_b != 4.0  # the f32 sum keeps what bf16 adds would lose
        assert out["sync_a"] == [6.0, 6.0]
        dp, tpi = divmod(rank, 2)
        assert out["sync_mean"] == [float(tpi + 1)] * 2  # (t + (2 + t)) / 2
        np.testing.assert_array_equal(
            out["heads"], np.concatenate(
                [s[:, :, 2 * rank:2 * rank + 2] for s in seqs], axis=1))
        assert out["round"] and out["a2a_bwd"] and out["a2a_inv"]
        assert "must divide by axis 'sp' size 4" in out["a2a_error"]
        base = np.arange(6, dtype=np.float32).reshape(2, 3)
        np.testing.assert_array_equal(out["copy_fwd"], base)
        # copy's transpose: the tp group's cotangents summed.
        np.testing.assert_array_equal(
            out["copy_bwd"], base * ((2 * dp + 1) + (2 * dp + 2)))
        np.testing.assert_array_equal(
            out["reduce_fwd"], base * ((2 * dp + 1) + (2 * dp + 2)))
        np.testing.assert_array_equal(out["reduce_bwd"], base * (rank + 1))
        np.testing.assert_array_equal(out["gather_fwd"], [
            [0, 1, 2, 10, 11], [3, 4, 5, 12, 13]])
        big = np.arange(10, dtype=np.float32).reshape(2, 5)
        np.testing.assert_array_equal(
            out["gather_bwd"], big[:, :3] if tpi == 0 else big[:, 3:])
