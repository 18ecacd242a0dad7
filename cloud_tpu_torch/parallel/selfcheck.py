"""Distributed-runtime self-check CLI: run one on every host of a job (port
of ``cloud_tpu/parallel/selfcheck.py``).

``python -m cloud_tpu_torch.parallel.selfcheck`` initializes the
multi-process runtime from the ``CLOUD_TPU_*`` env contract
(``parallel/distributed.py``) with a bounded timeout, so a mis-wired
coordinator fails loudly instead of hanging, then proves the job is
wired: a cross-process global reduction and real sharded train steps,
reported as one JSON line (``{"ok": false, "error": ...}`` and exit 1
on any exception).  Every phase is stamped into the report, so a
partial wedge is attributable.

One process is one rank with one device: each mode's mesh is sized from
the rank count as the JAX package sizes it from the device count.

Env knobs: ``CLOUD_TPU_SELFCHECK_FORCE_CPU=1`` runs on the CPU over gloo
(the local rig); otherwise each rank takes card ``rank % cards`` and the
backend is NCCL, or gloo when ranks share a card (NCCL refuses two ranks
on one device); a host with no card raises.  ``CLOUD_TPU_SELFCHECK_TIMEOUT``
bounds the distributed init (default 60 s), and
``CLOUD_TPU_SELFCHECK_MODE`` picks the check:

- ``basic`` (default): a ``dp`` mesh over every rank, a cross-process
  sum and one sharded MNIST train step on per-process rows (the JAX
  package's: ``train.create_sharded_state`` and
  ``train.make_train_step(mesh=, logical_axes=mnist.param_logical_axes
  (cfg))``).
- ``transformer``: ``{fsdp: n/2, tp: 2}``, two CloudLM TINY steps.
- ``pp``: ``{pp: n/2, tp: 2}`` with ``layers`` -> ``pp``: the GPipe
  pipeline's sends cross processes.
- ``tp``: ``{fsdp: n/4, tp: 4}``: a 4-wide tp group.
- ``sp``: ``{sp: n/2, tp: 2}``: the ring attention's hops.
- ``ulysses``: ``{fsdp: n/4, sp: 2, tp: 2}`` with ``ulysses_sp`` (sp is
  pinned to 2: TINY's 4 heads over tp 2 leave 2, which must divide by
  sp, or the ring would run instead).
- ``records``: every process streams its shard of a shared record dir
  (``CLOUD_TPU_SELFCHECK_RECORDS_DIR``) and reports the example ids it
  saw (the caller asserts the shards are disjoint and complete).

A mode whose mesh has an axis of size 0 on too few ranks reports
``phase: mesh_too_small`` with ``ok: false``.
"""

from __future__ import annotations

import json
import os
import sys


def _device():
    """This rank's device and the backend its groups use."""
    import torch

    from cloud_tpu_torch.parallel import distributed

    if os.environ.get("CLOUD_TPU_SELFCHECK_FORCE_CPU"):
        return torch.device("cpu"), "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device on this host; set CLOUD_TPU_SELFCHECK_FORCE_CPU=1 "
            "to run the check on the CPU")
    cards = torch.cuda.device_count()
    rank = int(os.environ.get(distributed.ENV_PROCESS_ID, "0"))
    world = int(os.environ.get(distributed.ENV_NUM_PROCESSES, "1"))
    device = torch.device("cuda", rank % cards)
    torch.cuda.set_device(device)
    return device, ("nccl" if world <= cards else "gloo")


def _check_transformer(report, mesh_sizes, device, backend, *,
                       pipeline: bool, ulysses: bool = False) -> None:
    """Two CloudLM TINY train steps on a model-parallel mesh; the second
    step's loss into ``report``."""
    import functools

    import numpy as np
    import torch

    from cloud_tpu_torch import bridge, parallel
    from cloud_tpu_torch.models import layers, transformer
    from cloud_tpu_torch.parallel import pipeline as pipeline_lib
    from cloud_tpu_torch.training import optimizers, train

    rules = (parallel.DEFAULT_RULES.extended(layers="pp") if pipeline
             else parallel.DEFAULT_RULES)
    cfg = transformer.TINY
    if ulysses:
        cfg = cfg.scaled(ulysses_sp=True)
    spec = parallel.MeshSpec(mesh_sizes)
    mesh = spec.build(devices=[device] * spec.num_devices, backend=backend)
    report["mesh"] = {k: v for k, v in mesh.shape.items() if v > 1}
    if ulysses:
        # This mode exists to prove the all-to-all path; an ineligible
        # mesh would run the ring instead.
        report["ulysses_eligible"] = layers.ulysses_eligible(
            cfg.num_heads, mesh, rules)
        if not report["ulysses_eligible"]:
            raise RuntimeError(
                f"ulysses mode mesh {mesh_sizes} is not Ulysses-eligible "
                f"for {cfg.num_heads} heads: it would test the ring, not "
                "the all-to-all path")
    logical_axes = transformer.param_logical_axes(cfg)

    # Ranks that differ only in tp, sp or pp feed the same rows: each
    # data rank its share of one global batch of 8 x 32 (under the
    # pipeline, its share of every global microbatch).
    global_batch, t = 8, 32
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (global_batch, t)).astype(np.int64)
    rows = pipeline_lib.microbatch_rows(
        mesh, global_batch,
        transformer.num_microbatches(cfg, mesh) if pipeline else 1)
    sgd = optimizers.sgd(0.1)
    gen = torch.Generator(device=device).manual_seed(0)
    state = train.create_sharded_state(
        gen, lambda g: bridge.init(cfg, g, device=device), sgd, mesh,
        logical_axes=logical_axes, rules=rules)
    step = train.make_train_step(
        functools.partial(transformer.loss_fn, config=cfg, rules=rules,
                          mesh=mesh),
        sgd, logical_axes=logical_axes, rules=rules, mesh=mesh)
    batch = train.shard_batch({"tokens": tokens[rows]}, mesh, rules)
    state, metrics = step(state, batch)
    state, metrics = step(state, batch)  # step 2 proves params updated
    report["loss"] = float(metrics["loss"])
    report["ok"] = bool(np.isfinite(report["loss"]))


def _check_records(report) -> None:
    """Stream this process's shard of a shared record dir; report ids."""
    from cloud_tpu_torch.training import records

    data_dir = os.environ["CLOUD_TPU_SELFCHECK_RECORDS_DIR"]
    ds = records.RecordDataset(os.path.join(data_dir, "*.rec"),
                               batch_size=2, drop_remainder=False)
    seen = []
    for batch in ds():
        seen.extend(int(x) for x in batch["x"][:, 0])
    report.update(
        shard_files=[os.path.basename(p) for p in ds.shard_files],
        example_ids=sorted(seen), loss=0.0, ok=True)


def _check_basic(report, device, backend) -> None:
    """A cross-process sum over a ``dp`` mesh of every rank, then one
    sharded MNIST train step on per-process rows."""
    import functools

    import numpy as np
    import torch

    from cloud_tpu_torch import bridge, parallel
    from cloud_tpu_torch.models import mnist
    from cloud_tpu_torch.parallel import collectives
    from cloud_tpu_torch.training import optimizers, train

    world, rank = report["process_count"], report["process_index"]
    # Phase 1: every process contributes rank+1 on each of its rows (one
    # row of 4 a device); the sum over the mesh proves the collectives
    # span every process, not just this one.
    report["phase"] = "psum"
    mesh = parallel.MeshSpec({"dp": world}).build(devices=[device] * world,
                                                  backend=backend)
    local = torch.full((1, 4), float(rank + 1), device=device)
    report["global_sum"] = float(collectives.all_reduce_sum(
        local.sum(), "dp", mesh=mesh))
    report["expected_sum"] = float(sum((r + 1) * 4 for r in range(world)))

    # Phase 2: one real sharded train step on per-process rows.
    report["phase"] = "train_step"
    cfg = mnist.MnistConfig(hidden_dim=16)
    logical_axes = mnist.param_logical_axes(cfg)
    sgd = optimizers.sgd(0.1)
    gen = torch.Generator(device=device).manual_seed(0)
    with parallel.use_mesh(mesh):
        state = train.create_sharded_state(
            gen, lambda g: bridge.init_mnist(cfg, g, device=device), sgd,
            mesh, logical_axes=logical_axes)
        step = train.make_train_step(
            functools.partial(mnist.loss_fn, config=cfg), sgd,
            logical_axes=logical_axes, mesh=mesh)
        rng = np.random.default_rng(rank)
        local_batch = {"image": rng.normal(size=(2, 784)).astype(np.float32),
                       "label": rng.integers(0, 10, 2)}
        batch = train.shard_batch(local_batch, mesh)
        state, metrics = step(state, batch)
    report["loss"] = float(metrics["loss"])
    report["phase"] = "done"
    report["ok"] = bool(
        abs(report["global_sum"] - report["expected_sum"]) < 1e-3
        and np.isfinite(report["loss"]))


def run_selfcheck() -> dict:
    import torch

    from cloud_tpu_torch.parallel import distributed

    report = {"phase": "init"}
    device, backend = _device()
    timeout = int(os.environ.get("CLOUD_TPU_SELFCHECK_TIMEOUT", "60"))
    report["distributed"] = distributed.initialize_from_env(
        timeout_seconds=timeout, device=device, backend=backend)
    world = distributed.process_count()
    report.update(
        process_index=distributed.process_index(), process_count=world,
        device_count=world, local_device_count=1, platform=device.type)

    mode = os.environ.get("CLOUD_TPU_SELFCHECK_MODE", "basic")
    # Model-parallel modes and their mesh from the job's device count
    # (one device a rank).
    model_parallel_meshes = {
        "transformer": {"fsdp": world // 2, "tp": 2},
        "pp": {"pp": world // 2, "tp": 2},
        "tp": {"fsdp": world // 4, "tp": 4},
        "sp": {"sp": world // 2, "tp": 2},
        "ulysses": {"fsdp": world // 4, "sp": 2, "tp": 2},
    }
    try:
        if mode in model_parallel_meshes:
            sizes = model_parallel_meshes[mode]
            if min(sizes.values()) < 1:
                report["phase"] = "mesh_too_small"
                report["ok"] = False
                report["error"] = (
                    f"mode {mode!r} computed mesh {sizes} from "
                    f"device_count={world}: every axis must be >= 1; run "
                    "this mode on a rig with more devices")
                return report
            report["phase"] = f"{mode}_step"
            _check_transformer(report, sizes, device, backend,
                               pipeline=(mode == "pp"),
                               ulysses=(mode == "ulysses"))
            report["phase"] = "done"
            return report
        if mode == "records":
            report["phase"] = "records"
            _check_records(report)
            report["phase"] = "done"
            return report
        if mode != "basic":
            raise ValueError(f"unknown CLOUD_TPU_SELFCHECK_MODE {mode!r}")
        _check_basic(report, device, backend)
        return report
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def main() -> int:
    try:
        report = run_selfcheck()
    except Exception as exc:  # noqa: BLE001 — the JSON line IS the report
        print(json.dumps(
            {"ok": False, "error": f"{type(exc).__name__}: {exc}"[:1000]}),
            flush=True)
        return 1
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
