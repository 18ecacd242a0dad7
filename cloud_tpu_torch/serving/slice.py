"""A serving slice (``tp`` x ``sp``): rank 0 and its followers in lockstep.

The JAX engine serves a multi-chip slice from one controller; the port
runs one process per rank.  Rank 0 is the caller's engine: it owns the
scheduler, admission, futures, ``health()`` and ``stats()``.  Before each
device dispatch it broadcasts a small plan (the program's name and its
host arguments: slot, tokens, lengths, block ids) over a CPU gloo group,
the :class:`ControlLink`; every other rank runs the same program on its
own shard of the params, grid and pool (``ServingEngine.follow``).  The
layers' collectives then meet in the same order on every rank, and every
rank samples the same tokens from the same gathered logits, so the
followers' state tracks rank 0's without a second broadcast.

``ServeConfig(mesh_shape=(tp, sp))`` (or ``layout="auto"``) makes rank 0
spawn ``tp * sp - 1`` followers (:func:`spawn_slice`, start method
``spawn``, each given only its ``tp`` shard, the same on every ``sp``
member) over the mesh ``{sp, tp}`` (``sp`` major, ``tp`` minor, as the
JAX engine lays it out) and join them over a process group of its own;
a caller's ``mesh=`` brings its ranks and group along instead.

A follower that raises leaves its loop and exits, and a dead follower
makes rank 0's next collective fail (gloo reports the closed connection
at once; a peer that hangs times out after the group's timeout): the
dispatch raises :class:`SliceError` and the engine fails its requests.
The followers wait for their next plan without a timeout (rank 0 may sit
idle for as long as it likes), and end when rank 0 sends ``stop`` or its
connection closes.
"""

from __future__ import annotations

import datetime
import logging
import multiprocessing
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from cloud_tpu_torch.parallel import mesh as mesh_lib

logger = logging.getLogger(__name__)

#: How long a follower waits for its next plan.
FOLLOWER_IDLE_TIMEOUT = datetime.timedelta(days=365)
#: Name prefix of spawned follower processes.
FOLLOWER_PROCESS_NAME = "cloud-tpu-torch-serve-follower"


class SliceError(RuntimeError):
    """A follower of the serving slice failed or died: the slice cannot
    dispatch again."""


class ControlLink:
    """The plan channel: one gloo group over every rank of the slice,
    created by every rank at the same point (a collective call).  Rank 0
    sends with the mesh's timeout; followers receive with no practical
    timeout."""

    def __init__(self, mesh, *, leader: bool):
        self.root = 0
        self.group = dist.new_group(
            ranks=list(range(mesh.spec.num_devices)), backend="gloo",
            timeout=(mesh_lib.DEFAULT_TIMEOUT if leader
                     else FOLLOWER_IDLE_TIMEOUT))

    def send(self, op: str, args: dict) -> None:
        dist.broadcast_object_list([(op, args)], src=self.root,
                                   group=self.group)

    def recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=self.root, group=self.group)
        return box[0]


class SpawnedSlice:
    """The followers this process spawned for a ``mesh_shape`` slice and
    the default process group it made to reach them."""

    def __init__(self, procs: List[multiprocessing.Process]):
        self.procs = procs

    def dead(self) -> Optional[str]:
        """Why the slice cannot serve (a follower exited), or None."""
        for rank, proc in enumerate(self.procs, start=1):
            if not proc.is_alive():
                return f"follower rank {rank} exited with code {proc.exitcode}"
        return None

    def close(self, timeout: float = 30.0) -> None:
        """Join the followers (terminate those still alive after
        ``timeout``) and destroy the process group."""
        for proc in self.procs:
            proc.join(timeout)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout)
        if dist.is_initialized():
            dist.destroy_process_group()


def _host_tree(tree):
    """Params as numpy for the pipe: floats in f32 (bf16 has no numpy
    type; the follower casts back), int8 leaves as they are."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_tree(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def _torch_tree(tree, like):
    if isinstance(tree, dict):
        return {k: _torch_tree(v, like[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v, l) for v, l in zip(tree, like)]
    return torch.from_numpy(tree).to(like)


def _dtypes(tree):
    if isinstance(tree, dict):
        return {k: _dtypes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_dtypes(v) for v in tree]
    return tree.dtype


def spawn_slice(shards, config, serve_config, rules, devices, backend: str,
                spec):
    """Spawn one follower per shard after the first (``shards[r]`` is rank
    ``r``'s params, without their ``"tp"`` context), join them in a new
    default process group as rank 0, and build the slice's mesh of
    ``spec`` (a ``MeshSpec`` over ``tp`` and ``sp``, one rank a shard).
    Returns ``(mesh, SpawnedSlice)``; raises if a follower does not join
    within the mesh's timeout."""
    if dist.is_initialized():
        raise ValueError(
            "mesh_shape/layout='auto' spawns its own process group, and "
            "this process already has one: build a mesh over it and pass "
            "mesh= instead")
    world = len(shards)
    store = dist.TCPStore("127.0.0.1", 0, world, True,
                          timeout=mesh_lib.DEFAULT_TIMEOUT,
                          wait_for_workers=False)
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(
            target=_follower_main, daemon=True,
            name=f"{FOLLOWER_PROCESS_NAME}-{rank}",
            args=(rank, world, store.port, backend,
                  [str(d) for d in devices], _host_tree(shards[rank]),
                  _dtypes(shards[rank]), config, serve_config, rules,
                  torch.get_num_threads(), spec))
        for rank in range(1, world)
    ]
    for proc in procs:
        proc.start()
    spawned = SpawnedSlice(procs)
    try:
        dist.init_process_group(backend, store=store, rank=0,
                                world_size=world,
                                timeout=mesh_lib.DEFAULT_TIMEOUT)
        mesh = spec.build(devices, backend=backend)
    except BaseException:
        for proc in procs:
            proc.kill()
        spawned.close(timeout=5.0)
        raise
    return mesh, spawned


def _follower_main(rank, world, port, backend, devices, shard, dtypes,
                   config, serve_config, rules, threads, spec):
    """A spawned follower: join the group, rebuild its shard, serve
    rank 0's plans until ``stop``.  Imports the port only."""
    from cloud_tpu_torch.parallel import tensor_parallel
    from cloud_tpu_torch.serving.engine import ServingEngine

    torch.set_num_threads(threads)
    store = dist.TCPStore("127.0.0.1", port, world, False,
                          timeout=mesh_lib.DEFAULT_TIMEOUT)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world,
                            timeout=mesh_lib.DEFAULT_TIMEOUT)
    try:
        mesh = spec.build(devices, backend=backend)
        device = mesh.device
        if device.type == "cuda":
            torch.cuda.set_device(device)
        params = _torch_tree(shard, dtypes)
        params["tp"] = tensor_parallel.context(mesh, config, rules)
        engine = ServingEngine(params, config, serve_config, mesh=mesh,
                               rules=rules, device=device)
        engine.follow()
    except BaseException:
        logger.exception("serving follower rank %d failed", rank)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def shard_views(spec, devices, backend):
    """One :class:`~cloud_tpu_torch.parallel.mesh.Mesh` per rank of
    ``spec`` without process groups: enough to cut every rank's shard on
    the host before the followers exist."""
    grid = np.arange(spec.num_devices).reshape(spec.shape())
    views = []
    for rank in range(spec.num_devices):
        coords = dict(zip(mesh_lib.CANONICAL_AXES,
                          (int(c) for c in np.argwhere(grid == rank)[0])))
        views.append(mesh_lib.Mesh(spec=spec, devices=tuple(devices),
                                   rank=rank, coords=coords, backend=backend,
                                   groups={}, group_ranks={}))
    return views
