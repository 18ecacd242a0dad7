"""Named device meshes (port of ``cloud_tpu/parallel/mesh.py``).

The JAX package runs every parallel strategy as one ``jax.sharding.Mesh``
driven by a single controller.  The port runs one process per rank on
``torch.distributed``: a :class:`MeshSpec` names the axis sizes, and
:meth:`MeshSpec.build` lays the ranks of the default process group out on
the canonical grid and gives every nontrivial axis its own process group,
so a collective over ``tp`` reaches exactly this rank's ``tp``
neighbours.  Axis conventions:

==========  =====================================================
``dp``      pure data parallelism — params replicated; the slowest
            links, its only collective one gradient all-reduce a step
``pp``      pipeline stages
``fsdp``    data parallelism with params/optimizer sharded (ZeRO-3)
``ep``      expert parallelism for MoE layers
``sp``      sequence/context parallelism (ring attention)
``tp``      tensor parallelism (heads/mlp sharding); innermost —
            its collectives are on the hot path of every matmul
==========  =====================================================

The canonical order sorts axes by collective latency tolerance, and the
rank grid is a row-major reshape in that order, so ``tp`` neighbours are
consecutive ranks (on one host: the cards NVLink joins all to all).

A second thread that runs a step under a mesh beside the main thread
(``Trainer.fit(compile_ahead=True)``'s worker, which warms the step up
while the main thread restores shards, steps and validates) must not
share the main thread's groups: two threads' collectives on one group
pair in whatever order each rank issues them, which on two ranks can
differ, and a collective then meets the wrong peer (a deadlock, or a sum
of unrelated tensors).  :func:`worker_mesh` gives such a thread a second
set of axis groups, and :func:`route` sends that thread's collectives
over any of the mesh's axes through them (see there).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import json
import math
import threading
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXIS_DP = "dp"
AXIS_PP = "pp"
AXIS_FSDP = "fsdp"
AXIS_EP = "ep"
AXIS_SP = "sp"
AXIS_TP = "tp"

#: Outermost (slow-link tolerant) to innermost (bandwidth hungry).
CANONICAL_AXES: Tuple[str, ...] = (
    AXIS_DP,
    AXIS_PP,
    AXIS_FSDP,
    AXIS_EP,
    AXIS_SP,
    AXIS_TP,
)

#: How long a mesh's collectives wait for a peer before they raise.
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Sizes for each canonical axis (missing axes default to 1).

    ``dcn_sizes`` gives, per axis, how much of that axis spans slow links
    between slices rather than the fast ones inside a slice; an axis of
    size 8 with ``dcn_sizes={"dp": 2}`` is 2 granules x 4 within one.
    The planner fills it for multi-slice jobs.
    """

    sizes: Dict[str, int]
    dcn_sizes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        for axis in self.sizes:
            if axis not in CANONICAL_AXES:
                raise ValueError(
                    f"Unknown mesh axis {axis!r}; canonical axes are "
                    f"{CANONICAL_AXES}"
                )
            if self.sizes[axis] < 1:
                raise ValueError(f"Axis {axis!r} must have size >= 1")
        for axis, dcn in self.dcn_sizes.items():
            if axis not in CANONICAL_AXES:
                raise ValueError(f"Unknown DCN axis {axis!r}")
            if dcn < 1 or self.size(axis) % dcn:
                raise ValueError(
                    f"DCN granule {dcn} must divide axis {axis!r} size "
                    f"{self.size(axis)}"
                )

    @property
    def dcn_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in CANONICAL_AXES if self.dcn_sizes.get(a, 1) > 1)

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    @property
    def num_devices(self) -> int:
        return math.prod(self.sizes.values()) if self.sizes else 1

    def axis_names(self) -> Tuple[str, ...]:
        return CANONICAL_AXES

    def shape(self) -> Tuple[int, ...]:
        return tuple(self.size(a) for a in CANONICAL_AXES)

    def nontrivial_axes(self) -> List[str]:
        return [a for a in CANONICAL_AXES if self.size(a) > 1]

    def build(self, devices: Optional[Sequence] = None, *,
              backend: Optional[str] = None) -> "Mesh":
        """This rank's :class:`Mesh` over the default process group.

        ``devices[r]`` is rank ``r``'s device (default: ``cuda:r`` modulo
        the visible cards); their number must be ``num_devices``, which
        must also be the process group's size (a one-device mesh needs no
        process group).  ``backend`` is the per-axis groups' backend:
        ``nccl`` for CUDA devices and ``gloo`` for the CPU unless the
        caller names one (two ranks sharing a card must ask for gloo:
        NCCL refuses two ranks on one device).  Every rank calls
        ``build`` with the same arguments: it creates every axis group of
        the grid in canonical order, a collective call each.  Their
        collectives raise after :data:`DEFAULT_TIMEOUT` without a peer.
        """
        devices = (_default_devices(self.num_devices) if devices is None
                   else [torch.device(d) for d in devices])
        if len(devices) != self.num_devices:
            raise ValueError(
                f"MeshSpec wants {self.num_devices} devices "
                f"(sizes={self.sizes}), got {len(devices)}"
            )
        if backend is None:
            backend = "nccl" if devices[0].type == "cuda" else "gloo"
        grid = np.arange(self.num_devices).reshape(self.shape())
        if self.num_devices == 1 and not dist.is_initialized():
            rank = 0
        else:
            if not dist.is_initialized():
                raise RuntimeError(
                    f"a {self.num_devices}-device mesh needs an initialized "
                    "torch.distributed process group (parallel.distributed"
                    ".initialize_from_env, or init_process_group)"
                )
            if dist.get_world_size() != self.num_devices:
                raise ValueError(
                    f"MeshSpec wants {self.num_devices} ranks, the process "
                    f"group has {dist.get_world_size()}"
                )
            rank = dist.get_rank()
        coords = dict(zip(CANONICAL_AXES,
                          (int(c) for c in np.argwhere(grid == rank)[0])))
        groups, group_ranks = self._axis_groups(rank, backend)
        return Mesh(spec=self, devices=tuple(devices), rank=rank,
                    coords=coords, backend=backend, groups=groups,
                    group_ranks=group_ranks)

    def _axis_groups(self, rank: int, backend: str):
        """``(groups, group_ranks)`` of ``rank``: one new process group per
        row of every nontrivial axis of the grid, made in canonical order
        (every rank makes every group, a collective call each)."""
        grid = np.arange(self.num_devices).reshape(self.shape())
        groups, group_ranks = {}, {}
        for i, axis in enumerate(CANONICAL_AXES):
            if self.size(axis) == 1:
                continue
            rows = np.moveaxis(grid, i, -1).reshape(-1, self.size(axis))
            for row in rows.tolist():
                group = dist.new_group(ranks=row, backend=backend,
                                       timeout=DEFAULT_TIMEOUT)
                if rank in row:
                    groups[axis], group_ranks[axis] = group, tuple(row)
        return groups, group_ranks

    # --- wire format (job specs carry the plan into the container) ---

    def to_json(self) -> str:
        return json.dumps({"sizes": self.sizes, "dcn_sizes": self.dcn_sizes})

    @classmethod
    def from_json(cls, data: str) -> "MeshSpec":
        obj = json.loads(data)
        return cls(sizes=obj["sizes"], dcn_sizes=obj.get("dcn_sizes", {}))


def _default_devices(n: int) -> List[torch.device]:
    """One card per rank, ``cuda:r`` modulo the visible cards; raises on a
    host without one (the CPU is used only when asked for)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass devices= "
            "(e.g. ['cpu'] * n) to build a mesh of CPU ranks")
    count = torch.cuda.device_count()
    return [torch.device("cuda", r % count) for r in range(n)]


def visible_devices(device_type: str) -> List[torch.device]:
    """The devices a serving slice may span on this host: every card for
    ``cuda``; for ``cpu`` one rank per core."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    import os

    return [torch.device("cpu")] * (os.cpu_count() or 1)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a built mesh: its device, its coordinates on
    the grid and one process group per nontrivial axis (``groups``, with
    the global ranks of each group's members in axis order in
    ``group_ranks``)."""

    spec: MeshSpec
    devices: Tuple[torch.device, ...]
    rank: int
    coords: Dict[str, int]
    backend: str
    groups: Dict[str, object]
    group_ranks: Dict[str, Tuple[int, ...]]

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, every canonical axis (``Mesh.shape``)."""
        return {a: self.spec.size(a) for a in CANONICAL_AXES}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return CANONICAL_AXES

    def axis_size(self, axis: str) -> int:
        return self.spec.size(axis)

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        """The process group of this rank's ``axis`` neighbours (None on
        an axis of size 1): on a thread that :func:`route` routes this
        mesh, the worker mesh's group of the same neighbours."""
        return routed(self).groups.get(axis)


def check_mesh(mesh) -> None:
    """Raise ``TypeError`` unless ``mesh`` is None or a :class:`Mesh`."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(
            "mesh= takes a parallel.mesh.Mesh (MeshSpec(...).build()), got "
            f"{type(mesh).__name__}")


def effective_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh`` as a training step sees it (:func:`check_mesh` first):
    None when there is none or when it has one rank, since every
    collective over such a mesh is the identity and the step is the
    single-process one."""
    check_mesh(mesh)
    return mesh if mesh is not None and mesh.spec.num_devices > 1 else None


# --- a second thread's groups ----------------------------------------------

#: Per thread: ``routes`` (id of a mesh -> its worker mesh) and ``mesh``
#: (the global mesh as this thread sees it), set by :func:`route`.
_THREAD = threading.local()
_WORKER_MESHES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_WORKER_LOCK = threading.Lock()


def worker_mesh(mesh: Mesh) -> Mesh:
    """``mesh``'s coordinates, devices and members with a second set of
    axis groups of their own, made once per mesh (later calls return the
    same one).  A collective call: every rank calls it for the same mesh,
    in the same order, before the thread that uses it starts."""
    check_mesh(mesh)
    with _WORKER_LOCK:
        side = _WORKER_MESHES.get(mesh)
        if side is None:
            groups, group_ranks = mesh.spec._axis_groups(mesh.rank,
                                                         mesh.backend)
            side = dataclasses.replace(mesh, groups=groups,
                                       group_ranks=group_ranks)
            _WORKER_MESHES[mesh] = side
    return side


@contextlib.contextmanager
def route(mesh: Mesh, side: Mesh):
    """On this thread, for the duration of the block: ``mesh.group(axis)``
    is ``side``'s group (so every collective over ``mesh`` from this
    thread goes through ``side``'s groups, whoever holds the mesh: the
    step, its loss, the layers) and :func:`get_global_mesh` is ``mesh``.
    Autograd runs the backward of CUDA tensors on a thread of its own,
    which does not see the route: a differentiable collective keeps
    :func:`routed` of its mesh, taken in its forward, for its backward,
    and a remat body takes the route along (:func:`keep_route`)."""
    routes = dict(getattr(_THREAD, "routes", None) or {})
    routes[id(mesh)] = side
    with _thread_routes(routes, mesh):
        yield side


@contextlib.contextmanager
def _thread_routes(routes, mesh):
    prev = (getattr(_THREAD, "routes", None), getattr(_THREAD, "mesh", None))
    _THREAD.routes, _THREAD.mesh = routes, mesh
    try:
        yield
    finally:
        _THREAD.routes, _THREAD.mesh = prev


def keep_route(fn):
    """``fn``, run under this thread's routes wherever it is called later
    (a remat body that autograd's backward thread recomputes); ``fn``
    itself on a thread without routes."""
    routes = getattr(_THREAD, "routes", None)
    if not routes:
        return fn
    mesh = getattr(_THREAD, "mesh", None)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _thread_routes(routes, mesh):
            return fn(*args, **kwargs)

    return run


def routed(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh whose groups this thread's collectives over ``mesh`` use:
    its worker mesh on a thread that :func:`route` routes it, else
    ``mesh``."""
    routes = getattr(_THREAD, "routes", None)
    if mesh is not None and routes and id(mesh) in routes:
        return routes[id(mesh)]
    return mesh


# --- global mesh registry -------------------------------------------------

_GLOBAL_MESH: Optional[Mesh] = None


def set_global_mesh(mesh: Optional[Mesh]) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_global_mesh() -> Optional[Mesh]:
    """The installed global mesh (:func:`use_mesh`); on a thread that
    :func:`route` routes, the routed mesh."""
    local = getattr(_THREAD, "mesh", None)
    return local if local is not None else _GLOBAL_MESH


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Install ``mesh`` as the global mesh for the duration of the block
    (the collectives' default mesh)."""
    prev = get_global_mesh()
    set_global_mesh(mesh)
    try:
        yield mesh
    finally:
        set_global_mesh(prev)
