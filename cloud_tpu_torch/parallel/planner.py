"""Mesh planner (port of ``cloud_tpu/parallel/planner.py``): a machine
config and user hints -> a parallelism layout.

Host arithmetic, kept equal to the JAX package's planner: the same plans,
descriptions and error messages for the same inputs.  :func:`plan_mesh`
maps a job onto named mesh axes (one slice: ``fsdp`` = chips, or ``dp``
with ``prefer_fsdp=False``; several slices: ``dp`` across them, ``fsdp``
within); :func:`plan_serve_layout` picks a serving replica's ``tp``
(x ``sp``) slice from its head count, chip count and memory budget.

``chief_config`` is any object with the JAX package's ``MachineConfig``
methods ``is_tpu()`` and ``tpu_topology()`` (whose result has ``chips``
and ``hosts``); the port's own machine configs come with ``core/``
(ROADMAP.md, section A).  ``num_devices`` plans over a plain device count.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Optional

from cloud_tpu_torch.parallel import mesh as mesh_lib
from cloud_tpu_torch.parallel.mesh import MeshSpec

#: Model-parallel axes a user can pin via hints.
_HINT_AXES = (
    mesh_lib.AXIS_TP,
    mesh_lib.AXIS_SP,
    mesh_lib.AXIS_PP,
    mesh_lib.AXIS_EP,
    mesh_lib.AXIS_FSDP,
    mesh_lib.AXIS_DP,
)


@dataclasses.dataclass(frozen=True)
class ParallelismHints:
    """Optional user pins for mesh axis sizes.

    Unset axes are planned automatically; set axes are honored or rejected
    (never silently adjusted).  ``prefer_fsdp`` switches the leftover
    data-parallel capacity between replicated ``dp`` and sharded ``fsdp``.
    """

    tp: Optional[int] = None
    sp: Optional[int] = None
    pp: Optional[int] = None
    ep: Optional[int] = None
    fsdp: Optional[int] = None
    dp: Optional[int] = None
    prefer_fsdp: bool = True

    def pinned(self) -> Dict[str, int]:
        out = {}
        for axis in _HINT_AXES:
            val = getattr(self, axis)
            if val is not None:
                if val < 1:
                    raise ValueError(f"Hint {axis}={val} must be >= 1")
                out[axis] = val
        return out


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A fully-determined parallelism layout for one job."""

    spec: MeshSpec
    num_slices: int
    chips_per_slice: int
    hosts_per_slice: int
    description: str

    @property
    def total_chips(self) -> int:
        return self.num_slices * self.chips_per_slice

    @property
    def total_hosts(self) -> int:
        return self.num_slices * self.hosts_per_slice

    def build(self, devices=None, **kwargs):
        return self.spec.build(devices, **kwargs)

    def to_json(self) -> str:
        return json.dumps(
            {
                "sizes": self.spec.sizes,
                "dcn_sizes": self.spec.dcn_sizes,
                "num_slices": self.num_slices,
                "chips_per_slice": self.chips_per_slice,
                "hosts_per_slice": self.hosts_per_slice,
                "description": self.description,
            }
        )

    @classmethod
    def from_json(cls, data: str) -> "MeshPlan":
        obj = json.loads(data)
        return cls(
            spec=MeshSpec(
                sizes=obj["sizes"], dcn_sizes=obj.get("dcn_sizes", {})
            ),
            num_slices=obj["num_slices"],
            chips_per_slice=obj["chips_per_slice"],
            hosts_per_slice=obj["hosts_per_slice"],
            description=obj["description"],
        )


@dataclasses.dataclass(frozen=True)
class ServeLayout:
    """A fully-determined serving partition for one replica slice.

    Serving replicas shard the *generation* path — params by head/mlp/
    vocab, the slot KV cache (and prefix-cache block pool) by attention
    head — over a ``tp`` (x ``sp``) mesh, so one replica spans a
    multi-chip slice instead of one chip.  ``tp`` must divide the
    model's head count (head-granular KV sharding); ``sp`` is sequence
    parallelism over activations and defaults to 1.  The per-chip byte
    fields are planning *estimates* (params and KV divide by ``tp``;
    replicated norm scales are negligible), good enough to pick a
    layout against an HBM budget, not an allocator.
    """

    tp: int
    sp: int
    description: str
    param_bytes_per_chip: int = 0
    kv_bytes_per_chip: int = 0
    #: Speculative-decoding draft footprint (params + draft slot KV),
    #: budgeted REPLICATED per chip — the conservative bound: the engine
    #: head-shards the draft only when ``tp`` divides its head count.
    draft_bytes_per_chip: int = 0

    @property
    def num_chips(self) -> int:
        return self.tp * self.sp

    @property
    def shape(self) -> tuple:
        return (self.tp, self.sp)

    def mesh_spec(self) -> MeshSpec:
        return MeshSpec(sizes={
            mesh_lib.AXIS_SP: self.sp, mesh_lib.AXIS_TP: self.tp,
        })


def plan_serve_layout(
    *,
    num_heads: int,
    num_devices: int,
    param_bytes: int = 0,
    kv_bytes: int = 0,
    draft_bytes: int = 0,
    hbm_bytes_per_chip: Optional[int] = None,
    sp: int = 1,
) -> ServeLayout:
    """Pick the tensor-parallel serving partition for one replica slice.

    The serving analogue of :func:`plan_mesh` (AMP-style layout search,
    PAPERS.md): from the model's head count, the slice's chip count, and
    an optional per-chip HBM budget, choose the ``tp`` degree a
    ``ServingEngine`` replica shards its generation programs over.

    Candidates are every ``tp`` that divides ``num_heads`` (the KV cache
    shards by head — a non-dividing degree would split a head) and fits
    the slice (``tp * sp <= num_devices``).  Without a budget the
    largest candidate wins: use the whole slice for per-request speed.
    With ``hbm_bytes_per_chip``, the SMALLEST candidate whose estimated
    per-chip bytes (params + KV, both ~1/tp, plus the whole
    ``draft_bytes`` term — a speculative-decoding draft model's params +
    draft slot KV, budgeted replicated since the engine only head-shards
    a draft whose head count ``tp`` divides) fit wins — sharding no
    wider than memory requires leaves the remaining chips for more
    replicas, which is the fleet's business, not the slice's.  Raises
    ``ValueError`` (naming every number involved) when even the widest
    candidate busts the budget.
    """
    if num_heads < 1:
        raise ValueError(f"num_heads must be >= 1, got {num_heads}")
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    if sp < 1:
        raise ValueError(f"sp must be >= 1, got {sp}")
    if sp > num_devices:
        raise ValueError(
            f"sp={sp} exceeds the slice's {num_devices} device(s)"
        )
    candidates = [
        t for t in range(1, num_devices // sp + 1) if num_heads % t == 0
    ]

    def per_chip(tp: int) -> tuple:
        return (param_bytes + tp - 1) // tp, (kv_bytes + tp - 1) // tp

    if hbm_bytes_per_chip is None:
        tp = candidates[-1]
    else:
        fitting = [
            t for t in candidates
            if sum(per_chip(t)) + draft_bytes <= hbm_bytes_per_chip
        ]
        if not fitting:
            widest = candidates[-1]
            raise ValueError(
                f"No serving layout fits hbm_bytes_per_chip="
                f"{hbm_bytes_per_chip}: even tp={widest} (the widest "
                f"divisor of num_heads={num_heads} within "
                f"{num_devices} device(s), sp={sp}) needs "
                f"{sum(per_chip(widest)) + draft_bytes} bytes/chip "
                f"(params {param_bytes} + kv {kv_bytes} total"
                + (
                    f" + draft {draft_bytes} replicated"
                    if draft_bytes else ""
                )
                + "). Shrink the model/cache/draft or grow the slice."
            )
        tp = fitting[0]
    p_chip, k_chip = per_chip(tp)
    description = (
        f"serve slice {tp * sp} chip(s): tp={tp}"
        + (f" x sp={sp}" if sp > 1 else "")
        + f" ({num_heads} heads -> {num_heads // tp}/chip"
        + (
            f", ~{(p_chip + k_chip + draft_bytes) >> 20} MiB/chip"
            if param_bytes or kv_bytes or draft_bytes else ""
        )
        + (f", draft ~{draft_bytes >> 20} MiB replicated"
           if draft_bytes else "")
        + ")"
    )
    return ServeLayout(
        tp=tp, sp=sp, description=description,
        param_bytes_per_chip=p_chip, kv_bytes_per_chip=k_chip,
        draft_bytes_per_chip=draft_bytes,
    )


def plan_mesh(
    chief_config=None,
    worker_count: int = 0,
    hints: Optional[ParallelismHints] = None,
    num_devices: Optional[int] = None,
) -> MeshPlan:
    """Plan the mesh for a job.

    ``chief_config`` describes the TPU slice every worker runs (reference
    semantics: ``worker_count`` *additional* replicas of the slice, so the
    job spans ``worker_count + 1`` slices).  ``num_devices`` overrides the
    chip count for local/virtual runs (tests, CPU dry-runs) where no
    MachineConfig exists; combined with ``worker_count`` it plans a
    multi-slice job over virtual devices (``num_devices`` total chips
    split evenly into ``worker_count + 1`` slices), so the dp-over-DCN
    rule below is exercisable without TPU hardware.
    """
    hints = hints or ParallelismHints()

    if num_devices is not None:
        num_slices = worker_count + 1
        if num_devices % num_slices:
            raise ValueError(
                f"num_devices={num_devices} cannot be split into "
                f"worker_count + 1 = {num_slices} equal virtual slices "
                f"(worker_count={worker_count}); num_devices must be a "
                f"multiple of {num_slices}"
            )
        chips_per_slice = num_devices // num_slices
        hosts_per_slice = 1
    elif chief_config is not None and chief_config.is_tpu():
        topo = chief_config.tpu_topology()
        chips_per_slice = topo.chips
        hosts_per_slice = topo.hosts
        num_slices = worker_count + 1
    else:
        # CPU-only role: a single process, single "device" plan.
        chips_per_slice = 1
        hosts_per_slice = 1
        num_slices = 1

    total = chips_per_slice * num_slices
    pinned = hints.pinned()

    model_parallel = math.prod(
        pinned.get(a, 1)
        for a in (mesh_lib.AXIS_TP, mesh_lib.AXIS_SP, mesh_lib.AXIS_PP,
                  mesh_lib.AXIS_EP)
    )
    if total % model_parallel:
        raise ValueError(
            f"Model-parallel axes (tp x sp x pp x ep = {model_parallel}) do not "
            f"divide the total chip count {total} "
            f"({num_slices} slice(s) x {chips_per_slice} chips)."
        )
    data_capacity = total // model_parallel

    dp = pinned.get(mesh_lib.AXIS_DP)
    fsdp = pinned.get(mesh_lib.AXIS_FSDP)
    if dp is None and fsdp is None:
        if num_slices > 1:
            # DCN-friendly default: replicate across slices, shard within.
            if data_capacity % num_slices:
                raise ValueError(
                    f"Data-parallel capacity {data_capacity} not divisible by "
                    f"{num_slices} slices; pin dp/fsdp explicitly."
                )
            dp, fsdp = num_slices, data_capacity // num_slices
        elif hosts_per_slice > 1 or hints.prefer_fsdp:
            # Multi-host (or large-model preference): shard params over ICI.
            dp, fsdp = 1, data_capacity
        else:
            dp, fsdp = data_capacity, 1
    elif dp is None:
        if data_capacity % fsdp:
            raise ValueError(
                f"fsdp={fsdp} does not divide data capacity {data_capacity}"
            )
        dp = data_capacity // fsdp
    elif fsdp is None:
        if data_capacity % dp:
            raise ValueError(
                f"dp={dp} does not divide data capacity {data_capacity}"
            )
        fsdp = data_capacity // dp
    elif dp * fsdp != data_capacity:
        raise ValueError(
            f"dp={dp} x fsdp={fsdp} != data capacity {data_capacity} "
            f"(total {total} / model-parallel {model_parallel})"
        )

    sizes = {
        mesh_lib.AXIS_DP: dp,
        mesh_lib.AXIS_PP: pinned.get(mesh_lib.AXIS_PP, 1),
        mesh_lib.AXIS_FSDP: fsdp,
        mesh_lib.AXIS_EP: pinned.get(mesh_lib.AXIS_EP, 1),
        mesh_lib.AXIS_SP: pinned.get(mesh_lib.AXIS_SP, 1),
        mesh_lib.AXIS_TP: pinned.get(mesh_lib.AXIS_TP, 1),
    }
    dcn_sizes = {}
    if num_slices > 1:
        # Slice boundaries are crossed by the dp axis only (the lone
        # per-step collective tolerant of DCN latency).  A plan whose dp
        # cannot absorb the slice count would force another axis onto DCN —
        # reject it rather than silently build a layout whose ICI-hungry
        # collectives ride the slow links.
        if dp % num_slices:
            raise ValueError(
                f"Multi-slice plan needs dp divisible by the slice count: "
                f"dp={dp}, slices={num_slices}. Pin dp to a multiple of "
                f"{num_slices} (or leave dp/fsdp unpinned)."
            )
        dcn_sizes = {mesh_lib.AXIS_DP: num_slices}
    spec = MeshSpec(sizes=sizes, dcn_sizes=dcn_sizes)

    nontrivial = {a: s for a, s in sizes.items() if s > 1} or {"dp": 1}
    description = (
        f"{num_slices} slice(s) x {chips_per_slice} chips: "
        + " x ".join(f"{a}={s}" for a, s in nontrivial.items())
        + (" (dp over DCN)" if dcn_sizes else "")
    )
    return MeshPlan(
        spec=spec,
        num_slices=num_slices,
        chips_per_slice=chips_per_slice,
        hosts_per_slice=hosts_per_slice,
        description=description,
    )
