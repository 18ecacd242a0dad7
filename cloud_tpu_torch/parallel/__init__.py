"""Parallelism layer (port of ``cloud_tpu/parallel``): meshes, sharding
rules, the planner and collectives over ``torch.distributed``.

A :class:`MeshSpec` names the axis sizes and builds one rank's
:class:`~cloud_tpu_torch.parallel.mesh.Mesh` (its device, its grid
coordinates, a process group per nontrivial axis); the planner maps a
machine config or a device count to a layout; sharding rules map logical
tensor axes to mesh axes, which decides each rank's slice of a tensor.
The JAX package's ``named_sharding`` (a GSPMD placement) has no
counterpart: ``sharding.shard_tensor`` cuts a rank's slice instead.
Training under a mesh adds ``ring_attention.py`` (the ring and the
zig-zag ring over the flash kernels), ``autograd.py`` (the collectives
a backward pass runs), ``collectives``' two-level sum, ``grad_sync``,
Ulysses' all-to-all and the pipeline's point-to-point ``exchange``,
``pipeline.py`` (GPipe over ``pp``) and ``selfcheck.py`` (``python -m
cloud_tpu_torch.parallel.selfcheck``, the per-host check that a job is
wired).  The exports are the JAX package's.
"""

from cloud_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_EP,
    AXIS_FSDP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    CANONICAL_AXES,
    MeshSpec,
    get_global_mesh,
    set_global_mesh,
    use_mesh,
)
from cloud_tpu_torch.parallel.planner import (
    MeshPlan,
    ParallelismHints,
    ServeLayout,
    plan_mesh,
    plan_serve_layout,
)
from cloud_tpu_torch.parallel.sharding import (
    ShardingRules,
    DEFAULT_RULES,
    logical_to_mesh_axes,
    shard_constraint,
)

__all__ = [
    "AXIS_DP",
    "AXIS_EP",
    "AXIS_FSDP",
    "AXIS_PP",
    "AXIS_SP",
    "AXIS_TP",
    "CANONICAL_AXES",
    "MeshSpec",
    "MeshPlan",
    "ParallelismHints",
    "ShardingRules",
    "DEFAULT_RULES",
    "get_global_mesh",
    "set_global_mesh",
    "use_mesh",
    "logical_to_mesh_axes",
    "plan_mesh",
    "plan_serve_layout",
    "ServeLayout",
    "shard_constraint",
]
