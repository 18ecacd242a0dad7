"""TPU-first machine/slice resource model.

The port's copy of ``cloud_tpu/core/machine_config.py``, value for value:
the port launches the same catalog and presets as the JAX package, so its
requests can be held equal to the reference's (ROADMAP.md A.5).

This is the declarative resource layer of the framework: every job a user
launches is described by a :class:`MachineConfig` (what one *role* of the job
runs on) and, for TPU roles, a :class:`TpuTopology` (the shape of the slice).

Reference analogue: ``src/python/tensorflow_cloud/core/machine_config.py``
(AcceleratorType enum :25-55, MachineConfig :58-93, COMMON_MACHINE_CONFIGS
:97-176, is_tpu_config :179-185).  Differences, by design:

* TPU generations are first-class (v2..v6e) and carry *slice topology*
  (``2x4``, ``4x4`` ...), because on Cloud TPU the slice shape — not a GPU
  count — is the unit of scale.  The reference only knew ``TPU_V2/V3 x 8``.
* GPU accelerator types from the reference are kept as *migration aliases* so
  existing configs still parse; the TPU deploy path rejects them with a
  pointer to the nearest TPU config (see :func:`gpu_migration_hint`).
* A config knows how many hosts its slice spans — the mesh planner
  (``cloud_tpu/parallel/planner.py``) turns that into DCN x ICI mesh axes.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional


class AcceleratorType(enum.Enum):
    """Accelerator families a job role can request.

    TPU generations are the native path.  The NVIDIA entries mirror the
    reference enum (machine_config.py:25-55) so that configs written against
    the reference keep parsing; they are rejected at deploy time with a
    migration hint.
    """

    NO_ACCELERATOR = "CPU"
    TPU_V2 = "TPU_V2"
    TPU_V3 = "TPU_V3"
    TPU_V4 = "TPU_V4"
    TPU_V5E = "TPU_V5E"
    TPU_V5P = "TPU_V5P"
    TPU_V6E = "TPU_V6E"
    # --- migration aliases (reference GPU catalog) ---
    NVIDIA_TESLA_K80 = "K80"
    NVIDIA_TESLA_P100 = "P100"
    NVIDIA_TESLA_V100 = "V100"
    NVIDIA_TESLA_P4 = "P4"
    NVIDIA_TESLA_T4 = "T4"


#: TPU generations, newest last.
TPU_ACCELERATORS = (
    AcceleratorType.TPU_V2,
    AcceleratorType.TPU_V3,
    AcceleratorType.TPU_V4,
    AcceleratorType.TPU_V5E,
    AcceleratorType.TPU_V5P,
    AcceleratorType.TPU_V6E,
)

GPU_ACCELERATORS = (
    AcceleratorType.NVIDIA_TESLA_K80,
    AcceleratorType.NVIDIA_TESLA_P100,
    AcceleratorType.NVIDIA_TESLA_V100,
    AcceleratorType.NVIDIA_TESLA_P4,
    AcceleratorType.NVIDIA_TESLA_T4,
)


@dataclasses.dataclass(frozen=True)
class TpuTopology:
    """Shape of one TPU slice.

    ``chips`` is the number of physical chips; ``hosts`` the number of TPU-VM
    hosts the slice spans; ``topology`` the ICI wiring string as used by the
    Cloud TPU API (``2x4``, ``4x4x4`` ...); ``accelerator_type`` the API name
    (``v5litepod-8`` ...).  ``cores_per_chip`` distinguishes the two-TensorCore
    generations (v2-v4, v5p) from the single-core inference-optimised ones
    (v5e, v6e).
    """

    generation: AcceleratorType
    accelerator_type: str
    topology: str
    chips: int
    hosts: int
    cores_per_chip: int

    @property
    def chips_per_host(self) -> int:
        return self.chips // self.hosts

    @property
    def cores(self) -> int:
        return self.chips * self.cores_per_chip


def _topo(gen, name, topology, chips, hosts, cores_per_chip) -> TpuTopology:
    return TpuTopology(gen, name, topology, chips, hosts, cores_per_chip)


#: Legal slice shapes per generation, keyed by Cloud TPU API accelerator-type
#: string.  This is the TPU-native analogue of the reference's ~200-row
#: (cpu, mem, accelerator, count) whitelist (gcp.py:123-406): deploy requests
#: are validated against this table before anything touches the network.
TPU_SLICE_CATALOG: Dict[str, TpuTopology] = {
    t.accelerator_type: t
    for t in [
        # v2 / v3 (the only generations the reference knew; gcp.py:78-90)
        _topo(AcceleratorType.TPU_V2, "v2-8", "2x2", 4, 1, 2),
        _topo(AcceleratorType.TPU_V2, "v2-32", "4x4", 16, 4, 2),
        _topo(AcceleratorType.TPU_V3, "v3-8", "2x2", 4, 1, 2),
        _topo(AcceleratorType.TPU_V3, "v3-32", "4x4", 16, 4, 2),
        # v4: 3D torus, 4 chips/host
        _topo(AcceleratorType.TPU_V4, "v4-8", "2x2x1", 4, 1, 2),
        _topo(AcceleratorType.TPU_V4, "v4-16", "2x2x2", 8, 2, 2),
        _topo(AcceleratorType.TPU_V4, "v4-32", "2x2x4", 16, 4, 2),
        _topo(AcceleratorType.TPU_V4, "v4-64", "2x4x4", 32, 8, 2),
        _topo(AcceleratorType.TPU_V4, "v4-128", "4x4x4", 64, 16, 2),
        # v5e: 2D mesh, single host up to 8 chips, 4 chips/host beyond
        _topo(AcceleratorType.TPU_V5E, "v5litepod-1", "1x1", 1, 1, 1),
        _topo(AcceleratorType.TPU_V5E, "v5litepod-4", "2x2", 4, 1, 1),
        _topo(AcceleratorType.TPU_V5E, "v5litepod-8", "2x4", 8, 1, 1),
        _topo(AcceleratorType.TPU_V5E, "v5litepod-16", "4x4", 16, 4, 1),
        _topo(AcceleratorType.TPU_V5E, "v5litepod-32", "4x8", 32, 8, 1),
        _topo(AcceleratorType.TPU_V5E, "v5litepod-64", "8x8", 64, 16, 1),
        _topo(AcceleratorType.TPU_V5E, "v5litepod-128", "8x16", 128, 32, 1),
        _topo(AcceleratorType.TPU_V5E, "v5litepod-256", "16x16", 256, 64, 1),
        # v5p: 3D torus, 4 chips/host
        _topo(AcceleratorType.TPU_V5P, "v5p-8", "2x2x1", 4, 1, 2),
        _topo(AcceleratorType.TPU_V5P, "v5p-16", "2x2x2", 8, 2, 2),
        _topo(AcceleratorType.TPU_V5P, "v5p-32", "2x2x4", 16, 4, 2),
        _topo(AcceleratorType.TPU_V5P, "v5p-128", "4x4x4", 64, 16, 2),
        # v6e (Trillium): 2D mesh like v5e
        _topo(AcceleratorType.TPU_V6E, "v6e-1", "1x1", 1, 1, 1),
        _topo(AcceleratorType.TPU_V6E, "v6e-4", "2x2", 4, 1, 1),
        _topo(AcceleratorType.TPU_V6E, "v6e-8", "2x4", 8, 1, 1),
        _topo(AcceleratorType.TPU_V6E, "v6e-16", "4x4", 16, 4, 1),
        _topo(AcceleratorType.TPU_V6E, "v6e-32", "4x8", 32, 8, 1),
        _topo(AcceleratorType.TPU_V6E, "v6e-64", "8x8", 64, 16, 1),
        _topo(AcceleratorType.TPU_V6E, "v6e-128", "8x16", 128, 32, 1),
        _topo(AcceleratorType.TPU_V6E, "v6e-256", "16x16", 256, 64, 1),
    ]
}


def find_topology(
    generation: AcceleratorType, chips: int, topology: Optional[str] = None
) -> TpuTopology:
    """Resolve (generation, chip count[, topology string]) to a catalog entry."""
    matches = [
        t
        for t in TPU_SLICE_CATALOG.values()
        if t.generation == generation
        and t.chips == chips
        and (topology is None or t.topology == topology)
    ]
    if not matches:
        legal = sorted(
            t.chips for t in TPU_SLICE_CATALOG.values() if t.generation == generation
        )
        raise ValueError(
            f"No legal {generation.name} slice with {chips} chips"
            + (f" and topology {topology!r}" if topology else "")
            + f". Legal chip counts for {generation.name}: {legal}."
        )
    return matches[0]


@dataclasses.dataclass(frozen=True)
class MachineConfig:
    """Declarative spec for one job role (chief / worker).

    For TPU configs ``accelerator_count`` counts *chips* — note Google's
    v2/v3/v4/v5p accelerator-type names count TensorCores instead, so
    ``TPU_V4 x 32`` chips resolves to API name ``v4-64`` — and ``topology``
    may pin the slice wiring; ``cpu_cores``/``memory`` describe the host VM and
    may be ``None`` (TPU-VM machine shape is implied by the slice, mirroring
    the reference's TPU rows ``(None, None, TPU_V*, 8)``, gcp.py:123-406).
    """

    cpu_cores: Optional[int] = 8
    memory: Optional[int] = 30
    accelerator_type: AcceleratorType = AcceleratorType.NO_ACCELERATOR
    accelerator_count: int = 0
    topology: Optional[str] = None

    def __post_init__(self):
        if not isinstance(self.accelerator_type, AcceleratorType):
            raise ValueError(
                "accelerator_type must be an AcceleratorType, got "
                f"{self.accelerator_type!r}"
            )
        if self.accelerator_type is AcceleratorType.NO_ACCELERATOR:
            if self.accelerator_count:
                raise ValueError(
                    "accelerator_count must be 0 for NO_ACCELERATOR, got "
                    f"{self.accelerator_count}"
                )
        elif self.accelerator_count < 1:
            raise ValueError(
                f"accelerator_count must be >= 1 for {self.accelerator_type.name}"
            )
        if self.is_tpu():
            # Resolves or raises with the legal-shape table.
            find_topology(self.accelerator_type, self.accelerator_count, self.topology)

    def is_tpu(self) -> bool:
        return self.accelerator_type in TPU_ACCELERATORS

    def is_gpu(self) -> bool:
        return self.accelerator_type in GPU_ACCELERATORS

    def tpu_topology(self) -> TpuTopology:
        if not self.is_tpu():
            raise ValueError(f"{self.accelerator_type.name} is not a TPU config")
        return find_topology(
            self.accelerator_type, self.accelerator_count, self.topology
        )


def is_tpu_config(config: Optional[MachineConfig]) -> bool:
    """Reference parity: machine_config.py:179-185."""
    return config is not None and config.is_tpu()


def gpu_migration_hint(config: MachineConfig) -> str:
    """The TPU config a reference GPU config should move to.

    Used by validate/deploy to produce actionable errors instead of silently
    launching GPU fleets from a TPU-native framework.
    """
    n = max(1, config.accelerator_count)
    if n <= 1:
        name = "v5litepod-1"
    elif n <= 4:
        name = "v5litepod-4"
    else:
        name = "v5litepod-8"
    return (
        f"{config.accelerator_type.name} x{config.accelerator_count} is a GPU "
        f"config from tensorflow-cloud; this framework launches TPU jobs. "
        f"Nearest TPU equivalent: COMMON_MACHINE_CONFIGS['TPU_V5E_{TPU_SLICE_CATALOG[name].chips}'] "
        f"({name})."
    )


def _tpu_config(name: str) -> MachineConfig:
    t = TPU_SLICE_CATALOG[name]
    return MachineConfig(
        cpu_cores=None,
        memory=None,
        accelerator_type=t.generation,
        accelerator_count=t.chips,
        topology=t.topology,
    )


#: Named presets.  Mirrors the reference's 14-entry catalog
#: (machine_config.py:97-176) but TPU-first: 'TPU' now means a current-
#: generation v5e-8 slice (the BASELINE.json north-star target), and every
#: TPU generation gets entries.  The GPU presets stay for migration parsing.
COMMON_MACHINE_CONFIGS: Dict[str, MachineConfig] = {
    "CPU": MachineConfig(cpu_cores=4, memory=15),
    "CPU_LARGE": MachineConfig(cpu_cores=32, memory=120),
    # TPU presets — the native path.
    "TPU": _tpu_config("v5litepod-8"),
    "TPU_V2": _tpu_config("v2-8"),
    "TPU_V3": _tpu_config("v3-8"),
    "TPU_V4_8": _tpu_config("v4-8"),
    "TPU_V4_32": _tpu_config("v4-32"),
    "TPU_V5E_1": _tpu_config("v5litepod-1"),
    "TPU_V5E_4": _tpu_config("v5litepod-4"),
    "TPU_V5E_8": _tpu_config("v5litepod-8"),
    "TPU_V5E_16": _tpu_config("v5litepod-16"),
    "TPU_V5E_32": _tpu_config("v5litepod-32"),
    "TPU_V5E_64": _tpu_config("v5litepod-64"),
    "TPU_V5E_128": _tpu_config("v5litepod-128"),
    "TPU_V5E_256": _tpu_config("v5litepod-256"),
    "TPU_V5P_8": _tpu_config("v5p-8"),
    "TPU_V6E_8": _tpu_config("v6e-8"),
    "TPU_V6E_32": _tpu_config("v6e-32"),
    "TPU_V6E_256": _tpu_config("v6e-256"),
    # Migration aliases (reference catalog names; deploy rejects with hint).
    "K80_1X": MachineConfig(8, 30, AcceleratorType.NVIDIA_TESLA_K80, 1),
    "K80_4X": MachineConfig(16, 60, AcceleratorType.NVIDIA_TESLA_K80, 4),
    "K80_8X": MachineConfig(32, 120, AcceleratorType.NVIDIA_TESLA_K80, 8),
    "P100_1X": MachineConfig(8, 30, AcceleratorType.NVIDIA_TESLA_P100, 1),
    "P100_4X": MachineConfig(16, 60, AcceleratorType.NVIDIA_TESLA_P100, 4),
    "P4_1X": MachineConfig(8, 30, AcceleratorType.NVIDIA_TESLA_P4, 1),
    "P4_4X": MachineConfig(16, 60, AcceleratorType.NVIDIA_TESLA_P4, 4),
    "V100_1X": MachineConfig(8, 30, AcceleratorType.NVIDIA_TESLA_V100, 1),
    "V100_4X": MachineConfig(16, 60, AcceleratorType.NVIDIA_TESLA_V100, 4),
    "T4_1X": MachineConfig(8, 30, AcceleratorType.NVIDIA_TESLA_T4, 1),
    "T4_4X": MachineConfig(16, 60, AcceleratorType.NVIDIA_TESLA_T4, 4),
}
