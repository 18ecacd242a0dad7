"""GCP substrate: project/region discovery, TPU placement tables, validation.

The port's copy of ``cloud_tpu/core/gcp.py`` (framework-free).

Reference analogue: ``src/python/tensorflow_cloud/core/gcp.py`` (project from
ADC :25-32, hardcoded region :73-75, accelerator-name map :78-90, machine-type
map :93-116, valid-config whitelist :123-406, job-label validator :409-481).

TPU-native differences:

* Region/zone selection is TPU-generation-aware (each generation is only
  offered in certain zones) instead of a single hardcoded ``us-central1``.
* The machine-type table maps *TPU generations* to TPU-VM machine types
  (``ct5lp-hightpu-4t`` ...); CPU-only roles keep an ``n1-*``-style table.
* Configuration validity is the slice catalog in ``machine_config.py``
  (legal topologies per generation) rather than a flat 200-row whitelist.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

from . import machine_config

AcceleratorType = machine_config.AcceleratorType


def get_project_name() -> str:
    """Project id from env, falling back to Application Default Credentials.

    Reference: gcp.py:25-32 (ADC only).  Env first keeps offline/test paths
    hermetic.
    """
    for var in ("GOOGLE_CLOUD_PROJECT", "CLOUD_TPU_PROJECT", "PROJECT_ID"):
        if os.environ.get(var):
            return os.environ[var]
    try:
        import google.auth  # deferred: not needed in offline paths

        _, project = google.auth.default()
    except Exception:
        project = None
    if not project:
        raise RuntimeError(
            "Could not determine the GCP project id. Set GOOGLE_CLOUD_PROJECT "
            "or configure application default credentials "
            "(gcloud auth application-default login)."
        )
    return project


#: Zones offering each TPU generation (first entry = default).  The TPU-aware
#: replacement for the reference's hardcoded region (gcp.py:73-75).
TPU_ZONES: Dict[AcceleratorType, List[str]] = {
    AcceleratorType.TPU_V2: ["us-central1-b", "europe-west4-a"],
    AcceleratorType.TPU_V3: ["us-central1-a", "europe-west4-a"],
    AcceleratorType.TPU_V4: ["us-central2-b"],
    AcceleratorType.TPU_V5E: ["us-west4-a", "us-east1-c", "europe-west4-b"],
    AcceleratorType.TPU_V5P: ["us-east5-a", "us-central1-a"],
    AcceleratorType.TPU_V6E: ["us-east5-b", "europe-west4-a", "asia-northeast1-b"],
}

_DEFAULT_ZONE = "us-central1-b"


def get_zone(config: Optional[machine_config.MachineConfig] = None) -> str:
    """Zone from env CLOUD_TPU_ZONE, else the default zone for the generation."""
    if os.environ.get("CLOUD_TPU_ZONE"):
        return os.environ["CLOUD_TPU_ZONE"]
    if config is not None and config.is_tpu():
        return TPU_ZONES[config.accelerator_type][0]
    return _DEFAULT_ZONE


def get_region(config: Optional[machine_config.MachineConfig] = None) -> str:
    """Region = zone minus the trailing letter. Reference: gcp.py:73-75."""
    zone = get_zone(config)
    return zone.rsplit("-", 1)[0]


#: TPU generation -> Cloud TPU VM machine-type family.  The per-host chip
#: count (the ``-Nt`` suffix) varies with the slice shape for v5e/v6e
#: (single-host slices pack 1/4/8 chips on one host), so the full machine
#: type is derived in :func:`get_machine_type` from the slice topology.
TPU_VM_MACHINE_FAMILIES: Dict[AcceleratorType, str] = {
    AcceleratorType.TPU_V4: "ct4p-hightpu",
    AcceleratorType.TPU_V5E: "ct5lp-hightpu",
    AcceleratorType.TPU_V5P: "ct5p-hightpu",
    AcceleratorType.TPU_V6E: "ct6e-standard",
}

#: TPU generation -> default TPU-VM runtime (software) version.  The
#: TPU-native analogue of the reference's ``tpuTfVersion: "2.1"`` pin
#: (deploy.py:152-153) and its supported-versions gate (gcp.py:119-120).
TPU_RUNTIME_VERSIONS: Dict[AcceleratorType, str] = {
    AcceleratorType.TPU_V2: "tpu-ubuntu2204-base",
    AcceleratorType.TPU_V3: "tpu-ubuntu2204-base",
    AcceleratorType.TPU_V4: "tpu-ubuntu2204-base",
    AcceleratorType.TPU_V5E: "v2-alpha-tpuv5-lite",
    AcceleratorType.TPU_V5P: "v2-alpha-tpuv5",
    AcceleratorType.TPU_V6E: "v2-alpha-tpuv6e",
}

#: (cpu_cores, memory_gb) -> machine type for CPU-only roles.
#: Reference parity: gcp.py:93-116.
CPU_MACHINE_TYPES: Dict[tuple, str] = {
    (4, 15): "n1-standard-4",
    (8, 30): "n1-standard-8",
    (16, 60): "n1-standard-16",
    (32, 120): "n1-standard-32",
    (64, 240): "n1-standard-64",
    (96, 360): "n1-standard-96",
    (2, 13): "n1-highmem-2",
    (4, 26): "n1-highmem-4",
    (8, 52): "n1-highmem-8",
    (16, 104): "n1-highmem-16",
    (32, 208): "n1-highmem-32",
    (64, 416): "n1-highmem-64",
    (96, 624): "n1-highmem-96",
}


def get_machine_type(config: machine_config.MachineConfig) -> str:
    """Machine type string for a role. Reference: gcp.py:93-116."""
    if config.is_tpu():
        topo = config.tpu_topology()
        if config.accelerator_type in (
            AcceleratorType.TPU_V2,
            AcceleratorType.TPU_V3,
        ):
            return "n1-standard-96"  # v2/v3 TPU-VM hosts
        family = TPU_VM_MACHINE_FAMILIES[config.accelerator_type]
        return f"{family}-{topo.chips_per_host}t"
    key = (config.cpu_cores, config.memory)
    if key not in CPU_MACHINE_TYPES:
        legal = sorted(CPU_MACHINE_TYPES)
        raise ValueError(
            f"Invalid (cpu_cores, memory) = {key}. Legal combinations: {legal}"
        )
    return CPU_MACHINE_TYPES[key]


def get_accelerator_type(config: machine_config.MachineConfig) -> str:
    """Cloud TPU API accelerator-type string (e.g. 'v5litepod-8').

    Reference: gcp.py:78-90 mapped enum -> CAIP accelerator names; here the
    slice catalog already carries the API name.
    """
    if config.accelerator_type is AcceleratorType.NO_ACCELERATOR:
        return "ACCELERATOR_TYPE_UNSPECIFIED"
    if config.is_gpu():
        raise ValueError(machine_config.gpu_migration_hint(config))
    return config.tpu_topology().accelerator_type


def validate_machine_configuration(
    cpu_cores: Optional[int],
    memory: Optional[int],
    accelerator_type: AcceleratorType,
    accelerator_count: int,
    topology: Optional[str] = None,
) -> None:
    """Raise ValueError unless the combination is launchable.

    Reference: gcp.py:35-70 checked against the flat whitelist; here TPU
    validity is the slice catalog and CPU validity is the machine-type table.
    """
    config = machine_config.MachineConfig(
        cpu_cores=cpu_cores,
        memory=memory,
        accelerator_type=accelerator_type,
        accelerator_count=accelerator_count,
        topology=topology,
    )
    if config.is_gpu():
        raise ValueError(machine_config.gpu_migration_hint(config))
    if not config.is_tpu():
        get_machine_type(config)  # raises on bad (cpu, memory)


_LABEL_KEY_RE = re.compile(r"^[a-z][a-z0-9_-]{0,62}$")
_LABEL_VALUE_RE = re.compile(r"^[a-z0-9_-]{0,63}$")
_MAX_LABELS = 64
_RESERVED_LABEL_PREFIXES = ("goog",)


def validate_job_labels(labels: Optional[Dict[str, str]]) -> None:
    """GCP resource-label rules. Reference parity: gcp.py:409-481.

    <=64 labels; keys start with a lowercase letter, <=63 chars of
    [a-z0-9_-]; values <=63 chars of [a-z0-9_-]; 'goog'-prefixed keys are
    reserved.
    """
    if not labels:
        return
    if len(labels) > _MAX_LABELS:
        raise ValueError(
            f"Too many job labels: {len(labels)} > {_MAX_LABELS} allowed."
        )
    for key, value in labels.items():
        if any(key.startswith(p) for p in _RESERVED_LABEL_PREFIXES):
            raise ValueError(
                f"Invalid job label key {key!r}: the 'goog' prefix is reserved."
            )
        if not _LABEL_KEY_RE.fullmatch(key):
            raise ValueError(
                f"Invalid job label key {key!r}: must start with a lowercase "
                "letter and contain <=63 chars of [a-z0-9_-]."
            )
        if not _LABEL_VALUE_RE.fullmatch(value):
            raise ValueError(
                f"Invalid value {value!r} for job label {key!r}: must contain "
                "<=63 chars of [a-z0-9_-]."
            )
