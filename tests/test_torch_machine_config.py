"""The port's machine configs and GCP tables (``cloud_tpu_torch.core.
machine_config``, ``core.gcp``) against the JAX package's, on the CPU.

The port keeps the reference's catalog and presets value for value (its
requests are held equal to JAX's), so every catalog entry, preset, error
and ``gpu_migration_hint`` text is compared as data: each case runs on
both packages and the outcomes (a value, or the exception's type and
message) must be equal.
"""

import pytest
import torch

import cloud_tpu
import cloud_tpu_torch
from helpers.torch_launcher import JAX, PORT, as_data, error_of, mc

torch.set_num_threads(1)


def test_root_exports_the_reference_surface():
    for name in ("AcceleratorType", "COMMON_MACHINE_CONFIGS", "MachineConfig",
                 "TpuTopology", "TPU_SLICE_CATALOG", "is_tpu_config"):
        assert name in cloud_tpu_torch.__all__
        assert (as_data(getattr(cloud_tpu_torch, name, None)) is not None)
    for name in ("run", "remote", "RunReport"):
        assert callable(getattr(cloud_tpu_torch, name))
    from cloud_tpu_torch import tuner

    for name, want in (("CloudTuner", tuner.CloudTuner),
                       ("CloudOracle", tuner.CloudOracle)):
        assert hasattr(cloud_tpu, name)
        assert getattr(cloud_tpu_torch, name) is want
    # The function, or once imported the package, which calls it.
    assert hasattr(cloud_tpu, "cloud_fit")
    assert callable(cloud_tpu_torch.cloud_fit)
    from cloud_tpu_torch.cloud_fit import client

    assert callable(cloud_tpu_torch.cloud_fit)
    with pytest.raises(ValueError, match="TrainerSpec"):
        cloud_tpu_torch.cloud_fit(object(), "unused", train_data={})
    assert client.cloud_fit.__module__ == "cloud_tpu_torch.cloud_fit.client"
    with pytest.raises(AttributeError):
        cloud_tpu_torch.no_such_name  # noqa: B018


def test_every_catalog_entry_and_preset_equals_the_reference():
    for attr in ("TPU_SLICE_CATALOG", "COMMON_MACHINE_CONFIGS",
                 "TPU_ACCELERATORS", "GPU_ACCELERATORS"):
        assert (as_data(getattr(PORT.machine_config, attr))
                == as_data(getattr(JAX.machine_config, attr))), attr
    assert ([as_data(a) for a in PORT.machine_config.AcceleratorType]
            == [as_data(a) for a in JAX.machine_config.AcceleratorType])
    for name in JAX.machine_config.COMMON_MACHINE_CONFIGS:
        j, p = mc(JAX, name), mc(PORT, name)
        for method in ("is_tpu", "is_gpu"):
            assert getattr(p, method)() == getattr(j, method)(), (name,
                                                                   method)
        assert (PORT.machine_config.is_tpu_config(p)
                == JAX.machine_config.is_tpu_config(j))
        if j.is_tpu():
            assert as_data(p.tpu_topology()) == as_data(j.tpu_topology())
            assert p.tpu_topology().chips_per_host == (
                j.tpu_topology().chips_per_host)
            assert p.tpu_topology().cores == j.tpu_topology().cores
        if j.is_gpu():
            assert (PORT.machine_config.gpu_migration_hint(p)
                    == JAX.machine_config.gpu_migration_hint(j))


def _config_cases(side):
    m = side.machine_config
    A = m.AcceleratorType
    return [
        lambda: as_data(m.find_topology(A.TPU_V4, 16)),
        lambda: as_data(m.find_topology(A.TPU_V5E, 8, "2x4")),
        lambda: m.find_topology(A.TPU_V5E, 3),
        lambda: m.find_topology(A.TPU_V4, 8, "4x4x4"),
        lambda: m.MachineConfig(accelerator_type=A.TPU_V5E,
                                accelerator_count=3),
        lambda: m.MachineConfig(cpu_cores=4, memory=15, accelerator_count=2),
        lambda: m.MachineConfig(accelerator_type="TPU_V5E",
                                accelerator_count=8),
        lambda: m.MachineConfig(accelerator_type=A.NVIDIA_TESLA_T4,
                                accelerator_count=0),
        lambda: m.MachineConfig().tpu_topology(),
        lambda: m.is_tpu_config(None),
        lambda: [m.gpu_migration_hint(m.MachineConfig(
            8, 30, A.NVIDIA_TESLA_V100, n)) for n in (1, 3, 4, 8)],
    ]


@pytest.mark.parametrize("case", range(len(_config_cases(JAX))))
def test_config_errors_and_hints_equal_the_reference(case):
    assert (error_of(_config_cases(PORT)[case])
            == error_of(_config_cases(JAX)[case]))


def _gcp_cases(side):
    g, m = side.gcp, side.machine_config
    A = m.AcceleratorType
    return [
        lambda: [g.get_zone(c) for c in m.COMMON_MACHINE_CONFIGS.values()],
        lambda: [g.get_region(c) for c in m.COMMON_MACHINE_CONFIGS.values()],
        lambda: {n: error_of(lambda c=c: g.get_machine_type(c))
                 for n, c in m.COMMON_MACHINE_CONFIGS.items()},
        lambda: {n: error_of(lambda c=c: g.get_accelerator_type(c))
                 for n, c in m.COMMON_MACHINE_CONFIGS.items()},
        lambda: g.get_machine_type(m.MachineConfig(cpu_cores=3, memory=7)),
        lambda: g.validate_machine_configuration(8, 30, A.NVIDIA_TESLA_T4, 1),
        lambda: g.validate_machine_configuration(None, None, A.TPU_V6E, 8),
        lambda: g.validate_machine_configuration(4, 15, A.NO_ACCELERATOR, 0),
        lambda: g.validate_job_labels({"team": "ml", "env": "dev-1"}),
        lambda: g.validate_job_labels({f"k{i}": "v" for i in range(65)}),
        lambda: [error_of(lambda k=k: g.validate_job_labels({k: "v"}))
                 for k in ("Upper", "1abc", "goog-x", "a" * 64, "ok_key")],
        lambda: [error_of(lambda v=v: g.validate_job_labels({"k": v}))
                 for v in ("UPPER", "a" * 64, "ok-1", "")],
        lambda: (as_data(g.TPU_ZONES), as_data(g.TPU_RUNTIME_VERSIONS),
                 as_data(g.TPU_VM_MACHINE_FAMILIES),
                 {str(k): v for k, v in g.CPU_MACHINE_TYPES.items()}),
    ]


@pytest.mark.parametrize("case", range(len(_gcp_cases(JAX))))
def test_gcp_tables_and_checks_equal_the_reference(case, monkeypatch):
    monkeypatch.delenv("CLOUD_TPU_ZONE", raising=False)
    assert error_of(_gcp_cases(PORT)[case]) == error_of(_gcp_cases(JAX)[case])


def test_project_and_zone_from_env(monkeypatch):
    monkeypatch.setenv("GOOGLE_CLOUD_PROJECT", "proj-x")
    monkeypatch.setenv("CLOUD_TPU_ZONE", "europe-west4-b")
    for side in (JAX, PORT):
        assert side.gcp.get_project_name() == "proj-x"
        assert side.gcp.get_zone(mc(side, "TPU")) == "europe-west4-b"
        assert side.gcp.get_region() == "europe-west4"
