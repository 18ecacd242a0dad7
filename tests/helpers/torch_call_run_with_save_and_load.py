"""The port's copy of ``examples/call_run_with_save_and_load.py``: launch
the save-and-load workload (``torch_save_and_load.py``), which owns its
mesh, so the planner is opted out of."""

import os

import cloud_tpu_torch
from cloud_tpu_torch.core.containerize import DockerConfig

HELPERS = os.path.dirname(os.path.abspath(__file__))


def main(dry_run: bool = False):
    return cloud_tpu_torch.run(
        entry_point=os.path.join(HELPERS, "torch_save_and_load.py"),
        chief_config=cloud_tpu_torch.COMMON_MACHINE_CONFIGS["TPU"],
        # The workload owns its mesh (builds one itself): opt out of the
        # planner (the reference's distribution_strategy=None).
        distribution_strategy=None,
        docker_config=DockerConfig(image="gcr.io/my-project/ckpt:demo"),
        dry_run=dry_run,
    )


if __name__ == "__main__":
    main()
