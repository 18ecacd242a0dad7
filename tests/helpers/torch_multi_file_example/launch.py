"""The port's copy of ``examples/multi_file_example/launch.py``: ``run()``
ships the entry point's whole directory, so its sibling modules import
in the container."""

import os

import cloud_tpu_torch
from cloud_tpu_torch.core.containerize import DockerConfig


def main(dry_run: bool = False):
    return cloud_tpu_torch.run(
        entry_point=os.path.join(os.path.dirname(__file__), "train.py"),
        chief_config=cloud_tpu_torch.COMMON_MACHINE_CONFIGS["TPU"],
        docker_config=DockerConfig(image="gcr.io/my-project/multifile:demo"),
        dry_run=dry_run,
    )


if __name__ == "__main__":
    main()
