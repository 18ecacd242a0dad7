"""The port's copy of ``examples/call_run_with_custom_image.py``: a custom
parent image, the user's extra requirements and job labels."""

import os

import cloud_tpu_torch
from cloud_tpu_torch.core.containerize import DockerConfig

HELPERS = os.path.dirname(os.path.abspath(__file__))


def main(dry_run: bool = False):
    return cloud_tpu_torch.run(
        entry_point=os.path.join(HELPERS, "torch_mnist_example.py"),
        requirements_txt=os.path.join(HELPERS, "torch_requirements.txt"),
        chief_config=cloud_tpu_torch.COMMON_MACHINE_CONFIGS["TPU"],
        docker_config=DockerConfig(
            image="gcr.io/my-project/mnist:custom-base",
            parent_image="python:3.12-slim",
        ),
        job_labels={"team": "research", "phase": "dev"},
        dry_run=dry_run,
    )


if __name__ == "__main__":
    main()
