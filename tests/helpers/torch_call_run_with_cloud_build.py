"""The port's copy of ``examples/call_run_with_cloud_build.py``: the image
is built by Cloud Build from a context uploaded to a bucket."""

import os

import cloud_tpu_torch
from cloud_tpu_torch.core.containerize import DockerConfig

HELPERS = os.path.dirname(os.path.abspath(__file__))


def main(dry_run: bool = False):
    return cloud_tpu_torch.run(
        entry_point=os.path.join(HELPERS, "torch_mnist_example.py"),
        chief_config=cloud_tpu_torch.COMMON_MACHINE_CONFIGS["TPU"],
        docker_config=DockerConfig(
            image="gcr.io/my-project/mnist:cloudbuild",
            image_build_bucket="my-build-bucket",
        ),
        dry_run=dry_run,
    )


if __name__ == "__main__":
    main()
