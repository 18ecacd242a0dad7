"""The port's copy of ``examples/call_run_on_script.py``: launch the
golden MNIST workload (``torch_mnist_example.py``) onto a TPU slice
through the port's ``run()``."""

import os

import cloud_tpu_torch
from cloud_tpu_torch.core.containerize import DockerConfig

HELPERS = os.path.dirname(os.path.abspath(__file__))


def main(dry_run: bool = False):
    return cloud_tpu_torch.run(
        entry_point=os.path.join(HELPERS, "torch_mnist_example.py"),
        chief_config=cloud_tpu_torch.COMMON_MACHINE_CONFIGS["TPU"],
        # Explicit image URI; omit to default to gcr.io/<project>/... via ADC.
        docker_config=DockerConfig(image="gcr.io/my-project/mnist:demo"),
        dry_run=dry_run,
    )


if __name__ == "__main__":
    main()
