"""The port's copy of ``examples/call_run_with_tuner_search.py``: launch a
hyperparameter-search workload onto TPU workers through the port's
``run()``.  The shipped script (``torch_tuner_mnist_example.py``) drives
``CloudTuner`` over the MNIST dense model; each submitted job is one
tuner worker, and N invocations with a shared study id give distributed
search (``tuner.dispatch_search`` submits them).
"""

import os

import cloud_tpu_torch
from cloud_tpu_torch.core.containerize import DockerConfig

HELPERS = os.path.dirname(os.path.abspath(__file__))


def main(dry_run: bool = False):
    return cloud_tpu_torch.run(
        entry_point=os.path.join(HELPERS, "torch_tuner_mnist_example.py"),
        chief_config=cloud_tpu_torch.COMMON_MACHINE_CONFIGS["TPU"],
        docker_config=DockerConfig(image="gcr.io/my-project/tuner:demo"),
        # Trials coordinate through the study service, not the mesh —
        # parallelism comes from submitting this job several times.
        job_labels={"workload": "hp-search"},
        dry_run=dry_run,
    )


if __name__ == "__main__":
    main()
