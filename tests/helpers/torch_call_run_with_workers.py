"""The port's copy of ``examples/call_run_with_workers.py``: a chief slice
and one worker slice, dp spanning the slices over DCN and tp 4 inside
each."""

import os

import cloud_tpu_torch
from cloud_tpu_torch.core.containerize import DockerConfig
from cloud_tpu_torch.parallel import ParallelismHints

HELPERS = os.path.dirname(os.path.abspath(__file__))


def main(dry_run: bool = False):
    return cloud_tpu_torch.run(
        entry_point=os.path.join(HELPERS, "torch_mnist_example.py"),
        chief_config=cloud_tpu_torch.COMMON_MACHINE_CONFIGS["TPU_V5E_16"],
        worker_count=1,  # one extra slice; dp spans slices over DCN
        parallelism_hints=ParallelismHints(tp=4, prefer_fsdp=True),
        docker_config=DockerConfig(image="gcr.io/my-project/big-run:demo"),
        dry_run=dry_run,
    )


if __name__ == "__main__":
    main()
