"""``chip_smoke.py``'s phases 9t and 9f rehearsed on the CPU: their whole
Python path, the launch checks aside (on the CPU no kernel launches).

* 9t: ``tuner.dispatch_search`` of two workers of
  ``tests/helpers/torch_tuner_resnet_example.py`` (a dry run), each job's
  build context and startup script booted by
  ``utils.local_rig.launch_emulated_slice`` on gloo CPU ranks, at a narrow
  ResNet in f32 with 8 rows a batch: one study of 4 trials, all
  COMPLETED with 2 measurements and finite losses.
* 9f: ``cloud_tpu_torch.cloud_fit`` (a dry run) for two one-chip hosts,
  its ENTRYPOINT as generated (``run()``'s plan ``{dp: 2}``) on two
  emulated hosts, a checkpoint written by rank 0 alone; two ranks under
  the bootstrap's own ``{fsdp: 2}`` restore it into their shards and save
  a sharded checkpoint holding both ranks' files; a one-process
  ``remote.run`` restores that.  Each restore equals the parameters saved
  bit for bit.
"""

import torch

import chip_smoke
from helpers import torch_tuner_resnet_example as worker

torch.set_num_threads(1)

CPU = torch.device("cpu")


def test_tuner_phase_on_the_cpu():
    out = chip_smoke.run_tuner_phase(CPU, "cpu", batch=8, rig="cpu",
                                     worker_args=("--config", "tiny"))
    assert len(out["trials"]) == 4
    assert sum(out["trials_per_worker"].values()) == 4
    assert out["steps"] == 4 * 2 * 3


def test_cloud_fit_phase_on_the_cpu():
    out = chip_smoke.run_cloud_fit_phase(CPU, "cpu", config=worker.TINY,
                                         batch=8, rig="cpu")
    assert out["plan"] == {"dp": 2}
    assert [r["mesh"] for r in out["dp_ranks"]] == [{"dp": 2}] * 2
    assert [r["mesh"] for r in out["fsdp_ranks"]] == [{"fsdp": 2}] * 2
    assert out["dp_files_by_rank"][1] == 0
    assert all(out["fsdp_files_by_rank"].values())
