"""The restart-resume scenario on the port (the counterpart of the JAX
package's ``tests/unit/test_multiprocess.py`` ``TestRestartResumeFleet``):
a 2-process dp fleet on the CPU over gloo
(``tests/helpers/torch_preemptible_train.py`` through
``utils.local_rig.launch_process_fleet``) saves every 5 steps, is killed
at step 12 (exit 42) on both ranks, and the same command relaunched
resumes from the step-10 checkpoint, ends at step 30, and its first loss
is below run 1's first loss.
"""

import json
import os
import pathlib

import torch

from cloud_tpu_torch.training import checkpoint
from cloud_tpu_torch.utils import local_rig

torch.set_num_threads(1)

SCRIPT = str(pathlib.Path(__file__).resolve().parent / "helpers"
             / "torch_preemptible_train.py")


def _report(result):
    for line in reversed(result.stdout.splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"no JSON report; rc={result.returncode}\n"
                         f"stderr={result.stderr[-3000:]}")


def _fleet(ckpt, **env):
    return local_rig.launch_process_fleet(
        2, device="cpu", module=SCRIPT, timeout=240,
        extra_env={"CLOUD_TPU_TEST_CKPT_DIR": ckpt, **env})


def test_killed_fleet_resumes_from_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = []
    for rank, res in enumerate(_fleet(ckpt, CLOUD_TPU_TEST_KILL_AT="12")):
        assert res.returncode == 42, (rank, res.returncode,
                                      res.stderr[-3000:])
        rep = _report(res)
        assert rep["killed_at"] == 12 and rep["process_count"] == 2
        first.append(rep)
    manager = checkpoint.CheckpointManager(ckpt, device="cpu")
    assert manager.steps() == [5, 10]
    assert manager.verify(10) == "verified"
    for rank, res in enumerate(_fleet(ckpt)):
        assert res.returncode == 0, (rank, res.stderr[-3000:])
        rep = _report(res)
        assert rep["start_step"] == 10, rep
        assert rep["final_step"] == 30
        assert rep["losses"][0] < first[rank]["losses"][0], (
            rep["losses"][0], first[rank]["losses"][0])
    assert manager.latest_step() == 30
    assert not [n for n in os.listdir(ckpt)
                if n.startswith(checkpoint.TMP_PREFIX)]
