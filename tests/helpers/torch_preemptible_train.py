"""The port's copy of ``tests/testdata/preemptible_train.py``: the
preemption-recovery workload of the restart-resume fleet test.

Trains dense MNIST under a ``dp`` mesh over every rank with
``CheckpointCallback(every_n_steps=5)``.  With
``CLOUD_TPU_TEST_KILL_AT=<step>`` set, every rank hard-exits
(``os._exit(42)``) at that global step after committing the pending
checkpoint writes: a whole-slice preemption.  Re-running the same command
with the variable unset is what a recreated node does: the callback must
resume from the last saved step and training continues, not restarts.
Each rank prints one JSON report line.  ``CLOUD_TPU_SELFCHECK_FORCE_CPU``
(set by ``utils.local_rig`` for ``device="cpu"``) runs the ranks on the
CPU over gloo; otherwise on the card.
"""

import functools
import json
import os
import sys

import numpy as np
import torch

from cloud_tpu_torch import bridge, parallel
from cloud_tpu_torch.models import mnist
from cloud_tpu_torch.parallel import distributed
from cloud_tpu_torch.training import checkpoint as ckpt_lib
from cloud_tpu_torch.training import data, optimizers
from cloud_tpu_torch.training import trainer as trainer_lib


class KillSwitch(trainer_lib.Callback):
    """Simulated preemption: commit checkpoint writes, then die hard."""

    def __init__(self, kill_at, ckpt_cb, report):
        self.kill_at = kill_at
        self.ckpt_cb = ckpt_cb
        self.report = report

    def on_step_end(self, step, logs, trainer):
        if self.kill_at is None or step != self.kill_at:
            return
        # The step-10 save is asynchronous; this test asserts a resume
        # from step 10, so the write must be committed before the kill.
        self.ckpt_cb._get(trainer).wait()
        self.report["killed_at"] = step
        print(json.dumps(self.report), flush=True)
        os._exit(42)


class Recorder(trainer_lib.Callback):
    """The step training starts from (after the checkpoint callback's
    restore) and the per-step loss trail."""

    def __init__(self, report):
        self.report = report

    def on_train_begin(self, trainer):
        self.report["start_step"] = int(trainer.state.step)

    def on_step_end(self, step, logs, trainer):
        self.report.setdefault("losses", []).append(
            round(float(logs["loss"]), 5))
        self.report["final_step"] = step


def main() -> int:
    cpu = bool(os.environ.get("CLOUD_TPU_SELFCHECK_FORCE_CPU"))
    device = torch.device("cpu") if cpu else None
    distributed.initialize_from_env(
        timeout_seconds=int(os.environ.get("CLOUD_TPU_SELFCHECK_TIMEOUT",
                                           "60")),
        device=device, backend="gloo")
    world = distributed.process_count()
    mesh = parallel.MeshSpec({"dp": world}).build(
        devices=[device] * world if cpu else None, backend="gloo")
    cfg = mnist.MnistConfig(hidden_dim=16)
    report = {"process_index": distributed.process_index(),
              "process_count": world}

    trainer = trainer_lib.Trainer(
        functools.partial(mnist.loss_fn, config=cfg),
        optimizers.sgd(0.1),
        lambda gen: bridge.init_mnist(cfg, gen, device=gen.device),
        mesh=mesh,
        logical_axes=mnist.param_logical_axes(cfg),
    )
    trainer.init_state(torch.Generator(device=trainer.device).manual_seed(0))

    ckpt_cb = ckpt_lib.CheckpointCallback(
        os.environ["CLOUD_TPU_TEST_CKPT_DIR"], every_n_steps=5,
        device=trainer.device)
    kill_at = os.environ.get("CLOUD_TPU_TEST_KILL_AT")
    recorder = Recorder(report)
    kill = KillSwitch(int(kill_at) if kill_at else None, ckpt_cb, report)

    # This process's rows, identical in every run, so the loss trail is
    # comparable across the kill/restart boundary.
    rng = np.random.default_rng(distributed.process_index())
    rows = 8
    train_ds = data.ArrayDataset(
        {"image": rng.normal(size=(rows * 20, 784)).astype(np.float32),
         "label": rng.integers(0, 10, rows * 20)}, rows)
    trainer.fit(train_ds, epochs=1, steps_per_epoch=20,
                callbacks=[ckpt_cb, recorder, kill])
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
