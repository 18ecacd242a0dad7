"""A tuner worker over ResNet-50 CIFAR (bf16, GroupNorm K1-K4 on the card):
the container workload ``chip_smoke.py``'s phase 9t dispatches with
``tuner.dispatch_search``.

The worker builds a ``CloudTuner`` over a local study in the
shared ``--study-dir`` (``--study-id`` and ``--tuner-id`` are appended by
``dispatch_search``), searching ``learning_rate`` (log-uniform in
1e-4..1e-1) and ``momentum`` (0.0 or 0.9) for ``--max-trials`` trials
between all workers (with ``--meet-dir`` and ``--workers`` the workers
meet once each holds its first trial, so each runs at least one).  Each
trial is the port's ``Trainer`` (under the
bootstrap's mesh) for ``--epochs`` epochs of ``--steps`` steps of
``--batch`` rows of the synthetic CIFAR arrays of
``torch_resnet_cifar_fit.py``, every trial for all its epochs (the
study's median rule stops none).  It prints one JSON line: the devices
its trials' Trainers ran on, the worker's trials (hyperparameters,
per-epoch losses, steps, wall time, peak memory, device), its steps,
its GroupNorm launches (``ops.dispatch``), its wall time and
``run/submit_to_first_step_seconds``.  ``--config tiny`` trains a narrow
ResNet in f32 (the CPU rehearsal, ``--device cpu``).
"""

import argparse
import functools
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_resnet_cifar_fit import GN_KERNELS, cifar_arrays  # noqa: E402
from torch_tuner_fakes import barrier_hypermodel  # noqa: E402

from cloud_tpu_torch import bridge, parallel  # noqa: E402
from cloud_tpu_torch import tuner as tuner_lib  # noqa: E402
from cloud_tpu_torch.models import resnet  # noqa: E402
from cloud_tpu_torch.monitoring import metrics, tracing  # noqa: E402
from cloud_tpu_torch.ops import dispatch  # noqa: E402
from cloud_tpu_torch.training import data, optimizers, trainer  # noqa: E402

TINY = resnet.ResNetConfig(stage_sizes=(1, 1, 1, 1), width=16,
                           num_classes=10, num_groups=8, dtype=torch.float32)


def hyperparameters():
    hp = tuner_lib.HyperParameters()
    hp.Float("learning_rate", 1e-4, 1e-1, sampling="log")
    hp.Choice("momentum", [0.0, 0.9])
    return hp


class FullTrials(tuner_lib.LocalStudyService):
    """A local study whose median rule never stops a trial early: every
    trial runs all its epochs (with the rule a diverging trial stops
    after one, so the trials' steps would depend on the draws)."""

    def should_stop(self, trial_id):
        return False


class TrialRecorder(trainer.Callback):
    """Each trial's per-epoch losses, steps, wall time and peak memory."""

    def __init__(self):
        self.trials = []

    def on_train_begin(self, t):
        if t.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(t.device)
        self.trials.append({"losses": [], "start": time.perf_counter(),
                            "hyperparameters": dict(t.hp_values),
                            "device": (torch.cuda.get_device_name(t.device)
                                       if t.device.type == "cuda"
                                       else "cpu")})

    def on_epoch_end(self, epoch, logs, t):
        self.trials[-1]["losses"].append(float(logs["loss"]))

    def on_train_end(self, t):
        trial = self.trials[-1]
        trial["wall_s"] = time.perf_counter() - trial.pop("start")
        trial["steps"] = int(t.state.step)
        trial["max_memory_allocated"] = (
            torch.cuda.max_memory_allocated(t.device)
            if t.device.type == "cuda" else None)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--study-id", required=True)
    parser.add_argument("--tuner-id", required=True)
    parser.add_argument("--study-dir", required=True)
    parser.add_argument("--max-trials", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--config", default="resnet50", choices=["resnet50",
                                                                 "tiny"])
    parser.add_argument("--device", default=None, choices=["cuda", "cpu"])
    # Workers meet under --meet-dir once each holds its first trial, so a
    # worker that boots late still finds trials left in the study.
    parser.add_argument("--meet-dir", default=None)
    parser.add_argument("--workers", type=int, default=1)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    config = resnet.RESNET50_CIFAR if args.config == "resnet50" else TINY
    mesh = parallel.get_global_mesh()
    arrays = cifar_arrays(args.steps * args.batch, config.num_classes)

    def hypermodel(hp):
        device = None if mesh is not None else args.device
        t = trainer.Trainer(
            functools.partial(resnet.loss_fn, config=config, device=device),
            optimizers.sgd(hp.get("learning_rate"),
                           momentum=hp.get("momentum")),
            init_fn=lambda gen: bridge.init_resnet(config, gen,
                                                   device=gen.device),
            mesh=mesh, logical_axes=resnet.param_logical_axes(config),
            device=device)
        t.hp_values = hp.values
        t.init_state(torch.Generator(device=t.device).manual_seed(0))
        return t

    if args.meet_dir:
        hypermodel = barrier_hypermodel(args.meet_dir, args.tuner_id,
                                        args.workers, hypermodel)
    service = FullTrials(args.study_id, args.study_dir,
                         max_trials=args.max_trials, seed=0)
    tuner = tuner_lib.CloudTuner(
        hypermodel, service, objective="loss",
        hyperparameters=hyperparameters(), max_trials=args.max_trials,
        tuner_id=args.tuner_id)
    recorder = TrialRecorder()
    dispatch.reset_launch_counts()
    start = time.perf_counter()
    tuner.search(train_data=data.ArrayDataset(arrays, args.batch,
                                              shuffle=True, seed=0),
                 epochs=args.epochs, callbacks=[recorder])
    wall = time.perf_counter() - start
    out = {
        "devices": sorted({fit["device"] for fit in recorder.trials}),
        "tuner_id": args.tuner_id,
        "trials": [{"trial_id": t.trial_id, "status": t.status.value,
                    "score": t.score, "hyperparameters": t.hyperparameters
                    .values, "measurements": len(t.measurements)}
                   for t in tuner.oracle.trials.values()],
        "fits": recorder.trials,
        "steps": sum(t.get("steps", 0) for t in recorder.trials),
        "launches": dispatch.launch_counts(GN_KERNELS),
        "wall_s": wall,
        "submit_to_first_step_seconds": metrics.snapshot()["gauges"].get(
            tracing.SUBMIT_TO_FIRST_STEP_GAUGE),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
