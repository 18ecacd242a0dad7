"""ResNet-50 CIFAR through ``Trainer.fit`` under the bootstrap's mesh: a
container workload for ``cloud_tpu_torch.run()`` (``chip_smoke.py``'s
phase 9r submits it).

The script trains ResNet-50 CIFAR (bf16, GroupNorm K1-K4 on the card)
with SGD momentum on a shuffled synthetic ``ArrayDataset`` (numpy seed 0,
labels drawn first, then the images), under whatever mesh the bootstrap
installed, for :data:`STEPS` steps of :data:`BATCH` rows, and prints one
JSON line: the device, the GroupNorm launches of the run
(``ops.dispatch``), the steps, the per-step losses, the parameters'
relative change (the L2 norm of the update over the initial norm), fit's
steps/s and ``run/submit_to_first_step_seconds`` (published by the first
step when ``run()`` forwarded ``CLOUD_TPU_SUBMIT_TS``).
"""

import functools
import json

import numpy as np
import torch

from cloud_tpu_torch import bridge, parallel
from cloud_tpu_torch.models import resnet
from cloud_tpu_torch.monitoring import metrics, tracing
from cloud_tpu_torch.ops import dispatch
from cloud_tpu_torch.training import data, optimizers, trainer

GN_KERNELS = ("gn_fwd", "gn_fwd_res", "gn_bwd", "gn_bwd_res")
STEPS = 6
BATCH = 256
#: Small enough that the loss on this noise stays near its start (SGD 0.1
#: with momentum 0.9 climbs to a hundred times it within 6 steps).
LEARNING_RATE = 1e-3


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree.detach()]


def _norm(leaves):
    return float(torch.sqrt(sum(torch.sum(x.double() ** 2) for x in leaves)))


def cifar_arrays(n, num_classes, seed=0):
    """The synthetic CIFAR arrays: labels drawn first, then the images."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, n)
    images = rng.normal(size=(n, 32, 32, 3)).astype(np.float32)
    return {"image": images, "label": labels}


def main(config=resnet.RESNET50_CIFAR, steps=STEPS, batch=BATCH):
    mesh = parallel.get_global_mesh()
    ds = data.ArrayDataset(cifar_arrays(steps * batch, config.num_classes),
                           batch, shuffle=True, seed=0)
    losses = []
    t = trainer.Trainer(
        functools.partial(resnet.loss_fn, config=config),
        optimizers.sgd(LEARNING_RATE, momentum=0.9),
        init_fn=lambda gen: bridge.init_resnet(config, gen,
                                               device=gen.device),
        mesh=mesh,
        logical_axes=resnet.param_logical_axes(config),
    )
    t.init_state(torch.Generator(device=t.device).manual_seed(0))
    before = [p.clone() for p in _leaves(t.state.params)]
    dispatch.reset_launch_counts()
    history = t.fit(ds, epochs=1, callbacks=[trainer.LambdaCallback(
        on_step_end=lambda step, logs, _: losses.append(logs["loss"]))])
    after = _leaves(t.state.params)
    epoch_seconds = history.history["epoch_seconds"][-1]
    out = {
        "device": (torch.cuda.get_device_name(t.device)
                   if t.device.type == "cuda" else "cpu"),
        "mesh": None if mesh is None else mesh.shape,
        "steps": int(t.state.step),
        "launches": dispatch.launch_counts(GN_KERNELS),
        "losses": [float(v) for v in losses],
        "param_change": _norm([a - b for a, b in zip(after, before)])
        / _norm(before),
        "steps_per_s": int(t.state.step) / epoch_seconds,
        "submit_to_first_step_seconds": metrics.snapshot()["gauges"].get(
            tracing.SUBMIT_TO_FIRST_STEP_GAUGE),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
