"""Dense MNIST classifier, the reference's golden minimal workload (port
of ``cloud_tpu/models/mnist.py``): flattened 28x28 images, a 512-unit
relu layer and a 10-way head.  It runs no kernel of the port; its params
come from ``bridge.init_mnist`` or, from JAX's, ``bridge.mnist_to_torch``.

Under a training mesh of more than one rank (``mesh=``, or the installed
global mesh) :func:`loss_fn` returns this rank's share of the global loss
(``train.mesh_loss``): the rows are split over ``dp`` and ``fsdp``, and
ranks that differ only in ``tp``, ``sp``, ``pp`` or ``ep`` compute the
same rows (``parallel.collectives.data_parallel_mesh``).  When the
hidden units are split over ``tp`` (:func:`param_logical_axes` puts
them on ``mlp``), the hidden layer is column-split behind one
differentiable copy and the head row-split with one sum, as GSPMD runs
the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import layers
from cloud_tpu_torch.parallel import collectives, tensor_parallel


@dataclasses.dataclass(frozen=True)
class MnistConfig:
    input_dim: int = 784
    hidden_dim: int = 512
    num_classes: int = 10


def apply(params, images, config: MnistConfig = MnistConfig(), *,
          device=None, tp=None):
    """images ``[B, ...]`` (flattened to ``[B, input_dim]``) -> logits
    ``[B, num_classes]``.  ``tp``: the params hold this rank's hidden
    units (a ``tensor_parallel.TrainContext``)."""
    device = resolve_device(device)
    x = torch.as_tensor(images, device=device)
    x = x.reshape(x.shape[0], -1)
    if tp is not None:
        x = tp.copy(x)
    x = torch.relu(layers.dense_apply(params["hidden"], x))
    return layers.row_parallel_dense(params["out"], x, tp)


def param_logical_axes(config: MnistConfig = MnistConfig()):
    """The JAX package's logical axes (``cloud_tpu/models/mnist.py``)."""
    return {
        "hidden": {"kernel": (None, "mlp"), "bias": ("mlp",)},
        "out": {"kernel": ("mlp", None), "bias": (None,)},
    }


def loss_fn(params, batch: Dict[str, Any],
            config: MnistConfig = MnistConfig(), *,
            device=None, mesh=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean softmax cross-entropy and accuracy over ``batch["image"]``,
    ``batch["label"]``; the metrics are detached from the graph.  Under a
    mesh of more than one rank ``batch`` is this rank's rows, the device
    the mesh's, and the loss this rank's share of the global loss."""
    mesh, device = collectives.data_parallel_mesh(mesh, device)
    tp = None
    if (mesh is not None and mesh.axis_size("tp") > 1
            and params["hidden"]["kernel"].shape[-1] < config.hidden_dim):
        tp = tensor_parallel.TrainContext(mesh=mesh)
    logits = apply(params, batch["image"], config, device=device, tp=tp)
    sp = mesh.axis_size("sp") if mesh is not None else 1
    return layers.classification_loss(logits, batch["label"], mesh,
                                      replicas=sp)


#: Under a mesh, :func:`loss_fn` returns its rank's share of the global
#: loss: the kind ``training.train``'s step under a mesh takes.
loss_fn.mesh_loss = True
