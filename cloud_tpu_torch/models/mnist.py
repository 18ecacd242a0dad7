"""Dense MNIST classifier, the reference's golden minimal workload (port
of ``cloud_tpu/models/mnist.py``): flattened 28x28 images, a 512-unit
relu layer and a 10-way head.  It runs no kernel of the port; its params
come from ``bridge.init_mnist`` or, from JAX's, ``bridge.mnist_to_torch``.

Under a training mesh of more than one rank (``mesh=``, or the installed
global mesh) :func:`loss_fn` returns this rank's share of the global loss
(``train.mesh_loss``): the rows are split over ``dp`` and ``fsdp``; other
axes raise (``parallel.collectives.data_parallel_mesh``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from cloud_tpu_torch._device import resolve_device
from cloud_tpu_torch.models import layers
from cloud_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class MnistConfig:
    input_dim: int = 784
    hidden_dim: int = 512
    num_classes: int = 10


def apply(params, images, config: MnistConfig = MnistConfig(), *,
          device=None):
    """images ``[B, ...]`` (flattened to ``[B, input_dim]``) -> logits
    ``[B, num_classes]``."""
    device = resolve_device(device)
    x = torch.as_tensor(images, device=device)
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(layers.dense_apply(params["hidden"], x))
    return layers.dense_apply(params["out"], x)


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
    mesh, device = collectives.data_parallel_mesh(mesh, "MNIST", device)
    logits = apply(params, batch["image"], config, device=device)
    return layers.classification_loss(logits, batch["label"], mesh)


#: Under a mesh, :func:`loss_fn` returns its rank's share of the global
#: loss: the kind ``training.train``'s step under a mesh takes.
loss_fn.mesh_loss = True
