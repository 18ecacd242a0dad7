"""Training of the port: the train state, step and window, its
optimizers, the Keras-fit-parity Trainer with its callbacks, the prefetch
pipeline, and checkpoints with durable resume (port of
``cloud_tpu/training``; ``param_shardings`` and ``compile_cache`` wait
for ROADMAP.md A.6)."""

from cloud_tpu_torch.training.train import (
    TrainState,
    create_sharded_state,
    make_eval_step,
    make_multi_step,
    make_train_step,
)
from cloud_tpu_torch.training import optimizers, pipeline_io
from cloud_tpu_torch.training.pipeline_io import prefetch_to_device
from cloud_tpu_torch.training.trainer import (
    Callback,
    EarlyStopping,
    TerminateOnNaN,
    History,
    LambdaCallback,
    ProgressLogger,
    Trainer,
)

__all__ = [
    "TrainState",
    "optimizers",
    "Trainer",
    "Callback",
    "EarlyStopping",
    "TerminateOnNaN",
    "History",
    "LambdaCallback",
    "ProgressLogger",
    "create_sharded_state",
    "make_train_step",
    "make_multi_step",
    "make_eval_step",
    "pipeline_io",
    "prefetch_to_device",
]
