"""Training of the port: the train state, step and window (stochastic
steps included), its optimizers, the Keras-fit-parity Trainer with its
callbacks, compile-ahead and the persistent kernel cache
(``compile_cache``), the prefetch and record pipelines (``pipeline_io``,
``records``), checkpoints with durable resume, and the step under a
mesh with the hybrid data-parallel step (port of
``cloud_tpu/training``)."""

from cloud_tpu_torch.training.train import (
    TrainState,
    create_sharded_state,
    make_eval_step,
    make_multi_step,
    make_hybrid_dp_train_step,
    make_train_step,
    mesh_loss,
    param_shardings,
    shard_batch,
)
from cloud_tpu_torch.training import (compile_cache, optimizers,
                                      pipeline_io, records)
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
    "param_shardings",
    "pipeline_io",
    "prefetch_to_device",
    "compile_cache",
    "records",
]
