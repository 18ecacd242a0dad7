"""In-process continuous-batching serving on the card (port of
``cloud_tpu/serving``).  See :mod:`cloud_tpu_torch.serving.engine`."""

from cloud_tpu_torch.serving.engine import (
    DeadlineExceededError,
    DraftConfig,
    EngineClosedError,
    QueueFullError,
    SERVE_SCHEDULER_THREAD_NAME,
    ServeConfig,
    ServeResult,
    ServingEngine,
)

__all__ = [
    "DeadlineExceededError",
    "DraftConfig",
    "EngineClosedError",
    "QueueFullError",
    "SERVE_SCHEDULER_THREAD_NAME",
    "ServeConfig",
    "ServeResult",
    "ServingEngine",
]
