"""In-process continuous-batching serving on the card (port of
``cloud_tpu/serving``).  See :mod:`cloud_tpu_torch.serving.engine` and,
for priority classes, quotas and streaming,
:mod:`cloud_tpu_torch.serving.qos`."""

from cloud_tpu_torch.serving.engine import (
    DeadlineExceededError,
    DispatchTimeoutError,
    DraftConfig,
    EngineClosedError,
    QueueFullError,
    SERVE_DISPATCH_THREAD_NAME,
    SERVE_SCHEDULER_THREAD_NAME,
    ServeConfig,
    ServeResult,
    ServingEngine,
)
from cloud_tpu_torch.serving.qos import (
    BrownoutShedError,
    PriorityClass,
    QosConfig,
    QosScheduler,
    QuotaExceededError,
    TenantQuota,
    TokenBucket,
    TokenStream,
)

__all__ = [
    "BrownoutShedError",
    "DeadlineExceededError",
    "DispatchTimeoutError",
    "DraftConfig",
    "EngineClosedError",
    "PriorityClass",
    "QosConfig",
    "QosScheduler",
    "QueueFullError",
    "QuotaExceededError",
    "SERVE_DISPATCH_THREAD_NAME",
    "SERVE_SCHEDULER_THREAD_NAME",
    "ServeConfig",
    "ServeResult",
    "ServingEngine",
    "TenantQuota",
    "TokenBucket",
    "TokenStream",
]
